"""AdamW with global-norm clipping and a warmup-cosine schedule, as
functions on parameter trees.  Port of ``repro.optim.adamw``.

The update is functional, ``(params, grads, state) -> (params, state,
metrics)``, like the JAX one: gradients are clipped by their global norm
first, the moments are float32, bias correction uses the int32 step
counter (``1 - β^t`` with t cast to float32), and the decoupled weight
decay applies only to leaves with two or more dimensions.  Everything
stays on the parameters' device: the learning rate is a 0-d tensor, so a
step never waits for the host.

Leaves may be DTensors (the data-parallel step's sharded parameters,
gradients and moments, laid out alike): the update runs on each rank's
shard, and :func:`global_norm` sums a sharded leaf's squares over the
ranks that hold its shards, so clipping sees the whole gradient.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.tree import (is_dtensor, tree_leaves, tree_map,
                                     tree_unflatten)


class OptState(NamedTuple):
    step: torch.Tensor       # () int32, on the parameters' device
    m: Any
    v: Any


def _local(x):
    """A DTensor's shard on this rank, else ``x``."""
    return x.to_local() if is_dtensor(x) else x


def _like(ref, local):
    """``local`` as a DTensor laid out as ``ref`` when ``ref`` is one."""
    if not is_dtensor(ref):
        return local
    return type(ref).from_local(local, ref.device_mesh, ref.placements,
                                run_check=False, shape=ref.shape,
                                stride=ref.stride())


def init(params) -> OptState:
    """Zero float32 moments of the parameters' shapes (laid out as the
    parameters where they are DTensors), step 0."""
    leaves = tree_leaves(params)
    dev = _local(leaves[0]).device if leaves else None

    def zeros(p):
        lp = _local(p)
        return _like(p, torch.zeros(lp.shape, dtype=torch.float32,
                                    device=lp.device))

    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    m=tree_map(zeros, params), v=tree_map(zeros, params))


def schedule(step: torch.Tensor, tcfg: TrainConfig) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor): linear warmup to
    ``learning_rate`` over ``warmup_steps``, then a cosine to 0 at
    ``total_steps``; float32, like JAX's."""
    step = torch.as_tensor(step)
    lr = tcfg.learning_rate
    warm = lr * (step + 1).to(torch.float32) / max(1, tcfg.warmup_steps)
    t = torch.clamp((step - tcfg.warmup_steps).to(torch.float32)
                    / max(1, tcfg.total_steps - tcfg.warmup_steps), 0.0, 1.0)
    cos = lr * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < tcfg.warmup_steps, warm, cos)


def _square_sum(x) -> torch.Tensor:
    """Σ x² in float32 over the whole leaf: a DTensor's shard sum added up
    over the mesh dims that shard it."""
    s = _local(x).float().square().sum()
    if is_dtensor(x):
        import torch.distributed as dist
        for dim, pl in enumerate(x.placements):
            if pl.is_shard() and x.device_mesh.size(dim) > 1:
                dist.all_reduce(s, group=x.device_mesh.get_group(dim))
    return s


def global_norm(tree) -> torch.Tensor:
    """The L2 norm over every leaf, in float32 (over whole leaves where
    they are DTensors)."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(_square_sum(x) for x in leaves))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / norm), norm); each leaf keeps
    its dtype (and its layout)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-9), max=1.0)
    return tree_map(lambda g: _like(g, (_local(g).float() * scale).to(
        g.dtype)), grads), norm


def update(params, grads, state: OptState, tcfg: TrainConfig
           ) -> Tuple[Any, OptState, Dict[str, torch.Tensor]]:
    """One AdamW step: new (params, state) and {"grad_norm", "lr"}, the
    norm taken before clipping."""
    grads, gnorm = clip_by_global_norm(grads, tcfg.grad_clip)
    lr = schedule(state.step, tcfg)
    b1, b2 = tcfg.beta1, tcfg.beta2
    t = state.step + 1
    tf = t.to(torch.float32)
    bc1, bc2 = 1 - torch.pow(b1, tf), 1 - torch.pow(b2, tf)

    ps = tree_leaves(params)
    g32 = [_local(g).float() for g in tree_leaves(grads)]
    ms, vs = tree_leaves(state.m), tree_leaves(state.v)
    # new moments, each accumulated in place (no full-size temporaries)
    m = torch._foreach_mul([_local(x) for x in ms], b1)
    torch._foreach_add_(m, g32, alpha=1 - b1)
    v = torch._foreach_mul([_local(x) for x in vs], b2)
    torch._foreach_addcmul_(v, g32, g32, value=1 - b2)
    new_p = []
    for p, mi, vi in zip(ps, m, v):
        lp = _local(p)
        step_ = (mi / bc1) / (torch.sqrt(vi / bc2) + 1e-8)
        if p.dim() >= 2:                                 # decoupled decay
            step_ = step_ + tcfg.weight_decay * lp.float()
        new_p.append(_like(p, (lp.float() - lr * step_).to(p.dtype)))
    m = [_like(r, x) for r, x in zip(ms, m)]
    v = [_like(r, x) for r, x in zip(vs, v)]
    new_state = OptState(step=t, m=tree_unflatten(state.m, m),
                         v=tree_unflatten(state.v, v))
    return (tree_unflatten(params, new_p), new_state,
            {"grad_norm": gnorm, "lr": lr})
