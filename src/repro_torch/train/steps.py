"""Step functions.  Training: the loss, its gradients and the AdamW train
step with microbatch accumulation (``make_loss_fn``, ``loss_and_grads``,
``make_train_step``).  GCN inference over prebuilt ExecutionPlans: the
clip step, the per-frame stream step, the session-slab step and the fused
serving tick, each the two-stream (joint + bone) ensemble.  LM steps: the
greedy KV-cache decode step and the prefill forward.  Port of
``repro.train.steps``."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.tree import tree_leaves, tree_map, tree_unflatten


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """``loss(params, batch) -> (loss, metrics)``: the family's training
    loss (``registry.loss_fn``)."""
    from repro_torch.models import registry

    def loss(params, batch):
        return registry.loss_fn(params, batch, cfg)
    return loss


def loss_and_grads(loss_fn: Callable, params, batch
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, metrics, grads) of ``loss_fn(params, batch)``, with grads in
    ``params``' structure and dtypes (zeros for a leaf the loss does not
    reach, as JAX's ``value_and_grad`` gives); the loss and metrics are
    detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_unflatten(params, grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    forward and backward, gradients averaged over ``tcfg.microbatches``
    equal slices of the batch (each slice's loss on its own, so BatchNorm
    takes each slice's statistics, as JAX's scan does), cast to bf16 when
    ``tcfg.grad_compression == "bf16"``, then ``adamw.update``.  Returns
    new trees; the inputs are not changed.

    ``loss_fn`` (default :func:`make_loss_fn`) may be any ``(params,
    batch) -> (loss, metrics)`` — the pruning bench's prune-aware losses.
    JAX's ``grad_shardings`` (the ZeRO-2 reduce-scatter of gradients over
    a data-parallel mesh) is not taken: it joins with the training half of
    distribution (ROADMAP.md, Queue 1 item 4b)."""
    from repro_torch.optim import adamw

    loss_fn = loss_fn or make_loss_fn(cfg)
    nmb = max(1, tcfg.microbatches)

    def train_step(params, opt_state, batch):
        if nmb == 1:
            loss, metrics, grads = loss_and_grads(loss_fn, params, batch)
        else:
            gacc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            n = next(iter(batch.values())).shape[0]
            if n % nmb:
                raise ValueError(f"a batch of {n} does not split into "
                                 f"{nmb} microbatches")
            per, loss = n // nmb, 0.0
            for i in range(nmb):
                mb = {k: v[i * per:(i + 1) * per] for k, v in batch.items()}
                li, _, g = loss_and_grads(loss_fn, params, mb)
                gacc = tree_map(torch.add, gacc, g)
                loss = loss + li
            grads = tree_map(lambda g: g / nmb, gacc)
            loss = loss / nmb
            metrics = {"loss": loss}
        if tcfg.grad_compression == "bf16":
            grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        params, opt_state, opt_metrics = adamw.update(
            params, grads, opt_state, tcfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def _gcn_bone_fn(plans) -> Callable:
    """Bone transform for the ensemble's second stream: the plan's own
    (V,) parent map when present, else the fixed NTU-25 bone stream."""
    from repro_torch.core.agcn.model import bone_stream, bone_stream_parents

    parents = plans[1].arrays.get("parents") if len(plans) > 1 else None
    if parents is None:
        return bone_stream
    return lambda x: bone_stream_parents(x, parents[: x.shape[-2]])


def make_gcn_infer_step(cfg: ModelConfig) -> Callable:
    """``step(plans, x) -> logits`` for a tuple of one (joint) or two
    (joint, bone) ExecutionPlans; two plans average their logits.  ``x``
    lies on the plans' device."""
    from repro_torch.core.agcn import engine

    @torch.inference_mode()
    def infer_step(plans, x):
        logits = engine.execute(plans[0], x)
        if len(plans) > 1:
            logits = 0.5 * (logits + engine.execute(
                plans[1], _gcn_bone_fn(plans)(x)))
        return logits

    return infer_step


def _ensemble(plans, frames, call) -> tuple:
    """The two-stream ensemble of one streaming call.  ``call(i, x)`` runs
    stream ``i`` (0 joint, 1 bone) on raw frames ``x`` and returns
    ``(state, logits, *more)``; the result is ``(states, logits, *more)``
    with each of ``states`` and ``more`` a per-stream tuple and the two
    streams' logits averaged."""
    outs = [call(0, frames)]
    if len(plans) > 1:
        outs.append(call(1, _gcn_bone_fn(plans)(frames)))
    logits = outs[0][1] if len(outs) == 1 else 0.5 * (outs[0][1] + outs[1][1])
    per_stream = [tuple(o[k] for o in outs) for k in range(len(outs[0]))]
    return (per_stream[0], logits, *per_stream[2:])


def make_gcn_stream_step(cfg: ModelConfig) -> Callable:
    """Per-frame step ``step(plans, states, frame, valid=True) -> (states,
    logits)`` over matched tuples of one (joint) or two (joint, bone)
    ExecutionPlans and StreamStates; ``frame`` is one raw (N, V, C)
    skeleton frame.  The bone transform is frame-local, so the ensemble
    streams too; ``valid=False`` drains the per-block latency after the
    clip (``engine.stream_flush_frames``)."""
    from repro_torch.core.agcn import engine

    @torch.inference_mode()
    def stream_step(plans, states, frame, valid=True):
        return _ensemble(plans, frame, lambda i, x: engine.step_frame(
            plans[i], states[i], x, valid=valid))

    return stream_step


def make_gcn_slab_step(cfg: ModelConfig) -> Callable:
    """Session-slab step ``step(plans, slabs, frames, valid, reset,
    hold=None, stats=None) -> (slabs, logits)``: the scheduler-tick form of
    :func:`make_gcn_stream_step` (``engine.step_frames``), with one raw
    (S, V, C) frame per slot and (S,) ``valid``/``reset``/``hold`` masks
    shared by both ensemble streams.  ``stats`` is an optional per-stream
    tuple of BN statistics overriding each slab's own for this tick."""
    from repro_torch.core.agcn import engine

    @torch.inference_mode()
    def slab_step(plans, slabs, frames, valid, reset, hold=None, stats=None):
        st = stats or (None,) * len(plans)
        return _ensemble(plans, frames, lambda i, x: engine.step_frames(
            plans[i], slabs[i], x, valid, reset, hold, bn_stats=st[i]))

    return slab_step


def make_gcn_fused_tick(cfg: ModelConfig) -> Callable:
    """Serving tick ``tick(plans, slabs, frames, valid, reset, hold,
    snap_order, rest_order, rings, stats=None) -> (slabs, logits, rings)``:
    :func:`make_gcn_slab_step` with the tick's snapshot and restore events
    (``engine.fused_tick``), one snapshot ring per ensemble stream
    (``engine.init_snapshot_ring``) and the (E, 2) sentinel-padded event
    buffers shared by both streams.  Functional: callers use the returned
    slabs and rings."""
    from repro_torch.core.agcn import engine

    @torch.inference_mode()
    def fused_tick(plans, slabs, frames, valid, reset, hold,
                   snap_order, rest_order, rings, stats=None):
        st = stats or (None,) * len(plans)
        return _ensemble(plans, frames, lambda i, x: engine.fused_tick(
            plans[i], slabs[i], x, valid, reset, hold, snap_order,
            rest_order, rings[i], bn_stats=st[i]))

    return fused_tick


def make_serve_step(cfg: ModelConfig, backend: str = "cuda") -> Callable:
    """LM decode step ``step(params, cache, batch) -> (next_tok (B,) int32,
    cache, logits (B, padded_vocab))``: ``registry.serve_fn`` (the cache
    updated in place) and the greedy next token.  The reference's step
    returns the token and cache only; the last position's logits are
    returned too so callers can check them."""
    from repro_torch.models import registry

    @torch.inference_mode()
    def serve_step(params, cache, batch):
        logits, cache = registry.serve_fn(params, batch, cache, cfg, backend)
        last = logits[:, -1, : cfg.padded_vocab]
        return last.argmax(-1).to(torch.int32), cache, last

    return serve_step


def make_prefill_step(cfg: ModelConfig) -> Callable:
    """LM prefill ``step(params, {tokens, labels}) -> metrics``: the
    cache-free forward and its next-token loss."""
    from repro_torch.models import registry

    @torch.inference_mode()
    def prefill_step(params, batch):
        return registry.loss_fn(params, batch, cfg)[1]

    return prefill_step
