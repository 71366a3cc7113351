"""Step functions.  Training: the loss, its gradients and the AdamW train
step with microbatch accumulation, in one process or over a
``torch.distributed`` mesh of data (and pod) and model ranks
(``make_loss_fn``, ``loss_and_grads``, ``make_train_step``,
``grad_sync_plan``, ``sync_grads``, ``shard_batch``).  GCN inference
over prebuilt ExecutionPlans: the clip step, the per-frame stream step,
the session-slab step and the fused serving tick, each the two-stream
(joint + bone) ensemble.  LM steps: the greedy KV-cache decode step and
the prefill forward.  Port of ``repro.train.steps``."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.cost import report_collective
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


class SyncStep(NamedTuple):
    """One collective of the gradient sync: ``kind`` ("all-reduce" or
    "reduce-scatter", the latter along tensor dim ``dim``) over the
    ``ranks`` ranks of mesh axis ``axis``; ``nbytes`` is its result's
    bytes at the payload dtype (``hlo_cost``'s measure)."""
    axis: str
    kind: str
    dim: Optional[int]
    ranks: int
    nbytes: int


def grad_sync_plan(grads, shardings, compression: str = "none",
                   rules=None) -> List[List[SyncStep]]:
    """The collectives :func:`sync_grads` issues, per leaf of ``grads``
    (each rank's gradients: a leaf's model shard where its spec shards it
    over ``model``; in ``tree_leaves`` order; tensors or anything with
    ``shape`` and ``dtype``, e.g. meta tensors): for each batch axis of
    the mesh under ``rules`` (default the active rules, else the default
    ones) with more than one rank, a reduce-scatter into the leaf's shard
    when its spec shards it over that axis, else an all-reduce, in the
    batch axes' order.  No step runs over ``model`` unless the rules put
    batch on it (``dp_only``): a rank's gradient of a leaf replicated on
    ``model`` is already the whole one when it reaches the sync.  Under
    sequence parallelism (the ``seq_shard`` rule) the leaves a rank reads
    on its sequence shard alone, the norm scales on the residual
    (``distributed.params.SEQ_SHARD_LEAVES``: ``ln1``, ``ln2``,
    ``final_norm``, the xLSTM and Mamba2 blocks' ``ln``, zamba2's
    ``use_ln`` and ``shared/ln2``), are summed over ``model`` inside
    autograd (``params.seq_shard_sums``, counted with the step's
    collectives), so they are whole here too.  The payload is the
    gradient's dtype, or bfloat16 with ``compression == "bf16"``.  Needs
    no process group: the dry run reads it on a shape-only mesh."""
    from repro_torch.distributed.sharding import axis_size, batch_axes
    plan = []
    for g, s in zip(tree_leaves(grads), tree_leaves(shardings)):
        mesh = s.mesh
        item = 2 if compression == "bf16" else g.dtype.itemsize
        numel = 1
        for d in g.shape:
            numel *= int(d)
        steps = []
        for a in batch_axes(mesh, rules):
            k = axis_size(mesh, a)
            if k == 1:
                continue
            dim = next((i for i, e in enumerate(s.spec)
                        if e == a or (isinstance(e, tuple) and a in e)),
                       None)
            if dim is not None:
                numel //= k
                steps.append(SyncStep(a, "reduce-scatter", dim, k,
                                      numel * item))
            else:
                steps.append(SyncStep(a, "all-reduce", None, k,
                                      numel * item))
        plan.append(steps)
    return plan


def sync_grads(grads, shardings, compression: str = "none", rules=None):
    """The data-parallel gradient sync of one train step: each rank's
    gradients (its rows' mean; whole leaves, or a leaf's model shard where
    ``shardings`` shards it over ``model``) -> the mean over the batch
    axes' ranks under ``rules`` (:func:`grad_sync_plan`), as DTensors laid
    out by ``shardings`` (a tree of
    ``sharding.NamedSharding``, or anything with ``mesh``, ``spec`` and
    ``placements``).  Issues :func:`grad_sync_plan`'s collectives, each
    counted on the active cost counter (``common.cost``): a leaf sharded over
    a batch axis gets a reduce-scatter into its shard, every other leaf
    an all-reduce.  With ``compression == "bf16"`` the payloads are
    bfloat16 (half the bytes; the sum is rounded to bfloat16) and the
    result stays bfloat16, as the reference's compressed sync hands AdamW
    bf16 gradients."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    plan = grad_sync_plan(grads, shardings, compression, rules)

    def one(g, s, steps):
        if compression == "bf16":
            g = g.to(torch.bfloat16)
        n = 1
        for st in steps:
            n *= st.ranks
            group = s.mesh.get_group(st.axis)
            if st.kind == "reduce-scatter":
                src = g.movedim(st.dim, 0).contiguous()
                out = src.new_empty((src.shape[0] // st.ranks,
                                     *src.shape[1:]))
                dist.reduce_scatter_tensor(out, src, group=group)
                g = out.movedim(0, st.dim)
            else:
                g = g.clone(memory_format=torch.contiguous_format)
                dist.all_reduce(g, group=group)     # the caller's grads stay
            report_collective(st.kind, st.nbytes)
        g = g / n if n > 1 else g
        return DTensor.from_local(g.contiguous(), s.mesh, s.placements,
                                  run_check=False)

    return tree_unflatten(grads, [
        one(g, s, steps) for g, s, steps in zip(
            tree_leaves(grads), tree_leaves(shardings), plan)])


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                    grad_shardings=None, loss_fn: Optional[Callable] = None,
                    rules=None) -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    forward and backward, gradients averaged over ``tcfg.microbatches``
    equal slices of the batch (each slice's loss on its own, so BatchNorm
    takes each slice's statistics, as JAX's scan does), cast to bf16 when
    ``tcfg.grad_compression == "bf16"``, then ``adamw.update``.  Returns
    new trees; the inputs are not changed.

    ``grad_shardings`` (a tree of ``sharding.NamedSharding``, from
    ``distributed.params.param_shardings``) makes it the step over the
    mesh, JAX's meaning of the argument: the parameters and the optimizer
    state are DTensors laid out so (``distribute_params``), ``batch``
    holds this rank's rows (its batch rank's, ``sharding.batch_rank``),
    and each microbatch of a rank is its share of the global microbatch
    (the global batch split as (microbatches, ranks, rows),
    ``shard_batch``).  ``rules`` are the mesh's logical rules (default
    ``sharding.rules_for`` of ``cfg.sharding``: the batch
    over ``data`` and ``pod``, or over every axis under ``dp_only``).
    The step gathers each parameter over the batch axes and keeps its
    model shard (``params.local_params``), runs the loss under
    ``sharding.axis_rules`` with the specs' ``ModelPlan`` (so BatchNorm
    statistics and the MoE load-balance means span every batch rank, and
    the LM's layers take their model shards: ``params.prepare``
    gathers the rest inside autograd), so each rank differentiates with
    respect to its own shards; then it syncs the gradients
    (:func:`sync_grads`: a reduce-scatter into the shard of a leaf sharded
    over ``data``, an all-reduce mean elsewhere, on bf16 payloads with
    compression), and AdamW updates each rank's shard; the metrics are
    means over the ranks.

    ``loss_fn`` (default :func:`make_loss_fn`) may be any ``(params,
    batch) -> (loss, metrics)`` — the pruning bench's prune-aware
    losses."""
    from repro_torch.distributed import params as dparams
    from repro_torch.distributed import sharding
    from repro_torch.optim import adamw

    loss_fn = loss_fn or make_loss_fn(cfg)
    nmb = max(1, tcfg.microbatches)
    layout = None
    if grad_shardings is not None:
        mesh = tree_leaves(grad_shardings)[0].mesh
        specs = tree_map(lambda s: s.spec, grad_shardings)
        policy = cfg.sharding
        layout = dparams.ModelLayout(
            specs, dparams.plan_of(cfg, specs, mesh), policy)
        rules = rules or sharding.rules_for(policy, 0, mesh)
        shard_loss = loss_fn

        def loss_fn(params, batch):
            return shard_loss(dparams.prepare(params, layout), batch)

    def local_grads(params, batch):
        if nmb == 1:
            return loss_and_grads(loss_fn, params, batch)
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
        return loss / nmb, {"loss": loss / nmb}, tree_map(
            lambda g: g / nmb, gacc)

    def train_step(params, opt_state, batch):
        if grad_shardings is None:
            loss, metrics, grads = local_grads(params, batch)
            if tcfg.grad_compression == "bf16":
                grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
        else:
            local = dparams.local_params(params)
            with sharding.axis_rules(mesh, rules, layout.plan):
                loss, metrics, grads = local_grads(local, batch)
            del local
            grads = sync_grads(grads, grad_shardings, tcfg.grad_compression,
                               rules)
            with torch.no_grad(), sharding.axis_rules(mesh, rules):
                metrics = {k: sharding.batch_mean(v)
                           for k, v in metrics.items()}
        params, opt_state, opt_metrics = adamw.update(
            params, grads, opt_state, tcfg)
        metrics = dict(metrics)
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def shard_batch(batch: Dict[str, Any], rank: int, ranks: int,
                microbatches: int = 1) -> Dict[str, Any]:
    """Rank ``rank``'s rows of a global batch for the data-parallel step
    over ``ranks`` batch ranks: the batch split as (microbatches, ranks,
    rows), so the rows a rank holds in its microbatch i are the r-th share
    of the global microbatch i (what JAX's one-device scan takes as
    microbatch i)."""
    def take(x):
        n = x.shape[0]
        if n % (microbatches * ranks):
            raise ValueError(f"a batch of {n} does not split into "
                             f"{microbatches} microbatches x {ranks} ranks")
        per = n // (microbatches * ranks)
        y = x.reshape(microbatches, ranks, per, *x.shape[1:])[:, rank]
        return y.reshape(microbatches * per, *x.shape[1:])
    return {k: take(v) for k, v in batch.items()}


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


def _on_mesh(cfg: ModelConfig, mesh, rules, fn: Callable) -> Callable:
    """``fn(params, *args)`` run on ``mesh``'s ranks: under the mesh's
    rules and plan (``params.mesh_context``), with ``params`` (DTensors,
    or this rank's local tensors from ``params.local_params`` or
    ``params.local_shards``) prepared for the layers.  ``fn`` itself
    without a mesh."""
    if mesh is None:
        return fn
    from repro_torch.distributed import params as dparams
    layout = dparams.model_layout(cfg, mesh)

    def on_mesh(params, *args):
        with dparams.mesh_context(cfg, mesh, rules, layout):
            return fn(dparams.prepare(dparams.local_params(params), layout),
                      *args)
    return on_mesh


def make_serve_step(cfg: ModelConfig, backend: str = "cuda", mesh=None,
                    rules=None) -> Callable:
    """LM decode step ``step(params, cache, batch) -> (next_tok (B,) int32,
    cache, logits (B, padded_vocab))``: ``registry.serve_fn`` (the cache
    updated in place) and the greedy next token.  The reference's step
    returns the token and cache only; the last position's logits are
    returned too so callers can check them.

    With ``mesh`` it is one rank's step: the layers take their model
    shards (the logits come back whole on every rank) and, under
    ``rules`` with ``kv_seq`` (``sharding.rules_for`` of a batch that
    does not divide over the data ranks), the cache is this rank's slot
    range; ``cache`` must come from ``registry.init_cache`` inside
    ``params.mesh_context`` of the same mesh and rules."""
    from repro_torch.models import registry

    def serve(params, cache, batch):
        logits, cache = registry.serve_fn(params, batch, cache, cfg, backend)
        last = logits[:, -1, : cfg.padded_vocab]
        return last.argmax(-1).to(torch.int32), cache, last

    return torch.inference_mode()(_on_mesh(cfg, mesh, rules, serve))


def make_prefill_step(cfg: ModelConfig, mesh=None, rules=None) -> Callable:
    """LM prefill ``step(params, {tokens, labels}) -> metrics``: the
    cache-free forward and its next-token loss (on ``mesh``'s ranks as
    :func:`make_serve_step` runs them)."""
    from repro_torch.models import registry

    def prefill(params, batch):
        return registry.loss_fn(params, batch, cfg)[1]

    return torch.inference_mode()(_on_mesh(cfg, mesh, rules, prefill))
