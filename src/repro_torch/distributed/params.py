"""Parameter partition specs (2D ZeRO-3-style sharding), the port of
``repro.distributed.params``, and their DTensor form.

Rule per weight leaf:
  * MoE expert tensors: the experts dim -> "model" (expert parallelism),
    the largest remaining divisible dim -> "data".
  * Everything else: of the last two dims, the larger divisible one ->
    "model" (tensor parallelism), the other -> "data" (FSDP) if divisible.
  * Dims smaller than 128, stacked leading dims, and 0/1-D leaves stay
    replicated.

This never shards a head axis, so odd head counts (smollm's 15 heads) are
safe.  :func:`param_shardings` gives each spec's DTensor placements on the
mesh and :func:`distribute_params` lays a tree out with them.

The model axis: :func:`model_layout` reads which layers of an LM take
their weights as model shards (a :class:`ModelPlan`) off the specs;
:func:`local_params` turns the DTensor tree into this rank's local
tensors (gathered over the batch axes, each leaf's model shard kept), and
:func:`prepare` gathers, inside autograd, every model-sharded leaf that
no layer takes as a shard (norm scales outside a head-parallel layer,
the router, a layer whose heads do not divide the axis), so each rank's
gradients are of its own shards.  Under sequence parallelism
(``sharding.seq_parallel``) the models pass their trees through
:func:`seq_shard_sums`, whose leaves (:data:`SEQ_SHARD_LEAVES`) a rank
reads on its sequence shard alone, so their gradients are summed over
``model``.
"""
from __future__ import annotations

import re
from typing import Any, Dict, List, NamedTuple, Optional

from repro_torch.common.tree import tree_map, tree_paths, tree_unflatten
from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              axis_size, copy_to_model,
                                              gather_from_model)

MIN_SHARD_DIM = 128

# weights whose CONTRACTION dim must live on "model" (Megatron row-parallel:
# their producer's output is already model-sharded, so the matmul is local
# and only the output needs a reduce-scatter)
ROW_PARALLEL_NAMES = ("wo", "out_proj")


def leaf_spec(path: str, shape, mesh, expert_dim: Optional[int] = None
              ) -> PartitionSpec:
    """The spec of one weight leaf at ``path`` (``layers/moe/wi``)."""
    shape = tuple(shape)
    ndim = len(shape)
    spec = [None] * ndim
    model_n = axis_size(mesh, "model")
    data_n = axis_size(mesh, "data")
    if ndim == 0:
        return PartitionSpec()
    leaf_name = path.rsplit("/", 1)[-1]

    is_moe = "moe" in path or "router" in path
    used_model = False
    if is_moe and expert_dim and expert_dim in shape:
        for i, d in enumerate(shape):           # experts dim -> model (EP)
            if d == expert_dim and d % model_n == 0:
                spec[i] = "model"
                used_model = True
                break

    def ok(i, n):
        return (spec[i] is None and shape[i] >= MIN_SHARD_DIM
                and shape[i] % n == 0)

    if ndim >= 2:
        if leaf_name == "embed":
            # vocab -> model (sharded logits), d_model -> data (FSDP)
            order_model, order_data = [ndim - 2], [ndim - 1]
        elif any(leaf_name.startswith(n) for n in ROW_PARALLEL_NAMES):
            # row-parallel: contraction (dim -2) on model, output on data
            order_model, order_data = [ndim - 2], [ndim - 1]
        else:
            # column-parallel (wq/wk/wv/wi/wg/router/...): output (dim -1)
            # on model, contraction on data
            order_model, order_data = [ndim - 1], [ndim - 2]
        if not used_model:
            for i in order_model:
                if ok(i, model_n):
                    spec[i] = "model"
                    used_model = True
                    break
        for i in order_data + order_model:
            if ok(i, data_n):
                spec[i] = "data"
                break
    return PartitionSpec(*spec)


def _drop_data(spec: PartitionSpec) -> PartitionSpec:
    return PartitionSpec(*[None if s == "data" else s for s in spec])


def param_specs(params, mesh, expert_dim: Optional[int] = None,
                policy: str = "2d"):
    """A :class:`PartitionSpec` tree matching ``params`` (any leaves with a
    ``shape``: tensors on the ``meta`` device will do).

    policies:
      "2d"      — model (TP) + data (FSDP) on every weight
      "zero2"   — model (TP) only on params
      "dp_only" — replicate everything"""
    if policy not in ("2d", "zero2", "dp_only"):
        raise ValueError(f"unknown sharding policy {policy!r}")
    specs = []
    for path, leaf in tree_paths(params):
        if policy == "dp_only":
            specs.append(PartitionSpec())
            continue
        spec = leaf_spec(path, leaf.shape, mesh, expert_dim)
        specs.append(_drop_data(spec) if policy == "zero2" else spec)
    return tree_unflatten(params, specs)


def param_shardings(params, mesh, expert_dim: Optional[int] = None,
                    policy: str = "2d"):
    """:func:`param_specs` as :class:`NamedSharding` leaves on ``mesh``; each
    one's ``placements`` are its DTensor placements (``Shard(i)`` on the
    mesh dim named in slot i, ``Replicate()`` elsewhere)."""
    specs = param_specs(params, mesh, expert_dim, policy)
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def distribute_params(params, shardings):
    """``params`` as DTensors laid out by ``shardings`` (a tree of
    :class:`NamedSharding` from :func:`param_shardings`), each rank
    keeping its shard.  Every rank passes the same full values (rank 0's
    are the ones scattered)."""
    from torch.distributed.tensor import distribute_tensor
    return tree_map(lambda p, s: distribute_tensor(
        p.detach(), s.mesh, s.placements), params, shardings)


def sharded_bytes(params, specs, mesh) -> int:
    """Per-device parameter bytes under the given specs."""
    total = 0
    for (_, leaf), (_, spec) in zip(tree_paths(params), tree_paths(specs)):
        n = 1
        for d in leaf.shape:
            n *= int(d)
        div = 1
        for ax in spec:
            if ax is not None:
                div *= axis_size(mesh, ax)
        total += n * _itemsize(leaf) // div
    return total


def _itemsize(leaf: Any) -> int:
    if hasattr(leaf, "element_size"):
        return int(leaf.element_size())
    return int(leaf.dtype.itemsize)


def held_bytes(params) -> int:
    """Parameter bytes this rank holds: a DTensor leaf's local shard, else
    the whole leaf (:func:`sharded_bytes` of the full tree under its specs,
    read off the laid-out tree)."""
    total = 0
    for _, leaf in tree_paths(params):
        local = leaf.to_local() if hasattr(leaf, "to_local") else leaf
        total += local.numel() * local.element_size()
    return total


# ---------------------------------------------------------------------------
# the model axis: which layers take shards, and this rank's local tree
# ---------------------------------------------------------------------------

class ModelPlan(NamedTuple):
    """Which layers take their weights as model shards: ``attn`` (wq and
    wkv column-parallel, wo row-parallel, whole query and kv heads a rank;
    every self- and cross-attention of the model), ``mlp`` (wi and wg
    columns, wo rows), ``moe`` (experts), ``vocab`` (embedding rows: the
    lookup and the logits vocab-parallel), and the recurrent layers by
    heads: ``mlstm`` (wqkv's products gathered, wz columns, out_proj
    rows), ``slstm`` (wx and bias columns, r gathered, out_proj rows) and
    ``mamba`` (wx, wz and conv_w columns, out_proj rows), each with its
    norm scale's columns.  A layer that does not runs whole on every model
    rank."""
    attn: bool = False
    mlp: bool = False
    moe: bool = False
    vocab: bool = False
    mlstm: bool = False
    slstm: bool = False
    mamba: bool = False


# the leaves a layer takes as shards: for each group, the pattern of its
# layers' path prefixes (every attention, self- or cross-, of any stack,
# every MLP) and, under a prefix, each leaf and the dim its model shard
# lies on
SHARD_CONSUMERS = {
    "attn": (r"(?:.+/)?x?attn", {"wq": -1, "wkv": -1, "wo": -2}),
    "mlp": (r"(?:.+/)?mlp", {"wi": -1, "wg": -1, "wo": -2}),
    "moe": (r"layers/moe", {"wi": -3, "wg": -3, "wo": -3}),
    "vocab": (r"", {"embed": -2}),
    "mlstm": (r"layers/mlstm/cell", {"wqkv": -1, "wz": -1,
                                     "norm/scale": -1, "out_proj": -2}),
    "slstm": (r"layers/slstm/cell", {"wx": -1, "bias": -1, "r": -1,
                                     "norm/scale": -1, "out_proj": -2}),
    "mamba": (r"mamba_(?:groups|tail)/cell", {
        "wx": -1, "wz": -1, "conv_w": -1, "norm/scale": -1,
        "out_proj": -2}),
}


def consumers(group: str, paths) -> Dict[str, int]:
    """The leaves among ``paths`` that ``group``'s layers take as shards,
    each with the dim its model shard lies on."""
    prefix, leaves = SHARD_CONSUMERS[group]
    names = "|".join(map(re.escape, leaves))
    pat = re.compile(rf"{prefix}/({names})" if prefix else f"({names})")
    out = {}
    for path in paths:
        m = pat.fullmatch(path)
        if m is not None:
            out[path] = leaves[m.group(1)]
    return out


class ModelLayout(NamedTuple):
    """A model's parameter specs on a mesh, its :class:`ModelPlan` and the
    policy they came from."""
    specs: Any
    plan: ModelPlan
    policy: str


def model_dim(spec: PartitionSpec) -> Optional[int]:
    """The tensor dim ``spec`` puts on ``model`` (None if none), counted
    from the end (negative)."""
    for i, s in enumerate(spec):
        if s == "model" or (isinstance(s, tuple) and "model" in s):
            return i - len(spec)
    return None


def plan_of(cfg, specs, mesh) -> ModelPlan:
    """The :class:`ModelPlan` of an LM's ``specs`` on ``mesh``: a layer
    takes shards when it has leaves and every leaf it would take so is
    model-sharded on the dim it expects, and only where its heads divide
    the axis: attention's query and kv heads (JAX shards the flattened
    ``qkv_flat`` dim, which divides where the heads do not, and GSPMD
    reshards; the port runs such attention whole instead, after gathering
    its weights), the mLSTM and sLSTM heads, the Mamba2 heads
    (d_inner / ``HEAD_P``).  The gcn family's layers take none."""
    from repro_torch.models.layers.mamba2 import HEAD_P
    m = axis_size(mesh, "model")
    if m == 1 or cfg.family == "gcn":
        return ModelPlan()
    flat = dict(tree_paths(specs))

    def takes(group):
        want = consumers(group, flat)
        return bool(want) and all(model_dim(flat[p]) == d
                                  for p, d in want.items())

    heads = cfg.num_heads % m == 0
    return ModelPlan(
        attn=takes("attn") and heads and cfg.num_kv_heads % m == 0,
        mlp=takes("mlp"), moe=takes("moe"), vocab=takes("vocab"),
        mlstm=takes("mlstm") and heads, slstm=takes("slstm") and heads,
        mamba=takes("mamba")
        and (cfg.ssm_expand * cfg.d_model // HEAD_P) % m == 0)


def model_layout(cfg, mesh, policy: Optional[str] = None) -> ModelLayout:
    """``cfg``'s parameter specs on ``mesh`` (the shapes from a meta init)
    under ``policy`` (default the config's ``sharding``) and their plan."""
    from repro_torch.models import registry
    policy = policy or cfg.sharding
    meta = registry.init_params(cfg, device="meta")
    specs = param_specs(meta, mesh, expert_dim=cfg.padded_experts or None,
                        policy=policy)
    return ModelLayout(specs, plan_of(cfg, specs, mesh), policy)


def _consumed(plan: ModelPlan, paths):
    out = {}
    for group in ModelPlan._fields:
        if getattr(plan, group):
            out.update(consumers(group, paths))
    return out


def local_params(params):
    """This rank's local tensors of a DTensor tree: each leaf gathered
    over every mesh dim but ``model`` (a collective every rank joins,
    outside autograd) with its model shard kept; plain leaves as they
    are."""
    from torch.distributed.tensor import Replicate

    def one(x):
        if not hasattr(x, "device_mesh"):
            return x
        mesh = x.device_mesh
        names = mesh.mesh_dim_names
        # a shard over a mesh dim of one rank is already whole there
        want = [pl if n == "model" or mesh.size(i) == 1 else Replicate()
                for i, (n, pl) in enumerate(zip(names, x.placements))]
        if list(x.placements) != want:
            x = x.redistribute(mesh, want)
        return x.to_local()
    return tree_map(one, params)


def local_shards(params, specs, mesh):
    """Whole (one-process) ``params`` cut to this rank's model shards by
    ``specs`` (the rank's index along ``model`` of ``mesh``): what
    :func:`local_params` gives for the same values laid out on the mesh,
    with no collective (rank 0's on a shape-only mesh)."""
    m = axis_size(mesh, "model")
    rank = (mesh.get_local_rank("model")
            if m > 1 and hasattr(mesh, "get_local_rank") else 0)

    def one(x, spec):
        d = model_dim(spec)
        if d is None or m == 1:
            return x
        k = x.shape[d] // m
        return x.narrow(d, rank * k, k).contiguous()
    return tree_map(one, params, specs)


def prepare(params, layout: ModelLayout):
    """The tree the model code takes on a model rank: ``params`` (this
    rank's local tensors) with every model-sharded leaf that no layer of
    ``layout.plan`` takes as a shard gathered over ``model``
    (differentiable: its backward keeps this rank's slice, since every
    rank uses the whole leaf alike).  Needs the mesh's context
    (``sharding.axis_rules``).  Where the forward then holds the residual
    as a sequence shard, the model passes this tree on through
    :func:`seq_shard_sums`, whose leaves each rank reads on its own
    tokens alone (their gradients summed over ``model``); every other
    leaf is read on the whole sequence."""
    flat = tree_paths(params)
    keep = _consumed(layout.plan, [path for path, _ in flat])
    out = []
    for (path, x), (_, spec) in zip(flat, tree_paths(layout.specs)):
        d = model_dim(spec)
        if d is None or keep.get(path) == d:
            out.append(x)
        else:
            out.append(gather_from_model(x, d))
    return tree_unflatten(params, out)


# the leaves a model rank reads on its sequence shard alone under
# sequence parallelism: the scales of the norms on the residual between
# blocks (the decoders' ``layers/ln1``, ``layers/ln2``; xlstm's
# ``layers/{mlstm,slstm}/ln`` and ``ln2``; zamba2's ``mamba_groups/ln``,
# ``mamba_tail/ln``, ``use_ln`` and ``shared/ln2``; every
# ``final_norm``).  The norms inside a layer (``cell/norm``) run on the
# gathered sequence.
SEQ_SHARD_LEAVES = re.compile(r"(?:.+/)?(?:ln\d?|use_ln|final_norm)/scale")


def seq_shard_leaves(paths) -> List[str]:
    """The paths among ``paths`` of :data:`SEQ_SHARD_LEAVES`."""
    return [p for p in paths if SEQ_SHARD_LEAVES.fullmatch(p)]


def seq_shard_sums(params):
    """``params`` for a forward whose residual is a sequence shard: each
    leaf of :data:`SEQ_SHARD_LEAVES` through ``sharding.copy_to_model``
    (identity forward; the backward sums the ranks' gradients, each of its
    own tokens), so every rank gets the whole gradient of the loss, as
    :func:`prepare` gives it of the leaves it gathers.  Every other leaf
    is read on the whole sequence, and its gradient is whole already: a
    layer run whole takes the gathered input and its output's slice
    all-gathers the cotangents (``sharding.layer_out``)."""
    flat = tree_paths(params)
    keep = set(seq_shard_leaves([p for p, _ in flat]))
    return tree_unflatten(params, [copy_to_model(x) if p in keep else x
                                   for p, x in flat])


def mesh_context(cfg, mesh, rules=None, layout: Optional[ModelLayout] = None):
    """``sharding.axis_rules`` for ``cfg`` on ``mesh``: ``rules`` (default
    ``rules_for`` of the policy with a batch that divides) and the plan of
    ``layout`` (default :func:`model_layout`).  Caches made by
    ``registry.init_cache`` inside it are this rank's shards."""
    from repro_torch.distributed.sharding import axis_rules, rules_for
    layout = layout or model_layout(cfg, mesh)
    return axis_rules(mesh, rules or rules_for(layout.policy, 0, mesh),
                      layout.plan)
