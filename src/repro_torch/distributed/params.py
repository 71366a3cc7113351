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
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.common.tree import tree_map, tree_paths, tree_unflatten
from repro_torch.distributed.sharding import (NamedSharding, PartitionSpec,
                                              axis_size)

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
