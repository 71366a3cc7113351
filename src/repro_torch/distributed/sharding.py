"""Logical-axis sharding rules (MaxText-style), the port of
``repro.distributed.sharding``.

Model code names the axes of its tensors with *logical* names through
:func:`constrain`; a context (:func:`axis_rules`, entered by the training
loop) maps logical names to the axes of a mesh.  Outside any context
:func:`constrain` does nothing, so one-process runs and tests run
unchanged.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose dims are
named ``("data", "model")`` or ``("pod", "data", "model")``; anything with
``axis_names`` and a ``shape`` mapping (a shape-only stand-in) serves the
pure shape logic too.  A spec is a :class:`PartitionSpec`, one entry per
tensor dim (``None``, a mesh axis name, or a tuple of names), equal to the
reference's as a tuple of axis names; :func:`spec_placements` turns it
into DTensor placements.

JAX's GSPMD makes every reduction over a data-sharded batch dim global by
itself.  The port's data-parallel step holds each rank's rows as plain
local tensors, so the few reductions that couple rows (BatchNorm's
statistics, the MoE load-balance means) call :func:`batch_mean`, a
differentiable mean over the ranks of the batch axes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Dict, List, Optional, Tuple, Union

import torch

from repro_torch.common.cost import report_collective

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

# Default rules for the production mesh (data, model) [+ optional pod axis]:
# batch over (pod, data); big weight dims and the sequence between blocks
# over model; vocab/ffn/experts/kv-flat over model.
DEFAULT_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,               # activations' sequence dim inside blocks
    "seq_shard": "model",      # sequence dim *between* blocks (SP regions)
    "embed": None,             # activation d_model dim
    "vocab": "model",
    "ffn": "model",
    "heads": None,
    "qkv_flat": "model",       # flattened heads*head_dim weight dim
    "kv_flat": "model",        # flattened kv_heads*head_dim (cache + weights)
    "expert": "model",
    "embed_fsdp": "data",      # weight d_model dim (ZeRO-3 over data)
    "layers": None,
    "state": "model",          # ssm state dims
    "kv_seq": None,            # decode KV cache sequence dim
    "kv_hd": "model",          # KV cache head_dim
}


class PartitionSpec:
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names.  Compares equal to any sequence with the same
    entries (``tuple(jax_spec)``); a tree leaf, not a container, for the
    port's tree utilities."""

    __slots__ = ("parts",)

    def __init__(self, *parts):
        self.parts = tuple(parts)

    def __iter__(self):
        return iter(self.parts)

    def __len__(self):
        return len(self.parts)

    def __getitem__(self, i):
        return self.parts[i]

    def __eq__(self, other):
        if isinstance(other, PartitionSpec):
            return self.parts == other.parts
        if isinstance(other, (tuple, list)):
            return self.parts == tuple(other)
        return NotImplemented

    def __hash__(self):
        return hash(self.parts)

    def __repr__(self):
        return f"PartitionSpec{self.parts!r}"


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names (a DeviceMesh's ``mesh_dim_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    """The size of mesh axis ``name``, 1 where the mesh lacks it."""
    names = axis_names(mesh)
    if name not in names:
        return 1
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return int(mesh.size(names.index(name)))
    return int(mesh.shape[name])


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, as ``jax.sharding.NamedSharding``."""
    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return spec_placements(self.mesh, self.spec)


def spec_placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(i)`` where slot i of the spec names it, else ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in axis_names(mesh):
        dim = None
        for i, s in enumerate(spec):
            if s == name or (isinstance(s, tuple) and name in s):
                dim = i
                break
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


class _Ctx(threading.local):
    mesh: Optional[Any] = None
    rules: Optional[Rules] = None


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Rules] = None):
    """Map logical axis names to ``mesh``'s axes by ``rules`` (default
    :data:`DEFAULT_RULES`) inside the block."""
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh, _CTX.rules = mesh, dict(rules or DEFAULT_RULES)
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def _resolve(axis: Optional[str]) -> Union[None, str, Tuple[str, ...]]:
    if axis is None or _CTX.rules is None:
        return None
    spec = _CTX.rules.get(axis)
    if spec is None:
        return None
    # drop mesh axes that don't exist (e.g. "pod" on the single-pod mesh);
    # a tuple left with one member normalizes to the bare string
    names = axis_names(_CTX.mesh)
    if isinstance(spec, tuple):
        kept = tuple(s for s in spec if s in names)
        if not kept:
            return None
        return kept[0] if len(kept) == 1 else kept
    return spec if spec in names else None


def logical_spec(*axes: Optional[str]) -> PartitionSpec:
    return PartitionSpec(*[_resolve(a) for a in axes])


def constrain(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """The logical sharding constraint of the reference; does nothing
    outside :func:`axis_rules`.  Inside, it checks the rank and returns
    ``x``: the port's data-parallel step keeps each rank's batch rows as
    local tensors, which meets a batch constraint by construction, and a
    model axis above 1 (tensor or expert parallelism) is refused by the
    train step."""
    if _CTX.mesh is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} axes for rank-{x.dim()} tensor")
    return x


def named_sharding(*axes: Optional[str]) -> Optional[NamedSharding]:
    if _CTX.mesh is None:
        return None
    return NamedSharding(_CTX.mesh, logical_spec(*axes))


def current_mesh():
    return _CTX.mesh


def divisible(dim: int, axis: Optional[str]) -> bool:
    """Would sharding ``dim`` over logical ``axis`` divide evenly on this
    mesh?"""
    if _CTX.mesh is None:
        return True
    spec = _resolve(axis)
    if spec is None:
        return True
    axes = spec if isinstance(spec, tuple) else (spec,)
    n = 1
    for a in axes:
        n *= axis_size(_CTX.mesh, a)
    return dim % n == 0


# ---------------------------------------------------------------------------
# the batch axes' ranks (data parallelism over torch.distributed)
# ---------------------------------------------------------------------------

def make_mesh(shape, device="cuda"):
    """A ``DeviceMesh`` of ``shape``, (data, model) or (pod, data, model),
    over the current process group, on ``device``'s type."""
    from torch.distributed.device_mesh import init_device_mesh
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=names)


def batch_axes(mesh) -> List[str]:
    """The mesh axes the logical batch axis maps to (``pod``, ``data``)."""
    spec = DEFAULT_RULES["batch"]
    return [a for a in spec if a in axis_names(mesh)]


def batch_ranks(mesh=None) -> int:
    """How many ranks split the batch on ``mesh`` (default: the current
    context's; 1 outside a context)."""
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None:
        return 1
    n = 1
    for a in batch_axes(mesh):
        n *= axis_size(mesh, a)
    return n


def batch_rank(mesh) -> int:
    """This rank's index among the batch axes' ranks of ``mesh``."""
    r = 0
    for a in batch_axes(mesh):
        r = r * axis_size(mesh, a) + mesh.get_local_rank(a)
    return r


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the batch axes, differentiable
    (its backward sums the cotangents over the same ranks), for the
    reductions over a batch that a rank holds only a share of: each rank
    passes its local mean over an equal number of rows.  ``x`` itself
    outside :func:`axis_rules` or where one rank holds the whole batch."""
    n = batch_ranks()
    if n == 1:
        return x
    from torch.distributed.nn import functional as dist_fn
    mesh = _CTX.mesh
    with warnings.catch_warnings():   # deprecated in newer torch, kept there
        warnings.simplefilter("ignore", FutureWarning)
        for a in batch_axes(mesh):
            if axis_size(mesh, a) > 1:
                x = dist_fn.all_reduce(x, group=mesh.get_group(a))
                report_collective("all-reduce", x.numel() * x.element_size())
    return x / n
