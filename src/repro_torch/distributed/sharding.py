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

The model axis (tensor and expert parallelism) and the ``kv_seq`` decode
are explicit too: a layer holds its shard of a weight as a plain local
tensor and calls the collectives below, Megatron's column- and
row-parallel products, each of whose backward is the one that gives every
rank the gradient of the one loss for its own tensors.  A loss is the same
number on every model rank.  Without sequence parallelism the residual
between blocks is replicated over ``model`` (every model rank holds the
whole (B, S, d) activation): :func:`copy_to_model` (identity forward,
all-reduce backward) at a column-parallel input, :func:`reduce_from_model`
(all-reduce forward, identity backward) at a row-parallel output.
:func:`gather_from_model` (all-gather forward; backward the rank's slice
when every rank uses the whole result, a reduce-scatter when each uses
only its part), :func:`scatter_to_model` (a rank's slice forward,
all-gather backward), :func:`reduce_scatter_to_model` (reduce-scatter
forward, all-gather backward) and :func:`all_to_all` (its own adjoint)
serve the rest.

Sequence parallelism between blocks (Megatron-SP, the layout GSPMD gives
JAX under its default rules): where the rules resolve ``seq_shard`` to
the model axis, that axis does not carry the batch, and its M ranks
divide the sequence (:func:`seq_parallel`), the residual between blocks
is each model rank's contiguous sequence shard, a local (B, S/M, d)
tensor, and the norms on it run on the shard.  A layer takes its input
from the shard through :func:`layer_in` (an all-gather along the sequence
whose backward reduce-scatters, in place of :func:`copy_to_model`, for a
layer that takes shards; an all-gather whose backward keeps the rank's
slice for a layer run whole) and returns its output through
:func:`layer_out` (a reduce-scatter of the row-parallel partial sums into
the rank's shard, in place of :func:`reduce_from_model`; the rank's slice
of a whole result).  Elsewhere the layout stays replicated: a sequence M
does not divide (one-token decode, an odd prompt, a VLM prefix whose
``N_img + S`` does not divide), ``seq_shard: None`` in the rules, or the
batch on the model axis (``dp_only``).  Each collective counts its
result's bytes through ``common.cost.report_collective``.  On a
shape-only mesh (the dry run) they return meta tensors of the result's
shape and report the same bytes.  The ranks of an axis are found with
:func:`axis_group`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple, Union

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
    plan: Optional[Any] = None


_CTX = _Ctx()


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Rules] = None, plan: Any = None):
    """Map logical axis names to ``mesh``'s axes by ``rules`` (default
    :data:`DEFAULT_RULES`) inside the block.  ``plan``
    (``distributed.params.ModelPlan``) says which layers take their
    weights as model shards; without one every layer runs whole."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.plan)
    _CTX.mesh, _CTX.rules = mesh, dict(rules or DEFAULT_RULES)
    _CTX.plan = plan
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules, _CTX.plan = prev


def bind_context(fn):
    """``fn`` run under the context active now (mesh, rules and plan)
    wherever it is called, ``fn`` itself outside a context.  A
    checkpointed block recomputes its forward in the backward, which the
    autograd engine runs on a thread of its own for CUDA tensors, where
    the thread-local context of :func:`axis_rules` is not set."""
    mesh, rules, plan = _CTX.mesh, _CTX.rules, _CTX.plan
    if mesh is None:
        return fn

    def bound(*args, **kwargs):
        with axis_rules(mesh, rules, plan):
            return fn(*args, **kwargs)
    return bound


def model_plan():
    """The active ``ModelPlan``, None outside :func:`axis_rules` or when
    no layer takes model shards."""
    return _CTX.plan


def takes_shards(layer: str) -> bool:
    """Does the active plan give ``layer`` (a ``ModelPlan`` field:
    ``attn``, ``mlstm``, ...) its weights as model shards?"""
    return _CTX.plan is not None and getattr(_CTX.plan, layer)


def model_share(n: int, layer: str) -> int:
    """This model rank's share of ``n`` heads (or head-major channels) of
    ``layer``: n / the model axis's size where the active plan shards
    ``layer`` by heads, else n."""
    return n // model_group().size if takes_shards(layer) else n


def rules_for(policy: str, rows: int, mesh) -> Rules:
    """The rules of one cell (JAX's ``launch.dryrun._rules_for``): the
    default rules; under the ``dp_only`` policy the batch on every mesh
    axis; and where ``rows`` (the global batch) does not divide over the
    batch ranks, no batch sharding and the decode cache's sequence over
    ``data`` (``kv_seq``: every rank runs the whole batch against its
    slot range of the cache)."""
    rules = dict(DEFAULT_RULES)
    dp = axis_size(mesh, "data") * axis_size(mesh, "pod")
    if policy == "dp_only":
        rules["batch"] = ("pod", "data", "model")
        dp *= axis_size(mesh, "model")
    if rows % dp:
        rules["batch"] = None
        rules["kv_seq"] = "data"
    return rules


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
    outside :func:`axis_rules`.  Inside, it resolves ``axes`` through the
    active rules (an unknown logical name raises KeyError), checks the
    rank and returns ``x``: the port lays its tensors out itself, each
    rank's batch rows and its model shards being local tensors that the
    layers move with the collectives of this module, so a constraint is
    met by construction where GSPMD would reshard."""
    if _CTX.mesh is None:
        return x
    if len(axes) != x.dim():
        raise ValueError(f"{len(axes)} axes for rank-{x.dim()} tensor")
    for a in axes:
        if a is not None and a not in _CTX.rules:
            raise KeyError(f"no rule for logical axis {a!r}")
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


def batch_axes(mesh, rules: Optional[Rules] = None) -> List[str]:
    """The mesh axes the logical batch axis maps to under ``rules`` (by
    default the active rules, else :data:`DEFAULT_RULES`: ``pod``,
    ``data``; every axis under ``dp_only``; none under ``kv_seq``)."""
    rules = rules or _CTX.rules or DEFAULT_RULES
    spec = rules.get("batch")
    if spec is None:
        return []
    spec = spec if isinstance(spec, tuple) else (spec,)
    return [a for a in spec if a in axis_names(mesh)]


def batch_ranks(mesh=None, rules: Optional[Rules] = None) -> int:
    """How many ranks split the batch on ``mesh`` (default: the current
    context's; 1 outside a context)."""
    mesh = _CTX.mesh if mesh is None else mesh
    if mesh is None:
        return 1
    n = 1
    for a in batch_axes(mesh, rules):
        n *= axis_size(mesh, a)
    return n


def batch_rank(mesh, rules: Optional[Rules] = None) -> int:
    """This rank's index among the batch axes' ranks of ``mesh``."""
    r = 0
    for a in batch_axes(mesh, rules):
        r = r * axis_size(mesh, a) + mesh.get_local_rank(a)
    return r


def batch_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks of the batch axes, differentiable
    (its backward sums the cotangents over the same ranks), for the
    reductions over a batch that a rank holds only a share of: each rank
    passes its local mean over an equal number of rows.  ``x`` itself
    outside :func:`axis_rules` or where one rank holds the whole batch.
    On a shape-only mesh it counts the all-reduces and returns ``x / n``
    (a meta tensor there)."""
    n = batch_ranks()
    if n == 1:
        return x
    from torch.distributed.nn import functional as dist_fn
    mesh = _CTX.mesh
    with warnings.catch_warnings():   # deprecated in newer torch, kept there
        warnings.simplefilter("ignore", FutureWarning)
        for a in batch_axes(mesh):
            ax = axis_group(a)
            if ax.size > 1:
                if ax.group is not None:
                    x = dist_fn.all_reduce(x, group=ax.group)
                report_collective("all-reduce", x.numel() * x.element_size())
    return x / n


# ---------------------------------------------------------------------------
# the model axis and the kv_seq ranks: groups and differentiable collectives
# ---------------------------------------------------------------------------

class AxisGroup(NamedTuple):
    """The ranks of one mesh axis as this rank sees them: the process
    group (None on a shape-only mesh, or where the axis has one rank),
    this rank's index along the axis (0 on a shape-only mesh) and the
    axis's size."""
    group: Any
    rank: int
    size: int


def axis_group(name: Optional[str]) -> AxisGroup:
    """The ranks of mesh axis ``name`` in the active context (one rank
    outside a context, or for ``None``)."""
    mesh = _CTX.mesh
    if mesh is None or name is None:
        return AxisGroup(None, 0, 1)
    n = axis_size(mesh, name)
    if n == 1 or getattr(mesh, "mesh_dim_names", None) is None:
        return AxisGroup(None, 0, n)
    return AxisGroup(mesh.get_group(name), mesh.get_local_rank(name), n)


def model_group() -> AxisGroup:
    """The ranks of the ``model`` axis."""
    return axis_group("model")


def kv_seq_group() -> AxisGroup:
    """The ranks that split a decode cache's slots (the mesh axis the
    ``kv_seq`` rule names; one rank when it names none)."""
    spec = _resolve("kv_seq")
    if isinstance(spec, tuple):
        raise NotImplementedError(f"kv_seq over {spec}: one mesh axis only")
    return axis_group(spec)


def _report(kind: str, t: torch.Tensor) -> None:
    report_collective(kind, t.numel() * t.element_size())


def _gathered(x: torch.Tensor, ax: AxisGroup, dim: int) -> torch.Tensor:
    """All-gather ``x`` along ``dim`` over ``ax`` (rank order)."""
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((ax.size * src.shape[0], *src.shape[1:]))
    if ax.group is not None:
        import torch.distributed as dist
        dist.all_gather_into_tensor(out, src, group=ax.group)
    _report("all-gather", out)
    return out.movedim(0, dim)


def _scattered(x: torch.Tensor, ax: AxisGroup, dim: int) -> torch.Tensor:
    """Reduce-scatter (sum) ``x`` along ``dim`` over ``ax``."""
    dim = dim % x.dim()
    src = x.movedim(dim, 0).contiguous()
    if src.shape[0] % ax.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {ax.size} ranks")
    out = src.new_empty((src.shape[0] // ax.size, *src.shape[1:]))
    if ax.group is not None:
        import torch.distributed as dist
        dist.reduce_scatter_tensor(out, src, group=ax.group)
    _report("reduce-scatter", out)
    return out.movedim(0, dim)


def _summed(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """All-reduce (sum) of ``x`` over ``ax``, into a new tensor."""
    out = x.clone(memory_format=torch.contiguous_format)
    if ax.group is not None:
        import torch.distributed as dist
        dist.all_reduce(out, group=ax.group)
    _report("all-reduce", out)
    return out


def _own(x: torch.Tensor, ax: AxisGroup, dim: int) -> torch.Tensor:
    """This rank's contiguous slice of ``x`` along ``dim``."""
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {ax.size} ranks")
    k = n // ax.size
    return x.narrow(dim, ax.rank * k, k).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _summed(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, partial_use):
        ctx.ax, ctx.dim, ctx.partial = ax, dim, partial_use
        return _gathered(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.partial:
            return _scattered(g, ctx.ax, ctx.dim), None, None, None
        return _own(g, ctx.ax, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _own(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.ax, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _scattered(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _gathered(g, ctx.ax, ctx.dim), None, None


def _exchange(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    if ax.group is not None:
        import torch.distributed as dist
        dist.all_to_all_single(out, x.contiguous(), group=ax.group)
    _report("all-to-all", out)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _exchange(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.ax), None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """A column-parallel product's input: ``x`` itself, whose backward sums
    the cotangents of the model ranks (each holds the part its shard of
    the weight gives)."""
    ax = model_group()
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """A row-parallel product's output: the sum of the model ranks'
    partial ``x``, replicated; the cotangent passes through unchanged."""
    ax = model_group()
    return x if ax.size == 1 else _ReduceFrom.apply(x, ax)


def gather_from_model(x: torch.Tensor, dim: int,
                      partial_use: bool = False) -> torch.Tensor:
    """The model ranks' shards of ``x`` concatenated along ``dim`` in rank
    order.  Backward: this rank's slice of the cotangent when every rank
    uses the whole result alike, or with ``partial_use`` (each rank uses
    only a part of it) the sum of the ranks' cotangents, reduce-scattered."""
    ax = model_group()
    return x if ax.size == 1 else _Gather.apply(x, ax, dim, partial_use)


def scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's contiguous slice of replicated ``x`` along
    ``dim``; the backward all-gathers the ranks' cotangents."""
    ax = model_group()
    return x if ax.size == 1 else _Scatter.apply(x, ax, dim)


def all_to_all(x: torch.Tensor) -> torch.Tensor:
    """Exchange along leading dim 0 (of the model axis's size) over the
    model ranks: slice j goes to rank j, and slice j of the result came
    from rank j.  Its own adjoint."""
    ax = model_group()
    if ax.size == 1:
        return x
    if x.shape[0] != ax.size:
        raise ValueError(f"all_to_all: leading dim {x.shape[0]} is not the "
                         f"{ax.size} ranks")
    return _AllToAll.apply(x, ax)


def reduce_scatter_to_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum of the model ranks' partial ``x``, of which this rank keeps
    its contiguous slice along ``dim``; the backward all-gathers the
    ranks' cotangents."""
    ax = model_group()
    return x if ax.size == 1 else _ReduceScatter.apply(x, ax, dim)


# the sequence dim of a (B, S, d) activation
SEQ_DIM = 1


def seq_parallel(seq_len: int) -> bool:
    """Is the residual between blocks of a ``seq_len``-token sequence a
    sequence shard on this rank?  Where the active rules resolve
    ``seq_shard`` to the model axis, that axis has M > 1 ranks, carries no
    batch (``dp_only`` puts the batch there) and M divides ``seq_len``.
    False outside :func:`axis_rules`, under ``seq_shard: None`` and where
    the split does not apply (the layout then stays replicated).  A rule
    naming another axis raises: the layers' sequence collectives run over
    ``model``."""
    if _CTX.mesh is None:
        return False
    spec = _resolve("seq_shard")
    if spec is None:
        return False
    if spec != "model":
        raise NotImplementedError(f"seq_shard over {spec!r}: the port splits "
                                  f"the sequence over 'model' only")
    m = axis_size(_CTX.mesh, "model")
    return (m > 1 and "model" not in batch_axes(_CTX.mesh)
            and seq_len % m == 0)


def layer_in(x: torch.Tensor, sharded: bool, seq_shard: bool
             ) -> torch.Tensor:
    """A layer's input (B, S, d) from the residual's layout.  With
    ``seq_shard`` ``x`` is this rank's sequence shard and the whole
    sequence is all-gathered: for a layer that takes model shards
    (``sharded``) each rank's cotangent is partial and the backward
    reduce-scatters; for a layer run whole every rank uses the whole
    input alike and the backward keeps the rank's slice.  Without it
    ``x`` is replicated: :func:`copy_to_model` for a layer that takes
    shards, ``x`` itself for one run whole."""
    if seq_shard:
        # the gathered (M, B, S/M, d) buffer seen as (B, S, d) is strided:
        # one copy here, not one in each product that reads it
        return gather_from_model(x, SEQ_DIM, partial_use=sharded
                                 ).contiguous()
    return copy_to_model(x) if sharded else x


def layer_out(y: torch.Tensor, sharded: bool, seq_shard: bool
              ) -> torch.Tensor:
    """A layer's output (B, S, d) in the residual's layout: with
    ``seq_shard`` the rank's sequence shard of the row-parallel partial
    sums reduce-scattered (``sharded``), or of the whole result of a layer
    run whole (the backward all-gathers the ranks' cotangents, so every
    rank differentiates the whole layer); without it the partial sums
    all-reduced (``sharded``) or ``y`` itself."""
    if seq_shard:
        return (reduce_scatter_to_model(y, SEQ_DIM) if sharded
                else scatter_to_model(y, SEQ_DIM))
    return reduce_from_model(y) if sharded else y


def max_over(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """The elementwise max of ``x`` over ``ax``'s ranks, outside autograd
    (a softmax's stabiliser)."""
    if ax.size == 1:
        return x
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if ax.group is not None:
        import torch.distributed as dist
        dist.all_reduce(out, op=dist.ReduceOp.MAX, group=ax.group)
    _report("all-reduce", out)
    return out


def gather_over(x: torch.Tensor, ax: AxisGroup) -> torch.Tensor:
    """The ranks' ``x`` stacked along a new leading dim in rank order, for
    use in inference (no backward): the kv_seq ranks' partial
    attention."""
    if ax.size == 1:
        return x[None]
    return _gathered(x[None], ax, 0)
