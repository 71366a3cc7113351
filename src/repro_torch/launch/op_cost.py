"""Op-level cost counter of one eager step: the port's counterpart of
``repro.launch.hlo_cost``.

There is no compiled HLO to read, so :class:`OpCost` counts the aten ops
the step dispatches (a ``TorchDispatchMode``), on meta tensors (a static
count: shapes alone, nothing allocated) or on real ones.  ``analyze()``
returns ``hlo_cost``'s keys and two more:

    flops            — matmul and convolution FLOPs, as
                       ``torch.utils.flop_counter``'s registry counts them
                       (the set ``hlo_cost`` counts: dot and convolution)
    bytes            — operand plus result bytes of every op that touches
                       memory; views and metadata ops are free
    collective_bytes — bytes of the collectives the step issues (and the
                       dry run's gradient-sync plan), per kind in
                       ``collectives``
    ops              — ops that touch memory, kernel launches included
    peak_live_bytes  — the high-water mark of the bytes of the tensors the
                       step made and still holds (its arguments excluded)

``bytes`` differs from ``hlo_cost``'s fusion-boundary rule: XLA fuses
elementwise chains, so ``hlo_cost`` charges only the ops that materialise
(fusions, dots, copies, gathers...), while eager PyTorch writes every op's
result to memory and reads it back in the next, so every op is charged.
This is what the port moves, and more than the JAX program moves for the
same step.  An operand broadcast by stride 0 is charged its distinct
elements.  An in-place scatter (``index_copy_``, ``index_put_``,
``scatter_``...) is charged its sources twice (read, then written into
the target) and not the target, which it does not sweep; ``copy_`` and
``fill_`` are charged what they read and what they write.

The hand-written kernels are extension calls, invisible to a dispatch
mode, so each kernel wrapper is decorated with
``common.cost.reports_work``: under an active counter (an :class:`OpCost`
pushes itself onto ``common.cost``'s registry) it adds the kernel's work
function's ``(flops, bytes)`` and one op, and suspends the counting of the aten ops inside (the plain
version on the CPU, the output allocation on the card), so the work
counts once whichever implementation runs.  A kernel's flops are its dot
products, as the plain version's matmuls would count.

Usage::

    with OpCost() as c:
        step(params, batch)
    c.analyze()
"""
from __future__ import annotations

import collections
import contextlib
import functools
import weakref
from typing import Dict, Iterator, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.common import cost

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

_aten = torch.ops.aten
# ops that allocate or describe a tensor without touching its memory
_FREE = {
    _aten.empty, _aten.empty_like, _aten.empty_strided, _aten.new_empty,
    _aten.new_empty_strided, _aten.detach, _aten.lift_fresh, _aten.alias,
    _aten.set_, _aten.resize_, _aten.sym_size, _aten.sym_stride,
    _aten.sym_numel, _aten.sym_storage_offset, _aten.is_same_size,
    _aten._local_scalar_dense,
}
# in-place scatters: the sources are read and written into the target,
# which is not swept
_SCATTER = {
    _aten.index_copy_, _aten.index_put_, _aten.scatter_, _aten.scatter_add_,
    _aten.index_add_, _aten.scatter_reduce_, _aten._index_put_impl_,
}
# write-only targets: copy_ reads its source, fill_/zero_ nothing
_WRITE_ONLY = {_aten.copy_, _aten.fill_, _aten.zero_}

def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements ``t`` addresses (dims of stride 0,
    a broadcast, count once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """Whether ``func`` is a CompositeImplicitAutograd op (one that
    decomposes into others), which reaches a dispatch mode whole under
    ``inference_mode``."""
    return torch._C._dispatch_has_kernel_for_dispatch_key(
        func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)


# (op, argument metadata) -> (output metadata, single, cost) of meta ops
# whose outputs are fresh tensors, () for one that is not: the same op on
# the same shapes costs the same, and its outputs' metadata need not be
# recomputed
_MEMO: Dict[tuple, tuple] = {}
_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.layout, torch.memory_format)


@functools.lru_cache(maxsize=None)
def _fresh(func) -> bool:
    """Whether ``func`` writes no argument and returns no alias of one."""
    if func.is_view:
        return False
    schema = func._schema
    return not any(a.alias_info is not None
                   for a in (*schema.arguments, *schema.returns))


def _key(x):
    if isinstance(x, torch.Tensor):
        if x.device.type != "meta":
            raise TypeError
        return (x.shape, x.stride(), x.dtype, x.storage_offset())
    if isinstance(x, (tuple, list)):
        return (type(x), *map(_key, x))
    if isinstance(x, dict):
        return tuple((k, _key(v)) for k, v in x.items())
    if isinstance(x, _PLAIN):
        return (type(x), x)
    raise TypeError


def _meta_key(func, args, kwargs, ins):
    """The memo key of an op on meta tensors ``ins`` (its tensor
    arguments), or None (no tensor argument, one not on meta, not fresh,
    or an argument the key cannot hold)."""
    if not ins or not _fresh(func):
        return None
    try:
        return (func, _key(args), _key(kwargs))
    except TypeError:
        return None


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in nested tuples, lists and dicts (an op's arguments
    or results)."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


class OpCost(TorchDispatchMode):
    """Counts the flops, bytes, ops, collectives and peak live bytes of the
    ops run inside it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.ops = 0
        self.collectives: Dict[str, float] = dict.fromkeys(COLLECTIVES, 0.0)
        self.flops_by_op: Dict[str, float] = collections.defaultdict(float)
        self.kernels: Dict[str, Dict[str, float]] = {}
        self._quiet = 0
        self._live: Dict[int, int] = {}
        self._live_bytes = 0
        self.peak_live_bytes = 0

    # -- context ----------------------------------------------------------
    def __enter__(self):
        cost.push(self)
        return super().__enter__()

    def __exit__(self, *exc):
        cost.pop(self)
        return super().__exit__(*exc)

    @contextlib.contextmanager
    def kernel(self, name: str, flops: float, nbytes: float) -> Iterator:
        """Count one launch of kernel ``name`` doing ``flops`` and moving
        ``nbytes``, and none of the aten ops run inside (a kernel nested
        in another counts as part of it)."""
        if not self._quiet:
            self.flops += flops
            self.bytes += nbytes
            self.ops += 1
            self.flops_by_op[name] += flops
            k = self.kernels.setdefault(
                name, {"calls": 0, "flops": 0.0, "bytes": 0.0})
            k["calls"] += 1
            k["flops"] += flops
            k["bytes"] += nbytes
        self._quiet += 1
        try:
            yield
        finally:
            self._quiet -= 1

    def collective(self, kind: str, nbytes: float) -> None:
        """Count one collective of ``kind`` (``COLLECTIVES``) whose result
        holds ``nbytes`` (``hlo_cost``'s measure)."""
        if kind not in self.collectives:
            raise ValueError(f"unknown collective {kind!r}")
        self.collectives[kind] += nbytes

    # -- live bytes -------------------------------------------------------
    def _freed(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, outs, ins) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self._live:
                continue
            seen.add(key)
            self._live[key] = st.nbytes()
            self._live_bytes += st.nbytes()
            weakref.finalize(st, self._freed, key)
        self.peak_live_bytes = max(self.peak_live_bytes, self._live_bytes)

    # -- dispatch ---------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _composite(func):
            # a composite op (matmul, einsum... reach the mode whole under
            # inference_mode): count the ops it decomposes into instead
            TorchDispatchMode.__enter__(self)
            try:
                r = func.decompose(*args, **kwargs)
            finally:
                TorchDispatchMode.__exit__(self, None, None, None)
            if r is not NotImplemented:
                return r
        ins = _tensors((args, kwargs))
        key = _meta_key(func, args, kwargs, ins)
        hit = _MEMO.get(key) if key is not None else None
        if hit:
            # a meta op seen before: its outputs from their metadata
            # alone, skipping the (Python) meta kernel
            specs, single, cost = hit
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in specs]
            self._track(outs, ())
            self._count(func, *cost)
            return outs[0] if single else tuple(outs)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._track(outs, ins)
        cost = self._cost(func, args, kwargs, out, ins, outs)
        self._count(func, *cost)
        if key is not None:
            # an op that returns an input's storage (``_unsafe_view``
            # carries no alias annotation) or a non-tensor is not memoised
            shared = {t.untyped_storage()._cdata for t in ins}
            ok = (isinstance(out, torch.Tensor) or (
                isinstance(out, (tuple, list)) and len(outs) == len(out))
            ) and not any(t.untyped_storage()._cdata in shared for t in outs)
            _MEMO[key] = ([(tuple(t.shape), t.stride(), t.dtype)
                           for t in outs], isinstance(out, torch.Tensor),
                          cost) if ok else ()
        return out

    @staticmethod
    def _cost(func, args, kwargs, out, ins, outs) -> Tuple[float, float, int]:
        """(flops, bytes, ops) of one op (see the module docstring)."""
        packet = func._overloadpacket
        f = 0.0
        if packet in flop_registry:
            f = float(flop_registry[packet](*args, **kwargs, out_val=out))
        if func.is_view or packet in _FREE:
            return f, 0.0, 0
        if packet in _SCATTER:
            b = 2 * sum(tensor_bytes(t) for t in ins[1:])
        elif packet in _WRITE_ONLY:
            b = sum(tensor_bytes(t) for t in ins[1:]) + tensor_bytes(ins[0])
        else:
            b = (sum(tensor_bytes(t) for t in ins)
                 + sum(tensor_bytes(t) for t in outs))
        return f, float(b), 1

    def _count(self, func, flops: float, nbytes: float, ops: int) -> None:
        if self._quiet:
            return
        if flops:
            self.flops += flops
            self.flops_by_op[func._overloadpacket.__name__] += flops
        self.bytes += nbytes
        self.ops += ops

    def analyze(self) -> Dict:
        """``hlo_cost.analyze_hlo``'s keys plus ``ops``,
        ``peak_live_bytes``, ``flops_by_op`` and ``kernels``."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_bytes": sum(self.collectives.values()),
            "collectives": dict(self.collectives),
            "ops": self.ops,
            "peak_live_bytes": self.peak_live_bytes,
            "flops_by_op": dict(self.flops_by_op),
            "kernels": {k: dict(v) for k, v in self.kernels.items()},
        }
