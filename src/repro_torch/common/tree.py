"""Tree utilities over the port's parameter and optimizer trees: nested
dicts, lists, tuples and NamedTuples with tensor leaves (``None`` is an
empty subtree, as in JAX).  Leaves come in JAX's order — dict keys sorted,
NamedTuple fields and sequence items in order — so a tree's flat leaves and
their paths line up with the same tree's in ``repro.common.tree`` and
``repro.checkpoint.store``."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch


def _is_namedtuple(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node: Any) -> Iterator[Tuple[str, Any]]:
    """(path element, child) of a container node, in JAX's order: a dict
    key as itself, a NamedTuple field as ``.name`` (JAX's attribute key),
    a sequence index as its number."""
    if isinstance(node, dict):
        for k in sorted(node):
            yield str(k), node[k]
    elif _is_namedtuple(node):
        for f in node._fields:
            yield f".{f}", getattr(node, f)
    else:
        for i, v in enumerate(node):
            yield str(i), v


def _is_container(node: Any) -> bool:
    return isinstance(node, (dict, list, tuple))


def _walk(node: Any, prefix: List[str], out: List[Tuple[str, Any]]) -> None:
    if node is None:
        return
    if not _is_container(node):
        out.append(("/".join(prefix), node))
        return
    for k, v in _children(node):
        _walk(v, prefix + [k], out)


def tree_paths(tree: Any) -> List[Tuple[str, Any]]:
    """``[(path, leaf)]`` with JAX's checkpoint leaf names: path elements
    joined by ``/`` (``blocks/0/Wk``, ``.m/fc_w``).  The walk is a module
    function, not a closure: a self-referencing closure is a reference
    cycle that kept every leaf alive until the cyclic collector ran."""
    out: List[Tuple[str, Any]] = []
    _walk(tree, [], out)
    return out


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in tree_paths(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); containers keep their type."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_index(tree: Any, *idx: int) -> Any:
    """The ``idx`` slice (a view) of every leaf of a stacked tree."""
    return tree_map(lambda t: t[idx], tree)


def tree_copy_(dst: Any, src: Any) -> None:
    """Copy ``src``'s leaves into ``dst``'s (same structure) in place."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with its leaves replaced by ``leaves``, given
    in JAX's order (:func:`tree_leaves`)."""
    return _rebuild(like, iter(leaves))


def _rebuild(node: Any, leaves: Iterator[Any]) -> Any:
    if node is None:
        return None
    if not _is_container(node):
        return next(leaves)
    if isinstance(node, dict):      # sorted keys take the leaves in order
        done = {k: _rebuild(node[k], leaves) for k in sorted(node)}
        return {k: done[k] for k in node}
    items = [_rebuild(v, leaves) for v in node]
    if _is_namedtuple(node):
        return type(node)(*items)
    return type(node)(items)


def param_count(tree: Any) -> int:
    """The number of elements over every leaf."""
    return sum(int(x.numel()) for x in tree_leaves(tree))


def tree_bytes(tree: Any) -> int:
    """The bytes the leaves hold (elements × element size)."""
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(tree))


def tree_norm(tree: Any) -> torch.Tensor:
    """The global L2 norm over every leaf, in float32 (a 0-d tensor)."""
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(x.float().square().sum() for x in leaves))


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Floating-point leaves cast to ``dtype``; other leaves unchanged."""
    return tree_map(
        lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a ``torch.distributed`` DTensor."""
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)
