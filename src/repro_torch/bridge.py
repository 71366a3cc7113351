"""Trees across frameworks, as numpy arrays: the JAX ``init_params`` tree
becomes the port's parameter tree (the LM's (num_groups, group, ...)
stacked leaves keep their nesting), a JAX ``StreamState`` or snapshot ring
becomes the port's (and back), and so do an LM KV cache and an AdamW
``OptState``.  ``jax.random``
cannot be reproduced with torch, so the parity tests move weights,
mid-stream slabs and mid-sequence caches this way."""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.core.agcn.engine import StreamState
from repro_torch.kernels.rfc_pack import bits_from_hot, hot_from_bits

_STATE_FIELDS = tuple(f.name for f in dataclasses.fields(StreamState))


def _to_torch(node: Any, dev: torch.device) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _to_torch(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_torch(v, dev) for v in node]
    return torch.as_tensor(np.array(node, copy=True), device=dev)


def _to_numpy(node: Any) -> Any:
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: _to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_numpy(v) for v in node]
    return node.detach().cpu().numpy()


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists/tuples of array-likes -> the same nesting (tuples
    become lists) of tensors on ``device`` (default CUDA), values and
    dtypes unchanged."""
    return _to_torch(tree, resolve_device(device))


def _map_rfc(tree: dict, fn) -> dict:
    """``tree`` with each boundary of its ``rfc`` carry (a list of dicts,
    where present) mapped through ``fn``."""
    if tree.get("rfc") is None:
        return tree
    return {**tree, "rfc": [fn(r) for r in tree["rfc"]]}


def stream_state_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A stream state with numpy leaves -> the port's, on ``device``
    (default CUDA).  ``tree`` is an object with the ``StreamState`` fields
    as attributes (a JAX ``StreamState`` mapped to numpy) or a dict of
    them, which becomes a ``StreamState``; a snapshot capture or snapshot
    ring (a dict without ``bn_stats``) stays a dict.  The JAX RFC carry's
    float ``hot`` mask becomes the port's int16 ``bits``; other dtypes are
    unchanged."""
    dev = resolve_device(device)
    if not isinstance(tree, dict):
        tree = {f: getattr(tree, f) for f in _STATE_FIELDS}
    out = _map_rfc(_to_torch(tree, dev), lambda r: {
        "vals": r["vals"], "bits": bits_from_hot(r["hot"])})
    return out if "bn_stats" not in tree else StreamState(**out)


def stream_state_to_numpy(state: Any) -> dict:
    """The port's ``StreamState``, snapshot capture or snapshot ring -> a
    dict of numpy leaves with the same field names (``StreamState(**d)``
    rebuilds the JAX one): the RFC carry's ``bits`` go back to the JAX
    float ``hot`` mask of the values' width, other dtypes are unchanged."""
    if isinstance(state, StreamState):
        state = {f: getattr(state, f) for f in _STATE_FIELDS}
    return _to_numpy(_map_rfc(state, lambda r: {
        "vals": r["vals"],
        "hot": hot_from_bits(r["bits"], r["vals"].dtype)[
            ..., :r["vals"].shape[-1]]}))


_CACHE_KEYS = {"k", "v", "pos"}


def kv_cache_from_numpy(tree: Any, device: DeviceLike = None) -> dict:
    """A dense LM's KV cache {"k", "v": (ng, g, B, L, Hkv, D), "pos":
    (ng, g) int32} with numpy leaves -> the port's, on ``device`` (default
    CUDA), dtypes unchanged."""
    if set(tree) != _CACHE_KEYS:
        raise ValueError(f"a KV cache has keys {sorted(_CACHE_KEYS)}, got "
                         f"{sorted(tree)}")
    return _to_torch(dict(tree), resolve_device(device))


def kv_cache_to_numpy(cache: dict) -> dict:
    """The port's KV cache -> a dict of numpy leaves (what the reference's
    ``serve_fn`` takes after ``jnp.asarray``)."""
    return _to_numpy(cache)


def opt_state_from_numpy(state: Any, device: DeviceLike = None):
    """An AdamW state with numpy leaves (a JAX ``OptState`` mapped to
    numpy, or any object with ``step``, ``m`` and ``v``) -> the port's
    ``OptState`` on ``device`` (default CUDA), dtypes unchanged."""
    from repro_torch.optim.adamw import OptState
    dev = resolve_device(device)
    return OptState(step=_to_torch(state.step, dev),
                    m=_to_torch(state.m, dev), v=_to_torch(state.v, dev))


def opt_state_to_numpy(state: Any) -> dict:
    """The port's ``OptState`` -> {"step", "m", "v"} of numpy leaves
    (``OptState(**d)`` rebuilds the JAX one)."""
    return {"step": _to_numpy(state.step), "m": _to_numpy(state.m),
            "v": _to_numpy(state.v)}
