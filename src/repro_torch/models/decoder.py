"""Decoder-only transformer, dense family (danube, smollm): GQA attention
with optional sliding windows, gated MLP, RMSNorm, tied embeddings.  Port
of the dense part of ``repro.models.decoder`` (MoE and VLM are not
ported: ROADMAP.md, Queue 1 item 13).

Per-layer parameters and caches are stacked into (num_groups, group, ...)
leaves as in the reference, so JAX trees carry across unchanged
(``repro_torch.bridge``); the layers run as a Python loop over them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.models.layers.attention import attention_layer, attn_init
from repro_torch.models.layers.common import (he_init, rmsnorm, rmsnorm_init,
                                              rope_tables)
from repro_torch.models.layers.mlp import mlp, mlp_init


# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------

def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Per-layer attention kind within one group: all local with a
    sliding window, else all global."""
    return ["local" if cfg.window_size > 0 else "global"] * scan_group_size(
        cfg)


def scan_group_size(cfg: ModelConfig) -> int:
    return max(1, cfg.scan_group)


def num_groups(cfg: ModelConfig) -> int:
    g = scan_group_size(cfg)
    assert cfg.num_layers % g == 0, (cfg.num_layers, g)
    return cfg.num_layers // g


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind == "local" else 0


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported (only "
            f"'dense' is; see ROADMAP.md, Queue 1 item 13)")
    if cfg.local_global_ratio > 0:
        raise NotImplementedError(
            f"{cfg.name}: the local:global stack (gemma3) is not ported "
            f"(see ROADMAP.md, Queue 1 item 13)")


def _stack(trees: List[Any]) -> Any:
    """Stack matching trees of tensors leaf by leaf along a new axis 0."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def _index(tree: Any, gi: int, i: int) -> Any:
    """The (gi, i) slice (a view) of every leaf of a stacked tree."""
    if isinstance(tree, dict):
        return {k: _index(v, gi, i) for k, v in tree.items()}
    return tree[gi, i]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    dev = gen.device
    return {
        "ln1": rmsnorm_init(cfg.d_model, dev),
        "ln2": rmsnorm_init(cfg.d_model, dev),
        "attn": attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff),
    }


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """float32 parameter tree with the reference's nesting and shapes: "embed"
    (padded_vocab, d), "layers" with (num_groups, group, ...) leaves,
    "final_norm".  Numbers come from ``generator`` (else a generator on
    ``device`` seeded with ``seed``), layer by layer, then the embedding;
    they do not reproduce ``jax.random``'s (the bridge carries JAX's)."""
    _check_family(cfg)
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator(
        device=dev).manual_seed(seed)
    g, ng = scan_group_size(cfg), num_groups(cfg)
    groups = [_stack([_layer_init(gen, cfg) for _ in range(g)])
              for _ in range(ng)]
    params = {
        "embed": he_init(gen, (cfg.padded_vocab, cfg.d_model), cfg.d_model),
        "layers": _stack(groups),
        "final_norm": rmsnorm_init(cfg.d_model, gen.device),
    }
    return _to(params, dev)


def _to(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            caches: Optional[Dict] = None,
            positions: Optional[torch.Tensor] = None,
            backend: str = "cuda") -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, S) int -> (logits (B, S, padded_vocab), caches).  With
    ``caches`` (from :func:`init_cache`) each layer writes its k/v into
    them in place and advances its position; ``backend`` picks the decode
    attention (``"cuda"``: the ``flash_decode`` kernel for one-token
    steps; ``"reference"``: the plain blockwise attention)."""
    _check_family(cfg)
    kinds = layer_kinds(cfg)
    x = F.embedding(tokens, params["embed"]) * math.sqrt(cfg.d_model)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.device)
    for gi in range(num_groups(cfg)):
        for i, kind in enumerate(kinds):
            lp = _index(params["layers"], gi, i)
            cache = _index(caches, gi, i) if caches is not None else None
            h, _ = attention_layer(
                lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), rope,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, causal=True, window=_window(cfg, kind), cache=cache,
                backend=backend)
            x = x + h
            x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps),
                        cfg.act)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ params["embed"].T, caches


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """A sliding window only needs ``window`` slots (a ring)."""
    if cfg.window_size > 0:
        return min(max_len, cfg.window_size)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict:
    """Zero KV caches {"k", "v": (ng, g, batch, L, Hkv, D), "pos": (ng, g)
    int32} on ``device`` (default CUDA).  float32: the ``flash_decode``
    kernel takes float32 caches (the reference defaults to bfloat16)."""
    _check_family(cfg)
    dev = resolve_device(device)
    ng, g = num_groups(cfg), scan_group_size(cfg)
    shape = (ng, g, batch, cache_len(cfg, max_len), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=torch.float32, device=dev),
            "v": torch.zeros(shape, dtype=torch.float32, device=dev),
            "pos": torch.zeros((ng, g), dtype=torch.int32, device=dev)}
