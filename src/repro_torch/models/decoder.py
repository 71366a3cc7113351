"""Decoder-only transformer: the dense family (danube, smollm), the MoE
family (granite-moe, qwen3-moe: the MLP replaced by a top-k mixture of
experts whose load-balance loss is summed over layers) and the VLM family
(llava: projected patch embeddings put before the text embeddings).  GQA
attention with optional sliding windows or gemma3's local:global stack
(groups of ``local_global_ratio`` windowed layers and one global layer),
gated MLP, RMSNorm, tied embeddings.  Port of ``repro.models.decoder``.

Per-layer parameters and caches are stacked into (num_groups, group, ...)
leaves as in the reference, so JAX trees carry across unchanged
(``repro_torch.bridge``); the layers run as a Python loop over them.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_index, tree_map
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers.attention import attention_layer, attn_init
from repro_torch.models.layers.common import (he_init, rmsnorm, rmsnorm_init,
                                              rope_tables, stack_layers)
from repro_torch.models.layers.mlp import mlp, mlp_init
from repro_torch.models.layers.moe import moe_ffn, moe_init

FAMILIES = ("dense", "moe", "vlm")


# ---------------------------------------------------------------------------
# structure helpers
# ---------------------------------------------------------------------------

def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Per-layer attention kind within one group: r local layers and one
    global for a local:global ratio r, else all local with a sliding
    window, else all global."""
    g = scan_group_size(cfg)
    if cfg.local_global_ratio > 0:
        r = cfg.local_global_ratio
        return ["local"] * r + ["global"] * (g - r) if g == r + 1 else (
            (["local"] * r + ["global"]) * (g // (r + 1)))
    return ["local" if cfg.window_size > 0 else "global"] * g


def scan_group_size(cfg: ModelConfig) -> int:
    """Layers per stacked group: one local:global period, else
    ``cfg.scan_group``."""
    if cfg.local_global_ratio > 0:
        return cfg.local_global_ratio + 1
    return max(1, cfg.scan_group)


def num_groups(cfg: ModelConfig) -> int:
    g = scan_group_size(cfg)
    assert cfg.num_layers % g == 0, (cfg.num_layers, g)
    return cfg.num_layers // g


def _window(cfg: ModelConfig, kind: str) -> int:
    return cfg.window_size if kind == "local" else 0


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: the {cfg.family!r} family is not a "
                         f"decoder family ({', '.join(FAMILIES)})")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _layer_init(gen: Optional[torch.Generator], cfg: ModelConfig,
                dev: torch.device) -> Dict:
    p = {
        "ln1": rmsnorm_init(cfg.d_model, dev),
        "ln2": rmsnorm_init(cfg.d_model, dev),
        "attn": attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim),
    }
    if cfg.family == "moe":
        p["moe"] = moe_init(gen, cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
                            cfg.padded_experts)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """float32 parameter tree with the reference's nesting and shapes: "embed"
    (padded_vocab, d), "layers" with (num_groups, group, ...) leaves (a
    "moe" subtree in place of "mlp" for the MoE family), "final_norm", and
    for the VLM family "img_proj" (d, d).  Numbers come from ``generator``
    (else a generator on ``device`` seeded with ``seed``), layer by layer,
    then the embedding and the image projection; they do not reproduce
    ``jax.random``'s (the bridge carries JAX's).  ``device="meta"`` gives
    the tree's shapes alone, drawing nothing (as ``jax.eval_shape``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    meta = dev.type == "meta"
    gen = None if meta else generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    gdev = dev if gen is None else gen.device
    g, ng = scan_group_size(cfg), num_groups(cfg)
    with torch.device("meta") if meta else contextlib.nullcontext():
        params = {
            "layers": stack_layers(lambda: _layer_init(gen, cfg, gdev),
                                   (ng, g)),
            "embed": he_init(gen, (cfg.padded_vocab, cfg.d_model),
                             cfg.d_model),
            "final_norm": rmsnorm_init(cfg.d_model, gdev),
        }
        if cfg.family == "vlm":
            params["img_proj"] = he_init(gen, (cfg.d_model, cfg.d_model),
                                         cfg.d_model)
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            image_embeds: Optional[torch.Tensor] = None,
            caches: Optional[Dict] = None,
            positions: Optional[torch.Tensor] = None,
            backend: str = "cuda", need_aux: bool = True
            ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    """tokens (B, S) int -> (logits (B, S_total, padded_vocab), caches,
    aux), as the reference's.  ``aux`` is the MoE load-balance loss summed
    over layers (a float32 zero for the other families).  For the VLM
    family ``image_embeds`` (B, N_img, d), when given, are projected by
    ``img_proj`` and put before the text, so S_total = N_img + S.  With
    ``caches`` (from :func:`init_cache`) each layer writes its k/v into
    them in place and advances its position; ``backend`` picks the decode
    attention (``"cuda"``: the ``flash_decode`` kernel for one-token
    steps; ``"reference"``: the plain blockwise attention).  With
    ``need_aux=False`` the MoE layers skip the aux loss (a serving step
    discards it) and ``aux`` stays zero."""
    _check_family(cfg)
    kinds = layer_kinds(cfg)
    x = F.embedding(tokens, params["embed"]) * math.sqrt(cfg.d_model)
    if cfg.family == "vlm" and image_embeds is not None:
        img = image_embeds @ params["img_proj"]
        x = torch.cat([img.to(x.dtype), x], dim=1)
    x = constrain(x, "batch", "seq_shard", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.device)
    for gi in range(num_groups(cfg)):
        for i, kind in enumerate(kinds):
            lp = tree_index(params["layers"], gi, i)
            cache = tree_index(caches, gi, i) if caches is not None else None
            attn_in = constrain(rmsnorm(x, lp["ln1"], cfg.norm_eps),
                                "batch", None, None)
            h, _ = attention_layer(
                lp["attn"], attn_in, rope,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, causal=True, window=_window(cfg, kind),
                cache=cache, backend=backend)
            x = x + h
            h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                h2, a = moe_ffn(lp["moe"], h2, num_experts=cfg.num_experts,
                                top_k=cfg.experts_per_token,
                                capacity_factor=cfg.moe_capacity_factor,
                                act=cfg.act, need_aux=need_aux)
                if a is not None:
                    aux = aux + a
            else:
                h2 = mlp(lp["mlp"], h2, cfg.act)
            x = constrain(x + h2, "batch", "seq_shard", None)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = constrain(x @ params["embed"].T, "batch", None, "vocab")
    return logits, caches, aux


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """A uniform sliding window only needs ``window`` slots (a ring); a
    local:global stack keeps the full length (its global layers need it,
    and every layer's cache has one shape)."""
    if cfg.window_size > 0 and cfg.local_global_ratio == 0:
        return min(max_len, cfg.window_size)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None,
               dtype: torch.dtype = torch.float32) -> Dict:
    """Zero KV caches {"k", "v": (ng, g, batch, L, Hkv, D) of ``dtype``
    (float32, or bfloat16, the reference's default), "pos": (ng, g)
    int32} on ``device`` (default CUDA)."""
    _check_family(cfg)
    dev = resolve_device(device)
    ng, g = num_groups(cfg), scan_group_size(cfg)
    shape = (ng, g, batch, cache_len(cfg, max_len), cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((ng, g), dtype=torch.int32, device=dev)}


def cache_specs(cfg: ModelConfig) -> Dict:
    """Logical axes of each cache leaf, as the reference's."""
    return {"k": (None, None, "batch", "kv_seq", None, "kv_hd"),
            "v": (None, None, "batch", "kv_seq", None, "kv_hd"),
            "pos": (None, None)}

