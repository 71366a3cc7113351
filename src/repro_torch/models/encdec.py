"""Encoder-decoder transformer (the whisper-small backbone).  Port of
``repro.models.encdec``.

The conv/mel front end is a stub, as in the reference: the encoder takes
frame embeddings (B, encoder_frames, d).  LayerNorm, learned absolute
positions (``enc_pos``, ``dec_pos``) added to the inputs on top of the
self-attention's RoPE (the reference applies both), a non-gated MLP with
the tanh-form GELU (``jax.nn.gelu``'s default).  The encoder's
self-attention is not causal; each decoder layer has a causal
self-attention with a KV cache and a cross-attention over the encoder
memory (no RoPE, no mask, no cache).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_index, tree_map
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers.attention import attention_layer, attn_init
from repro_torch.models.layers.common import (he_init, layernorm,
                                              layernorm_init, rope_tables,
                                              stack_layers)

DEC_POSITIONS = 32_768     # rows of the decoder's learned positions


def _mlp_init(gen, d: int, dff: int) -> Dict:
    return {"wi": he_init(gen, (d, dff), d), "wo": he_init(gen, (dff, d), dff)}


def _mlp(p: Dict, x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x @ p["wi"], approximate="tanh") @ p["wo"]


def _enc_layer_init(gen, cfg: ModelConfig, dev) -> Dict:
    return {
        "ln1": layernorm_init(cfg.d_model, dev),
        "ln2": layernorm_init(cfg.d_model, dev),
        "attn": attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim),
        "mlp": _mlp_init(gen, cfg.d_model, cfg.d_ff),
    }


def _dec_layer_init(gen, cfg: ModelConfig, dev) -> Dict:
    p = _enc_layer_init(gen, cfg, dev)
    p["ln_x"] = layernorm_init(cfg.d_model, dev)
    p["xattn"] = attn_init(gen, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """float32 parameters with the reference's nesting and shapes:
    "embed", "enc_pos" (encoder_frames, d), "dec_pos" (32 768, d),
    "enc_layers" and "dec_layers" ((layers, ...) leaves), "enc_norm",
    "dec_norm".  Numbers come from ``generator`` (else one on ``device``
    seeded with ``seed``); ``device="meta"`` gives the shapes alone."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    gen = None if meta else generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    gdev = dev if gen is None else gen.device
    enc_l = cfg.encoder_layers or cfg.num_layers
    with torch.device("meta") if meta else contextlib.nullcontext():
        params = {
            "enc_layers": stack_layers(
                lambda: _enc_layer_init(gen, cfg, gdev), (enc_l,)),
            "dec_layers": stack_layers(
                lambda: _dec_layer_init(gen, cfg, gdev), (cfg.num_layers,)),
            "embed": he_init(gen, (cfg.padded_vocab, cfg.d_model),
                             cfg.d_model),
            "enc_pos": he_init(gen, (cfg.encoder_frames, cfg.d_model),
                               cfg.d_model) * 0.02,
            "dec_pos": he_init(gen, (DEC_POSITIONS, cfg.d_model),
                               cfg.d_model) * 0.02,
            "enc_norm": layernorm_init(cfg.d_model, gdev),
            "dec_norm": layernorm_init(cfg.d_model, gdev),
        }
    return tree_map(lambda t: t.to(dev), params)


def _heads(cfg: ModelConfig) -> Dict:
    return dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim)


def _enc_layer(cfg, lp, h, rope):
    a, _ = attention_layer(lp["attn"], layernorm(h, lp["ln1"]), rope,
                           causal=False, **_heads(cfg))
    h = h + a
    h = h + _mlp(lp["mlp"], layernorm(h, lp["ln2"]))
    return constrain(h, "batch", None, None)


def encode(params: Dict, frames: torch.Tensor, cfg: ModelConfig
           ) -> torch.Tensor:
    """frames (B, F, d) stub embeddings -> encoder memory (B, F, d).
    Under autograd each layer is recomputed in the backward (the
    reference's ``jax.checkpoint``)."""
    x = frames + params["enc_pos"][None, :frames.shape[1]]
    x = constrain(x, "batch", None, None)
    rope = rope_tables(torch.arange(x.shape[1], device=x.device),
                       cfg.head_dim, cfg.rope_theta, x.device)
    n = params["enc_layers"]["ln1"]["scale"].shape[0]
    for i in range(n):
        lp = tree_index(params["enc_layers"], i)
        if torch.is_grad_enabled() and x.requires_grad:
            x = checkpoint(_enc_layer, cfg, lp, x, rope, use_reentrant=False)
        else:
            x = _enc_layer(cfg, lp, x, rope)
    return layernorm(x, params["enc_norm"])


def _dec_layer(cfg, lp, h, memory, rope, cache, backend):
    a, _ = attention_layer(lp["attn"], layernorm(h, lp["ln1"]), rope,
                           causal=True, cache=cache, backend=backend,
                           **_heads(cfg))
    h = h + a
    xa, _ = attention_layer(lp["xattn"], layernorm(h, lp["ln_x"]), None,
                            causal=False, memory=memory, backend=backend,
                            **_heads(cfg))
    h = h + xa
    h = h + _mlp(lp["mlp"], layernorm(h, lp["ln2"]))
    return constrain(h, "batch", None, None)


def decode(params: Dict, tokens: torch.Tensor, memory: torch.Tensor,
           cfg: ModelConfig, caches: Optional[Dict] = None,
           positions: Optional[torch.Tensor] = None, backend: str = "cuda"
           ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, S), memory (B, F, d) -> (logits (B, S, padded_vocab),
    caches).  With caches (from :func:`init_cache`) each layer writes its
    self-attention k/v in place and advances its position; ``backend``
    picks the one-token attention (``"cuda"``: ``flash_decode`` for the
    cached self-attention and for the cross-attention)."""
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)
    x = F.embedding(tokens, params["embed"])
    x = x + F.embedding(positions.long(), params["dec_pos"])
    x = constrain(x, "batch", None, None)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.device)
    for i in range(cfg.num_layers):
        lp = tree_index(params["dec_layers"], i)
        cache = tree_index(caches, i) if caches is not None else None
        if cache is None and torch.is_grad_enabled() and x.requires_grad:
            x = checkpoint(_dec_layer, cfg, lp, x, memory, rope, None,
                           backend, use_reentrant=False)
        else:
            x = _dec_layer(cfg, lp, x, memory, rope, cache, backend)
    x = layernorm(x, params["dec_norm"])
    logits = x @ params["embed"].T
    return constrain(logits, "batch", None, "vocab"), caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None,
               dtype: torch.dtype = torch.float32) -> Dict:
    """Zero self-attention caches {"k", "v": (layers, B, max_len, Hkv, D)
    of ``dtype`` (float32, or bfloat16, the reference's default), "pos":
    (layers,) int32} on ``device`` (default CUDA)."""
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros(cfg.num_layers, dtype=torch.int32, device=dev)}


def cache_specs(cfg: ModelConfig) -> Dict:
    """Logical axes of each cache leaf, as the reference's."""
    return {"k": (None, "batch", "kv_seq", None, "kv_hd"),
            "v": (None, "batch", "kv_seq", None, "kv_hd"),
            "pos": (None,)}
