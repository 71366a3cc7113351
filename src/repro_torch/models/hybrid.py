"""Zamba2-style hybrid: a Mamba2 backbone with one shared (weight-tied)
attention + MLP block applied at every group boundary.  Port of
``repro.models.hybrid``.

Structure (``cfg.num_layers`` applications): ``ng`` groups of [the shared
block, then ``shared_attn_every`` mamba layers], and a tail of mamba
layers so the counts match exactly (81 = 11 × (1 + 6) + 4 for zamba2-7b).
The shared block's weights are one set, applied ng times (autograd sums
their gradients); each use has its own input-norm scale (``use_ln``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_copy_, tree_index, tree_map
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers.attention import attention_layer, attn_init
from repro_torch.models.layers.common import (he_init, rmsnorm, rmsnorm_init,
                                              rope_tables, stack_layers,
                                              wide_dtype)
from repro_torch.models.layers.mamba2 import HEAD_P, mamba2_init, mamba2_layer
from repro_torch.models.layers.mlp import mlp, mlp_init


def structure(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(num_groups, mamba layers per group, tail mamba layers)."""
    per = cfg.shared_attn_every
    ng = cfg.num_layers // (per + 1)
    return ng, per, cfg.num_layers - ng * (per + 1)


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """float32 parameters with the reference's nesting and shapes:
    "embed", "mamba_groups" ((ng, per, ...) leaves), "mamba_tail"
    ((tail, ...) leaves, ``None`` without a tail), "shared" (one attention
    block, its MLP and its second norm), "use_ln" {"scale": (ng, d)},
    "final_norm".  Numbers come from ``generator`` (else one on
    ``device`` seeded with ``seed``): the mamba layers in order, then the
    shared block and the embedding; ``device="meta"`` gives the shapes
    alone."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    gen = None if meta else generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    gdev = dev if gen is None else gen.device
    ng, per, tail = structure(cfg)

    def mamba():
        return {"ln": rmsnorm_init(cfg.d_model, gdev),
                "cell": mamba2_init(gen, cfg.d_model, cfg.ssm_state,
                                    cfg.ssm_expand, cfg.ssm_conv, gdev)}
    with torch.device("meta") if meta else contextlib.nullcontext():
        params = {
            "mamba_groups": stack_layers(mamba, (ng, per)),
            "mamba_tail": stack_layers(mamba, (tail,)) if tail else None,
            "shared": {
                "attn": attn_init(gen, cfg.d_model, cfg.num_heads,
                                  cfg.num_kv_heads, cfg.head_dim),
                "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff),
                "ln2": rmsnorm_init(cfg.d_model, gdev),
            },
            "use_ln": {"scale": torch.ones((ng, cfg.d_model), device=gdev)},
            "embed": he_init(gen, (cfg.padded_vocab, cfg.d_model),
                             cfg.d_model),
            "final_norm": rmsnorm_init(cfg.d_model, gdev),
        }
    return tree_map(lambda t: t.to(dev), params)


def _shared_block(cfg, shared, ln_scale, x, rope, cache, backend):
    h = rmsnorm(x, {"scale": ln_scale}, cfg.norm_eps)
    a, _ = attention_layer(
        shared["attn"], h, rope, num_heads=cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, causal=True,
        cache=cache, backend=backend)
    x = x + a
    return x + mlp(shared["mlp"], rmsnorm(x, shared["ln2"], cfg.norm_eps),
                   cfg.act)


def _mamba_block(cfg, lp, x, cache):
    h, new_c = mamba2_layer(lp["cell"], rmsnorm(x, lp["ln"], cfg.norm_eps),
                            cfg.ssm_state, cfg.ssm_expand, cache)
    if cache is not None:
        tree_copy_(cache, new_c)
    return x + h


def _group(cfg, shared, gp, ln_scale, x, rope, cache, backend):
    """The shared block, then the group's mamba layers; a cache slice is
    updated in place."""
    x = _shared_block(cfg, shared, ln_scale, x, rope,
                      cache["attn"] if cache is not None else None, backend)
    for i in range(cfg.shared_attn_every):
        x = _mamba_block(cfg, tree_index(gp, i), x,
                         tree_index(cache["mamba"], i)
                         if cache is not None else None)
    return constrain(x, "batch", "seq_shard", None)


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            caches: Optional[Dict] = None,
            positions: Optional[torch.Tensor] = None, backend: str = "cuda"
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, S) -> (logits (B, S, padded_vocab), caches).  Without
    caches the cache-free forward (the chunked SSD scan; under autograd
    each group is recomputed in the backward, as the reference's
    ``jax.checkpoint``); with caches (from :func:`init_cache`) a decode
    step, the caches updated in place and returned.  ``backend`` picks the
    shared attention's decode path (``"cuda"``: ``flash_decode`` for a
    one-token step).

    A conv leaf narrower than the activations (a bf16 cache) is widened
    to their dtype at the first step, as the reference's conv step
    returns its context (the bf16 cache concatenated with float32 inputs
    is float32): from then on the context is read unrounded, as there."""
    ng, per, tail = structure(cfg)
    x = F.embedding(tokens, params["embed"]) * math.sqrt(cfg.d_model)
    if caches is not None:
        for part in (caches["groups"]["mamba"], caches.get("tail")):
            if part is not None and part["conv"].dtype != x.dtype:
                part["conv"] = part["conv"].to(x.dtype)
    x = constrain(x, "batch", "seq_shard", None)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.device)
    shared = params["shared"]
    for gi in range(ng):
        gp = tree_index(params["mamba_groups"], gi)
        ln = params["use_ln"]["scale"][gi]
        cache = tree_index(caches["groups"], gi) if caches is not None \
            else None
        if cache is None and torch.is_grad_enabled() and x.requires_grad:
            x = checkpoint(_group, cfg, shared, gp, ln, x, rope, None,
                           backend, use_reentrant=False)
        else:
            x = _group(cfg, shared, gp, ln, x, rope, cache, backend)
    for i in range(tail):
        x = _mamba_block(cfg, tree_index(params["mamba_tail"], i), x,
                         tree_index(caches["tail"], i)
                         if caches is not None else None)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["embed"].T
    return constrain(logits, "batch", None, "vocab"), caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None,
               dtype: torch.dtype = torch.float32) -> Dict:
    """Zero caches on ``device`` (default CUDA): the KV and conv leaves of
    ``dtype`` (float32, bfloat16 as the reference's default, or float64),
    the SSM states float32 (float64 in a float64 run), as the
    reference keeps them:
    {"groups": {"attn": {"k", "v": (ng, B, max_len, Hkv, D), "pos": (ng,)
    int32}, "mamba": {"conv": (ng, per, B, K − 1, C), "ssm": (ng, per, B,
    H, N, P)}}, "tail": the tail's mamba caches (tail, ...) when there is
    a tail}."""
    dev = resolve_device(device)
    ng, per, tail = structure(cfg)
    d_inner = cfg.ssm_expand * cfg.d_model
    H = d_inner // HEAD_P

    def zeros(*shape, dtype=dtype):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def mamba(*lead):
        return {"conv": zeros(*lead, batch, cfg.ssm_conv - 1, d_inner),
                "ssm": zeros(*lead, batch, H, cfg.ssm_state, HEAD_P,
                             dtype=wide_dtype(dtype))}
    kv = (ng, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {"groups": {
        "attn": {"k": zeros(*kv), "v": zeros(*kv),
                 "pos": zeros(ng, dtype=torch.int32)},
        "mamba": mamba(ng, per)}}
    if tail:
        cache["tail"] = mamba(tail)
    return cache


def cache_specs(cfg: ModelConfig) -> Dict:
    """Logical axes of each cache leaf, as the reference's."""
    ng, per, tail = structure(cfg)
    spec = {"groups": {
        "attn": {"k": (None, "batch", "kv_seq", None, "kv_hd"),
                 "v": (None, "batch", "kv_seq", None, "kv_hd"),
                 "pos": (None,)},
        "mamba": {"conv": (None, None, "batch", None, None),
                  "ssm": (None, None, "batch", None, "state", None)}}}
    if tail:
        spec["tail"] = {"conv": (None, "batch", None, None),
                        "ssm": (None, "batch", None, "state", None)}
    return spec
