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

On a model axis (``distributed.sharding.axis_rules`` with a ``ModelPlan``,
the tree from ``distributed.params.prepare``) the layers take their
shards: attention by heads, the MLP by d_ff, the MoE by experts and the
embedding and logits by vocabulary rows.  Between blocks the residual is
each model rank's sequence shard wherever ``sharding.seq_parallel`` holds
for the sequence (JAX's ``seq_shard`` rule, Megatron-style sequence
parallelism): the embedding's rows are reduce-scattered into (B, S/M, d)
shards after the VLM's image prefix is put in front, ``ln1`` and ``ln2``
run on the shard, attention, the MLP and the MoE all-gather their normed
input once and reduce-scatter (or slice) their outputs back into the
shard, and the final norm's output is all-gathered before the logits, so
the loss is one number on every rank.  The norm scales then get each
rank's tokens' share of their gradient, summed over ``model``
(``params.seq_shard_sums``).  Where M does not divide the sequence (one
token a decode step, an odd prompt, an image prefix plus text of odd
length) or the rules say ``seq_shard: None``, the residual stays
replicated over ``model`` and each block ends in an all-reduce (attention's
and the MLP's row-parallel outputs) or an all-gather (the MoE's rows).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_index, tree_map
from repro_torch.distributed import params as dparams
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers.attention import (attention_layer, attn_init,
                                                 local_cache_len)
from repro_torch.models.layers.common import (embed_lookup, he_init, rmsnorm,
                                              rmsnorm_init, rope_tables,
                                              stack_layers, tied_logits)
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
            backend: str = "cuda", need_aux: bool = True,
            gather_logits: bool = True
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
    discards it) and ``aux`` stays zero.  Where a model axis's plan shards
    the vocabulary, ``gather_logits=False`` returns this rank's vocabulary
    columns alone (the loss's ``common.xent`` takes them so).  The
    residual between blocks is a sequence shard wherever
    ``sharding.seq_parallel`` holds for S_total (the module docstring);
    the logits cover every position either way."""
    _check_family(cfg)
    kinds = layer_kinds(cfg)
    img = None
    if cfg.family == "vlm" and image_embeds is not None:
        img = image_embeds @ params["img_proj"]
    S_total = tokens.shape[1] + (0 if img is None else img.shape[1])
    sp = sharding.seq_parallel(S_total)
    if sp:
        params = dparams.seq_shard_sums(params)
    x = embed_lookup(tokens, params["embed"], math.sqrt(cfg.d_model), img,
                     sp)
    x = constrain(x, "batch", "seq_shard", None)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if positions is None:
        positions = torch.arange(S_total, device=x.device)
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta, x.device)
    for gi in range(num_groups(cfg)):
        for i, kind in enumerate(kinds):
            lp = tree_index(params["layers"], gi, i)
            cache = tree_index(caches, gi, i) if caches is not None else None
            # attention all-gathers its normed input once (JAX's constraint
            # of it to ("batch", None, None)) under sequence parallelism
            h, _ = attention_layer(
                lp["attn"], rmsnorm(x, lp["ln1"], cfg.norm_eps), rope,
                num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.head_dim, causal=True, window=_window(cfg, kind),
                cache=cache, backend=backend, seq_shard=sp)
            x = x + h
            h2 = rmsnorm(x, lp["ln2"], cfg.norm_eps)
            if cfg.family == "moe":
                h2, a = moe_ffn(lp["moe"], h2, num_experts=cfg.num_experts,
                                top_k=cfg.experts_per_token,
                                capacity_factor=cfg.moe_capacity_factor,
                                act=cfg.act, need_aux=need_aux, seq_shard=sp)
                if a is not None:
                    aux = aux + a
            else:
                h2 = mlp(lp["mlp"], h2, cfg.act, seq_shard=sp)
            x = constrain(x + h2, "batch", "seq_shard", None)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = constrain(tied_logits(x, params["embed"], gather_logits, sp),
                       "batch", None, "vocab")
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
    int32} on ``device`` (default CUDA).  Inside ``sharding.axis_rules``
    it is this rank's shard: L / P slots under the ``kv_seq`` rule (slots
    [r·L/P, (r+1)·L/P)), and Hkv / M kv heads where the plan takes
    attention by heads.  JAX's spec shards the cache's head_dim over
    ``model`` (``kv_hd``); the port shards the kv heads, as its attention
    computes (``cache_specs`` gives the reference's axes)."""
    _check_family(cfg)
    dev = resolve_device(device)
    ng, g = num_groups(cfg), scan_group_size(cfg)
    hkv = sharding.model_share(cfg.num_kv_heads, "attn")
    shape = (ng, g, batch, local_cache_len(cache_len(cfg, max_len)), hkv,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "pos": torch.zeros((ng, g), dtype=torch.int32, device=dev)}


def cache_specs(cfg: ModelConfig) -> Dict:
    """Logical axes of each cache leaf, as the reference's."""
    return {"k": (None, None, "batch", "kv_seq", None, "kv_hd"),
            "v": (None, None, "batch", "kv_seq", None, "kv_hd"),
            "pos": (None, None)}

