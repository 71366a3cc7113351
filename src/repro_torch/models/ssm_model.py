"""xLSTM language model (xlstm-1.3b): mLSTM blocks with a periodic sLSTM
block (one per ``cfg.slstm_every`` blocks: xLSTM[7:1] for the 1.3B
config), each with an optional gated MLP.  A group holds one period:
``slstm_every − 1`` mLSTM blocks, then the sLSTM block.  The embedding is
scaled by √d and tied to the logits.  Port of ``repro.models.ssm_model``:
leaves are stacked as the reference's, (num_groups, slstm_every − 1, ...)
for the mLSTM blocks and (num_groups, ...) for the sLSTM blocks, so a
JAX tree carries across unchanged (``repro_torch.bridge``).

Under sequence parallelism (``distributed.sharding.seq_parallel`` of the
sequence: JAX's ``seq_shard`` rule on a model axis whose ranks divide it)
the residual between blocks is each model rank's (B, S/M, d) sequence
shard: the embedding's rows are reduce-scattered into it, each block's
pre-norms (``ln``, ``ln2``) and the final norm run on the shard, the
mLSTM and sLSTM cells and the MLP all-gather their normed input (the scans
and the time loop need the whole sequence of each head) and
reduce-scatter (or slice) their outputs, and the final norm's output is
all-gathered before the logits.  The norm scales' gradients are summed
over ``model`` (``distributed.params.seq_shard_sums``).  A decode step
(one token) and a sequence M does not divide stay replicated.  A group
recomputed in the backward reissues its collectives in the forward's
order on every rank.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_copy_, tree_index, tree_map
from repro_torch.distributed import params as dparams
from repro_torch.distributed.sharding import (bind_context, constrain,
                                              model_share, seq_parallel)
from repro_torch.models.layers.common import (embed_lookup, he_init, rmsnorm,
                                              rmsnorm_init, stack_layers,
                                              tied_logits, wide_dtype)
from repro_torch.models.layers.mlp import mlp, mlp_init
from repro_torch.models.layers.xlstm import (mlstm_init, mlstm_layer,
                                             slstm_init, slstm_layer)


def group_size(cfg: ModelConfig) -> int:
    return cfg.slstm_every if cfg.slstm_every > 0 else cfg.scan_group


def num_groups(cfg: ModelConfig) -> int:
    g = group_size(cfg)
    assert cfg.num_layers % g == 0, (cfg.num_layers, g)
    return cfg.num_layers // g


def _block_init(gen, cfg: ModelConfig, dev, cell) -> Dict:
    p = {"ln": rmsnorm_init(cfg.d_model, dev), "cell": cell}
    if cfg.d_ff:
        p["ln2"] = rmsnorm_init(cfg.d_model, dev)
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff)
    return p


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """float32 parameters with the reference's nesting and shapes:
    "embed" (padded_vocab, d), "layers" {"mlstm": (ng, g − 1, ...) leaves,
    "slstm": (ng, ...) leaves}, "final_norm".  Numbers come from
    ``generator`` (else one on ``device`` seeded with ``seed``): the mLSTM
    blocks, the sLSTM blocks, then the embedding; ``device="meta"`` gives
    the shapes alone."""
    dev = resolve_device(device)
    meta = dev.type == "meta"
    gen = None if meta else generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(seed)
    gdev = dev if gen is None else gen.device
    g, ng = group_size(cfg), num_groups(cfg)
    with torch.device("meta") if meta else contextlib.nullcontext():
        params = {
            "layers": {
                "mlstm": stack_layers(lambda: _block_init(
                    gen, cfg, gdev, mlstm_init(gen, cfg.d_model,
                                               cfg.num_heads, cfg.ssm_expand,
                                               gdev)), (ng, g - 1)),
                "slstm": stack_layers(lambda: _block_init(
                    gen, cfg, gdev, slstm_init(gen, cfg.d_model,
                                               cfg.num_heads, gdev)), (ng,)),
            },
            "embed": he_init(gen, (cfg.padded_vocab, cfg.d_model),
                             cfg.d_model),
            "final_norm": rmsnorm_init(cfg.d_model, gdev),
        }
    return tree_map(lambda t: t.to(dev), params)


def _block(cfg, lp, x, cache, cell_fn, sp):
    h, new_c = cell_fn(lp["cell"], rmsnorm(x, lp["ln"], cfg.norm_eps), cache,
                       sp)
    x = x + h
    if "mlp" in lp:
        x = x + mlp(lp["mlp"], rmsnorm(x, lp["ln2"], cfg.norm_eps), cfg.act,
                    seq_shard=sp)
    if cache is not None:
        tree_copy_(cache, new_c)
    return x


def _group(cfg: ModelConfig, gp: Dict, x: torch.Tensor,
           cache: Optional[Dict], sp: bool = False) -> torch.Tensor:
    """One period: g − 1 mLSTM blocks then the sLSTM block; a cache slice
    is updated in place.  ``sp``: ``x`` is this rank's sequence shard."""
    def mcell(p, h, c, sp):
        return mlstm_layer(p, h, cfg.num_heads, cfg.ssm_expand, c, sp)

    def scell(p, h, c, sp):
        return slstm_layer(p, h, cfg.num_heads, c, sp)
    for i in range(group_size(cfg) - 1):
        c_i = tree_index(cache["mlstm"], i) if cache is not None else None
        x = _block(cfg, tree_index(gp["mlstm"], i), x, c_i, mcell, sp)
    x = _block(cfg, gp["slstm"], x,
               cache["slstm"] if cache is not None else None, scell, sp)
    return constrain(x, "batch", "seq_shard", None)


def forward(params: Dict, tokens: torch.Tensor, cfg: ModelConfig,
            caches: Optional[Dict] = None,
            positions: Optional[torch.Tensor] = None,
            gather_logits: bool = True
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, S) -> (logits (B, S, padded_vocab), caches).  Without
    caches the cache-free forward (the chunked SSD scan; under autograd
    each group is recomputed in the backward, as the reference's
    ``jax.checkpoint``); with caches (from :func:`init_cache`) one token
    per call through the recurrences, the caches updated in place and
    returned.  ``positions`` is ignored (no positional encoding).  Where a
    model axis's plan shards the vocabulary, ``gather_logits=False``
    returns this rank's vocabulary columns alone (the loss's
    ``common.xent`` takes them so).  The residual is a sequence shard
    where ``seq_parallel`` holds (the module docstring)."""
    sp = seq_parallel(tokens.shape[1])
    if sp:
        params = dparams.seq_shard_sums(params)
    x = embed_lookup(tokens, params["embed"], math.sqrt(cfg.d_model),
                     seq_shard=sp)
    x = constrain(x, "batch", "seq_shard", None)
    for gi in range(num_groups(cfg)):
        gp = tree_index(params["layers"], gi)
        if caches is not None:
            x = _group(cfg, gp, x, tree_index(caches, gi), sp)
        elif torch.is_grad_enabled() and x.requires_grad:
            x = checkpoint(bind_context(_group), cfg, gp, x, None, sp,
                           use_reentrant=False)
        else:
            x = _group(cfg, gp, x, None, sp)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = tied_logits(x, params["embed"], gather_logits, sp)
    return constrain(logits, "batch", None, "vocab"), caches


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None,
               dtype: torch.dtype = torch.float32) -> Dict:
    """Zero recurrent states on ``device`` (default CUDA), float32 (the
    reference's, whatever cache dtype it is asked for) or float64 when
    ``dtype`` is float64 (:func:`common.wide_dtype`):
    {"mlstm": {"ssm": (ng, g − 1, B, H, dh, dh + 1)}, "slstm": {"c",
    "n", "h", "m": (ng, B, H, d / H)}}; ``max_len`` does not size them.
    Inside ``sharding.axis_rules`` they are this rank's shards: H / M heads
    of each layer the plan takes by heads.  JAX's spec shards the mLSTM
    state's key dim over ``model`` (``state``); the port shards the heads,
    as its layers compute: the same bytes a rank and no collective inside
    the scan (``cache_specs`` gives the reference's axes)."""
    dev = resolve_device(device)
    g, ng = group_size(cfg), num_groups(cfg)
    dh = cfg.ssm_expand * cfg.d_model // cfg.num_heads
    dh_s = cfg.d_model // cfg.num_heads
    hm = model_share(cfg.num_heads, "mlstm")
    hs = model_share(cfg.num_heads, "slstm")

    def zeros(*shape):
        return torch.zeros(shape, dtype=wide_dtype(dtype), device=dev)
    return {
        "mlstm": {"ssm": zeros(ng, g - 1, batch, hm, dh, dh + 1)},
        "slstm": {k: zeros(ng, batch, hs, dh_s)
                  for k in ("c", "n", "h", "m")},
    }


def cache_specs(cfg: ModelConfig) -> Dict:
    """Logical axes of each cache leaf, as the reference's."""
    return {
        "mlstm": {"ssm": (None, None, "batch", None, "state", None)},
        "slstm": {k: (None, "batch", None, None)
                  for k in ("c", "n", "h", "m")},
    }
