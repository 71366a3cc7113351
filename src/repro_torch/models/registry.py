"""Family dispatch, as ``repro.models.registry``, for the families the
port has:

    init_params(cfg, generator, seed=, device=)  -> params tree
    loss_fn(params, batch, cfg)                  -> (loss, metrics)
    serve_fn(params, batch, cache, cfg, backend) -> (logits, cache)
    init_cache(cfg, batch, max_len, device=)     -> cache tree

Only the dense decoder family is ported here; the others raise
NotImplementedError (ROADMAP.md, Queue 1 item 13; 2s-AGCN runs through
``repro_torch.core.agcn``).  Batch dict: {tokens (B, S), labels (B, S)},
and for a decode step {tokens (B, 1), pos int32 device scalar}.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike
from repro_torch.models import decoder


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict:
    return decoder.init_params(cfg, generator, seed=seed, device=device)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the padded vocabulary plus the 1e-4 z-loss
    (the reference's logit drift regulariser)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean() + 1e-4 * logz.square().mean()


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token loss of the cache-free forward (the prefill path)."""
    logits, _ = decoder.forward(params, batch["tokens"], cfg)
    loss = _xent(logits[:, :-1], batch["labels"][:, 1:])
    return loss, {"loss": loss}


def serve_fn(params: Dict, batch: Dict[str, torch.Tensor], cache: Dict,
             cfg: ModelConfig, backend: str = "cuda"
             ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: batch = {tokens (B, S), pos int32 device scalar};
    the cache is updated in place and returned.  A step of S > 1 tokens
    must fit in the cache's L slots (pos + S <= L): the reference clamps
    such a write's start, which this port does not reproduce, so it
    raises (the check reads pos on the host; one-token steps never do)."""
    pos = batch["pos"]
    S = batch["tokens"].shape[1]
    L = cache["k"].shape[3]
    if S > 1 and int(pos) + S > L:
        raise ValueError(f"serve_fn: {S} tokens at position {int(pos)} do "
                         f"not fit in the cache's {L} slots")
    positions = pos + torch.arange(S, device=pos.device)
    return decoder.forward(params, batch["tokens"], cfg, caches=cache,
                           positions=positions, backend=backend)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict:
    return decoder.init_cache(cfg, batch, max_len, device)
