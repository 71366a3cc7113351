"""Family dispatch, as ``repro.models.registry``, for the families the
port has:

    init_params(cfg, generator, seed=, device=)  -> params tree
    loss_fn(params, batch, cfg, inference=False) -> (loss, metrics)
    gcn_logits(params, x, cfg, plan=None)        -> logits (training forward)
    serve_fn(params, batch, cache, cfg, backend) -> (logits, cache)
    init_cache(cfg, batch, max_len, device=)     -> cache tree

The gcn family (2s-AGCN, one stream) and the dense, MoE and VLM decoder
families are ported; the others raise NotImplementedError (ROADMAP.md,
Queue 1 item 6).  Batch dicts: gcn {x (N, T, V, C), labels (N,)};
dense/moe {tokens (B, S), labels (B, S)}; vlm {tokens (B, S_text),
image_embeds (B, N_img, d), labels (B, S_text)}; and for a decode step
{tokens (B, 1), pos int32 device scalar}.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike
from repro_torch.core.agcn import model as agcn
from repro_torch.models import decoder


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Random float32 parameters of ``cfg``'s family from ``generator``
    (else seeded with ``seed``), on ``device`` (default CUDA)."""
    if cfg.family == "gcn":
        return agcn.init_params(cfg, generator, seed=seed, device=device)
    return decoder.init_params(cfg, generator, seed=seed, device=device)


def _xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the logits' last axis (the padded
    vocabulary, or the classes) plus the 1e-4 z-loss (the reference's
    logit drift regulariser)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return (logz - gold).mean() + 1e-4 * logz.square().mean()


def gcn_logits(params: Dict, x: torch.Tensor, cfg: ModelConfig,
               plan=None) -> torch.Tensor:
    """The differentiable one-stream 2s-AGCN forward the training loss
    takes: a ``reference`` plan with dense spatial convs (plain einsums and
    ``F.conv2d``, so gradients reach every parameter; no graph-density
    probe, as in JAX's traced train path), with the prune plan ``plan``
    applied when given."""
    from repro_torch.core.agcn import engine
    ep = engine.build_execution_plan(params, cfg, plan, backend="reference",
                                     sconv="dense")
    return engine.execute(ep, x)


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            inference: bool = False
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The training loss and its metrics.

    gcn: cross-entropy (with the z-loss) of the clip logits and top-1
    accuracy, always through :func:`gcn_logits` on the ``reference``
    backend, whatever ``cfg.gcn_backend`` says: the ``cuda`` backend's
    plan packs weights through numpy and carries no gradient.  Training
    runs the dense graph; ``inference=True`` applies the config's static
    prune plan (the deployed model).  dense, moe and vlm: the next-token
    loss of the cache-free forward (the prefill path) plus 0.01 × the MoE
    load-balance loss, with metrics {"loss" (the cross-entropy), "aux"};
    the VLM's logits are cut to the text positions."""
    if cfg.family == "gcn":
        from repro_torch.core.pruning.plan import plan_from_config
        plan = plan_from_config(cfg) if inference else None
        logits = gcn_logits(params, batch["x"], cfg, plan)
        loss = _xent(logits, batch["labels"])
        acc = (logits.argmax(-1) == batch["labels"]).to(torch.float32).mean()
        return loss, {"loss": loss, "acc": acc}
    logits, _, aux = decoder.forward(params, batch["tokens"], cfg,
                                     image_embeds=batch.get("image_embeds"))
    if cfg.family == "vlm":
        logits = logits[:, -batch["tokens"].shape[1]:]      # text positions
    loss = _xent(logits[:, :-1], batch["labels"][:, 1:])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def serve_fn(params: Dict, batch: Dict[str, torch.Tensor], cache: Dict,
             cfg: ModelConfig, backend: str = "cuda"
             ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: batch = {tokens (B, S), pos int32 device scalar};
    the cache is updated in place and returned.  The VLM serves text
    alone, as the reference's step does (no image embeddings).  A step of S > 1 tokens
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
    logits, cache, _ = decoder.forward(params, batch["tokens"], cfg,
                                       caches=cache, positions=positions,
                                       backend=backend, need_aux=False)
    return logits, cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None) -> Dict:
    return decoder.init_cache(cfg, batch, max_len, device)
