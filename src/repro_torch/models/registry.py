"""Family dispatch over every family, as ``repro.models.registry``:

    init_params(cfg, generator, seed=, device=)  -> params tree
    loss_fn(params, batch, cfg, inference=False) -> (loss, metrics)
    gcn_logits(params, x, cfg, plan=None)        -> logits (training forward)
    serve_fn(params, batch, cache, cfg, backend) -> (logits, cache)
    prefill_fn(params, batch, cfg)               -> the prefill loss
    init_cache(cfg, batch, max_len, device=, dtype=) -> cache tree
    cache_specs(cfg)                             -> logical axes of the cache

The gcn family (2s-AGCN, one stream), the decoder families (dense, moe,
vlm), the SSM family (xLSTM), the hybrid (Zamba2) and the audio
encoder-decoder (Whisper); an unknown family raises ValueError.  Batch
dicts: gcn {x (N, T, V, C), labels (N,)}; dense/moe/ssm/hybrid {tokens
(B, S), labels (B, S)}; vlm {tokens (B, S_text), image_embeds (B, N_img,
d), labels (B, S_text)}; audio {frames (B, F, d), tokens (B, S), labels
(B, S)}; and for a decode step {tokens (B, 1), pos int32 device scalar,
and for audio memory (B, F, d)}.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike
from repro_torch.core.agcn import model as agcn
from repro_torch.models import decoder, encdec, hybrid, ssm_model

LM_FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid", "audio")


def _module(cfg: ModelConfig):
    """The model module of ``cfg``'s family."""
    if cfg.family in decoder.FAMILIES:
        return decoder
    mod = {"gcn": agcn, "audio": encdec, "ssm": ssm_model,
           "hybrid": hybrid}.get(cfg.family)
    if mod is None:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return mod


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict:
    """Random float32 parameters of ``cfg``'s family from ``generator``
    (else seeded with ``seed``), on ``device`` (default CUDA)."""
    return _module(cfg).init_params(cfg, generator, seed=seed, device=device)


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
    mod = _module(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
    if mod is decoder:
        logits, _, aux = decoder.forward(
            params, batch["tokens"], cfg,
            image_embeds=batch.get("image_embeds"))
        if cfg.family == "vlm":
            logits = logits[:, -batch["tokens"].shape[1]:]  # text positions
    elif mod is encdec:
        memory = encdec.encode(params, batch["frames"], cfg)
        logits, _ = encdec.decode(params, batch["tokens"], memory, cfg)
    else:
        logits, _ = mod.forward(params, batch["tokens"], cfg)
    loss = _xent(logits[:, :-1], batch["labels"][:, 1:])
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def serve_fn(params: Dict, batch: Dict[str, torch.Tensor], cache: Dict,
             cfg: ModelConfig, backend: str = "cuda"
             ) -> Tuple[torch.Tensor, Dict]:
    """One decode step: batch = {tokens (B, S), pos int32 device scalar,
    and for the audio family memory (B, F, d)}; the cache is updated in
    place and returned.  The VLM serves text alone, as the reference's
    step does (no image embeddings).  The SSM and hybrid recurrences take
    one token a step.  A decoder step of S > 1 tokens must fit in the
    cache's L slots (pos + S <= L): the reference clamps such a write's
    start, which this port does not reproduce, so it raises (the check
    reads pos on the host; one-token steps never do)."""
    pos = batch["pos"]
    S = batch["tokens"].shape[1]
    positions = pos + torch.arange(S, device=pos.device)
    mod = _module(cfg)
    if mod is encdec:
        return encdec.decode(params, batch["tokens"], batch["memory"], cfg,
                             caches=cache, positions=positions,
                             backend=backend)
    if mod is ssm_model:
        return ssm_model.forward(params, batch["tokens"], cfg, caches=cache)
    if mod is hybrid:
        return hybrid.forward(params, batch["tokens"], cfg, caches=cache,
                              positions=positions, backend=backend)
    if mod is not decoder:
        raise ValueError(f"no serve path for family {cfg.family}")
    L = cache["k"].shape[3]
    if S > 1 and int(pos) + S > L:
        raise ValueError(f"serve_fn: {S} tokens at position {int(pos)} do "
                         f"not fit in the cache's {L} slots")
    logits, cache, _ = decoder.forward(params, batch["tokens"], cfg,
                                       caches=cache, positions=positions,
                                       backend=backend, need_aux=False)
    return logits, cache


def prefill_fn(params: Dict, batch: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Optional[torch.Tensor]:
    """The prefill forward's loss (the cache writes are ``serve_fn``'s),
    None for a batch without labels, as the reference's."""
    return loss_fn(params, batch, cfg)[0] if "labels" in batch else None


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device: DeviceLike = None,
               dtype: torch.dtype = torch.float32) -> Dict:
    """The family's zero decode cache on ``device`` (default CUDA), with
    the reference's leaf dtypes for ``dtype``: float32 throughout;
    bfloat16 (the reference's default) for the attention k and v and the
    hybrid's conv context, the SSM states staying float32; or float64
    for the SSM and hybrid families (a float64 run of their
    recurrences).  Positions are int32."""
    mod = _module(cfg)
    if mod is agcn:
        raise ValueError(f"{cfg.name}: the gcn family has no decode cache")
    if dtype == torch.float64 and mod not in (ssm_model, hybrid):
        raise ValueError(f"{cfg.name}: no {dtype} decode cache")
    if dtype not in (torch.float32, torch.bfloat16, torch.float64):
        raise ValueError(f"{cfg.name}: no {dtype} decode cache")
    return mod.init_cache(cfg, batch, max_len, device, dtype)


def cache_specs(cfg: ModelConfig) -> Dict:
    """Logical axes of each leaf of the family's decode cache."""
    mod = _module(cfg)
    if mod is agcn:
        raise ValueError(f"{cfg.name}: the gcn family has no decode cache")
    return mod.cache_specs(cfg)

