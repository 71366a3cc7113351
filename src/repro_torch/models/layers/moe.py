"""Mixture-of-Experts FFN with capacity-based, per-example scatter
dispatch.  Port of ``repro.models.layers.moe``.

The dispatch is sort-free: each (token, choice) finds its slot inside its
expert's capacity buffer with a cumulative sum over the one-hot routing
mask, within its own example — the cumsum compaction of the paper's RFC
encoder applied to token→expert routing.  The reference vmaps the
per-example scatter once per routing choice; here one accumulating
``index_put`` over (example, expert, slot) indices places every example's
(token, choice) pairs at once, in the same slots.

``num_experts`` is padded so 16 divides it (the pads get −1e30 router
logits and zero weights).  Tokens over an expert's capacity go to a spare
slot ``cap`` whose output is weighted 0 (the residual passes through).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.sharding import batch_mean, constrain
from repro_torch.models.layers.common import activation, he_init


def moe_init(generator: Optional[torch.Generator], d_model: int,
             moe_d_ff: int, num_experts: int, padded_experts: int) -> Dict:
    """Router (d, E) and stacked expert weights wi, wg (E, d, f) and wo
    (E, f, d) over the ``padded_experts`` E, the pads' weights zero."""
    E = padded_experts
    wi = he_init(generator, (E, d_model, moe_d_ff), d_model)
    wg = he_init(generator, (E, d_model, moe_d_ff), d_model)
    wo = he_init(generator, (E, moe_d_ff, d_model), moe_d_ff)
    if E > num_experts:
        mask = (torch.arange(E, device=wi.device) < num_experts).to(
            wi.dtype)[:, None, None]
        wi, wg, wo = wi * mask, wg * mask, wo * mask
    return {"router": he_init(generator, (d_model, E), d_model),
            "wi": wi, "wg": wg, "wo": wo}


def moe_ffn(p: Dict, x: torch.Tensor, *, num_experts: int, top_k: int,
            capacity_factor: float = 1.25, act: str = "silu",
            need_aux: bool = True
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d) -> (output (B, S, d), the load-balance aux loss, or
    None with ``need_aux=False``: serving discards it).

    Each expert takes at most cap = max(1, int(k·S·cf/E)) tokens of an
    example, in token order then choice order; the rest go to the spare
    slot and contribute nothing.  The aux loss is Switch-style: the mean
    router probability per expert times its mean token share, summed;
    under a data-parallel mesh both means span every rank's tokens
    (:func:`~repro_torch.distributed.sharding.batch_mean`), as JAX's
    global means do."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    cap = max(1, int(top_k * S * capacity_factor / E))
    dev = x.device

    logits = (x @ p["router"]).float()                          # (B, S, E)
    logits = torch.where(torch.arange(E, device=dev) < num_experts, logits,
                         torch.full((), -1e30, device=dev))
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, top_k, dim=-1)     # (B, S, k)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # the RFC-style cumsum compaction, per example: the slot of each
    # (token, choice) is the number of earlier assignments to its expert
    onehot = (expert_idx[..., None]
              == torch.arange(E, device=dev)).long()          # (B, S, k, E)
    flat = onehot.reshape(B, S * top_k, E)
    slot = torch.cumsum(flat, dim=1) - flat
    slot = (slot * flat).sum(-1).reshape(B, S, top_k)
    keep = slot < cap
    sidx = torch.where(keep, slot, torch.full_like(slot, cap))
    rows = torch.arange(B, device=dev)[:, None, None].expand(B, S, top_k)

    # dispatch: one accumulating scatter of every (token, choice) at its
    # slot; a kept slot is unique in its example, so only the spare slot
    # sums (its output is weighted 0), and the backward sums each token's
    # k gathered cotangents before any cross-rank reduction
    buf = x.new_zeros((B, E, cap + 1, d)).index_put(
        (rows, expert_idx, sidx), x[:, :, None, :], accumulate=True)
    buf = constrain(buf, "batch", "expert", None, None)

    h = activation(act)(torch.einsum("becd,edf->becf", buf, p["wg"])) * \
        torch.einsum("becd,edf->becf", buf, p["wi"])
    out_buf = torch.einsum("becf,efd->becd", h, p["wo"])
    out_buf = constrain(out_buf, "batch", "expert", None, None)

    # combine: gather each choice's output row, weighted by its gate
    w = (gate_vals * keep).to(out_buf.dtype)
    out = (out_buf[rows, expert_idx, sidx] * w[..., None]).sum(2)
    out = constrain(out, "batch", None, None)
    if not need_aux:
        return out, None

    # load-balance aux loss (Switch-style)
    me = batch_mean(probs.reshape(-1, E).mean(0))
    ce = batch_mean(onehot.reshape(-1, top_k, E).sum(1).float().mean(0)
                    * E / top_k)
    aux = (me * ce).sum() * num_experts / E
    return out, aux
