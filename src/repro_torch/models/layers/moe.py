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

Expert parallelism (a model axis whose plan takes the experts as shards,
``sharding.model_plan().moe``): ``wi``, ``wg`` and ``wo`` hold this rank's
E/M experts; the router runs whole on every model rank (its input is
replicated there), so the routing, the slots and the aux loss are the one
process's.  Where M divides the batch, each model rank dispatches its B/M
rows into a (B/M, E, cap+1, d) buffer, one all-to-all trades it for the
(B, E/M, cap+1, d) buffer of its own experts (JAX's two ``constrain``
points: batch-sharded to expert-sharded and back), the second all-to-all
returns the outputs, and the combined rows are all-gathered; else every
rank builds the whole buffer and keeps its experts' slice, and the
outputs are all-gathered over the experts.

Under sequence parallelism (``seq_shard``) the layer takes the rank's
sequence shard and all-gathers the whole sequence first: the capacity's
per-example slot cumsum runs over the whole sequence, so the routing, the
slots, the outputs and the aux loss are the one process's on every rank,
and the rank keeps its sequence slice of the combined output.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed import sharding
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
            need_aux: bool = True, seq_shard: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """x (B, S, d) -> (output (B, S, d), the load-balance aux loss, or
    None with ``need_aux=False``: serving discards it).

    Each expert takes at most cap = max(1, int(k·S·cf/E)) tokens of an
    example, in token order then choice order; the rest go to the spare
    slot and contribute nothing.  The aux loss is Switch-style: the mean
    router probability per expert times its mean token share, summed;
    under a data-parallel mesh both means span every rank's tokens
    (:func:`~repro_torch.distributed.sharding.batch_mean`), as JAX's
    global means do.  With ``seq_shard`` ``x`` and the output are this
    model rank's sequence shards (the module docstring)."""
    x = sharding.layer_in(x, False, seq_shard)
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
    w = gate_vals * keep
    plan = sharding.model_plan()
    if plan is not None and plan.moe:
        out = _expert_parallel(p, x, expert_idx, sidx, w, cap, act)
    else:
        out = _experts(p, x, expert_idx, sidx, w, cap, act)
    out = sharding.layer_out(constrain(out, "batch", None, None), False,
                             seq_shard)
    if not need_aux:
        return out, None

    # load-balance aux loss (Switch-style)
    me = batch_mean(probs.reshape(-1, E).mean(0))
    ce = batch_mean(onehot.reshape(-1, top_k, E).sum(1).float().mean(0)
                    * E / top_k)
    aux = (me * ce).sum() * num_experts / E
    return out, aux


def _dispatch(x: torch.Tensor, expert_idx: torch.Tensor, sidx: torch.Tensor,
              E: int, cap: int) -> torch.Tensor:
    """The (B, E, cap+1, d) capacity buffer: one accumulating scatter of
    every (token, choice) at its slot; a kept slot is unique in its
    example, so only the spare slot sums (its output is weighted 0), and
    the backward sums each token's k gathered cotangents before any
    cross-rank reduction."""
    B, S, d = x.shape
    rows = torch.arange(B, device=x.device)[:, None, None].expand_as(sidx)
    return x.new_zeros((B, E, cap + 1, d)).index_put(
        (rows, expert_idx, sidx), x[:, :, None, :], accumulate=True)


def _ffn(p: Dict, buf: torch.Tensor, act: str) -> torch.Tensor:
    """The experts' gated FFN on their capacity buffers."""
    h = activation(act)(torch.einsum("becd,edf->becf", buf, p["wg"])) * \
        torch.einsum("becd,edf->becf", buf, p["wi"])
    return torch.einsum("becf,efd->becd", h, p["wo"])


def _combine(out_buf: torch.Tensor, expert_idx: torch.Tensor,
             sidx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each choice's output row, weighted by its gate, summed a token."""
    B = out_buf.shape[0]
    rows = torch.arange(B, device=out_buf.device)[:, None, None].expand_as(
        sidx)
    return (out_buf[rows, expert_idx, sidx]
            * w.to(out_buf.dtype)[..., None]).sum(2)


def _experts(p, x, expert_idx, sidx, w, cap, act) -> torch.Tensor:
    """Dispatch, the experts and the combine on one rank (all E experts,
    or under expert parallelism with B indivisible over the model axis,
    this rank's slice of the whole buffer, the outputs gathered)."""
    E = p["router"].shape[-1]
    buf = constrain(_dispatch(x, expert_idx, sidx, E, cap),
                    "batch", "expert", None, None)
    if p["wi"].shape[0] == E:
        return _combine(_ffn(p, buf, act), expert_idx, sidx, w)
    out_buf = sharding.gather_from_model(
        _ffn(p, sharding.scatter_to_model(buf, 1), act), 1)
    return _combine(constrain(out_buf, "batch", "expert", None, None),
                    expert_idx, sidx, w)


def _expert_parallel(p, x, expert_idx, sidx, w, cap, act) -> torch.Tensor:
    """Expert parallelism over the model axis (the module docstring): the
    rows split over the ranks and two all-to-alls where M divides B."""
    ax = sharding.model_group()
    B, S, d = x.shape
    E = p["router"].shape[-1]
    M, El = ax.size, p["wi"].shape[0]
    if B % M:
        return _experts(p, x, expert_idx, sidx, w, cap, act)
    Br = B // M
    lo = ax.rank * Br
    idx_r, sidx_r = expert_idx[lo:lo + Br], sidx[lo:lo + Br]
    # batch-sharded (Br, E, cap+1, d) -> expert-sharded (B, El, cap+1, d):
    # slice j of the exchange holds rank j's experts, and rank j's rows
    # come back in rank order, so the rows stay in batch order
    buf = _dispatch(sharding.scatter_to_model(x, 0), idx_r, sidx_r, E, cap)
    buf = buf.reshape(Br, M, El, cap + 1, d).transpose(0, 1)
    buf = sharding.all_to_all(buf).reshape(B, El, cap + 1, d)
    out_buf = _ffn(p, buf, act).reshape(M, Br, El, cap + 1, d)
    out_buf = sharding.all_to_all(out_buf).transpose(0, 1).reshape(
        Br, E, cap + 1, d)
    out = _combine(out_buf, idx_r, sidx_r, sharding.scatter_to_model(w, 0))
    return sharding.gather_from_model(out, 0)
