"""Chunked SSD (state-space duality) core, shared by Mamba2 (zamba2) and
mLSTM (xlstm), both gated linear attention with a decay:

    S_t = a_t · S_{t-1} + dt_t · B_t ⊗ x_t          (state: H × N × P)
    y_t = C_t · S_t

The chunked form computes the interactions inside a chunk as a masked
attention-like product and carries the state between chunks with a short
loop over chunks: O(S·L) work instead of O(S²).  Port of
``repro.models.layers.ssd``; the products stay ``torch.einsum`` (the
reference's are XLA einsums, outside any Pallas kernel).

Heads are independent, so ``ssd_scan`` can run the core over head groups
(``head_group``) to bound the (L × L × H) decay mask; the default runs all
heads at once, as the reference's does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import wide, wide_dtype

DEFAULT_CHUNK = 128
HEAD_GROUP = 0


def _ssd_core(x, log_a, dt, Bm, Cm, init_state, chunk):
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    pad = (-S) % L
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Sp = S + pad
    nc = Sp // L

    xc = x.reshape(Bsz, nc, L, H, P)
    lac = wide(log_a.reshape(Bsz, nc, L, H))
    dtc = wide(dt.reshape(Bsz, nc, L, H))
    Bc = Bm.reshape(Bsz, nc, L, N)
    Cc = Cm.reshape(Bsz, nc, L, N)

    cum = torch.cumsum(lac, dim=2)                      # (B, nc, L, H)
    total = cum[:, :, -1]                               # (B, nc, H)

    # --- intra-chunk (attention-like, causal with a decay mask) ---
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,i,j,H)
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: exp of the (positive) upper triangle overflows, and
    # 0 * inf = NaN would poison the gradient of a mask applied after it
    diff = diff.masked_fill(~causal[None, None, :, :, None], -torch.inf)
    decay = torch.exp(diff)
    cb = torch.einsum("bnie,bnje->bnij", Cc, Bc)       # (B, nc, L, L)
    w = cb[..., None] * decay * dtc[:, :, None, :, :]  # (B, nc, i, j, H)
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", w.to(x.dtype), xc)

    # --- chunk summary states ---
    sdec = torch.exp(total[:, :, None, :] - cum) * dtc  # (B, nc, L, H)
    states = torch.einsum("bnlh,bnle,bnlhp->bnhep", sdec.to(x.dtype), Bc, xc)

    # --- inter-chunk recurrence ---
    s = (torch.zeros((Bsz, H, N, P), dtype=wide_dtype(x.dtype),
                     device=x.device)
         if init_state is None else wide(init_state))
    prevs = []
    for n in range(nc):
        prevs.append(s)
        s = s * torch.exp(total[:, n])[:, :, None, None] + wide(states[:, n])
    prev = torch.stack(prevs, 1)                        # (B, nc, H, N, P)
    y_inter = torch.einsum("bnle,bnlh,bnhep->bnlhp", Cc,
                           torch.exp(cum).to(x.dtype), prev.to(x.dtype))
    y = (y_intra + y_inter).reshape(Bsz, Sp, H, P)[:, :S]
    return y, s


def ssd_scan(x: torch.Tensor, log_a: torch.Tensor, dt: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             init_state: Optional[torch.Tensor] = None,
             chunk: int = DEFAULT_CHUNK, head_group: int = HEAD_GROUP
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, H, P), log_a (B, S, H) per-step log decay (<= 0), dt (B, S,
    H) input scale (>= 0), Bm and Cm (B, S, N) shared across heads,
    init_state (B, H, N, P) -> (y (B, S, H, P), final state (B, H, N, P)
    float32, float64 for float64 inputs).  S is padded to a multiple of ``chunk``."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    if not head_group or H <= head_group or H % head_group:
        return _ssd_core(x, log_a, dt, Bm, Cm, init_state, chunk)
    ng = H // head_group
    if init_state is None:
        init_state = torch.zeros((Bsz, H, N, P), dtype=wide_dtype(x.dtype),
                                 device=x.device)
    ys, finals = [], []
    for g in range(ng):
        hs = slice(g * head_group, (g + 1) * head_group)
        y, f = _ssd_core(x[:, :, hs], log_a[:, :, hs], dt[:, :, hs], Bm, Cm,
                         init_state[:, hs], chunk)
        ys.append(y)
        finals.append(f)
    return torch.cat(ys, 2), torch.cat(finals, 1)


def ssd_step(state: torch.Tensor, x: torch.Tensor, log_a: torch.Tensor,
             dt: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step: state (B, H, N, P), x (B, H, P), log_a and dt
    (B, H), Bm and Cm (B, N) -> (y (B, H, P), new state (B, H, N, P)
    float32, float64 for float64 inputs)."""
    s = state * torch.exp(wide(log_a))[:, :, None, None]
    s = s + torch.einsum("bh,be,bhp->bhep", wide(dt), wide(Bm), wide(x))
    y = torch.einsum("be,bhep->bhp", wide(Cm), s)
    return y.to(x.dtype), s
