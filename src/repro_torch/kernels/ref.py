"""Plain PyTorch oracles of the port's kernels: the twins of
``repro.kernels.ref``, in the same layouts, plus the streaming temporal
conv's einsum (JAX ``engine.ReferenceBackend.temporal_step``, which has no
``ref.py`` oracle)."""
from __future__ import annotations

import math
from typing import Union

import torch
import torch.nn.functional as F


def rfc_encode_ref(x: torch.Tensor, bank: int = 16):
    """ReLU + stable in-bank compaction.  x: (rows, C) -> (values, hot)."""
    x = torch.clamp_min(x, 0.0)
    rows, cols = x.shape
    b = x.reshape(rows, cols // bank, bank)
    hot = b > 0
    order = torch.argsort((~hot).to(torch.uint8), dim=-1, stable=True)
    vals = torch.take_along_dim(b, order, dim=-1)
    return vals.reshape(rows, cols), hot.to(x.dtype).reshape(rows, cols)


def rfc_decode_ref(values: torch.Tensor, hot: torch.Tensor, bank: int = 16):
    """Scatter front-packed bank values back to their hot positions."""
    rows, cols = values.shape
    v = values.reshape(rows, cols // bank, bank)
    h = hot.reshape(rows, cols // bank, bank) > 0
    pos = torch.cumsum(h.to(torch.int64), dim=-1) - 1
    out = torch.where(h, torch.take_along_dim(v, pos.clamp_min(0), dim=-1), 0.0)
    return out.reshape(rows, cols)


def cavity_tconv_ref(x: torch.Tensor, w: torch.Tensor,
                     stride: int = 1) -> torch.Tensor:
    """Dense masked temporal conv, 'same' padding.
    x: (B, T, C) unpadded, w: (F, C, K) masked -> (B, T_out, F)."""
    K = w.shape[-1]
    out = F.conv1d(x.transpose(1, 2), w, stride=stride, padding=K // 2)
    return out.transpose(1, 2)


def cavity_tconv_step_ref(win: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """One output step per window, dense masked weights.
    win: (N, K, V, C) oldest first, tw: (F, C, K) -> (N, V, F)."""
    return torch.einsum("nkvc,fck->nvf", win, tw)


def graph_sconv_ref(x: torch.Tensor, g: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
    """out = Σ_k (G_k·x)·W_k.  x: (R, V, Cin), g: (K, V, V),
    w: (K, Cin, Co) -> (R, V, Co)."""
    y = torch.einsum("rvc,kwv->krwc", x, g)
    return torch.einsum("krwc,kco->rwo", y, w)


def graph_sconv_csr_ref(x: torch.Tensor, indptr: torch.Tensor,
                        indices: torch.Tensor, values: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """CSR spatial conv: gather-accumulate over indptr/indices per subset.

    x: (R, Vx, Cin) with Vx >= V (rows past V are padding the graph never
    references), indptr: (K, V+1), indices/values: (K, E) zero-padded,
    w: (K, Cin, Co) -> (R, V, Co).  Entry e lies on output row w iff
    ``indptr[k, w] <= e < indptr[k, w+1]``; padded entries map past the
    last row and are dropped (JAX's ``mode="drop"``) by a spare row that
    is cut off."""
    K, E = indices.shape
    V = indptr.shape[1] - 1
    R, _, C = x.shape
    out = torch.zeros((R, V, w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    entries = torch.arange(E, dtype=indptr.dtype, device=x.device)
    for k in range(K):
        rows = torch.searchsorted(indptr[k].contiguous(), entries,
                                  right=True) - 1
        gathered = (x.index_select(1, indices[k].long())
                    * values[k].to(x.dtype)[None, :, None])
        agg = x.new_zeros((R, V + 1, C)).index_add_(1, rows.long(), gathered)
        out = out + torch.einsum("rvc,co->rvo", agg[:, :V], w[k])
    return out.to(x.dtype)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: Union[int, torch.Tensor],
                     window: int = 0) -> torch.Tensor:
    """GQA decode attention oracle: cache slots >= ``valid`` masked, and
    with ``window`` > 0 also the slots below ``valid − window`` (the
    sliding window of the query at position valid − 1, as
    ``flash_attention`` masks qi − kj >= window).  q: (B, Hkv, G, D),
    k/v: (B, S, Hkv, D) -> (B, Hkv, G, D); ``valid`` an int or a
    one-element integer tensor on k's device.  A query with no live slot
    gets the mean of v over all S.

    With a bfloat16 cache (float32 q) the reference's bf16 rules apply
    (``repro.models.layers.attention.flash_attention``): float32 scores,
    ``s − max`` rounded to bfloat16 before ``exp`` and the probabilities
    bfloat16, their float32 sum, the PV product of bf16 p and v
    accumulated in float32, the output in q's dtype."""
    D, S = q.shape[-1], k.shape[1]
    s = torch.einsum("bhgd,bshd->bhgs", q, k.to(q.dtype)) / math.sqrt(D)
    if torch.is_tensor(valid):
        valid = valid.reshape(())
    slots = torch.arange(S, device=k.device)
    live = slots < valid
    if window > 0:
        live = live & (slots >= valid - window)
    s = torch.where(live, s, -1e30)
    if v.dtype != torch.bfloat16:
        return torch.einsum("bhgs,bshd->bhgd", torch.softmax(s, -1), v)
    p = torch.exp((s - s.amax(-1, keepdim=True)).to(v.dtype)).float()
    out = torch.einsum("bhgs,bshd->bhgd", p, v.float())
    return (out / p.sum(-1, keepdim=True).clamp_min(1e-20)).to(q.dtype)
