"""xLSTM blocks: mLSTM (matrix memory, parallel over time on the SSD core
with a ones-column normaliser) and sLSTM (scalar memory with a true
hidden-to-hidden recurrence and exponential gates stabilised by m, a loop
over time).  Port of ``repro.models.layers.xlstm``.

mLSTM on SSD: x = v, B = k/√d, C = q, dt = exp(min(i, 10)),
log_a = logsigmoid(f).  A ones column appended to v makes the same scan
emit the normaliser n·q, so y = num / max(|den|, 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import (he_init, rmsnorm, rmsnorm_init,
                                              wide, wide_dtype)
from repro_torch.models.layers.ssd import ssd_scan, ssd_step


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(generator: Optional[torch.Generator], d_model: int,
               num_heads: int, expand: int = 2,
               device: Optional[torch.device] = None) -> Dict:
    d_inner = expand * d_model
    dev = device if generator is None else generator.device
    return {
        "wqkv": he_init(generator, (d_model, 3 * d_inner), d_model),
        "wif": he_init(generator, (d_model, 2 * num_heads), d_model) * 0.1,
        "if_bias": torch.cat([
            torch.zeros(num_heads, device=dev),
            3.0 + torch.arange(num_heads, dtype=torch.float32,
                               device=dev) * 0.5]),
        "wz": he_init(generator, (d_model, d_inner), d_model),
        "out_proj": he_init(generator, (d_inner, d_model), d_inner),
        "norm": rmsnorm_init(d_inner, dev),
    }


def mlstm_layer(p: Dict, x: torch.Tensor, num_heads: int, expand: int = 2,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) -> (out (B, S, d), new cache).  With ``cache`` =
    {"ssm": (B, H, dh, dh + 1)} a one-token step (the recurrence); the new
    state is returned in a new cache dict."""
    B, S, d = x.shape
    d_inner = expand * d
    dh = d_inner // num_heads

    q, k, v = (x @ p["wqkv"]).chunk(3, dim=-1)
    q = q.reshape(B, S, num_heads, dh)
    k = k.reshape(B, S, num_heads, dh) * dh ** -0.5
    v = v.reshape(B, S, num_heads, dh)

    gates = wide(x @ p["wif"] + p["if_bias"])
    i_pre, f_pre = gates.chunk(2, dim=-1)                # (B, S, H)
    log_f = F.logsigmoid(f_pre)
    dt = torch.exp(torch.clamp(i_pre, max=10.0))          # stabilised gate

    # the normaliser: a ones column appended to v
    v_aug = torch.cat([v, torch.ones((B, S, num_heads, 1), dtype=v.dtype,
                                     device=v.device)], -1)
    # k and q are per head while SSD shares B and C over its heads: fold
    # the heads into the batch and run SSD with H = 1
    q_f = q.transpose(1, 2).reshape(B * num_heads, S, dh)
    k_f = k.transpose(1, 2).reshape(B * num_heads, S, dh)
    v_f = v_aug.transpose(1, 2).reshape(B * num_heads, S, 1, dh + 1)
    la_f = log_f.transpose(1, 2).reshape(B * num_heads, S, 1)
    dt_f = dt.transpose(1, 2).reshape(B * num_heads, S, 1)

    if cache is not None:
        state0 = cache["ssm"].reshape(B * num_heads, 1, dh, dh + 1)
        y, new_state = ssd_step(state0, v_f[:, 0], la_f[:, 0], dt_f[:, 0],
                                k_f[:, 0], q_f[:, 0])
        y = y[:, None]
    else:
        y, new_state = ssd_scan(v_f, la_f, dt_f, k_f, q_f)

    y = y.reshape(B, num_heads, S, dh + 1).transpose(1, 2)
    num, den = y[..., :dh], y[..., dh:]
    h = num / torch.clamp_min(den.abs(), 1.0)
    h = h.reshape(B, S, d_inner)
    h = rmsnorm(h, p["norm"]) * F.silu(x @ p["wz"])
    out = h @ p["out_proj"]
    new_cache = ({"ssm": new_state.reshape(B, num_heads, dh, dh + 1)}
                 if cache is not None else None)
    return out, new_cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(generator: Optional[torch.Generator], d_model: int,
               num_heads: int, device: Optional[torch.device] = None) -> Dict:
    dh = d_model // num_heads
    dev = device if generator is None else generator.device
    return {
        "wx": he_init(generator, (d_model, 4 * d_model), d_model),
        "r": he_init(generator, (num_heads, dh, 4 * dh), dh) * 0.5,
        "bias": torch.zeros(4 * d_model, device=dev),
        "norm": rmsnorm_init(d_model, dev),
        "out_proj": he_init(generator, (d_model, d_model), d_model),
    }


def slstm_layer(p: Dict, x: torch.Tensor, num_heads: int,
                cache: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) -> (out (B, S, d), new cache), one step per token in
    order (the recurrence).  ``cache`` = {"c", "n", "h", "m": (B, H, dh)
    float32} carries the state; without it the state starts at zero (m
    too: the reference's ``zeros - 1e30 * 0.0``)."""
    B, S, d = x.shape
    dh = d // num_heads
    xg = (x @ p["wx"] + p["bias"]).reshape(B, S, num_heads, 4 * dh)
    r = wide(p["r"])
    if cache is not None:
        c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    else:
        c = n = h = m = torch.zeros((B, num_heads, dh),
                                    dtype=wide_dtype(x.dtype),
                                    device=x.device)
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,hde->bhe", h, r)
        g = wide(xg[:, t]) + rec                     # (B, H, 4 dh)
        zi, ii, fi, oi = g.chunk(4, dim=-1)
        z = torch.tanh(zi)
        o = torch.sigmoid(oi)
        m_new = torch.maximum(fi + m, ii)
        i = torch.exp(ii - m_new)
        f = torch.exp(fi + m - m_new)
        c = f * c + i * z
        n = f * n + i
        h = o * c / torch.clamp_min(n, 1.0)
        m = m_new
        hs.append(h)
    hseq = torch.stack(hs, 1).reshape(B, S, d).to(x.dtype)
    out = rmsnorm(hseq, p["norm"]) @ p["out_proj"]
    new_cache = ({"c": c, "n": n, "h": h, "m": m}
                 if cache is not None else None)
    return out, new_cache
