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

from repro_torch.distributed import sharding
from repro_torch.models.layers.common import (he_init, rmsnorm_heads,
                                              rmsnorm_init, wide, wide_dtype)
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
                cache: Optional[Dict] = None, seq_shard: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) -> (out (B, S, d), new cache).  With ``cache`` =
    {"ssm": (B, H, dh, dh + 1)} a one-token step (the recurrence); the new
    state is returned in a new cache dict.

    On a model axis whose plan takes the layer by heads
    (``sharding.model_plan().mlstm``) the rank runs its H / M heads:
    ``wqkv`` is stored ``[q | k | v]`` and its column shard is not whole
    heads, so the products are gathered and the rank keeps its heads' q,
    k and v (each rank using its part, the backward reduce-scatters);
    ``wz``, the norm scale and ``out_proj``'s rows are the rank's heads;
    the replicated ``wif`` and ``if_bias`` give their i and f columns of
    the rank's heads (their backward gathers the ranks' parts); the norm's
    mean of squares is summed over the ranks, and so are the output
    products.  The cache holds H / M heads.  With ``seq_shard`` ``x`` and
    the output are this model rank's sequence shards: the scan needs the
    whole sequence, so the input is all-gathered and the output
    reduce-scattered (sliced, run whole: ``sharding.layer_in``,
    ``layer_out``)."""
    tp = sharding.takes_shards("mlstm")
    x = sharding.layer_in(x, tp, seq_shard)
    B, S, d = x.shape
    dh = expand * d // num_heads
    H = sharding.model_share(num_heads, "mlstm")
    d_inner = H * dh
    wif, if_bias = p["wif"], p["if_bias"]
    if tp:
        qkv = sharding.gather_from_model(x @ p["wqkv"], -1, partial_use=True)
        lo = sharding.model_group().rank * d_inner
        q, k, v = (t[..., lo:lo + d_inner] for t in qkv.chunk(3, dim=-1))
        # [i | f] of every head -> [i | f] of this rank's heads
        wif = sharding.scatter_to_model(
            wif.reshape(d, 2, num_heads), -1).reshape(d, 2 * H)
        if_bias = sharding.scatter_to_model(
            if_bias.reshape(2, num_heads), -1).reshape(2 * H)
    else:
        q, k, v = (x @ p["wqkv"]).chunk(3, dim=-1)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, H, dh) * dh ** -0.5
    v = v.reshape(B, S, H, dh)

    gates = wide(x @ wif + if_bias)
    i_pre, f_pre = gates.chunk(2, dim=-1)                # (B, S, H)
    log_f = F.logsigmoid(f_pre)
    dt = torch.exp(torch.clamp(i_pre, max=10.0))          # stabilised gate

    # the normaliser: a ones column appended to v
    v_aug = torch.cat([v, torch.ones((B, S, H, 1), dtype=v.dtype,
                                     device=v.device)], -1)
    # k and q are per head while SSD shares B and C over its heads: fold
    # the heads into the batch and run SSD with H = 1
    q_f = q.transpose(1, 2).reshape(B * H, S, dh)
    k_f = k.transpose(1, 2).reshape(B * H, S, dh)
    v_f = v_aug.transpose(1, 2).reshape(B * H, S, 1, dh + 1)
    la_f = log_f.transpose(1, 2).reshape(B * H, S, 1)
    dt_f = dt.transpose(1, 2).reshape(B * H, S, 1)

    if cache is not None:
        state0 = cache["ssm"].reshape(B * H, 1, dh, dh + 1)
        y, new_state = ssd_step(state0, v_f[:, 0], la_f[:, 0], dt_f[:, 0],
                                k_f[:, 0], q_f[:, 0])
        y = y[:, None]
    else:
        y, new_state = ssd_scan(v_f, la_f, dt_f, k_f, q_f)

    y = y.reshape(B, H, S, dh + 1).transpose(1, 2)
    num, den = y[..., :dh], y[..., dh:]
    h = num / torch.clamp_min(den.abs(), 1.0)
    h = h.reshape(B, S, d_inner)
    h = rmsnorm_heads(h, p["norm"], "mlstm") * F.silu(x @ p["wz"])
    out = h @ p["out_proj"]
    new_cache = ({"ssm": new_state.reshape(B, H, dh, dh + 1)}
                 if cache is not None else None)
    return sharding.layer_out(out, tp, seq_shard), new_cache


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
                cache: Optional[Dict] = None, seq_shard: bool = False
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) -> (out (B, S, d), new cache), one step per token in
    order (the recurrence).  ``cache`` = {"c", "n", "h", "m": (B, H, dh)
    float32} carries the state; without it the state starts at zero (m
    too: the reference's ``zeros - 1e30 * 0.0``).

    On a model axis whose plan takes the layer by heads
    (``sharding.model_plan().slstm``) the rank runs its H / M heads, with
    no collective in the time loop (the recurrence is block-diagonal by
    head): ``wx``'s and ``bias``'s columns, the norm scale and
    ``out_proj``'s rows are the rank's heads (head-major); ``r``'s shard
    splits the 4·dh gate columns inside each head, so ``r`` is gathered
    and the rank keeps its heads (the backward reduce-scatters).  The
    norm's mean of squares and the output products are summed over the
    ranks; the cache holds H / M heads.  With ``seq_shard`` the whole
    sequence is all-gathered for the time loop and the output is the
    rank's sequence shard, as :func:`mlstm_layer`'s."""
    tp = sharding.takes_shards("slstm")
    x = sharding.layer_in(x, tp, seq_shard)
    B, S, d = x.shape
    dh = d // num_heads
    H = sharding.model_share(num_heads, "slstm")
    r = p["r"]
    if tp:
        lo = sharding.model_group().rank * H
        r = sharding.gather_from_model(r, -1, partial_use=True)[lo:lo + H]
    xg = (x @ p["wx"] + p["bias"]).reshape(B, S, H, 4 * dh)
    r = wide(r)
    if cache is not None:
        c, n, h, m = cache["c"], cache["n"], cache["h"], cache["m"]
    else:
        c = n = h = m = torch.zeros((B, H, dh), dtype=wide_dtype(x.dtype),
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
    hseq = torch.stack(hs, 1).reshape(B, S, H * dh).to(x.dtype)
    out = rmsnorm_heads(hseq, p["norm"], "slstm") @ p["out_proj"]
    new_cache = ({"c": c, "n": n, "h": h, "m": m}
                 if cache is not None else None)
    return sharding.layer_out(out, tp, seq_shard), new_cache
