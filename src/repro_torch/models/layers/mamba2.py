"""Mamba2 block (zamba2's backbone) on the shared SSD core.  Port of
``repro.models.layers.mamba2``, with its simplifications: one B/C group,
the gated RMSNorm after the SSD (y · silu(z), then the norm), a
depthwise causal conv of width ``conv_width``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers.common import he_init, rmsnorm, rmsnorm_init
from repro_torch.models.layers.ssd import ssd_scan, ssd_step

HEAD_P = 64    # mamba2 head channel dim


def mamba2_init(generator: Optional[torch.Generator], d_model: int,
                d_state: int, expand: int = 2, conv_width: int = 4,
                device: Optional[torch.device] = None) -> Dict:
    """Separate z / x / B / C / dt projections (as the reference's), the
    depthwise conv, A_log = log(linspace(1, 16, H)), D = 1 and
    dt_bias = 0."""
    d_inner = expand * d_model
    H = d_inner // HEAD_P
    dev = device if generator is None else generator.device
    return {
        "wz": he_init(generator, (d_model, d_inner), d_model),
        "wx": he_init(generator, (d_model, d_inner), d_model),
        "wb": he_init(generator, (d_model, d_state), d_model),
        "wc": he_init(generator, (d_model, d_state), d_model),
        "wdt": he_init(generator, (d_model, H), d_model) * 0.1,
        "conv_w": he_init(generator, (conv_width, d_inner), conv_width) * 0.1,
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, device=dev)),
        "D": torch.ones(H, device=dev),
        "dt_bias": torch.zeros(H, device=dev),
        "out_proj": he_init(generator, (d_inner, d_model), d_inner),
        "norm": rmsnorm_init(d_inner, dev),
    }


def _short_conv(x: torch.Tensor, w: torch.Tensor,
                cache: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal depthwise conv over S with SiLU.  x (B, S, C), w (K, C);
    ``cache`` (B, K − 1, C) holds the trailing context of a decode.
    Returns (out, the new trailing context)."""
    K = w.shape[0]
    if cache is not None:
        x_ext = torch.cat([cache.to(x.dtype), x], dim=1)
    else:
        x_ext = F.pad(x, (0, 0, K - 1, 0))
    S = x.shape[1]
    out = x_ext[:, 0:S] * w[0]
    for i in range(1, K):
        out = out + x_ext[:, i:i + S] * w[i]
    return F.silu(out), x_ext[:, -(K - 1):]


def mamba2_layer(p: Dict, x: torch.Tensor, d_state: int, expand: int = 2,
                 cache: Optional[Dict] = None
                 ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) -> (out (B, S, d), new cache).  With ``cache`` =
    {"conv": (B, K − 1, C), "ssm": (B, H, N, P)} a one-token step."""
    B, S, d = x.shape
    d_inner = expand * d
    H = d_inner // HEAD_P

    z = x @ p["wz"]
    xs = x @ p["wx"]
    Bm = x @ p["wb"]
    Cm = x @ p["wc"]
    dt = x @ p["wdt"]
    xs, new_conv = _short_conv(xs, p["conv_w"],
                               cache["conv"] if cache is not None else None)

    dt = F.softplus(dt + p["dt_bias"])                 # (B, S, H)
    A = -torch.exp(p["A_log"])                          # (H,) negative
    log_a = dt * A

    xh = xs.reshape(B, S, H, HEAD_P)
    if cache is not None:
        y, new_ssm = ssd_step(cache["ssm"], xh[:, 0], log_a[:, 0], dt[:, 0],
                              Bm[:, 0], Cm[:, 0])
        y = y[:, None]
    else:
        y, new_ssm = ssd_scan(xh, log_a, dt, Bm, Cm)
    y = y + xh * p["D"][:, None]
    y = y.reshape(B, S, d_inner)
    y = rmsnorm(y * F.silu(z), p["norm"])
    out = y @ p["out_proj"]
    new_cache = ({"conv": new_conv, "ssm": new_ssm}
                 if cache is not None else None)
    return out, new_cache
