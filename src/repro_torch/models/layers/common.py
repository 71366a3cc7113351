"""Shared layer primitives: norms, RoPE, inits, activations.  Port of
``repro.models.layers.common``."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def he_init(generator: torch.Generator, shape: Sequence[int],
            fan_in: int) -> torch.Tensor:
    """float32 normal weights with variance 2 / fan_in, drawn from
    ``generator`` on the generator's device."""
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w * math.sqrt(2.0 / max(1, fan_in))


def rmsnorm_init(d: int, device: Optional[torch.device] = None) -> Dict:
    return {"scale": torch.ones(d, device=device)}


def rmsnorm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics and the elementwise product in
    ``x``'s dtype."""
    var = x.float().square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":                   # jax.nn.gelu's default: tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":                  # squared ReLU
        return lambda x: torch.relu(x).square()
    raise ValueError(name)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos|cos, -sin|sin) of shape (B or 1, S, 1, head_dim) for positions
    (B, S) or (S,): computed once per forward and shared by every layer's
    :func:`rotate`."""
    freqs = rope_freqs(head_dim, theta, device)               # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rotate(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]
           ) -> torch.Tensor:
    """RoPE of x (B, S, H, D) from :func:`rope_tables`: the two halves of
    each head rotate (not interleaved pairs), as the reference does;
    x1·cos + x2·(−sin) and x2·cos + x1·sin equal the reference's
    x1·cos − x2·sin and x2·cos + x1·sin exactly."""
    cos2, sin2 = tables
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos2 + torch.cat([x2, x1], -1) * sin2).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta, x.device))
