"""Quantization (paper C5): simulated Q8.8 fixed point, and per-channel
int8 weights (``repro.core.quant``'s int8 path)."""
from __future__ import annotations

from typing import Tuple

import torch

Q88_SCALE = 256.0          # 8 fractional bits


def quantize_q88(x: torch.Tensor) -> torch.Tensor:
    """Q8.8: 8 integer + 8 fractional bits.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the result is bit-equal to JAX's."""
    return torch.clamp(torch.round(x * Q88_SCALE), -32768, 32767) / Q88_SCALE


def quantize_int8(w: torch.Tensor, axis: int = -1
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel symmetric int8 quantization along ``axis``: returns
    (q int8, scale in w's dtype), q = round(w / scale) clipped to ±127."""
    amax = w.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`quantize_int8`: q·scale in the scale's dtype."""
    return q.to(scale.dtype) * scale


def int8_matmul(x: torch.Tensor, q: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """``x @ dequant(q)`` with the scale applied after the matmul: q
    (in, out) int8 with a per-output ``scale`` ((out,), (1, out)) or a
    per-input one ((in, 1), applied as its transpose, as JAX does)."""
    y = torch.einsum("...i,io->...o", x, q.to(x.dtype))
    return y * scale.reshape(1, -1) if scale.dim() <= 1 else y * scale.T
