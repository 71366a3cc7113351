"""Quantization (paper C5): simulated Q8.8 fixed point."""
from __future__ import annotations

import torch

Q88_SCALE = 256.0          # 8 fractional bits


def quantize_q88(x: torch.Tensor) -> torch.Tensor:
    """Q8.8: 8 integer + 8 fractional bits.  ``torch.round`` rounds half to
    even, as ``jnp.round`` does, so the result is bit-equal to JAX's."""
    return torch.clamp(torch.round(x * Q88_SCALE), -32768, 32767) / Q88_SCALE
