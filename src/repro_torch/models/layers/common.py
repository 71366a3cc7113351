"""Shared layer primitives: norms, RoPE, inits, activations.  Port of
``repro.models.layers.common``."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def he_init(generator: Optional[torch.Generator], shape: Sequence[int],
            fan_in: int) -> torch.Tensor:
    """float32 normal weights with variance 2 / fan_in, drawn from
    ``generator`` on the generator's device.  Without a generator, an
    uninitialised tensor on the default device: the shape-only init under
    ``torch.device("meta")``."""
    if generator is None:
        return torch.empty(tuple(shape), dtype=torch.float32)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w * math.sqrt(2.0 / max(1, fan_in))


def lecun_init(generator: Optional[torch.Generator], shape: Sequence[int],
               fan_in: int) -> torch.Tensor:
    """float32 normal weights with variance 1 / fan_in, as
    :func:`he_init` draws them (shape-only without a generator)."""
    if generator is None:
        return torch.empty(tuple(shape), dtype=torch.float32)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w * math.sqrt(1.0 / max(1, fan_in))


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 for statistics, states and accumulators, or as it
    is when it is float64: a float64 run (chip_smoke's exact-arithmetic
    check of the SSM and hybrid recurrences) stays float64 throughout."""
    return x if x.dtype == torch.float64 else x.float()


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype :func:`wide` gives a tensor of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def rmsnorm_init(d: int, device: Optional[torch.device] = None) -> Dict:
    return {"scale": torch.ones(d, device=device)}


def rmsnorm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics and the elementwise product in
    ``x``'s dtype."""
    var = wide(x).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


def layernorm_init(d: int, device: Optional[torch.device] = None) -> Dict:
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def layernorm(x: torch.Tensor, p: Dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (the biased variance), cast back to ``x``'s
    dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def stack_layers(make: Callable[[], Dict], shape: Sequence[int]) -> Dict:
    """A tree whose leaves stack ``prod(shape)`` calls of ``make()`` (one
    layer's parameters) into leaves of shape (*shape, ...), drawn in
    row-major order; each layer is copied into its slot as it is drawn,
    so the tree is never held twice.  Under ``torch.device("meta")`` the
    leaves are shapes alone."""
    from repro_torch.common.tree import tree_map
    out = None
    n = math.prod(shape)
    for i in range(n):
        lp = make()
        if out is None:
            out = tree_map(lambda t: t.new_empty((*shape, *t.shape)), lp)
        idx = _unravel(i, shape)
        tree_map(lambda dst, src: dst[idx].copy_(src), out, lp)
    return out


def _unravel(i: int, shape: Sequence[int]) -> Tuple[int, ...]:
    idx = []
    for n in reversed(shape):
        idx.append(i % n)
        i //= n
    return tuple(reversed(idx))


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
    xf = wide(x)
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos2 + torch.cat([x2, x1], -1) * sin2).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta, x.device))
