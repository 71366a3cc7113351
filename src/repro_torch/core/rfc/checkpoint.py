"""RFC-checkpointed activations (C3 applied to training).  Port of
``repro.core.rfc.checkpoint``.

For a squared-ReLU MLP  y = relu(x·wi)² · wo  the hidden activation h is
sparse, and because h = relu(z)² the ReLU's mask is h > 0 and relu(z) is
√h.  So the backward pass needs only x, the weights and h, saved in the
RFC format (values and hot bits):

    dwo = hᵀ·g          dh = g·woᵀ
    dz  = dh · 2·√h     (zero where h == 0, exactly relu's mask)
    dwi = xᵀ·dz         dx = dz·wiᵀ

with no recompute of the up-projection.  On a CUDA tensor the forward
saves the hand-written encode's (values, bits) (``kernels.ops.rfc_encode``;
h >= 0, so its ReLU leaves h as it is) and the backward decodes them with
the hand-written decode; on the CPU the kernels' plain versions run.  The
decode is bit-exact, so the gradients are those of the plain autograd up
to the rounding of √(relu(z)²).

What is held: the format keeps full-width values beside the bits, so the
saved residual is larger than h itself (:func:`held_bytes`).  The saving
of :func:`checkpoint_bytes` is the paper's mini-bank storage model, not
memory this module saves.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.rfc.format import rfc_encode, storage_cost
from repro_torch.kernels import ops


class _MlpRelu2Rfc(torch.autograd.Function):
    """The custom VJP of :func:`mlp_relu2_rfc`."""

    @staticmethod
    def forward(ctx, x, wi, wo):
        h = torch.square(torch.relu(x @ wi))
        y = h @ wo
        vals, bits = ops.rfc_encode(h)              # the compressed residual
        ctx.save_for_backward(x, vals, bits, wi, wo)
        return y

    @staticmethod
    def backward(ctx, g):
        x, vals, bits, wi, wo = ctx.saved_tensors
        h = ops.rfc_decode(vals, bits)
        dwo = torch.einsum("...f,...d->fd", h, g)
        dh = torch.einsum("...d,fd->...f", g, wo)
        dz = dh * 2.0 * torch.sqrt(h)               # zero exactly off-mask
        dwi = torch.einsum("...c,...f->cf", x, dz)
        dx = torch.einsum("...f,cf->...c", dz, wi)
        return dx, dwi, dwo


def mlp_relu2_rfc(x: torch.Tensor, wi: torch.Tensor,
                  wo: torch.Tensor) -> torch.Tensor:
    """y = relu(x·wi)² · wo with the hidden activation saved for the
    backward pass in the RFC format.  x (..., d), wi (d, f), wo (f, d')."""
    return _MlpRelu2Rfc.apply(x, wi, wo)


def checkpoint_bytes(h: torch.Tensor, bank: int = 16,
                     minibank: int = 4) -> Tuple[int, int]:
    """(dense_bytes, rfc_bytes) of the stored hidden activation under the
    paper's storage model (:func:`~repro_torch.core.rfc.format.storage_cost`
    at h's element width): JAX's numbers."""
    _, hot = rfc_encode(h, bank=bank, apply_relu=False)
    c = storage_cost(hot, bank=bank, minibank=minibank,
                     elem_bits=8 * h.element_size())
    return int(c["dense_bits"] // 8), int(c["rfc_bits"] // 8)


def held_bytes(h: torch.Tensor) -> int:
    """Bytes the autograd graph holds for h in the port's format: the
    full-width values plus one int16 word per bank of 16 channels (C
    rounded up to a whole bank)."""
    C = h.shape[-1]
    rows = h.numel() // C if C else 0
    return h.numel() * h.element_size() + rows * (-(-C // 16)) * 2
