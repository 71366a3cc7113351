"""RFC encode/decode (paper §V-C): the runtime sparse inter-layer format.

Port of ``repro.kernels.rfc_pack.rfc_encode_pallas`` and
``rfc_decode_pallas``.  Encode fuses the ReLU, then front-packs the
non-zeros of each 16-channel bank in order (stable compaction) beside a
float hot mask; decode scatters them back.  On the TPU the compaction is a
one-hot permutation matmul; the CUDA kernels (``csrc/rfc_pack.cu``) map a
bank onto half a warp and take each value's slot from a ballot and a
popcount.

Layouts: x, values, hot, out all (rows, C) float32 with C % bank == 0
(``ops`` pads C).  The bank width of the CUDA kernels is 16.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

BANK = 16


def _banks(name: str, x: torch.Tensor, bank: int):
    rows, cols = x.shape
    if cols % bank:
        raise ValueError(f"{name}: C={cols} not divisible by bank={bank}")
    return x.reshape(rows, cols // bank, bank)


def rfc_encode_plain(x: torch.Tensor, bank: int = BANK):
    """Plain version: ReLU, then a cumsum-based scatter of each bank's
    non-zeros to its front (the zeros fill the tail)."""
    b = _banks("rfc_encode", torch.clamp_min(x, 0.0), bank)
    hot = b > 0
    n_hot = hot.sum(-1, keepdim=True)
    # a permutation: hot values to their rank, cold ones behind them
    dest = torch.where(hot, torch.cumsum(hot, -1) - 1,
                       n_hot + torch.cumsum(~hot, -1) - 1)
    vals = torch.zeros_like(b).scatter_(-1, dest, torch.where(hot, b, 0.0))
    return vals.reshape(x.shape), hot.to(x.dtype).reshape(x.shape)


def rfc_decode_plain(values: torch.Tensor, hot: torch.Tensor,
                     bank: int = BANK) -> torch.Tensor:
    """Plain version: a cumsum-based gather of each hot position's value."""
    v = _banks("rfc_decode", values, bank)
    h = _banks("rfc_decode", hot, bank) > 0
    pos = (torch.cumsum(h, -1) - 1).clamp_min(0)
    return torch.where(h, torch.gather(v, -1, pos), 0.0).reshape(values.shape)


def _check_bank(name: str, x: torch.Tensor, bank: int) -> None:
    if bank != BANK:
        raise ValueError(f"{name}: the CUDA kernel packs banks of {BANK}, "
                         f"not {bank}")
    if x.dim() != 2 or x.shape[1] % BANK:
        raise ValueError(f"{name}: expected (rows, C) with C % {BANK} == 0, "
                         f"got {tuple(x.shape)}")


def rfc_encode_cuda(x: torch.Tensor, bank: int = BANK):
    """ReLU + bank compaction (rows, C) -> (values, hot): launches the CUDA
    kernel for CUDA tensors; CPU tensors take :func:`rfc_encode_plain`."""
    if _build.dispatch_device("rfc_encode", x) == "cpu":
        return rfc_encode_plain(x, bank)
    _check_bank("rfc_encode", x, bank)
    _build.check_cuda_f32("rfc_encode", x)
    values = torch.empty_like(x)
    hot = torch.empty_like(x)
    if x.numel():
        _build.launch("rfc_encode", "rfc_encode_f32", x.device, x.data_ptr(),
                      values.data_ptr(), hot.data_ptr(), x.numel())
    return values, hot


def rfc_decode_cuda(values: torch.Tensor, hot: torch.Tensor,
                    bank: int = BANK) -> torch.Tensor:
    """Bank decompaction (values, hot) -> dense (rows, C): launches the
    CUDA kernel for CUDA tensors; CPU tensors take
    :func:`rfc_decode_plain`."""
    if _build.dispatch_device("rfc_decode", values) == "cpu":
        return rfc_decode_plain(values, hot, bank)
    _check_bank("rfc_decode", values, bank)
    if hot.shape != values.shape:
        raise ValueError("rfc_decode: values and hot differ in shape")
    _build.check_cuda_f32("rfc_decode", values, hot)
    out = torch.empty_like(values)
    if values.numel():
        _build.launch("rfc_decode", "rfc_decode_f32", values.device,
                      values.data_ptr(), hot.data_ptr(), out.data_ptr(),
                      values.numel())
    return out
