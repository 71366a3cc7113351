"""Cavity-pruned temporal convolution (paper C2), clip form.

Port of ``repro.kernels.cavity_tconv.cavity_tconv_pallas``.  Filters fall
into L (=8) groups with identical kept-tap sets; group g holds filters
g, g+L, g+2L, … and computes only its ``n_keep`` shifted (C×Fg) products —
the paper's FLOP skip.  The CUDA kernel is ``csrc/cavity_tconv.cu``.

Layouts (after ``ops.pack_cavity_weights``):
  x:    (B, T_pad, C)        input, already zero-padded on T by the caller
  wp:   (L, n_keep, C, Fg)   packed kept-tap weights per group
  taps: (L, n_keep) int32    kept tap offsets per group, each in [0, K)
  out:  (B, T_out, L, Fg)    T_out = (T_pad − K + 1) // stride
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _t_out(t_pad: int, kernel_size: int, stride: int) -> int:
    return (t_pad - kernel_size + 1) // stride


def cavity_tconv_plain(x: torch.Tensor, wp: torch.Tensor, taps: torch.Tensor,
                       kernel_size: int = 9, stride: int = 1) -> torch.Tensor:
    """Plain version: a loop over the packed (L, n_keep) taps, one strided
    (B, T_out, C)·(C, Fg) product each."""
    B, T_pad, C = x.shape
    L, n_keep, _, Fg = wp.shape
    T_out = _t_out(T_pad, kernel_size, stride)
    out = torch.zeros((B, T_out, L, Fg), dtype=x.dtype, device=x.device)
    for g, row in enumerate(taps.tolist()):
        for j, off in enumerate(row):
            xs = x[:, off: off + T_out * stride: stride]
            out[:, :, g] += xs @ wp[g, j]
    return out


def cavity_tconv_cuda(x: torch.Tensor, wp: torch.Tensor, taps: torch.Tensor,
                      kernel_size: int = 9, stride: int = 1) -> torch.Tensor:
    """Packed cavity tconv (B, T_pad, C) -> (B, T_out, L, Fg): launches the
    CUDA kernel for CUDA tensors; CPU tensors take
    :func:`cavity_tconv_plain`."""
    if _build.dispatch_device("cavity_tconv", x) == "cpu":
        return cavity_tconv_plain(x, wp, taps, kernel_size, stride)
    B, T_pad, C = x.shape
    L, n_keep, C_w, Fg = wp.shape
    if C_w != C or taps.shape != (L, n_keep):
        raise ValueError(f"cavity_tconv: shapes x{tuple(x.shape)} "
                         f"wp{tuple(wp.shape)} taps{tuple(taps.shape)} "
                         f"do not match")
    if taps.dtype != torch.int32 or taps.device != x.device:
        raise TypeError("cavity_tconv: taps must be int32 on x's device")
    if not taps.is_contiguous():
        raise ValueError("cavity_tconv: taps must be contiguous")
    _build.check_cuda_f32("cavity_tconv", x, wp)
    T_out = _t_out(T_pad, kernel_size, stride)
    if T_out < 1:
        raise ValueError(f"cavity_tconv: T_pad={T_pad} is shorter than the "
                         f"kernel ({kernel_size})")
    out = torch.empty((B, T_out, L, Fg), dtype=x.dtype, device=x.device)
    if B:
        _build.launch("cavity_tconv", "cavity_tconv_f32", x.device,
                      x.data_ptr(), wp.data_ptr(), taps.data_ptr(),
                      out.data_ptr(), B, T_pad, C, L, n_keep, Fg, T_out,
                      stride, kernel_size)
    return out
