"""Cavity-pruned temporal convolution (paper C2), clip and streaming forms.

Ports of ``repro.kernels.cavity_tconv.cavity_tconv_pallas`` (clip) and
``cavity_tconv_step_pallas`` (one output step per K-frame window, the
streaming hot path).  Filters fall into L (=8) groups with identical
kept-tap sets; group g holds filters g, g+L, g+2L, … and computes only its
``n_keep`` shifted (C×Fg) products — the paper's FLOP skip.  The CUDA
kernels are ``csrc/cavity_tconv.cu`` and ``csrc/cavity_tconv_step.cu``.

Layouts (after ``ops.pack_cavity_weights``):
  x:    (B, T_pad, C)        clip input, already zero-padded on T
        (B, K, C)            streaming window, oldest frame first
  wp:   (L, n_keep, C, Fg)   packed kept-tap weights per group
  taps: (L, n_keep) int32    kept tap offsets per group, each in [0, K)
  out:  (B, T_out, L, Fg)    clip, T_out = (T_pad − K + 1) // stride
        (B, L, Fg)           streaming
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def _t_out(t_pad: int, kernel_size: int, stride: int) -> int:
    return (t_pad - kernel_size + 1) // stride


def _check_packed(name: str, x: torch.Tensor, wp: torch.Tensor,
                  taps: torch.Tensor) -> None:
    """Raise unless x (B, T, C), wp (L, n_keep, C, Fg) and taps
    (L, n_keep) fit each other and the kernels' types and layouts."""
    L, n_keep, C_w, _ = wp.shape
    if C_w != x.shape[2] or taps.shape != (L, n_keep):
        raise ValueError(f"{name}: shapes x{tuple(x.shape)} "
                         f"wp{tuple(wp.shape)} taps{tuple(taps.shape)} "
                         f"do not match")
    if taps.dtype != torch.int32 or taps.device != x.device:
        raise TypeError(f"{name}: taps must be int32 on x's device")
    if not taps.is_contiguous():
        raise ValueError(f"{name}: taps must be contiguous")
    _build.check_cuda_f32(name, x, wp)


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
    _check_packed("cavity_tconv", x, wp, taps)
    B, T_pad, C = x.shape
    L, n_keep, _, Fg = wp.shape
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


def cavity_tconv_step_plain(x: torch.Tensor, wp: torch.Tensor,
                            taps: torch.Tensor) -> torch.Tensor:
    """Plain version of the streaming form: a loop over the packed
    (L, n_keep) taps, one (B, C)·(C, Fg) product each."""
    B, K, C = x.shape
    L, n_keep, _, Fg = wp.shape
    out = torch.zeros((B, L, Fg), dtype=x.dtype, device=x.device)
    for g, row in enumerate(taps.tolist()):
        for j, off in enumerate(row):
            out[:, g] += x[:, off] @ wp[g, j]
    return out


def cavity_tconv_step_cuda(x: torch.Tensor, wp: torch.Tensor,
                           taps: torch.Tensor) -> torch.Tensor:
    """One output step per K-frame window, (B, K, C) -> (B, L, Fg):
    launches the CUDA kernel for CUDA tensors; CPU tensors take
    :func:`cavity_tconv_step_plain`.  The kernel stages x in float4s, so
    on the card C must be a multiple of 4 and x 16-byte aligned
    (``ops.cavity_tconv_step`` pads and copies to make it so)."""
    if _build.dispatch_device("cavity_tconv_step", x) == "cpu":
        return cavity_tconv_step_plain(x, wp, taps)
    _check_packed("cavity_tconv_step", x, wp, taps)
    if x.shape[2] % 4 or x.data_ptr() % 16:
        raise ValueError(f"cavity_tconv_step: C={x.shape[2]} is not a "
                         f"multiple of 4 or x is not 16-byte aligned")
    B, K, C = x.shape
    L, n_keep, _, Fg = wp.shape
    out = torch.empty((B, L, Fg), dtype=x.dtype, device=x.device)
    if B:
        _build.launch("cavity_tconv_step", "cavity_tconv_step_f32", x.device,
                      x.data_ptr(), wp.data_ptr(), taps.data_ptr(),
                      out.data_ptr(), B, K, C, L, n_keep, Fg)
    return out
