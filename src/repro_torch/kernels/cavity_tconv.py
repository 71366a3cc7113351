"""Cavity-pruned temporal convolution (paper C2), clip and streaming forms.

Ports of ``repro.kernels.cavity_tconv.cavity_tconv_pallas`` (clip) and
``cavity_tconv_step_pallas`` (one output step per K-frame window, the
streaming hot path).  Filters fall into L (=8) groups with identical
kept-tap sets; group g holds filters g, g+L, g+2L, … and computes only its
``n_keep`` shifted (C×Fg) products — the paper's FLOP skip.  The CUDA
kernels are ``csrc/cavity_tconv.cu`` (tensor cores, TF32 with a 3-pass
split, float32 in and out) and ``csrc/cavity_tconv_step.cu``.

Layouts (after ``ops.pack_cavity_weights``):
  x:    (N, T, V, C)         clip input, read in place: row (n, v) walks
                             t; 'same' zero padding is the kernel's bound
                             check
        (B, K, C)            streaming window, oldest frame first
  wp:   (L, n_keep, C, Fg)   packed kept-tap weights per group
  taps: (L, n_keep) int32    kept tap offsets per group, each in [0, K)
  inv_perm: (L·Fg,) int64    natural filter f sits in packed slot
                             inv_perm[f] = g·Fg + i
  out:  (N, T_out, V, F)     clip, natural filter order, the first F
                             filters; T_out = (T + 2·(K//2) − K)//stride + 1
        (B, L, Fg)           streaming, packed slot order
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

SMEM_MAX = 227 * 1024          # dynamic shared memory a block may use
TCONV_PAIRS = 128              # (row, step) pairs of a clip block's tile
_KC, _LDX, _LDB, _GROUPS = 8, 12, 8, 8   # csrc/cavity_tconv.cu's tiling


def t_out(T: int, kernel_size: int, stride: int) -> int:
    """Output steps of the 'same'-padded clip conv: conv semantics,
    ``(T + 2·pad − K)//stride + 1`` with pad = K//2."""
    return (T + 2 * (kernel_size // 2) - kernel_size) // stride + 1


class TconvPlan(NamedTuple):
    """One clip launch: each block owns ``nb`` rows (n, v) × ``tt`` output
    steps (≤ 128 pairs) and 8 groups × 8 filters of each."""
    tt: int
    nb: int
    grid: tuple
    smem: int


def _smem_bytes(nb: int, tt: int, stride: int, kernel_size: int,
                n_keep: int) -> int:
    """csrc/cavity_tconv.cu:smem_bytes: two buffers of the rows' x windows
    and of the (group, tap) weight slices, each as hi and lo planes, and
    the tap masks and filter map."""
    xplane = nb * ((tt - 1) * stride + kernel_size) * _LDX
    bplane = _GROUPS * n_keep * _KC * _LDB
    return 4 * (4 * xplane + 4 * bplane) + 4 * (_GROUPS * kernel_size
                                                + _GROUPS * 8 + 1)


@functools.lru_cache(maxsize=512)
def tconv_plan(B: int, T_out: int, L: int, n_keep: int, Fg: int,
               kernel_size: int, stride: int) -> TconvPlan:
    """The (rows × steps) block tile for B = N·V rows of T_out steps,
    among those that fit shared memory: the fewest blocks of 128 pairs
    (each pads the tile's unused pairs), each weighed with the window rows
    it stages (``(tt − 1)·stride + K`` per row), a quarter of a pair's
    cost."""
    best = None
    for tt in range(1, min(T_out, TCONV_PAIRS) + 1):
        nb = min(B, TCONV_PAIRS // tt)
        smem = _smem_bytes(nb, tt, stride, kernel_size, n_keep)
        if smem > SMEM_MAX:
            continue
        blocks = -(-B // nb) * -(-T_out // tt)
        staged = nb * ((tt - 1) * stride + kernel_size)
        key = (blocks * (4 * TCONV_PAIRS + staged), staged)
        if best is None or key < best[0]:
            best = key, TconvPlan(tt, nb, (blocks, -(-L // _GROUPS)
                                          * -(-Fg // 8)), smem)
    if best is None:
        raise ValueError(f"cavity_tconv: no tile fits shared memory at "
                         f"n_keep={n_keep}, K={kernel_size}")
    return best[1]


def _check_packed(name: str, x: torch.Tensor, wp: torch.Tensor,
                  taps: torch.Tensor) -> None:
    """Raise unless x (..., C), wp (L, n_keep, C, Fg) and taps
    (L, n_keep) fit each other and the kernels' types and layouts."""
    L, n_keep, C_w, _ = wp.shape
    if C_w != x.shape[-1] or taps.shape != (L, n_keep):
        raise ValueError(f"{name}: shapes x{tuple(x.shape)} "
                         f"wp{tuple(wp.shape)} taps{tuple(taps.shape)} "
                         f"do not match")
    if taps.dtype != torch.int32 or taps.device != x.device:
        raise TypeError(f"{name}: taps must be int32 on x's device")
    if not taps.is_contiguous():
        raise ValueError(f"{name}: taps must be contiguous")
    _build.check_cuda_f32(name, x, wp)


def cavity_tconv_plain(x: torch.Tensor, wp: torch.Tensor, taps: torch.Tensor,
                       inv_perm: torch.Tensor, num_filters: int,
                       kernel_size: int = 9, stride: int = 1) -> torch.Tensor:
    """Plain version: zero-pad T ('same'), then a loop over the packed
    (L, n_keep) taps, one strided (N, T_out, V, C)·(C, Fg) product each,
    gathered into natural filter order."""
    N, T, V, C = x.shape
    L, n_keep, _, Fg = wp.shape
    pad = kernel_size // 2
    T_out = t_out(T, kernel_size, stride)
    xp = F.pad(x, (0, 0, 0, 0, pad, kernel_size - 1 + T_out * stride - T - pad))
    out = x.new_zeros((N, T_out, V, L, Fg))
    for g, row in enumerate(taps.tolist()):
        for j, off in enumerate(row):
            if 0 <= off < kernel_size:        # taps outside read nothing
                xs = xp[:, off: off + T_out * stride: stride]
                out[:, :, :, g] += xs @ wp[g, j]
    flat = out.reshape(N, T_out, V, L * Fg).index_select(-1, inv_perm)
    return flat[..., :num_filters]


def cavity_tconv_cuda(x: torch.Tensor, wp: torch.Tensor, taps: torch.Tensor,
                      inv_perm: torch.Tensor, num_filters: int,
                      kernel_size: int = 9, stride: int = 1) -> torch.Tensor:
    """Cavity tconv (N, T, V, C) -> (N, T_out, V, F) in natural filter
    order: launches the CUDA kernel for CUDA tensors; CPU tensors take
    :func:`cavity_tconv_plain`."""
    if _build.dispatch_device("cavity_tconv", x) == "cpu":
        return cavity_tconv_plain(x, wp, taps, inv_perm, num_filters,
                                  kernel_size, stride)
    _check_packed("cavity_tconv", x, wp, taps)
    N, T, V, C = x.shape
    L, n_keep, _, Fg = wp.shape
    if (inv_perm.dtype != torch.int64 or inv_perm.device != x.device
            or inv_perm.shape != (L * Fg,) or not inv_perm.is_contiguous()):
        raise ValueError(f"cavity_tconv: inv_perm must be a contiguous int64 "
                         f"({L * Fg},) tensor on x's device")
    if not 0 < num_filters <= L * Fg:
        raise ValueError(f"cavity_tconv: num_filters={num_filters} outside "
                         f"(0, {L * Fg}]")
    T_out = t_out(T, kernel_size, stride)
    if T_out < 1:
        raise ValueError(f"cavity_tconv: T={T} gives no output step at "
                         f"K={kernel_size}, stride={stride}")
    out = torch.empty((N, T_out, V, num_filters), dtype=x.dtype,
                      device=x.device)
    if N and V:
        p = tconv_plan(N * V, T_out, L, n_keep, Fg, kernel_size, stride)
        # the split weights, laid out per block column and chunk by the
        # kernel's pre-pass
        scratch = torch.empty(2 * p.grid[1] * -(-C // _KC) * _GROUPS * n_keep
                              * _KC * _LDB, dtype=x.dtype, device=x.device)
        _build.launch("cavity_tconv", "cavity_tconv_f32", x.device,
                      x.data_ptr(), wp.data_ptr(), taps.data_ptr(),
                      inv_perm.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                      N, T, V, C, L, n_keep, Fg, num_filters, T_out, stride,
                      kernel_size, kernel_size // 2, p.tt, p.nb)
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
