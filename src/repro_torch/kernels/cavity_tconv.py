"""Cavity-pruned temporal convolution (paper C2), clip and streaming forms.

Ports of ``repro.kernels.cavity_tconv.cavity_tconv_pallas`` (clip) and
``cavity_tconv_step_pallas`` (one output step per K-frame window, the
streaming hot path).  Filters fall into L (=8) groups with identical
kept-tap sets; group g holds filters g, g+L, g+2L, … and computes only its
``n_keep`` shifted (C×Fg) products — the paper's FLOP skip.  The CUDA
kernels are ``csrc/cavity_tconv.cu`` and ``csrc/cavity_tconv_step.cu``
(tensor cores, TF32 with a 3-pass split, float32 in and out).  The
streaming kernel reads the stream state's ring in place at each slot's
phase and stores the block's output layout: kept filters at their
columns with the bias, pruned columns zero.

Layouts (after ``ops.pack_cavity_weights``):
  x:    (N, T, V, C)         clip input, read in place: row (n, v) walks
                             t; 'same' zero padding is the kernel's bound
                             check
  ring: (S, K, V, C)         streaming: a block's tconv-input ring, with
                             head (S,) int32, each slot's oldest frame
  wp:   (L, n_keep, C, Fg)   packed kept-tap weights per group
  taps: (L, n_keep) int32    kept tap offsets per group, each in [0, K)
  inv_perm: (L·Fg,) int64    natural filter f sits in packed slot
                             inv_perm[f] = g·Fg + i
  slot_col: (L·Fg,) int32    streaming: packed slot g·Fg + i -> its output
                             column, or −1 (padding, pruned)
  bias: (cout,)              streaming: per output column
  out:  (N, T_out, V, F)     clip, natural filter order, the first F
                             filters; T_out = (T + 2·(K//2) − K)//stride + 1
        (S, V, cout)         streaming, output columns
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.common.cost import reports_work

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


def cavity_tconv_work(N: int, T: int, V: int, C: int, L: int, n_keep: int,
                      Fg: int, F: int, T_out: int, pairs: int = None
                      ) -> tuple:
    """(flops, bytes) of one clip call with ``pairs`` (kept filter, tap)
    pairs holding weights (default F · n_keep, every kept filter at each
    of its group's taps): their multiply-adds; x, the packed weights, the
    taps and inv_perm read once, the output written once."""
    pairs = F * n_keep if pairs is None else pairs
    return (2 * N * V * T_out * C * pairs,
            4 * (N * T * V * C + L * n_keep * C * Fg + L * n_keep
                 + N * T_out * V * F) + 8 * L * Fg)


def cavity_tconv_step_work(S: int, K: int, V: int, C: int, L: int,
                           n_keep: int, Fg: int, cout: int, pairs: int = None,
                           frames: int = None) -> tuple:
    """(flops, bytes) of one ring step with ``pairs`` (packed slot, tap)
    pairs holding weights on live columns (default all L · n_keep · Fg)
    and ``frames`` ring frames some group reads (default all K): their
    multiply-adds; those frames, the packed weights, taps, slot_col, bias
    and head read once, the output written once."""
    pairs = L * n_keep * Fg if pairs is None else pairs
    frames = K if frames is None else frames
    return (2 * S * V * C * pairs,
            4 * (S * V * frames * C + L * n_keep * C * Fg + L * n_keep
                 + L * Fg + cout + S + S * V * cout))


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


@reports_work("cavity_tconv", lambda x, wp, taps, inv_perm, num_filters,
              kernel_size=9, stride=1: cavity_tconv_work(
                  *x.shape, *wp.shape[:2], wp.shape[3], num_filters,
                  t_out(x.shape[1], kernel_size, stride)))
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
    """Plain version of the packed streaming product on chronological
    windows (B, K, C) -> (B, L, Fg): a loop over the packed (L, n_keep)
    taps, one (B, C)·(C, Fg) product each."""
    B, K, C = x.shape
    L, n_keep, _, Fg = wp.shape
    out = torch.zeros((B, L, Fg), dtype=x.dtype, device=x.device)
    for g, row in enumerate(taps.tolist()):
        for j, off in enumerate(row):
            out[:, g] += x[:, off] @ wp[g, j]
    return out


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


class StepPlan(NamedTuple):
    """One streaming launch: blocks of ``16·wm`` rows × one group's slots,
    ``parts`` blocks (a cluster) sharing each tile's contraction; grid
    (row tiles, L, parts)."""
    wm: int
    parts: int
    grid: tuple
    smem: int


STEP_WM = (1, 2, 4)            # 16-row tiles of a block (its 4 warps)
STEP_PARTS = (8, 4, 2, 1)      # blocks of a cluster (portable sizes)
STEP_MAX_BLOCKS = 512          # about 4 resident blocks an SM


def _step_smem_bytes(wm: int, qw: int, nb: int, n_keep: int, slots: int,
                     cout: int) -> int:
    """csrc/cavity_tconv_step.cu:step_smem_words, in bytes: the block's
    frame rows (16·wm × qw) and weight rows (qw × nb), the warps' partial
    tiles, the (row, tap) frame indices, the store map of all ``slots``,
    the bias and the column marks."""
    bm = 16 * wm
    ld_b = _up(nb, 8) + (8 if _up(nb, 8) % 16 == 0 else 0)
    return 4 * (bm * (_up(qw, 8) + 4) + qw * ld_b + (4 // wm) * bm * nb
                + _up(bm * n_keep, 4) + _up(slots, 4) + _up(cout, 4) + cout)


@functools.lru_cache(maxsize=512)
def step_plan(B: int, C: int, L: int, n_keep: int, Fg: int,
              cout: int) -> StepPlan:
    """The tile and cluster size of one streaming launch over B rows.  A
    block's time is latency, so the work is spread over as many blocks as
    help: 16-row tiles, with clusters of as many parts as the (tap,
    8-channel) steps allow up to 8 (the portable size), halved while the
    grid would pass 512 blocks (about 4 resident an SM); larger tiles only
    where that is not enough or shared memory would not fit.  S = 1, 3
    and 8 slots of 25 joints take 128, 320 and 416 blocks.  (Same-call
    timings on the H100 of every tile and cluster size,
    ``tools/torch_kernel_plans.py``, put this pick within 6% of the
    fastest at 25 joints; at 50 joints it is up to 33% slower, at S = 8
    and C = 256, where 32-row tiles in clusters of 8 win.)"""
    if not (B > 0 and C > 0 and L > 0 and 0 < n_keep <= 16
            and 0 < Fg <= 64 and cout > 0):
        raise ValueError(f"cavity_tconv_step: no plan for B={B} C={C} L={L} "
                         f"n_keep={n_keep} Fg={Fg} cout={cout}")
    steps, nb = n_keep * -(-C // 8), _up(Fg, 8)
    fits = []
    for wm in STEP_WM:
        for parts in STEP_PARTS:
            qw = -(-steps // parts) * 8
            smem = _step_smem_bytes(wm, qw, nb, n_keep, L * Fg, cout)
            if parts <= steps and smem <= SMEM_MAX:
                fits.append(StepPlan(wm, parts, (-(-B // (16 * wm)), L,
                                                 parts), smem))
    if not fits:
        raise ValueError(f"cavity_tconv_step: no tile fits shared memory at "
                         f"C={C}, n_keep={n_keep}, Fg={Fg}, cout={cout}")
    for p in fits:
        if p.grid[0] * p.grid[1] * p.grid[2] <= STEP_MAX_BLOCKS:
            return p
    return min(fits, key=lambda p: p.grid[0] * p.grid[1] * p.grid[2])


def column_sources(slot_col: torch.Tensor, cout: int) -> torch.Tensor:
    """The inverse of ``slot_col``: (cout,) int64, the packed slot each
    output column takes, or L·Fg (no slot: a pruned filter).  No host
    sync: the unmapped slots scatter into a dropped extra column."""
    n = slot_col.shape[0]
    dest = torch.where(slot_col >= 0, slot_col.long(),
                       torch.full_like(slot_col, cout, dtype=torch.int64))
    src = torch.full((cout + 1,), n, dtype=torch.int64,
                     device=slot_col.device)
    src.scatter_(0, dest, torch.arange(n, device=slot_col.device))
    return src[:cout]


def cavity_tconv_step_ring_plain(ring: torch.Tensor, head: torch.Tensor,
                                 wp: torch.Tensor, taps: torch.Tensor,
                                 slot_col: torch.Tensor,
                                 bias: torch.Tensor) -> torch.Tensor:
    """Plain version of the ring form, (S, K, V, C) -> (S, V, cout): each
    slot's window gathered oldest first from ``head``, transposed to
    (S·V, K, C) rows, :func:`cavity_tconv_step_plain`, then each output
    column takes its slot plus its bias (columns no slot reaches: 0)."""
    S, K, V, C = ring.shape
    L, _, _, Fg = wp.shape
    cout = bias.shape[0]
    chrono = (head.long()[:, None]
              + torch.arange(K, device=ring.device)[None, :]) % K
    win = torch.gather(ring, 1, chrono[:, :, None, None].expand(S, K, V, C))
    packed = cavity_tconv_step_plain(
        win.permute(0, 2, 1, 3).reshape(S * V, K, C), wp, taps)
    src = column_sources(slot_col, cout)
    flat = torch.cat([packed.reshape(S * V, L * Fg),
                      packed.new_zeros((S * V, 1))], 1).index_select(1, src)
    out = torch.where(src < L * Fg, flat + bias, 0.0)
    return out.reshape(S, V, cout)


@reports_work("cavity_tconv_step", lambda ring, head, wp, taps, slot_col,
              bias, plan=None: cavity_tconv_step_work(
                  *ring.shape, *wp.shape[:2], wp.shape[3], bias.shape[0]))
def cavity_tconv_step_ring_cuda(ring: torch.Tensor, head: torch.Tensor,
                                wp: torch.Tensor, taps: torch.Tensor,
                                slot_col: torch.Tensor, bias: torch.Tensor,
                                plan: Optional[StepPlan] = None
                                ) -> torch.Tensor:
    """One output step per slot from its ring, (S, K, V, C) ->
    (S, V, cout): launches the CUDA kernel for CUDA tensors; CPU tensors
    take :func:`cavity_tconv_step_ring_plain`.  ``plan`` overrides
    :func:`step_plan` (``tools/torch_kernel_plans.py`` times them all)."""
    if _build.dispatch_device("cavity_tconv_step", ring) == "cpu":
        return cavity_tconv_step_ring_plain(ring, head, wp, taps, slot_col,
                                            bias)
    if ring.dim() != 4:
        raise ValueError(f"cavity_tconv_step: ring{tuple(ring.shape)} is not "
                         f"(S, K, V, C)")
    _check_packed("cavity_tconv_step", ring, wp, taps)
    S, K, V, C = ring.shape
    L, n_keep, _, Fg = wp.shape
    cout = bias.shape[0] if bias.dim() == 1 else -1
    for name, t, shape in (("head", head, (S,)),
                           ("slot_col", slot_col, (L * Fg,))):
        if (t.dtype != torch.int32 or t.device != ring.device
                or t.shape != shape or not t.is_contiguous()):
            raise ValueError(f"cavity_tconv_step: {name} must be a contiguous "
                             f"int32 {shape} tensor on the ring's device")
    if cout <= 0:
        raise ValueError(f"cavity_tconv_step: bias{tuple(bias.shape)} is not "
                         f"(cout,)")
    _build.check_cuda_f32("cavity_tconv_step", ring, bias)
    p = plan or step_plan(S * V, C, L, n_keep, Fg, cout)
    out = torch.empty((S, V, cout), dtype=ring.dtype, device=ring.device)
    _build.launch("cavity_tconv_step", "cavity_tconv_step_f32", ring.device,
                  ring.data_ptr(), head.data_ptr(), wp.data_ptr(),
                  taps.data_ptr(), slot_col.data_ptr(), bias.data_ptr(),
                  out.data_ptr(), S, K, V, C, L, n_keep, Fg, cout, p.wm,
                  p.parts)
    return out


@reports_work("cavity_tconv_step", lambda x, wp, taps: cavity_tconv_step_work(
    x.shape[0], x.shape[1], 1, x.shape[2], *wp.shape[:2], wp.shape[3],
    wp.shape[0] * wp.shape[3]))
def cavity_tconv_step_cuda(x: torch.Tensor, wp: torch.Tensor,
                           taps: torch.Tensor) -> torch.Tensor:
    """The packed streaming product on chronological windows, (B, K, C) ->
    (B, L, Fg) in packed slot order: CPU tensors take
    :func:`cavity_tconv_step_plain`; CUDA tensors launch the ring kernel
    on the windows as a ring of B slots of one joint, every head 0, each
    slot its own column, no bias."""
    if _build.dispatch_device("cavity_tconv_step", x) == "cpu":
        return cavity_tconv_step_plain(x, wp, taps)
    B, K, C = x.shape
    L, _, _, Fg = wp.shape
    dev = x.device
    out = cavity_tconv_step_ring_cuda(
        x.reshape(B, K, 1, C), torch.zeros(B, dtype=torch.int32, device=dev),
        wp, taps, torch.arange(L * Fg, dtype=torch.int32, device=dev),
        torch.zeros(L * Fg, dtype=x.dtype, device=dev))
    return out.reshape(B, L, Fg)
