"""Fused graph + 1×1 spatial conv (paper C1, eq. (5)): out = Σ_k (G_k·x)·W_k,
over a dense graph and over an ELL-packed sparse one.

Ports of ``repro.kernels.graph_sconv.graph_sconv_pallas`` (dense) and
``graph_sconv_csr_pallas`` (sparse).  The CUDA kernels
(``csrc/graph_sconv.cu``, ``csrc/graph_sconv_csr.cu``, one template in
``csrc/sconv_mma.cuh``) keep the G·x intermediate in shared memory, as the
TPU kernels keep it in VMEM.  Cin is the *kept* channel count: channel
compaction happens before the call.  Both run the 1×1 product on the
tensor cores (TF32 with a 3-pass split, float32 in and out); the dense
kernel's graph product is a TF32 GEMM too, the sparse kernel's an ELL
gather in float32 on the CUDA cores.  The block tiles come from
:func:`sconv_plan` and :func:`csr_plan` here.

Layouts, float32 unless noted:
  dense:  x (R, V, Cin), g (K, V, V), w (K, Cin, Cout) -> (R, V, Cout)
  sparse: x (R, V, Cin), idx (K, V, D) int32 and val (K, V, D) (output
          row w's D neighbours and edge weights, zero-padded: value 0 at
          index 0), w (K, Cin, Cout) -> (R, V, Cout)
No joint padding: the kernels bound-check V.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.common.cost import reports_work

SM_COUNT = 132                 # the H100's streaming multiprocessors
SMEM_MAX = 227 * 1024          # dynamic shared memory a block may use
SMEM_TWO = 113 * 1024          # at most this, two blocks fit an SM
MAX_JOINTS = 128
# The dense kernel's block tiles, largest first, as (WM, WN, MT, NT, KC, W):
# WM x WN warps, each a (16·MT) × (8·NT) tile of (row, joint) pairs ×
# output channels, so the block's tile is (16·WM·MT) × (8·WN·NT); KC input
# channels a contraction chunk; W warps in all (the ones past WM·WN only
# stage and form G·x).  The order is csrc/sconv_mma.cuh's kTiles.
SCONV_TILES = ((4, 4, 2, 8, 16, 16), (4, 2, 2, 8, 16, 8),
               (4, 2, 2, 4, 16, 8), (2, 1, 2, 8, 32, 4), (1, 2, 2, 2, 64, 4),
               (1, 1, 1, 2, 64, 4), (1, 1, 1, 1, 64, 4), (1, 1, 1, 4, 64, 4))
# the tiles each planner tries, largest first: the ELL planner also takes
# 16 pairs × 32 channels, so that at stream shapes its costlier y (the
# gather) is formed for half as many channel tiles
DENSE_TILES = (0, 1, 2, 3, 4, 5, 6)
CSR_TILES = (0, 1, 2, 3, 4, 7, 5, 6)


class SconvPlan(NamedTuple):
    """One launch of either kernel: block tile ``tile`` (an index into
    :data:`SCONV_TILES`) of ``bm`` pairs × ``bn`` channels; each block
    owns ``rows`` rows of ``wt`` joints (whole rows when ``wt == V``, else
    a 16-joint-aligned slice of one row) and ``bn`` output channels, and
    keeps its x rows' channels in shared memory all at once (``xres``) or
    one contraction chunk's at a time."""
    tile: int
    rows: int
    wt: int
    xres: bool
    bm: int
    bn: int
    threads: int
    grid: tuple
    smem: int


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _smem_bytes(bm: int, bn: int, kc: int, rows: int, wt: int, V: int,
                Cin: int, xres: bool, D: int = 0) -> int:
    """csrc/sconv_mma.cuh:smem_floats, in bytes: the block's x rows (every
    channel, or a chunk's kc) and its joints' graph rows (dense, D = 0: x
    and G_k's rows as hi and lo planes; ELL: x in float32 and the D
    indices and values of its wt joints), the y chunk (hi and lo) and two
    W_k chunk buffers (hi and lo)."""
    def ld_a(k):
        return _up(k, 8) + 4

    def ld_b(n):
        return _up(n, 8) + (8 if _up(n, 8) % 16 == 0 else 0)
    xcols = ld_b(Cin if xres else kc)
    if D == 0:
        graph = (2 * (rows * V + _up(V, 8) - V) * xcols
                 + 2 * _up(wt, 16) * ld_a(V))
    else:
        graph = rows * V * xcols + 2 * _up(wt * D, 4)
    return 4 * (graph + 2 * bm * ld_a(kc) + 4 * kc * ld_b(bn))


def output_tiles(R: int, V: int, Cout: int) -> int:
    """The output's 16-joint × 8-channel tiles (joint tiles do not cross
    rows): the most blocks a launch can usefully have."""
    return R * -(-V // 16) * -(-Cout // 8)


@functools.lru_cache(maxsize=512)
def sconv_plan(R: int, V: int, Cin: int, Cout: int, K: int) -> SconvPlan:
    """The block tile for one dense launch.  Tiles wider than twice Cout
    are skipped; of the rest, the largest whose grid reaches
    min(132, :func:`output_tiles`) blocks and whose shared memory fits is
    taken.  At clip shapes that is one block per row tile owning every
    output channel (Cout ≤ 256), so y = G·x is formed once per row tile; at
    stream shapes (a few rows) it is a small tile, down to 16 joints × 8
    channels, and each block recomputes its cheap G·x."""
    return _plan("graph_sconv", R, V, Cin, Cout, K, 0)


@functools.lru_cache(maxsize=512)
def csr_plan(R: int, V: int, Cin: int, Cout: int, K: int,
             D: int) -> SconvPlan:
    """The block tile for one ELL launch of width D: :func:`sconv_plan`'s
    rule, with shared memory counting the block's x rows in float32 and
    its joints' D indices and values in place of G_k's rows."""
    if D <= 0:
        raise ValueError(f"graph_sconv_csr: no plan for ELL width D={D}")
    return _plan("graph_sconv_csr", R, V, Cin, Cout, K, D)


def _plan(name: str, R: int, V: int, Cin: int, Cout: int, K: int,
          D: int) -> SconvPlan:
    """The tile rule of :func:`sconv_plan` (D = 0) and :func:`csr_plan`."""
    if not (R > 0 and 0 < V <= MAX_JOINTS and Cin > 0 and Cout > 0 and K > 0):
        raise ValueError(f"{name}: no plan for R={R} V={V} Cin={Cin} "
                         f"Cout={Cout} K={K}")
    target = min(SM_COUNT, output_tiles(R, V, Cout))
    plans = []
    for tile in (CSR_TILES if D else DENSE_TILES):
        wm, wn, mt, nt, kc, warps = SCONV_TILES[tile]
        bm, bn = 16 * wm * mt, 8 * wn * nt
        if bn >= 2 * _up(Cout, 8):
            continue
        if V <= bm:
            rows, wt = min(R, bm // V), V
        else:
            rows, wt = 1, bm
        # x resident (staged and split once, not per k) unless it costs
        # the second block on an SM or does not fit; then fewer rows
        threads = 32 * warps
        res = _smem_bytes(bm, bn, kc, rows, wt, V, Cin, True, D)
        xres = res <= (SMEM_MAX if threads > 256 else SMEM_TWO)
        while rows > 1 and _smem_bytes(bm, bn, kc, rows, wt, V, Cin,
                                       xres, D) > SMEM_MAX:
            rows -= 1
        smem = _smem_bytes(bm, bn, kc, rows, wt, V, Cin, xres, D)
        if smem <= SMEM_MAX:
            grid = (-(-R // rows) * -(-V // wt), -(-Cout // bn))
            plans.append(SconvPlan(tile, rows, wt, xres, bm, bn, threads,
                                   grid, smem))
    for p in plans:
        if p.grid[0] * p.grid[1] >= target:
            return p
    return plans[-1]


def graph_sconv_work(R: int, V: int, Cin: int, Cout: int,
                     K: int) -> tuple:
    """(flops, bytes) of one dense call: the graph product and the 1×1
    conv's multiply-adds; x, g and w read once, the output written once
    (float32)."""
    flops = 2 * R * K * (V * V * Cin + V * Cin * Cout)
    return flops, 4 * (R * V * Cin + K * V * V + K * Cin * Cout + R * V * Cout)


def graph_sconv_csr_work(R: int, V: int, Cin: int, Cout: int, K: int, D: int,
                         nnz: int = None) -> tuple:
    """(flops, bytes) of one ELL call over ``nnz`` stored edges (default
    all K·V·D slots, what a shape-only count can see): the gather's and
    the 1×1 conv's multiply-adds; x, idx, val and w read once, the output
    written once."""
    nnz = K * V * D if nnz is None else nnz
    flops = 2 * R * (nnz * Cin + K * V * Cin * Cout)
    return flops, 4 * (R * V * Cin + 2 * K * V * D + K * Cin * Cout
                       + R * V * Cout)


def graph_sconv_plain(x: torch.Tensor, g: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Plain version: two einsums, the graph product then the 1×1 conv."""
    y = torch.einsum("rvc,kwv->krwc", x, g)
    return torch.einsum("krwc,kco->rwo", y, w)


@reports_work("graph_sconv", lambda x, g, w: graph_sconv_work(
    *x.shape, w.shape[2], w.shape[0]))
def graph_sconv_cuda(x: torch.Tensor, g: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """Σ_k (G_k·x)·W_k: launches the CUDA kernel for CUDA tensors; CPU
    tensors take :func:`graph_sconv_plain`."""
    if _build.dispatch_device("graph_sconv", x) == "cpu":
        return graph_sconv_plain(x, g, w)
    R, V, Cin = x.shape
    K, Cin_w, Cout = w.shape
    if g.shape != (K, V, V) or Cin_w != Cin:
        raise ValueError(f"graph_sconv: shapes x{tuple(x.shape)} "
                         f"g{tuple(g.shape)} w{tuple(w.shape)} do not match")
    _build.check_cuda_f32("graph_sconv", x, g, w)
    out = torch.empty((R, V, Cout), dtype=x.dtype, device=x.device)
    if R:
        p = sconv_plan(R, V, Cin, Cout, K)
        _build.launch("graph_sconv", "graph_sconv_f32", x.device,
                      x.data_ptr(), g.data_ptr(), w.data_ptr(),
                      out.data_ptr(), R, V, Cin, Cout, K, p.tile, p.rows,
                      p.wt, int(p.xres))
    return out


def _check_ell(x: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
               w: torch.Tensor) -> None:
    """Raise unless the ELL graph (K, V, D) and w (K, Cin, Cout) fit x
    (R, V, Cin) and the kernel's types and layouts."""
    R, V, Cin = x.shape
    K, Cin_w, _ = w.shape
    if (idx.dim() != 3 or tuple(idx.shape[:2]) != (K, V)
            or val.shape != idx.shape or Cin_w != Cin):
        raise ValueError(f"graph_sconv_csr: shapes x{tuple(x.shape)} "
                         f"idx{tuple(idx.shape)} val{tuple(val.shape)} "
                         f"w{tuple(w.shape)} do not match")
    if idx.dtype != torch.int32 or idx.device != x.device:
        raise TypeError("graph_sconv_csr: idx must be int32 on x's device")
    if not idx.is_contiguous():
        raise ValueError("graph_sconv_csr: idx must be contiguous")
    _build.check_cuda_f32("graph_sconv_csr", x, val, w)


def graph_sconv_csr_plain(x: torch.Tensor, idx: torch.Tensor,
                          val: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: per subset, D gather-accumulate sweeps (one
    neighbour of every output joint each), then the 1×1 conv."""
    R, V, Cin = x.shape
    out = x.new_zeros((R, V, w.shape[-1]))
    for k in range(w.shape[0]):
        agg = x.new_zeros((R, V, Cin))
        for d in range(idx.shape[-1]):
            agg = agg + (x.index_select(1, idx[k, :, d].long())
                         * val[k, :, d][None, :, None])
        out = out + agg @ w[k]
    return out


@reports_work("graph_sconv_csr", lambda x, idx, val, w: graph_sconv_csr_work(
    *x.shape, w.shape[2], w.shape[0], idx.shape[-1]))
def graph_sconv_csr_cuda(x: torch.Tensor, idx: torch.Tensor,
                         val: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Σ_k (G_k·x)·W_k over an ELL graph: launches the CUDA kernel for
    CUDA tensors; CPU tensors take :func:`graph_sconv_csr_plain`.  Every
    index lies in [0, V)."""
    if _build.dispatch_device("graph_sconv_csr", x) == "cpu":
        return graph_sconv_csr_plain(x, idx, val, w)
    _check_ell(x, idx, val, w)
    R, V, Cin = x.shape
    K, _, Cout = w.shape
    D = idx.shape[-1]
    out = torch.empty((R, V, Cout), dtype=x.dtype, device=x.device)
    if R:
        p = csr_plan(R, V, Cin, Cout, K, D)
        _build.launch("graph_sconv_csr", "graph_sconv_csr_f32", x.device,
                      x.data_ptr(), idx.data_ptr(), val.data_ptr(),
                      w.data_ptr(), out.data_ptr(), R, V, Cin, Cout, K, D,
                      p.tile, p.rows, p.wt, int(p.xres))
    return out
