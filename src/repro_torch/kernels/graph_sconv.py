"""Fused graph + 1×1 spatial conv (paper C1, eq. (5)): out = Σ_k (G_k·x)·W_k,
over a dense graph and over an ELL-packed sparse one.

Ports of ``repro.kernels.graph_sconv.graph_sconv_pallas`` (dense) and
``graph_sconv_csr_pallas`` (sparse).  The CUDA kernels
(``csrc/graph_sconv.cu``, ``csrc/graph_sconv_csr.cu``) keep the G·x
intermediate in shared memory, as the TPU kernels keep it in VMEM.  Cin is
the *kept* channel count: channel compaction happens before the call.
The dense kernel runs both products on the tensor cores (TF32 with a
3-pass split, float32 in and out) over the block tile that
:func:`sconv_plan` chooses here.

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

SM_COUNT = 132                 # the H100's streaming multiprocessors
SMEM_MAX = 227 * 1024          # dynamic shared memory a block may use
SMEM_TWO = 113 * 1024          # at most this, two blocks fit an SM
MAX_JOINTS = 128
# The dense kernel's block tiles, largest first, as (WM, WN, MT, NT, KC, W):
# WM x WN warps, each a (16·MT) × (8·NT) tile of (row, joint) pairs ×
# output channels, so the block's tile is (16·WM·MT) × (8·WN·NT); KC input
# channels a contraction chunk; W warps in all (the ones past WM·WN only
# stage and form G·x).  The order is csrc/graph_sconv.cu's kTiles.
SCONV_TILES = ((4, 4, 2, 8, 16, 16), (4, 2, 2, 8, 16, 8),
               (4, 2, 2, 4, 16, 8), (2, 1, 2, 8, 32, 4), (1, 2, 2, 2, 64, 4),
               (1, 1, 1, 2, 64, 4), (1, 1, 1, 1, 64, 4))


class SconvPlan(NamedTuple):
    """One launch of the dense kernel: block tile ``tile`` (an index into
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
                Cin: int, xres: bool) -> int:
    """csrc/graph_sconv.cu:smem_floats, in bytes: the block's x rows (every
    channel, or a chunk's kc), G_k's rows, the y chunk (each as hi and lo
    planes) and two W_k chunk buffers."""
    def ld_a(k):
        return _up(k, 8) + 4

    def ld_b(n):
        return _up(n, 8) + (8 if _up(n, 8) % 16 == 0 else 0)
    floats = (2 * (rows * V + _up(V, 8) - V) * ld_b(Cin if xres else kc)
              + 2 * _up(wt, 16) * ld_a(V) + 2 * bm * ld_a(kc)
              + 4 * kc * ld_b(bn))
    return 4 * floats


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
    if not (R > 0 and 0 < V <= MAX_JOINTS and Cin > 0 and Cout > 0 and K > 0):
        raise ValueError(f"graph_sconv: no plan for R={R} V={V} Cin={Cin} "
                         f"Cout={Cout} K={K}")
    target = min(SM_COUNT, output_tiles(R, V, Cout))
    plans = []
    for tile, (wm, wn, mt, nt, kc, warps) in enumerate(SCONV_TILES):
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
        res = _smem_bytes(bm, bn, kc, rows, wt, V, Cin, True)
        xres = res <= (SMEM_MAX if threads > 256 else SMEM_TWO)
        while rows > 1 and _smem_bytes(bm, bn, kc, rows, wt, V, Cin,
                                       xres) > SMEM_MAX:
            rows -= 1
        smem = _smem_bytes(bm, bn, kc, rows, wt, V, Cin, xres)
        if smem <= SMEM_MAX:
            grid = (-(-R // rows) * -(-V // wt), -(-Cout // bn))
            plans.append(SconvPlan(tile, rows, wt, xres, bm, bn, threads,
                                   grid, smem))
    for p in plans:
        if p.grid[0] * p.grid[1] >= target:
            return p
    return plans[-1]


def graph_sconv_plain(x: torch.Tensor, g: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """Plain version: two einsums, the graph product then the 1×1 conv."""
    y = torch.einsum("rvc,kwv->krwc", x, g)
    return torch.einsum("krwc,kco->rwo", y, w)


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
    out = torch.empty((R, V, Cout), dtype=x.dtype, device=x.device)
    if R:
        _build.launch("graph_sconv_csr", "graph_sconv_csr_f32", x.device,
                      x.data_ptr(), idx.data_ptr(), val.data_ptr(),
                      w.data_ptr(), out.data_ptr(), R, V, Cin, Cout, K,
                      idx.shape[-1])
    return out
