"""Fused graph + 1×1 spatial conv (paper C1, eq. (5)): out = Σ_k (G_k·x)·W_k,
over a dense graph and over an ELL-packed sparse one.

Ports of ``repro.kernels.graph_sconv.graph_sconv_pallas`` (dense) and
``graph_sconv_csr_pallas`` (sparse).  The CUDA kernels
(``csrc/graph_sconv.cu``, ``csrc/graph_sconv_csr.cu``) keep the G·x
intermediate in shared memory, as the TPU kernels keep it in VMEM.  Cin is
the *kept* channel count: channel compaction happens before the call.

Layouts, float32 unless noted:
  dense:  x (R, V, Cin), g (K, V, V), w (K, Cin, Cout) -> (R, V, Cout)
  sparse: x (R, V, Cin), idx (K, V, D) int32 and val (K, V, D) (output
          row w's D neighbours and edge weights, zero-padded: value 0 at
          index 0), w (K, Cin, Cout) -> (R, V, Cout)
No joint padding: the kernels bound-check V.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


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
        _build.launch("graph_sconv", "graph_sconv_f32", x.device,
                      x.data_ptr(), g.data_ptr(), w.data_ptr(),
                      out.data_ptr(), R, V, Cin, Cout, K)
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
