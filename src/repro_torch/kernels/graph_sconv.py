"""Fused graph + 1×1 spatial conv (paper C1, eq. (5)): out = Σ_k (G_k·x)·W_k.

Port of ``repro.kernels.graph_sconv.graph_sconv_pallas``.  The CUDA kernel
(``csrc/graph_sconv.cu``) keeps the G·x intermediate in shared memory, as
the TPU kernel keeps it in VMEM.  Cin is the *kept* channel count: channel
compaction happens before the call.

Layouts:  x (R, V, Cin), g (K, V, V), w (K, Cin, Cout) -> (R, V, Cout),
float32.  No joint padding: the kernel bounds-checks V.
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
