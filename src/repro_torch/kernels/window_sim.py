"""Windowed similarity graph C(t) of adaptive streaming, per slab slot:
the K-deep window sums of the θ/φ embedding rings, Θ·Φᵀ/√Ce, the input-
joint columns >= ``valid`` set to -1e30, and a row softmax.

Port of ``repro.kernels.window_sim.windowed_similarity_pallas``; the CUDA
kernel is ``csrc/window_sim.cu`` (one block per slot, nothing but the
(V, V) graph leaves the chip).  Its oracle is
``repro_torch.core.agcn.adaptive.windowed_ck(ring.sum(1), ...)``, which
the plain version calls.

Layouts: ring_th, ring_ph (S, K, V, Ce) float32 (any ring phase: the
window sum does not depend on it) -> (S, V, V).
"""
from __future__ import annotations

import torch

from repro_torch.core.agcn.adaptive import windowed_ck
from repro_torch.kernels import _build


def windowed_similarity_plain(ring_th: torch.Tensor, ring_ph: torch.Tensor,
                              valid: int) -> torch.Tensor:
    """Plain version: the ring rows summed in ring order (the kernel's),
    then the oracle ``adaptive.windowed_ck`` with columns >= ``valid``
    masked."""
    th, ph = ring_th[:, 0], ring_ph[:, 0]
    for k in range(1, ring_th.shape[1]):
        th = th + ring_th[:, k]
        ph = ph + ring_ph[:, k]
    return windowed_ck(th, ph, valid_joints=valid)


def windowed_similarity_cuda(ring_th: torch.Tensor, ring_ph: torch.Tensor,
                             valid: int) -> torch.Tensor:
    """(S, K, V, Ce) rings -> (S, V, V) graphs, columns >= ``valid``
    (1 <= valid <= V) masked: launches the CUDA kernel for CUDA tensors;
    CPU tensors take :func:`windowed_similarity_plain`."""
    if ring_th.dim() != 4 or ring_ph.shape != ring_th.shape:
        raise ValueError(f"windowed_similarity: rings {tuple(ring_th.shape)} "
                         f"and {tuple(ring_ph.shape)} do not match")
    S, K, V, Ce = ring_th.shape
    if not 1 <= valid <= V:
        raise ValueError(f"windowed_similarity: valid={valid} outside "
                         f"[1, {V}]")
    if _build.dispatch_device("windowed_similarity", ring_th) == "cpu":
        return windowed_similarity_plain(ring_th, ring_ph, valid)
    _build.check_cuda_f32("windowed_similarity", ring_th, ring_ph)
    out = torch.empty((S, V, V), dtype=ring_th.dtype, device=ring_th.device)
    if S:
        _build.launch("windowed_similarity", "window_sim_f32",
                      ring_th.device, ring_th.data_ptr(), ring_ph.data_ptr(),
                      out.data_ptr(), S, K, V, Ce, int(valid))
    return out
