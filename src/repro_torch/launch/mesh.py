"""Shape-only meshes of one H100 node and the card's constants for the
roofline: the port's counterpart of ``repro.launch.mesh``.

A :class:`ShapeMesh` has axis names and sizes and nothing else (no
process group, no devices), which ``distributed.sharding`` accepts for
its shape logic: the dry run lays out a cell on it without a card.

    h100x1  (data 1, model 1): one card
    h100x8  (data 8, model 1): one 8-card NVLink node, data-parallel

The model axis stays 1: the port's train step raises on a model axis
above 1 (``train/steps.py:_check_mesh``; tensor and expert parallelism
are ROADMAP.md Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

# NVIDIA H100 SXM5 80 GB, per card, from NVIDIA's H100 Tensor Core GPU
# data sheet (SXM column):
HBM_BW = 3.35e12            # HBM3 bandwidth, B/s
PEAK_FLOPS_F32 = 67e12      # FP32 on the CUDA cores, FLOP/s
PEAK_FLOPS_TF32 = 495e12    # TF32 tensor core, dense (989 with sparsity)
PEAK_FLOPS_BF16 = 989e12    # BF16 tensor core, dense (1 979 with sparsity)
# NVLink 4: 900 GB/s a card, counting both directions (18 links of
# 50 GB/s); the collective term takes one direction, 450 GB/s
NVLINK_BW = 450e9           # B/s per direction
HBM_BYTES = 80 * 2 ** 30    # 80 GiB of device memory


@dataclasses.dataclass(frozen=True)
class ShapeMesh:
    """A mesh by its axis names and sizes alone."""
    name: str
    axis_names: Tuple[str, ...]
    dims: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return math.prod(self.dims)


def make_production_mesh(*, multi: bool = False) -> ShapeMesh:
    """``h100x8`` (one 8-card NVLink node, data 8) with ``multi``, else
    ``h100x1`` (one card)."""
    if multi:
        return ShapeMesh("h100x8", ("data", "model"), (8, 1))
    return ShapeMesh("h100x1", ("data", "model"), (1, 1))


def make_smoke_mesh() -> ShapeMesh:
    """One card with the production axis names (the CPU tests)."""
    return ShapeMesh("h100x1", ("data", "model"), (1, 1))
