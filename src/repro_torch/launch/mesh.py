"""Shape-only meshes of one H100 node and the card's constants for the
roofline: the port's counterpart of ``repro.launch.mesh``.

A :class:`ShapeMesh` has axis names and sizes and nothing else (no
process group, no devices), which ``distributed.sharding`` accepts for
its shape logic: the dry run lays out a cell on it without a card.

    h100x1    (data 1, model 1): one card
    h100x8    (data 8, model 1): one 8-card NVLink node, data-parallel
    h100x8m4  (data 2, model 4): the same node with a model axis of 4
              (tensor and expert parallelism), the counterpart of the
              model axis of JAX's production mesh (data 16, model 16)
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


MESHES = {
    "h100x1": ShapeMesh("h100x1", ("data", "model"), (1, 1)),
    "h100x8": ShapeMesh("h100x8", ("data", "model"), (8, 1)),
    "h100x8m4": ShapeMesh("h100x8m4", ("data", "model"), (2, 4)),
}


def make_production_mesh(*, multi: bool = False) -> ShapeMesh:
    """``h100x8`` (one 8-card NVLink node, data 8) with ``multi``, else
    ``h100x1`` (one card)."""
    return MESHES["h100x8" if multi else "h100x1"]


def named_mesh(name: str) -> ShapeMesh:
    """The shape-only mesh ``name`` of :data:`MESHES`."""
    if name not in MESHES:
        raise KeyError(f"unknown mesh {name!r} (one of {sorted(MESHES)})")
    return MESHES[name]


def make_smoke_mesh() -> ShapeMesh:
    """One card with the production axis names (the CPU tests)."""
    return ShapeMesh("h100x1", ("data", "model"), (1, 1))
