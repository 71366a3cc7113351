"""Skeleton graphs for 2s-AGCN (paper §II), numpy on the host.

A_k is the static NTU RGB+D 25-joint skeleton split into the ST-GCN
spatial-configuration subsets (identity / centripetal / centrifugal), each
column-normalized.  The learned dense B_k lives in the params; the engine
adds the two once, when it compiles a plan.  The arithmetic is the JAX
package's, step for step, so the adjacency is bit-equal to it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

# NTU RGB+D 25-joint skeleton, 1-indexed bone list (joint, parent).
NTU_EDGES = [
    (1, 2), (2, 21), (3, 21), (4, 3), (5, 21), (6, 5), (7, 6), (8, 7),
    (9, 21), (10, 9), (11, 10), (12, 11), (13, 1), (14, 13), (15, 14),
    (16, 15), (17, 1), (18, 17), (19, 18), (20, 19), (22, 23), (23, 8),
    (24, 25), (25, 12),
]
NTU_CENTER = 21  # spine joint (1-indexed)
NUM_JOINTS = 25


def _hop_distance(num_joints: int, edges) -> np.ndarray:
    adj = np.eye(num_joints, dtype=np.int32)
    for i, j in edges:
        adj[i - 1, j - 1] = 1
        adj[j - 1, i - 1] = 1
    dist = np.full((num_joints, num_joints), np.inf)
    power = np.eye(num_joints, dtype=np.int64)
    for d in range(num_joints):
        if d > 0:
            power = power @ adj
        dist[(power > 0) & np.isinf(dist)] = d
    return dist


def build_subsets(edges, center: int, num_joints: int,
                  num_subsets: int = 3) -> np.ndarray:
    """A of shape (K, V, V) float32: identity / centripetal / centrifugal
    subsets split by hop distance to ``center`` (1-indexed), each
    column-normalized (D^-1 A as in ST-GCN)."""
    V = num_joints
    dist = _hop_distance(V, edges)
    adj1 = (dist <= 1).astype(np.float64)       # self + 1-hop
    deg = adj1.sum(0)
    norm = adj1 / np.maximum(deg[None, :], 1)

    center_d = dist[:, center - 1]
    subsets = np.zeros((num_subsets, V, V), dtype=np.float64)
    for i in range(V):
        for j in range(V):
            if dist[i, j] > 1:
                continue
            if center_d[j] == center_d[i]:
                subsets[0, i, j] = norm[i, j]           # root (same distance)
            elif center_d[j] < center_d[i]:
                subsets[1, i, j] = norm[i, j]           # centripetal
            else:
                subsets[2, i, j] = norm[i, j]           # centrifugal
    return subsets.astype(np.float32)


def parents_from_edges(edges, num_joints: int) -> np.ndarray:
    """(V,) int32 parent index (0-indexed) per joint; roots parent
    themselves so the bone vector ``x - x[parents]`` is zero there."""
    parents = np.arange(num_joints, dtype=np.int32)
    for joint, parent in edges:
        parents[joint - 1] = parent - 1
    return parents


@dataclasses.dataclass(frozen=True, eq=False)
class GraphTopology:
    """A skeleton graph the engine can compile an ExecutionPlan for: the
    normalized subset stack and the parent map of the bone stream."""

    name: str
    num_joints: int
    center: int
    edges: Tuple[Tuple[int, int], ...]
    parents: np.ndarray        # (V,) int32, 0-indexed, roots self-parent
    adjacency: np.ndarray      # (K, V, V) float32 normalized subsets


_TOPOLOGY_CACHE: Dict[Tuple[str, int], GraphTopology] = {}


def get_topology(name: str = "ntu25", num_subsets: int = 3) -> GraphTopology:
    """The registry skeleton ``name``.  Only ``ntu25`` is ported so far."""
    if name != "ntu25":
        raise NotImplementedError(
            f"topology {name!r} is not ported yet (only 'ntu25'); the other "
            f"skeletons are ROADMAP.md Queue 1 item 8")
    key = (name, num_subsets)
    if key not in _TOPOLOGY_CACHE:
        _TOPOLOGY_CACHE[key] = GraphTopology(
            name=name, num_joints=NUM_JOINTS, center=NTU_CENTER,
            edges=tuple(NTU_EDGES),
            parents=parents_from_edges(NTU_EDGES, NUM_JOINTS),
            adjacency=build_subsets(NTU_EDGES, NTU_CENTER, NUM_JOINTS,
                                    num_subsets))
    return _TOPOLOGY_CACHE[key]
