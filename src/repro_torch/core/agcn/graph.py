"""Skeleton graphs for 2s-AGCN (paper §II), numpy on the host.

A_k is a static skeleton split into the ST-GCN spatial-configuration
subsets (identity / centripetal / centrifugal), each column-normalized.
The learned dense B_k lives in the params; the engine adds the two once,
when it compiles a plan.  The data-dependent C_k lives in
``repro_torch.core.agcn.adaptive``.  A ``GraphTopology`` holds a skeleton's
subset stack, its CSR factorization (for the sparse spatial conv), the
parent map of the bone stream and the joint-validity mask of a plan padded
to a wider slab.  Registry: ``ntu25`` (NTU RGB+D), ``ntu50`` (two NTU
persons), ``hand21`` and ``body_hand46``.  The arithmetic is the JAX
package's, step for step, so every array is bit-equal to it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

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


def build_ntu_subsets(num_subsets: int = 3) -> np.ndarray:
    """A of shape (K, V, V) for the NTU 25-joint skeleton: identity /
    centripetal / centrifugal subsets, each column-normalized."""
    return build_subsets(NTU_EDGES, NTU_CENTER, NUM_JOINTS, num_subsets)


def static_graph(num_subsets: int = 3) -> torch.Tensor:
    """The normalized NTU subset graphs A as a (K, V, V) float32 CPU
    tensor."""
    return torch.from_numpy(build_ntu_subsets(num_subsets))


def similarity_graph(x: torch.Tensor, w_theta: torch.Tensor,
                     w_phi: torch.Tensor) -> torch.Tensor:
    """C_k = softmax(theta(x)^T phi(x)) over joints, eq. (1): x (N, T, V,
    C), w_theta and w_phi (C, Ce) -> (N, V, V) in x's dtype.

    The paper's full-clip ablation form: one graph per clip, the
    embeddings summed over all T frames.  The streaming engine serves the
    causal per-frame form instead (``adaptive.windowed_ck``: a trailing
    window of pooled embeddings per tick), which reaches this form once
    the window spans the clip."""
    theta = torch.einsum("ntvc,ce->nve", x, w_theta)
    phi = torch.einsum("ntvc,ce->nve", x, w_phi)
    logits = torch.einsum("nve,nwe->nvw", theta, phi) / torch.sqrt(
        torch.tensor(float(theta.shape[-1]), dtype=x.dtype, device=x.device))
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    return (e / e.sum(-1, keepdim=True)).to(x.dtype)


def parents_from_edges(edges, num_joints: int) -> np.ndarray:
    """(V,) int32 parent index (0-indexed) per joint; roots parent
    themselves so the bone vector ``x - x[parents]`` is zero there."""
    parents = np.arange(num_joints, dtype=np.int32)
    for joint, parent in edges:
        parents[joint - 1] = parent - 1
    return parents


def graph_sparsity(a: np.ndarray) -> float:
    """Fraction of zero entries (A_k is sparse, B_k is dense: paper §I)."""
    return float((a == 0).mean())


def dense_to_csr(a: np.ndarray, eps: float = 0.0):
    """A dense (K, V, V) subset stack as per-k CSR over output rows.

    Row w of subset k holds the input joints v with ``|a[k, w, v]| > eps``.
    Returns ``(indptr (K, V+1) int32, indices (K, E) int32, values (K, E)
    float32)`` with E the largest nnz over k; shorter subsets are
    zero-padded (a zero value adds nothing in the gather-accumulate)."""
    a = np.asarray(a)
    K, V, _ = a.shape
    per_k = []
    for k in range(K):
        rows, cols = np.nonzero(np.abs(a[k]) > eps)
        per_k.append((rows.astype(np.int64), cols.astype(np.int64),
                      a[k][rows, cols].astype(np.float32)))
    E = max(1, max(len(r) for r, _, _ in per_k))
    indptr = np.zeros((K, V + 1), np.int32)
    indices = np.zeros((K, E), np.int32)
    values = np.zeros((K, E), np.float32)
    for k, (rows, cols, vals) in enumerate(per_k):
        indptr[k, 1:] = np.cumsum(np.bincount(rows, minlength=V))
        indices[k, : len(cols)] = cols       # np.nonzero is row-major
        values[k, : len(vals)] = vals
    return indptr, indices, values


def csr_to_dense(indptr: np.ndarray, indices: np.ndarray,
                 values: np.ndarray) -> np.ndarray:
    """Inverse of :func:`dense_to_csr`: the (K, V, V) stack."""
    K, V1 = np.asarray(indptr).shape
    V = V1 - 1
    out = np.zeros((K, V, V), np.float32)
    for k in range(K):
        for w in range(V):
            lo, hi = int(indptr[k, w]), int(indptr[k, w + 1])
            out[k, w, indices[k, lo:hi]] += values[k, lo:hi]
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class GraphTopology:
    """A skeleton graph the engine can compile an ExecutionPlan for: the
    normalized subset stack and its CSR factorization, the parent map of
    the bone stream, and the joint-validity mask used when the skeleton
    rides in a slab padded to a wider ``Vmax``."""

    name: str
    num_joints: int
    center: int
    edges: Tuple[Tuple[int, int], ...]
    parents: np.ndarray        # (V,) int32, 0-indexed, roots self-parent
    adjacency: np.ndarray      # (K, V, V) float32 normalized subsets
    indptr: np.ndarray         # (K, V+1) int32 CSR row pointers
    indices: np.ndarray        # (K, E) int32 CSR column indices
    values: np.ndarray         # (K, E) float32 CSR values
    valid: np.ndarray          # (V,) bool joint-validity mask

    @property
    def num_subsets(self) -> int:
        """K, the number of spatial-configuration subsets."""
        return int(self.adjacency.shape[0])

    @property
    def density(self) -> float:
        """Fraction of non-zero entries of the normalized adjacency."""
        return 1.0 - graph_sparsity(self.adjacency)

    def padded_valid(self, vmax: int) -> np.ndarray:
        """(vmax,) bool mask: this skeleton's joints inside a Vmax slab."""
        out = np.zeros(vmax, bool)
        out[: self.num_joints] = self.valid
        return out


def make_topology(name: str, edges: Sequence[Tuple[int, int]], center: int,
                  num_joints: int, num_subsets: int = 3) -> GraphTopology:
    """A :class:`GraphTopology` from a 1-indexed bone list."""
    adjacency = build_subsets(edges, center, num_joints, num_subsets)
    indptr, indices, values = dense_to_csr(adjacency)
    return GraphTopology(
        name=name, num_joints=num_joints, center=center,
        edges=tuple((int(j), int(p)) for j, p in edges),
        parents=parents_from_edges(edges, num_joints),
        adjacency=adjacency, indptr=indptr, indices=indices, values=values,
        valid=np.ones(num_joints, bool))


def _ntu50_edges():
    """Two-person NTU scene: block-diagonal person graphs plus one link
    from person 2's spine to person 1's."""
    edges = list(NTU_EDGES)
    edges += [(j + NUM_JOINTS, p + NUM_JOINTS) for j, p in NTU_EDGES]
    edges.append((NTU_CENTER + NUM_JOINTS, NTU_CENTER))
    return edges


# 21-joint hand: wrist (1) plus five 4-joint finger chains.
HAND_EDGES = [
    (2, 1), (3, 2), (4, 3), (5, 4),          # thumb
    (6, 1), (7, 6), (8, 7), (9, 8),          # index
    (10, 1), (11, 10), (12, 11), (13, 12),   # middle
    (14, 1), (15, 14), (16, 15), (17, 16),   # ring
    (18, 1), (19, 18), (20, 19), (21, 20),   # pinky
]


def _body_hand46_edges():
    """The NTU body with a 21-joint hand grafted onto its right-hand joint
    (NTU joint 12)."""
    edges = list(NTU_EDGES)
    edges += [(j + NUM_JOINTS, p + NUM_JOINTS) for j, p in HAND_EDGES]
    edges.append((1 + NUM_JOINTS, 12))       # hand wrist -> body right hand
    return edges


_TOPOLOGY_SPECS = {
    "ntu25": (NTU_EDGES, NTU_CENTER, NUM_JOINTS),
    "ntu50": (_ntu50_edges(), NTU_CENTER, 2 * NUM_JOINTS),
    "hand21": (HAND_EDGES, 1, 21),
    "body_hand46": (_body_hand46_edges(), NTU_CENTER, NUM_JOINTS + 21),
}
_TOPOLOGY_CACHE: Dict[Tuple[str, int], GraphTopology] = {}


def topology_names() -> Tuple[str, ...]:
    """Names of the registered skeleton topologies."""
    return tuple(_TOPOLOGY_SPECS)


def get_topology(name: str = "ntu25", num_subsets: int = 3) -> GraphTopology:
    """The registry skeleton ``name`` (cached); ``KeyError`` for a name
    that is not registered."""
    key = (name, num_subsets)
    if key not in _TOPOLOGY_CACHE:
        if name not in _TOPOLOGY_SPECS:
            raise KeyError(
                f"unknown topology {name!r}; registered: {topology_names()}")
        edges, center, num_joints = _TOPOLOGY_SPECS[name]
        _TOPOLOGY_CACHE[key] = make_topology(name, edges, center,
                                             num_joints, num_subsets)
    return _TOPOLOGY_CACHE[key]
