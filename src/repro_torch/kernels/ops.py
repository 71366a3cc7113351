"""Public wrappers around the kernels: layout adaptation (padding, the
cavity filter-group permutation, kept-tap and ELL packing) so callers use
natural shapes.  Port of ``repro.kernels.ops`` (all but flash decoding).

Each wrapper reaches its kernel through the kernel module's ``*_cuda``
function, which dispatches on the input's device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import cavity_tconv as _ct
from repro_torch.kernels import graph_sconv as _gs
from repro_torch.kernels import rfc_pack as _rfc
from repro_torch.kernels import window_sim as _ws


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> torch.Tensor:
    """Zero-pad ``axis`` up to a multiple of ``mult``."""
    pad = (-x.shape[axis]) % mult
    if pad == 0:
        return x
    widths = [0, 0] * x.dim()
    widths[2 * (x.dim() - 1 - axis) + 1] = pad     # F.pad runs last axis first
    return F.pad(x, widths)


# ---------------------------------------------------------------------------
# RFC
# ---------------------------------------------------------------------------

def rfc_encode(x: torch.Tensor, bank: int = 16):
    """Encode activations of any (..., C) shape; returns (values, hot).
    C is zero-padded to a whole number of banks for the kernel."""
    shape = x.shape
    flat = _pad_to(x.reshape(-1, shape[-1]), 1, bank).contiguous()
    vals, hot = _rfc.rfc_encode_cuda(flat, bank=bank)
    return (vals[:, : shape[-1]].reshape(shape),
            hot[:, : shape[-1]].reshape(shape))


def rfc_decode(values: torch.Tensor, hot: torch.Tensor,
               bank: int = 16) -> torch.Tensor:
    """Inverse of :func:`rfc_encode`, any (..., C) shape; lossless on
    post-ReLU activations."""
    shape = values.shape
    v = _pad_to(values.reshape(-1, shape[-1]), 1, bank).contiguous()
    h = _pad_to(hot.reshape(-1, shape[-1]), 1, bank).contiguous()
    out = _rfc.rfc_decode_cuda(v, h, bank=bank)
    return out[:, : shape[-1]].reshape(shape)


# ---------------------------------------------------------------------------
# Cavity temporal conv
# ---------------------------------------------------------------------------

def pack_cavity_weights(
    w: np.ndarray,           # (F, C, K) dense weights of the *kept* filters
    tap_mask: np.ndarray,    # (F, K) bool — cavity pattern tiled to F
    loop: int = 8,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group filters by recurring pattern row (f % loop) and pack kept taps.

    Returns (wp (L, n_keep, C, Fg), taps (L, n_keep) int32, inv_perm (Fp,)
    int32): ``out.reshape(..., L*Fg)[..., inv_perm]`` is the natural
    filter order.  Filters are zero-padded to a multiple of ``loop``, the
    padding taking the mask's first row.  Host-side numpy, bit-equal to
    ``repro.kernels.ops.pack_cavity_weights``."""
    F_, C, K = w.shape
    Fp = ((F_ + loop - 1) // loop) * loop
    if Fp != F_:
        w = np.concatenate([w, np.zeros((Fp - F_, C, K), w.dtype)], 0)
        tap_mask = np.concatenate(
            [tap_mask, np.tile(tap_mask[:1], (Fp - F_, 1))], 0)
    Fg = Fp // loop
    n_keep = int(tap_mask[:loop].sum(axis=1).max())
    wp = np.zeros((loop, n_keep, C, Fg), w.dtype)
    taps = np.zeros((loop, n_keep), np.int32)
    for g in range(loop):
        kept = np.flatnonzero(tap_mask[g])
        taps[g, : len(kept)] = kept
        for j, k in enumerate(kept):
            # filters g, g+loop, g+2*loop, ... share this tap set
            wp[g, j] = w[g::loop, :, k].T          # (C, Fg)
    # the kernel output flattens (L, Fg): slot g*Fg+i holds filter g+loop*i
    inv = np.empty(Fp, np.int32)
    order = np.arange(Fp).reshape(Fg, loop).T.reshape(-1)
    inv[order] = np.arange(Fp)
    return wp, taps, inv


def cavity_tconv(
    x: torch.Tensor,          # (N, T, V, C), or (B, T, C): its V = 1 view
    wp: torch.Tensor,
    taps: torch.Tensor,
    inv_perm: torch.Tensor,
    num_filters: int,
    kernel_size: int = 9,
    stride: int = 1,
) -> torch.Tensor:
    """Cavity-pruned temporal conv, 'same' padding.  Returns
    (N, T_out, V, F), or (B, T_out, F) for a 3-D input, in natural filter
    order.

    T_out follows conv semantics, ``(T + 2·pad − K)//stride + 1``.  The
    kernel reads x where it lies (no transposed or padded copy: the
    padding is its bound check) and writes natural filter order through
    ``inv_perm``."""
    x4 = x.unsqueeze(2) if x.dim() == 3 else x
    out = _ct.cavity_tconv_cuda(x4.contiguous(), wp, taps, inv_perm,
                                num_filters, kernel_size=kernel_size,
                                stride=stride)
    return out.squeeze(2) if x.dim() == 3 else out


def slot_columns(inv_perm: np.ndarray, num_filters: int,
                 columns: np.ndarray = None) -> np.ndarray:
    """The streaming kernel's store map, (L·Fg,) int32: packed slot
    ``inv_perm[f]`` of natural filter f < ``num_filters`` goes to output
    column ``columns[f]`` (default f: the kept-filter scatter when given);
    padding slots and filters past ``num_filters`` go nowhere (−1)."""
    inv_perm = np.asarray(inv_perm)
    col = np.full(inv_perm.shape[0], -1, np.int32)
    col[inv_perm[:num_filters]] = (np.arange(num_filters) if columns is None
                                   else np.asarray(columns)[:num_filters])
    return col


def cavity_tconv_step_ring(
    ring: torch.Tensor,       # (S, K, V, C) per-slot tconv-input ring
    head: torch.Tensor,       # (S,) int32 each slot's oldest frame
    wp: torch.Tensor,
    taps: torch.Tensor,
    slot_col: torch.Tensor,   # (L·Fg,) int32 from :func:`slot_columns`
    bias: torch.Tensor,       # (cout,) per output column
) -> torch.Tensor:
    """Single-step cavity tconv of the streaming engine, read from the
    ring in place.  Returns (S, V, cout): each kept filter at its column
    with its bias, the other columns 0.

    No padding (the ring holds K frames; its zeros stand in for the clip's
    'same' padding) and no stride (emission gating lives in the engine).
    Same packed weights and tap sets as :func:`cavity_tconv`."""
    return _ct.cavity_tconv_step_ring_cuda(ring.contiguous(), head, wp, taps,
                                           slot_col, bias)


def cavity_tconv_step(
    x: torch.Tensor,          # (B, K, C) chronological window, oldest first
    wp: torch.Tensor,
    taps: torch.Tensor,
    inv_perm: torch.Tensor,
    num_filters: int,
) -> torch.Tensor:
    """Single-step cavity tconv over chronological windows.  Returns
    (B, F) in natural filter order: :func:`cavity_tconv_step_ring` on the
    windows as a ring of B slots of one joint, each head at 0."""
    B, K, C = x.shape
    L, _, _, Fg = wp.shape
    dev = x.device
    slot_col = torch.full((L * Fg,), -1, dtype=torch.int32, device=dev)
    slot_col[inv_perm[:num_filters]] = torch.arange(
        num_filters, dtype=torch.int32, device=dev)
    out = cavity_tconv_step_ring(
        x.reshape(B, K, 1, C), torch.zeros(B, dtype=torch.int32, device=dev),
        wp.contiguous(), taps, slot_col,
        torch.zeros(num_filters, dtype=x.dtype, device=dev))
    return out.reshape(B, num_filters)


# ---------------------------------------------------------------------------
# Windowed similarity (streaming C_k)
# ---------------------------------------------------------------------------

def windowed_similarity(
    ring_th: torch.Tensor,    # (S, K, V, Ce) per-slot θ-embedding ring
    ring_ph: torch.Tensor,    # (S, K, V, Ce) per-slot φ-embedding ring
    valid_joints: int = 0,
) -> torch.Tensor:
    """Streaming windowed C_k from the embedding rings: (S, V, V).  Input-
    joint columns >= ``valid_joints`` are masked; 0 or >= V means every
    column is live.  The kernel needs no joint padding."""
    V = ring_th.shape[2]
    valid = valid_joints if 0 < valid_joints < V else V
    return _ws.windowed_similarity_cuda(ring_th.contiguous(),
                                        ring_ph.contiguous(), int(valid))


# ---------------------------------------------------------------------------
# Fused graph + spatial conv
# ---------------------------------------------------------------------------

def _topology_note(topology: str) -> str:
    return f" for topology {topology!r}" if topology else ""


def graph_sconv(
    x: torch.Tensor,          # (N, T, V, Cin) — kept channels already gathered
    g: torch.Tensor,          # (K, V', V'), V' >= V
    w: torch.Tensor,          # (K, Cin, Cout)
    topology: str = "",
) -> torch.Tensor:
    """Fused Σ_k (G_k·x)·W_k.  Returns (N, T, V, Cout).  The rows are the
    flattened N·T axis; the kernel needs no joint or row padding.  A graph
    wider than x's joints (a plan padded to a slab Vmax, run on a clip at
    the skeleton's own V) is sliced: it is zero outside its valid joints.
    ``topology`` names the skeleton in the shape errors."""
    N, T, V, Cin = x.shape
    note = _topology_note(topology)
    if g.shape[0] != w.shape[0]:
        raise ValueError(
            f"graph has K={g.shape[0]} subsets but w has K={w.shape[0]}"
            f"{note}; the plan packed weights against a different topology")
    if g.shape[-1] < V:
        raise ValueError(f"graph{note} is {g.shape[-1]} joints wide, "
                         f"expected >= {V} (x runs {V} joints)")
    if g.shape[-1] > V:
        g = g[:, :V, :V]
    xr = x.reshape(N * T, V, Cin).contiguous()
    out = _gs.graph_sconv_cuda(xr, g.contiguous(), w.to(x.dtype).contiguous())
    return out.reshape(N, T, V, -1)


def pack_csr_ell(
    indptr: np.ndarray,      # (K, V+1) int32
    indices: np.ndarray,     # (K, E) int32
    values: np.ndarray,      # (K, E) f32, zero-padded
    vp: int,                 # joint rows of the pack, >= V
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side CSR -> ELL repack for the sparse spatial conv.

    Each output row's neighbour list is padded to the largest row degree
    D (index 0, value 0: a gather of joint 0 scaled by zero) and rows are
    padded to ``vp``.  Returns (idx (K, vp, D) int32, val (K, vp, D) f32),
    bit-equal to ``repro.kernels.ops.pack_csr_ell``."""
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    values = np.asarray(values)
    K, V1 = indptr.shape
    V = V1 - 1
    deg = int(max(1, (indptr[:, 1:] - indptr[:, :-1]).max()))
    idx = np.zeros((K, vp, deg), np.int32)
    val = np.zeros((K, vp, deg), np.float32)
    for k in range(K):
        for r in range(V):
            lo, hi = int(indptr[k, r]), int(indptr[k, r + 1])
            idx[k, r, : hi - lo] = indices[k, lo:hi]
            val[k, r, : hi - lo] = values[k, lo:hi]
    return idx, val


def graph_sconv_csr(
    x: torch.Tensor,          # (N, T, V, Cin) — kept channels already gathered
    idx: torch.Tensor,        # (K, V', D) int32 ELL indices, V' >= V
    val: torch.Tensor,        # (K, V', D) ELL values
    w: torch.Tensor,          # (K, Cin, Cout)
    topology: str = "",
) -> torch.Tensor:
    """Sparse Σ_k (G_k·x)·W_k over an ELL-packed graph.  Returns
    (N, T, V, Cout).  An ELL pack wider than x's joints (a plan padded to
    a slab Vmax) is sliced: its padded rows are empty and its indices only
    reference the skeleton's own joints."""
    N, T, V, Cin = x.shape
    note = _topology_note(topology)
    if idx.shape[0] != w.shape[0]:
        raise ValueError(
            f"ELL graph has K={idx.shape[0]} subsets but w has "
            f"K={w.shape[0]}{note}")
    if idx.shape[1] < V:
        raise ValueError(f"ELL graph{note} packed to {idx.shape[1]} joints, "
                         f"expected >= {V} (x runs {V} joints)")
    xr = x.reshape(N * T, V, Cin).contiguous()
    out = _gs.graph_sconv_csr_cuda(
        xr, idx[:, :V].contiguous(), val[:, :V].to(x.dtype).contiguous(),
        w.to(x.dtype).contiguous())
    return out.reshape(N, T, V, -1)
