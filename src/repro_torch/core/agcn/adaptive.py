"""Windowed data-dependent C_k graphs: the adaptive-streaming form of the
paper's C_k (eq. (1)).  Port of ``repro.core.agcn.adaptive``.

Eq. (1) pools embeddings over the whole clip, which a live stream does not
have.  Here C_k is a trailing-window statistic over the K frames the
block's temporal ring already spans:

    Θ(t) = Σ_{u=t−K+1..t} θ(x_u)          (zeros before the stream starts)
    Φ(t) = Σ_{u=t−K+1..t} φ(x_u)
    C(t) = softmax(Θ(t)·Φ(t)ᵀ / √Ce)      (per output joint, over inputs)

Clip mode evaluates the recurrence at every frame index
(:func:`clip_windowed_ck`); streaming evaluates it from the (S, K, V, Ce)
embedding rings (:func:`windowed_ck` on the ring sums, or the kernel
``repro_torch.kernels.ops.windowed_similarity``), so post-drain stream
logits equal clip logits with C_k on.  Joints of a slab-padded plan are
masked out of the softmax columns.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

__all__ = ["windowed_ck", "clip_windowed_ck"]


def windowed_ck(win_th: torch.Tensor, win_ph: torch.Tensor,
                valid_joints: int = 0) -> torch.Tensor:
    """C = softmax(Θ·Φᵀ/√Ce) from window-summed embeddings (..., V, Ce).

    ``valid_joints`` > 0 sets the input-joint columns >= it to -1e30
    before the softmax, so the rows of a slab-padded plan do not pool from
    its padded joints; rows past it are returned as computed.  Returns the
    (..., V, V) graph added to every subset's ``A_k + B_k``."""
    ce = win_th.shape[-1]
    logits = torch.einsum("...ve,...we->...vw", win_th, win_ph) / math.sqrt(ce)
    V = logits.shape[-1]
    if 0 < valid_joints < V:
        dead = torch.arange(V, device=logits.device) >= valid_joints
        logits = torch.where(dead, torch.tensor(-1e30, dtype=logits.dtype,
                                                device=logits.device), logits)
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _trailing_window_sum(e: torch.Tensor, k: int) -> torch.Tensor:
    """Trailing-K window sums of (N, T, V, Ce) embeddings over T, zeros
    before frame 0: the streaming ring's content at each block clock, as
    K−1 shifted adds (no (T, K) window tensor)."""
    out = e
    T = e.shape[1]
    for d in range(1, k):
        out = out + F.pad(e, (0, 0, 0, 0, d, 0))[:, :T]
    return out


def clip_windowed_ck(x: torch.Tensor, w_theta: torch.Tensor,
                     w_phi: torch.Tensor, k: int,
                     valid_joints: int = 0) -> torch.Tensor:
    """Per-frame windowed C_k in clip mode: (N, T, V, C) -> (N, T, V, V).

    ``x`` is the block input with the kept channels gathered, ``w_theta``
    and ``w_phi`` the plan's (C_kept, Ce) projections."""
    th = torch.einsum("ntvc,ce->ntve", x, w_theta.to(x.dtype))
    ph = torch.einsum("ntvc,ce->ntve", x, w_phi.to(x.dtype))
    return windowed_ck(_trailing_window_sum(th, k),
                       _trailing_window_sum(ph, k), valid_joints=valid_joints)
