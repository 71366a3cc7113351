"""Temporal-attention saliency gating: skip uninformative frames per slot.
Port of ``repro.serving.saliency`` (the same kept indices, bit for bit).

The adaptive-streaming subsystem's input-side half (the graph-side half is
the windowed C_k in ``repro_torch.core.agcn.adaptive``).  Skeleton streams are
temporally redundant — a subject holding a pose contributes near-identical
frames for ticks on end — and the slab charges one tick per fed frame
regardless.  Following the temporal-attention frame selection of PAPERS.md
2010.12221 (and the paper's own input-skip C5 optimization, which zero-
suppresses *joints*; this gate suppresses whole *frames*), each incoming
frame is scored against the session's recent motion history and marked
*uninformative* when its attention ratio falls under a threshold:

    m_t = ||f_t − f_{t−1}||₂                 (raw inter-frame motion)
    α_t = m_t / (mean(m_1..m_t−1) + ε)        (attention vs. running mean)
    keep ⇔ t = 0  ∨  α_t ≥ threshold  ∨  consecutive skips = max cap

The consecutive-skip cap bounds the worst-case information loss (a long
freeze still samples every ``max_consecutive_skips + 1``-th frame), and
frame 0 is always kept so every session produces a logit.  Skipped frames
are never fed: the scheduler serves the *kept* subsequence — composing
with the SLO controller's degrade stride, which further decimates the kept
list — and starves (→ the engine's per-slot ``hold`` mask) when an open
stream's fresh frames were all skipped.  The session finishes in
~``kept/raw`` of the ticks, so the same slab serves proportionally more
sessions.

Everything here is deterministic host-side numpy — no RNG, no device — and
the scorer state plus the kept-index list live **on the request**
(``req.sal_kept`` / ``req.sal_state``), so they ride preemption re-queues
and cross-replica ``export_session``/``import_session`` unchanged: a
migrated session skips exactly the frames it would have skipped in place
(bit-identity locked in the tests).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

__all__ = ["SaliencyConfig", "SaliencyGate"]


@dataclasses.dataclass(frozen=True)
class SaliencyConfig:
    """Knobs for :class:`SaliencyGate`.

    ``threshold`` is the attention-ratio keep bound (α_t ≥ it keeps the
    frame; ≤ 0 is rejected — use no gate at all to disable saliency, so a
    configured gate always means the feature is on).
    ``max_consecutive_skips`` caps how many frames in a row may be
    dropped; ``eps`` regularizes the running-mean denominator (also what
    keeps the first motion sample, scored against an empty history)."""

    threshold: float = 1.0
    max_consecutive_skips: int = 3
    eps: float = 1e-6

    def __post_init__(self):
        if self.threshold <= 0.0:
            raise ValueError(
                f"threshold must be > 0, got {self.threshold} (omit the "
                "gate entirely to disable saliency)")
        if self.max_consecutive_skips < 1:
            raise ValueError("max_consecutive_skips must be >= 1, got "
                             f"{self.max_consecutive_skips}")
        if self.eps <= 0.0:
            raise ValueError(f"eps must be > 0, got {self.eps}")


@dataclasses.dataclass
class _ScorerState:
    """Per-session incremental scorer state (rides on the request)."""

    scored: int = 0                      # raw frames scored so far
    prev: Optional[np.ndarray] = None    # flattened previous frame
    mean: float = 0.0                    # causal running mean of motion
    nm: int = 0                          # motion samples folded into mean
    consec: int = 0                      # current consecutive-skip streak


class SaliencyGate:
    """Incremental per-session frame scorer feeding the scheduler.

    One gate serves every session (it is stateless across sessions); the
    per-session state lives on the :class:`SessionRequest` itself.
    :meth:`extend` scores any raw frames that arrived since the last call
    and appends the kept raw indices to ``req.sal_kept`` — the scheduler
    then feeds ``sal_kept[rel * degrade_stride]`` instead of
    ``rel * degrade_stride``, so saliency and SLO degrade compose."""

    def __init__(self, config: SaliencyConfig):
        self.config = config
        self.frames_scored = 0           # lifetime, across sessions
        self.frames_skipped = 0

    def extend(self, req) -> None:
        """Score ``req``'s unscored raw frames, growing ``req.sal_kept``.

        Idempotent per frame (each raw index is scored exactly once, in
        order) and safe to call every tick on open sessions — new frames
        pushed between calls are scored on the next call.  Must run before
        the session's frame payload is released."""
        st: Optional[_ScorerState] = getattr(req, "sal_state", None)
        if st is None:
            st = _ScorerState()
            req.sal_state = st
            req.sal_kept: List[int] = []
        cfg = self.config
        n = req.n_frames()
        while st.scored < n:
            t = st.scored
            f = np.asarray(req.frame(t), np.float32).ravel()
            if t == 0:
                keep = True              # first frame anchors the stream
            else:
                m = float(np.linalg.norm(f - st.prev))
                alpha = m / (st.mean + cfg.eps)
                st.nm += 1
                st.mean += (m - st.mean) / st.nm
                keep = (alpha >= cfg.threshold
                        or st.consec >= cfg.max_consecutive_skips)
            if keep:
                req.sal_kept.append(t)
                st.consec = 0
            else:
                st.consec += 1
                self.frames_skipped += 1
            st.prev = f
            st.scored = t + 1
            self.frames_scored += 1
