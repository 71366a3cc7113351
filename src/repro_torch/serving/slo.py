"""SLO-driven capacity control + admission shedding for the session slab.
Port of ``repro.serving.slo`` (the same decisions on the same inputs).

The paper's accelerator holds throughput under a *fixed hardware budget*;
this module is the serving analogue of that discipline.  The demand-driven
:class:`~repro_torch.serving.capacity.CapacityManager` grows whenever raw
demand (busy + queued) exceeds the tier — which can leave a p99 latency
SLO blown while occupancy looks healthy (queued sessions are "demand"
whether or not anyone is still waiting within budget), and keeps queueing
forever once even the top tier is saturated.  :class:`SloController` instead closes the
loop on the *measured* service-level objective:

  grow    — the p99 admission-to-first-logit latency (tick-denominated,
            over a sliding window of completed latches, plus the age of
            the oldest queued session — a session that has already waited
            past the bound has breached it even though it never latched)
            exceeds ``target_p99_ticks`` for ``breach_patience``
            consecutive ticks → hop one tier up the ladder.
  shed    — the breach persists at the **top** tier → enter shedding:
            new low-priority opens are *rejected* or *degraded*
            (``shed_mode``) until the SLO recovers, so the protected
            class's latency bound survives overload instead of every
            class queueing forever.
  degrade — the principled shed (PAPERS.md 2010.12221's
            temporal-attention frame skip): a degraded session is served
            at ``degrade_stride``-decimated fidelity — the scheduler
            feeds every stride-th frame through the existing per-slot
            hold/input-skip path, so the session finishes in ~1/stride
            the ticks and the slab serves more sessions at lower
            fidelity instead of turning them away.
  shrink  — demand fits the next smaller tier *and* the measured p99 sits
            under ``shrink_margin × target`` for ``recover_patience``
            consecutive ticks → step one tier down (SLO-safe shrink: a
            healthy latency trend is required, not just low occupancy).

Pure host logic (numpy-free, device-free) mirroring the
:class:`CapacityManager` interface — ``observe(busy, queued, tick)`` →
optional resize target — so :class:`~repro_torch.serving.service.GcnService`
swaps controllers behind one ``policy={demand,slo}`` knob and the
trace-replay harness (:mod:`repro_torch.serving.traffic`) can A/B both on
identical traffic."""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, List, Optional, Tuple

from repro_torch.serving.capacity import ResizeEvent

CONTROL_POLICIES = ("demand", "slo")

SHED_MODES = ("reject", "degrade")


@dataclasses.dataclass(frozen=True)
class SloConfig:
    """Knobs for :class:`SloController`.

    ``target_p99_ticks`` is the SLO itself: the p99 admission-to-first-
    logit latency bound, denominated in scheduler ticks (arrival →
    first-logit latch) so A/B comparisons are deterministic, not wall
    noise.  ``window`` bounds the sliding sample window; ``breach_patience``
    / ``recover_patience`` are the consecutive-tick thresholds before a
    grow/shed (resp. un-shed/shrink) fires; ``cooldown`` freezes decisions
    after any resize (same no-thrash discipline as
    :class:`~repro_torch.serving.capacity.CapacityConfig`).
    ``protect_priority``
    marks the protected classes (priority ≥ it is never shed);
    ``shed_mode`` picks what happens to unprotected opens while shedding
    (``"reject"`` turns them away, ``"degrade"`` serves them at
    ``degrade_stride``-decimated fidelity); ``shrink_margin`` is the
    fraction of the target the measured p99 must sit under before a
    shrink is considered SLO-safe.

    ``degrade_stride_max`` > 0 makes the degrade stride *adapt to breach
    depth*: each additional ``breach_patience``-long breach streak while
    already shedding doubles the stride applied to newly degraded opens
    (``degrade_stride · 2^(depth−1)``, capped at the max), so a deepening
    overload sheds harder instead of queueing at a fidelity that already
    proved insufficient.  0 (the default) keeps the legacy fixed
    stride."""

    target_p99_ticks: int = 50
    window: int = 64
    breach_patience: int = 2
    recover_patience: int = 8
    cooldown: int = 4
    protect_priority: int = 1
    shed_mode: str = "degrade"
    degrade_stride: int = 2
    shrink_margin: float = 0.5
    degrade_stride_max: int = 0

    def __post_init__(self):
        if self.target_p99_ticks < 1:
            raise ValueError(
                f"target_p99_ticks must be >= 1, got {self.target_p99_ticks}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.shed_mode not in SHED_MODES:
            raise ValueError(f"unknown shed_mode {self.shed_mode!r} "
                             f"(expected one of {SHED_MODES})")
        if self.degrade_stride < 2:
            raise ValueError("degrade_stride must be >= 2 (1 would make "
                             f"degrade a no-op), got {self.degrade_stride}")
        if self.degrade_stride_max != 0 and \
                self.degrade_stride_max < self.degrade_stride:
            raise ValueError(
                "degrade_stride_max must be 0 (fixed stride) or >= "
                f"degrade_stride ({self.degrade_stride}), got "
                f"{self.degrade_stride_max}")
        if self.cooldown < 3:
            raise ValueError("cooldown must be >= 3 ticks (the no-thrash "
                             "hysteresis guarantee)")
        if not 0.0 < self.shrink_margin <= 1.0:
            raise ValueError(
                f"shrink_margin must be in (0, 1], got {self.shrink_margin}")


def _p99(samples: List[int]) -> float:
    """Tick-denominated p99 by rank (nearest-rank percentile over ints —
    numpy-free so the controller unit-tests without it)."""
    xs = sorted(samples)
    return float(xs[min(len(xs) - 1, (len(xs) * 99 + 99) // 100 - 1)])


class SloController:
    """SLO-closed-loop capacity + admission control over a tier ladder.

    Drop-in for :class:`~repro_torch.serving.capacity.CapacityManager` on the
    resize side (:meth:`observe` returns an optional target capacity, the
    caller migrates) plus two SLO-specific surfaces the service wires in:
    :meth:`record_first_logit` feeds each session's tick-denominated
    admission-to-first-logit latency as it latches, and :meth:`admit`
    gates every ``open_session`` — returning ``"accept"``, ``"reject"``
    or ``"degrade"`` — which is the admission-control half the demand
    policy doesn't have."""

    def __init__(self, config: SloConfig = SloConfig(),
                 tiers: Tuple[int, ...] = (8,),
                 start_tier: Optional[int] = None,
                 latency_floor: int = 0):
        self.config = config
        # the pipeline's intrinsic first-logit latency in ticks (the
        # engine's stream_first_logit_delay): a session that has queued
        # for w ticks cannot latch before w + floor, so the controller
        # anticipates the breach ``floor`` ticks before it is measurable
        # — latency is a trailing signal; this is the leading correction
        self.latency_floor = int(latency_floor)
        self.tiers: Tuple[int, ...] = tuple(sorted(tiers))
        if not self.tiers or any(t <= 0 for t in self.tiers):
            raise ValueError(f"invalid capacity tiers {tiers!r}")
        if start_tier is None:
            self._idx = 0
        else:
            if start_tier not in self.tiers:
                raise ValueError(
                    f"start_tier {start_tier} not in tiers {self.tiers}")
            self._idx = self.tiers.index(start_tier)
        # sliding window of (priority, first-logit ticks) latch samples
        self._samples: Deque[Tuple[int, int]] = deque(maxlen=config.window)
        self._breach = 0
        self._recover = 0
        self._cooldown_until = -1
        self.shedding = False
        # breach depth while shedding: 1 when shedding switches on, +1 per
        # further breach_patience-long streak that fires with shedding
        # already active, 0 when it switches off — the severity signal
        # behind degrade_stride_now()
        self.shed_depth = 0
        self.events: List[ResizeEvent] = []     # committed resizes
        self.shed_rejected = 0                  # opens turned away
        self.shed_degraded = 0                  # opens served at stride
        self.shed_windows = 0                   # times shedding switched on

    @property
    def capacity(self) -> int:
        """The current tier's slot capacity."""
        return self.tiers[self._idx]

    def record_first_logit(self, priority: int, ticks: int) -> None:
        """Feed one latched admission-to-first-logit latency (in scheduler
        ticks, arrival → latch) into the sliding window — the measurement
        the whole control loop closes on."""
        self._samples.append((int(priority), int(ticks)))

    def measured_p99(self, *, protected_only: bool = True) -> Optional[float]:
        """The window's p99 first-logit latency in ticks; with
        ``protected_only`` restricted to the protected classes (priority ≥
        ``protect_priority``), falling back to all classes when no
        protected sample exists yet.  None while the window is empty."""
        if not self._samples:
            return None
        if protected_only:
            prot = [t for p, t in self._samples
                    if p >= self.config.protect_priority]
            if prot:
                return _p99(prot)
        return _p99([t for _, t in self._samples])

    def breached(self, queue_age: int = 0, inflight_age: int = 0) -> bool:
        """True when the SLO trend is currently blown: the measured p99
        exceeds the target, or the oldest queued session is already
        *committed* to breaching — it has waited ``queue_age`` ticks and
        cannot latch sooner than ``queue_age + latency_floor``, so
        waiting for the latch would let an unserved queue look healthy
        for a whole pipeline delay longer.

        ``inflight_age`` closes the other half of that blind spot: the
        worst *committed* first-logit latency among sessions already
        admitted to a slot but not yet latched (admission tick + pipeline
        delay − arrival).  Those sessions appear in neither the sample
        window (no latch yet) nor the queue (already admitted), so
        without this term a recovery streak could un-shed while the slab
        is still full of sessions guaranteed to breach when they latch."""
        if queue_age + self.latency_floor > self.config.target_p99_ticks:
            return True
        if inflight_age > self.config.target_p99_ticks:
            return True
        p99 = self.measured_p99()
        return p99 is not None and p99 > self.config.target_p99_ticks

    def admit(self, priority: int) -> str:
        """Admission-control verdict for one ``open_session``:
        ``"accept"``, or — while shedding and the session is below the
        protected class — the configured ``shed_mode`` (``"reject"`` /
        ``"degrade"``).  Counts every shed decision."""
        if not self.shedding or priority >= self.config.protect_priority:
            return "accept"
        if self.config.shed_mode == "reject":
            self.shed_rejected += 1
            return "reject"
        self.shed_degraded += 1
        return "degrade"

    def degrade_stride_now(self) -> int:
        """The frame-skip stride for a session degraded *right now*: the
        configured ``degrade_stride`` doubled per breach-depth level past
        the first (``stride · 2^(depth−1)``) and capped at
        ``degrade_stride_max`` — identical to the fixed stride when the
        max is 0 (the legacy default) or shedding just switched on.
        Already-admitted sessions keep the stride they were admitted at;
        only new degrade verdicts see the deepened stride."""
        cfg = self.config
        if cfg.degrade_stride_max <= 0 or self.shed_depth <= 1:
            return cfg.degrade_stride
        return min(cfg.degrade_stride_max,
                   cfg.degrade_stride * (2 ** (self.shed_depth - 1)))

    def idle_reset(self) -> None:
        """Forget the latency window and stop shedding — called when the
        service fast-forwards an *idle* gap: every session has drained, so
        the windowed samples describe a traffic regime that no longer
        exists and would otherwise pin the controller in breach/shedding
        forever (the window only ages out by new samples, not by time)."""
        self._samples.clear()
        self._breach = self._recover = 0
        self.shedding = False
        self.shed_depth = 0

    def observe(self, busy: int, queued: int, tick: int,
                queue_age: int = 0, inflight_age: int = 0) -> Optional[int]:
        """One tick's control decision → an optional resize target (slots).

        Same contract as :meth:`CapacityManager.observe` (call once per
        tick before admissions; the caller executes any returned resize),
        plus ``queue_age`` — the oldest queued session's wait in ticks —
        and ``inflight_age`` — the worst committed latency among admitted-
        but-unlatched sessions — as the leading-edge breach signals.
        Shedding toggles happen here too: a persistent breach at the top
        tier turns shedding on, a persistent recovery turns it off (and
        may shrink)."""
        if tick < self._cooldown_until:
            return None
        cfg = self.config
        if self.breached(queue_age, inflight_age):
            self._breach += 1
            self._recover = 0
        else:
            self._recover += 1
            self._breach = 0
        if self._breach >= cfg.breach_patience:
            self._breach = 0
            if self._idx < len(self.tiers) - 1:
                return self._commit(self._idx + 1, busy, queued, tick)
            if not self.shedding:
                self.shedding = True
                self.shed_windows += 1
                self.shed_depth = 1
            else:
                # breach persisted through another whole patience streak
                # while already shedding: the overload is deepening —
                # escalate the degrade stride for newly shed opens
                self.shed_depth += 1
            return None
        if self._recover >= cfg.recover_patience:
            self._recover = 0
            if self.shedding:
                # recover in two steps: stop shedding first, then (next
                # recovery window) consider shrinking — never both at once
                self.shedding = False
                self.shed_depth = 0
                return None
            p99 = self.measured_p99()
            demand = busy + queued
            if (self._idx > 0
                    and demand <= self.tiers[self._idx - 1]
                    and (p99 is None
                         or p99 <= cfg.shrink_margin * cfg.target_p99_ticks)):
                return self._commit(self._idx - 1, busy, queued, tick)
        return None

    def _commit(self, idx: int, busy: int, queued: int, tick: int) -> int:
        """Commit a resize to tier ``idx``: log the event, reset pressure
        counters, start the cooldown window."""
        self.events.append(ResizeEvent(
            tick=tick, old=self.capacity, new=self.tiers[idx],
            busy=busy, queued=queued))
        self._idx = idx
        self._breach = self._recover = 0
        self._cooldown_until = tick + self.config.cooldown
        return self.capacity
