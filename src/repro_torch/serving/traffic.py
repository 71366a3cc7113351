"""Realistic traffic modelling + deterministic trace replay for serving.
Port of ``repro.serving.traffic``: the same events, clip bytes and digests
from the same seeds and trace files (numpy only).

The ROADMAP's missing half of SLO-driven autoscaling: controller changes
are only trustworthy when two policies can be A/B'd on **identical**
traffic.  This module provides

* a traffic model richer than the poisson/bursty load generators —
  :class:`TrafficConfig` + :class:`TraceGenerator` compose a diurnal rate
  cycle (thinned non-homogeneous Poisson), correlated flash crowds (an
  accepted arrival seeds a burst of follow-on arrivals within a short
  span) and heavy-tailed session lengths (log-normal or Pareto, the
  measured shape of real stream sessions) — emitted one event at a time
  from an explicit ``numpy.random.Generator`` (no global RNG state, so
  interleaved generators reproduce their solo sequences);
* a serializable trace format — :class:`TraceEvent` rows inside a
  versioned :class:`Trace` envelope with exact JSON round-tripping
  (``replay(serialize(trace))`` is event-for-event identical), checked
  into ``tests/data/traces/`` as the repo's canonical regression loads;
* the replay harness — :func:`replay` feeds a recorded trace
  byte-identically (clip content derives from each event's ``clip_seed``,
  never from generator state) into any
  :class:`~repro_torch.serving.service.GcnService` configuration and returns
  the same metrics row shape as :func:`~repro_torch.serving.service.
  run_sessions`, tagged with the ``policy``/``trace`` merge axes — so
  ``serve sessions --trace FILE --policy {demand,slo}`` benchmarks the
  demand-driven and SLO-driven controllers on the same events, and the
  golden tests lock scheduler-tick-level outcomes per (qos, policy).
"""
from __future__ import annotations

import dataclasses
import hashlib
import heapq
import json
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

TRACE_SCHEMA_VERSION = 1

LENGTH_DISTS = ("lognormal", "pareto", "fixed")


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One recorded session arrival — the unit of a serialized trace.

    ``arrival`` is the scheduler tick the session opens; ``frames`` its
    clip length; ``clip_seed`` the self-contained seed its clip content
    derives from at replay time (``default_rng(clip_seed)`` — byte-
    identical across processes, independent of any generator state);
    ``deadline`` the optional absolute completion-deadline tick (filled
    by the replay driver under ``qos="deadline"`` when None)."""

    sid: int
    arrival: int
    frames: int
    priority: int = 0
    clip_seed: int = 0
    deadline: Optional[int] = None

    def to_json(self) -> Dict:
        """The event as a plain-JSON dict (ints + optional deadline)."""
        d = {"sid": self.sid, "arrival": self.arrival,
             "frames": self.frames, "priority": self.priority,
             "clip_seed": self.clip_seed}
        if self.deadline is not None:
            d["deadline"] = self.deadline
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "TraceEvent":
        """Inverse of :meth:`to_json` (exact round-trip)."""
        return cls(sid=int(d["sid"]), arrival=int(d["arrival"]),
                   frames=int(d["frames"]), priority=int(d["priority"]),
                   clip_seed=int(d["clip_seed"]),
                   deadline=(int(d["deadline"])
                             if d.get("deadline") is not None else None))


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """The traffic model behind :class:`TraceGenerator`.

    Arrival process — a thinned non-homogeneous Poisson with rate
    ``λ(t) = (1/mean_interarrival) · (1 + diurnal_amplitude ·
    sin(2πt/diurnal_period))`` (``diurnal_amplitude=0`` degenerates to
    the plain Poisson process), plus **flash crowds**: each accepted base
    arrival seeds, with probability ``flash_crowd_prob``, a correlated
    burst of ``1 + Geometric(1/flash_crowd_size)`` follow-on arrivals
    uniformly inside the next ``flash_crowd_span`` ticks (the "everyone
    opens the app at once" shape a homogeneous process cannot produce).

    Session lengths — ``length_dist``: ``"lognormal"`` (σ =
    ``length_sigma``, mean = ``mean_frames``), ``"pareto"`` (tail index
    ``pareto_alpha`` > 1, mean = ``mean_frames``) or ``"fixed"``;
    clamped to [``min_frames``, ``max_frames``] (``max_frames=0`` =
    uncapped).  Priorities are a Bernoulli(``high_priority_ratio``)
    high(1)/low(0) mix.  ``seed`` is the default generator seed when no
    explicit ``numpy.random.Generator`` is threaded in."""

    n_sessions: int = 32
    mean_interarrival: float = 8.0
    diurnal_amplitude: float = 0.0
    diurnal_period: float = 200.0
    flash_crowd_prob: float = 0.0
    flash_crowd_size: float = 3.0
    flash_crowd_span: float = 4.0
    length_dist: str = "lognormal"
    mean_frames: float = 16.0
    length_sigma: float = 0.6
    pareto_alpha: float = 2.5
    min_frames: int = 2
    max_frames: int = 0
    high_priority_ratio: float = 0.0
    seed: int = 0

    def __post_init__(self):
        if self.n_sessions < 1:
            raise ValueError(f"n_sessions must be >= 1, got {self.n_sessions}")
        if self.mean_interarrival <= 0:
            raise ValueError("mean_interarrival must be > 0, got "
                             f"{self.mean_interarrival}")
        if not 0.0 <= self.diurnal_amplitude < 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1) (the "
                             f"rate must stay positive), got "
                             f"{self.diurnal_amplitude}")
        if self.diurnal_period <= 0:
            raise ValueError(
                f"diurnal_period must be > 0, got {self.diurnal_period}")
        if not 0.0 <= self.flash_crowd_prob <= 1.0:
            raise ValueError("flash_crowd_prob must be in [0, 1], got "
                             f"{self.flash_crowd_prob}")
        if self.flash_crowd_size < 1.0:
            raise ValueError("flash_crowd_size must be >= 1, got "
                             f"{self.flash_crowd_size}")
        if self.length_dist not in LENGTH_DISTS:
            raise ValueError(f"unknown length_dist {self.length_dist!r} "
                             f"(expected one of {LENGTH_DISTS})")
        if self.length_dist == "pareto" and self.pareto_alpha <= 1.0:
            raise ValueError("pareto_alpha must be > 1 (the mean must be "
                             f"finite), got {self.pareto_alpha}")
        if self.min_frames < 1:
            raise ValueError(f"min_frames must be >= 1, got {self.min_frames}")
        if self.max_frames and self.max_frames < self.min_frames:
            raise ValueError(
                f"max_frames {self.max_frames} < min_frames {self.min_frames}")

    def rate(self, t: float) -> float:
        """The instantaneous arrival rate λ(t) (sessions per tick) — the
        diurnal modulation the generator thins against, exposed so tests
        can integrate it analytically."""
        base = 1.0 / self.mean_interarrival
        return base * (1.0 + self.diurnal_amplitude
                       * math.sin(2.0 * math.pi * t / self.diurnal_period))


class TraceGenerator:
    """Streaming event generator over an explicit RNG — iterate to draw
    :class:`TraceEvent`\\ s one at a time, in arrival order.

    All randomness comes from the single ``numpy.random.Generator`` the
    instance owns (``rng`` argument, else ``default_rng(config.seed)``):
    no module-level or global numpy state is ever touched, so two
    interleaved generators reproduce their solo sequences exactly and
    concurrent benchmark runs cannot cross-contaminate.  The draw order
    per event is part of the determinism contract: the thinned arrival
    draws (and, on acceptance, the crowd-seeding draws) first, then
    length, priority and clip seed at emission."""

    def __init__(self, config: TrafficConfig,
                 rng: Optional[np.random.Generator] = None):
        self.config = config
        self.rng = rng if rng is not None else np.random.default_rng(
            config.seed)
        self._t = 0.0                    # continuous clock of the base process
        self._pending: List[float] = []  # crowd arrivals (min-heap)
        self._next_base: Optional[float] = None
        self._emitted = 0

    def __iter__(self) -> Iterator[TraceEvent]:
        return self

    def _draw_base(self) -> float:
        """Advance the thinned non-homogeneous base process to its next
        accepted arrival; a crowd seeded by the acceptance enqueues its
        follow-on arrivals immediately (one draw block per acceptance)."""
        cfg = self.config
        lam_max = (1.0 + cfg.diurnal_amplitude) / cfg.mean_interarrival
        while True:
            self._t += self.rng.exponential(1.0 / lam_max)
            if self.rng.random() * lam_max <= cfg.rate(self._t):
                break
        t = self._t
        if cfg.flash_crowd_prob > 0 and self.rng.random() < cfg.flash_crowd_prob:
            k = 1 + self.rng.geometric(1.0 / cfg.flash_crowd_size)
            for dt in self.rng.uniform(0.0, cfg.flash_crowd_span, size=k):
                heapq.heappush(self._pending, t + float(dt))
        return t

    def _length(self) -> int:
        cfg = self.config
        if cfg.length_dist == "lognormal":
            mu = math.log(cfg.mean_frames) - 0.5 * cfg.length_sigma ** 2
            x = self.rng.lognormal(mu, cfg.length_sigma)
        elif cfg.length_dist == "pareto":
            xm = cfg.mean_frames * (cfg.pareto_alpha - 1.0) / cfg.pareto_alpha
            x = xm * (1.0 + self.rng.pareto(cfg.pareto_alpha))
        else:
            x = cfg.mean_frames
        n = max(cfg.min_frames, int(round(x)))
        if cfg.max_frames:
            n = min(n, cfg.max_frames)
        return n

    def _emit(self, t: float) -> TraceEvent:
        cfg = self.config
        ev = TraceEvent(
            sid=self._emitted, arrival=int(math.floor(t)),
            frames=self._length(),
            priority=int(self.rng.random() < cfg.high_priority_ratio),
            clip_seed=int(self.rng.integers(0, 2 ** 31 - 1)))
        self._emitted += 1
        return ev

    def __next__(self) -> TraceEvent:
        if self._emitted >= self.config.n_sessions:
            raise StopIteration
        if self._next_base is None:
            self._next_base = self._draw_base()
        if self._pending and self._pending[0] <= self._next_base:
            return self._emit(heapq.heappop(self._pending))
        t, self._next_base = self._next_base, None
        return self._emit(t)


@dataclasses.dataclass(frozen=True)
class Trace:
    """A recorded traffic trace: versioned envelope + event rows.

    ``config`` is the generating :class:`TrafficConfig` as a plain dict
    (informational — replay never re-draws from it), ``name`` the merge-
    key label BENCH rows carry.  Serialization is exact: ``Trace.
    from_json(trace.to_json()) == trace`` field-for-field, which is the
    determinism contract golden tests replay against."""

    events: Tuple[TraceEvent, ...]
    name: str = ""
    config: Optional[Dict] = None
    version: int = TRACE_SCHEMA_VERSION

    def to_json(self) -> str:
        """Serialize to a stable, human-diffable JSON document."""
        return json.dumps(
            {"version": self.version, "name": self.name,
             "config": self.config,
             "events": [e.to_json() for e in self.events]},
            indent=1, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        """Parse a serialized trace; rejects unknown schema versions
        loudly (the trace files are regression inputs — silently
        reinterpreting an old schema would unlock the goldens)."""
        d = json.loads(text)
        version = int(d.get("version", -1))
        if version != TRACE_SCHEMA_VERSION:
            raise ValueError(
                f"trace schema version {version} != supported "
                f"{TRACE_SCHEMA_VERSION} — regenerate the trace "
                "or replay it with a matching "
                "repo revision")
        return cls(events=tuple(TraceEvent.from_json(e)
                                for e in d["events"]),
                   name=str(d.get("name", "")), config=d.get("config"),
                   version=version)

    def save(self, path: str) -> None:
        """Write the trace to ``path`` (the checked-in-trace format)."""
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "Trace":
        """Read a trace written by :meth:`save`."""
        with open(path) as f:
            return cls.from_json(f.read())

    def digest(self) -> str:
        """Short content hash of the event rows — the default ``name``
        stand-in so unnamed traces still merge-key distinctly."""
        h = hashlib.sha256(
            json.dumps([e.to_json() for e in self.events],
                       sort_keys=True).encode())
        return h.hexdigest()[:12]


def generate_trace(config: TrafficConfig,
                   rng: Optional[np.random.Generator] = None,
                   name: str = "") -> Trace:
    """Draw a full :class:`Trace` from the traffic model — the batch
    convenience over iterating :class:`TraceGenerator` (same event
    sequence; events arrive sorted by construction)."""
    events = tuple(TraceGenerator(config, rng=rng))
    return Trace(events=events, name=name,
                 config=dataclasses.asdict(config))


def event_clip(event: TraceEvent, joints: int, channels: int) -> np.ndarray:
    """The (frames, V, C) clip content a trace event replays with:
    standard-normal skeleton frames from the event's own ``clip_seed`` —
    a fresh ``default_rng`` per event, so replay is byte-identical across
    processes and independent of every other event."""
    rng = np.random.default_rng(event.clip_seed)
    return rng.standard_normal(
        (event.frames, joints, channels)).astype(np.float32)


def trace_requests(trace: Trace, joints: int, channels: int) -> List:
    """Materialize a trace into scheduler :class:`~repro_torch.serving.
    scheduler.SessionRequest`\\ s (clip content via :func:`event_clip`) —
    the bridge from recorded events to the live-session drivers."""
    from repro_torch.serving.scheduler import SessionRequest
    return [SessionRequest(sid=e.sid, arrival=e.arrival,
                           clip=event_clip(e, joints, channels),
                           priority=e.priority, deadline=e.deadline)
            for e in trace.events]


# ---------------------------------------------------------------------------
# the replay harness
# ---------------------------------------------------------------------------

def replay(
    cfg,
    trace: Trace,
    *,
    backend: str = "cuda",
    qos: str = "fifo",
    policy: str = "demand",
    capacity_tiers: Sequence[int] = (4,),
    slo_config=None,
    deadline_slack: int = 25,
    quant: bool = True,
    seed: int = 0,
    fused: bool = True,
    record_outcomes: bool = False,
    max_ticks: int = 100_000,
    plans=None,
    bn_stats=None,
    saliency_thresh: float = 0.0,
    device=None,
) -> Dict:
    """Replay a recorded trace through one
    :class:`~repro_torch.serving.service.GcnService` configuration and
    return its metrics row.

    The standing A/B rig for controller and scheduler changes: every
    knob of the service (backend, qos, ``policy={demand,slo}``, tiers)
    varies while the *traffic* — arrival ticks, clip lengths, priorities
    and clip bytes — is pinned by the trace, so two configurations are
    benchmarked on identical events and replaying the same trace twice
    yields identical scheduler-tick outcomes (locked by the golden
    tests).  The returned row carries the ``policy``/``load="trace"``/
    ``trace=<name>`` merge axes for ``BENCH_sessions.json``, plus the
    per-tick ``outcomes`` log when ``record_outcomes`` is set (the
    golden-lock shape; stripped from BENCH rows like ``records``).

    Sessions a shedding SLO controller *rejects* never enter the
    scheduler; their clips are dropped and they count under
    ``shed_rejected`` — the queue-forever alternative is exactly what the
    policy exists to avoid.  Under ``qos="deadline"``, events without an
    explicit deadline get arrival + minimal service time +
    ``deadline_slack`` (same rule as :func:`~repro_torch.serving.service.
    run_sessions`).  ``saliency_thresh`` > 0 replays through a
    :class:`~repro_torch.serving.saliency.SaliencyGate` — the gate is
    deterministic over the trace's pinned clip bytes, so gated replays
    golden-lock exactly like ungated ones (tests/data/traces/
    golden_saliency.json).  ``device`` is the service's (None: CUDA)."""
    from collections import deque

    from repro_torch.serving.service import GcnService

    svc = GcnService(cfg, backend=backend, qos=qos, policy=policy,
                     capacity_tiers=tuple(capacity_tiers), quant=quant,
                     seed=seed, fused=fused, slo_config=slo_config,
                     plans=plans, bn_stats=bn_stats,
                     record_outcomes=record_outcomes,
                     saliency_thresh=saliency_thresh, device=device)
    reqs = trace_requests(trace, cfg.gcn_joints, cfg.gcn_in_channels)
    if qos == "deadline":
        for r in reqs:
            if r.deadline is None:
                r.deadline = (r.arrival + len(r.clip)
                              + svc.flush_frames(len(r.clip))
                              + deadline_slack)
    pending = deque(sorted(reqs, key=lambda r: (r.arrival, r.sid)))
    while svc.now < max_ticks:
        while pending and pending[0].arrival <= svc.now:
            r = pending.popleft()
            h = svc.open_session(priority=r.priority, deadline=r.deadline,
                                 arrival=r.arrival)
            if svc.poll(h).state != "rejected":
                svc.submit_clip(h, r.clip)
        if svc.idle():
            if not pending:
                break
            svc.advance_clock(pending[0].arrival)
            continue
        svc.tick()
    out = svc.metrics()
    out["load"] = "trace"
    out["trace"] = trace.name or trace.digest()
    if record_outcomes:
        out["outcomes"] = svc.outcomes
    return out


def outcome_digest(outcomes: List[Dict]) -> str:
    """Stable hash of a replay's per-tick outcome log — the compact form
    the determinism lock compares (full logs live in the goldens)."""
    return hashlib.sha256(
        json.dumps(outcomes, sort_keys=True).encode()).hexdigest()
