"""Session-slab scheduling internals behind the :class:`GcnService` facade.
Port of ``repro.serving.scheduler``: the same tick plans on the same
inputs, numpy only.

This module is the host-side half of multi-session stream serving.  The
streaming engine serves *one* lockstep batch of streams; live
traffic is many independent skeleton sessions arriving and ending at
different times — the continual-inference regime of CoST-GCN (Hedegaard et
al., 2022) at the throughput target of the ROADMAP:

  device  — a fixed-capacity **session slab**: one ``engine.StreamState``
            whose leading axis is S slots, advanced by one
            ``engine.step_frames(plan, slab, frames[S], valid[S],
            reset[S], hold[S])`` per tick (the same kernels at any
            occupancy).  Preemption is the engine's ``snapshot_slots``
            (one gather over every per-slot leaf) and resume is
            ``restore_slots`` (the inverse scatter).
  host    — :class:`SlabScheduler`: a slot table + priority admission
            queue (:class:`AdmissionQueue`, strict (priority, arrival)
            order) with a pluggable QoS policy:

              fifo     — run-to-completion (the default; with uniform
                         priorities this is exactly FIFO admission).
              preempt  — a queued strictly-higher-priority session may
                         snapshot-evict the lowest-priority active slot;
                         the victim re-queues (keeping its progress and
                         device snapshot) and later restores into a free
                         slot and resumes.
              deadline — sessions whose completion deadline has passed
                         are dropped from the queue or evicted from their
                         slot and counted as ``missed``.

Sessions come in two flavors sharing one code path: **closed** sessions
arrive with their whole clip (``SessionRequest(clip=...)`` — the batch
load-generator path), while **open** sessions (the ``GcnService``
open/submit/poll/close path) grow a frame buffer incrementally and are
*held* — per-slot frozen in place via the engine's ``hold`` mask, not
zero-padded — whenever the buffer is empty but the stream has not been
closed.

The scheduler is pure host bookkeeping (numpy in, numpy out) so it unit-
tests without a device — device snapshots never enter it; :meth:`tick_inputs`
returns a :class:`TickPlan` naming which slots to snapshot/restore and the
driver (:class:`repro_torch.serving.GcnService`) holds the captures.
"""
from __future__ import annotations

import dataclasses
import heapq
import json
import os
import warnings
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

DEFAULT_BENCH_PATH = "BENCH_torch_sessions.json"

QOS_POLICIES = ("fifo", "preempt", "deadline")

# sentinel (slot, ring row) value padding the fixed-shape event-order
# buffers consumed by the fused serving tick — must equal
# ``repro_torch.core.agcn.engine.SNAP_SENTINEL`` (redefined here as a plain
# int so this module imports no torch; equality is locked in tests)
SNAP_SENTINEL = 2 ** 30

# per-tick snapshot/restore event budget cap: the fused tick's order
# buffers are padded to a *static* ``max_events_for(slots)`` rows, so
# every sentinel row costs one (dropped) gather/scatter per leaf per tick
# — capping keeps that overhead bounded at large slot counts while the
# scheduler defers surplus preemptions/restores to later ticks
MAX_EVENTS_PER_TICK = 8


def max_events_for(slots: int) -> int:
    """The static per-tick snapshot/restore event-buffer width for a
    ``slots``-slot tier: ``min(slots, max(MAX_EVENTS_PER_TICK,
    slots // 8))``.  One tick can structurally produce at most ``slots``
    events of either kind (each slot is evicted/admitted at most once per
    tick); the floor bounds the padded no-op gather/scatter cost at small
    tiers, while the ``slots // 8`` term scales the budget with capacity
    so a big slab's preemption throughput isn't starved at 8 events/tick
    (at S=256 a fixed budget would need 32 ticks to turn the slab over)."""
    slots = int(slots)
    return min(slots, max(MAX_EVENTS_PER_TICK, slots // 8))


def pad_event_orders(events: Sequence[Tuple[int, int]],
                     max_events: int) -> np.ndarray:
    """Pad a list of (slot, ring row) events to the fixed-shape
    ``(max_events, 2)`` int32 order buffer the fused tick consumes, with
    :data:`SNAP_SENTINEL` no-op rows — any event count from 0 to
    ``max_events`` reuses one compilation per tier.  Raises when the
    events overflow the static buffer (the scheduler's own budgets make
    that structurally impossible; direct callers must size ahead)."""
    if len(events) > max_events:
        raise ValueError(
            f"{len(events)} snapshot/restore events overflow the static "
            f"max_events={max_events} order buffer — the fused tick's "
            "shapes are compiled per tier and cannot grow at traffic time")
    out = np.full((max_events, 2), SNAP_SENTINEL, np.int32)
    for i, (slot, row) in enumerate(events):
        out[i] = (slot, row)
    return out


# ---------------------------------------------------------------------------
# load generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SessionRequest:
    """One incoming stream session.

    Two construction modes share this type:

    * **closed** — ``clip`` is the whole (T, V, C) skeleton clip up front
      (the load-generator path); the session's service time is known at
      admission.
    * **open** — ``clip=None``; frames arrive incrementally via
      :meth:`push_frame` and the stream ends with :meth:`close` (the
      ``GcnService.submit``/``close`` path).  Until closed, a starved slot
      is held in place rather than flushed.

    ``priority`` orders admission (larger = more urgent; ties are FIFO by
    arrival) and selects preemption victims under the ``preempt`` policy;
    ``deadline`` is the absolute tick by which the session must *complete*
    under the ``deadline`` policy (None = no deadline).  ``degrade`` is the
    frame-skip stride (1 = full fidelity): a degraded session is served on
    every ``degrade``-th raw frame only — the SLO controller's shed-by-
    fidelity mode — so it occupies its slot for ~1/stride the ticks.

    When the scheduler runs a
    :class:`~repro_torch.serving.saliency.SaliencyGate`
    the gate attaches ``sal_kept`` (the kept raw-frame indices) and its
    scorer state to this object — request attributes, so they ride
    preemption re-queues and cross-replica export/import — and the
    degrade stride then decimates the *kept* subsequence."""

    sid: int
    arrival: int             # tick index at which the session arrives
    clip: Optional[np.ndarray] = None   # (T, V, C) raw frames (closed mode)
    priority: int = 0
    deadline: Optional[int] = None
    degrade: int = 1         # frame-skip stride (1 = every frame)
    topology: Optional[str] = None      # skeleton name (None = the
                                        # service's primary topology)

    def __post_init__(self):
        self._buf: List[np.ndarray] = []
        self._closed = self.clip is not None
        self._released: Optional[int] = None

    def push_frame(self, frame: np.ndarray) -> None:
        """Append one (V, C) raw frame to an open session's buffer."""
        if self._closed:
            raise ValueError(f"session {self.sid} is closed")
        self._buf.append(np.asarray(frame, np.float32))

    def close(self) -> None:
        """End an open session's stream: no more frames will arrive, so the
        scheduler can compute the flush-drain budget and finish it."""
        self._closed = True

    def is_closed(self) -> bool:
        """True once the stream has ended (closed clips always are)."""
        return self._closed

    def n_frames(self) -> int:
        """Raw frames available so far (clip length for closed sessions;
        the final count survives :meth:`release_frames`)."""
        if self._released is not None:
            return self._released
        return len(self.clip) if self.clip is not None else len(self._buf)

    def kept_frames(self) -> int:
        """Frames surviving the saliency gate (``len(sal_kept)`` once a
        gate has scored this session; all raw frames otherwise).  The
        count the scheduler's feed clock and service-time budget run on —
        saliency-skipped frames simply don't exist to the slab."""
        kept = getattr(self, "sal_kept", None)
        return len(kept) if kept is not None else self.n_frames()

    def eff_frames(self) -> int:
        """Frames the scheduler will actually feed: ``kept_frames``
        (saliency-gated; raw when no gate) decimated by the ``degrade``
        stride (``ceil(kept / degrade)`` — frame 0 is always kept and
        served, so a non-empty session always feeds at least 1)."""
        return -(-self.kept_frames() // max(1, int(self.degrade)))

    def frame(self, i: int) -> np.ndarray:
        """The i-th raw (V, C) frame."""
        return self.clip[i] if self.clip is not None else self._buf[i]

    def release_frames(self) -> None:
        """Drop the frame payload once the session has finished (or been
        dropped) and its outcome is recorded — a long-lived service must
        not pin every served clip in memory.  ``n_frames`` keeps
        answering with the final count; ``frame`` is no longer valid."""
        self._released = self.n_frames()
        self.clip = None
        self._buf = []


@dataclasses.dataclass
class SessionRecord:
    """A completed session: identity, timing, QoS history, final logits."""

    sid: int
    frames: int              # clip length T (real frames)
    arrival: int             # tick of arrival (queue entry)
    admitted: int            # tick of first slot admission
    finished: int            # tick the drained logits were captured
    wall_admitted: float     # monotonic seconds
    wall_first_logit: float  # first *valid* logit contribution for this slot
                             # (-1.0 sentinel: the session never produced one)
    wall_finished: float
    logits: np.ndarray       # (num_classes,) post-drain prediction
    priority: int = 0
    preemptions: int = 0     # times this session was snapshot-evicted
    first_logit_tick: int = -1   # tick of the first valid logit (-1: never)
    degrade: int = 1         # frame-skip stride the session was served at
    frames_skipped: int = 0  # raw frames the saliency gate dropped


def _requests_from_arrivals(
    arrivals: np.ndarray,
    lengths: Sequence[int],
    joints: int,
    channels: int,
    rng: np.random.Generator,
    clip_source: Optional[Callable[[int, int], np.ndarray]],
    priorities: Optional[Sequence[int]],
    high_priority_ratio: float,
) -> List[SessionRequest]:
    """Shared request-building tail of the load generators: the priority
    mix (explicit ``priorities`` win over the ``high_priority_ratio``
    Bernoulli draw), the uniform clip-length choice, and clip content
    from ``clip_source(sid, T) -> (T, V, C)`` (standard-normal synthetic
    skeletons by default).  Draw order is part of the determinism
    contract: priorities first, then one (length, clip) pair per session
    in sid order, all from the caller's ``rng``."""
    if priorities is None:
        priorities = (rng.random(len(arrivals))
                      < high_priority_ratio).astype(int)
    reqs = []
    for sid, at in enumerate(arrivals):
        T = int(rng.choice(np.asarray(lengths)))
        if clip_source is not None:
            clip = np.asarray(clip_source(sid, T), np.float32)
        else:
            clip = rng.standard_normal((T, joints, channels)).astype(np.float32)
        reqs.append(SessionRequest(sid=sid, arrival=int(at), clip=clip,
                                   priority=int(priorities[sid])))
    return reqs


def poisson_arrivals(
    n_sessions: int,
    mean_interarrival: float,
    lengths: Sequence[int],
    joints: int,
    channels: int,
    seed: int = 0,
    clip_source: Optional[Callable[[int, int], np.ndarray]] = None,
    priorities: Optional[Sequence[int]] = None,
    high_priority_ratio: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> List[SessionRequest]:
    """Poisson-process session arrivals (exponential inter-arrival ticks).

    Clip/priority semantics per :func:`_requests_from_arrivals`.  Returns
    requests sorted by arrival tick (the first arrival anchors tick 0).
    All randomness comes from ``rng`` when given (``default_rng(seed)``
    otherwise) — never from numpy's global state, so interleaved
    generators and concurrent benchmark runs cannot cross-contaminate."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    gaps = rng.exponential(mean_interarrival, size=n_sessions)
    arrivals = np.floor(np.cumsum(gaps) - gaps[0]).astype(int)
    return _requests_from_arrivals(arrivals, lengths, joints, channels, rng,
                                   clip_source, priorities,
                                   high_priority_ratio)


def bursty_arrivals(
    n_sessions: int,
    lengths: Sequence[int],
    joints: int,
    channels: int,
    *,
    burst_size: int = 4,
    burst_gap: float = 1.0,
    lull_gap: float = 60.0,
    seed: int = 0,
    clip_source: Optional[Callable[[int, int], np.ndarray]] = None,
    priorities: Optional[Sequence[int]] = None,
    high_priority_ratio: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> List[SessionRequest]:
    """Bursty Poisson arrivals: alternating traffic peaks and lulls.

    Sessions arrive in bursts of ``burst_size`` spaced by exponential
    ``burst_gap`` ticks, with an exponential ``lull_gap`` idle stretch
    between bursts — the elastic-capacity stress load (a fixed small slab
    queues the bursts, a fixed large slab idles through the lulls; the
    elastic tier manager should do neither).  Clip/priority semantics per
    :func:`_requests_from_arrivals`; as with :func:`poisson_arrivals`, all
    randomness comes from the explicit ``rng`` (or ``default_rng(seed)``),
    never numpy's global state."""
    rng = rng if rng is not None else np.random.default_rng(seed)
    gaps = []
    for i in range(n_sessions):
        if i == 0:
            gaps.append(0.0)
        elif i % burst_size == 0:
            gaps.append(rng.exponential(lull_gap))
        else:
            gaps.append(rng.exponential(burst_gap))
    arrivals = np.floor(np.cumsum(gaps)).astype(int)
    return _requests_from_arrivals(arrivals, lengths, joints, channels, rng,
                                   clip_source, priorities,
                                   high_priority_ratio)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Slot:
    """Host-side view of one slab slot holding an admitted session.

    A preempted session is re-queued as this same object (progress,
    first-logit latch and preemption count travel with it), which is also
    how re-admission knows to restore its device snapshot rather than
    reset the slot.  ``total`` is None while the session is still open
    (clip length unknown); ``held`` marks a starved open session this tick
    (no step was taken for it)."""

    req: SessionRequest
    admitted: int            # first admission tick
    rel: int                 # frames fed so far (decimated clip + flush)
    total: Optional[int]     # eff. clip length + flush drain (None: open)
    wall_admitted: float
    wall_first_logit: float = -1.0
    first_logit_tick: int = -1    # tick-denominated twin of the wall latch
    preemptions: int = 0
    held: bool = False


class AdmissionQueue:
    """Priority admission queue: strict (priority desc, arrival, seq) order.

    With uniform priorities the (arrival, seq) tie-break makes this exactly
    a FIFO — today's behavior is the degenerate case, not a second code
    path.  Items are fresh :class:`SessionRequest`\\ s or preempted
    :class:`_Slot`\\ s awaiting re-admission (both carry the same ordering
    key through their request)."""

    def __init__(self):
        self._heap: List[Tuple[int, int, int, Any]] = []
        self._seq = 0
        self._by_sid: Dict[int, Any] = {}

    @staticmethod
    def _req(item) -> SessionRequest:
        return item.req if isinstance(item, _Slot) else item

    def push(self, item) -> None:
        """Queue a session (or a preempted slot) by (priority, arrival)."""
        r = self._req(item)
        heapq.heappush(self._heap, (-r.priority, r.arrival, self._seq, item))
        self._seq += 1
        self._by_sid[r.sid] = item

    def pop(self):
        """Remove and return the highest-priority (then earliest) item."""
        item = heapq.heappop(self._heap)[-1]
        self._by_sid.pop(self._req(item).sid, None)
        return item

    def peek(self):
        """The head item (next admission) without removing it, or None."""
        return self._heap[0][-1] if self._heap else None

    def peek_priority(self) -> Optional[int]:
        """Priority of the head item (the next admission), or None when
        the queue is empty (guarded: an empty heap used to IndexError)."""
        if not self._heap:
            return None
        return -self._heap[0][0]

    def remove(self, sid: int):
        """Remove and return the queued item with session id ``sid`` (a
        fresh request or a preempted slot awaiting re-admission), or None
        if that session is not queued — the cross-replica drain pulls a
        pinned session out of the admission queue here."""
        dropped = self.drop_if(lambda it: self._req(it).sid == sid)
        return dropped[0] if dropped else None

    def get(self, sid: int):
        """O(1) lookup by session id: the queued item (fresh request or
        preempted slot awaiting re-admission), or None if not queued —
        ``GcnService.poll`` runs this per call, so no linear scans."""
        return self._by_sid.get(sid)

    def drop_if(self, pred: Callable[[Any], bool]) -> List[Any]:
        """Remove and return every queued item for which ``pred`` holds
        (deadline expiry sweep); the queue keeps its heap order."""
        kept, dropped = [], []
        for entry in self._heap:
            (dropped if pred(entry[-1]) else kept).append(entry)
        if dropped:
            self._heap = kept
            heapq.heapify(self._heap)
        for e in dropped:
            self._by_sid.pop(self._req(e[-1]).sid, None)
        return [e[-1] for e in dropped]

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)

    def __iter__(self):
        """Iterate the queued items in heap (not pop) order — read-only
        inspection (e.g. ``GcnService.poll`` finding a preempted slot)."""
        return (entry[-1] for entry in self._heap)


@dataclasses.dataclass
class TickPlan:
    """One tick's device work order, built by ``SlabScheduler.tick_inputs``.

    ``frames``/``valid``/``reset``/``hold`` feed ``engine.step_frames``
    unchanged.  ``snapshot`` lists (slot, sid) pairs the driver must
    capture with ``engine.snapshot_slots`` *before* the step (preemption
    evictions); ``restore`` lists (slot, sid) pairs whose stored snapshot
    must be scattered back with ``engine.restore_slots`` before the step.

    When the scheduler was built with a snapshot ring (``snap_ring``),
    ``snap_order``/``rest_order`` additionally carry the same events as
    fixed-shape ``(max_events, 2)`` int32 (slot, ring row) buffers padded
    with :data:`SNAP_SENTINEL` — the one-dispatch form consumed by
    ``engine.fused_tick`` (None otherwise)."""

    frames: np.ndarray
    valid: np.ndarray
    reset: np.ndarray
    snapshot: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    restore: List[Tuple[int, int]] = dataclasses.field(default_factory=list)
    hold: Optional[np.ndarray] = None
    snap_order: Optional[np.ndarray] = None
    rest_order: Optional[np.ndarray] = None

    def __iter__(self):
        """Deprecated back-compat unpacking: ``frames, valid, reset =
        tick_inputs()`` — silently drops the ``hold`` mask (and the
        snapshot/restore orders), so drivers must migrate to the named
        fields."""
        warnings.warn(
            "unpacking TickPlan as a (frames, valid, reset) 3-tuple is "
            "deprecated: it drops the hold mask and the snapshot/restore "
            "orders — use the named fields (.frames/.valid/.reset/.hold/"
            ".snapshot/.restore)",
            DeprecationWarning, stacklevel=2)
        return iter((self.frames, self.valid, self.reset))


class SlabScheduler:
    """Slot table + priority admission queue driving ``engine.step_frames``.

    Pure host logic over numpy arrays: each tick, :meth:`tick_inputs`
    applies the QoS policy (deadline sweep, admissions, preemptions) and
    builds the :class:`TickPlan` the slab step consumes, and
    :meth:`tick_outputs` consumes the step's logits — finalising any
    session whose flush drain completed this tick and recycling its slot.

    Timing is delegated to two plan-derived callables so the scheduler
    itself stays device-free: ``flush_frames(T)`` (the per-block 'same'-padding
    drain after a T-frame clip, ``engine.stream_flush_frames``) and
    ``first_logit_delay`` (raw frames from admission to the first valid
    logit, ``engine.stream_first_logit_delay``).  Device snapshots never
    enter the scheduler either: preemption/restore are *named* in the
    TickPlan and executed by the driver.  Slot capacity is elastic through
    :meth:`resize` — the :class:`repro_torch.serving.GcnService` capacity
    manager compacts active sessions into a different-size slot table and
    migrates their device state with the same snapshot/restore
    primitives."""

    def __init__(self, slots: int, joints: int, channels: int,
                 flush_frames: Callable[[int], int],
                 first_logit_delay: int,
                 policy: str = "fifo",
                 snap_ring: Optional[int] = None,
                 retain: int = 1024,
                 saliency: Optional[Any] = None):
        if policy not in QOS_POLICIES:
            raise ValueError(
                f"unknown QoS policy {policy!r} (expected one of "
                f"{QOS_POLICIES})")
        if retain < 1:
            raise ValueError(f"retain must be >= 1, got {retain}")
        self.slots: List[Optional[_Slot]] = [None] * slots
        self.joints, self.channels = joints, channels
        self.flush_frames = flush_frames
        self.first_logit_delay = first_logit_delay
        self.policy = policy
        self.queue = AdmissionQueue()
        # per-session bookkeeping is retention-bounded: a long-lived
        # service must not pin every served session's record forever, so
        # completed/missed keep only the most recent ``retain`` entries
        # while the running aggregates below carry the lifetime totals
        self.retain = int(retain)
        self.completed: Deque[SessionRecord] = deque(maxlen=self.retain)
        self.missed: Deque[SessionRequest] = deque()  # deadline casualties
        self.missed_sids: set = set()            # O(1) poll-side mirror
        self._occ_window: Deque[float] = deque(maxlen=self.retain)
        self.n_completed = 0         # lifetime finished-session count
        self.n_missed = 0            # lifetime deadline-miss count
        self.occ_sum = 0.0           # lifetime sum of busy/S samples
        self.occ_ticks = 0           # processed ticks (occupancy samples)
        self.qwait_sum = 0           # lifetime sum of arrival->admit waits
        # optional callback fired when the deadline policy drops a session
        # (after its frames are released) — the service uses it to bound
        # its own per-sid bookkeeping in lockstep
        self.on_miss: Optional[Callable[[SessionRequest], None]] = None
        # optional callback fired the tick a session's first valid logit
        # latches: (priority, arrival->latch ticks) — the measurement the
        # SLO controller's control loop closes on
        self.on_first_logit: Optional[Callable[[int, int], None]] = None
        self.valid_frames = 0        # real (clip) frames fed across all slots
        self.preemptions = 0         # snapshot-evictions performed
        self.restores = 0            # preempted sessions re-admitted
        # optional repro_torch.serving.saliency.SaliencyGate: scores each
        # occupied slot's unscored frames every tick and the feed clock
        # serves only the kept subsequence (None = saliency off, the feed
        # path is byte-identical to the pre-saliency scheduler)
        self.saliency = saliency
        self.frames_skipped = 0      # lifetime saliency-dropped frames
                                     # across *finished* sessions
        # per-tick event budget: the fused tick's order buffers are padded
        # to this static width, and the QoS loops below never schedule more
        # snapshot (or restore) events per tick than it — surplus work
        # defers to later ticks.  Applied under every policy so the fused
        # and legacy drivers see identical TickPlans.
        self.max_events = max_events_for(slots)
        # optional host-side allocator for the on-device snapshot ring
        # (``engine.init_snapshot_ring``): rows are S-independent, so one
        # ring serves every capacity tier and survives elastic migrations.
        self.snap_ring = snap_ring
        self._ring_free: List[int] = (
            list(range(int(snap_ring))) if snap_ring is not None else [])
        self._ring_of: Dict[int, int] = {}       # sid -> occupied ring row

    @property
    def occupancy_samples(self) -> List[float]:
        """The most recent ``retain`` busy/S samples (one per processed
        tick) as a plain list — the retention window behind the lifetime
        ``occ_sum``/``occ_ticks`` aggregates."""
        return list(self._occ_window)

    # -- admission -----------------------------------------------------------

    def submit(self, req: SessionRequest) -> None:
        """Queue an arrived session (strict (priority, arrival) order —
        plain FIFO when every priority is equal)."""
        self.queue.push(req)

    def busy(self) -> int:
        """Occupied slot count (active + draining)."""
        return sum(s is not None for s in self.slots)

    def idle(self) -> bool:
        """True when no session is queued or occupying a slot."""
        return not self.queue and self.busy() == 0

    def resize(self, new_slots: int) -> Dict[int, int]:
        """Compact the occupied slots into a ``new_slots``-slot table.

        The elastic-capacity slot remap: active sessions keep their host
        state and are packed into slots ``0..k-1`` of the new table (k =
        busy count, which must fit — the capacity manager only shrinks
        when it does).  Returns the ``{old_slot: new_slot}`` mapping the
        driver uses to migrate the matching device rows via
        ``engine.snapshot_slots``/``restore_slots``.  Queue, records and
        counters are untouched."""
        occupied = [(s, slot) for s, slot in enumerate(self.slots)
                    if slot is not None]
        if len(occupied) > new_slots:
            raise ValueError(
                f"cannot resize to {new_slots} slots: {len(occupied)} "
                "sessions are active")
        mapping: Dict[int, int] = {}
        slots: List[Optional[_Slot]] = [None] * new_slots
        for ns, (s, slot) in enumerate(occupied):
            slots[ns] = slot
            mapping[s] = ns
        self.slots = slots
        self.max_events = max_events_for(new_slots)
        return mapping

    # -- policy helpers ------------------------------------------------------

    def _expired(self, item, tick: int) -> bool:
        r = AdmissionQueue._req(item)
        return r.deadline is not None and tick > r.deadline

    def _miss(self, item, tick: int) -> None:
        r = AdmissionQueue._req(item)
        # the outcome is recorded; drop the frame payload immediately so a
        # long-lived deadline service never pins dropped clips in memory
        r.release_frames()
        self.missed.append(r)
        self.missed_sids.add(r.sid)
        self.n_missed += 1
        while len(self.missed) > self.retain:
            old = self.missed.popleft()
            self.missed_sids.discard(old.sid)
        if self.on_miss is not None:
            self.on_miss(r)

    def sweep_expired(self, tick: int) -> int:
        """Drop every queued or active session whose deadline has passed;
        returns the number of sessions missed.  A no-op under non-deadline
        policies, and idempotent within a tick — the service calls this
        *before* the capacity manager observes demand (expired sessions
        are not demand and must not trigger a grow), and
        :meth:`tick_inputs` calls it again as part of the tick."""
        if self.policy != "deadline":
            return 0
        n = 0
        # queue sweep: expired sessions never reach a slot (only fresh
        # requests can be queued here — preempted _Slots exist only under
        # the mutually-exclusive preempt policy, so no stored snapshot can
        # be orphaned by a drop)
        for item in self.queue.drop_if(lambda it: self._expired(it, tick)):
            self._miss(item, tick)
            n += 1
        # slot sweep: evict sessions whose deadline passed mid-service
        for s, slot in enumerate(self.slots):
            if slot is not None and self._expired(slot, tick):
                self.slots[s] = None
                self._miss(slot, tick)
                n += 1
        return n

    def _admit(self, s: int, item, tick: int, now: float,
               reset: np.ndarray, restore: List[Tuple[int, int]]) -> None:
        """Place a queue item into free slot ``s``: fresh sessions get a
        traced reset, preempted sessions get a snapshot restore.  The
        service-time budget (``total``) stays None until the session's
        stream is closed (a closed clip resolves it on the first tick)."""
        if isinstance(item, _Slot):                  # resume a preemption
            self.slots[s] = item
            restore.append((s, item.req.sid))
            self.restores += 1
        else:
            self.slots[s] = _Slot(
                req=item, admitted=tick, rel=0, total=None,
                wall_admitted=now)
            reset[s] = True

    # -- one tick ------------------------------------------------------------

    def tick_inputs(self, tick: int, now: float) -> TickPlan:
        """Apply the QoS policy, admit into free slots, build step inputs.

        Returns a :class:`TickPlan` whose ``frames (S, V, C) f32``,
        ``valid (S,) bool``, ``reset (S,) bool`` and ``hold (S,) bool``
        feed the slab step (reset marks this tick's fresh admissions — the
        traced slot zeroing; valid marks slots feeding real clip frames,
        False = flush drain or free slot — both take the zero-padding
        path; hold marks starved *open* sessions frozen in place), plus
        the snapshot/restore slot lists the driver must execute around
        it."""
        S = len(self.slots)
        reset = np.zeros((S,), bool)
        snapshot: List[Tuple[int, int]] = []
        restore: List[Tuple[int, int]] = []

        self.sweep_expired(tick)

        for s in range(S):
            if self.slots[s] is None and self.queue:
                # restore-budget gate: re-admitting a preempted head costs
                # one restore event; once the tick's budget is spent, stop
                # admitting (skipping the head would break strict priority
                # order) — the queue drains next tick
                if (isinstance(self.queue.peek(), _Slot)
                        and len(restore) >= self.max_events):
                    break
                self._admit(s, self.queue.pop(), tick, now, reset, restore)

        if self.policy == "preempt":
            # a queued strictly-higher-priority session snapshot-evicts the
            # lowest-priority active slot (latest admission breaks ties —
            # the session with the least sunk progress yields first);
            # capped at max_events snapshots (and restores) per tick so
            # the fused tick's fixed-shape order buffers always fit —
            # surplus preemptions simply happen a tick later
            while self.queue:
                if len(snapshot) >= self.max_events:
                    break
                if (isinstance(self.queue.peek(), _Slot)
                        and len(restore) >= self.max_events):
                    break
                head_p = self.queue.peek_priority()
                cands = [(slot.req.priority, -slot.admitted, s)
                         for s, slot in enumerate(self.slots)
                         if slot is not None]
                if not cands:
                    break
                vp, _, vs = min(cands)
                if vp >= head_p:
                    break
                victim = self.slots[vs]
                snapshot.append((vs, victim.req.sid))
                victim.preemptions += 1
                self.preemptions += 1
                self.slots[vs] = None
                self.queue.push(victim)
                self._admit(vs, self.queue.pop(), tick, now, reset, restore)

        frames = np.zeros((S, self.joints, self.channels), np.float32)
        valid = np.zeros((S,), bool)
        hold = np.zeros((S,), bool)
        for s, slot in enumerate(self.slots):
            if slot is None:
                continue
            slot.held = False
            req = slot.req
            if self.saliency is not None and slot.total is None:
                # score any frames that arrived since last tick *before*
                # the budget/feed math below — the kept list is this
                # tick's ground truth for both
                self.saliency.extend(req)
            if slot.total is None and req.is_closed():
                # service-time budget in *effective* frames: a degraded
                # session's clip is stride-decimated (of the saliency-kept
                # subsequence when a gate runs), so both the clip phase
                # and the flush drain shrink by ~the stride
                n = req.eff_frames()
                slot.total = n + self.flush_frames(n)
            stride = max(1, int(req.degrade))
            kept = getattr(req, "sal_kept", None)
            if slot.rel * stride < req.kept_frames():
                # feed effective frame ``rel`` = kept frame ``rel*stride``
                # (raw index when no saliency gate; stride 1 = every kept
                # frame): the device sees a contiguous decimated stream —
                # no engine change, no hold-mask cost.  An open session
                # whose fresh frames were all saliency-skipped fails this
                # bound and is *held* below, exactly like a starved one.
                raw = (kept[slot.rel * stride] if kept is not None
                       else slot.rel * stride)
                f = req.frame(raw)
                # a narrower-topology frame rides zero-padded to the slab
                # width (its plan masks the padded joints)
                frames[s, : f.shape[0]] = f
                valid[s] = True
                self.valid_frames += 1
            elif slot.total is None:
                # open session with an empty buffer: freeze the slot (a
                # flush step here would inject zero padding mid-stream)
                hold[s] = True
                slot.held = True
        occ = self.busy() / S
        self._occ_window.append(occ)
        self.occ_sum += occ
        self.occ_ticks += 1
        snap_order = rest_order = None
        if self.snap_ring is not None:
            snap_order, rest_order = self._ring_orders(snapshot, restore)
        return TickPlan(frames=frames, valid=valid, reset=reset,
                        snapshot=snapshot, restore=restore, hold=hold,
                        snap_order=snap_order, rest_order=rest_order)

    def _ring_orders(self, snapshot: List[Tuple[int, int]],
                     restore: List[Tuple[int, int]]
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Assign ring rows to this tick's events and build the padded
        (slot, ring row) order buffers for ``engine.fused_tick``.

        Snapshot rows are allocated *before* restored rows are returned to
        the free list, so a row being read by this tick's restore scatter
        can never be handed to this tick's snapshot gather — within the
        fused dispatch the snapshot writes land first, and across ticks
        device execution follows dispatch order, so next-tick reuse is
        safe.  A same-tick snapshot→restore of one session (preempt-then-
        readmit) reads the row the snapshot just wrote, by construction of
        ``engine.fused_tick``."""
        snap_events = []
        for s, sid in snapshot:
            if not self._ring_free:
                raise RuntimeError(
                    f"snapshot ring exhausted ({self.snap_ring} rows, "
                    f"{len(self._ring_of)} live snapshots) — raise the "
                    "service's snap_capacity")
            row = self._ring_free.pop()
            self._ring_of[sid] = row
            snap_events.append((s, row))
        rest_events = []
        freed = []
        for s, sid in restore:
            row = self._ring_of.pop(sid)
            rest_events.append((s, row))
            freed.append(row)
        self._ring_free.extend(freed)
        return (pad_event_orders(snap_events, self.max_events),
                pad_event_orders(rest_events, self.max_events))

    def ring_adopt(self, sid: int) -> int:
        """Allocate a snapshot-ring row for session ``sid`` and return it —
        the import half of a cross-replica migration: the driver uploads
        the session's host snapshot into this row, and the next admission
        restores it exactly like a local preemption resume."""
        if self.snap_ring is None:
            raise RuntimeError("scheduler was built without a snapshot "
                               "ring (fused path only)")
        if not self._ring_free:
            raise RuntimeError(
                f"snapshot ring exhausted ({self.snap_ring} rows, "
                f"{len(self._ring_of)} live snapshots) — raise the "
                "service's snap_capacity")
        row = self._ring_free.pop()
        self._ring_of[sid] = row
        return row

    def ring_release(self, sid: int) -> int:
        """Free session ``sid``'s snapshot-ring row and return it — the
        export half of a cross-replica migration: the driver reads the row
        out of the device ring before the allocator recycles it (device
        execution follows dispatch order, so the read always lands before
        any later snapshot reuses the row)."""
        row = self._ring_of.pop(sid)
        self._ring_free.append(row)
        return row

    def tick_outputs(self, tick: int, logits: np.ndarray, now: float
                     ) -> List[SessionRecord]:
        """Advance slot clocks with this tick's logits; evict drained slots.

        ``logits`` is the slab step's (S, num_classes) output.  Held slots
        took no step and are skipped.  The first tick a slot's clock
        reaches the first-logit delay latches the wall time (a ``>=``
        latch, set once — the session keeps it across preemptions); a slot
        whose flush drain completed captures its logits row as the
        session's final prediction, is freed, and the finished
        :class:`SessionRecord` is returned (and appended to
        ``self.completed``)."""
        done: List[SessionRecord] = []
        for s, slot in enumerate(self.slots):
            if slot is None or slot.held:
                continue
            if (slot.wall_first_logit < 0
                    and slot.rel >= self.first_logit_delay - 1):
                slot.wall_first_logit = now
                slot.first_logit_tick = tick
                if self.on_first_logit is not None:
                    self.on_first_logit(slot.req.priority,
                                        tick - slot.req.arrival)
            if slot.total is not None and slot.rel == slot.total - 1:
                skipped = slot.req.n_frames() - slot.req.kept_frames()
                self.frames_skipped += skipped
                rec = SessionRecord(
                    sid=slot.req.sid, frames=slot.req.n_frames(),
                    arrival=slot.req.arrival, admitted=slot.admitted,
                    finished=tick, wall_admitted=slot.wall_admitted,
                    wall_first_logit=slot.wall_first_logit,
                    wall_finished=now,
                    logits=np.asarray(logits[s]),
                    priority=slot.req.priority,
                    preemptions=slot.preemptions,
                    first_logit_tick=slot.first_logit_tick,
                    degrade=max(1, int(slot.req.degrade)),
                    frames_skipped=skipped)
                done.append(rec)
                self.completed.append(rec)   # bounded deque (maxlen=retain)
                self.n_completed += 1
                self.qwait_sum += rec.admitted - rec.arrival
                self.slots[s] = None
            else:
                slot.rel += 1
        return done


# ---------------------------------------------------------------------------
# benchmark row persistence
# ---------------------------------------------------------------------------

def bench_key(row: Dict) -> Tuple:
    """Merge key of one ``BENCH_torch_sessions.json`` row: ``(backend,
    device, slots, qos, capacity, load, mesh, replicas, policy, trace,
    topologies, ck, saliency)``.

    ``device`` (``"cuda"`` or ``"cpu"``, default ``"cuda"``, the port's
    default device) keeps a CPU run of the plain versions from clobbering
    the card's row of the same cell.

    ``capacity`` distinguishes fixed-capacity runs (``"fixed"``, the
    default for rows written before the elastic axis existed) from elastic
    runs (``"elastic:2,4,8"`` — the tier tuple), and ``load`` the arrival
    process (``"poisson"`` default vs ``"burst"`` vs ``"trace"`` for
    trace replays) — without them an elastic run and its fixed baselines
    under the same (backend, slots, qos) would collide and clobber each
    other.  ``mesh`` (device-mesh size, default 1 = single device) and
    ``replicas`` (router replica count, default 1 = one service) are the
    distributed axes: a sharded or routed run must not clobber its
    single-device baseline.  ``policy`` (capacity-control policy,
    default ``"demand"`` for every pre-SLO row) and ``trace`` (the
    replayed trace's name/digest, default ``""`` for generated loads)
    are the A/B axes of the trace-replay harness: the same trace under
    ``demand`` vs ``slo`` must land as two comparable rows, not one
    clobbering the other.  ``topologies`` (the served skeleton set,
    default ``"ntu25"`` for every pre-variable-topology row) keeps an
    ``--topology ntu50`` run from clobbering its 25-joint baseline.
    ``ck`` (windowed C_k graph on, default False) and ``saliency`` (the
    gate threshold, default 0 = off) are the adaptive-streaming axes —
    legacy rows predate both features, so the defaults key them as
    feature-off runs."""
    return (row.get("backend"), row.get("device", "cuda"), row.get("slots"),
            row.get("qos", "fifo"),
            row.get("capacity", "fixed"), row.get("load", "poisson"),
            row.get("mesh", 1), row.get("replicas", 1),
            row.get("policy", "demand"), row.get("trace", ""),
            row.get("topologies", "ntu25"),
            bool(row.get("ck", False)), float(row.get("saliency", 0.0)))


def write_bench(results: List[Dict], path: str = DEFAULT_BENCH_PATH) -> None:
    """Merge the multi-session serving rows into ``path`` (default
    ``BENCH_torch_sessions.json``).

    Rows are keyed by :func:`bench_key` — ``(backend, device, slots, qos,
    capacity, load, mesh, replicas, policy, trace, topologies, ck,
    saliency)``, with legacy
    defaults (``qos="fifo"``, ``capacity="fixed"``, ``load="poisson"``,
    ``policy="demand"``, ``ck=False``, ``saliency=0``, …) for rows
    written before each
    axis existed: an existing row with the same key is replaced in place,
    every other row survives, and new keys are appended — so
    ``serve sessions --backend cuda`` refreshes only the cuda rows
    instead of clobbering the reference rows."""
    existing: List[Dict] = []
    if os.path.exists(path):
        try:
            with open(path) as f:
                existing = json.load(f)
            if not isinstance(existing, list):
                existing = []
        except (json.JSONDecodeError, OSError):
            existing = []
    fresh = {bench_key(r): {k: v for k, v in r.items()
                            if k not in ("records", "outcomes")}
             for r in results}
    rows = []
    for r in existing:
        rows.append(fresh.pop(bench_key(r), r))
    rows.extend(fresh.values())
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)
