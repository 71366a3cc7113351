"""`GcnService`: the session-handle serving facade over the AGCN engine.
Port of ``repro.serving.service``.

One object owns the compiled ExecutionPlans, the per-tier session slabs,
the QoS scheduler and the elastic capacity manager, and exposes the
four-call session protocol:

    svc = GcnService(cfg, backend="cuda", qos="preempt",
                     capacity_tiers=(2, 4, 8, 16))
    h = svc.open_session(priority=1)
    svc.submit(h, frame)          # one (V, C) raw skeleton frame at a time
    svc.tick()                    # one scheduler tick serves every session
    svc.poll(h)                   # state + running logits
    svc.close(h)                  # end of stream -> flush drain -> record

Under the facade: the host-side
:class:`~repro_torch.serving.scheduler.SlabScheduler` builds each tick's
:class:`~repro_torch.serving.scheduler.TickPlan`, one call of
``make_gcn_slab_step`` (or, on a tick with snapshot or restore events,
``make_gcn_fused_tick``) advances every slot (admission resets, flush
drains and starved-session holds are masks), and QoS preemption and
elastic migration both ride the engine's snapshot/restore gather and
scatter.

The engine is functional: every step, restore and migration returns new
slabs and rings, which the service rebinds.  So the per-tier slabs stay
pristine (all zero) and entering a tier needs no reset.  The tick's host
inputs go to the device in one copy from pinned memory, and its logits
come back only when something reads them: a session finishing this
tick, ``poll(wait=True)`` or ``metrics``.  A tick without either does no
device-to-host copy, so the host plans tick t + 1 while the device runs
tick t.

**Elastic capacity**: one slab per ``capacity_tiers`` entry, a hysteresis
:class:`~repro_torch.serving.capacity.CapacityManager` (or the SLO
controller) over queue depth and occupancy, and on a grow/shrink decision
every active session migrates across slabs: gather the occupied rows,
scatter them into the pristine target tier, remap the scheduler's slot
table.  A session migrated across tiers gives the logits of the
uninterrupted fixed-capacity session.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device, synchronize
from repro_torch.serving.capacity import CapacityConfig, CapacityManager
from repro_torch.serving.saliency import SaliencyConfig, SaliencyGate
from repro_torch.serving.scheduler import (QOS_POLICIES, AdmissionQueue,
                                           SessionRecord, SessionRequest,
                                           SlabScheduler, bursty_arrivals,
                                           max_events_for, pad_event_orders,
                                           poisson_arrivals)
from repro_torch.serving.slo import CONTROL_POLICIES, SloConfig, SloController

SESSION_STATES = ("queued", "active", "draining", "done", "missed",
                  "rejected")

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.bool_): torch.bool}


@dataclasses.dataclass(frozen=True)
class SessionHandle:
    """Opaque ticket for one open session (returned by ``open_session``)."""

    sid: int


@dataclasses.dataclass
class SessionStatus:
    """One ``poll`` result: where the session is and what it predicts.

    ``state`` ∈ ``SESSION_STATES``: *queued* (awaiting a slot — including
    a preempted session awaiting re-admission), *active* (in a slot,
    consuming frames; a starved open session holds here), *draining*
    (stream closed, flush latency draining through the blocks), *done*
    (final record available), *missed* (dropped by the deadline
    policy) or *rejected* (turned away at open by the SLO controller's
    admission shed — it never entered the scheduler; ``submit``/``close``
    on it are no-ops).  ``logits`` is the slot's running prediction while
    active/draining, the final post-drain prediction when done, None
    otherwise."""

    sid: int
    state: str
    frames_submitted: int
    frames_consumed: int
    priority: int
    logits: Optional[np.ndarray] = None
    record: Optional[SessionRecord] = None


def _state_copy(slab):
    """A copy of a StreamState: every per-slot leaf gathered anew."""
    from repro_torch.core.agcn import engine
    idx = torch.arange(slab.t_raw.shape[0], device=slab.t_raw.device)
    return dataclasses.replace(slab, **engine.snapshot_slots(slab, idx))


def _set_row(leaf: torch.Tensor, row: int, value) -> torch.Tensor:
    """``leaf`` with row ``row`` replaced by ``value``, out of place."""
    out = leaf.clone()
    out[row] = torch.as_tensor(np.asarray(value), dtype=leaf.dtype,
                               device=leaf.device)
    return out


class GcnService:
    """Multi-session GCN serving facade: open/submit/poll/close + tick.

    One instance owns, per ensemble stream (joint + bone by default): a
    compiled ``ExecutionPlan``, frozen BN calibration, and one pristine
    session slab per capacity tier.  ``tick()`` advances every admitted
    session by one raw frame through one slab step; admission, preemption
    (``qos="preempt"``), deadline eviction (``qos="deadline"``) and
    elastic tier migration all happen between steps on the host.

    Parameters (as the JAX package's ``GcnService``, without ``mesh``):
      cfg              — a gcn-family ``ModelConfig``.
      backend          — engine backend (``cuda`` | ``reference``).
      device           — where plans, slabs and steps live; None means
                         CUDA (raises without a card), ``"cpu"`` runs the
                         kernels' plain versions.
      qos              — scheduler policy (``fifo`` | ``preempt`` |
                         ``deadline``).
      capacity_tiers   — slot capacities; one entry = fixed capacity,
                         several = elastic (the service starts at the
                         smallest tier and the controller hops the ladder).
      capacity_config  — hysteresis knobs (tiers taken from
                         ``capacity_tiers``).
      policy           — capacity control: ``"demand"`` (grow on raw
                         busy+queued demand) or ``"slo"`` (grow on the
                         measured p99 first-logit latency, shed by
                         admission control at the top tier).
      slo_config       — :class:`~repro_torch.serving.slo.SloConfig` knobs
                         for ``policy="slo"``.
      record_outcomes  — keep a per-tick scheduler-outcome log under
                         ``self.outcomes`` (pure host ints: admissions,
                         restores, preemptions, finishes, misses, sheds,
                         capacity), the record the golden replays lock.
      quant            — Q8.8-quantize the plans (the paper's C5 target).
      seed             — parameter and calibration seed (ignored when
                         ``plans`` is given): one ``torch.Generator``
                         seeded with it draws the joint then the bone
                         stream, anew for each topology, so the
                         parameters that do not depend on the joint count
                         are the same for every skeleton.
      plans            — prebuilt ExecutionPlan tuple: ``(joint,)`` or
                         ``(joint, bone)``, on ``device``.
      bn_stats         — frozen BN statistics per plan (tuple, or one dict
                         shared by every plan); calibrated from
                         ``x_calib`` (or a synthetic pipeline batch) when
                         None.
      x_calib          — (N, T, V, C) calibration clip batch.
      warm             — run every tier's steps, the fused tick and the
                         tier migrations once at construction, so kernel
                         builds and first allocations land before traffic.
      fused            — ticks with snapshot or restore events run
                         ``make_gcn_fused_tick`` (gathers, scatters,
                         masks and the step in one call, snapshots in an
                         on-device ring) and the logits are read back only
                         when needed; False is the legacy tick (one call
                         per snapshot/restore event, host-held snapshots,
                         a readback every tick).
      snap_capacity    — snapshot-ring rows (fused path); default
                         ``2 * max(capacity_tiers)``.
      topologies       — skeletons served (registry names).  The first is
                         the primary; the slab is as wide as the widest
                         skeleton and every topology's plans are padded to
                         it.  A mixed tick steps the primary group (with
                         the events and free slots) first, then each other
                         group with its own plans and BN statistics, the
                         slots outside the group held.
      sconv, csr_eps   — spatial-conv selection for
                         ``engine.build_execution_plan``.
      retain_records   — bound on per-session host bookkeeping.
      saliency_thresh  — > 0 runs a
                         :class:`~repro_torch.serving.saliency.SaliencyGate`
                         at that threshold; 0 (default) = off.
    """

    @torch.inference_mode()
    def __init__(self, cfg, *, backend: str = "cuda", qos: str = "fifo",
                 capacity_tiers: Sequence[int] = (8,),
                 capacity_config: Optional[CapacityConfig] = None,
                 policy: str = "demand",
                 slo_config: Optional[SloConfig] = None,
                 record_outcomes: bool = False,
                 quant: bool = True, seed: int = 0,
                 plans: Optional[Tuple] = None,
                 bn_stats: Optional[Any] = None,
                 x_calib: Optional[Any] = None,
                 warm: bool = True, fused: bool = True,
                 snap_capacity: Optional[int] = None,
                 topologies: Sequence[str] = ("ntu25",),
                 sconv: str = "auto", csr_eps: float = 0.0,
                 retain_records: int = 1024,
                 saliency_thresh: float = 0.0,
                 device: DeviceLike = None):
        from repro_torch.core.agcn import engine
        from repro_torch.core.agcn.graph import get_topology
        from repro_torch.core.agcn.model import bone_stream_parents
        from repro_torch.train.steps import (make_gcn_fused_tick,
                                             make_gcn_slab_step)

        if qos not in QOS_POLICIES:
            raise ValueError(f"unknown QoS policy {qos!r}")
        if policy not in CONTROL_POLICIES:
            raise ValueError(f"unknown capacity policy {policy!r} "
                             f"(expected one of {CONTROL_POLICIES})")
        tiers = tuple(sorted(int(t) for t in capacity_tiers))
        if not tiers:
            raise ValueError("capacity_tiers must name at least one tier")
        if retain_records < 1:
            raise ValueError(
                f"retain_records must be >= 1, got {retain_records}")
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        self.backend = backend
        self.qos = qos
        self.tiers = tiers
        self.retain_records = int(retain_records)
        self._engine = engine

        # --- topology registry: one plan set per declared skeleton --------
        names = tuple(dict.fromkeys(topologies))
        if not names:
            raise ValueError("topologies must name at least one skeleton")
        self._topos = {t: get_topology(t, cfg.gcn_kv) for t in names}
        self.topologies = names
        self.primary = names[0]
        self.vmax = max(tp.num_joints for tp in self._topos.values())

        # --- plans (joint [+ bone]), each padded to the slab width --------
        if plans is not None and len(names) > 1:
            raise ValueError(
                "prebuilt plans are single-topology — a multi-topology "
                "service builds its own per-skeleton plans from cfg")
        self._topo_plans: Dict[str, Tuple] = {}
        if plans is None:
            from repro_torch.core.agcn.model import init_params
            from repro_torch.core.pruning.plan import plan_from_config
            for t in names:
                topo = self._topos[t]
                cfg_t = dataclasses.replace(cfg, gcn_joints=topo.num_joints)
                gen = torch.Generator().manual_seed(seed)
                self._topo_plans[t] = tuple(
                    engine.build_execution_plan(
                        init_params(cfg_t, gen, device=dev), cfg_t,
                        plan_from_config(cfg_t), quant=quant,
                        backend=backend, topology=topo,
                        pad_joints=self.vmax, sconv=sconv, csr_eps=csr_eps)
                    for _ in ("joint", "bone"))
        else:
            on = {p.arrays["fc_w"].device.type for p in plans}
            if on != {dev.type}:
                raise ValueError(f"the prebuilt plans lie on {sorted(on)}, "
                                 f"the service on {dev.type}")
            self._topo_plans[self.primary] = tuple(plans)
        self.plans = self._topo_plans[self.primary]
        self.vmax = int(self.plans[0].static.joints)

        # --- frozen BN calibration (per topology, shared by every tier) ---
        if len(names) > 1 and (bn_stats is not None or x_calib is not None):
            raise ValueError(
                "bn_stats/x_calib override a single topology's calibration "
                "— a multi-topology service calibrates each skeleton from "
                "its own synthetic batch")
        self._topo_stats: Dict[str, Tuple] = {}
        for t in names:
            plans_t = self._topo_plans[t]
            topo = self._topos[t]
            transforms = [
                lambda x: x,
                lambda x, p=topo.parents: bone_stream_parents(x, p),
            ][: len(plans_t)]
            if bn_stats is not None:
                st = ((bn_stats,) * len(plans_t)
                      if isinstance(bn_stats, dict) else tuple(bn_stats))
            else:
                xc = x_calib
                if xc is None:
                    from repro_torch.data.pipeline import (DataConfig,
                                                           skeleton_batches)
                    cfg_t = dataclasses.replace(
                        cfg, gcn_joints=topo.num_joints)
                    dcfg = DataConfig(global_batch=4, seq_len=cfg.gcn_frames,
                                      seed=seed)
                    xc = next(skeleton_batches(cfg_t, dcfg))["x"]
                xc = torch.as_tensor(xc, dtype=torch.float32, device=dev)
                st = tuple(engine.collect_bn_stats(p, tf(xc))
                           for p, tf in zip(plans_t, transforms))
            self._topo_stats[t] = tuple(
                engine._pad_data_bn_stats(s, p.static)
                for s, p in zip(st, plans_t))
        self.bn_stats = self._topo_stats[self.primary]

        # --- one pristine slab per capacity tier --------------------------
        # nothing writes into a slab in place (steps, restores and
        # migrations return new ones), so the live slab may start as the
        # tier's own and every tier stays all zero
        self._tier_slabs = {
            S: tuple(engine.init_session_slab(p, S, bn_stats=bs)
                     for p, bs in zip(self.plans, self.bn_stats))
            for S in tiers}
        self.slabs = self._tier_slabs[tiers[0]]

        # --- scheduler + capacity manager ---------------------------------
        self.fused = bool(fused)
        self.snap_capacity = int(snap_capacity if snap_capacity is not None
                                 else 2 * max(tiers))
        self.saliency: Optional[SaliencyGate] = None
        if saliency_thresh and saliency_thresh > 0.0:
            self.saliency = SaliencyGate(
                SaliencyConfig(threshold=float(saliency_thresh)))
        self.sched = SlabScheduler(
            tiers[0], self.vmax, cfg.gcn_in_channels,
            flush_frames=self.flush_frames,
            first_logit_delay=engine.stream_first_logit_delay(self.plans[0]),
            policy=qos,
            snap_ring=self.snap_capacity if self.fused else None,
            retain=self.retain_records,
            saliency=self.saliency)
        self.sched.on_miss = self._on_miss
        self.policy = policy
        self.capman: Optional[CapacityManager] = None
        self.slo: Optional[SloController] = None
        if policy == "slo":
            self.slo = SloController(
                slo_config or SloConfig(), tiers=tiers, start_tier=tiers[0],
                latency_floor=self.sched.first_logit_delay)
            self.sched.on_first_logit = self.slo.record_first_logit
        elif len(tiers) > 1:
            ccfg = capacity_config or CapacityConfig(tiers=tiers)
            if tuple(sorted(ccfg.tiers)) != tiers:
                ccfg = dataclasses.replace(ccfg, tiers=tiers)
            self.capman = CapacityManager(ccfg, start_tier=tiers[0])
        self.record_outcomes = bool(record_outcomes)
        self.outcomes: List[Dict] = []
        self._shed_tick: List[Dict] = []    # sheds since the last tick
        self._missed_tick: List[int] = []   # misses within this tick
        self._rejected: set = set()         # rejected sids (poll-side)
        self.n_rejected = 0                 # lifetime rejected-open count

        # --- device entry points (plain callables, functional) ------------
        self._step = make_gcn_slab_step(cfg)
        self._fused_tick = make_gcn_fused_tick(cfg)
        self._snap_fn = engine.snapshot_slots
        self._rest_fn = engine.restore_slots
        # per-stream snapshot rings (fused path): rows are slot-shaped, so
        # one ring serves every tier and rides through migrations
        self._rings: Optional[Tuple] = None
        if self.fused:
            self._rings = tuple(
                engine.init_snapshot_ring(s, self.snap_capacity)
                for s in self._tier_slabs[tiers[0]])

        # --- session bookkeeping -------------------------------------------
        self._next_sid = 0
        self._sessions: Dict[int, SessionRequest] = {}
        self._records: Dict[int, SessionRecord] = {}
        self._snaps: Dict[int, Tuple] = {}    # sid -> per-stream snapshots
                                              # (legacy tick path only)
        self._retired: deque = deque()
        self._tick = 0
        self._last_logits: Optional[Any] = None   # device tensor until forced
        self.wall_host_s = 0.0                # host scheduling inside tick()
        self.wall_device_s = 0.0              # forced-readback device waits
        self.wall_dispatch_s = 0.0            # host time issuing the upload
                                              # and the steps (in host_s)
        self.device_dispatches = 0            # step calls issued by tick()
        self.readbacks = 0                    # forced logit copies to host
        self.tier_ticks: Dict[int, int] = {S: 0 for S in tiers}
        self._tick_ms: deque = deque(maxlen=self.retain_records)

        if warm:
            self._warm()

    # -- construction helpers ------------------------------------------------

    def _retire(self, sid: int) -> None:
        """Enter ``sid`` into the bounded retirement window; the oldest
        retiree beyond ``retain_records`` loses its host-side bookkeeping
        (its outcome already lives in the lifetime aggregates)."""
        self._retired.append(sid)
        while len(self._retired) > self.retain_records:
            old = self._retired.popleft()
            self._sessions.pop(old, None)
            self._records.pop(old, None)
            self._snaps.pop(old, None)
            self.sched.missed_sids.discard(old)
            self._rejected.discard(old)

    def _on_miss(self, req: SessionRequest) -> None:
        """Scheduler ``on_miss`` hook: retire the dropped session's
        bookkeeping and note the miss in this tick's outcome log."""
        self._retire(req.sid)
        if self.record_outcomes:
            self._missed_tick.append(req.sid)

    def _upload(self, *arrays: np.ndarray) -> Tuple[torch.Tensor, ...]:
        """Host arrays (float32, int32, bool) as tensors on the device.  On
        the card they travel in one asynchronous copy from one pinned
        buffer (the caching host allocator keeps the buffer until the copy
        has run), so a tick's inputs cost one transfer and no host wait."""
        if self.device.type != "cuda":
            return tuple(torch.from_numpy(np.ascontiguousarray(a))
                         for a in arrays)
        offs, n = [], 0
        for a in arrays:
            offs.append(n)
            n += -(-a.nbytes // 8) * 8           # 8-byte aligned parts
        host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
        buf = host.numpy()
        for a, o in zip(arrays, offs):
            buf[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(
                np.uint8)
        dev = host.to(self.device, non_blocking=True)
        return tuple(dev[o:o + a.nbytes].view(_TORCH_DTYPES[a.dtype])
                     .view(a.shape) for a, o in zip(arrays, offs))

    def _warm(self) -> None:
        """Run the tick path of every tier once before traffic (the plain
        step, each other skeleton group's step, the fused tick on copies
        of the tier slab and a throwaway ring, the legacy preempt pair)
        and every ordered tier pair's migration, so kernel builds and first
        allocations do not land inside a tick."""
        engine = self._engine
        V, C = self.vmax, self.cfg.gcn_in_channels
        for S, slabs in self._tier_slabs.items():
            zf, zb = self._upload(np.zeros((S, V, C), np.float32),
                                  np.zeros((S,), bool))
            self._step(self.plans, slabs, zf, zb, zb, zb)
            for t in self.topologies[1:]:
                self._step(self._topo_plans[t], slabs, zf, zb, zb, zb,
                           stats=self._topo_stats[t])
            if self.fused:
                wslabs = tuple(_state_copy(s) for s in slabs)
                wrings = tuple(engine.init_snapshot_ring(
                    s, self.snap_capacity) for s in slabs)
                zo, = self._upload(pad_event_orders([], max_events_for(S)))
                self._fused_tick(self.plans, wslabs, zf, zb, zb, zb, zo, zo,
                                 wrings)
            elif self.qos == "preempt":
                snaps = tuple(self._snap_fn(s, 0) for s in slabs)
                tuple(self._rest_fn(s, 0, x) for s, x in zip(slabs, snaps))
        for a in self.tiers:
            for b in self.tiers:
                if a != b:
                    idx = torch.arange(min(a, b), device=self.device)
                    tuple(self._migrate_fn(sa, sb, idx, idx)
                          for sa, sb in zip(self._tier_slabs[a],
                                            self._tier_slabs[b]))
        synchronize(self.device)

    def _migrate_fn(self, src, dst, old_idx, new_idx):
        """Rows ``old_idx`` of slab ``src`` scattered into rows ``new_idx``
        of slab ``dst``; returns the new slab."""
        engine = self._engine
        return engine.restore_slots(dst, new_idx,
                                    engine.snapshot_slots(src, old_idx))

    # -- plan-derived timing --------------------------------------------------

    def flush_frames(self, frames: int) -> int:
        """Flush-drain ticks after a ``frames``-long stream (the per-block
        'same'-padding latency, ``engine.stream_flush_frames``)."""
        return self._engine.stream_flush_frames(self.plans[0], frames)

    @property
    def first_logit_delay(self) -> int:
        """Raw frames from admission to the first valid logit."""
        return self._engine.stream_first_logit_delay(self.plans[0])

    # -- the session protocol -------------------------------------------------

    @property
    def now(self) -> int:
        """The service clock: index of the next tick to run."""
        return self._tick

    @property
    def wall_s(self) -> float:
        """Total serving time inside ``tick()``: host scheduling plus
        forced-readback device waits."""
        return self.wall_host_s + self.wall_device_s

    @property
    def capacity(self) -> int:
        """Current slot capacity (the active tier)."""
        return len(self.sched.slots)

    def open_session(self, *, priority: int = 0,
                     deadline: Optional[int] = None,
                     arrival: Optional[int] = None,
                     topology: Optional[str] = None) -> SessionHandle:
        """Open a new session and enter it into the admission queue.

        Frames arrive via :meth:`submit` and the stream ends with
        :meth:`close` (an admitted session with an empty buffer is held in
        place, never zero-padded).  ``priority`` orders admission and
        selects preemption victims; ``deadline`` is the absolute
        completion-deadline tick under ``qos="deadline"``; ``arrival``
        backdates the queueing clock (defaults to now); ``topology`` is
        the session's skeleton (one of the service's ``topologies``;
        default the primary).  Under ``policy="slo"`` the controller's
        admission gate may reject the open or degrade its stride."""
        topo = topology or self.primary
        if topo not in self._topos:
            raise ValueError(
                f"unknown topology {topo!r} — this service serves "
                f"{self.topologies}; construct it with topologies=(...) "
                "to add a skeleton")
        sid = self._next_sid
        self._next_sid += 1
        req = SessionRequest(
            sid=sid, arrival=self._tick if arrival is None else int(arrival),
            clip=None, priority=priority, deadline=deadline, topology=topo)
        self._sessions[sid] = req
        if self.slo is not None:
            verdict = self.slo.admit(priority)
            if verdict == "reject":
                self._rejected.add(sid)
                self.n_rejected += 1
                if self.record_outcomes:
                    self._shed_tick.append({"sid": sid, "mode": "reject"})
                self._retire(sid)
                return SessionHandle(sid=sid)
            if verdict == "degrade":
                req.degrade = self.slo.degrade_stride_now()
                if self.record_outcomes:
                    self._shed_tick.append(
                        {"sid": sid, "mode": "degrade",
                         "stride": req.degrade})
        self.sched.submit(req)
        return SessionHandle(sid=sid)

    def _req(self, h: SessionHandle) -> SessionRequest:
        try:
            return self._sessions[h.sid]
        except KeyError:
            raise KeyError(f"unknown session handle {h!r}") from None

    def submit(self, h: SessionHandle, frame: np.ndarray) -> None:
        """Append one raw (V, C) skeleton frame to the session's stream
        (a no-op on a rejected session)."""
        if h.sid in self._rejected:
            return
        frame = np.asarray(frame, np.float32)
        req = self._req(h)
        t = req.topology or self.primary
        vt = self._topos[t].num_joints
        if frame.shape != (vt, self.cfg.gcn_in_channels):
            raise ValueError(
                f"expected one ({vt}, {self.cfg.gcn_in_channels}) frame "
                f"for topology {t!r}, got {frame.shape}")
        req.push_frame(frame)

    def submit_clip(self, h: SessionHandle, clip: np.ndarray) -> None:
        """Submit a whole (T, V, C) clip and close the stream (a no-op on
        a rejected session)."""
        if h.sid in self._rejected:
            return
        for frame in np.asarray(clip, np.float32):
            self._req(h).push_frame(frame)
        self.close(h)

    def close(self, h: SessionHandle) -> None:
        """End the session's stream: the scheduler drains the flush latency
        and the final record becomes available via :meth:`poll`."""
        if h.sid in self._rejected:
            return
        self._req(h).close()

    def poll(self, h: SessionHandle, *, wait: bool = False) -> SessionStatus:
        """Non-blocking status: state, progress and the latest logits.

        An active/draining session reports the logits of the most recent
        *forced* tick — None while the last tick's logits are still on the
        device — so polling every tick costs no device wait.
        ``wait=True`` copies the pending logits to the host first (timed
        into ``wall_device_s``)."""
        req = self._req(h)
        rec = self._records.get(h.sid)
        if rec is not None:
            return SessionStatus(
                sid=h.sid, state="done", frames_submitted=req.n_frames(),
                frames_consumed=rec.frames, priority=req.priority,
                logits=rec.logits, record=rec)
        if h.sid in self.sched.missed_sids:
            return SessionStatus(
                sid=h.sid, state="missed", frames_submitted=req.n_frames(),
                frames_consumed=0, priority=req.priority)
        if h.sid in self._rejected:
            return SessionStatus(
                sid=h.sid, state="rejected",
                frames_submitted=req.n_frames(),
                frames_consumed=0, priority=req.priority)
        for s, slot in enumerate(self.sched.slots):
            if slot is not None and slot.req is req:
                stride = max(1, int(req.degrade))
                state = ("active" if slot.rel < req.eff_frames()
                         or not req.is_closed() else "draining")
                if wait:
                    self._force_logits()
                logits = (np.asarray(self._last_logits[s])
                          if isinstance(self._last_logits, np.ndarray)
                          else None)
                return SessionStatus(
                    sid=h.sid, state=state, frames_submitted=req.n_frames(),
                    frames_consumed=min(slot.rel * stride, req.n_frames()),
                    priority=req.priority, logits=logits)
        item = self.sched.queue.get(h.sid)
        consumed = (min(getattr(item, "rel", 0), req.n_frames())
                    if item is not None else 0)
        return SessionStatus(
            sid=h.sid, state="queued", frames_submitted=req.n_frames(),
            frames_consumed=consumed, priority=req.priority)

    def idle(self) -> bool:
        """True when no session is queued or occupying a slot."""
        return self.sched.idle()

    def advance_clock(self, tick: int) -> None:
        """Fast-forward an idle service to ``tick``.  The skipped gap is
        fed to the capacity controller as empty demand — enough to walk
        the tier ladder to the bottom — followed by one migration."""
        if not self.idle():
            raise ValueError("cannot fast-forward a busy service")
        tick = int(tick)
        if self.capman is not None and tick > self._tick:
            cc = self.capman.config
            budget = len(self.tiers) * (cc.shrink_patience + cc.cooldown + 1)
            start = self.capman.capacity
            t = self._tick
            while (t < tick and budget > 0
                   and self.capman.capacity > self.tiers[0]):
                self.capman.observe(0, 0, t)
                t += 1
                budget -= 1
            if self.capman.capacity != start:
                self._migrate(self.capman.capacity)
        elif self.slo is not None and tick > self._tick:
            sc = self.slo.config
            self.slo.idle_reset()
            budget = len(self.tiers) * (sc.recover_patience + sc.cooldown + 1)
            start = self.slo.capacity
            t = self._tick
            while (t < tick and budget > 0
                   and self.slo.capacity > self.tiers[0]):
                self.slo.observe(0, 0, t, queue_age=0)
                t += 1
                budget -= 1
            if self.slo.capacity != start:
                self._migrate(self.slo.capacity)
        self._tick = max(self._tick, tick)

    # -- the serving tick -----------------------------------------------------

    def _force_logits(self) -> Optional[np.ndarray]:
        """Copy the pending tick's logits to the host (once): the one
        device-to-host copy of a tick, made only when a session finishes,
        ``poll(wait=True)`` or ``metrics`` needs it.  Its wait is timed
        into ``wall_device_s``."""
        if (self._last_logits is not None
                and not isinstance(self._last_logits, np.ndarray)):
            t0 = time.monotonic()
            self._last_logits = self._last_logits.cpu().numpy()
            self.wall_device_s += time.monotonic() - t0
            self.readbacks += 1
        return self._last_logits

    def _topology_groups(self) -> List[Tuple[str, np.ndarray]]:
        """Partition the slot table by session topology: ``[(name, (S,)
        bool mask), ...]`` with the primary group first (free slots ride
        the primary); empty non-primary groups are dropped."""
        S = len(self.sched.slots)
        masks = {t: np.zeros(S, bool) for t in self.topologies}
        for s, slot in enumerate(self.sched.slots):
            t = self.primary
            if slot is not None and slot.req.topology:
                t = slot.req.topology
            masks[t][s] = True
        out = [(self.primary, masks[self.primary])]
        out += [(t, masks[t]) for t in self.topologies[1:]
                if masks[t].any()]
        return out

    def _step_groups(self, frames, groups, logits):
        """Step each non-primary skeleton group: one step per group with
        that topology's plans and BN statistics over the shared slab,
        everything outside the group held.  ``groups`` holds (name, valid,
        reset, hold) with the masks on the device.  Returns the last
        step's logits, which cover the whole slab (held rows report their
        running prediction, and the fc head is the same for every
        topology's plans)."""
        for t, valid, reset, hold in groups:
            self.slabs, logits = self._step(
                self._topo_plans[t], self.slabs, frames, valid, reset, hold,
                stats=self._topo_stats[t])
            self.device_dispatches += 1
        return logits

    @torch.inference_mode()
    def tick(self) -> List[SessionRecord]:
        """Run one scheduler tick: capacity decision, QoS policy and
        admissions, one step for all slots (the fused tick when the tick
        has snapshot or restore events, the plain slab step otherwise; the
        legacy sequence when ``fused=False``), drain accounting.  Returns
        the sessions that finished this tick."""
        t0 = time.monotonic()
        dev0 = self.wall_device_s
        if self.capman is not None or self.slo is not None:
            # expired sessions are not demand
            self.sched.sweep_expired(self._tick)
        if self.slo is not None:
            queue_age = max(
                (self._tick - AdmissionQueue._req(it).arrival
                 for it in self.sched.queue), default=0)
            inflight_age = max(
                (slot.admitted + self.sched.first_logit_delay - 1
                 - slot.req.arrival
                 for slot in self.sched.slots
                 if slot is not None and slot.first_logit_tick < 0),
                default=0)
            target = self.slo.observe(
                self.sched.busy(), len(self.sched.queue), self._tick,
                queue_age=queue_age, inflight_age=inflight_age)
            if target is not None and target != self.capacity:
                self._migrate(target)
        elif self.capman is not None:
            target = self.capman.observe(
                self.sched.busy(), len(self.sched.queue), self._tick)
            if target is not None:
                self._migrate(target)
        tp = self.sched.tick_inputs(self._tick, t0)
        outcome = None
        if self.record_outcomes:
            # pure host ints: the per-tick shape the golden replays lock,
            # taken right after tick_inputs
            outcome = {
                "tick": self._tick,
                "capacity": self.capacity,
                "busy": self.sched.busy(),
                "queued": len(self.sched.queue),
                "admitted": sorted(
                    self.sched.slots[s].req.sid
                    for s in np.flatnonzero(tp.reset)
                    if self.sched.slots[s] is not None),
                "restored": sorted(sid for _, sid in tp.restore),
                "preempted": sorted(sid for _, sid in tp.snapshot),
                "held": int(tp.hold.sum()),
                "shed": self._shed_tick,
            }
            self._shed_tick = []
        # mixed-skeleton slab: the primary group takes the events and the
        # free slots, every other group is stepped afterwards with its own
        # plans; reset is group-masked (step_frames resets before the hold)
        groups = (self._topology_groups()
                  if len(self.topologies) > 1 else None)
        valid, reset, hold = tp.valid, tp.reset, tp.hold
        host = []
        if groups is not None:
            mp = groups[0][1]
            valid, reset, hold = valid & mp, reset & mp, hold | ~mp
            for _, m in groups[1:]:
                host += [tp.valid & m, tp.reset & m, tp.hold | ~m]
        events = bool(tp.snapshot or tp.restore)
        orders = ([tp.snap_order, tp.rest_order]
                  if self.fused and events else [])
        t_dispatch = time.monotonic()
        frames, valid, reset, hold, *rest = self._upload(
            tp.frames, valid, reset, hold, *orders, *host)
        if orders:
            snap_order, rest_order, *rest = rest
        group_masks = [(t, *rest[3 * i: 3 * i + 3])
                       for i, (t, _) in enumerate((groups or [])[1:])]
        if self.fused:
            if events:
                self.slabs, logits, self._rings = self._fused_tick(
                    self.plans, self.slabs, frames, valid, reset, hold,
                    snap_order, rest_order, self._rings)
            else:
                self.slabs, logits = self._step(
                    self.plans, self.slabs, frames, valid, reset, hold)
            self.device_dispatches += 1
            logits = self._step_groups(frames, group_masks, logits)
            self.wall_dispatch_s += time.monotonic() - t_dispatch
            self._last_logits = logits          # on the device until forced
            # a session finishing this tick needs its logits row now
            if any(slot is not None and not slot.held
                   and slot.total is not None and slot.rel == slot.total - 1
                   for slot in self.sched.slots):
                self._force_logits()
        else:
            for s, sid in tp.snapshot:      # capture before restore/step
                self._snaps[sid] = tuple(self._snap_fn(slab, s)
                                         for slab in self.slabs)
                self.device_dispatches += len(self.slabs)
            for s, sid in tp.restore:
                snaps = self._snaps.pop(sid)
                self.slabs = tuple(self._rest_fn(slab, s, sn)
                                   for slab, sn in zip(self.slabs, snaps))
                self.device_dispatches += len(self.slabs)
            self.slabs, logits = self._step(
                self.plans, self.slabs, frames, valid, reset, hold)
            self.device_dispatches += 1
            logits = self._step_groups(frames, group_masks, logits)
            self.wall_dispatch_s += time.monotonic() - t_dispatch
            self._last_logits = logits
            self._force_logits()                 # legacy: synchronous tick
        done = self.sched.tick_outputs(self._tick, self._last_logits,
                                       time.monotonic())
        for rec in done:
            self._records[rec.sid] = rec
            self._sessions[rec.sid].release_frames()
            self._retire(rec.sid)
        if outcome is not None:
            outcome["finished"] = sorted(r.sid for r in done)
            outcome["missed"] = sorted(self._missed_tick)
            self._missed_tick = []
            self.outcomes.append(outcome)
        self.tier_ticks[self.capacity] += 1
        self._tick += 1
        dt = time.monotonic() - t0
        self.wall_host_s += dt - (self.wall_device_s - dev0)
        self._tick_ms.append(dt * 1e3)
        return done

    def run_until_idle(self, max_ticks: int = 100_000) -> int:
        """Tick until every queued/active session has drained; returns the
        number of ticks run.  Raises if the budget is exhausted (an open
        session that is never closed holds its slot forever)."""
        n = 0
        while not self.idle():
            if n >= max_ticks:
                raise RuntimeError(
                    f"service did not drain within {max_ticks} ticks — "
                    "is an open session missing its close()?")
            self.tick()
            n += 1
        return n

    # -- elastic migration ----------------------------------------------------

    @torch.inference_mode()
    def _migrate(self, new_S: int) -> None:
        """Hop capacity tiers: compact the scheduler slot table, gather the
        occupied rows out of the live slabs and scatter them into the
        pristine target-tier slabs.  The gather/scatter is fixed-shape
        (``min(S_old, S_new)`` rows, occupied first, then free rows, whose
        stale content lands in free target slots that the admission reset
        zeroes before reuse)."""
        t0 = time.monotonic()
        S_old = self.capacity
        occupied = [s for s, slot in enumerate(self.sched.slots)
                    if slot is not None]
        mapping = self.sched.resize(new_S)
        free = [s for s in range(S_old) if s not in mapping]
        k = min(S_old, new_S)
        old_idx = torch.as_tensor((occupied + free)[:k], dtype=torch.int64,
                                  device=self.device)
        new_idx = torch.arange(k, device=self.device)
        self.slabs = tuple(
            self._migrate_fn(slab, nsl, old_idx, new_idx)
            for slab, nsl in zip(self.slabs, self._tier_slabs[new_S]))
        synchronize(self.device)
        # _last_logits is not remapped: _migrate runs only inside tick()
        # (or on an idle service), which overwrites it before a poll
        ctrl = self.capman if self.capman is not None else self.slo
        if ctrl is not None and ctrl.events:
            ctrl.events[-1].wall_ms = (time.monotonic() - t0) * 1e3

    # -- cross-replica migration ----------------------------------------------

    @torch.inference_mode()
    def export_session(self, h: SessionHandle) -> Dict:
        """Drain one live session out of this service so another service
        can adopt it.  Returns a host-side package: the session's scheduler
        item (the request, or the in-flight slot bookkeeping) plus
        per-stream numpy snapshots of its device state (the shape of
        ``engine.snapshot_slots``; None when it was never admitted).  The
        session stops existing here; bystander slots are untouched.
        Finished or missed sessions cannot be exported."""
        engine = self._engine
        to_host = lambda tree: engine._tree_map(       # noqa: E731
            lambda t: t.cpu().numpy(), tree)
        req = self._req(h)
        sid = h.sid
        if sid in self._records or sid in self.sched.missed_sids:
            raise ValueError(
                f"session {sid} already finished — nothing to export")
        item: Any = None
        snaps: Optional[Tuple] = None
        for s, slot in enumerate(self.sched.slots):
            if slot is not None and slot.req is req:
                # active: its live state is slab row s; the slot is freed
                # (the admission reset zeroes the stale row before reuse)
                snaps = tuple(to_host(self._snap_fn(slab, s))
                              for slab in self.slabs)
                self.sched.slots[s] = None
                item = slot
                break
        if item is None:
            item = self.sched.queue.remove(sid)
            if item is None:
                raise ValueError(f"session {sid} is in no exportable state")
            if item is not req:
                # a preempted slot awaiting re-admission: its state is a
                # ring row (fused) or a held snapshot (legacy)
                if self.fused:
                    row = self.sched.ring_release(sid)
                    snaps = tuple(
                        engine._tree_map(lambda leaf: leaf[row].cpu().numpy(),
                                         ring)
                        for ring in self._rings)
                else:
                    snaps = tuple(to_host(sn)
                                  for sn in self._snaps.pop(sid))
        self._sessions.pop(sid, None)
        return {"item": item, "snaps": snaps}

    @torch.inference_mode()
    def import_session(self, package: Dict) -> SessionHandle:
        """Adopt a session exported from another service: its scheduler
        item re-enters the admission queue under a fresh local sid, and a
        package carrying device snapshots first writes them into a
        snapshot-ring row (fused) or the held snapshots (legacy), so the
        next admission restores it like a local preemption resume."""
        engine = self._engine
        item = package["item"]
        snaps = package["snaps"]
        req = item if isinstance(item, SessionRequest) else item.req
        if req.topology and req.topology not in self._topos:
            raise ValueError(
                f"cannot adopt a {req.topology!r} session — this service "
                f"serves {self.topologies}")
        sid = self._next_sid
        self._next_sid += 1
        req.sid = sid
        self._sessions[sid] = req
        if snaps is not None:
            if self.fused:
                row = self.sched.ring_adopt(sid)
                self._rings = tuple(
                    engine._tree_map(lambda r, sv: _set_row(r, row, sv),
                                     ring, sn)
                    for ring, sn in zip(self._rings, snaps))
            else:
                self._snaps[sid] = tuple(
                    engine._tree_map(lambda sv: torch.as_tensor(
                        np.asarray(sv), device=self.device), sn)
                    for sn in snaps)
        self.sched.queue.push(item)
        return SessionHandle(sid=sid)

    # -- metrics --------------------------------------------------------------

    def metrics(self, *, keep_records: Optional[int] = None) -> Dict:
        """Aggregate serving metrics over everything served so far — the
        JAX service's row (fps, per-priority latency p50/p99, occupancy,
        first-logit delay, QoS and elastic accounting, recent
        :class:`SessionRecord`\\ s under ``"records"``) plus ``device``,
        ``readbacks`` (forced logit copies), ``wall_dispatch_s`` (the part
        of ``wall_host_s`` spent issuing the upload and the steps; the
        rest is the scheduler's) and the per-tick host wall time
        ``tick_ms_p50``/``tick_ms_mean`` over the retention window.
        ``keep_records`` bounds the returned record list (``0`` drops
        it).  Reading metrics forces any pending logits first."""
        self._force_logits()
        sched, wall = self.sched, self.wall_s
        recs = list(sched.completed)
        lat = np.asarray([r.wall_finished - r.wall_admitted for r in recs])
        first = np.asarray([r.wall_first_logit - r.wall_admitted
                            for r in recs if r.wall_first_logit >= 0])
        no_first = sum(r.wall_first_logit < 0 for r in recs)
        by_prio: Dict[str, Dict[str, float]] = {}
        for p in sorted({r.priority for r in recs}):
            pl = np.asarray([r.wall_finished - r.wall_admitted
                             for r in recs if r.priority == p])
            pt = np.asarray([r.finished - r.arrival
                             for r in recs if r.priority == p], np.float64)
            ft = np.asarray([r.first_logit_tick - r.arrival
                             for r in recs
                             if r.priority == p and r.first_logit_tick >= 0],
                            np.float64)
            by_prio[str(p)] = {
                "n": int(len(pl)),
                "p50_ms": float(np.percentile(pl, 50) * 1e3),
                "p99_ms": float(np.percentile(pl, 99) * 1e3),
                "e2e_p50_ticks": float(np.percentile(pt, 50)),
                "e2e_p99_ticks": float(np.percentile(pt, 99)),
                "first_logit_p50_ticks": (float(np.percentile(ft, 50))
                                          if len(ft) else -1.0),
                "first_logit_p99_ticks": (float(np.percentile(ft, 99))
                                          if len(ft) else -1.0),
                "degraded": int(sum(r.degrade > 1 for r in recs
                                    if r.priority == p)),
            }
        n_missed = sched.n_missed
        ticks = self._tick
        occ_busy = float(sched.occ_sum / max(sched.occ_ticks, 1))
        occ_time = float(sched.occ_sum / max(ticks, 1))
        ctrl = self.capman if self.capman is not None else self.slo
        events = ctrl.events if ctrl is not None else []
        tick_ms = np.asarray(self._tick_ms)
        out = {
            "backend": self.backend,
            "device": self.device.type,
            "slots": self.tiers[0],
            "mesh": 1,
            "topologies": ",".join(self.topologies),
            "joints": self.vmax,
            "qos": self.qos,
            "policy": self.policy,
            "capacity": ("fixed" if len(self.tiers) == 1 else
                         "elastic:" + ",".join(str(t) for t in self.tiers)),
            "sessions": sched.n_completed,
            "ticks": ticks,
            "wall_s": wall,
            "wall_host_s": self.wall_host_s,
            "wall_device_s": self.wall_device_s,
            "wall_dispatch_s": self.wall_dispatch_s,
            "tick_path": "fused" if self.fused else "legacy",
            "device_dispatches": self.device_dispatches,
            "readbacks": self.readbacks,
            "tick_ms_p50": (float(np.percentile(tick_ms, 50))
                            if len(tick_ms) else 0.0),
            "tick_ms_mean": float(tick_ms.mean()) if len(tick_ms) else 0.0,
            "frames_per_s": sched.valid_frames / wall if wall > 0 else 0.0,
            "ticks_per_s": ticks / wall if wall > 0 else 0.0,
            "occupancy": occ_time,
            "occupancy_busy": occ_busy,
            "latency_ms_p50": (float(np.percentile(lat, 50) * 1e3)
                               if len(lat) else 0.0),
            "latency_ms_p99": (float(np.percentile(lat, 99) * 1e3)
                               if len(lat) else 0.0),
            "latency_ms_by_priority": by_prio,
            "first_logit_ms_p50": (float(np.percentile(first, 50) * 1e3)
                                   if len(first) else 0.0),
            "first_logit_frames": self.first_logit_delay,
            "sessions_no_first_logit": int(no_first),
            "queue_wait_ticks_mean": (sched.qwait_sum / sched.n_completed
                                      if sched.n_completed else 0.0),
            "preemptions": sched.preemptions,
            "restores": sched.restores,
            "deadline_missed": n_missed,
            "deadline_miss_rate": (
                n_missed / (n_missed + sched.n_completed)
                if (n_missed + sched.n_completed) else 0.0),
            "capacity_final": self.capacity,
            "migrations": len(events),
            "migrations_grow": sum(e.new > e.old for e in events),
            "migrations_shrink": sum(e.new < e.old for e in events),
            "migration_ms_mean": (float(np.mean([e.wall_ms for e in events]))
                                  if events else 0.0),
            "resize_events": [[e.tick, e.old, e.new] for e in events],
            "tier_ticks": {str(S): n for S, n in self.tier_ticks.items()},
            "records": (recs if keep_records is None
                        else recs[len(recs) - min(keep_records, len(recs)):]),
        }
        # the adaptive-streaming axes ride the row only when enabled;
        # bench_key defaults the absent keys to off
        if getattr(self.cfg, "use_ck", False):
            out["ck"] = True
        if self.saliency is not None:
            gate = self.saliency
            out["saliency"] = gate.config.threshold
            out["frames_scored"] = gate.frames_scored
            out["frames_skipped"] = gate.frames_skipped
            out["frames_skipped_finished"] = sched.frames_skipped
            out["skip_rate"] = (gate.frames_skipped / gate.frames_scored
                                if gate.frames_scored else 0.0)
            out["sessions_per_slot_tick"] = (
                sched.n_completed / (self.capacity * max(sched.occ_ticks, 1)))
        if self.slo is not None:
            out["slo_target_p99_ticks"] = self.slo.config.target_p99_ticks
            out["shed_mode"] = self.slo.config.shed_mode
            out["shed_rejected"] = self.slo.shed_rejected
            out["shed_degraded"] = self.slo.shed_degraded
            out["shed_windows"] = self.slo.shed_windows
            out["sessions_rejected"] = self.n_rejected
            out["sessions_degraded"] = int(
                sum(r.degrade > 1 for r in recs))
        return out


# ---------------------------------------------------------------------------
# the batch serving driver (serve sessions / BENCH rows)
# ---------------------------------------------------------------------------

def run_sessions(
    cfg,
    *,
    slots: int = 8,
    n_sessions: int = 16,
    mean_interarrival: float = 8.0,
    lengths: Optional[Sequence[int]] = None,
    backend: str = "cuda",
    quant: bool = True,
    seed: int = 0,
    max_ticks: int = 100_000,
    qos: str = "fifo",
    preempt_ratio: float = 0.25,
    deadline_slack: int = 25,
    priorities: Optional[Sequence[int]] = None,
    capacity_tiers: Optional[Sequence[int]] = None,
    load: str = "poisson",
    fused: bool = True,
    policy: str = "demand",
    slo_config: Optional[SloConfig] = None,
    topology: Optional[str] = None,
    rng: Optional[np.random.Generator] = None,
    use_ck: bool = False,
    saliency_thresh: float = 0.0,
    device: DeviceLike = None,
) -> Dict:
    """Serve ``n_sessions`` generated skeleton sessions through a
    :class:`GcnService` with the two-stream (joint + bone) ensemble: each
    arrival becomes ``open_session`` + ``submit_clip`` and idle stretches
    fast-forward the service clock.  The arguments are the JAX
    package's ``run_sessions`` (without ``mesh``) plus ``device``:
    ``capacity_tiers`` makes the service elastic, ``load`` picks the
    arrival process (``"poisson"`` | ``"burst"``), ``preempt_ratio`` the
    high-priority mix under every policy, ``deadline_slack`` the deadline
    past each session's minimal service time under ``qos="deadline"``,
    ``topology`` the served skeleton, ``use_ck`` the windowed C_k graph and
    ``saliency_thresh`` the saliency gate.  Returns
    :meth:`GcnService.metrics` with ``load`` added."""
    from repro_torch.data.pipeline import DataConfig, skeleton_batches

    tiers = tuple(capacity_tiers) if capacity_tiers else (slots,)
    if use_ck and not cfg.use_ck:
        cfg = dataclasses.replace(cfg, use_ck=True)
    svc = GcnService(cfg, backend=backend, qos=qos, capacity_tiers=tiers,
                     policy=policy, slo_config=slo_config,
                     topologies=(topology,) if topology else ("ntu25",),
                     quant=quant, seed=seed, fused=fused,
                     saliency_thresh=saliency_thresh, device=device)

    if lengths is None:
        lengths = (cfg.gcn_frames, max(2, cfg.gcn_frames // 2))
    # clips at the served skeleton's own joint count (the scheduler pads
    # them to the slab width at tick time)
    vt = svc._topos[svc.primary].num_joints
    cfg_clips = (dataclasses.replace(cfg, gcn_joints=vt)
                 if vt != cfg.gcn_joints else cfg)
    pool = np.asarray(next(skeleton_batches(
        cfg_clips, DataConfig(global_batch=n_sessions,
                              seq_len=cfg.gcn_frames,
                              seed=seed + 1)))["x"])

    def clip_source(sid: int, T: int) -> np.ndarray:
        return pool[sid % len(pool), :T]

    if load == "burst":
        reqs = bursty_arrivals(
            n_sessions, lengths, vt, cfg.gcn_in_channels,
            burst_gap=max(1.0, mean_interarrival / 8.0),
            lull_gap=mean_interarrival * 8.0,
            seed=seed, clip_source=clip_source, priorities=priorities,
            high_priority_ratio=preempt_ratio, rng=rng)
    elif load == "poisson":
        reqs = poisson_arrivals(
            n_sessions, mean_interarrival, lengths,
            vt, cfg.gcn_in_channels, seed=seed,
            clip_source=clip_source, priorities=priorities,
            high_priority_ratio=preempt_ratio, rng=rng)
    else:
        raise ValueError(f"unknown load {load!r} (poisson | burst)")
    if qos == "deadline":
        for r in reqs:
            r.deadline = (r.arrival + len(r.clip)
                          + svc.flush_frames(len(r.clip)) + deadline_slack)

    pending = deque(reqs)
    while svc.now < max_ticks:
        while pending and pending[0].arrival <= svc.now:
            r = pending.popleft()
            h = svc.open_session(priority=r.priority, deadline=r.deadline,
                                 arrival=r.arrival)
            svc.submit_clip(h, r.clip)
        if svc.idle():
            if not pending:
                break
            svc.advance_clock(pending[0].arrival)
            continue
        svc.tick()

    out = svc.metrics()
    out["load"] = load
    return out
