"""Multi-replica session routing over N :class:`~repro_torch.serving.
GcnService`\\ s.  Port of ``repro.distributed.router``.

One mesh-sharded slab scales slot capacity; replicas scale *dispatch*
(each replica is its own service with its own slab and scheduler, sharing
the first one's plans and BN statistics).  All replicas live in one
process and on the service's device, as in the JAX package.  The router
in front of them owns three things:

* **consistent pinning** — a session opened through the router gets a
  :class:`RouterHandle`; the router remembers which replica holds it, and
  every ``submit``/``poll``/``close`` routes there.  The pin survives
  rebalancing: migration re-points the handle.
* **feedback placement** — new sessions land on the replica with the
  lowest load (busy slots + queue depth; index breaks ties), read fresh
  from each replica at open time (:meth:`ReplicaRouter.feedback`).
* **drain-and-rebalance** — :meth:`ReplicaRouter.rebalance` moves
  sessions from the most- to the least-loaded replica through the host
  round trip ``GcnService.export_session`` → ``import_session``.  A
  migrated session's final logits match its uninterrupted run within
  1e-3, and bystander sessions on both replicas are bit-equal
  (``tests/test_torch_distributed.py``).

The router tick is lockstep: :meth:`ReplicaRouter.tick` advances every
replica's clock by exactly one tick (busy replicas run a real tick, idle
ones fast-forward), so arrival timestamps mean the same thing on every
replica.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.common.device import DeviceLike
from repro_torch.serving import GcnService
from repro_torch.serving.scheduler import bursty_arrivals, poisson_arrivals


@dataclasses.dataclass(frozen=True)
class RouterHandle:
    """Opaque ticket for one routed session: stable across rebalancing
    (the router re-points ``rsid`` at the session's current replica and
    replica-local handle)."""

    rsid: int


class ReplicaRouter:
    """Route sessions across N replica :class:`GcnService` instances.

    Construct with prebuilt services (same config, backend and QoS across
    replicas) or via :meth:`build`, which builds the plans once and
    shares them: replicas 2..N skip plan building and BN calibration."""

    def __init__(self, services: Sequence[GcnService]):
        if not services:
            raise ValueError("router needs at least one replica service")
        self.services: List[GcnService] = list(services)
        ticks = {s.now for s in self.services}
        if len(ticks) != 1:
            raise ValueError(
                f"replica clocks disagree at construction: {sorted(ticks)}")
        self._tick = self.services[0].now
        self._next_rsid = 0
        # rsid -> (replica index, replica-local handle); the one mutable
        # pin rebalancing re-points
        self._where: Dict[int, tuple] = {}
        self.rebalances = 0          # sessions moved across replicas
        self.migration_failures = 0  # rebalance picks that had no mover

    @classmethod
    def build(cls, cfg, *, replicas: int, **service_kwargs) -> "ReplicaRouter":
        """Build ``replicas`` services for one router: the first builds its
        ExecutionPlans and BN calibration, the rest share them (plans are
        read-only; slabs and schedulers stay per replica)."""
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        first = GcnService(cfg, **service_kwargs)
        service_kwargs.pop("plans", None)
        service_kwargs.pop("bn_stats", None)
        rest = [GcnService(cfg, plans=first.plans, bn_stats=first.bn_stats,
                           **service_kwargs)
                for _ in range(replicas - 1)]
        return cls([first] + rest)

    # -- placement ------------------------------------------------------------

    @property
    def now(self) -> int:
        """The router clock (every replica's clock agrees with it)."""
        return self._tick

    def feedback(self) -> List[Dict[str, int]]:
        """Per-replica load feedback: busy slots, queue depth, capacity —
        the placement signal (and the rebalance imbalance measure)."""
        return [{"replica": i, "busy": s.sched.busy(),
                 "queued": len(s.sched.queue), "capacity": s.capacity}
                for i, s in enumerate(self.services)]

    def _load(self, i: int) -> int:
        s = self.services[i]
        return s.sched.busy() + len(s.sched.queue)

    def _place(self) -> int:
        return min(range(len(self.services)),
                   key=lambda i: (self._load(i), i))

    def replica_of(self, h: RouterHandle) -> int:
        """The replica index currently holding ``h`` (the pin)."""
        return self._where[h.rsid][0]

    # -- the session protocol (delegated) --------------------------------------

    def _at(self, h: RouterHandle) -> tuple:
        try:
            rid, inner = self._where[h.rsid]
        except KeyError:
            raise KeyError(f"unknown router handle {h!r}") from None
        return self.services[rid], inner

    def open_session(self, *, priority: int = 0,
                     deadline: Optional[int] = None,
                     arrival: Optional[int] = None,
                     replica: Optional[int] = None) -> RouterHandle:
        """Open a session on the least-loaded replica (or pin it to an
        explicit ``replica``, the manual-placement override) and return
        its router-level handle."""
        rid = self._place() if replica is None else int(replica)
        inner = self.services[rid].open_session(
            priority=priority, deadline=deadline, arrival=arrival)
        h = RouterHandle(rsid=self._next_rsid)
        self._next_rsid += 1
        self._where[h.rsid] = (rid, inner)
        return h

    def submit(self, h: RouterHandle, frame: np.ndarray) -> None:
        """Append one raw (V, C) frame to the session's pinned replica."""
        svc, inner = self._at(h)
        svc.submit(inner, frame)

    def submit_clip(self, h: RouterHandle, clip: np.ndarray) -> None:
        """Submit a whole (T, V, C) clip and close the stream."""
        svc, inner = self._at(h)
        svc.submit_clip(inner, clip)

    def close(self, h: RouterHandle) -> None:
        """End the session's stream on its pinned replica."""
        svc, inner = self._at(h)
        svc.close(inner)

    def poll(self, h: RouterHandle, *, wait: bool = False):
        """Status from the session's pinned replica (the semantics of
        :meth:`GcnService.poll`, including its logits read discipline)."""
        svc, inner = self._at(h)
        return svc.poll(inner, wait=wait)

    # -- lockstep ticking -------------------------------------------------------

    def tick(self) -> None:
        """Advance every replica by exactly one tick: busy replicas run a
        real scheduler tick, idle replicas fast-forward their clock — the
        lockstep keeps arrival timestamps comparable across replicas."""
        nxt = self._tick + 1
        for s in self.services:
            if s.idle():
                s.advance_clock(nxt)
            else:
                s.tick()
        self._tick = nxt

    def idle(self) -> bool:
        """True when every replica is idle."""
        return all(s.idle() for s in self.services)

    def advance_clock(self, tick: int) -> None:
        """Fast-forward every (idle) replica to ``tick``; lulls walk each
        replica's elastic ladder down, as on the single service."""
        for s in self.services:
            s.advance_clock(tick)
        self._tick = max(self._tick, int(tick))

    def run_until_idle(self, max_ticks: int = 100_000) -> int:
        """Tick until every replica drains; returns ticks run."""
        n = 0
        while not self.idle():
            if n >= max_ticks:
                raise RuntimeError(
                    f"router did not drain within {max_ticks} ticks")
            self.tick()
            n += 1
        return n

    # -- drain and rebalance -----------------------------------------------------

    def migrate_session(self, h: RouterHandle, dst: int) -> None:
        """Move one live session to replica ``dst`` through the host
        snapshot round trip: export on the source (slot or queue entry
        plus per-stream device snapshots), import on the destination
        (snapshot upload and re-queue), re-point the pin.  A no-op when
        the session already lives on ``dst``."""
        rid, inner = self._where[h.rsid]
        dst = int(dst)
        if dst == rid:
            return
        package = self.services[rid].export_session(inner)
        new_inner = self.services[dst].import_session(package)
        self._where[h.rsid] = (dst, new_inner)
        self.rebalances += 1

    def _movable_on(self, rid: int) -> Optional[RouterHandle]:
        """A session on ``rid`` that can migrate: prefer queued sessions
        (no slot disruption), fall back to active ones; oldest first."""
        svc = self.services[rid]
        queued = active = None
        for rsid in sorted(self._where):
            r, inner = self._where[rsid]
            if r != rid:
                continue
            state = svc.poll(inner).state
            if state == "queued" and queued is None:
                queued = RouterHandle(rsid=rsid)
            elif state in ("active", "draining") and active is None:
                active = RouterHandle(rsid=rsid)
            if queued is not None:
                break
        return queued or active

    def rebalance(self, threshold: int = 2) -> int:
        """Even out replica load: while the busiest replica carries at
        least ``threshold`` more sessions (busy + queued) than the most
        idle one, drain one session from the former into the latter.
        Returns the number of sessions moved (also accumulated into
        ``self.rebalances``, the bench row's rebalance count)."""
        moved = 0
        while True:
            loads = [self._load(i) for i in range(len(self.services))]
            src = max(range(len(loads)), key=lambda i: (loads[i], -i))
            dst = min(range(len(loads)), key=lambda i: (loads[i], i))
            if loads[src] - loads[dst] < max(1, int(threshold)):
                break
            h = self._movable_on(src)
            if h is None:
                self.migration_failures += 1
                break
            self.migrate_session(h, dst)
            moved += 1
        return moved

    # -- metrics ------------------------------------------------------------------

    def metrics(self) -> Dict:
        """One merged serving row over every replica, the routed
        ``BENCH_torch_sessions.json`` shape: lifetime totals summed,
        occupancy averaged, latency percentiles over the union of the
        replicas' record windows, plus ``replicas``/``rebalances`` and the
        per-replica rows under ``"per_replica"``."""
        per = [s.metrics(keep_records=None) for s in self.services]
        recs = [r for m in per for r in m["records"]]
        lat = np.asarray([r.wall_finished - r.wall_admitted for r in recs])
        wall = sum(m["wall_s"] for m in per)
        frames = sum(s.sched.valid_frames for s in self.services)
        missed = sum(m["deadline_missed"] for m in per)
        done = sum(m["sessions"] for m in per)
        return {
            "backend": per[0]["backend"],
            "device": per[0]["device"],
            "slots": per[0]["slots"],
            "qos": per[0]["qos"],
            "capacity": per[0]["capacity"],
            "mesh": per[0]["mesh"],
            "replicas": len(self.services),
            "rebalances": self.rebalances,
            "sessions": done,
            "ticks": self._tick,
            "wall_s": wall,
            "frames_per_s": frames / wall if wall > 0 else 0.0,
            "occupancy": float(np.mean([m["occupancy"] for m in per])),
            "occupancy_busy": float(np.mean([m["occupancy_busy"]
                                             for m in per])),
            "latency_ms_p50": (float(np.percentile(lat, 50) * 1e3)
                               if len(lat) else 0.0),
            "latency_ms_p99": (float(np.percentile(lat, 99) * 1e3)
                               if len(lat) else 0.0),
            "preemptions": sum(m["preemptions"] for m in per),
            "restores": sum(m["restores"] for m in per),
            "deadline_missed": missed,
            "deadline_miss_rate": (missed / (missed + done)
                                   if (missed + done) else 0.0),
            "migrations": sum(m["migrations"] for m in per),
            "capacity_final": [m["capacity_final"] for m in per],
            "per_replica": [{k: v for k, v in m.items() if k != "records"}
                            for m in per],
            "records": recs,
        }


def run_routed_sessions(
    cfg,
    *,
    replicas: int = 2,
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
    capacity_tiers: Optional[Sequence[int]] = None,
    load: str = "poisson",
    fused: bool = True,
    rebalance_every: int = 16,
    device: DeviceLike = None,
) -> Dict:
    """Serve a generated session load through a :class:`ReplicaRouter`,
    the routed counterpart of :func:`repro_torch.serving.run_sessions`:
    the same arrival processes, clips and QoS wiring, with feedback
    placement at admission and a :meth:`ReplicaRouter.rebalance` sweep
    every ``rebalance_every`` ticks.  ``device`` is every replica's (None:
    CUDA).  Returns the merged :meth:`ReplicaRouter.metrics` row with
    ``load`` added (``replicas``/``rebalances`` are its distributed axes
    in ``BENCH_torch_sessions.json``)."""
    from repro_torch.data.pipeline import DataConfig, skeleton_batches

    tiers = tuple(capacity_tiers) if capacity_tiers else (slots,)
    router = ReplicaRouter.build(
        cfg, replicas=replicas, backend=backend, qos=qos,
        capacity_tiers=tiers, quant=quant, seed=seed, fused=fused,
        device=device)
    svc0 = router.services[0]

    if lengths is None:
        lengths = (cfg.gcn_frames, max(2, cfg.gcn_frames // 2))
    pool = np.asarray(next(skeleton_batches(
        cfg, DataConfig(global_batch=n_sessions, seq_len=cfg.gcn_frames,
                        seed=seed + 1)))["x"])

    def clip_source(sid: int, T: int) -> np.ndarray:
        return pool[sid % len(pool), :T]

    if load == "burst":
        reqs = bursty_arrivals(
            n_sessions, lengths, cfg.gcn_joints, cfg.gcn_in_channels,
            burst_gap=max(1.0, mean_interarrival / 8.0),
            lull_gap=mean_interarrival * 8.0,
            seed=seed, clip_source=clip_source,
            high_priority_ratio=preempt_ratio)
    elif load == "poisson":
        reqs = poisson_arrivals(
            n_sessions, mean_interarrival, lengths,
            cfg.gcn_joints, cfg.gcn_in_channels, seed=seed,
            clip_source=clip_source, high_priority_ratio=preempt_ratio)
    else:
        raise ValueError(f"unknown load {load!r} (poisson | burst)")
    if qos == "deadline":
        for r in reqs:
            r.deadline = (r.arrival + len(r.clip)
                          + svc0.flush_frames(len(r.clip)) + deadline_slack)

    pending = deque(reqs)
    while router.now < max_ticks:
        while pending and pending[0].arrival <= router.now:
            r = pending.popleft()
            h = router.open_session(priority=r.priority, deadline=r.deadline,
                                    arrival=r.arrival)
            router.submit_clip(h, r.clip)
        if router.idle():
            if not pending:
                break
            router.advance_clock(pending[0].arrival)
            continue
        router.tick()
        if rebalance_every and router.now % rebalance_every == 0:
            router.rebalance()

    out = router.metrics()
    out["load"] = load
    return out
