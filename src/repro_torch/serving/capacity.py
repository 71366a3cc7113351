"""Elastic slot-capacity management for the session slab.  Port of
``repro.serving.capacity`` (numpy-free host logic, the same decisions).

Slot capacity S is a slab shape (the per-slot state is allocated at S
rows and every tick steps all of them), so growing and shrinking with
traffic means hopping between **pre-built capacity tiers** — one slab
(and one warmed step) per tier — and migrating the
active sessions' device state across slabs with the same
``engine.snapshot_slots``/``restore_slots`` primitives that QoS preemption
uses.  High-performance GCN serving hinges on keeping compiled capacity
matched to load (cf. arXiv:2305.18710): a fixed small slab queues traffic
peaks, a fixed large slab pays the full-S tick cost through the lulls.

This module is the pure-host *decision* half (unit-testable without a device):
:class:`CapacityManager` watches queue depth + slot occupancy each tick
and emits grow/shrink decisions under hysteresis; the :class:`GcnService`
facade executes them (slab reset + snapshot/restore migration + scheduler
:meth:`~repro_torch.serving.scheduler.SlabScheduler.resize`).

Hysteresis: demand must exceed the current tier for ``grow_patience``
consecutive ticks before growing (to the smallest tier that fits), fit
inside the next smaller tier for ``shrink_patience`` consecutive ticks
before shrinking (one tier at a time), and any resize starts a
``cooldown`` window during which no further resize is considered — so a
grow is never immediately undone by the next tick's lull (no
grow→shrink→grow inside 3 ticks)."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CapacityConfig:
    """Hysteresis knobs for :class:`CapacityManager`.

    ``tiers`` are the available slot capacities (sorted ascending at use);
    ``grow_patience``/``shrink_patience`` are the consecutive-tick
    thresholds demand must hold before a resize fires, and ``cooldown``
    is the post-resize window during which no new decision is taken.
    ``cooldown`` must be ≥ 3 to make the no-thrash guarantee (no
    grow→shrink→grow within 3 ticks) structural."""

    tiers: Tuple[int, ...] = (2, 4, 8, 16)
    grow_patience: int = 2
    shrink_patience: int = 8
    cooldown: int = 4

    def __post_init__(self):
        if len(self.tiers) < 1 or any(t <= 0 for t in self.tiers):
            raise ValueError(f"invalid capacity tiers {self.tiers!r}")
        if len(set(self.tiers)) != len(self.tiers):
            raise ValueError(f"duplicate capacity tiers {self.tiers!r}")
        if self.cooldown < 3:
            raise ValueError("cooldown must be >= 3 ticks (the no-thrash "
                             "hysteresis guarantee)")


@dataclasses.dataclass
class ResizeEvent:
    """One committed capacity change (for metrics / BENCH rows).

    ``wall_ms`` is filled in by the service after it executes the
    migration (snapshot occupied slots → reset target slab → restore)."""

    tick: int
    old: int
    new: int
    busy: int                # active sessions migrated
    queued: int              # queue depth at decision time
    wall_ms: float = 0.0


class CapacityManager:
    """Hysteresis-based grow/shrink decisions over a fixed tier ladder.

    Pure host logic: call :meth:`observe` once per scheduler tick with the
    current busy-slot count and queue depth; it returns the target tier
    capacity when a resize should happen *this tick* (the caller executes
    the migration and must honor the decision), else None.

    Policy: demand = busy + queued.
      grow   — demand > current capacity for ``grow_patience`` consecutive
               ticks → jump to the smallest tier that fits demand (capped
               at the top tier).
      shrink — demand ≤ the next smaller tier for ``shrink_patience``
               consecutive ticks → step down exactly one tier (repeated
               lulls walk down the ladder one cooldown at a time).
      cooldown — for ``cooldown`` ticks after any resize, pressure
               counters are frozen at zero and no decision is taken."""

    def __init__(self, config: CapacityConfig = CapacityConfig(),
                 start_tier: Optional[int] = None):
        self.config = config
        self.tiers: Tuple[int, ...] = tuple(sorted(config.tiers))
        if start_tier is None:
            self._idx = 0
        else:
            if start_tier not in self.tiers:
                raise ValueError(
                    f"start_tier {start_tier} not in tiers {self.tiers}")
            self._idx = self.tiers.index(start_tier)
        self._grow = 0
        self._shrink = 0
        self._cooldown_until = -1
        self.events: List[ResizeEvent] = []

    @property
    def capacity(self) -> int:
        """The current tier's slot capacity."""
        return self.tiers[self._idx]

    def observe(self, busy: int, queued: int, tick: int) -> Optional[int]:
        """One tick's load sample → an optional resize target (slots).

        Must be called before the scheduler's admissions for the tick so a
        grow decision admits queued sessions into the new slots
        immediately.  Returns the new capacity (the caller migrates and
        resizes), or None."""
        if tick < self._cooldown_until:
            return None
        demand = busy + queued
        can_grow = self._idx < len(self.tiers) - 1
        can_shrink = self._idx > 0
        if can_grow and demand > self.capacity:
            self._grow += 1
            self._shrink = 0
        elif can_shrink and demand <= self.tiers[self._idx - 1]:
            self._shrink += 1
            self._grow = 0
        else:
            self._grow = self._shrink = 0
        if self._grow >= self.config.grow_patience:
            target = self._idx + 1
            while (target < len(self.tiers) - 1
                   and self.tiers[target] < demand):
                target += 1
            return self._commit(target, busy, queued, tick)
        if self._shrink >= self.config.shrink_patience:
            return self._commit(self._idx - 1, busy, queued, tick)
        return None

    def _commit(self, idx: int, busy: int, queued: int, tick: int) -> int:
        self.events.append(ResizeEvent(
            tick=tick, old=self.capacity, new=self.tiers[idx],
            busy=busy, queued=queued))
        self._idx = idx
        self._grow = self._shrink = 0
        self._cooldown_until = tick + self.config.cooldown
        return self.capacity
