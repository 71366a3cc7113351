"""Fault-tolerance monitors, a copy of ``repro.fault.monitor``:

  * HeartbeatMonitor — per-host liveness with grace windows; drives restart
    and elastic re-mesh decisions.
  * StragglerDetector — per-step duration statistics (EWMA + MAD); flags
    hosts whose step times exceed median + k·MAD, the standard mitigation
    trigger (re-shard away / preempt).
  * Both are pure-python state machines over injected timestamps, testable
    without a cluster; ``launch/train.py`` wires them to wall-clock time,
    one entry per rank (each rank's step time gathered every step).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Set


@dataclasses.dataclass
class HeartbeatMonitor:
    num_hosts: int
    timeout_s: float = 60.0
    _last: Dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: Optional[float] = None):
        self._last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: Optional[float] = None) -> List[int]:
        now = time.monotonic() if now is None else now
        return [
            h for h in range(self.num_hosts)
            if now - self._last.get(h, -1e18) > self.timeout_s
        ]

    def healthy(self, now: Optional[float] = None) -> bool:
        return not self.dead_hosts(now)


@dataclasses.dataclass
class StragglerDetector:
    """Median + k·MAD step-time outlier detection with EWMA smoothing."""
    num_hosts: int
    k: float = 4.0
    ewma: float = 0.3
    _t: Dict[int, float] = dataclasses.field(default_factory=dict)

    def record(self, host: int, step_seconds: float):
        prev = self._t.get(host)
        self._t[host] = (
            step_seconds if prev is None
            else (1 - self.ewma) * prev + self.ewma * step_seconds
        )

    def stragglers(self) -> Set[int]:
        if len(self._t) < max(3, self.num_hosts // 2):
            return set()
        vals = sorted(self._t.values())
        med = vals[len(vals) // 2]
        mad = sorted(abs(v - med) for v in vals)[len(vals) // 2]
        cut = med + self.k * max(mad, 0.05 * med)
        return {h for h, v in self._t.items() if v > cut}


@dataclasses.dataclass
class FaultPolicy:
    """What a trainer does when the monitors fire:
       dead host      -> restore the latest checkpoint on the survivors
                         (the re-sharding plan: ``fault/elastic.py``)
       straggler      -> log and request a scheduler swap; training
                         continues, data-parallel work re-balanced by
                         shrinking that host's shard in the next epoch.
    """
    checkpoint_every: int = 100
    max_restarts: int = 10
    elastic: bool = True
