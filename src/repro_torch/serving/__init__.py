"""`repro_torch.serving` — the multi-session GCN serving package, the
port of ``repro.serving`` with the same public names.

* :class:`GcnService` — the session-handle facade
  (``open_session``/``submit``/``poll``/``close`` + ``tick``), owning the
  plans, the per-tier session slabs, QoS and elastic capacity, on the
  card (``device=None``) or the CPU (``device="cpu"``).
* :func:`run_sessions` — the batch driver (Poisson/bursty load through a
  service; the ``serve sessions`` path).
* :class:`SlabScheduler`, :class:`AdmissionQueue`, :class:`TickPlan`,
  :class:`SessionRequest`, :class:`SessionRecord` — scheduling internals
  (host-side, numpy only).
* :class:`CapacityManager`, :class:`CapacityConfig` — demand-driven
  elastic tiers (``policy="demand"``).
* :class:`SloController`, :class:`SloConfig` — the SLO closed loop
  (``policy="slo"``): grow on measured p99 first-logit regression, shed
  (reject/degrade) at the top tier.
* :func:`poisson_arrivals`, :func:`bursty_arrivals`,
  :class:`TrafficConfig`, :class:`TraceGenerator`, :func:`generate_trace`
  — load generators and the traffic model.
* :class:`Trace`, :func:`replay`, :func:`outcome_digest` — deterministic
  trace replay (``serve sessions --trace``, the golden digests).
* :func:`write_bench`, :func:`bench_key` — ``BENCH_torch_sessions.json``
  row merge (keyed by device too)."""
from repro_torch.serving.capacity import (CapacityConfig, CapacityManager,
                                          ResizeEvent)
from repro_torch.serving.scheduler import (DEFAULT_BENCH_PATH, QOS_POLICIES,
                                           AdmissionQueue, SessionRecord,
                                           SessionRequest, SlabScheduler,
                                           TickPlan, bench_key,
                                           bursty_arrivals, poisson_arrivals,
                                           write_bench)
from repro_torch.serving.service import (SESSION_STATES, GcnService,
                                         SessionHandle, SessionStatus,
                                         run_sessions)
from repro_torch.serving.slo import (CONTROL_POLICIES, SHED_MODES, SloConfig,
                                     SloController)
from repro_torch.serving.traffic import (LENGTH_DISTS, TRACE_SCHEMA_VERSION,
                                         Trace, TraceEvent, TraceGenerator,
                                         TrafficConfig, event_clip,
                                         generate_trace, outcome_digest,
                                         replay, trace_requests)

__all__ = [
    "AdmissionQueue",
    "CONTROL_POLICIES",
    "CapacityConfig",
    "CapacityManager",
    "DEFAULT_BENCH_PATH",
    "GcnService",
    "LENGTH_DISTS",
    "QOS_POLICIES",
    "ResizeEvent",
    "SESSION_STATES",
    "SHED_MODES",
    "SessionHandle",
    "SessionRecord",
    "SessionRequest",
    "SessionStatus",
    "SlabScheduler",
    "SloConfig",
    "SloController",
    "TRACE_SCHEMA_VERSION",
    "TickPlan",
    "Trace",
    "TraceEvent",
    "TraceGenerator",
    "TrafficConfig",
    "bench_key",
    "bursty_arrivals",
    "event_clip",
    "generate_trace",
    "outcome_digest",
    "poisson_arrivals",
    "replay",
    "run_sessions",
    "trace_requests",
    "write_bench",
]
