"""Deprecated shim, the port of ``repro.launch.sessions``: the session
stack lives in :mod:`repro_torch.serving`.

    from repro_torch.serving import GcnService, run_sessions, SlabScheduler

Every public name this module used to define resolves lazily from
``repro_torch.serving`` with a :class:`DeprecationWarning`; any other name
raises :class:`AttributeError`.  New code imports from
``repro_torch.serving``."""
from __future__ import annotations

import warnings

_MOVED = (
    "AdmissionQueue",
    "DEFAULT_BENCH_PATH",
    "QOS_POLICIES",
    "SessionRecord",
    "SessionRequest",
    "SlabScheduler",
    "TickPlan",
    "bench_key",
    "bursty_arrivals",
    "poisson_arrivals",
    "run_sessions",
    "write_bench",
)


def __getattr__(name: str):
    """Forward a moved name to ``repro_torch.serving``, with a warning."""
    if name in _MOVED:
        warnings.warn(
            f"repro_torch.launch.sessions.{name} moved to "
            f"repro_torch.serving.{name}; this shim will be removed in a "
            f"future release", DeprecationWarning, stacklevel=2)
        import repro_torch.serving as serving
        return getattr(serving, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    """The forwarded names."""
    return sorted(_MOVED)
