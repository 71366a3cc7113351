"""Where kernels, steps and collectives report their work: the registry of
the cost counters in use.

A counter (``launch.op_cost.OpCost``) pushes itself here while it is
active.  The hand-written kernels are extension calls that a dispatch mode
cannot see, so each kernel wrapper is decorated with :func:`reports_work`,
and the code that issues a collective calls :func:`report_collective`.
Both do nothing when no counter is active.  A counter offers
``kernel(name, flops, nbytes)`` (a context manager that counts one launch
and none of the ops run inside it) and ``collective(kind, nbytes)``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, Optional, Tuple

_ACTIVE: List[Any] = []


def push(counter) -> None:
    """Make ``counter`` the innermost counter in use."""
    _ACTIVE.append(counter)


def pop(counter) -> None:
    """Take ``counter`` off the registry."""
    _ACTIVE.remove(counter)


def active() -> Optional[Any]:
    """The innermost counter in use, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def reports_work(name: str, work: Callable[..., Tuple[float, float]]
                 ) -> Callable:
    """Decorate kernel wrapper ``name``: under an active counter each call
    adds ``work(*args, **kwargs)`` (its ``(flops, bytes)``) as one kernel
    op and hides the aten ops it runs.  Without a counter the wrapper runs
    as it is."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c = active()
            if c is None:
                return fn(*args, **kwargs)
            flops, nbytes = work(*args, **kwargs)
            with c.kernel(name, flops, nbytes):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def report_collective(kind: str, nbytes: float) -> None:
    """Count a collective on the active counter, if any."""
    c = active()
    if c is not None:
        c.collective(kind, nbytes)
