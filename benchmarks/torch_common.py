"""Shared helpers of the port's benches: the counterpart of
``benchmarks/common.py`` for ``repro_torch``.  Imports torch, numpy and
``repro_torch`` only.

``emit`` prints a ``name,us_per_call,derived`` CSV row and appends it to
``ROWS``; the harness (``benchmarks/torch_run.py``) drains a module's rows
into ``BENCH_torch_<module>.json``.  ``time_fn`` is the median of
synchronised host-clock calls.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Sequence

import torch

from repro_torch.common.device import synchronize

ROWS: List[Dict] = []

# --smoke (benchmarks.torch_run): one timed call, no warm-up, and the
# measured axes cut as the JAX harness's smoke tier cuts them.  Smoke
# timings are not comparable across runs.
SMOKE = False


def _device_of(args) -> torch.device:
    return next((a.device for a in args if isinstance(a, torch.Tensor)),
                None)


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5,
            device=None) -> float:
    """Median µs of ``fn(*args)``, each call synchronised with ``device``
    (default: the device of the first tensor argument)."""
    if SMOKE:
        warmup, iters = 0, 1
    dev = device if device is not None else _device_of(args)
    for _ in range(warmup):
        fn(*args)
    synchronize(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        synchronize(dev)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] * 1e6


def emit(name: str, us: float, derived: str = "") -> None:
    """Print one CSV row and keep it in :data:`ROWS`."""
    ROWS.append({"name": name, "us_per_call": round(us, 1),
                 "derived": derived})
    print(f"{name},{us:.1f},{derived}")


def drain_rows() -> List[Dict]:
    """Return and clear the collected rows (one module's snapshot)."""
    rows, ROWS[:] = list(ROWS), []
    return rows


def demo_prune_plan(cfg, params):
    """The benches' canonical pruning plan (``common.demo_prune_plan``):
    magnitude selection from the spatial weights, half the channels kept
    from block 1 on, cav-70-1, input skip 2."""
    from repro_torch.core.pruning.plan import build_prune_plan

    sw = [b["Wk"].detach().cpu().numpy() for b in params["blocks"]]
    fracs = [1.0] + [0.5] * (len(cfg.gcn_channels) - 1)
    return build_prune_plan(sw, cfg.gcn_channels, fracs, "cav-70-1",
                            input_skip=2)


def parse_backends(argv: Sequence[str]) -> tuple:
    """The shared ``--backend`` axis over ``engine.BACKENDS`` (default
    ``both``).  Unknown flags are tolerated: modules run under the
    harness's argv."""
    from repro_torch.core.agcn.engine import BACKENDS

    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--backend", default="both", choices=(*BACKENDS, "both"))
    args, _ = ap.parse_known_args(argv)
    return BACKENDS if args.backend == "both" else (args.backend,)


def parse_setup(argv: Sequence[str]) -> argparse.Namespace:
    """The shared ``--device`` (default CUDA) and ``--reduced`` flags;
    unknown flags are tolerated."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--device", default=None)
    ap.add_argument("--reduced", action="store_true")
    args, _ = ap.parse_known_args(argv)
    return args


def device_name(dev: torch.device) -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``cpu``: the
    caveat every measured row carries."""
    dev = torch.device(dev)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
