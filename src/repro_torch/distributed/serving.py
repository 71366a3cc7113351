"""Mesh-sharded session serving: the slab tick split over a 1-D slot
mesh.  Port of ``repro.distributed.serving``.

The paper's throughput story — every layer resident, runtime-compressed
features, many streams at once — caps out at one device's slab capacity.
This module scales the *slot axis*: a 1-D mesh splits the session slab's
leading S axis into contiguous shards of S/n slots, and
``GcnService(mesh=...)`` runs one slab step per shard on its device while
the host scheduler stays the single-device scheduler (slots are global
indices).

The JAX tier is one SPMD program and XLA inserts its collectives.  Here
one process addresses every device explicitly (not ``torch.distributed``,
whose ranks would each need their own scheduler), and the collectives
become device-to-device copies: snapshot-ring rows (the ring lives on the
mesh's first device), the rows of a tier migration, and the tick's logits
gathered to the first device when they are read.

A mesh may be logical: ``make_batch_mesh(n, device="cpu")`` or
``device="cuda:0"`` gives n shards on one device (the counterpart of
JAX's ``--xla_force_host_platform_device_count``), which is how the CPU
tests and a one-card run exercise a real mesh.  :func:`collective_cost_ms`
measures what the split costs per tick (``collective_ms_per_tick`` of
``BENCH_torch_sessions.json``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, canonical_device
from repro_torch.common.tree import tree_map

BATCH_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class BatchMesh:
    """A 1-D slot mesh: ``devices[j]`` holds shard j (a device may repeat:
    logical shards on one device)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (BATCH_AXIS,)

    @property
    def size(self) -> int:
        """The number of shards."""
        return len(self.devices)


def make_batch_mesh(n_devices: Optional[int] = None, *,
                    device: DeviceLike = None) -> BatchMesh:
    """Build the 1-D slot mesh under the single axis ``"data"``.

    Without ``device`` (or with ``"cuda"``, no index: the cards) it takes
    the first ``n_devices`` visible CUDA devices (default all of them) and
    raises ``RuntimeError`` when fewer are visible; nothing falls back to
    the CPU.  With one device (e.g. ``"cpu"`` or ``"cuda:0"``) it gives
    ``n_devices`` (default 1) logical shards on that device."""
    if device is None or torch.device(device) == torch.device("cuda"):
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = visible if n_devices is None else int(n_devices)
        if visible < max(n, 1):
            raise RuntimeError(
                f"asked for a {max(n, 1)}-device mesh but "
                f"torch.cuda.device_count() is {visible}; pass device='cpu' "
                "or device='cuda:0' for logical shards on one device")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    else:
        n = 1 if n_devices is None else int(n_devices)
        devices = (canonical_device(device),) * n
    if n < 1:
        raise ValueError(f"mesh needs at least 1 device, got {n}")
    return BatchMesh(devices=devices)


def _timed_ms(fn: Callable[[], None], devices: Sequence[torch.device],
              iters: int) -> float:
    """ms per call of ``fn`` over ``iters`` calls after one warm-up: CUDA
    events on every CUDA device it runs on (the slowest device's span),
    the host clock on the CPU."""
    fn()
    cuda = [d for d in dict.fromkeys(devices) if d.type == "cuda"]
    if not cuda:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    marks = []
    for d in cuda:
        torch.cuda.synchronize(d)
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record(torch.cuda.current_stream(d))
        marks.append(ev)
    for _ in range(iters):
        fn()
    for d, ev in zip(cuda, marks):
        ev[1].record(torch.cuda.current_stream(d))
    for _, end in marks:
        end.synchronize()
    return max(a.elapsed_time(b) for a, b in marks) / iters


@torch.inference_mode()
def collective_cost_ms(svc, iters: int = 16) -> float:
    """Per-tick cost of splitting the slab step over the service's mesh,
    in ms: the service's own sharded no-event step (one slab step per
    shard) minus one slab step over the same slab content gathered into
    one S-slot slab on the mesh's first device, floored at 0 — the
    ``collective_ms_per_tick`` column of the sharded
    ``BENCH_torch_sessions.json`` rows.  CUDA events on the card, the host
    clock on the CPU.  On a mesh of logical shards on one device there is
    no interconnect: the number is what issuing n smaller steps costs over
    one.  Run on an idle service (the slab is read, not rebound)."""
    from repro_torch.core.agcn import engine
    from repro_torch.train.steps import make_gcn_slab_step

    n, S = len(svc.slabs), svc.capacity
    w, dev0 = S // n, svc.device
    V, C = svc.vmax, svc.cfg.gcn_in_channels
    zs = svc._upload_shards([[np.zeros((w, V, C), np.float32),
                              np.zeros((w,), bool)] for _ in range(n)])

    def sharded() -> None:
        for j, (zf, zb) in enumerate(zs):
            svc._step(svc._plans_at(j), svc.slabs[j], zf, zb, zb, zb)

    idx = torch.arange(w)
    whole = []
    for i in range(len(svc.plans)):
        rows = [engine.snapshot_slots(sh[i], idx.to(sh[i].t_raw.device))
                for sh in svc.slabs]
        whole.append(dataclasses.replace(svc.slabs[0][i], **tree_map(
            lambda *xs: torch.cat([x.to(dev0) for x in xs]), *rows)))
    zf1, zb1 = svc._upload(np.zeros((S, V, C), np.float32),
                           np.zeros((S,), bool))
    step = make_gcn_slab_step(svc.cfg)

    def single() -> None:
        step(svc.plans, tuple(whole), zf1, zb1, zb1, zb1)

    sharded_ms = _timed_ms(sharded, svc._shard_devs, iters)
    single_ms = _timed_ms(single, [dev0], iters)
    return max(0.0, sharded_ms - single_ms)


def run_sharded_sessions(cfg, *, mesh: int, **kwargs) -> Dict:
    """Serve a session load with the slab split over a ``mesh``-shard
    batch mesh: :func:`repro_torch.serving.run_sessions` with the mesh
    axis set (the mesh is built on its ``device``); the returned row
    carries ``mesh`` and ``collective_ms_per_tick``."""
    from repro_torch.serving import run_sessions

    return run_sessions(cfg, mesh=int(mesh), **kwargs)
