"""The paper's Tables IV/V on the port: the analytic op counts of the
FLOP-reduction chain original → w/o C → +skip → +prune, the paper's
published figures, and measured throughput of the four variants on the
card, beside the serving axes (clip, stream, sessions, preemption,
elastic migration, trace replay, the fused tick, C_k × saliency).  The
counterpart of ``benchmarks/throughput.py``.

    PYTHONPATH=src python -m benchmarks.torch_throughput \\
        [--reduced] [--device cuda|cpu] [--backend cuda|reference|both]

``throughput/gop/*`` is the paper's accounting: GOP (2 ops per
multiply-add) of one clip of the dense model, skips credited to the
accelerator.  ``throughput/paper/*`` prints the paper's Tables IV/V as
published: an FPGA (XCKU-115) against two GPUs (RTX 2080Ti, V100), so each
ratio is between numbers taken on different hardware.
``throughput/measured/table4/<backend>/<variant>/b{1,16}`` runs each
variant's ExecutionPlans through ``engine.execute`` at full ``agcn-2s`` on
the paper's clip (T 300, V 25, 2 persons folded into the batch), b clips
a call: fps through one stream and through the two-stream ensemble, the
step's FLOPs and bytes as ``launch.op_cost`` counts them with the bound on
``launch.roofline``'s H100 terms (the counted eager-traffic share), and
the analytic GOP beside them (the two counts follow different
conventions; both are printed) with the model's minimal bound: the
analytic GOP and the plans, clips and logits moved once (the model
share).  The axes
below it are the JAX module's, on the card.  Times are medians of
synchronised host-clock calls; every measured row names the device.
"""
from __future__ import annotations

import dataclasses
import gc
import pathlib
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmarks import torch_common as common
from benchmarks.torch_common import (device_name, emit, parse_backends,
                                     parse_setup, time_fn)
from repro_torch.common.device import resolve_device, synchronize
from repro_torch.configs import get_config

# The paper's published figures (Tables IV/V): fps of 2s-AGCN on its
# XCKU-115 FPGA accelerator and on two GPUs, for the original model, w/o
# C_k (woC) and w/o C_k with input skip (skip); the FPGA's peak GOP/s.
PAPER = {
    "ours_fpga_fps": 271.25,
    "2080ti_fps": 29.53, "v100_fps": 69.38,
    "2080ti_woC": 45.42, "v100_woC": 98.87,
    "2080ti_skip": 104.0, "v100_skip": 199.09,
    "peak_gops": 1142.0,
}
PAPER_HARDWARE = {"ours": "XCKU-115 FPGA", "2080ti": "RTX 2080Ti",
                  "v100": "V100"}
# the paper's columns each measured variant stands beside
PAPER_COLUMNS = {
    "original": ("2080ti_fps", "v100_fps"),
    "woC": ("2080ti_woC", "v100_woC"),
    "woC+skip": ("2080ti_skip", "v100_skip"),
    "woC+skip+prune": ("ours_fpga_fps",),
}

CHANNELS = (64, 64, 64, 64, 128, 128, 128, 256, 256, 256)
STRIDES = (1, 1, 1, 1, 2, 1, 1, 2, 1, 1)
DROP1 = [1.0, 0.6, 0.6, 0.55, 0.5, 0.5, 0.45, 0.4, 0.35, 0.3]
# the analytic chain's keyword arguments of agcn_gops per variant
VARIANTS = {
    "original": dict(use_ck=True),
    "woC": dict(use_ck=False),
    "woC+skip": dict(use_ck=False, input_skip=2),
    "woC+skip+prune": dict(use_ck=False, input_skip=2, keep=DROP1,
                           cav_keep=0.3),
}
TABLE4_BATCHES = (1, 16)
TRACE = (pathlib.Path(__file__).resolve().parent.parent / "tests" / "data"
         / "traces" / "smoke.json")
# The smoke tier (``common.SMOKE``) cuts the served traffic, never the
# model: the fused tick at S 4 (JAX's smoke S), the trace's first
# SMOKE_TRACE_EVENTS events, and C_k × saliency at S 4 over
# SMOKE_CK_SESSIONS sessions of SMOKE_CK_LENGTHS frames.  It cuts further
# than JAX's tier (7 events; 8 sessions of T and T/2 frames at S 16): at
# full width every served session costs its length plus the stream's
# flush (77 frames) in ticks of 10-30 ms on the card.
SMOKE_TRACE_EVENTS = 2
SMOKE_CK_SESSIONS, SMOKE_CK_LENGTHS = 2, (8, 4)


def agcn_gops(kv=3, V=25, T=300, persons=2, use_ck=True, input_skip=1,
              keep=None, cav_keep=1.0):
    """Multiply-add count (GOP, 2 ops per MAC) for one clip."""
    cin, t = 3, T // input_skip
    total = 0.0
    for b, cout in enumerate(CHANNELS):
        kc = keep[b] if keep else 1.0
        cin_eff = max(1, int(cin * kc))
        # graph matmul: kv × (t·V·V·cin_eff)  — skipped channels drop out
        total += 2 * kv * t * V * V * cin_eff
        # spatial 1x1: kv × t·V·cin_eff·cout
        total += 2 * kv * t * V * cin_eff * cout
        if use_ck:
            ce = max(4, cin // 4)
            total += 2 * (2 * t * V * cin * ce + V * V * ce * t)
        t //= STRIDES[b]
        # temporal 9x1 conv with coarse (next block keep) + fine (cavity)
        kf = keep[b + 1] if keep and b + 1 < len(CHANNELS) else 1.0
        total += 2 * t * V * cout * int(cout * kf) * 9 * cav_keep
        cin = cout
    total += 2 * CHANNELS[-1] * 60
    return total * persons / 1e9


def analytic_rows() -> Dict[str, float]:
    """Emit ``throughput/gop/*`` (the reduction chain) and
    ``throughput/paper/*`` (the published figures); returns GOP per
    variant."""
    gops = {name: agcn_gops(**kw) for name, kw in VARIANTS.items()}
    g0 = gops["original"]
    for name, g in gops.items():
        emit(f"throughput/gop/{name}", 0.0,
             f"GOP={g:.2f} reduction={(1 - g / g0) * 100:.1f}%")
    fpga = PAPER["ours_fpga_fps"]
    for key in ("2080ti_fps", "v100_fps", "2080ti_woC", "v100_woC",
                "2080ti_skip", "v100_skip"):
        hw = PAPER_HARDWARE[key.split("_")[0]]
        emit(f"throughput/paper/{key}", 0.0,
             f"fps={PAPER[key]} (paper Tables IV/V, {hw}) "
             f"fpga/{hw}={fpga / PAPER[key]:.2f}x (the paper's "
             f"{PAPER_HARDWARE['ours']} {fpga} fps against {hw}: "
             f"both published, different hardware)")
    emit("throughput/paper/peak_gops", 0.0,
         f"GOP/s={PAPER['peak_gops']} (paper Table V, "
         f"{PAPER_HARDWARE['ours']}, published)")
    return gops


# ---------------------------------------------------------------------------
# Table IV measured: the four variants on the card
# ---------------------------------------------------------------------------

def variant_config(cfg, variant: str):
    """(config, prune plan, quant) of one Table IV variant on ``cfg``:
    ``original`` (C_k, no skip, no pruning), ``woC``, ``woC+skip`` (input
    skip 2) and ``woC+skip+prune`` (``plan_from_config``: Drop-1 or the
    config's fractions, cav-70-1, skip 2, Q8.8 weights)."""
    from repro_torch.core.pruning.plan import plan_from_config

    if variant == "woC+skip+prune":
        fracs = cfg.prune_channel_fracs or tuple(
            DROP1[:len(cfg.gcn_channels)])
        vcfg = dataclasses.replace(cfg, use_ck=False, input_skip=2,
                                   prune_channel_fracs=fracs,
                                   cavity_pattern="cav-70-1")
        return vcfg, plan_from_config(vcfg), True
    kw = VARIANTS[variant]
    vcfg = dataclasses.replace(cfg, use_ck=kw["use_ck"],
                               input_skip=kw.get("input_skip", 1))
    return vcfg, None, False


def table4_clips(cfg, batch: int, dev: torch.device) -> torch.Tensor:
    """``batch`` of the data pipeline's skeleton clips, persons folded
    into the batch: (batch · persons, T, V, C) on ``dev``."""
    from repro_torch.data.pipeline import DataConfig, skeleton_batches

    x = next(skeleton_batches(cfg, DataConfig(
        global_batch=batch, seq_len=cfg.gcn_frames, seed=0)))["x"]
    return torch.as_tensor(x, device=dev)


def table4(dev: torch.device, *, reduced: bool = False,
           backends: Sequence[str] = ("cuda",), iters: int = 5,
           counted=None) -> List[Dict]:
    """Emit ``throughput/measured/table4/<backend>/<variant>/b<N>`` for
    every variant, backend and batch of :data:`TABLE4_BATCHES`; returns one
    dict a row with the measured and counted numbers (``fps_stream``,
    ``fps_ensemble``, ``ms_ensemble``, ``counted_flops``,
    ``counted_bytes``, ``analytic_gop``...) and two bounds on the H100's
    terms: ``bound_ms`` (by ``bound_by``) on the counted eager step, every
    intermediate's reads and writes included, with ``eager_share`` of it
    reached; ``model_bound_ms`` (by ``model_bound_by``) on the model's
    minimal work, the analytic GOP of the two streams and the plans'
    tensors, the clips and the logits moved once (``model_bytes``), with
    ``model_share``.  ``counted(row, step)``, when
    given, is called before the timing with ``step`` running one ensemble
    call (a launch counter reads the kernels it runs)."""
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import init_params
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_F32
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.launch.roofline import roofline_terms
    from repro_torch.train.steps import make_gcn_infer_step

    base = get_config("agcn-2s", reduced=reduced)
    paper_model = base.gcn_channels == CHANNELS
    note = device_name(dev)
    out = []
    for variant in VARIANTS:
        cfg, prune, quant = variant_config(base, variant)
        gen = torch.Generator().manual_seed(0)
        params = [init_params(cfg, gen, device=dev) for _ in range(2)]
        infer = make_gcn_infer_step(cfg)
        gop = (agcn_gops(**VARIANTS[variant], T=cfg.gcn_frames,
                         V=cfg.gcn_joints, persons=cfg.gcn_persons)
               if paper_model else None)
        for backend in backends:
            plans = tuple(engine.build_execution_plan(
                p, cfg, prune, quant=quant, backend=backend) for p in params)
            for b in TABLE4_BATCHES:
                x = table4_clips(cfg, b, dev)
                if counted is not None:
                    counted(f"{backend}/{variant}/b{b}",
                            lambda: infer(plans, x))
                with torch.inference_mode():
                    t_s = time_fn(engine.execute, plans[0], x, iters=iters)
                    t_e = time_fn(infer, plans, x, iters=iters)
                    with OpCost() as c:
                        logits = infer(plans, x)
                    synchronize(dev)
                cost = c.analyze()
                model_flops = (gop or 0.0) * 1e9 * b * 2
                model_bytes = (sum(_nbytes(p.arrays) for p in plans)
                               + _nbytes(x) + _nbytes(logits))
                terms = roofline_terms(cost, model_flops, 1,
                                       model_bytes_total=model_bytes)
                bound_s = max(terms["t_compute_s"], terms["t_memory_s"],
                              terms["t_collective_s"])
                ms_e = t_e / 1e3
                fps_s, fps_e = b / (t_s * 1e-6), b / (t_e * 1e-6)
                row = {
                    "backend": backend, "variant": variant, "batch": b,
                    "rows": int(x.shape[0]), "ms_stream": t_s / 1e3,
                    "ms_ensemble": ms_e, "fps_stream": fps_s,
                    "fps_ensemble": fps_e, "counted_flops": cost["flops"],
                    "counted_bytes": cost["bytes"], "ops": cost["ops"],
                    "bound_ms": bound_s * 1e3,
                    "bound_by": ("operations" if terms["dominant"]
                                 == "compute" else "bytes"),
                    "eager_share": bound_s * 1e3 / ms_e,
                    "model_flops": model_flops, "model_bytes": model_bytes,
                    "model_bound_ms": terms["ideal_s"] * 1e3,
                    "model_bound_by": (
                        "operations" if model_flops / PEAK_FLOPS_F32
                        > model_bytes / HBM_BW else "bytes"),
                    "model_share": terms["ideal_s"] * 1e3 / ms_e,
                    "analytic_gop": gop, "device": note,
                }
                out.append(row)
                per = 1.0 / (b * 2)           # one clip through one stream
                a_txt = (f"analytic_GOP_per_clip={gop:.3f} "
                         f"analytic_GOP/s={gop * fps_s:.1f}"
                         if gop is not None
                         else "analytic_GOP n/a (reduced widths)")
                paper = " ".join(
                    f"ensemble/{PAPER_HARDWARE[k.split('_')[0]]}="
                    f"{fps_e / PAPER[k]:.2f}x" for k in PAPER_COLUMNS[variant])
                emit(f"throughput/measured/table4/{backend}/{variant}/b{b}",
                     t_e,
                     f"fps_stream={fps_s:.2f} fps_ensemble={fps_e:.2f} "
                     f"counted_GFLOP_per_clip={cost['flops'] * per / 1e9:.3f} "
                     f"counted_GB_per_clip={cost['bytes'] * per / 1e9:.4f} "
                     f"{a_txt} (H100: {PEAK_FLOPS_F32:.3g} FLOP/s float32, "
                     f"{HBM_BW:.3g} B/s) counted eager-traffic "
                     f"bound_ms={row['bound_ms']:.4f} by {row['bound_by']} "
                     f"eager_share={row['eager_share']:.4f}; model "
                     f"(analytic GOP, plans+clips+logits "
                     f"{model_bytes / 1e6:.2f} MB) "
                     f"bound_ms={row['model_bound_ms']:.4f} by "
                     f"{row['model_bound_by']} "
                     f"model_share={row['model_share']:.4f} "
                     f"rows={row['rows']} ({note}); paper fps as ratios of "
                     f"different hardware: {paper}")
            del plans
        del params
    return out


def _nbytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a tensor, dict or sequence)."""
    from repro_torch.common.tree import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def table4_names(backends: Sequence[str] = ("cuda",)) -> List[str]:
    """The row names :func:`table4` emits."""
    return [f"throughput/measured/table4/{be}/{v}/b{b}"
            for v in VARIANTS for be in backends for b in TABLE4_BATCHES]


# ---------------------------------------------------------------------------
# the measured serving axes
# ---------------------------------------------------------------------------

def measured_axes(dev: torch.device, *, reduced: bool = False,
                  backends: Sequence[str] = ("cuda",)) -> None:
    """Emit the JAX module's measured axes on ``dev``: clip, stream,
    sessions at S 4 and 16, preempt against fifo, grow 4→8 and shrink
    8→4, the trace replay, the fused tick and C_k × saliency (the smoke
    tier cuts the last three's traffic, see :data:`SMOKE_TRACE_EVENTS`)."""
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import init_params

    cfg = get_config("agcn-2s", reduced=reduced)
    note = device_name(dev)
    params = init_params(cfg, seed=0, device=dev)
    x = torch.randn((8, cfg.gcn_frames, cfg.gcn_joints, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    for backend in backends:
        ep = engine.build_execution_plan(params, cfg, quant=True,
                                         backend=backend)
        with torch.inference_mode():
            _engine_axes(ep, backend, cfg, x, note)
            _trace_replay_axis(ep, backend, cfg, x, note)
            _tick_fused_axis(ep, backend, cfg, x, note)
        _ck_saliency_axis(backend, cfg, dev, note)


def axis_names(backends: Sequence[str] = ("cuda",),
               smoke: bool = False) -> List[str]:
    """The row names :func:`measured_axes` emits."""
    from repro_torch.serving import Trace

    trace = Trace.load(str(TRACE)).name + (
        f"-head{SMOKE_TRACE_EVENTS}" if smoke else "")
    out = []
    for be in backends:
        m = f"throughput/measured/{{}}/{be}"
        out += [m.format("clip"), m.format("stream"),
                *(m.format("sessions") + f"/{s}" for s in
                  ("S4", "S16", "S4_preempt", "grow_4to8", "shrink_8to4")),
                *(m.format("trace_replay") + f"/{trace}/{p}"
                  for p in ("demand", "slo")),
                *(m.format("tick_fused") + f"/S{S}/{k}/{wl}"
                  for S in ((4,) if smoke else (16, 64, 256))
                  for wl in ("fifo", "preempt") for k in ("legacy", "fused")),
                *(m.format("ck_saliency") + f"/S{4 if smoke else 16}"
                  f"/ck{ck}/sal{sal}" for ck in (0, 1) for sal in (0, 1))]
    return out


def _engine_axes(ep, backend, cfg, x, note) -> None:
    from repro_torch.core.agcn import engine

    dev = x.device
    t = time_fn(engine.execute, ep, x, iters=3)
    emit(f"throughput/measured/clip/{backend}", t,
         f"clips_per_s={x.shape[0] / (t * 1e-6):.1f} ({note})")
    bn = engine.collect_bn_stats(ep, x)
    st = engine.init_stream_state(ep, x.shape[0], bn_stats=bn)
    ts = time_fn(engine.step_frame, ep, st, x[:, 0], True, iters=3)
    emit(f"throughput/measured/stream/{backend}", ts,
         f"frames_per_s={x.shape[0] * 1e6 / ts:.1f} "
         f"clip_equiv_us={ts * cfg.gcn_frames:.0f} ({note})")
    shape = (cfg.gcn_joints, cfg.gcn_in_channels)
    for S in (4, 16):
        slab = engine.init_session_slab(ep, S, bn_stats=bn)
        frames = torch.zeros((S, *shape), device=dev)
        valid = torch.as_tensor(np.arange(S) % 2 == 0, device=dev)
        reset = torch.as_tensor(np.arange(S) == 0, device=dev)
        tS = time_fn(engine.step_frames, ep, slab, frames, valid, reset,
                     iters=3)
        n_act = int(valid.sum())
        emit(f"throughput/measured/sessions/{backend}/S{S}", tS,
             f"frames_per_s={n_act * 1e6 / tS:.1f} "
             f"active={n_act}/{S} per_active_slot_us={tS / n_act:.0f} "
             f"({note})")
    # preempt against fifo: a snapshot of the victim, a restore of the
    # incoming session and the step, against the plain tick
    S = 4
    slab = engine.init_session_slab(ep, S, bn_stats=bn)
    frames = torch.zeros((S, *shape), device=dev)
    valid = torch.as_tensor(np.arange(S) % 2 == 0, device=dev)
    noreset = torch.zeros((S,), dtype=torch.bool, device=dev)
    stored = engine.snapshot_slots(slab, 1)

    def preempt_tick(slab, stored):
        snap = engine.snapshot_slots(slab, 0)
        slab = engine.restore_slots(slab, 0, stored)
        state, logits = engine.step_frames(ep, slab, frames, valid, noreset)
        return state, logits, snap

    # more calls than the other rows: this row is a difference of two
    t_fifo = time_fn(engine.step_frames, ep, slab, frames, valid, noreset,
                     iters=9)
    t_pre = time_fn(preempt_tick, slab, stored, iters=9, device=dev)
    emit(f"throughput/measured/sessions/{backend}/S{S}_preempt", t_pre,
         f"fifo_tick_us={t_fifo:.0f} "
         f"preempt_overhead={(t_pre / t_fifo - 1) * 100:.1f}% "
         f"(snapshot+restore+step, {note})")
    # elastic: the service's fixed-shape tier migration, min(S_old, S_new)
    # rows gathered from one tier and scattered into the other
    slab8 = engine.init_session_slab(ep, 8, bn_stats=bn)
    idx4 = torch.arange(4, dtype=torch.int64, device=dev)

    def migrate(src, dst):
        return engine.restore_slots(dst, idx4,
                                    engine.snapshot_slots(src, idx4))

    t_grow = time_fn(migrate, slab, slab8, iters=9, device=dev)
    t_shrink = time_fn(migrate, slab8, slab, iters=9, device=dev)
    emit(f"throughput/measured/sessions/{backend}/grow_4to8", t_grow,
         f"rows=4 vs_fifo_tick={(t_grow / t_fifo) * 100:.0f}% "
         f"(fixed-shape min(S_old,S_new)-row gather/scatter into a "
         f"pristine tier, {note})")
    emit(f"throughput/measured/sessions/{backend}/shrink_8to4", t_shrink,
         f"rows=4 vs_fifo_tick={(t_shrink / t_fifo) * 100:.0f}% ({note})")


def _paired(fa, fb, warmup: int = 1, iters: int = 5):
    """Interleaved A/B minima (µs): ``fa`` and ``fb`` alternate each
    round, so drift hits both alike; each call ends synchronised (its
    logits are read back), and the collector is kept out of the timed
    rounds."""
    if common.SMOKE:
        warmup, iters = 0, 1
    for _ in range(warmup):
        fa()
        fb()
    ta, tb = [], []
    gc.collect()
    gc.disable()
    try:
        for _ in range(iters):
            t0 = time.perf_counter()
            fa()
            ta.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            fb()
            tb.append(time.perf_counter() - t0)
    finally:
        gc.enable()
    return min(ta) * 1e6, min(tb) * 1e6


def _trace_replay_axis(ep, backend, cfg, x, note) -> None:
    """``throughput/measured/trace_replay``: the smoke trace through a
    (2, 4)-tier ``GcnService`` under ``policy=demand`` and ``slo`` (the
    same traffic, so the difference is the controller)."""
    from repro_torch.core.agcn import engine
    from repro_torch.serving import SloConfig, Trace, replay

    trace = Trace.load(str(TRACE))
    if common.SMOKE:
        n = SMOKE_TRACE_EVENTS
        trace = dataclasses.replace(trace, events=trace.events[:n],
                                    name=f"{trace.name}-head{n}")
    bn = engine.collect_bn_stats(ep, x)
    scfg = SloConfig(target_p99_ticks=45, window=16, breach_patience=2,
                     recover_patience=8, shed_mode="reject")
    for policy in ("demand", "slo"):
        out = replay(cfg, trace, backend=backend, qos="fifo", policy=policy,
                     capacity_tiers=(2, 4),
                     slo_config=scfg if policy == "slo" else None,
                     plans=(ep,), bn_stats=(bn,), device=x.device)
        per_tick = out["wall_s"] * 1e6 / max(out["ticks"], 1)
        hp = out["latency_ms_by_priority"].get("1", {})
        emit(f"throughput/measured/trace_replay/{backend}/{trace.name}"
             f"/{policy}", per_tick,
             f"ticks={out['ticks']} sessions={out['sessions']} "
             f"rejected={out.get('sessions_rejected', 0)} "
             f"hp_first_logit_p99_ticks="
             f"{hp.get('first_logit_p99_ticks', -1.0):.1f} ({note})")


def _tick_fused_axis(ep, backend, cfg, x, note) -> None:
    """``throughput/measured/tick_fused``: the one-call tick
    (``engine.fused_tick`` on event ticks, the plain step otherwise, one
    readback a burst) against the legacy tick (a snapshot and a restore
    call per event, a readback every tick) at the serving slot counts,
    fifo and preempt-heavy."""
    from repro_torch.core.agcn import engine
    from repro_torch.serving.scheduler import max_events_for, pad_event_orders

    dev = x.device
    bn = engine.collect_bn_stats(ep, x)
    for S in ((4,) if common.SMOKE else (16, 64, 256)):
        nticks = 4 if S <= 64 else 2
        pristine = engine.init_session_slab(ep, S, bn_stats=bn)
        frames = torch.zeros((S, cfg.gcn_joints, cfg.gcn_in_channels),
                             device=dev)
        valid = torch.as_tensor(np.arange(S) % 2 == 0, device=dev)
        zeros = torch.zeros((S,), dtype=torch.bool, device=dev)
        E = max_events_for(S)
        # preempt-heavy: the scheduler's whole event budget every tick
        snap_o = torch.as_tensor(pad_event_orders(
            [(i, i) for i in range(E)], E), device=dev)
        rest_o = torch.as_tensor(pad_event_orders(
            [(i, E + i) for i in range(E)], E), device=dev)
        st = {
            "leg": {"slab": pristine,
                    "hot": [engine.snapshot_slots(pristine, i)
                            for i in range(E)]},
            "fus": {"slab": pristine,
                    "ring": engine.init_snapshot_ring(pristine, 2 * E)},
        }

        def run_legacy(preempt):
            s = st["leg"]
            slab, logits = s["slab"], None
            for _ in range(nticks):
                if preempt:
                    for i in range(E):
                        hot = engine.snapshot_slots(slab, i)
                        slab = engine.restore_slots(slab, i, s["hot"][i])
                        s["hot"][i] = hot
                slab, logits = engine.step_frames(ep, slab, frames, valid,
                                                  zeros, zeros)
                logits.cpu()                 # the per-tick readback
            s["slab"] = slab
            return logits

        def run_fused(preempt):
            s = st["fus"]
            slab, logits = s["slab"], None
            for _ in range(nticks):
                if preempt:
                    slab, logits, s["ring"] = engine.fused_tick(
                        ep, slab, frames, valid, zeros, zeros, snap_o,
                        rest_o, s["ring"])
                else:
                    slab, logits = engine.step_frames(ep, slab, frames,
                                                      valid, zeros, zeros)
            s["slab"] = slab
            logits.cpu()                     # one readback a burst
            return logits

        iters = 9 if S <= 16 else (7 if S <= 64 else 5)
        for wl in ("fifo", "preempt"):
            pre = wl == "preempt"
            t_leg, t_fus = _paired(lambda: run_legacy(pre),
                                   lambda: run_fused(pre), iters=iters)
            t_leg /= nticks
            t_fus /= nticks
            emit(f"throughput/measured/tick_fused/{backend}/S{S}/legacy/{wl}",
                 t_leg, f"ticks_per_s={1e6 / t_leg:.1f} ({note})")
            emit(f"throughput/measured/tick_fused/{backend}/S{S}/fused/{wl}",
                 t_fus, f"ticks_per_s={1e6 / t_fus:.1f} "
                 f"speedup_vs_legacy={t_leg / t_fus:.2f}x "
                 f"(one call a tick, one readback a burst, {note})")


def _ck_saliency_axis(backend, cfg, dev, note) -> None:
    """``throughput/measured/ck_saliency``: C_k on/off × saliency gating
    on/off through ``run_sessions`` on the same Poisson traffic (S 16, 32
    sessions of the config's T and T/2 frames; the smoke tier's S 4 and
    :data:`SMOKE_CK_SESSIONS`): frames/s and sessions per slot-tick."""
    from repro_torch.serving import run_sessions

    S, n, lengths = ((4, SMOKE_CK_SESSIONS, SMOKE_CK_LENGTHS) if common.SMOKE
                     else (16, 32, None))
    for ck in (0, 1):
        for sal in (0, 1):
            out = run_sessions(
                cfg, slots=S, n_sessions=n, lengths=lengths,
                mean_interarrival=2.0,
                backend=backend, seed=0, use_ck=bool(ck),
                saliency_thresh=1.05 if sal else 0.0, device=dev)
            per_tick = out["wall_s"] * 1e6 / max(out["ticks"], 1)
            spst = out["sessions"] / (S * max(out["ticks"], 1))
            emit(f"throughput/measured/ck_saliency/{backend}/S{S}"
                 f"/ck{ck}/sal{sal}", per_tick,
                 f"frames_per_s={out['frames_per_s']:.1f} "
                 f"sessions={out['sessions']} ticks={out['ticks']} "
                 f"eff_sessions_per_slot_tick={spst:.4f} "
                 f"skip_rate={out.get('skip_rate', 0.0):.2f} ({note})")


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Emit the analytic rows, the measured Table IV and the measured
    axes (see the module docstring)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    setup = parse_setup(argv)
    backends = parse_backends(argv)
    dev = resolve_device(setup.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    analytic_rows()
    table4(dev, reduced=setup.reduced, backends=backends)
    measured_axes(dev, reduced=setup.reduced, backends=backends)


if __name__ == "__main__":
    main()
