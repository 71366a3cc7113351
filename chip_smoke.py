#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and the CUDA toolkit's nvcc; imports
only torch, numpy and ``repro_torch``.  Phases, in order:

  1. device  — the card's name and power limit (nvidia-smi), torch and
               CUDA versions.  TF32 is switched off for matmul and cuDNN,
               so every comparison below is in full float32.
  2. build   — the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
               process per source, in parallel), with ptxas's register and
               spill report.
  3. kernels — one ensemble step of the main path (full agcn-2s, batch 8)
               is run with recording wrappers, so each kernel is held
               against its plain version on exactly the inputs the path
               gives it (graph_sconv and cavity_tconv within
               atol=rtol=1e-4, RFC bit-equal), plus an RFC case with
               C % 16 != 0.  Each kernel is timed with CUDA events beside
               its plain version, a one-call PyTorch yardstick where one
               exists, and its bound on this card.
  4. main    — ``serve_gcn`` at the full agcn-2s config (batch 8, a few
               batches) on the ``cuda`` and ``reference`` backends: clips/s,
               logit agreement within atol=rtol=1e-3, and the launch
               counts (20 graph_sconv, 20 cavity_tconv, 18 rfc_encode and
               18 rfc_decode per ensemble step).
  5. profile — two ``cuda`` ensemble steps under ``torch.profiler``: the
               device's busy share of the wall time and device time by
               kernel name (reported, not checked; the profiler's own cost
               inflates the wall time).

Prints the kernels JSON line, the nvidia-smi line and, last, the result
line.  Any failed phase exits non-zero.  Per-case kernel numbers go to
``build/chip_smoke_cases.json`` (git-ignored).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 rate and float32 rate outside the
# tensor cores (the kernels use plain float32 FMAs)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

KERNEL_INFO = {   # name -> (CUDA source, TPU kernel it replaces)
    "graph_sconv": ("src/repro_torch/csrc/graph_sconv.cu",
                    "src/repro/kernels/graph_sconv.py:52"),
    "cavity_tconv": ("src/repro_torch/csrc/cavity_tconv.cu",
                     "src/repro/kernels/cavity_tconv.py:99"),
    "rfc_encode": ("src/repro_torch/csrc/rfc_pack.cu",
                   "src/repro/kernels/rfc_pack.py:67"),
    "rfc_decode": ("src/repro_torch/csrc/rfc_pack.cu",
                   "src/repro/kernels/rfc_pack.py:87"),
}
ARCH, BATCH, CLIPS, SEED = "agcn-2s", 8, 32, 0


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back
    calls, by CUDA events, after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def capture_step(modules, cfg, plans, x):
    """Run one ensemble step with each kernel wrapper wrapped by a recorder;
    returns {kernel: [(args, kwargs), ...]} with cloned tensor inputs."""
    import torch
    from repro_torch.train.steps import make_gcn_infer_step
    gs, ct, rp = modules
    targets = [(gs, "graph_sconv_cuda", "graph_sconv"),
               (ct, "cavity_tconv_cuda", "cavity_tconv"),
               (rp, "rfc_encode_cuda", "rfc_encode"),
               (rp, "rfc_decode_cuda", "rfc_decode")]
    captured = {name: [] for _, _, name in targets}
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def recorder(orig, name):
        def rec(*args, **kwargs):
            captured[name].append((
                tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                dict(kwargs)))
            return orig(*args, **kwargs)
        return rec

    try:
        for (mod, attr, orig), (_, _, name) in zip(originals, targets):
            setattr(mod, attr, recorder(orig, name))
        make_gcn_infer_step(cfg)(plans, x)
        torch.cuda.synchronize()
    finally:
        for mod, attr, orig in originals:
            setattr(mod, attr, orig)
    return captured


def measure_case(name, args, kwargs, modules):
    """Kernel vs plain on one captured input: error, pass/fail, times and
    the bound on this card."""
    import torch
    import torch.nn.functional as F
    gs, ct, rp = modules
    library = None
    if name == "graph_sconv":
        x, g, w = args
        kern = lambda: gs.graph_sconv_cuda(x, g, w)
        plain = lambda: gs.graph_sconv_plain(x, g, w)
        library = lambda: torch.einsum("rvc,kwv,kco->rwo", x, g, w)
        R, V, Cin = x.shape
        K, _, Cout = w.shape
        nbytes = 4 * (x.numel() + g.numel() + w.numel() + R * V * Cout)
        flops = 2 * R * K * (V * V * Cin + V * Cin * Cout)
    elif name == "cavity_tconv":
        xp, wp, taps = args
        ks, stride = kwargs["kernel_size"], kwargs["stride"]
        kern = lambda: ct.cavity_tconv_cuda(xp, wp, taps, ks, stride)
        plain = lambda: ct.cavity_tconv_plain(xp, wp, taps, ks, stride)
        L, n_keep, C, Fg = wp.shape
        # masked dense weights of the same filters, filter f = g + L*i
        w_dense = torch.zeros(L * Fg, C, ks, device=xp.device)
        for g, row in enumerate(taps.tolist()):
            for j, off in enumerate(row):
                w_dense[g::L, :, off] += wp[g, j].T
        x4 = xp.permute(0, 2, 1).unsqueeze(-1).contiguous()
        w4 = w_dense.unsqueeze(-1)
        library = lambda: F.conv2d(x4, w4, stride=(stride, 1))
        B, T_pad, _ = xp.shape
        T_out = (T_pad - ks + 1) // stride
        # the (filter, tap) pairs this data needs: packed slots with weights
        pairs = int((wp != 0).any(dim=2).sum())
        nbytes = 4 * (xp.numel() + wp.numel() + taps.numel()
                      + B * T_out * L * Fg)
        flops = 2 * B * T_out * C * pairs
    elif name == "rfc_encode":
        (x,) = args
        kern = lambda: rp.rfc_encode_cuda(x)
        plain = lambda: rp.rfc_encode_plain(x)
        nbytes, flops = 12 * x.numel(), x.numel()
    else:
        values, hot = args
        kern = lambda: rp.rfc_decode_cuda(values, hot)
        plain = lambda: rp.rfc_decode_plain(values, hot)
        nbytes, flops = 12 * values.numel(), values.numel()

    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    if name.startswith("rfc"):
        ok = all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        ok = all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
                 for a, b in zip(got, want))
    if name == "cavity_tconv":
        # the yardstick computes the same sums in natural filter order
        ref = library()[..., 0].permute(0, 2, 1)
        flat = got[0].reshape(ref.shape[0], ref.shape[1], -1)
        n = ref.shape[2]
        perm = torch.arange(n, device=ref.device).reshape(-1, L).T.reshape(-1)
        ok = ok and torch.allclose(flat, ref[..., perm], atol=1e-4, rtol=1e-4)
    elif library is not None:
        ok = ok and torch.allclose(got[0], library(), atol=1e-4, rtol=1e-4)
    b_ms, t_bytes, t_ops = bound_ms(nbytes, flops)
    return {
        "shape": [list(a.shape) for a in args if hasattr(a, "shape")],
        "stride": kwargs.get("stride"), "ok": bool(ok), "max_abs_err": err,
        "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain, reps=3, inner=3),
        "library_ms": cuda_ms(library) if library is not None else None,
        "bound_ms": b_ms, "bytes_ms": t_bytes, "ops_ms": t_ops,
    }


def profile_steps(step, plans, x, steps: int = 2) -> None:
    """Print the device's busy share and its time by kernel name over
    ``steps`` ensemble steps, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step(plans, x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(plans, x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []   # device-side events only: operator rows repeat their kernels
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count / steps, e.key))
    if not rows:
        print("profile: the profiler recorded no device time (not measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile: {wall_ms:.3f} ms wall per ensemble step under the "
          f"profiler, device busy {busy:.3f} ms ({busy / wall_ms * 100:.1f}%), "
          f"{sum(r[1] for r in rows):.0f} kernels and copies per step")
    for ms, count, key in rows[:15]:
        print(f"profile: {ms:8.3f} ms {count:5.0f}x {key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != SRC:
        fail(f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import init_params
    from repro_torch.core.pruning.plan import plan_from_config
    from repro_torch.data.pipeline import DataConfig, skeleton_batches
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cavity_tconv as ct
    from repro_torch.kernels import graph_sconv as gs
    from repro_torch.kernels import rfc_pack as rp
    from repro_torch.launch.serve import serve_gcn
    modules = (gs, ct, rp)

    # ---- 1. device ---------------------------------------------------------
    smi = smi_line()
    dev = torch.device("cuda")
    print(f"device: {smi}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for matmul and cuDNN (full float32 comparisons)")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib, log = _build.build()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"build: {line.strip()}")

    # ---- 3. kernels against their plain versions ---------------------------
    cfg = get_config(ARCH)
    gen = torch.Generator().manual_seed(SEED)
    params = [init_params(cfg, gen, device=dev) for _ in ("joint", "bone")]
    prune_plan = plan_from_config(cfg)
    plans = tuple(engine.build_execution_plan(
        p, cfg, prune_plan, quant=True, backend="cuda") for p in params)
    dcfg = DataConfig(global_batch=BATCH, seq_len=cfg.gcn_frames, seed=SEED)
    x0 = torch.from_numpy(next(skeleton_batches(cfg, dcfg))["x"]).to(dev)
    captured = capture_step(modules, cfg, plans, x0)
    nblocks = len(cfg.gcn_channels)
    per_step = {"graph_sconv": 2 * nblocks, "cavity_tconv": 2 * nblocks,
                "rfc_encode": 2 * (nblocks - 1),
                "rfc_decode": 2 * (nblocks - 1)}
    failures, cases, summary = [], {}, {}
    for name in _build.KERNELS:
        if len(captured[name]) != per_step[name]:
            failures.append(f"{name}: one step made {len(captured[name])} "
                            f"calls, expected {per_step[name]}")
        cases[name] = [measure_case(name, a, k, modules)
                       for a, k in captured[name]]
        bad = [i for i, c in enumerate(cases[name]) if not c["ok"]]
        if bad:
            failures.append(f"{name}: kernel disagrees with its plain version "
                            f"on cases {bad}")
        cs = cases[name]
        t_bytes = sum(c["bytes_ms"] for c in cs)
        t_ops = sum(c["ops_ms"] for c in cs)
        summary[name] = {
            "max_abs_err": max(c["max_abs_err"] for c in cs),
            "ms": sum(c["ms"] for c in cs),
            "plain_ms": sum(c["plain_ms"] for c in cs),
            "bound_ms": sum(c["bound_ms"] for c in cs),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": (sum(c["library_ms"] for c in cs)
                           if cs[0]["library_ms"] is not None else None),
        }
        s = summary[name]
        print(f"kernel {name}: {'ok' if not bad else 'FAIL'} on "
              f"{len(cs)} main-path inputs, max_abs_err {s['max_abs_err']:.3g}; "
              f"per ensemble step {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
              f"library {s['library_ms']}, bound {s['bound_ms']:.4f} ms by "
              f"{s['bound_by']})")
    # RFC off the main path: a width that is not a whole number of banks
    xr = torch.randn(2400 * 25, 38, generator=gen).to(dev)
    vals, hot = ops.rfc_encode(xr)
    pv, ph = rp.rfc_encode_plain(torch.nn.functional.pad(xr, (0, 10)))
    rt = ops.rfc_decode(vals, hot)
    torch.cuda.synchronize()
    rfc_pad_ok = (torch.equal(vals, pv[:, :38]) and torch.equal(hot, ph[:, :38])
                  and torch.equal(rt, torch.relu(xr)))
    print(f"kernel rfc C=38 (padded to 48): {'ok' if rfc_pad_ok else 'FAIL'}")
    if not rfc_pad_ok:
        failures.append("rfc: C % 16 != 0 case is not bit-equal")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_cases.json").write_text(json.dumps(
        {"device": smi, "cases": cases}, indent=1))
    del captured

    # ---- 4. the main path --------------------------------------------------
    _build.reset_launch_counts()
    res = serve_gcn(ARCH, reduced=False, batch=BATCH, clips=CLIPS, seed=SEED,
                    backends=("cuda", "reference"), device=dev)
    counts = dict(_build.LAUNCHES)
    steps = res["cuda"]["steps"]
    for name, n in per_step.items():
        if counts[name] != n * steps:
            failures.append(f"{name}: {counts[name]} launches in {steps} "
                            f"ensemble steps, expected {n * steps}")
    lc, lr = res["cuda"]["logits"], res["reference"]["logits"]
    rows = CLIPS * cfg.gcn_persons             # persons fold into the batch
    if lc.shape != (rows, cfg.gcn_num_classes) or not np.isfinite(lc).all():
        failures.append(f"cuda logits: shape {lc.shape} or not finite")
    diff = float(np.abs(lc - lr).max())
    if not np.allclose(lc, lr, atol=1e-3, rtol=1e-3):
        failures.append(f"cuda vs reference logits differ by {diff:.3g}")
    agree = float(np.mean(res["cuda"]["top1"] == res["reference"]["top1"]))
    for name in ("cuda", "reference"):
        print(f"main: backend={name} {res[name]['clips_per_s']:.2f} clips/s "
              f"counted as skeleton sequences, as serve does ({CLIPS} clips x "
              f"{cfg.gcn_persons} persons, batch {BATCH}, full {ARCH}, "
              f"2-stream)")
    print(f"main: max |logit difference| {diff:.3g}, top-1 agreement "
          f"{agree * 100:.1f}%, launches {counts} in {steps} steps")

    # ---- 5. profile ----------------------------------------------------------
    from repro_torch.train.steps import make_gcn_infer_step
    profile_steps(make_gcn_infer_step(cfg), plans, x0)

    if failures:
        for f in failures:
            print(f"chip_smoke: FAIL: {f}", file=sys.stderr)
        return 1
    kernels = [{
        "name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
        "replaces": KERNEL_INFO[name][1], "launches": counts[name],
        "launches_per_step": per_step[name], **summary[name],
    } for name in _build.KERNELS]
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
