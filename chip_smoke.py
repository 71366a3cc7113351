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
     card_tests — the JAX-free kernel tests, every case marked ``cuda``:
               ``python3 -m pytest -q --noconftest -p no:cacheprovider -m
               cuda tests/test_torch_cuda_kernels.py`` with PYTHONPATH=src;
               fails unless pytest exits 0 with no case skipped, and
               prints the count that passed.
  3. kernels — one clip ensemble step (full agcn-2s, batch 8) and one
               stream tick at S = 1, 3 and 8 slots (after 200 raw frames,
               past the last block's first full window, so every kept tap
               reads data; a cavity_tconv_step input whose kept-tap frames
               are all zero fails) are run with recording wrappers, so each
               kernel is held against its plain version on exactly the
               inputs its path gives it (graph_sconv, cavity_tconv and
               cavity_tconv_step within atol=rtol=1e-4, RFC bit-equal:
               rfc_encode is the block epilogue relu(t + res) fused with
               the encode, and on a stream tick its step form), plus
               rfc_encode without res on the clip step's t, its step form
               with a mixed keep on the S = 8 tick's inputs and an RFC case
               with C % 16 != 0; likewise a clip step of the
               50-joint two-person skeleton (ntu50, persons not folded) on
               a CSR plan (graph_sconv_csr) and a dense one (graph_sconv at
               V = 50), and a clip step and an S = 8 tick (200 frames in) of
               hand21 and body_hand46 on dense plans (graph_sconv at V = 21
               and 46).  Each kernel, its plain version and a one-call
               PyTorch yardstick where one exists are timed on one clock
               (``cuda_ms``): CUDA events around ten back-to-back calls,
               behind a spin kernel sized to outlast the host's measured
               time to queue them (retried with a longer spin after a host
               hiccup), so the events time device work and no host gap;
               the plain versions that read taps on the host wait for the
               device and are timed with their waits (named on the
               ``clock:`` line with any timing three spins did not hide);
               the two RFC kernels, bound by bytes from HBM, are timed on
               rotating copies of their inputs that together exceed twice
               the L2 (at most 64 copies), with their time on one set of inputs beside it (``ms_l2``;
               a stream tick's 64 copies still fit the L2);
               beside them the bound on this card (the four tensor-core
               kernels take the TF32 rate, with the float32 bound and the
               3-pass split's floor beside it).  The ticks of the later
               streams are held the same way in their phases, on the state
               their own run reached 200 frames in.
  4. main    — ``serve_gcn`` at the full agcn-2s config (batch 8, a few
               batches) on the ``cuda`` and ``reference`` backends: clips/s,
               logit agreement within atol=rtol=1e-3, and the launch
               counts (20 graph_sconv, 20 cavity_tconv, 18 rfc_encode and
               18 rfc_decode per ensemble step).
  5. stream  — ``serve_gcn_stream`` at full agcn-2s (batch 4 clips = 8
               sequences, T = 300, then the 149-frame drain) on both
               backends: frames/s and per-step latency, post-drain stream
               logits against the clip engine's and ``cuda`` against
               ``reference`` (atol=rtol=1e-3, top-1 100%), and the launch
               counts of calibration, stream steps and the clip check.
  6. slab    — ``make_gcn_fused_tick`` on ``cuda`` at full width with 8
               slots and a fixed script: 12 staggered sessions of 64
               frames, a held session, a preemption into the snapshot ring
               with a foreign session in the slot, a same-tick snapshot
               and restore, drains.  Each session's logits at eviction
               against the same session streamed alone (atol=rtol=1e-3),
               the launch counts per tick, the tick time, and one tick
               with its inputs on the card under
               ``torch.cuda.set_sync_debug_mode("error")``.
  7. topology — ntu50 at full width: clip steps (batch 8) of CSR plans
               (csr_eps = 1e-5) on ``cuda`` against dense plans on
               ``reference`` and on ``cuda`` (atol=rtol=1e-3, top-1 100%),
               sequences/s of the three, 20 graph_sconv_csr and no
               graph_sconv launch per ensemble step; a stream of the batch
               (300 frames + the drain) on the CSR plans, post-drain logits
               against the clip engine's.  Its S = 8 tick 200 frames in is
               held on the CSR plan (graph_sconv_csr, D = the skeleton's
               degree), a CSR plan with csr_eps = 0 (D = V) and a dense
               plan (graph_sconv at V = 50).
  8. mixed   — an 8-slot slab at Vmax = 50 of ntu25 sessions (plans padded
               to 50) and ntu50 sessions on CSR plans, slots reused across
               skeletons, stepped as the JAX service steps its skeleton
               groups: one ``make_gcn_slab_step`` per group with its own BN
               statistics, the other slots held.  Each session's eviction
               logits against the same session run alone on a narrow plan
               (atol=rtol=1e-4).
  9. ck      — agcn-2s with the windowed C_k (``use_ck``) on ntu25: a stream
               of 8 sequences (300 frames + the drain) on ``cuda`` and
               ``reference``, post-drain logits against clip-mode C_k
               logits and ``cuda`` against ``reference`` (atol=rtol=1e-3,
               top-1 100%), 20 windowed_similarity launches per ensemble
               step (its step form: the C_k ring writes and the graph in
               one launch); the same stream on plans padded to 50 joints
               against the narrow one at every step (atol=rtol=1e-4).
               Ticks 200 frames in are held at S = 1, 3 and 8 of the
               ``cuda`` stream (every column live) and at S = 8 of the
               padded one (25 live): the step form as the path calls it
               (new rings bit-equal, graph within 1e-4) and the bare form
               on the same calls' new rings, each beside a four-call
               PyTorch composite (``sum``, ``baddbmm``, ``masked_fill``,
               ``softmax``; ``composite_ms``, no library call computes
               this function); a windowed_similarity input with an
               all-zero slot fails.
 10. sessions — ``repro_torch.serving.GcnService`` through its public API
               (``replay``, ``open_session``/``submit``/``close``/``poll``),
               with port weights from seed 0:
               (a) the golden replays on ``cuda`` at the reduced config
               (the golden tests' prune plan: [1.0, 0.5, 0.5, 0.5] kept,
               cav-70-1, input skip 2, Q8.8): ``tests/data/traces/
               smoke.json`` through the three ``fifo`` cells of
               ``golden_smoke.json`` and both cells of
               ``golden_saliency.json``, then, while the first ones took
               under 30 s, the four ``preempt``/``deadline`` cells; each
               must equal its golden cell exactly (outcome digest, ticks,
               sessions, preemptions, restores, deadline misses, sheds,
               saliency counts, tier walk, final capacity, per-priority
               tick percentiles), with graph_sconv, cavity_tconv_step,
               rfc_encode and rfc_decode launched per step as a
               one-stream tick does; (b) full agcn-2s on ``cuda`` and
               ``reference``: a ``TraceGenerator`` trace of 16 sessions
               (mean 48 frames, 16 to 96, 30% high priority, seed 7)
               under ``qos="preempt"``, tiers (4, 8), ``policy="demand"``;
               the two outcome digests equal, every finished session's
               logits within atol=rtol=1e-3, top-1 100%, at least one
               preemption and one migration, and the ``cuda`` launches
               exactly one tick's per step plus one calibration clip pass;
               prints sessions/s, frames/s, tick p50 and mean (host clock
               inside ``tick``), ms a tick over the run, dispatches,
               forced readbacks and launches per tick; (c) a two-skeleton
               service (ntu25 padded to 50, ntu50, 4 slots) fed frame by
               frame with starved (held) ticks, then closed: every
               session done, ``cuda`` against ``reference`` within
               atol=rtol=1e-3.  Prints the phase's time.
 11. profile — two steps each of the clip, stream, slab, ntu50 CSR clip
               and C_k stream paths under ``torch.profiler``: the device's
               busy share of the wall time and device time by kernel name
               (reported, not checked; the profiler's own cost inflates the
               wall time).
 12. lm      — dense LM decode serving at the full width of smollm-360m
               (32 layers, d_model 960, 15/5 heads, vocab 49 152; random
               weights from seed 0): ``generate`` (batch 4, a 496-token
               prompt fed token by token, then 16 greedy tokens: 511 serve
               steps, a 512-slot float32 cache) on ``cuda`` and
               ``reference``, tokens/s and per-step latency; the
               ``reference`` backend teacher-forced on the ``cuda`` run's
               tokens (per-step logits within atol=rtol=1e-3; a greedy
               token that differs fails unless the reference's top-2
               margin is <= 1e-3); the prompt's logits from the cache-free
               forward against the cached decode (1e-3); 32 flash_decode
               launches per ``cuda`` step and none on ``reference``; one
               decode step under ``set_sync_debug_mode("error")``; one step
               profiled.  flash_decode is held against its plain version
               (atol=rtol=1e-4) on the 32 layers' inputs of an early step
               (valid 17), the first step after the prompt and the last
               step, a long-context case
               (B 8, S 32 768, valid 30 000), h2o-danube's ring shape
               (B 4, L 4 096, 8 kv heads, G 4, D 80) and a small odd case
               (S 48, D 20, valid 1), beside one
               ``F.scaled_dot_product_attention`` call (the yardstick);
               each ``kernel flash_decode`` line names the launch's plan
               (splits, warps, stages), its µs per launch and its share of
               the bound.

Prints the kernels JSON line, the nvidia-smi line and, last, the result
line.  Any failed phase exits non-zero.  Per-case kernel numbers go to
``build/chip_smoke_cases.json`` (git-ignored).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# NVIDIA H100 SXM data sheet: HBM3 rate, float32 rate outside the tensor
# cores, and dense TF32 tensor-core rate.  graph_sconv and cavity_tconv
# run on the tensor cores (TF32, 3-pass split), so their bound takes the
# TF32 rate, with the float32 bound beside it and 3 x operations / TF32
# rate as the split's own floor; the other kernels use float32 FMAs.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
TENSOR_CORE_KERNELS = ("graph_sconv", "cavity_tconv", "graph_sconv_csr",
                       "cavity_tconv_step")

KERNEL_INFO = {   # name -> (CUDA source, TPU kernel it replaces)
    "graph_sconv_csr": ("src/repro_torch/csrc/graph_sconv_csr.cu",
                        "src/repro/kernels/graph_sconv.py:110"),
    "windowed_similarity": ("src/repro_torch/csrc/window_sim.cu",
                            "src/repro/kernels/window_sim.py:48"),
    "graph_sconv": ("src/repro_torch/csrc/graph_sconv.cu",
                    "src/repro/kernels/graph_sconv.py:52"),
    "cavity_tconv": ("src/repro_torch/csrc/cavity_tconv.cu",
                     "src/repro/kernels/cavity_tconv.py:99"),
    "cavity_tconv_step": ("src/repro_torch/csrc/cavity_tconv_step.cu",
                          "src/repro/kernels/cavity_tconv.py:67"),
    "rfc_encode": ("src/repro_torch/csrc/rfc_pack.cu",
                   "src/repro/kernels/rfc_pack.py:67"),
    "rfc_decode": ("src/repro_torch/csrc/rfc_pack.cu",
                   "src/repro/kernels/rfc_pack.py:87"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode.py:72"),
}
ARCH, BATCH, CLIPS, SEED = "agcn-2s", 8, 32, 0
DEVICE = "cuda"
STREAM_CLIPS = 4                   # 8 sequences of 2 persons
STREAM_SLOTS = (1, 3, 8)           # the stream shapes the kernels are held at
STREAM_WARM = 200                  # raw frames before a held stream tick
SLAB_SLOTS, SESSIONS, SESSION_FRAMES, EVENTS, RING_ROWS = 8, 12, 64, 4, 4
TOPO_CLIPS = 32                    # ntu50 sequences in the topology phase
MIXED_SESSIONS, MIXED_FRAMES, MIXED_EVERY = 10, 48, 4
SESSIONS_N, SESSIONS_TIERS = 16, (4, 8)    # the full-width sessions trace
SESSIONS_GOLDEN_S = 30.0           # golden cells past the first five run
                                   # while the first ones took less
MIXED_SVC_FRAMES = 24              # frames per session of the mixed service
VMAX = 50                          # slab width of the mixed and padded runs
DENSE_SKELETONS = (("hand21", 21), ("body_hand46", 46))
CSR_EPS = 1e-5                     # above B_k's 1e-6 init: D = degree
CARD_TESTS = "tests/test_torch_cuda_kernels.py"
SPIN_CYCLES = 2_000_000            # about 1 ms at the H100's boost clock
_CLOCK = {}                        # the spin kernel's cycles per ms
HOST_GAPS = set()                  # timings whose host time could not be
                                   # hidden behind a spin
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "smollm-360m", 4, 496, 16
LM_EARLY = 16                      # an early serve step: valid = 17
# flash_decode cases off the served run: (label, B, S, Hkv, G, D, valid)
FD_CASES = [("long context", 8, 32768, 5, 3, 64, 30000),
            ("danube ring", 4, 4096, 8, 4, 80, 4096),
            ("small odd", 2, 48, 1, 3, 20, 1)]


T_START = time.perf_counter()


def phase_done(name: str) -> None:
    print(f"time: {name} phase done {time.perf_counter() - T_START:.1f} s "
          f"after start")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def spin_cycles_per_ms() -> float:
    """The spin kernel's clock cycles per ms on this card (timed once, the
    second of two spins, after the first has woken the clocks)."""
    import torch
    if "cycles_per_ms" not in _CLOCK:
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            torch.cuda._sleep(SPIN_CYCLES)
            end.record()
            end.synchronize()
            _CLOCK["cycles_per_ms"] = SPIN_CYCLES / start.elapsed_time(end)
    return _CLOCK["cycles_per_ms"]


def cuda_ms(fn, reps: int = 7, inner: int = 10, label: str = "",
            waits: bool = False) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, by CUDA events, after one warm-up call.

    The host's queueing must not enter the device time, so each
    repetition first queues a spin kernel that outlasts the host's time to
    queue the ``inner`` calls: that time is measured once before the
    repetitions and again in each; a repetition whose queueing outlasted
    its spin (a host hiccup) is run again with a spin twice as long as the
    queueing took, up to three tries.  The device then reaches the first
    call only once the last is queued, and the events time its work alone.
    A call that waits for the device itself (``waits``: the plain versions
    that read their taps on the host), or whose launches fill the launch
    queue behind the spin (three tries fail), cannot be hidden so: it runs
    without a spin and is timed with its waits, and ``label`` goes into
    ``HOST_GAPS``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        for _ in range(1 if waits else 3):
            spin_ms = 0.0 if waits else max(1.0, 2.0 * host_ms + 0.5)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if spin_ms:
                torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
            h0 = time.perf_counter()
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - h0) * 1e3
            end.synchronize()
            if queued_ms < spin_ms:
                break
            host_ms = queued_ms
        else:
            # the calls wait for the device (or fill the launch queue behind
            # the spin): the remaining repetitions run without one
            waits = True
            if label:
                HOST_GAPS.add(label)
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _clone_tree(a):
    """A copy of ``a`` (tensors, None, and tuples and dicts of them) in
    storage of its own, with each tensor's strides."""
    import torch
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, (tuple, list)):
        return type(a)(_clone_tree(x) for x in a)
    if isinstance(a, dict):
        return {k: _clone_tree(x) for k, x in a.items()}
    return a


def rotating(call, args, in_bytes: float):
    """``call(args)`` on copies of ``args`` in turn, enough that their
    inputs together exceed twice the L2 (at most 64 copies): a call then
    finds none of its inputs left in L2 by the calls before it, as a byte
    bound from HBM assumes.  Returns the function and whether the copies
    do exceed twice the L2 (small inputs stay resident)."""
    import torch
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    n = min(64, max(2, -(-2 * l2 // max(int(in_bytes), 1))))
    copies = [_clone_tree(args) for _ in range(n)]
    k = [0]

    def fn():
        k[0] = (k[0] + 1) % n
        return call(copies[k[0]])
    return fn, n * in_bytes > 2 * l2


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def capture(modules, run):
    """Call ``run()`` with each kernel wrapper wrapped by a recorder;
    returns {kernel: [(args, kwargs), ...]} with cloned tensor inputs."""
    import torch
    gs, ct, rp, ws = modules
    targets = [(gs, "graph_sconv_cuda", "graph_sconv"),
               (ct, "cavity_tconv_cuda", "cavity_tconv"),
               (ct, "cavity_tconv_step_ring_cuda", "cavity_tconv_step"),
               (rp, "rfc_encode_cuda", "rfc_encode"),
               (rp, "rfc_decode_cuda", "rfc_decode"),
               (gs, "graph_sconv_csr_cuda", "graph_sconv_csr"),
               (ws, "windowed_similarity_cuda", "windowed_similarity"),
               (ws, "windowed_similarity_step_cuda", "windowed_similarity")]
    captured = {name: [] for _, _, name in targets}
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def clone(a):
        if isinstance(a, dict):             # the RFC step form's old leaves
            return {k: clone(v) for k, v in a.items()}
        return a.clone() if torch.is_tensor(a) else a

    def recorder(orig, name):
        def rec(*args, **kwargs):
            captured[name].append((tuple(clone(a) for a in args),
                                   dict(kwargs)))
            return orig(*args, **kwargs)
        return rec

    try:
        for (mod, attr, orig), (_, _, name) in zip(originals, targets):
            setattr(mod, attr, recorder(orig, name))
        run()
        torch.cuda.synchronize()
    finally:
        for mod, attr, orig in originals:
            setattr(mod, attr, orig)
    return captured


def _chrono(ring, head):
    """Each slot's window (S, K, V, C) gathered oldest first from its ring
    at ``head``."""
    import torch
    S, K, V, C = ring.shape
    idx = (head.long()[:, None] + torch.arange(K, device=ring.device)) % K
    return torch.gather(ring, 1, idx[:, :, None, None].expand(S, K, V, C))


def _dense_cavity(wp, taps, ks):
    """The masked dense weights (F, C, K) of packed cavity weights, filter
    f = g + L*i in natural order."""
    import torch
    L, n_keep, C, Fg = wp.shape
    w_dense = torch.zeros(L * Fg, C, ks, device=wp.device)
    for g, row in enumerate(taps.tolist()):
        for j, off in enumerate(row):
            w_dense[g::L, :, off] += wp[g, j].T
    return w_dense


def measure_case(name, args, kwargs, modules):
    """Kernel vs plain on one captured input: error, pass/fail, times and
    the bound on this card."""
    import torch
    import torch.nn.functional as F
    gs, ct, rp, ws = modules
    from repro_torch.kernels import flash_decode as fd
    library, as_kernel, composite, extra = None, None, None, {}
    exact = len(args) if name.startswith("rfc") else 0   # bit-equal outputs
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
        x, wp, taps, inv, nf = args
        ks, stride = kwargs["kernel_size"], kwargs["stride"]
        kern = lambda: ct.cavity_tconv_cuda(x, wp, taps, inv, nf,
                                            kernel_size=ks, stride=stride)
        plain = lambda: ct.cavity_tconv_plain(x, wp, taps, inv, nf,
                                              kernel_size=ks, stride=stride)
        N, T, V, C = x.shape
        # the yardstick: one cuDNN conv of the dense masked weights, in
        # natural filter order, over (N, C, T, V)
        x4 = x.permute(0, 3, 1, 2).contiguous()
        w4 = _dense_cavity(wp, taps, ks)[:nf].unsqueeze(-1)
        library = lambda: F.conv2d(x4, w4, stride=(stride, 1),
                                   padding=(ks // 2, 0))
        as_kernel = lambda: library().permute(0, 2, 3, 1)
        T_out = ct.t_out(T, ks, stride)
        # the (filter, tap) pairs this data needs: kept filters' packed
        # slots with weights
        live = inv[:nf]
        slots = (wp != 0).any(dim=2).permute(0, 2, 1).reshape(-1, wp.shape[1])
        pairs = int(slots[live].sum())
        nbytes = 4 * (x.numel() + wp.numel() + taps.numel()
                      + N * T_out * V * nf) + 8 * inv.numel()
        flops = 2 * N * V * T_out * C * pairs
    elif name == "cavity_tconv_step":
        ring, head, wp, taps, slot_col, bias = args
        kern = lambda: ct.cavity_tconv_step_ring_cuda(*args)
        plain = lambda: ct.cavity_tconv_step_ring_plain(*args)
        S, K, V, C = ring.shape
        L, n_keep, _, Fg = wp.shape
        cout = bias.shape[0]
        # the yardstick: one einsum of the chronological windows (gathered
        # here, outside the timing) with the dense masked weights laid out
        # in output-column order; the bias and the zero columns follow
        xb = _chrono(ring, head).permute(0, 2, 1, 3).reshape(S * V, K, C)
        src = ct.column_sources(slot_col, cout)
        live = src < L * Fg
        filt = torch.where(live, src % Fg * L + src // Fg, 0)
        w_cols = _dense_cavity(wp, taps, K)[filt] * live[:, None, None]
        library = lambda: torch.einsum("bkc,fck->bf", xb, w_cols)
        as_kernel = lambda: torch.where(live, library() + bias, 0.0).reshape(
            S, V, cout)
        # (slot, tap) pairs with weights on live slots
        pairs = int(((wp != 0).any(dim=2)
                     & (slot_col.reshape(L, 1, Fg) >= 0)).sum())
        # the frames some group reads (the union of the kept taps)
        frames = len(set(taps.flatten().tolist()))
        nbytes = 4 * (S * V * frames * C + wp.numel() + taps.numel()
                      + slot_col.numel() + cout + S + S * V * cout)
        flops = 2 * S * V * C * pairs
    elif name == "graph_sconv_csr":
        x, idx, val, w = args
        kern = lambda: gs.graph_sconv_csr_cuda(x, idx, val, w)
        plain = lambda: gs.graph_sconv_csr_plain(x, idx, val, w)
        R, V, Cin = x.shape
        K, _, Cout = w.shape
        # the yardstick: the dense 3-operand einsum on the densified graph
        g = torch.zeros(K, V, V, device=x.device).scatter_add_(
            2, idx.long(), val)
        library = lambda: torch.einsum("rvc,kwv,kco->rwo", x, g, w)
        nnz = int((val != 0).sum())            # the entries this graph has
        nbytes = 4 * (x.numel() + idx.numel() + val.numel() + w.numel()
                      + R * V * Cout)
        flops = 2 * R * (nnz * Cin + K * V * Cin * Cout)
    elif name == "windowed_similarity":
        th, ph, valid = args[0], args[1], args[-1]
        S, K, V, Ce = th.shape
        if len(args) == 8:      # the step form, as the C_k stream calls it
            kern = lambda: ws.windowed_similarity_step_cuda(*args)
            plain = lambda: ws.windowed_similarity_step_plain(*args)
            new_th, new_ph, _ = plain()
            exact = 2                       # the new rings: bit-equal
            has, inv = args[5], args[6]
            n_has, n_e = int(has.sum()), int((has & inv).sum())
            # the ring rows not overwritten, the embeddings written, the
            # flags; the new rings and the graph
            nbytes = (4 * 2 * V * Ce * ((S * K - n_has) + n_e) + 6 * S
                      + 4 * (th.numel() + ph.numel() + S * V * V))
            extra["form"] = "step"
        else:
            kern = lambda: ws.windowed_similarity_cuda(th, ph, valid)
            plain = lambda: ws.windowed_similarity_plain(th, ph, valid)
            new_th, new_ph = th, ph
            nbytes = 4 * (th.numel() + ph.numel() + S * V * V)
            extra["form"] = "bare"
        # window sums, the live columns' dots, then scale, max, exp, sum,
        # divide
        flops = 2 * S * K * V * Ce + 2 * S * V * valid * Ce + 5 * S * V * V
        # the yardstick: four PyTorch calls on the (new) rings, stacked
        # here outside the timing (no one call computes this function)
        rings = torch.stack((new_th, new_ph))
        dead = torch.arange(V, device=th.device) >= valid
        buf = torch.empty(S, V, V, device=th.device)

        def composite():
            win = rings.sum(2)
            lg = torch.baddbmm(buf, win[0], win[1].transpose(1, 2), beta=0.0,
                               alpha=1.0 / Ce ** 0.5)
            return torch.softmax(lg.masked_fill(dead, -1e30), dim=-1)
    elif name == "flash_decode":
        q, k, v, valid = args
        kern = lambda: fd.flash_decode(q, k, v, valid)
        plain = lambda: fd.flash_decode_plain(q, k, v, valid)
        B, Hkv, G, D = q.shape
        S = k.shape[1]
        live = (torch.arange(S, device=k.device) < valid).view(1, 1, 1, S)
        qh = q.reshape(B, Hkv * G, 1, D)
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        library = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=live, enable_gqa=True).reshape(q.shape)
        # the rows the softmax needs (the kernel reads no row past valid)
        n = int(valid.item())
        n = min(n, S) if n >= 1 else S
        nbytes = 4 * (2 * q.numel() + 2 * B * n * Hkv * D + 1)
        flops = B * Hkv * G * n * (4 * D + 5)
        p = fd.decode_plan(B, S, Hkv, G, D, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
        extra = {"plan": [p.splits, p.warps, p.stages]}
    elif name == "rfc_encode":
        t, res, live, keep, old = args
        call = lambda a: rp.rfc_encode_cuda(*a)
        kern = lambda: call(args)
        plain = lambda: rp.rfc_encode_plain(*args)
        C = t.shape[-1]
        rows = t.numel() // C
        # the rows whose t (and res) this run needs: emitting slots' live
        # joints; the other slots read their old leaves instead
        need = torch.ones(rows, dtype=torch.bool, device=t.device)
        n_old = 0
        if keep is not None:
            need &= keep.repeat_interleave(rows // t.shape[0])
            n_old = rows - int(need.sum())
        if live is not None:
            need &= live.repeat(rows // live.numel())
        n_need = int(need.sum())
        packed = 4 + 2 / 16                 # bytes of values and bits
        nbytes = (4 * C * n_need * (1 + (res is not None)) + n_old * C * packed
                  + rows * C * packed
                  + sum(m.numel() for m in (live, keep) if m is not None))
        flops = n_need * C * (1 + (res is not None))   # add, max
        in_bytes = sum(a.numel() * a.element_size() for a in
                       (t, res, live, keep, *(old or {}).values())
                       if a is not None)
    else:
        values, bits = args
        call = lambda a: rp.rfc_decode_cuda(*a)
        kern = lambda: call(args)
        plain = lambda: rp.rfc_decode_plain(values, bits)
        nbytes, flops = (4 + 2 / 16 + 4) * values.numel(), values.numel()
        in_bytes = 4 * values.numel() + 2 * bits.numel()

    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    ok = all(torch.equal(a, b) if i < exact else
             torch.allclose(a, b, atol=1e-4, rtol=1e-4)
             for i, (a, b) in enumerate(zip(got, want)))
    if library is not None:
        ref = as_kernel() if as_kernel is not None else library()
        ok = ok and torch.allclose(got[0], ref, atol=1e-4, rtol=1e-4)
    if composite is not None:
        ok = ok and torch.allclose(got[-1], composite(), atol=1e-4,
                                   rtol=1e-4)
    tc = name in TENSOR_CORE_KERNELS
    b_ms, t_bytes, t_ops = bound_ms(nbytes, flops,
                                    TF32_FLOP_PER_S if tc else F32_FLOP_PER_S)
    timed = kern
    if name.startswith("rfc"):
        # bound by bytes from HBM: timed on inputs no earlier call left in
        # L2, with the time on one set of inputs beside it
        extra["ms_l2"] = cuda_ms(kern, label=f"{name} kernel")
        timed, extra["cold"] = rotating(call, args, in_bytes)
    return {
        "shape": [list(a.shape) for a in args if hasattr(a, "shape")],
        "stride": kwargs.get("stride"), "ok": bool(ok), "max_abs_err": err,
        "ms": cuda_ms(timed, label=f"{name} kernel"),
        "plain_ms": cuda_ms(plain, reps=3, inner=3, label=f"{name} plain",
                            waits=name.startswith("cavity")),
        "library_ms": (cuda_ms(library, label=f"{name} library")
                       if library is not None else None),
        # a yardstick of several PyTorch calls, not a library kernel
        "composite_ms": (cuda_ms(composite, label=f"{name} composite")
                         if composite is not None else None),
        "bound_ms": b_ms, "bytes_ms": t_bytes, "ops_ms": t_ops,
        # the float32 CUDA-core bound and, on the tensor cores, the 3-pass
        # split's own floor (three TF32 products per product)
        "bound_f32_ms": bound_ms(nbytes, flops)[0],
        "split_floor_ms": (bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)[0]
                           if tc else None),
        **extra,
    }


def summarize(cs):
    """Per-step sums over the cases of one kernel on one path."""
    t_bytes = sum(c["bytes_ms"] for c in cs)
    t_ops = sum(c["ops_ms"] for c in cs)
    out = {
        "max_abs_err": max(c["max_abs_err"] for c in cs),
        "ms": sum(c["ms"] for c in cs),
        "plain_ms": sum(c["plain_ms"] for c in cs),
        "bound_ms": sum(c["bound_ms"] for c in cs),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": (sum(c["library_ms"] for c in cs)
                       if cs[0]["library_ms"] is not None else None),
        "bound_f32_ms": sum(c["bound_f32_ms"] for c in cs),
    }
    if cs[0]["split_floor_ms"] is not None:
        out["split_floor_ms"] = sum(c["split_floor_ms"] for c in cs)
    if cs[0]["composite_ms"] is not None:
        out["composite_ms"] = sum(c["composite_ms"] for c in cs)
        out["form"] = cs[0]["form"]
    if "ms_l2" in cs[0]:
        out["ms_l2"] = sum(c["ms_l2"] for c in cs)
        out["cold"] = all(c["cold"] for c in cs)
    return out


def profile_steps(label, run, steps: int = 2) -> None:
    """Print the device's busy share and its time by kernel name over
    ``steps`` calls of ``run``, from ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
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
        print(f"profile {label}: the profiler recorded no device time "
              f"(not measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile {label}: {wall_ms:.3f} ms wall per step under the "
          f"profiler, device busy {busy:.3f} ms ({busy / wall_ms * 100:.1f}%), "
          f"{sum(r[1] for r in rows):.0f} kernels and copies per step")
    for ms, count, key in rows[:15]:
        print(f"profile {label}: {ms:8.3f} ms {count:5.0f}x {key[:90]}")


def run_slab_script(tick, plans, slabs, rings, clips, flush, dev):
    """Drive the fused tick through a fixed session script: staggered
    arrivals, a hold, a preemption into the snapshot ring with a foreign
    session admitted into the slot, a swap (snapshot and restore of one
    slot in one tick), restores into freed slots, drains.  Returns
    ({session: logits at eviction}, per-tick wall ms, {event: count},
    slabs, rings)."""
    import numpy as np
    import torch
    from repro_torch.core.agcn.engine import SNAP_SENTINEL
    S, T = SLAB_SLOTS, SESSION_FRAMES
    V, C = clips.shape[2], clips.shape[3]
    arrival = {sid: 6 * sid for sid in range(len(clips))}
    HOLD_SID, HOLD_AT, HOLD_TICKS = 2, 30, 4
    PREEMPT_SID, PREEMPT_AT, SWAP_SID, SWAP_AT = 1, 50, 4, 60
    queue = collections.deque(sorted(arrival, key=arrival.get))
    waiting = collections.deque()      # (sid, ring row, eligible from tick)
    slots = [None] * S
    pos, got, lat = {}, {}, []
    held, preempted = 0, False
    counts = collections.Counter()
    for t in range(5000):
        if not queue and not waiting and all(s is None for s in slots):
            break
        snap, rest = [], []
        reset = np.zeros(S, bool)
        hold = np.zeros(S, bool)
        for s, sid in enumerate(slots):
            if sid == PREEMPT_SID and pos[sid] == PREEMPT_AT and not preempted:
                preempted = True
                snap.append((s, 0))
                waiting.append((sid, 0, t + 1))
                slots[s] = None
            elif (sid == SWAP_SID and pos[sid] == SWAP_AT
                  and waiting and waiting[0][0] == PREEMPT_SID):
                _, row, _ = waiting.popleft()
                snap.append((s, 1))
                rest.append((s, row))
                waiting.append((sid, 1, t + 1))
                slots[s] = PREEMPT_SID
            elif sid == HOLD_SID and pos[sid] == HOLD_AT and held < HOLD_TICKS:
                hold[s] = True
                held += 1
        for s in range(S):
            if slots[s] is not None:
                continue
            if waiting and waiting[0][2] <= t:
                sid, row, _ = waiting.popleft()
                rest.append((s, row))
                slots[s] = sid
            elif queue and arrival[queue[0]] <= t:
                sid = queue.popleft()
                reset[s], slots[s], pos[sid] = True, sid, 0
        frames = np.zeros((S, V, C), np.float32)
        valid = np.zeros(S, bool)
        for s, sid in enumerate(slots):
            if sid is not None and pos[sid] < T:
                frames[s], valid[s] = clips[sid, pos[sid]], True

        def order(events):
            o = np.full((EVENTS, 2), SNAP_SENTINEL, np.int32)
            if events:
                o[:len(events)] = events
            return torch.from_numpy(o).to(dev)

        counts.update(snapshot=len(snap), restore=len(rest),
                      admit=int(reset.sum()), hold=int(hold.sum()))
        inputs = (torch.from_numpy(frames).to(dev),
                  torch.from_numpy(valid).to(dev),
                  torch.from_numpy(reset).to(dev),
                  torch.from_numpy(hold).to(dev), order(snap), order(rest))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slabs, logits, rings = tick(plans, slabs, *inputs, rings)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        for s, sid in enumerate(slots):
            if sid is None or hold[s]:
                continue
            pos[sid] += 1
            if pos[sid] == T + flush:
                got[sid] = logits[s].cpu().numpy()
                slots[s] = None
    counts["ticks"] = len(lat)
    return got, lat, counts, slabs, rings


def counted(run):
    """``run()`` between a reset and a read of the launch counters:
    returns (its result, {kernel: launches})."""
    from repro_torch.kernels import _build
    _build.reset_launch_counts()
    out = run()
    return out, dict(_build.LAUNCHES)


def first_slots(state, S: int):
    """The stream state of the first ``S`` slots of ``state`` (slots are
    independent, so it equals a state warmed with S slots)."""
    import torch
    from repro_torch.core.agcn import engine
    idx = torch.arange(S, device=state.t_raw.device)
    return dataclasses.replace(state, **engine.snapshot_slots(state, idx))


def clip_run(infer, plans, batches, dev):
    """One warm-up ensemble step, then every batch, timed on the host
    clock up to a synchronise.  Returns (logits numpy, sequences/s,
    ensemble steps run)."""
    import torch
    infer(plans, batches[0])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    outs = [infer(plans, xb) for xb in batches]
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n = sum(xb.shape[0] for xb in batches)
    return torch.cat(outs).cpu().numpy(), n / dt, len(batches) + 1


def stream_run(step, plans, states, clip, flush, dev):
    """``serve_gcn_stream``'s loop: two discarded warm-up steps (a clip
    frame, a flush frame), then the clip frame by frame and the drain,
    each step timed on the host clock up to a synchronise.  Returns
    (states, per-step logits, per-step ms, the states STREAM_WARM raw
    frames in: steps return new states, so the run's own serve to hold
    the kernels on a tick past the first-logit delay)."""
    import torch
    T = clip.shape[1]
    zeros = torch.zeros_like(clip[:, 0])
    step(plans, states, clip[:, 0], True)
    step(plans, states, zeros, False)
    torch.cuda.synchronize(dev)
    logits, lat = [], []
    for r in range(T + flush):
        if r == STREAM_WARM:
            warm = states
        t0 = time.perf_counter()
        states, out = step(plans, states, clip[:, r] if r < T else zeros,
                           r < T)
        torch.cuda.synchronize(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
        logits.append(out)
    return states, logits, lat, warm


def run_mixed_script(slab_step, groups, slabs, sessions, flush, dev):
    """Drive a Vmax-wide slab shared by skeleton groups: sessions
    (skeleton, arrival tick, clip) take the first free slot at or after
    their arrival, and each tick steps every group that has a live slot
    with one ``slab_step`` over the whole slab (that group's plans and BN
    statistics, the slab's other slots held), as the JAX service's
    ``_step_groups`` does.  Returns ({session: eviction logits}, per-tick
    wall ms, dispatches, {skeleton: admissions into a slot another
    skeleton used before})."""
    import numpy as np
    import torch
    S = SLAB_SLOTS
    queue = collections.deque(range(len(sessions)))
    slots, pos, got, lat = [None] * S, {}, {}, []
    last_topo = [None] * S
    reused = collections.Counter()
    dispatches = 0
    for t in range(10000):
        if not queue and all(s is None for s in slots):
            break
        reset = np.zeros(S, bool)
        for s in range(S):
            if slots[s] is None and queue and sessions[queue[0]][1] <= t:
                sid = queue.popleft()
                topo = sessions[sid][0]
                if last_topo[s] not in (None, topo):
                    reused[topo] += 1
                slots[s], pos[sid], reset[s], last_topo[s] = sid, 0, True, topo
        frames = np.zeros((S, VMAX, 3), np.float32)
        valid = np.zeros(S, bool)
        for s, sid in enumerate(slots):
            if sid is not None and pos[sid] < sessions[sid][2].shape[0]:
                clip = sessions[sid][2][pos[sid]]
                frames[s, : clip.shape[0]] = clip
                valid[s] = True
        inputs = [torch.from_numpy(a).to(dev) for a in (frames, valid, reset)]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rows = {}
        for topo, (plans, stats) in groups.items():
            m = np.array([sid is not None and sessions[sid][0] == topo
                          for sid in slots])
            if not m.any():
                continue
            mask = torch.from_numpy(m).to(dev)
            slabs, logits = slab_step(plans, slabs, inputs[0],
                                      inputs[1] & mask, inputs[2] & mask,
                                      ~mask, stats=stats)
            dispatches += 1
            rows.update({s: logits[s] for s in np.flatnonzero(m)})
        torch.cuda.synchronize(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
        for s, sid in enumerate(slots):
            if sid is None:
                continue
            pos[sid] += 1
            if pos[sid] == sessions[sid][2].shape[0] + flush:
                got[sid] = rows[s].cpu().numpy()
                slots[s] = None
    return got, lat, dispatches, reused


def record_decode(steps, num_layers):
    """Wrap the decode attention's ``flash_decode`` (as the attention
    layer calls it) with a recorder of the calls of serve ``steps`` (call
    i belongs to step i // num_layers): returns (restore(), {step: [(args,
    {}), ...]}) with cloned inputs."""
    import torch
    from repro_torch.models.layers import attention
    orig, seen = attention.flash_decode, [0]
    got = {s: [] for s in steps}

    def rec(*args):
        step = seen[0] // num_layers
        seen[0] += 1
        if step in got:
            got[step].append((tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), {}))
        return orig(*args)

    attention.flash_decode = rec

    def restore():
        attention.flash_decode = orig
    return restore, got


def lm_phase(dev, failures, cases, summary, check_launches, modules):
    """Phase 12: ``generate`` at full smollm-360m width on both backends,
    the teacher-forced and prefill agreement checks, flash_decode's launch
    count, cases and times, a sync-free step and a profiled step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import decoder, registry
    from repro_torch.train.steps import make_prefill_step, make_serve_step

    cfg = get_config(LM_ARCH)
    steps = LM_PROMPT + LM_GEN - 1
    first, last = LM_PROMPT, steps - 1       # first step fed a generated token
    early = min(LM_EARLY, first - 1)
    params = registry.init_params(cfg, seed=SEED, device=dev)

    def hold(path, calls):
        cs = [measure_case("flash_decode", a, k, modules) for a, k in calls]
        cases[f"{path}/flash_decode"] = cs
        bad = [i for i, c in enumerate(cs) if not c["ok"]]
        if bad:
            failures.append(f"{path} flash_decode: kernel disagrees with its "
                            f"plain version on cases {bad}")
        sm = summary[(path, "flash_decode")] = summarize(cs)
        print(f"kernel flash_decode [{path}]: {'ok' if not bad else 'FAIL'} "
              f"on {len(cs)} inputs {cs[0]['shape']}, valid "
              f"{int(calls[0][0][3].item())}, splits/warps/stages "
              f"{'/'.join(map(str, cs[0]['plan']))}, max_abs_err "
              f"{sm['max_abs_err']:.3g}; {sm['ms']:.4f} ms, "
              f"{sm['ms'] / len(cs) * 1e3:.2f} us a launch, "
              f"{sm['bound_ms'] / sm['ms'] * 100:.1f}% of the bound (plain "
              f"{sm['plain_ms']:.4f}, sdpa {sm['library_ms']:.4f}, bound "
              f"{sm['bound_ms']:.4f} ms by {sm['bound_by']})")

    restore, got = record_decode((early, first, last), cfg.num_layers)
    try:
        res, counts = counted(lambda: generate(
            LM_ARCH, reduced=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
            gen=LM_GEN, seed=SEED, backend="cuda", device=dev, params=params,
            keep_logits=True))
    finally:
        restore()
    check_launches("lm", counts, {"flash_decode": cfg.num_layers}, steps)
    launched = counts["flash_decode"]
    ref, counts = counted(lambda: generate(
        LM_ARCH, reduced=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
        gen=LM_GEN, seed=SEED, backend="reference", device=dev,
        params=params, keep_logits=True))
    check_launches("lm reference", counts, {}, steps)
    for name, r in (("cuda", res), ("reference", ref)):
        print(f"lm: backend={name} {r['tokens_per_s']:.2f} tokens/s, serve "
              f"step p50 {r['latency_ms_p50']:.3f} ms mean "
              f"{r['latency_ms_mean']:.3f} ms ({LM_BATCH} sequences x "
              f"{r['steps']} steps, prompt {LM_PROMPT} fed token by token + "
              f"{LM_GEN} generated, full {LM_ARCH}, float32 cache)")
    toks = res["tokens"]
    if toks.shape != (LM_BATCH, LM_PROMPT + LM_GEN) or not np.isfinite(
            res["logits"].cpu().numpy()).all():
        failures.append(f"lm: tokens {toks.shape} or logits not finite")
    agree = float(np.mean(toks[:, LM_PROMPT:] == ref["tokens"][:, LM_PROMPT:]))

    # the reference backend teacher-forced on the cuda run's tokens: while
    # the free-running reference picks the same tokens it was fed exactly
    # those, so its own logits serve; after a divergence it is run again
    # on the cuda tokens
    tt = torch.from_numpy(toks).to(dev)
    if (ref["tokens"] == toks).all():
        forced = ref["logits"]
    else:
        step = make_serve_step(cfg, "reference")
        cache = registry.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN,
                                    device=dev)
        forced = torch.stack([step(params, cache, {
            "tokens": tt[:, t:t + 1],
            "pos": torch.full((), t, dtype=torch.int32, device=dev)})[2]
            for t in range(steps)])
    del ref["logits"]
    worst = float((res["logits"] - forced).abs().max())
    close = torch.isclose(res["logits"], forced, atol=1e-3, rtol=1e-3)
    if not bool(close.all()):
        bad = torch.nonzero(~close.flatten(1).all(1)).flatten().tolist()
        failures.append(f"lm: logits of steps {bad[:10]} differ from the "
                        f"teacher-forced reference (max {worst:.3g})")
    # greedy tokens: a cuda choice the reference would not make is only
    # allowed where the reference's top-2 margin is <= 1e-3
    top2 = forced[LM_PROMPT - 1:].topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    differ = (forced[LM_PROMPT - 1:].argmax(-1)
              != tt[:, LM_PROMPT:].T).cpu().numpy()
    flips = [(LM_PROMPT - 1 + t, b, float(margin[t, b]))
             for t, b in zip(*np.nonzero(differ))]
    hard = [f for f in flips if f[2] > 1e-3]
    if hard:
        failures.append(f"lm: greedy tokens differ from the reference's "
                        f"where its top-2 margin exceeds 1e-3: {hard}")
    # the prompt's logits from the cache-free forward (the prefill path)
    with torch.inference_mode():
        full, _ = decoder.forward(params, tt[:, :LM_PROMPT], cfg)
        metrics = make_prefill_step(cfg)(params, {
            "tokens": tt[:, :LM_PROMPT], "labels": tt[:, :LM_PROMPT]})
    cached = res["logits"][:LM_PROMPT].transpose(0, 1)
    pre = float((full - cached).abs().max())
    if not torch.allclose(full, cached, atol=1e-3, rtol=1e-3) or not bool(
            torch.isfinite(metrics["loss"])):
        failures.append(f"lm: cache-free prompt logits differ from the "
                        f"cached decode by {pre:.3g} (prefill loss "
                        f"{float(metrics['loss'])})")
    print(f"lm: teacher-forced reference vs cuda logits over {steps} steps "
          f"{worst:.3g}; greedy flips {flips} (allowed at top-2 margin <= "
          f"1e-3); generated-token agreement of the free-running backends "
          f"{agree * 100:.1f}%; cache-free prefill vs cached decode over the "
          f"{LM_PROMPT}-token prompt {pre:.3g}, prefill loss "
          f"{float(metrics['loss']):.4f}; flash_decode launches {launched} "
          f"in {steps} cuda steps ({cfg.num_layers} per step expected), "
          f"{sum(counts.values())} kernel launches on reference")

    # kernel cases: the served run's inputs, then shapes off the run
    hold("lm early decode step", got[early])
    hold("lm first decode step", got[first])
    hold("lm last step", got[last])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, B, S, Hkv, G, D, valid in FD_CASES:
        q = torch.randn(B, Hkv, G, D, generator=gen, device=dev)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
                for _ in range(2))
        hold(label, [((q, k, v, torch.full((1,), valid, dtype=torch.int32,
                                           device=dev)), {})])
        del q, k, v

    # one decode step past the prompt may not sync with the host
    fstep = make_serve_step(cfg, "cuda")
    cache = registry.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    nxt, cache, _ = fstep(params, cache, {
        "tokens": tt[:, :1], "pos": torch.zeros((), dtype=torch.int32,
                                                device=dev)})
    batch = {"tokens": nxt[:, None],
             "pos": torch.ones((), dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        fstep(params, cache, batch)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("lm: one decode step under set_sync_debug_mode('error'): no "
              "host sync")
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode("default")
        failures.append(f"lm: the decode step syncs with the host: {e}")
    # a decode step near the end of the cache (position 500 of 512 slots),
    # profiled; the cache's positions are set back before each call (one
    # fill kernel)
    p0 = steps - 11
    at = torch.full((), p0, dtype=torch.int32, device=dev)

    def decode_step():
        cache["pos"].fill_(p0)
        fstep(params, cache, {"tokens": batch["tokens"], "pos": at})
    profile_steps("lm decode step", decode_step)


def golden_mismatch(out, want) -> list:
    """The counters of a replay row that differ from a golden cell (the
    ones the golden tests check), as 'name got/want' strings."""
    from repro_torch.serving import outcome_digest
    pairs = [("outcome_digest", outcome_digest(out["outcomes"]),
              want["outcome_digest"]),
             ("migrations", out["resize_events"], want["migrations"])]
    pairs += [(k, out[k], want[k]) for k in (
        "ticks", "sessions", "preemptions", "restores", "deadline_missed",
        "capacity_final", "sessions_rejected", "sessions_degraded",
        "shed_windows", "frames_scored", "frames_skipped") if k in want]
    for p, d in want["per_priority"].items():
        got = out["latency_ms_by_priority"].get(p, {})
        pairs += [(f"priority {p} {k}", got.get(k), v) for k, v in d.items()]
    return [f"{k} {g}/{w}" for k, g, w in pairs if g != w]


def sessions_phase(dev, failures, check_launches, per_clip, per_tick):
    """Phase 10: ``GcnService`` through the public API — the golden trace
    replays on ``cuda`` at the reduced config, a generated trace at full
    width on ``cuda`` against ``reference``, and a two-skeleton service on
    both backends."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import init_params
    from repro_torch.core.pruning.plan import build_prune_plan
    from repro_torch.serving import (GcnService, SloConfig, Trace,
                                     TrafficConfig, generate_trace,
                                     outcome_digest, replay)

    t_phase = time.perf_counter()
    traces = ROOT / "tests" / "data" / "traces"
    golden = json.loads((traces / "golden_smoke.json").read_text())
    sal = json.loads((traces / "golden_saliency.json").read_text())
    smoke = Trace.load(str(traces / "smoke.json"))
    if smoke.digest() != golden["trace_digest"]:
        failures.append("sessions: smoke.json does not have the golden "
                        "trace digest")

    # ---- (a) the golden replays on cuda, with the port's own weights ------
    rcfg = get_config(ARCH, reduced=True)
    rp = init_params(rcfg, seed=SEED, device=dev)
    pp = build_prune_plan([b["Wk"].cpu().numpy() for b in rp["blocks"]],
                          rcfg.gcn_channels, [1.0, 0.5, 0.5, 0.5],
                          "cav-70-1", input_skip=2)
    rplan = engine.build_execution_plan(rp, rcfg, pp, quant=True,
                                        backend="cuda")
    xr = torch.randn((2, rcfg.gcn_frames, rcfg.gcn_joints,
                      rcfg.gcn_in_channels),
                     generator=torch.Generator().manual_seed(SEED + 1))
    rbn = engine.collect_bn_stats(rplan, xr.to(dev))
    nb = len(rcfg.gcn_channels)          # one stream: no ensemble
    per_tick_r = dict.fromkeys(per_tick, 0)
    per_tick_r.update(graph_sconv=nb, cavity_tconv_step=nb,
                      rfc_encode=nb - 1, rfc_decode=nb - 1)
    cells = [(golden, "fifo/demand"), (golden, "fifo/slo"),
             (golden, "fifo/slo-degrade"), (sal, "fifo/demand"),
             (sal, "preempt/demand"), (golden, "preempt/demand"),
             (golden, "preempt/slo"), (golden, "deadline/demand"),
             (golden, "deadline/slo")]
    t0 = time.perf_counter()
    total, steps = collections.Counter(), 0
    done = []
    for i, (src, cell) in enumerate(cells):
        if i >= 5 and time.perf_counter() - t0 > SESSIONS_GOLDEN_S:
            break                        # the optional cells past the budget
        qos, policy = cell.split("/")
        pol = "slo" if policy.startswith("slo") else "demand"
        slo = (SloConfig(**{**golden["slo"], "shed_mode": "degrade"
                            if policy == "slo-degrade" else "reject"})
               if pol == "slo" else None)
        gated = src is sal
        out, counts = counted(lambda: replay(
            rcfg, smoke, backend="cuda", qos=qos, policy=pol,
            capacity_tiers=tuple(src["tiers"]), slo_config=slo,
            plans=(rplan,), bn_stats=(rbn,), record_outcomes=True,
            saliency_thresh=src["saliency_thresh"] if gated else 0.0,
            device=dev))
        total.update(counts)
        # the warm-up steps the plain step and the fused tick once per tier
        want_n = out["device_dispatches"] + 2 * len(src["tiers"])
        steps += want_n
        bad = golden_mismatch(out, src["cells"][cell])
        label = f"{cell}{' saliency' if gated else ''}"
        for name, n in per_tick_r.items():
            if counts[name] != n * want_n:
                bad.append(f"{name} launches {counts[name]}/{n * want_n}")
        if bad:
            failures.append(f"sessions golden {label}: {bad}")
        done.append(label)
        print(f"sessions: golden {label} on cuda (reduced {ARCH}, port "
              f"weights): {'ok' if not bad else 'FAIL'}, digest "
              f"{outcome_digest(out['outcomes'])[:12]}, {out['ticks']} "
              f"ticks, {out['sessions']} sessions, preemptions "
              f"{out['preemptions']}, capacity {out['capacity_final']}, "
              f"{out['readbacks']} readbacks")
    check_launches("sessions golden", dict(total), per_tick_r, steps)
    print(f"sessions: {len(done)} golden cells of {len(cells)} in "
          f"{time.perf_counter() - t0:.1f} s; launches {dict(total)} in "
          f"{steps} steps (warm-up included)")

    # ---- (b) full width: a generated trace, cuda against reference --------
    cfg = get_config(ARCH)
    trace = generate_trace(TrafficConfig(
        n_sessions=SESSIONS_N, mean_frames=48, min_frames=16, max_frames=96,
        high_priority_ratio=0.3, seed=7), name="chip-sessions")
    rows = {}
    for backend in ("cuda", "reference"):
        t0 = time.perf_counter()
        out, counts = counted(lambda: replay(
            cfg, trace, backend=backend, qos="preempt", policy="demand",
            capacity_tiers=SESSIONS_TIERS, record_outcomes=True, seed=SEED,
            device=dev))
        wall = time.perf_counter() - t0
        rows[backend] = out
        # construction calibrates both streams (one clip pass each) and
        # warms the plain step and the fused tick once per tier
        warm = 2 * len(SESSIONS_TIERS)
        if backend == "cuda":
            per_tick_got = check_launches(
                "sessions", counts, per_tick, out["device_dispatches"] + warm,
                base=per_clip)
        t = out["ticks"]
        print(f"sessions: backend={backend} full {ARCH}, {SESSIONS_N} "
              f"sessions (trace {trace.digest()}), preempt, tiers "
              f"{SESSIONS_TIERS}: {out['sessions'] / out['wall_s']:.3f} "
              f"sessions/s, {out['frames_per_s']:.2f} frames/s, {t} ticks, "
              f"tick p50 {out['tick_ms_p50']:.3f} ms mean "
              f"{out['tick_ms_mean']:.3f} ms (host clock inside tick, no "
              f"synchronise), {out['wall_s'] / t * 1e3:.3f} ms a tick over "
              f"the run (host {out['wall_host_s'] / t * 1e3:.3f}, of it "
              f"issuing the upload and steps "
              f"{out['wall_dispatch_s'] / t * 1e3:.3f} and the scheduler "
              f"{(out['wall_host_s'] - out['wall_dispatch_s']) / t * 1e3:.3f}"
              f"; forced readback waits "
              f"{out['wall_device_s'] / t * 1e3:.3f}); "
              f"{out['device_dispatches']} device_dispatches, "
              f"{out['readbacks']} forced readbacks, preemptions "
              f"{out['preemptions']}, migrations {out['resize_events']}, "
              f"occupancy {out['occupancy'] * 100:.1f}%; {wall:.1f} s with "
              f"construction")
    print(f"sessions: launches per tick by name (cuda) "
          f"{ {k: v for k, v in per_tick_got.items() if v} }")
    c, r = rows["cuda"], rows["reference"]
    dc, dr = outcome_digest(c["outcomes"]), outcome_digest(r["outcomes"])
    lc = {x.sid: x.logits for x in c["records"]}
    lr = {x.sid: x.logits for x in r["records"]}
    diff = max((float(np.abs(lc[k] - lr[k]).max()) for k in lc if k in lr),
               default=float("inf"))
    top1 = float(np.mean([lc[k].argmax() == lr[k].argmax() for k in lc
                          if k in lr])) if lc else 0.0
    bad = []
    if dc != dr:
        bad.append(f"outcome digests differ ({dc[:12]} vs {dr[:12]})")
    if sorted(lc) != sorted(lr) or len(lc) != SESSIONS_N:
        bad.append(f"finished {sorted(lc)} vs {sorted(lr)}")
    if not all(np.isfinite(v).all() and np.allclose(v, lr[k], atol=1e-3,
                                                    rtol=1e-3)
               for k, v in lc.items() if k in lr) or top1 != 1.0:
        bad.append(f"logits differ by {diff:.3g}, top-1 {top1}")
    if not c["preemptions"] or not c["resize_events"]:
        bad.append("the trace made no preemption or no migration")
    if bad:
        failures.append(f"sessions full width: {bad}")
    print(f"sessions: full width cuda vs reference: digests "
          f"{'equal' if dc == dr else 'DIFFER'} ({dc[:12]}), {len(lc)} "
          f"finished sessions, max |logit difference| {diff:.3g}, top-1 "
          f"agreement {top1 * 100:.1f}%")

    # ---- (c) two skeletons in one service, cuda against reference ---------
    rng = np.random.default_rng(SEED + 2)
    script = [(topo, rng.standard_normal((MIXED_SVC_FRAMES, v, 3)).astype(
        np.float32)) for topo, v in (("ntu25", 25), ("ntu50", 50),
                                     ("ntu50", 50), ("ntu25", 25))]
    got = {}
    for backend in ("cuda", "reference"):
        t0 = time.perf_counter()

        def drive():
            svc = GcnService(cfg, backend=backend,
                             topologies=("ntu25", "ntu50"),
                             capacity_tiers=(len(script),), seed=SEED,
                             device=dev)
            hs = [svc.open_session(topology=t) for t, _ in script]
            fed = [0] * len(hs)
            t = 0
            while min(fed) < MIXED_SVC_FRAMES:
                # frames arrive 0, 1 or 2 at a time: a session whose buffer
                # runs dry is held
                for k, (h, (_, clip)) in enumerate(zip(hs, script)):
                    for _ in range((1, 0, 2, 1)[(t + k) % 4]):
                        if fed[k] < MIXED_SVC_FRAMES:
                            svc.submit(h, clip[fed[k]])
                            fed[k] += 1
                svc.tick()
                t += 1
            for h in hs:
                svc.close(h)
            svc.run_until_idle()
            return svc, [svc.poll(h) for h in hs]

        (svc, sts), counts = counted(drive)
        if backend == "cuda":
            # calibration: one clip pass per skeleton; warm-up: the primary
            # step, the other group's step and the fused tick
            check_launches("sessions mixed", counts, per_tick,
                           svc.device_dispatches + 3,
                           base={k: 2 * v for k, v in per_clip.items()})
        if any(s.state != "done" for s in sts):
            failures.append(f"sessions mixed {backend}: states "
                            f"{[s.state for s in sts]}")
        got[backend] = [s.logits for s in sts]
        m = svc.metrics(keep_records=0)
        print(f"sessions: mixed ntu25+ntu50 backend={backend}: "
              f"{len(sts)} sessions in {m['ticks']} ticks, "
              f"{m['device_dispatches']} dispatches, tick p50 "
              f"{m['tick_ms_p50']:.3f} ms, {time.perf_counter() - t0:.1f} s "
              f"with construction")
    d = max(float(np.abs(a - b).max())
            for a, b in zip(got["cuda"], got["reference"]))
    if not all(np.allclose(a, b, atol=1e-3, rtol=1e-3)
               for a, b in zip(got["cuda"], got["reference"])):
        failures.append(f"sessions mixed: cuda vs reference logits differ "
                        f"by {d:.3g}")
    print(f"sessions: mixed cuda vs reference, every session {d:.3g}")
    print(f"sessions: phase time {time.perf_counter() - t_phase:.1f} s")


def card_tests(failures) -> None:
    """The card_tests phase: the JAX-free kernel tests, every case marked
    ``cuda``, in a pytest process of their own; fails unless every selected
    case passes and none skips."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p",
           "no:cacheprovider", "-m", "cuda", CARD_TESTS]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    tail = out.stdout.strip().splitlines()[-1:] or [""]
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|errors?|deselected)", tail[0])}
    print(f"card_tests: {counts.get('passed', 0)} passed")
    print(f"card_tests: {tail[0]} ({' '.join(cmd[1:])}, exit {out.returncode})")
    if out.returncode != 0 or counts.get("skipped") or not counts.get(
            "passed"):
        print(out.stdout[-6000:], out.stderr[-3000:], sep="\n")
        failures.append(f"card_tests: exit {out.returncode}, {tail[0]}")


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
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import (bone_stream, bone_stream_parents,
                                             init_params)
    from repro_torch.core.pruning.plan import plan_from_config
    from repro_torch.data.pipeline import DataConfig, skeleton_batches
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cavity_tconv as ct
    from repro_torch.kernels import graph_sconv as gs
    from repro_torch.kernels import rfc_pack as rp
    from repro_torch.kernels import window_sim as ws
    from repro_torch.launch.serve import serve_gcn, serve_gcn_stream
    from repro_torch.train.steps import (make_gcn_fused_tick,
                                         make_gcn_infer_step,
                                         make_gcn_slab_step,
                                         make_gcn_stream_step)
    modules = (gs, ct, rp, ws)

    # ---- 1. device ---------------------------------------------------------
    smi = smi_line()
    dev = torch.device(DEVICE)
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

    phase_done("build")

    failures, cases, summary = [], {}, {}
    card_tests(failures)
    phase_done("card_tests")

    # ---- 3. kernels against their plain versions ---------------------------
    cfg = get_config(ARCH)
    nblocks = len(cfg.gcn_channels)
    gen = torch.Generator().manual_seed(SEED)
    params = [init_params(cfg, gen, device=dev) for _ in ("joint", "bone")]
    prune_plan = plan_from_config(cfg)

    def plans_for(params_, cfg_, backend="cuda", **kw):
        return tuple(engine.build_execution_plan(
            p, cfg_, prune_plan, quant=True, backend=backend, **kw)
            for p in params_)

    plans = plans_for(params, cfg)
    dcfg = DataConfig(global_batch=BATCH, seq_len=cfg.gcn_frames, seed=SEED)
    x0 = torch.from_numpy(next(skeleton_batches(cfg, dcfg))["x"]).to(dev)
    infer = make_gcn_infer_step(cfg)
    stream_step = make_gcn_stream_step(cfg)
    # launches per ensemble step of each path (10 blocks, 9 transfers, 2
    # streams); calibration runs one clip pass per stream
    per_clip = {"graph_sconv": 2 * nblocks, "cavity_tconv": 2 * nblocks,
                "cavity_tconv_step": 0, "rfc_encode": 2 * (nblocks - 1),
                "rfc_decode": 2 * (nblocks - 1), "graph_sconv_csr": 0,
                "windowed_similarity": 0}
    per_tick = dict(per_clip, cavity_tconv=0, cavity_tconv_step=2 * nblocks)
    # CSR plans run graph_sconv_csr where dense ones run graph_sconv; C_k
    # plans run the spatial product as an einsum (no graph_sconv) and, on a
    # stream tick, windowed_similarity
    per_csr_clip = dict(per_clip, graph_sconv=0, graph_sconv_csr=2 * nblocks)
    per_csr_tick = dict(per_tick, graph_sconv=0, graph_sconv_csr=2 * nblocks)
    per_ck_clip = dict(per_clip, graph_sconv=0)
    per_ck_tick = dict(per_tick, graph_sconv=0,
                       windowed_similarity=2 * nblocks)

    def hold_cases(path, captured, expect, measure=None):
        """Check the calls per kernel of one step against ``expect`` and
        hold the kernels named in ``measure`` (default: all it calls)
        against their plain versions on the captured inputs."""
        for name, n in expect.items():
            if len(captured[name]) != n:
                failures.append(f"{path} {name}: one step made "
                                f"{len(captured[name])} calls, expected {n}")
            if not n or (measure is not None and name not in measure):
                continue
            if name == "cavity_tconv_step":
                # a window whose kept-tap frames are all zero cannot tell a
                # right kernel from a wrongly indexed one
                empty = [i for i, (a, _) in enumerate(captured[name])
                         if any(not _chrono(a[0], a[1])[:, k].any()
                                for k in set(a[3].flatten().tolist()))]
                if empty:
                    failures.append(f"{path} {name}: calls {empty} read a "
                                    f"kept-tap frame that is all zero")
            if name == "windowed_similarity":
                # all-zero rings give uniform rows whatever the kernel does
                empty = [i for i, (a, _) in enumerate(captured[name])
                         if not all(r[s].any() for r in a[:2]
                                    for s in range(r.shape[0]))]
                if empty:
                    failures.append(f"{path} {name}: calls {empty} hold a "
                                    f"slot whose rings are all zero")
            hold(path, name, captured[name])
            if name == "windowed_similarity":
                # the bare form on the same calls' new rings
                hold(f"{path} bare", name, [
                    ((*ws.windowed_similarity_step_plain(*a)[:2], a[-1]), {})
                    for a, _ in captured[name]])
        return captured

    def hold(path, name, calls):
        """Hold one kernel against its plain version on ``calls`` (a list
        of (args, kwargs)), time both and record the per-step sums."""
        t_hold = time.perf_counter()
        cs = [measure_case(name, a, k, modules) for a, k in calls]
        t_hold = time.perf_counter() - t_hold
        cases[f"{path}/{name}"] = cs
        bad = [i for i, c in enumerate(cs) if not c["ok"]]
        if bad:
            failures.append(f"{path} {name}: kernel disagrees with its "
                            f"plain version on cases {bad}")
        s = summary[(path, name)] = summarize(cs)
        tc = (f", float32 bound {s['bound_f32_ms']:.4f}, 3-pass floor "
              f"{s['split_floor_ms']:.4f}" if "split_floor_ms" in s else "")
        if "ms_l2" in s:
            where = ("rotating copies past the L2" if s["cold"]
                     else "copies that fit the L2")
            tc += f"; timed on {where}, {s['ms_l2']:.4f} on one set of inputs"
        if "composite_ms" in s:
            tc += (f"; {s['form']} form, composite of 4 PyTorch calls "
                   f"{s['composite_ms']:.4f}")
        print(f"kernel {name} [{path}]: {'ok' if not bad else 'FAIL'} on "
              f"{len(cs)} inputs (held and timed in {t_hold:.1f} s), "
              f"max_abs_err {s['max_abs_err']:.3g}; per "
              f"ensemble step {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
              f"library {s['library_ms']}, bound {s['bound_ms']:.4f} ms by "
              f"{s['bound_by']}{tc})")

    clip_calls = hold_cases("clip", capture(modules, lambda: infer(plans, x0)),
                            per_clip)
    # stream ticks at S slots, STREAM_WARM raw frames into the clip (past
    # the first-logit delay and the last block's first full window, so
    # every kept tap reads data), on the frozen statistics of this batch;
    # the later streams' ticks are held on their own runs' states
    delay = engine.stream_first_logit_delay(plans[0])
    if STREAM_WARM < delay:
        fail(f"{STREAM_WARM} warm-up frames do not reach the last block "
             f"(first-logit delay {delay})")
    bn = [engine.collect_bn_stats(p, xx)
          for p, xx in zip(plans, (x0, bone_stream(x0)))]
    # one state warmed at the largest S; the smaller ticks take its first
    # S slots (slots are independent)
    S8 = STREAM_SLOTS[-1]
    warm8 = tuple(engine.init_stream_state(p, S8, bn_stats=b)
                  for p, b in zip(plans, bn))
    for r in range(STREAM_WARM):
        warm8, _ = stream_step(plans, warm8, x0[:S8, r])
    for S in STREAM_SLOTS:
        states = tuple(first_slots(s_, S) for s_ in warm8)
        tick_calls = hold_cases(f"stream S={S}", capture(
            modules, lambda: stream_step(plans, states, x0[:S, STREAM_WARM])),
            per_tick)
    # the RFC entry points the paths above do not take: encode without res
    # (on the clip step's t) and the step form with a mixed keep (the S = 8
    # tick's inputs, every other slot keeping its old leaves, which the
    # lockstep tick never does)
    hold("clip no res", "rfc_encode", [
        ((a[0], None, None, None, None), {})
        for a, _ in clip_calls["rfc_encode"]])
    mixed = torch.arange(S8, device=dev) % 2 == 0
    hold(f"stream S={S8} mixed keep", "rfc_encode", [
        ((a[0], a[1], a[2], mixed, a[4]), {})
        for a, _ in tick_calls["rfc_encode"]])

    # ntu50: the two-person NTU scene as one 50-joint skeleton (persons
    # not folded into the batch), same weights as ntu25 but B_k's width
    cfg50 = dataclasses.replace(cfg, gcn_joints=VMAX, gcn_persons=1)
    gen50 = torch.Generator().manual_seed(SEED)
    params50 = [init_params(cfg50, gen50, device=dev) for _ in range(2)]
    csr50 = plans_for(params50, cfg50, topology="ntu50", sconv="csr",
                      csr_eps=CSR_EPS)
    csr50_dv = plans_for(params50, cfg50, topology="ntu50", sconv="csr",
                         csr_eps=0.0)
    dense50 = plans_for(params50, cfg50, topology="ntu50", sconv="dense")
    clips50 = skeleton_batches(cfg50, DataConfig(
        global_batch=BATCH, seq_len=cfg.gcn_frames, seed=SEED))
    x50 = torch.from_numpy(next(clips50)["x"]).to(dev)

    def bone50(x):
        return bone_stream_parents(x, csr50[1].arrays["parents"])

    hold_cases("ntu50 csr clip", capture(modules, lambda: infer(csr50, x50)),
               per_csr_clip, {"graph_sconv_csr"})
    hold_cases("ntu50 dense clip", capture(
        modules, lambda: infer(dense50, x50)), per_clip, {"graph_sconv"})
    bn50 = [engine.collect_bn_stats(p, xx)
            for p, xx in zip(csr50, (x50, bone50(x50)))]

    # hand21 and body_hand46 on dense plans (sconv="auto" keeps their
    # graphs dense at csr_eps = 0): graph_sconv's 6 rows x 21 and 2 rows x
    # 46 joints a 128-pair tile, on one clip step and one S = 8 tick
    # STREAM_WARM frames in
    for topo, vt in DENSE_SKELETONS:
        cfg_t = dataclasses.replace(cfg, gcn_joints=vt, gcn_persons=1)
        gen_t = torch.Generator().manual_seed(SEED)
        params_t = [init_params(cfg_t, gen_t, device=dev) for _ in range(2)]
        plans_t = plans_for(params_t, cfg_t, topology=topo, sconv="dense")
        xt = torch.from_numpy(next(skeleton_batches(cfg_t, DataConfig(
            global_batch=BATCH, seq_len=cfg.gcn_frames, seed=SEED)))["x"]
            ).to(dev)
        hold_cases(f"{topo} dense clip", capture(
            modules, lambda: infer(plans_t, xt)), per_clip, {"graph_sconv"})
        bone_t = bone_stream_parents(xt, plans_t[1].arrays["parents"])
        st = tuple(engine.init_stream_state(p, S8, bn_stats=engine.
                                            collect_bn_stats(p, xx))
                   for p, xx in zip(plans_t, (xt, bone_t)))
        for r in range(STREAM_WARM):
            st, _ = stream_step(plans_t, st, xt[:S8, r])
        hold_cases(f"{topo} dense stream S={S8}", capture(
            modules, lambda: stream_step(plans_t, st, xt[:S8, STREAM_WARM])),
            per_tick, {"graph_sconv"})
        del params_t, plans_t, st

    # RFC off the main path: a width that is not a whole number of banks
    xr = torch.randn(2400 * 25, 38, generator=gen).to(dev)
    vals, bits = ops.rfc_encode(xr)
    pv, pb = rp.rfc_encode_plain(torch.nn.functional.pad(xr, (0, 10)))
    rt = ops.rfc_decode(vals, bits)
    torch.cuda.synchronize()
    rfc_pad_ok = (torch.equal(vals, pv[:, :38]) and torch.equal(bits, pb)
                  and torch.equal(rt, torch.relu(xr)))
    print(f"kernel rfc C=38 (padded to 48): {'ok' if rfc_pad_ok else 'FAIL'}")
    if not rfc_pad_ok:
        failures.append("rfc: C % 16 != 0 case is not bit-equal")

    phase_done("kernels")
    launches, per_step = {}, {}

    def check_launches(path, counts, expect, steps, base=None):
        """Check ``counts`` against ``expect`` per step over ``steps``
        steps plus ``base`` launches outside them (a service's
        calibration); returns the launches per step."""
        base = base or {}
        launches[path] = counts
        per_step[path] = {k: (v - base.get(k, 0)) / steps
                          for k, v in counts.items()}
        for name in counts:          # kernels missing from expect: none
            n = expect.get(name, 0) * steps + base.get(name, 0)
            if counts[name] != n:
                failures.append(f"{path} {name}: {counts[name]} launches in "
                                f"{steps} steps, expected {n}")
        return per_step[path]

    # ---- 4. the main path: clip serving ------------------------------------
    res, counts = counted(lambda: serve_gcn(
        ARCH, reduced=False, batch=BATCH, clips=CLIPS, seed=SEED,
        backends=("cuda", "reference"), device=dev))
    steps = res["cuda"]["steps"]
    check_launches("clip", counts, per_clip, steps)
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
          f"{agree * 100:.1f}%, launches {launches['clip']} in {steps} steps")

    phase_done("main")

    # ---- 5. streaming --------------------------------------------------------
    sres, counts = counted(lambda: serve_gcn_stream(
        ARCH, reduced=False, batch=STREAM_CLIPS, seed=SEED,
        backends=("cuda", "reference"), device=dev))
    sc, sr = sres["cuda"], sres["reference"]
    launches["stream phase"] = counts
    nseq = STREAM_CLIPS * cfg.gcn_persons
    if sc["flush"] != 149 or sc["steps"] != cfg.gcn_frames + 149 + 2:
        failures.append(f"stream: {sc['steps']} steps with {sc['flush']} "
                        f"flush frames, expected 451 with 149")
    parts = sc["launches"]
    for name in per_clip:
        want = {"calibration": per_clip[name], "clip": per_clip[name],
                "stream": per_tick[name] * sc["steps"]}
        for phase, n in want.items():
            if parts[phase][name] != n:
                failures.append(f"stream {phase} {name}: "
                                f"{parts[phase][name]} launches, expected {n}")
        if counts[name] != sum(want.values()):
            failures.append(f"stream {name}: {counts[name]} launches in the "
                            f"phase, expected {sum(want.values())}")
    per_step["stream"] = {k: v / sc["steps"] for k, v in
                          parts["stream"].items()}
    for name, r in sres.items():
        if (r["logits"].shape != (nseq, cfg.gcn_num_classes)
                or not np.isfinite(r["logits"]).all()):
            failures.append(f"stream {name}: logits {r['logits'].shape} or "
                            f"not finite")
        d = float(np.abs(r["logits"] - r["clip_logits"]).max())
        if (not np.allclose(r["logits"], r["clip_logits"], atol=1e-3,
                            rtol=1e-3) or r["clip_agreement"] != 1.0):
            failures.append(f"stream {name}: post-drain logits differ from "
                            f"clip logits by {d:.3g}, top-1 agreement "
                            f"{r['clip_agreement']}")
        print(f"stream: backend={name} {r['frames_per_s']:.2f} frames/s "
              f"({nseq} sequences x {sc['steps'] - 2} steps), latency per "
              f"step p50 {r['latency_ms_p50']:.3f} ms mean "
              f"{r['latency_ms_mean']:.3f} ms; post-drain vs clip logits "
              f"{d:.3g}, top-1 agreement {r['clip_agreement'] * 100:.1f}%")
    d = float(np.abs(sc["logits"] - sr["logits"]).max())
    if not np.allclose(sc["logits"], sr["logits"], atol=1e-3, rtol=1e-3):
        failures.append(f"stream: cuda vs reference last-step logits differ "
                        f"by {d:.3g}")
    print(f"stream: cuda vs reference last step {d:.3g}; drain "
          f"{sc['flush']} frames, first-logit delay "
          f"{engine.stream_first_logit_delay(plans[0])} raw frames; "
          f"launches {parts}")

    phase_done("stream")

    # ---- 6. the session slab: the fused serving tick -------------------------
    tick = make_gcn_fused_tick(cfg)
    rng = np.random.default_rng(SEED)
    clips = (x0[0, :SESSION_FRAMES].cpu().numpy()[None] + rng.standard_normal(
        (SESSIONS, SESSION_FRAMES, 25, 3)).astype(np.float32) * 0.05)
    slabs = tuple(engine.init_session_slab(p, SLAB_SLOTS, bn_stats=b)
                  for p, b in zip(plans, bn))
    rings = tuple(engine.init_snapshot_ring(s, RING_ROWS) for s in slabs)
    flush = engine.stream_flush_frames(plans[0], SESSION_FRAMES)
    (got, lat, events, slabs, rings), counts = counted(
        lambda: run_slab_script(tick, plans, slabs, rings, clips, flush, dev))
    ticks = events["ticks"]
    check_launches("slab", counts, per_tick, ticks)
    if (events["snapshot"], events["restore"], events["hold"],
            events["admit"]) != (2, 2, 4, SESSIONS):
        failures.append(f"slab: the script ran events {dict(events)}, "
                        f"expected 2 snapshots, 2 restores, 4 holds and "
                        f"{SESSIONS} admissions")
    # every session alone: one lockstep batch from tick 0 (slots are
    # independent), the same frames and drain
    alone = tuple(engine.init_stream_state(p, SESSIONS, bn_stats=b)
                  for p, b in zip(plans, bn))
    xc = torch.from_numpy(clips).to(dev)
    zeros = torch.zeros_like(xc[:, 0])
    for r in range(SESSION_FRAMES + flush):
        alone, want = stream_step(plans, alone, xc[:, r] if r < SESSION_FRAMES
                                  else zeros, r < SESSION_FRAMES)
    want = want.cpu().numpy()
    if sorted(got) != list(range(SESSIONS)):
        failures.append(f"slab: sessions {sorted(got)} finished, expected "
                        f"all {SESSIONS}")
    slab_diff = max((float(np.abs(got[i] - want[i]).max()) for i in got),
                    default=float("inf"))
    bad = [i for i in got if not np.allclose(got[i], want[i], atol=1e-3,
                                             rtol=1e-3)]
    if bad:
        failures.append(f"slab: sessions {bad} differ from their runs alone "
                        f"(max {slab_diff:.3g})")
    print(f"slab: {len(got)} sessions in {ticks} ticks at {SLAB_SLOTS} slots "
          f"(full {ARCH}, 2-stream, cuda): tick p50 "
          f"{statistics.median(lat):.3f} ms mean {statistics.mean(lat):.3f} "
          f"ms; events {dict(events)}; eviction logits vs each session "
          f"alone {slab_diff:.3g}; launches {launches['slab']}")
    # one tick with its inputs already on the card may not sync with the host
    S = SLAB_SLOTS
    sentinel = torch.full((EVENTS, 2), int(engine.SNAP_SENTINEL),
                          dtype=torch.int32, device=dev)
    snap_o = sentinel.clone()
    snap_o[0] = torch.tensor([0, 2], dtype=torch.int32)
    rest_o = sentinel.clone()
    rest_o[0] = torch.tensor([1, 2], dtype=torch.int32)
    inputs = (xc[:S, 0].contiguous(), torch.ones(S, dtype=torch.bool,
                                                 device=dev),
              torch.zeros(S, dtype=torch.bool, device=dev),
              torch.zeros(S, dtype=torch.bool, device=dev), snap_o, rest_o)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        tick(plans, slabs, *inputs, rings)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("slab: one fused tick under set_sync_debug_mode('error'): no "
              "host sync")
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode("default")
        failures.append(f"slab: the fused tick syncs with the host: {e}")

    phase_done("slab")

    # ---- 7. topology: ntu50 clips and a stream on CSR plans --------------------
    ref50 = plans_for(params50, cfg50, backend="reference", topology="ntu50",
                      sconv="dense")
    batches50 = [x50] + [torch.from_numpy(next(clips50)["x"]).to(dev)
                         for _ in range(TOPO_CLIPS // BATCH - 1)]
    (l_csr, rate_csr, steps50), counts = counted(
        lambda: clip_run(infer, csr50, batches50, dev))
    check_launches("topology", counts, per_csr_clip, steps50)
    (l_dense, rate_dense, _), counts = counted(
        lambda: clip_run(infer, dense50, batches50, dev))
    check_launches("topology dense", counts, per_clip, steps50)
    l_ref, rate_ref, _ = clip_run(infer, ref50, batches50, dev)
    if l_csr.shape != (TOPO_CLIPS, cfg.gcn_num_classes) or not np.isfinite(
            l_csr).all():
        failures.append(f"topology: logits {l_csr.shape} or not finite")
    for label, other in (("reference dense", l_ref), ("cuda dense", l_dense)):
        d = float(np.abs(l_csr - other).max())
        top1 = float(np.mean(l_csr.argmax(-1) == other.argmax(-1)))
        if not np.allclose(l_csr, other, atol=1e-3, rtol=1e-3) or top1 != 1.0:
            failures.append(f"topology: cuda csr vs {label} logits differ by "
                            f"{d:.3g}, top-1 agreement {top1}")
        print(f"topology: ntu50 cuda csr vs {label}: max |logit difference| "
              f"{d:.3g}, top-1 agreement {top1 * 100:.1f}%")
    print(f"topology: ntu50 clips (batch {BATCH}, {TOPO_CLIPS} sequences, "
          f"full {ARCH}, 2-stream): cuda csr {rate_csr:.2f}, cuda dense "
          f"{rate_dense:.2f}, reference dense {rate_ref:.2f} sequences/s")
    states = tuple(engine.init_stream_state(p, x50.shape[0], bn_stats=b)
                   for p, b in zip(csr50, bn50))
    flush50 = engine.stream_flush_frames(csr50[0], cfg.gcn_frames)
    (_, s_logits, s_lat, warm50), counts = counted(lambda: stream_run(
        stream_step, csr50, states, x50, flush50, dev))
    check_launches("topology stream", counts, per_csr_tick,
                   cfg.gcn_frames + flush50 + 2)
    # the kernels on one tick STREAM_WARM frames into that stream, on CSR
    # plans (and at csr_eps = 0, every ELL row full) and a dense plan
    f50 = x50[:, STREAM_WARM]
    degree = {}
    for path, plans_ in (("ntu50 csr stream S=8", csr50),
                         ("ntu50 csr eps=0 stream S=8", csr50_dv)):
        got = hold_cases(path, capture(modules, lambda: stream_step(
            plans_, warm50, f50)), per_csr_tick, {"graph_sconv_csr"})
        degree[path] = sorted({a[1].shape[-1]
                               for a, _ in got["graph_sconv_csr"]})
    if degree["ntu50 csr eps=0 stream S=8"] != [VMAX] or max(
            degree["ntu50 csr stream S=8"]) >= VMAX:
        failures.append(f"graph_sconv_csr: ELL widths D {degree}, expected "
                        f"D = {VMAX} at csr_eps = 0 and D < {VMAX} above")
    hold_cases("ntu50 dense stream S=8", capture(
        modules, lambda: stream_step(dense50, warm50, f50)), per_tick,
        {"graph_sconv"})
    print(f"kernel graph_sconv_csr: ELL widths D per block {degree}")
    clip_l = infer(csr50, x50).cpu().numpy()
    last = s_logits[-1].cpu().numpy()
    d = float(np.abs(last - clip_l).max())
    top1 = float(np.mean(last.argmax(-1) == clip_l.argmax(-1)))
    if not np.allclose(last, clip_l, atol=1e-3, rtol=1e-3) or top1 != 1.0:
        failures.append(f"topology stream: post-drain logits differ from clip "
                        f"logits by {d:.3g}, top-1 agreement {top1}")
    print(f"topology: ntu50 csr stream ({x50.shape[0]} sequences, "
          f"{cfg.gcn_frames} + {flush50} steps): step p50 "
          f"{statistics.median(s_lat):.3f} ms mean "
          f"{statistics.mean(s_lat):.3f} ms; post-drain vs clip {d:.3g}, "
          f"top-1 agreement {top1 * 100:.1f}%; launches "
          f"{launches['topology']} in {steps50} clip steps")

    phase_done("topology")

    # ---- 8. one slab, two skeletons ---------------------------------------------
    csr25 = plans_for(params, cfg, sconv="csr", csr_eps=CSR_EPS)
    csr25p = plans_for(params, cfg, sconv="csr", csr_eps=CSR_EPS,
                       pad_joints=VMAX)
    bn25 = [engine.collect_bn_stats(p, xx)
            for p, xx in zip(csr25, (x0, bone_stream(x0)))]
    rng = np.random.default_rng(SEED + 1)
    sessions = []
    for i in range(MIXED_SESSIONS):
        # the sessions past the first SLAB_SLOTS take the slots that free
        # first, which the other skeleton held
        first = (i % 2 == 0) != (i >= SLAB_SLOTS)
        topo, src = ("ntu25", x0) if first else ("ntu50", x50)
        clip = src[i % src.shape[0], :MIXED_FRAMES].cpu().numpy()
        sessions.append((topo, i * MIXED_EVERY, clip + rng.standard_normal(
            clip.shape).astype(np.float32) * 0.05))
    # stem statistics of the 25-joint group are padded to VMAX by the step
    groups = {"ntu25": (csr25p, tuple(bn25)), "ntu50": (csr50, tuple(bn50))}
    mslabs = tuple(engine.init_session_slab(p, SLAB_SLOTS, bn_stats=b)
                   for p, b in zip(csr25p, bn25))
    mflush = engine.stream_flush_frames(csr25[0], MIXED_FRAMES)
    (got, lat, dispatches, reused), counts = counted(lambda: run_mixed_script(
        make_gcn_slab_step(cfg), groups, mslabs, sessions, mflush, dev))
    check_launches("mixed", counts, per_csr_tick, dispatches)
    if sorted(got) != list(range(MIXED_SESSIONS)) or len(reused) < 2:
        failures.append(f"mixed: sessions {sorted(got)} finished, slot reuse "
                        f"across skeletons {dict(reused)}; expected all "
                        f"{MIXED_SESSIONS} and reuse by both skeletons")
    mixed_diff = 0.0
    for topo, narrow, stats in (("ntu25", csr25, bn25),
                                ("ntu50", csr50, bn50)):
        ids = [i for i, s_ in enumerate(sessions) if s_[0] == topo]
        xs = torch.from_numpy(np.stack([sessions[i][2] for i in ids])).to(dev)
        alone = tuple(engine.init_stream_state(p, len(ids), bn_stats=b)
                      for p, b in zip(narrow, stats))
        zeros = torch.zeros_like(xs[:, 0])
        for r in range(MIXED_FRAMES + mflush):
            alone, want = stream_step(narrow, alone, xs[:, r]
                                      if r < MIXED_FRAMES else zeros,
                                      r < MIXED_FRAMES)
        want = want.cpu().numpy()
        for j, i in enumerate(ids):
            if i not in got:
                continue
            mixed_diff = max(mixed_diff, float(np.abs(got[i] - want[j]).max()))
            if not np.allclose(got[i], want[j], atol=1e-4, rtol=1e-4):
                failures.append(f"mixed: session {i} ({topo}) differs from "
                                f"its run alone on a narrow plan")
    print(f"mixed: {len(got)} sessions (ntu25 padded to {VMAX}, ntu50) in "
          f"{len(lat)} ticks at {SLAB_SLOTS} slots, {dispatches} group "
          f"dispatches, slots reused across skeletons {dict(reused)}: tick "
          f"p50 {statistics.median(lat):.3f} ms mean "
          f"{statistics.mean(lat):.3f} ms; eviction logits vs each session "
          f"alone on a narrow plan {mixed_diff:.3g}; launches "
          f"{launches['mixed']}")

    phase_done("mixed")

    # ---- 9. adaptive streaming: the windowed C_k ----------------------------------
    # a use_ck plan, every column live, and the same plan padded to VMAX
    # joints (25 live)
    cfg_ck = dataclasses.replace(cfg, use_ck=True)
    gen_ck = torch.Generator().manual_seed(SEED)
    params_ck = [init_params(cfg_ck, gen_ck, device=dev) for _ in range(2)]
    ck_plans = plans_for(params_ck, cfg_ck)
    ck_pad = plans_for(params_ck, cfg_ck, pad_joints=VMAX)
    xs = x0[:S8]
    ck_ref = plans_for(params_ck, cfg_ck, backend="reference")
    flush_ck = engine.stream_flush_frames(ck_plans[0], cfg.gcn_frames)
    ck_steps = cfg.gcn_frames + flush_ck + 2
    ck = {}
    for backend, plans_ in (("cuda", ck_plans), ("reference", ck_ref)):
        states, counts = counted(lambda: tuple(
            engine.init_stream_state(p, S8, x_calib=xx)
            for p, xx in zip(plans_, (xs, bone_stream(xs)))))
        if backend == "cuda":
            check_launches("ck calibration", counts, per_ck_clip, 1)
        (_, logits, lat, warm), counts = counted(lambda: stream_run(
            stream_step, plans_, states, xs, flush_ck, dev))
        if backend == "cuda":
            check_launches("ck stream", counts, per_ck_tick, ck_steps)
            # the kernel on ticks STREAM_WARM frames into this stream, at
            # its first S slots
            warm_ck = warm
            for S in STREAM_SLOTS:
                st = tuple(first_slots(s_, S) for s_ in warm_ck)
                hold_cases(f"ck stream S={S}", capture(
                    modules, lambda: stream_step(
                        ck_plans, st, xs[:S, STREAM_WARM])), per_ck_tick,
                    {"windowed_similarity"})
        clip_l = infer(plans_, xs).cpu().numpy()
        last = logits[-1].cpu().numpy()
        d = float(np.abs(last - clip_l).max())
        top1 = float(np.mean(last.argmax(-1) == clip_l.argmax(-1)))
        if (last.shape != (S8, cfg.gcn_num_classes) or not np.isfinite(
                last).all() or not np.allclose(last, clip_l, atol=1e-3,
                                               rtol=1e-3) or top1 != 1.0):
            failures.append(f"ck {backend}: post-drain logits differ from "
                            f"clip-mode C_k logits by {d:.3g}, top-1 "
                            f"agreement {top1}")
        ck[backend] = (states, logits, last)
        print(f"ck: backend={backend} {S8 * len(lat) / sum(lat) * 1e3:.2f} "
              f"frames/s ({S8} sequences x {len(lat)} steps, full {ARCH} "
              f"with C_k, 2-stream), step p50 {statistics.median(lat):.3f} ms "
              f"mean {statistics.mean(lat):.3f} ms; post-drain vs clip "
              f"{d:.3g}, top-1 agreement {top1 * 100:.1f}%")
    d = float(np.abs(ck["cuda"][2] - ck["reference"][2]).max())
    top1 = float(np.mean(ck["cuda"][2].argmax(-1)
                         == ck["reference"][2].argmax(-1)))
    if not np.allclose(ck["cuda"][2], ck["reference"][2], atol=1e-3,
                       rtol=1e-3) or top1 != 1.0:
        failures.append(f"ck: cuda vs reference last-step logits differ by "
                        f"{d:.3g}, top-1 agreement {top1}")
    pad_states = tuple(engine.init_stream_state(p, S8, bn_stats=s_.bn_stats)
                       for p, s_ in zip(ck_pad, ck["cuda"][0]))
    xsp = F.pad(xs, (0, 0, 0, VMAX - xs.shape[2]))
    _, pad_logits, _, warm_pad = stream_run(stream_step, ck_pad, pad_states,
                                            xsp, flush_ck, dev)
    got = hold_cases(f"ck padded stream S={S8}", capture(
        modules, lambda: stream_step(ck_pad, warm_pad, xsp[:, STREAM_WARM])),
        per_ck_tick, {"windowed_similarity"})
    if {a[-1] for a, _ in got["windowed_similarity"]} != {x0.shape[2]}:
        failures.append("windowed_similarity: the padded plan's calls do "
                        "not mask the columns past its 25 joints")
    pad_diff = max(float((a - b).abs().max())
                   for a, b in zip(pad_logits, ck["cuda"][1]))
    if not all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
               for a, b in zip(pad_logits, ck["cuda"][1])):
        failures.append(f"ck: the plan padded to {VMAX} joints differs from "
                        f"the narrow one by {pad_diff:.3g}")
    print(f"ck: cuda vs reference last step {d:.3g}, top-1 agreement "
          f"{top1 * 100:.1f}%; padded to {VMAX} joints vs narrow, every step "
          f"{pad_diff:.3g}; launches per stream step "
          f"{per_step['ck stream']}")

    phase_done("ck")

    # ---- 10. sessions: GcnService ---------------------------------------------
    sessions_phase(dev, failures, check_launches, per_clip, per_tick)
    phase_done("sessions")

    # ---- 11. profile ----------------------------------------------------------
    profile_steps("clip", lambda: infer(plans, x0))
    profile_steps(f"stream S={S8}", lambda: stream_step(
        plans, warm8, x0[:S8, STREAM_WARM]))
    profile_steps(f"slab tick S={SLAB_SLOTS}",
                  lambda: tick(plans, slabs, *inputs, rings))
    profile_steps("clip ntu50 csr", lambda: infer(csr50, x50))
    profile_steps(f"ck stream S={S8}", lambda: stream_step(
        ck_plans, warm_ck, xs[:, STREAM_WARM]))

    phase_done("profile")

    # ---- 12. LM decode serving: smollm-360m at full width ---------------------
    lm_phase(dev, failures, cases, summary, check_launches, modules)
    phase_done("lm")

    print(f"clock: spin {spin_cycles_per_ms():.0f} cycles/ms; timings with "
          f"host time included (the plain versions that read taps on the "
          f"host, and any whose queueing outlasted three spins): "
          f"{sorted(HOST_GAPS) or 'none'}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_cases.json").write_text(json.dumps(
        {"device": smi, "cases": cases}, indent=1))

    if failures:
        for f in failures:
            print(f"chip_smoke: FAIL: {f}", file=sys.stderr)
        return 1
    main_case = {"cavity_tconv_step": f"stream S={S8}",
                 "graph_sconv_csr": "ntu50 csr clip",
                 "windowed_similarity": f"ck stream S={S8}",
                 "flash_decode": "lm last step"}
    more_cases = {
        "graph_sconv": [f"stream S={S8}", "ntu50 dense clip",
                        f"ntu50 dense stream S={S8}",
                        *(f"{t} dense {p}" for t, _ in DENSE_SKELETONS
                          for p in ("clip", f"stream S={S8}"))],
        "rfc_encode": [f"stream S={S8}", "clip no res",
                       f"stream S={S8} mixed keep"],
        "rfc_decode": [f"stream S={S8}"],
        "graph_sconv_csr": [f"ntu50 csr stream S={S8}",
                            f"ntu50 csr eps=0 stream S={S8}"],
        "windowed_similarity": [
            *(f"ck stream S={S}{f}" for S in STREAM_SLOTS
              for f in ("", " bare") if (S, f) != (S8, "")),
            f"ck padded stream S={S8}", f"ck padded stream S={S8} bare"],
        "flash_decode": ["lm early decode step", "lm first decode step",
                         *(c[0] for c in FD_CASES)]}
    kernels = []
    for name in _build.KERNELS:
        path = main_case.get(name, "clip")
        entry = {
            "name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
            "replaces": KERNEL_INFO[name][1],
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "launches_per_step": {p: c[name] for p, c in per_step.items()
                                  if c[name]},
            "path": path, **summary[(path, name)],
        }
        for p in more_cases.get(name, ()):
            entry[p] = summary[(p, name)]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
