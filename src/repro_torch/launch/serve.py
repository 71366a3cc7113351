"""Serving CLI for the port — 2s-AGCN two-stream inference and dense LM
decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve clip --arch agcn-2s \\
        [--reduced] [--batch N] [--clips N] \\
        [--backend cuda|reference|both] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve stream --arch agcn-2s \\
        [--reduced] [--batch N] [--backend cuda|reference|both] \\
        [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve sessions \\
        --arch agcn-2s [--reduced] [--slots S] [--n-sessions N] \\
        [--qos fifo|preempt|deadline] [--capacity-tiers 2,4,8] \\
        [--trace FILE] [--policy demand|slo] [--topology NAME] [--ck] \\
        [--saliency-thresh X] [--mesh N] [--replicas R] \\
        [--backend cuda|reference|both] [--device cuda|cpu] [--bench PATH]
    PYTHONPATH=src python -m repro_torch.launch.serve lm --arch smollm-360m \\
        [--reduced] [--batch N] [--prompt-len N] [--gen N] \\
        [--backend cuda|reference|both] [--device cuda|cpu]

Compiles one ExecutionPlan per (stream, backend) from the config's pruning
plan (Q8.8 weights).  ``clip`` drains clip batches through the ensemble
step and prints clips/s per backend.  ``stream`` feeds one clip batch
frame by frame through the per-frame ensemble step, then the flush drain,
and prints frames/s, the per-step latency and the post-drain top-1
agreement with the clip engine.  ``lm`` serves a dense decoder LM with
random weights: a seeded random prompt fed token by token through the
KV-cache decode step, then greedy decoding, and prints tokens/s and the
per-step latency.  ``--backend both`` adds the cross-backend top-1 (token)
agreement.  ``sessions`` serves many independent sessions through
``repro_torch.serving.GcnService`` (generated Poisson or bursty load, or a
recorded trace with ``--trace``), prints the service's metrics and merges
its rows into ``--bench`` (default ``BENCH_torch_sessions.json`` in the
current directory).  ``--mesh N`` splits the session slab over N shards
(N cards, or N logical shards on the CPU with ``--device cpu``) and
``--replicas R`` also serves the load through R service replicas behind
the replica router (``repro_torch.distributed``), one process either way.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device, synchronize
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine
from repro_torch.core.agcn.model import init_params
from repro_torch.core.pruning.plan import plan_from_config
from repro_torch.data.pipeline import DataConfig, skeleton_batches
from repro_torch.kernels import _build
from repro_torch.models import registry
from repro_torch.train.steps import (make_gcn_infer_step, make_gcn_stream_step,
                                     make_serve_step)


def _gcn_setup(arch: str, reduced: bool, batch: int, seed: int,
               device: DeviceLike):
    """(device, config, prune plan, two-stream params, clip batches): the
    weights come from ``init_params`` with one generator seeded by
    ``seed`` (joint stream first), the clips from ``skeleton_batches``."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if cfg.family != "gcn":
        raise ValueError(f"{arch} is not a gcn-family arch")
    gen = torch.Generator().manual_seed(seed)
    params = [init_params(cfg, gen, device=dev) for _ in ("joint", "bone")]
    dcfg = DataConfig(global_batch=batch, seq_len=cfg.gcn_frames, seed=seed)
    return (dev, cfg, plan_from_config(cfg), params,
            skeleton_batches(cfg, dcfg))


def serve_gcn(arch: str, *, reduced: bool = True, batch: int = 8,
              clips: int = 64, seed: int = 0,
              backends: Sequence[str] = ("cuda",),
              device: DeviceLike = None) -> Dict[str, Dict]:
    """Batched skeleton-clip inference: the two-stream 2s-AGCN ensemble.

    Weights and clips come from ``seed`` (:func:`_gcn_setup`).  Each
    backend runs one warm-up step, then every batch.  Returns {backend:
    {"clips_per_s", "top1" (clips,), "logits" (clips, classes) numpy,
    "steps" (ensemble steps run, warm-up included)}}."""
    dev, cfg, prune_plan, params, stream = _gcn_setup(arch, reduced, batch,
                                                      seed, device)
    batches = [next(stream)["x"] for _ in range(max(1, clips // batch))]

    step = make_gcn_infer_step(cfg)
    results = {}
    for backend in backends:
        plans = tuple(engine.build_execution_plan(
            p, cfg, prune_plan, quant=True, backend=backend) for p in params)
        step(plans, torch.from_numpy(batches[0]).to(dev))    # warm-up
        synchronize(dev)
        logits, n = [], 0
        t0 = time.perf_counter()
        for xb in batches:
            out = step(plans, torch.from_numpy(xb).to(dev))
            logits.append(out.cpu())
            n += xb.shape[0]
        synchronize(dev)
        dt = time.perf_counter() - t0
        all_logits = torch.cat(logits).numpy()
        results[backend] = {
            "clips_per_s": n / dt,
            "top1": all_logits.argmax(-1),
            "logits": all_logits,
            "steps": len(batches) + 1,
        }
    return results


def _launches_since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _build.LAUNCHES.items()}


def serve_gcn_stream(arch: str, *, reduced: bool = True, batch: int = 4,
                     seed: int = 0, backends: Sequence[str] = ("cuda",),
                     device: DeviceLike = None) -> Dict[str, Dict]:
    """Per-frame continual inference: the two-stream ensemble on a live
    stream of one clip batch.

    Weights and the clip batch come from ``seed`` (:func:`_gcn_setup`;
    persons fold into the batch).  Per backend, the StreamStates are
    calibrated on the clip (frozen BN statistics, one clip-mode pass per
    stream), two warm-up steps run (a clip frame and a flush frame), then
    the clip is fed frame by frame followed by the flush drain, each step
    timed on the host clock up to a synchronise.  Returns {backend:
    {"frames_per_s" (skeleton sequences × frames per second),
    "latency_ms_p50", "latency_ms_mean" (per step), "clip_agreement"
    (post-drain top-1 agreement with the clip engine on the same plans),
    "top1", "logits" (post-drain, numpy), "clip_logits" (numpy),
    "steps" (stream steps, warm-up included), "flush", "launches"
    ({"calibration", "stream", "clip"}: kernel launches of each phase)}}."""
    from repro_torch.core.agcn.model import bone_stream

    dev, cfg, prune_plan, params, stream = _gcn_setup(arch, reduced, batch,
                                                      seed, device)
    clip = torch.from_numpy(next(stream)["x"]).to(dev)
    T = clip.shape[1]
    zeros = torch.zeros_like(clip[:, 0])

    step = make_gcn_stream_step(cfg)
    clip_step = make_gcn_infer_step(cfg)
    results = {}
    for backend in backends:
        plans = tuple(engine.build_execution_plan(
            p, cfg, prune_plan, quant=True, backend=backend) for p in params)
        before = dict(_build.LAUNCHES)
        states = (engine.init_stream_state(plans[0], clip.shape[0],
                                           x_calib=clip),
                  engine.init_stream_state(plans[1], clip.shape[0],
                                           x_calib=bone_stream(clip)))
        launches = {"calibration": _launches_since(before)}
        flush = engine.stream_flush_frames(plans[0], T)
        total = T + flush
        before = dict(_build.LAUNCHES)
        step(plans, states, clip[:, 0], True)          # warm-up, discarded
        step(plans, states, zeros, False)
        synchronize(dev)
        lat = []
        for r in range(total):
            t0 = time.perf_counter()
            states, logits = step(plans, states,
                                  clip[:, r] if r < T else zeros, r < T)
            synchronize(dev)
            lat.append(time.perf_counter() - t0)
        launches["stream"] = _launches_since(before)
        before = dict(_build.LAUNCHES)
        clip_logits = clip_step(plans, clip)
        launches["clip"] = _launches_since(before)
        lat_ms = np.sort(np.asarray(lat)) * 1e3
        stream_logits = logits.cpu().numpy()
        clip_logits = clip_logits.cpu().numpy()
        stream_top1 = stream_logits.argmax(-1)
        results[backend] = {
            # one step advances every sequence of the batch by one frame
            "frames_per_s": clip.shape[0] * total / float(np.sum(lat)),
            "latency_ms_p50": float(lat_ms[len(lat_ms) // 2]),
            "latency_ms_mean": float(lat_ms.mean()),
            "clip_agreement": float(
                (stream_top1 == clip_logits.argmax(-1)).mean()),
            "top1": stream_top1,
            "logits": stream_logits,
            "clip_logits": clip_logits,
            "steps": total + 2,
            "flush": flush,
            "launches": launches,
        }
    return results


def generate(arch: str, *, reduced: bool = True, batch: int = 4,
             prompt_len: int = 16, gen: int = 32, seed: int = 0,
             backend: str = "cuda", device: DeviceLike = None,
             params: Optional[Dict] = None,
             keep_logits: bool = False) -> Dict:
    """KV-cache decoding of a dense LM: a random prompt from
    ``np.random.default_rng(seed)`` is fed token by token through the
    decode step (the prefill), then ``gen`` greedy tokens follow, as the
    reference's ``generate`` does.  Weights are ``params`` if given (e.g.
    the reference's, through the bridge), else ``registry.init_params``
    seeded with ``seed``; the cache is float32.  Each step is timed on the
    host clock up to a synchronise.  Returns {"tokens" (batch, prompt_len
    + gen) numpy, "tokens_per_s" (batch × steps / summed step time),
    "latency_ms_p50", "latency_ms_mean" (per step), "steps", and with
    ``keep_logits`` "logits" (steps, batch, padded_vocab) on the device:
    step t's logits for position t + 1}."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if cfg.family == "gcn":
        raise ValueError(f"{arch} is a gcn-family arch: use `serve clip|"
                         f"stream`, not `serve lm`")
    if params is None:
        params = registry.init_params(cfg, seed=seed, device=dev)
    max_len = prompt_len + gen
    cache = registry.init_cache(cfg, batch, max_len, device=dev)
    step = make_serve_step(cfg, backend)
    if backend == "cuda" and dev.type == "cuda":
        _build.library()                  # build the kernels before timing
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(batch, prompt_len))
    prompt = torch.from_numpy(prompt.astype(np.int32)).to(dev)
    tok = prompt[:, :1]
    pos = torch.zeros((), dtype=torch.int32, device=dev)
    out_tokens, kept, lat = [tok], [], []
    synchronize(dev)
    for p in range(max_len - 1):
        t0 = time.perf_counter()
        next_tok, cache, logits = step(params, cache,
                                       {"tokens": tok, "pos": pos})
        tok = prompt[:, p + 1: p + 2] if p + 1 < prompt_len else \
            next_tok[:, None]
        pos = pos + 1
        synchronize(dev)
        lat.append(time.perf_counter() - t0)
        out_tokens.append(tok)
        if keep_logits:
            kept.append(logits)
    lat_ms = np.sort(np.asarray(lat)) * 1e3
    out = {
        "tokens": torch.cat(out_tokens, 1).cpu().numpy(),
        "tokens_per_s": batch * len(lat) / float(np.sum(lat)),
        "latency_ms_p50": float(lat_ms[len(lat_ms) // 2]),
        "latency_ms_mean": float(lat_ms.mean()),
        "steps": len(lat),
    }
    if keep_logits:
        out["logits"] = torch.stack(kept)
    return out


def serve_gcn_sessions(arch: str, *, reduced: bool = True, slots: int = 4,
                       n_sessions: int = 0, rate: float = 0.0, seed: int = 0,
                       backends: Sequence[str] = ("cuda",),
                       qos: str = "fifo", preempt_ratio: float = 0.25,
                       deadline_slack: int = 25,
                       capacity_tiers: Optional[Sequence[int]] = None,
                       load: str = "poisson", policy: str = "demand",
                       slo_config=None, trace: str = "", topology: str = "",
                       use_ck: bool = False, saliency_thresh: float = 0.0,
                       mesh: int = 0, replicas: int = 1,
                       device: DeviceLike = None,
                       bench: Optional[str] = None) -> List[Dict]:
    """Multi-session stream serving through
    :class:`repro_torch.serving.GcnService`, one service per backend (the
    two-stream ensemble), as the JAX package's ``serve_gcn_sessions``.

    ``qos`` picks the scheduler policy, ``capacity_tiers`` (e.g. ``(2, 4,
    8)``) makes the service elastic (``slots`` alone is a fixed-capacity
    run), ``load`` the arrival process (``poisson`` | ``burst``).
    ``trace`` replays a recorded :class:`~repro_torch.serving.Trace` file
    instead of generating load, so runs that differ only in ``policy``
    (``demand`` | ``slo``, knobs in ``slo_config``) compare the
    controllers on identical traffic.  ``topology`` serves a registered
    skeleton, ``use_ck`` the windowed C_k graph, ``saliency_thresh`` > 0
    gates uninformative frames.  ``mesh`` > 1 splits the slab over a
    ``mesh``-shard batch mesh built on ``device`` (N cards when ``device``
    is None or ``"cuda"``, N logical shards on ``"cpu"``; the row gains
    ``mesh`` and ``collective_ms_per_tick``); ``replicas`` > 1 also serves
    the generated load through a :class:`~repro_torch.distributed.router.
    ReplicaRouter` and appends its merged row (``replicas`` and
    ``rebalances``) after each backend's.  Neither is taken with
    ``trace`` (the JAX CLI ignores them there; this one refuses).
    Returns the metrics rows and merges them into ``bench`` (default
    ``BENCH_torch_sessions.json``)."""
    from repro_torch.serving import (DEFAULT_BENCH_PATH, Trace, replay,
                                     run_sessions, write_bench)

    cfg = get_config(arch, reduced=reduced)
    if cfg.family != "gcn":
        raise ValueError(f"{arch} is not a gcn-family arch")
    if use_ck and not cfg.use_ck:
        cfg = dataclasses.replace(cfg, use_ck=True)
    tiers = tuple(capacity_tiers or (slots,))
    if trace:
        if topology:
            raise ValueError("--topology is not available with --trace: a "
                             "recorded trace pins its clip bytes to the "
                             "skeleton it was captured with")
        if mesh > 1 or replicas > 1:
            raise ValueError("--mesh and --replicas serve generated load; "
                             "replay takes no mesh or router")
        rec = Trace.load(trace)
        results = [
            replay(cfg, rec, backend=backend, qos=qos, policy=policy,
                   capacity_tiers=tiers, slo_config=slo_config,
                   deadline_slack=deadline_slack, seed=seed,
                   saliency_thresh=saliency_thresh, device=device)
            for backend in backends]
    else:
        if replicas > 1 and topology:
            raise ValueError("--topology is not threaded through the "
                             "replica router — drop --replicas")
        n = n_sessions or 3 * slots
        # mean inter-arrival ~ clip_len / slots: offered load ~ capacity
        mean_gap = rate if rate > 0 else max(2.0, cfg.gcn_frames / slots)
        results = []
        for backend in backends:
            results.append(run_sessions(
                cfg, slots=slots, n_sessions=n, mean_interarrival=mean_gap,
                backend=backend, seed=seed, qos=qos,
                preempt_ratio=preempt_ratio, deadline_slack=deadline_slack,
                capacity_tiers=capacity_tiers, load=load, policy=policy,
                slo_config=slo_config, topology=topology or None,
                use_ck=use_ck, saliency_thresh=saliency_thresh, mesh=mesh,
                device=device))
            if replicas > 1:
                from repro_torch.distributed import run_routed_sessions
                results.append(run_routed_sessions(
                    cfg, replicas=replicas, slots=slots, n_sessions=n,
                    mean_interarrival=mean_gap, backend=backend, seed=seed,
                    qos=qos, preempt_ratio=preempt_ratio,
                    deadline_slack=deadline_slack,
                    capacity_tiers=capacity_tiers, load=load,
                    device=device))
    write_bench(results, bench or DEFAULT_BENCH_PATH)
    return results


def _print_sessions(results: List[Dict], bench: str) -> None:
    for r in results:
        cap = (f" capacity={r['capacity']}" if r["capacity"] != "fixed"
               else "")
        if r.get("replicas", 1) > 1:
            # the merged router row: totals and percentiles (per-replica
            # detail rides under "per_replica" in the bench row)
            print(f"backend={r['backend']} [sessions routed "
                  f"replicas={r['replicas']} qos={r['qos']}{cap} "
                  f"load={r['load']} device={r['device']}]: "
                  f"{r['sessions']} sessions over "
                  f"{r['replicas']}x{r['slots']} slots in {r['ticks']} "
                  f"ticks, {r['frames_per_s']:.1f} frames/s, "
                  f"{r['sessions'] / r['wall_s'] if r['wall_s'] else 0.0:.2f}"
                  f" sessions/s, occupancy {r['occupancy'] * 100:.0f}%, "
                  f"session latency p50 {r['latency_ms_p50']:.0f} ms p99 "
                  f"{r['latency_ms_p99']:.0f} ms")
            print(f"  replicas={r['replicas']} "
                  f"rebalances={r['rebalances']}")
            continue
        pol = f" mesh={r['mesh']}" if r.get("mesh", 1) > 1 else ""
        pol += (f" policy={r['policy']}" if r["policy"] != "demand" else "")
        pol += f" trace={r['trace']}" if r.get("trace") else ""
        if r.get("ck"):
            pol += " ck"
        if r.get("saliency"):
            pol += (f" saliency={r['saliency']} "
                    f"(skip {r['skip_rate'] * 100:.0f}%)")
        print(f"backend={r['backend']} [sessions{pol} qos={r['qos']}{cap} "
              f"load={r['load']} device={r['device']}]: {r['sessions']} "
              f"sessions over {r['slots']} slots in {r['ticks']} ticks, "
              f"{r['frames_per_s']:.1f} frames/s, "
              f"{r['sessions'] / r['wall_s'] if r['wall_s'] else 0.0:.2f} "
              f"sessions/s, tick p50 {r['tick_ms_p50']:.2f} ms mean "
              f"{r['tick_ms_mean']:.2f} ms, occupancy "
              f"{r['occupancy'] * 100:.0f}% time-weighted "
              f"({r['occupancy_busy'] * 100:.0f}% busy), session latency "
              f"p50 {r['latency_ms_p50']:.0f} ms p99 "
              f"{r['latency_ms_p99']:.0f} ms, first logit after "
              f"{r['first_logit_frames']} frames, queue wait "
              f"{r['queue_wait_ticks_mean']:.1f} ticks, "
              f"{r['device_dispatches']} dispatches, {r['readbacks']} "
              f"readbacks")
        for p, pl in sorted(r["latency_ms_by_priority"].items()):
            print(f"  priority {p}: n={pl['n']} p50={pl['p50_ms']:.0f}ms "
                  f"p99={pl['p99_ms']:.0f}ms (arrival->finish "
                  f"p50={pl['e2e_p50_ticks']:.0f} "
                  f"p99={pl['e2e_p99_ticks']:.0f} ticks, first-logit "
                  f"p99={pl['first_logit_p99_ticks']:.0f} ticks)")
        if r["policy"] == "slo":
            print(f"  slo: target p99 {r['slo_target_p99_ticks']} ticks, "
                  f"shed_mode={r['shed_mode']} "
                  f"rejected={r['sessions_rejected']} "
                  f"degraded={r['sessions_degraded']} "
                  f"({r['shed_windows']} shed windows)")
        if r["qos"] == "preempt":
            print(f"  preemptions={r['preemptions']} "
                  f"restores={r['restores']}")
        if r["qos"] == "deadline":
            print(f"  deadline missed={r['deadline_missed']} "
                  f"(miss rate {r['deadline_miss_rate'] * 100:.0f}%)")
        if r["capacity"] != "fixed":
            print(f"  elastic: {r['migrations_grow']} grows / "
                  f"{r['migrations_shrink']} shrinks, migration "
                  f"{r['migration_ms_mean']:.1f} ms mean, final capacity "
                  f"{r['capacity_final']}, tier ticks {r['tier_ticks']}")
        if r.get("mesh", 1) > 1:
            print(f"  sharded: {r['mesh']} devices, collective cost "
                  f"{r['collective_ms_per_tick']:.2f} ms/tick")
    print(f"# merged into {bench}")


def build_parser() -> argparse.ArgumentParser:
    """The CLI: ``serve clip|stream|sessions|lm [flags]``."""
    from repro_torch.serving import (CONTROL_POLICIES, DEFAULT_BENCH_PATH,
                                     QOS_POLICIES, SHED_MODES)

    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    sub = ap.add_subparsers(dest="mode", required=True)
    clip = sub.add_parser("clip", help="gcn: batched two-stream clip "
                                       "inference")
    stream = sub.add_parser("stream", help="gcn: per-frame two-stream "
                                           "continual inference")
    sessions = sub.add_parser("sessions", help="gcn: multi-session traffic "
                                               "through GcnService")
    lm = sub.add_parser("lm", help="dense LM: token-by-token prefill and "
                                   "greedy KV-cache decoding")
    for p in (clip, stream, sessions, lm):
        p.add_argument("--arch", required=True)
        p.add_argument("--reduced", action="store_true")
        p.add_argument("--batch", type=int, default=0,
                       help="0 -> the config's default "
                            "(ModelConfig.serve_batch)")
        p.add_argument("--backend", default="cuda",
                       choices=(*engine.BACKENDS, "both"),
                       help="engine backend(s) to serve with")
        p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                       help="cpu runs the kernels' plain versions")
    clip.add_argument("--clips", type=int, default=64,
                      help="total clips to drain per backend")
    p = sessions
    p.add_argument("--slots", type=int, default=4,
                   help="slot capacity of a fixed run; also sets the load "
                        "defaults (--n-sessions 3 x slots, --rate "
                        "clip_len / slots)")
    p.add_argument("--n-sessions", type=int, default=0,
                   help="total sessions to serve (default 3 x slots)")
    p.add_argument("--rate", type=float, default=0.0,
                   help="mean inter-arrival ticks (0 -> clip_len / slots)")
    p.add_argument("--qos", default="fifo", choices=QOS_POLICIES,
                   help="scheduler policy: fifo run-to-completion, preempt "
                        "(priority snapshot-eviction), deadline (expiry "
                        "drops)")
    p.add_argument("--preempt-ratio", type=float, default=0.25,
                   help="fraction of high-priority sessions in the "
                        "generated load (under every policy)")
    p.add_argument("--deadline-slack", type=int, default=25,
                   help="ticks past each session's minimal service time "
                        "before its deadline")
    p.add_argument("--capacity-tiers", default="",
                   help="comma-separated slot tiers, e.g. 2,4,8: elastic "
                        "capacity (one slab per tier, hysteresis "
                        "grow/shrink, snapshot/restore migration)")
    p.add_argument("--load", default="poisson", choices=("poisson", "burst"),
                   help="arrival process: steady poisson or bursty peaks "
                        "and lulls")
    p.add_argument("--trace", default="",
                   help="replay a recorded Trace JSON file instead of "
                        "generating load")
    p.add_argument("--policy", default="demand", choices=CONTROL_POLICIES,
                   help="capacity control: demand (grow on busy + queued) "
                        "or slo (grow on measured p99 first-logit latency, "
                        "shed low-priority opens at the top tier)")
    p.add_argument("--slo-target", type=int, default=0,
                   help="SLO bound: p99 arrival -> first-logit ticks (0 -> "
                        "SloConfig default; with --policy slo)")
    p.add_argument("--slo-window", type=int, default=0,
                   help="the SLO controller's latency window (0 -> "
                        "SloConfig default)")
    p.add_argument("--slo-shed-mode", default="", choices=("", *SHED_MODES),
                   help="what shedding does to low-priority opens "
                        "(default: SloConfig default)")
    p.add_argument("--topology", default="",
                   help="registered skeleton to serve (ntu25, ntu50, "
                        "hand21, body_hand46; default ntu25)")
    p.add_argument("--ck", action="store_true",
                   help="serve with the windowed data-dependent C_k graph")
    p.add_argument("--saliency-thresh", type=float, default=0.0,
                   help="> 0 skips uninformative frames per session below "
                        "this attention-ratio threshold (0 = off)")
    p.add_argument("--bench", default=DEFAULT_BENCH_PATH,
                   help="the JSON file the rows merge into")
    p.add_argument("--mesh", type=int, default=0,
                   help="split the session slab over an N-shard 1-D mesh "
                        "(0/1: one device; N cards, or N logical shards "
                        "with --device cpu); every tier must be a "
                        "multiple of N")
    p.add_argument("--replicas", type=int, default=1,
                   help="also serve the load through R service replicas "
                        "behind the replica router (adds the routed row)")
    lm.add_argument("--prompt-len", type=int, default=16)
    lm.add_argument("--gen", type=int, default=32)
    return ap


def main(argv=None) -> None:
    """CLI entry."""
    ap = build_parser()
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    backends = engine.BACKENDS if args.backend == "both" else (args.backend,)
    if args.mode == "sessions":
        slo_config = None
        if args.policy == "slo":
            from repro_torch.serving import SloConfig
            overrides = {}
            if args.slo_target:
                overrides["target_p99_ticks"] = args.slo_target
            if args.slo_window:
                overrides["window"] = args.slo_window
            if args.slo_shed_mode:
                overrides["shed_mode"] = args.slo_shed_mode
            slo_config = SloConfig(**overrides)
        tiers = (tuple(int(t) for t in args.capacity_tiers.split(","))
                 if args.capacity_tiers else None)
        results = serve_gcn_sessions(
            args.arch, reduced=args.reduced, slots=args.slots,
            n_sessions=args.n_sessions, rate=args.rate, backends=backends,
            qos=args.qos, preempt_ratio=args.preempt_ratio,
            deadline_slack=args.deadline_slack, capacity_tiers=tiers,
            load=args.load, policy=args.policy, slo_config=slo_config,
            trace=args.trace, topology=args.topology, use_ck=args.ck,
            saliency_thresh=args.saliency_thresh, mesh=args.mesh,
            replicas=args.replicas, device=args.device, bench=args.bench)
        _print_sessions(results, args.bench)
        return
    batch = cfg.serve_batch(args.mode, args.batch)
    if args.mode == "lm":
        res = {name: generate(args.arch, reduced=args.reduced, batch=batch,
                              prompt_len=args.prompt_len, gen=args.gen,
                              backend=name, device=args.device)
               for name in backends}
        for name, r in res.items():
            print(f"backend={name}: {r['tokens_per_s']:.1f} tokens/s, "
                  f"latency p50 {r['latency_ms_p50']:.2f} ms mean "
                  f"{r['latency_ms_mean']:.2f} ms per step ({batch} "
                  f"sequences, {args.prompt_len} prompt + {args.gen} "
                  f"generated tokens, device={args.device})")
        if len(res) == 2:
            a, b = (res[k]["tokens"][:, args.prompt_len:]
                    for k in engine.BACKENDS)
            print(f"backend token agreement: "
                  f"{float(np.mean(a == b)) * 100:.1f}%")
        return
    if args.mode == "stream":
        res = serve_gcn_stream(args.arch, reduced=args.reduced, batch=batch,
                               backends=backends, device=args.device)
        for name, r in res.items():
            print(f"backend={name}: {r['frames_per_s']:.1f} frames/s, "
                  f"latency p50 {r['latency_ms_p50']:.2f} ms mean "
                  f"{r['latency_ms_mean']:.2f} ms per step, clip-engine "
                  f"top-1 agreement {r['clip_agreement'] * 100:.1f}% "
                  f"({len(r['top1'])} streams, 2-stream ensemble, "
                  f"device={args.device})")
    else:
        res = serve_gcn(args.arch, reduced=args.reduced, batch=batch,
                        clips=args.clips, backends=backends,
                        device=args.device)
        for name, r in res.items():
            print(f"backend={name}: {r['clips_per_s']:.1f} clips/s "
                  f"({len(r['top1'])} clips, 2-stream ensemble, "
                  f"device={args.device})")
    if len(res) == 2:
        a, b = (res[k]["top1"] for k in engine.BACKENDS)
        print(f"backend top-1 agreement: {float(np.mean(a == b))*100:.1f}%")


if __name__ == "__main__":
    main()
