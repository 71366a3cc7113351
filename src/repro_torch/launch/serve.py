"""Serving CLI for the port — 2s-AGCN two-stream inference and dense LM
decoding.

    PYTHONPATH=src python -m repro_torch.launch.serve clip --arch agcn-2s \\
        [--reduced] [--batch N] [--clips N] \\
        [--backend cuda|reference|both] [--device cuda|cpu]
    PYTHONPATH=src python -m repro_torch.launch.serve stream --arch agcn-2s \\
        [--reduced] [--batch N] [--backend cuda|reference|both] \\
        [--device cuda|cpu]
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
agreement.  The ``sessions`` mode is not ported yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence

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


def build_parser() -> argparse.ArgumentParser:
    """The CLI: ``serve clip|stream|lm [flags]``."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    sub = ap.add_subparsers(dest="mode", required=True)
    clip = sub.add_parser("clip", help="gcn: batched two-stream clip "
                                       "inference")
    stream = sub.add_parser("stream", help="gcn: per-frame two-stream "
                                           "continual inference")
    lm = sub.add_parser("lm", help="dense LM: token-by-token prefill and "
                                   "greedy KV-cache decoding")
    for p in (clip, stream, lm):
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
    lm.add_argument("--prompt-len", type=int, default=16)
    lm.add_argument("--gen", type=int, default=32)
    return ap


def main(argv=None) -> None:
    """CLI entry."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    backends = engine.BACKENDS if args.backend == "both" else (args.backend,)
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
