"""Serving CLI for the port — 2s-AGCN batched two-stream clip inference.

    PYTHONPATH=src python -m repro_torch.launch.serve clip --arch agcn-2s \\
        [--reduced] [--batch N] [--clips N] \\
        [--backend cuda|reference|both] [--device cuda|cpu]

Compiles one ExecutionPlan per (stream, backend) from the config's pruning
plan (Q8.8 weights), drains clip batches through the ensemble step and
prints clips/s per backend; ``--backend both`` adds the cross-backend
top-1 agreement.  The other serve modes (stream, sessions, lm) are not
ported yet (ROADMAP.md Queue 1).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device, synchronize
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine
from repro_torch.core.agcn.model import init_params
from repro_torch.core.pruning.plan import plan_from_config
from repro_torch.data.pipeline import DataConfig, skeleton_batches
from repro_torch.train.steps import make_gcn_infer_step


def serve_gcn(arch: str, *, reduced: bool = True, batch: int = 8,
              clips: int = 64, seed: int = 0,
              backends: Sequence[str] = ("cuda",),
              device: DeviceLike = None) -> Dict[str, Dict]:
    """Batched skeleton-clip inference: the two-stream 2s-AGCN ensemble.

    Weights come from ``init_params`` with one generator seeded by
    ``seed`` (joint stream first), clips from ``skeleton_batches``.  Each
    backend runs one warm-up step, then every batch.  Returns {backend:
    {"clips_per_s", "top1" (clips,), "logits" (clips, classes) numpy,
    "steps" (ensemble steps run, warm-up included)}}."""
    dev = resolve_device(device)
    cfg = get_config(arch, reduced=reduced)
    if cfg.family != "gcn":
        raise ValueError(f"{arch} is not a gcn-family arch")
    prune_plan = plan_from_config(cfg)
    gen = torch.Generator().manual_seed(seed)
    params = [init_params(cfg, gen, device=dev) for _ in ("joint", "bone")]

    dcfg = DataConfig(global_batch=batch, seq_len=cfg.gcn_frames, seed=seed)
    stream = skeleton_batches(cfg, dcfg)
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


def build_parser() -> argparse.ArgumentParser:
    """The CLI: ``serve clip [flags]``."""
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    sub = ap.add_subparsers(dest="mode", required=True)
    p = sub.add_parser("clip", help="gcn: batched two-stream clip inference")
    p.add_argument("--arch", required=True)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=0,
                   help="0 -> the config's default (ModelConfig.serve_batch)")
    p.add_argument("--clips", type=int, default=64,
                   help="total clips to drain per backend")
    p.add_argument("--backend", default="cuda",
                   choices=(*engine.BACKENDS, "both"),
                   help="engine backend(s) to serve with")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs the kernels' plain versions")
    return ap


def main(argv=None) -> None:
    """CLI entry."""
    args = build_parser().parse_args(argv)
    cfg = get_config(args.arch, reduced=args.reduced)
    backends = engine.BACKENDS if args.backend == "both" else (args.backend,)
    batch = cfg.serve_batch("clip", args.batch)
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
