"""Training entry point: config -> data -> train step -> checkpoints -> fault
monitors, on one process and one device.  Port of ``repro.launch.train``
for the gcn family (2s-AGCN); dense-LM training joins with the rest of the
LM zoo (ROADMAP.md, Queue 1 item 6) and multi-device training with
the training half of distribution (item 4b), so there is no mesh
argument.

    PYTHONPATH=src python -m repro_torch.launch.train --arch agcn-2s \\
        [--reduced] --steps 30 --batch 16 [--device cuda|cpu]

The CLI switches TF32 off for matmuls and cuDNN, so the card trains in
full float32 (cuDNN's TF32 default would put ``F.conv2d``'s training
gradients far from the CPU's float32); library callers set it themselves.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.common.config import TrainConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.fault.monitor import HeartbeatMonitor, StragglerDetector
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step


def train_loop(
    arch: str,
    tcfg: TrainConfig,
    *,
    reduced: bool = True,
    batch: int = 8,
    seq: int = 128,
    device: DeviceLike = None,
    log_every: int = 10,
    resume: bool = True,
    on_step: Optional[Callable] = None,
):
    """Train ``arch`` for ``tcfg.total_steps`` steps on ``batch`` clips a
    step (persons fold into the batch axis) from :func:`make_batches`,
    on ``device`` (default CUDA; raises without a card).  Params come
    from ``tcfg.seed``.  With ``resume``, the latest checkpoint under
    ``tcfg.checkpoint_dir`` (params) and ``<dir>/opt`` (the optimizer
    state) is restored and training continues from its step, on the
    batches the uninterrupted run would have read.  Every
    ``tcfg.checkpoint_every`` steps both are saved.

    ``on_step(step, params, opt_state, metrics, ms)``, when given, is
    called after each step; ``ms`` is the step's host time from fetching
    the batch to reading the loss, which waits for the device.  Returns
    (params, the losses of the steps run)."""
    cfg = get_config(arch, reduced=reduced)
    if cfg.family != "gcn":
        raise NotImplementedError(
            f"the port trains the gcn family; {cfg.family} training joins "
            f"with ROADMAP.md Queue 1 item 6")
    dev = resolve_device(device)
    heart = HeartbeatMonitor(num_hosts=1)
    strag = StragglerDetector(num_hosts=1)

    params = registry.init_params(cfg, seed=tcfg.seed, device=dev)
    opt_state = adamw.init(params)
    start = 0
    if resume:
        last = store.latest_step(tcfg.checkpoint_dir)
        if last is not None:
            params = store.restore(tcfg.checkpoint_dir, last, params)
            opt_state = store.restore(
                os.path.join(tcfg.checkpoint_dir, "opt"), last, opt_state)
            start = last
            print(f"[resume] from step {last}")
    data = make_batches(cfg, DataConfig(global_batch=batch, seq_len=seq,
                                        seed=tcfg.seed), start=start)
    step_fn = make_train_step(cfg, tcfg)

    losses: List[float] = []
    for step in range(start, tcfg.total_steps):
        t0 = time.perf_counter()
        b = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        heart.beat(0)
        strag.record(0, dt)
        if on_step is not None:
            on_step(step, params, opt_state, metrics, dt * 1e3)
        if step % log_every == 0 or step == tcfg.total_steps - 1:
            print(f"step {step:5d}  loss {loss:8.4f}  "
                  f"gnorm {float(metrics['grad_norm']):7.3f}  "
                  f"{dt * 1e3:7.1f} ms")
        if tcfg.checkpoint_every and (step + 1) % tcfg.checkpoint_every == 0:
            store.save(tcfg.checkpoint_dir, step + 1, params)
            store.save(os.path.join(tcfg.checkpoint_dir, "opt"), step + 1,
                       opt_state)
        if not heart.healthy():
            raise RuntimeError(f"dead hosts: {heart.dead_hosts()}")
    return params, losses


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        microbatches=args.microbatches,
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir,
    )
    _, losses = train_loop(args.arch, tcfg, reduced=args.reduced,
                           batch=args.batch, seq=args.seq, device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}, "
              f"mean of the last 5 {np.mean(losses[-5:]):.4f})")
    else:
        print("nothing to do (checkpoint already past --steps)")


if __name__ == "__main__":
    main()
