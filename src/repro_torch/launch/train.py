"""Training entry point: config -> data -> train step -> checkpoints ->
fault monitors, in one process or data-parallel over ``torch.distributed``
ranks.  Port of ``repro.launch.train`` for every family: the gcn family
(2s-AGCN) and the LM families (dense, MoE, VLM, SSM, hybrid, audio).

    PYTHONPATH=src python -m repro_torch.launch.train --arch agcn-2s \\
        [--reduced] --steps 30 --batch 16 [--device cuda|cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --reduced --steps 20 --batch 8 --seq 64 \\
        --mesh 4,1 --device cpu

With ``--mesh data,model`` the process is one rank of a data-parallel run
under ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``): NCCL on the
card (rank on ``cuda:LOCAL_RANK``), gloo with ``--device cpu``; the
parameters are DTensors laid out by ``distributed.params`` and each rank
reads its host's slice of the global batch.  The data-parallel step is
the same for every family.  A model axis above 1 is not supported yet
(ROADMAP.md, Queue 1 item 7).

The CLI switches TF32 off for matmuls and cuDNN, so the card trains in
full float32 (cuDNN's TF32 default would put ``F.conv2d``'s training
gradients far from the CPU's float32); library callers set it themselves.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import store
from repro_torch.common.config import ModelConfig, TrainConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.params import distribute_params, param_shardings
from repro_torch.fault.monitor import HeartbeatMonitor, StragglerDetector
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

def init_distributed(device: DeviceLike = None) -> torch.device:
    """Join the process group of a ``torchrun`` launch (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` from the environment; NCCL for CUDA,
    gloo for the CPU) unless it is up already; returns this rank's device
    (``cuda:LOCAL_RANK``, or the CPU when ``device`` says so)."""
    import torch.distributed as dist
    want = torch.device("cuda" if device is None else device)
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        raise RuntimeError("a mesh needs a process group: run under torchrun "
                           "(RANK and WORLD_SIZE are not set)")
    local = int(os.environ.get("LOCAL_RANK", 0))
    if want.type == "cuda":
        dev = resolve_device(f"cuda:{local}")
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]))
    return dev


def _rank_times(dt: float, dev: torch.device, world: int) -> List[float]:
    """Every rank's step time (an all-gather of one float)."""
    import torch.distributed as dist
    if world == 1:
        return [dt]
    mine = torch.tensor([dt], dtype=torch.float64, device=dev)
    out = [torch.empty_like(mine) for _ in range(world)]
    dist.all_gather(out, mine)
    return [float(t) for t in out]


def train_loop(
    arch: str,
    tcfg: TrainConfig,
    *,
    reduced: bool = True,
    batch: int = 8,
    seq: int = 128,
    mesh: Optional[Sequence[int]] = None,
    device: DeviceLike = None,
    log_every: int = 10,
    resume: bool = True,
    on_step: Optional[Callable] = None,
    cfg: Optional[ModelConfig] = None,
):
    """Train ``arch`` for ``tcfg.total_steps`` steps on a global batch of
    ``batch`` examples a step (clips, persons folded into the batch axis,
    or token sequences of ``seq``) from :func:`make_batches`.  Params come
    from ``tcfg.seed``.

    ``mesh=None``: one process, on ``device`` (default CUDA; raises
    without a card), no process group.  Otherwise a (data, model) or
    (pod, data, model) shape: this process joins the ``torchrun``
    process group (:func:`init_distributed`) and builds the mesh; the
    parameters and optimizer state are then DTensors
    (``param_shardings``, the reference's "2d" policy), the step is
    data-parallel, each rank reads host ``batch_rank`` of the batch
    ranks' slices, only rank 0 prints and writes checkpoints, and the
    monitors hold one entry per rank.

    With ``resume``, the latest checkpoint under ``tcfg.checkpoint_dir``
    (params) and ``<dir>/opt`` (the optimizer state) is restored and
    training continues from its step, on the batches the uninterrupted
    run would have read.  Every ``tcfg.checkpoint_every`` steps both are
    saved.

    ``on_step(step, params, opt_state, metrics, ms)``, when given, is
    called after each step; ``ms`` is the step's host time from fetching
    the batch to reading the loss, which waits for the device.  ``cfg``,
    when given, replaces the registry's config of ``arch`` (a depth cut).
    Returns (params, the losses of the steps run: the global batch's)."""
    import torch.distributed as dist
    cfg = cfg or get_config(arch, reduced=reduced)
    if mesh is None:
        dev, world, rank, data_rank, hosts = resolve_device(device), 1, 0, 0, 1
    else:
        dev = init_distributed(device)
        mesh = shd.make_mesh(mesh, dev)
        world, rank = dist.get_world_size(), dist.get_rank()
        data_rank, hosts = shd.batch_rank(mesh), shd.batch_ranks(mesh)
    heart = HeartbeatMonitor(num_hosts=world)
    strag = StragglerDetector(num_hosts=world)
    say = print if rank == 0 else (lambda *a, **k: None)

    params = registry.init_params(cfg, seed=tcfg.seed, device=dev)
    shardings = None
    if mesh is not None:
        shardings = param_shardings(params, mesh,
                                    expert_dim=cfg.padded_experts or None)
        params = distribute_params(params, shardings)
    opt_state = adamw.init(params)
    start = 0
    if resume:
        last = store.latest_step(tcfg.checkpoint_dir)
        if last is not None:
            params = store.restore(tcfg.checkpoint_dir, last, params)
            opt_state = store.restore(
                os.path.join(tcfg.checkpoint_dir, "opt"), last, opt_state)
            start = last
            say(f"[resume] from step {last}")
    data = make_batches(cfg, DataConfig(
        global_batch=batch, seq_len=seq, seed=tcfg.seed,
        host_index=data_rank, host_count=hosts), start=start)
    step_fn = make_train_step(cfg, tcfg, grad_shardings=shardings)

    losses: List[float] = []
    for step in range(start, tcfg.total_steps):
        t0 = time.perf_counter()
        b = {k: torch.as_tensor(v, device=dev) for k, v in next(data).items()}
        params, opt_state, metrics = step_fn(params, opt_state, b)
        loss = float(metrics["loss"])
        dt = time.perf_counter() - t0
        losses.append(loss)
        for r, t in enumerate(_rank_times(dt, dev, world)):
            heart.beat(r)
            strag.record(r, t)
        if on_step is not None:
            on_step(step, params, opt_state, metrics, dt * 1e3)
        if step % log_every == 0 or step == tcfg.total_steps - 1:
            say(f"step {step:5d}  loss {loss:8.4f}  "
                f"gnorm {float(metrics['grad_norm']):7.3f}  "
                f"{dt * 1e3:7.1f} ms")
        if tcfg.checkpoint_every and (step + 1) % tcfg.checkpoint_every == 0:
            store.save(tcfg.checkpoint_dir, step + 1, params)
            store.save(os.path.join(tcfg.checkpoint_dir, "opt"), step + 1,
                       opt_state)
        if not heart.healthy():
            raise RuntimeError(f"dead hosts: {heart.dead_hosts()}")
        if strag.stragglers():
            say(f"[straggler] ranks {sorted(strag.stragglers())}")
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
    ap.add_argument("--mesh", default="",
                    help="data,model (or pod,data,model): run as one rank of "
                         "a data-parallel torchrun launch on this mesh")
    ap.add_argument("--out", default="",
                    help="write the losses, step ms and peak device memory "
                         "as JSON here (rank 0)")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tcfg = TrainConfig(
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        microbatches=args.microbatches,
        checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir,
    )
    mesh: Optional[Tuple[int, ...]] = (
        tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None)
    step_ms: List[float] = []
    try:
        _, losses = train_loop(
            args.arch, tcfg, reduced=args.reduced, batch=args.batch,
            seq=args.seq, mesh=mesh, device=args.device,
            on_step=lambda *a: step_ms.append(a[-1]))
        peak = (torch.cuda.max_memory_allocated()
                if torch.cuda.is_available() and args.device != "cpu" else 0)
    finally:
        if mesh is not None and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    if mesh is not None and int(os.environ.get("RANK", 0)) != 0:
        return
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"losses": losses, "step_ms": step_ms,
                       "peak_bytes": peak, "mesh": mesh}, f)
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}, "
              f"mean of the last 5 {np.mean(losses[-5:]):.4f})")
    else:
        print("nothing to do (checkpoint already past --steps)")


if __name__ == "__main__":
    main()
