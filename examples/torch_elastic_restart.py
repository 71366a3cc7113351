"""Fault-tolerance walkthrough on the PyTorch port: data-parallel training
on 4 ranks, a checkpoint, a simulated loss of two ranks, the elastic
re-mesh plan, and the checkpoint resharded onto the survivors with the
global batch preserved.  The port's counterpart of
``examples/elastic_restart.py``; it runs gloo ranks on the CPU.

    PYTHONPATH=src python examples/torch_elastic_restart.py [--steps 2]
"""
import argparse
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.checkpoint import store
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.distributed.params import distribute_params, param_shardings
from repro_torch.distributed.sharding import make_mesh
from repro_torch.fault.elastic import (adjust_train_config, degraded_mesh,
                                       plan_degraded_mesh, reshard_checkpoint)
from repro_torch.fault.monitor import HeartbeatMonitor
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step, shard_batch

ARCH, RANKS, SURVIVORS, BATCH, SEQ = "smollm-360m", 4, 2, 8, 32


def _train(cfg, tcfg, params, opt, sh, batches, rank, ranks):
    step = make_train_step(cfg, tcfg, grad_shardings=sh)
    losses = []
    for b in batches:
        local = shard_batch(b, rank, ranks, tcfg.microbatches)
        params, opt, m = step(params, opt, local)
        losses.append(float(m["loss"]))
    return params, opt, losses


def rank_main(rank, workdir, steps):
    torch.set_num_threads(1)
    cfg = get_config(ARCH, reduced=True)
    data = make_batches(cfg, DataConfig(global_batch=BATCH, seq_len=SEQ))
    batches = [{k: torch.as_tensor(v) for k, v in next(data).items()}
               for _ in range(2 * steps)]
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=1, total_steps=100)
    ckpt = os.path.join(workdir, "ckpt")

    # 1. data-parallel training on 4 ranks, then a checkpoint
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdzv4",
                            rank=rank, world_size=RANKS)
    mesh = make_mesh((RANKS, 1), torch.device("cpu"))
    like = registry.init_params(cfg, seed=0, device="cpu")
    sh = param_shardings(like, mesh)
    params = distribute_params(like, sh)
    params, opt, losses = _train(cfg, tcfg, params, adamw.init(params), sh,
                                 batches[:steps], rank, RANKS)
    store.save(ckpt, steps, params)
    store.save(os.path.join(ckpt, "opt"), steps, opt)
    if rank == 0:
        print(f"4 ranks, data = 4: losses {[round(x, 4) for x in losses]}; "
              f"checkpoint written at step {steps}")
    dist.destroy_process_group()

    # 2. two ranks stop heartbeating; the survivors plan a smaller mesh
    hb = HeartbeatMonitor(num_hosts=RANKS, timeout_s=30)
    for h in range(RANKS):
        hb.beat(h, now=0.0)
    for h in range(SURVIVORS):
        hb.beat(h, now=40.0)
    dead = hb.dead_hosts(now=60.0)
    if rank in dead:
        return
    plan = plan_degraded_mesh(RANKS - len(dead), model=1, old_data=RANKS)
    tcfg = adjust_train_config(tcfg, plan)
    if rank == 0:
        print(f"dead ranks {dead}: new mesh data={plan.data} "
              f"model={plan.model}, microbatches x"
              f"{plan.microbatch_multiplier} -> {tcfg.microbatches} (global "
              f"batch preserved)")

    # 3. the survivors form a new group and reshard the checkpoint onto it
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rdzv2",
                            rank=rank, world_size=plan.chips)
    mesh = degraded_mesh(plan, "cpu")
    sh = param_shardings(like, mesh)
    params = reshard_checkpoint(ckpt, steps, like, mesh, sh)
    host_opt = store.restore(os.path.join(ckpt, "opt"), steps,
                             adamw.init(like))
    opt = adamw.OptState(step=host_opt.step,
                         m=distribute_params(host_opt.m, sh),
                         v=distribute_params(host_opt.v, sh))
    params, opt, more = _train(cfg, tcfg, params, opt, sh, batches[steps:],
                               rank, plan.chips)
    if rank == 0:
        print(f"{plan.chips} ranks after the restore: losses "
              f"{[round(x, 4) for x in more]} (optimizer step "
              f"{int(opt.step)})")
    dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as workdir:
        mp.spawn(rank_main, args=(workdir, args.steps), nprocs=RANKS)


if __name__ == "__main__":
    main()
