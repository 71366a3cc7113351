"""Rank code for the port's data-parallel tests, free of JAX: the ranks
are spawned with ``torch.multiprocessing`` and import this module, so it
imports torch, numpy and ``repro_torch`` only.

:func:`spawn` runs a function on N gloo ranks that meet through a
``file://`` store (no TCP port), with a deadline of its own.
:func:`run_scenarios` is the rank body the tests spawn once: it trains
each scenario of a list from the parent's files (initial parameters and
global batches as ``.npz``) on a (ranks, 1) mesh with
``make_train_step`` and ``shard_batch``, and rank 0 writes each one's
losses, parameters and, where asked, gradients back as ``.npz``.

    python tests/torch_dist_workers.py smoke --ranks 4 --steps 3

runs reduced smollm-360m data-parallel on 4 gloo ranks against the same
loop in one process and prints the largest loss and parameter gaps as
JSON (the card's check runs it so).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parents[1] / "src"
if str(SRC) not in sys.path:
    sys.path.insert(0, str(SRC))


class FakeMesh:
    """A shape-only mesh (``axis_names`` and a ``shape`` mapping) for the
    sharding rules, without a process group."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def _entry(rank, fn, world, init_file, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, workdir, *args, timeout: float = 300.0) -> None:
    """``fn(rank, world, *args)`` on ``world`` spawned processes, each in a
    gloo process group that meets through a file under ``workdir``.
    Raises if a rank fails, and kills every rank and raises TimeoutError
    past ``timeout`` seconds."""
    import torch.multiprocessing as mp
    init = Path(workdir) / f"rdzv_{time.monotonic_ns()}"
    ctx = mp.start_processes(_entry, args=(fn, world, str(init), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            raise TimeoutError(f"{world} ranks did not finish in {timeout} s")


def _cfg(spec):
    from repro_torch.configs import get_config
    cfg = get_config(spec["arch"], reduced=True)
    return dataclasses.replace(cfg, **spec.get("cfg", {}))


def load_tree(path):
    """An ``.npz`` of ``/``-joined leaf paths -> nested dicts of tensors."""
    out = {}
    with np.load(path) as z:
        for key in z.files:
            node = out
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(z[key].copy())
    return _lists(out)


def _lists(node):
    """Dicts whose keys are 0..n-1 back to lists (the gcn "blocks")."""
    if not isinstance(node, dict):
        return node
    node = {k: _lists(v) for k, v in node.items()}
    if node and all(k.isdigit() for k in node):
        return [node[str(i)] for i in range(len(node))]
    return node


def save_tree(path, tree) -> None:
    """A tree of tensors or arrays -> ``.npz`` keyed by leaf path
    (bfloat16 leaves widened to float32, which holds them exactly)."""
    from repro_torch.common.tree import tree_paths
    np.savez(path, **{n: (x.detach().cpu().float().numpy()
                          if isinstance(x, torch.Tensor)
                          and x.dtype == torch.bfloat16
                          else x.detach().cpu().numpy()
                          if isinstance(x, torch.Tensor) else np.asarray(x))
                      for n, x in tree_paths(tree)})


def _batches(path):
    with np.load(path) as z:
        n = len({k.split("/")[0] for k in z.files})
        return [{k.split("/", 1)[1]: torch.from_numpy(z[k].copy())
                 for k in z.files if k.startswith(f"{i}/")}
                for i in range(n)]


def _run_one(rank, world, spec, mesh):
    """One scenario on ``mesh``: returns (losses, params DTensors, opt)."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.distributed.params import (distribute_params,
                                                param_shardings)
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step, shard_batch
    cfg = _cfg(spec)
    tcfg = TrainConfig(**spec["tcfg"])
    params = load_tree(spec["params"])
    sh = param_shardings(params, mesh, expert_dim=cfg.padded_experts or None,
                         policy=spec.get("policy", "2d"))
    params = distribute_params(params, sh)
    opt = adamw.init(params)
    step = make_train_step(cfg, tcfg, grad_shardings=sh)
    losses, first = [], None
    for b in _batches(spec["batches"])[: spec["steps"]]:
        local = shard_batch(b, rank, world, tcfg.microbatches)
        params, opt, m = step(params, opt, local)
        losses.append(float(m["loss"]))
        if first is None:
            first = _full(params)
    return losses, params, opt, sh, first


def _full(tree):
    from repro_torch.common.tree import tree_map
    return tree_map(lambda x: x.full_tensor() if hasattr(x, "full_tensor")
                    else x, tree)


def _grads(rank, world, spec, mesh):
    """The first batch's gradients synced over the ranks, with and without
    bf16 compression."""
    from repro_torch.distributed import sharding
    from repro_torch.distributed.params import param_shardings
    from repro_torch.train.steps import (loss_and_grads, make_loss_fn,
                                         shard_batch, sync_grads)
    cfg = _cfg(spec)
    params = load_tree(spec["params"])
    sh = param_shardings(params, mesh, expert_dim=cfg.padded_experts or None)
    b = shard_batch(_batches(spec["batches"])[0], rank, world)
    with sharding.axis_rules(mesh):
        _, _, g = loss_and_grads(make_loss_fn(cfg), params, b)
    return {c: _full(sync_grads(g, sh, c)) for c in ("none", "bf16")}


def run_scenarios(rank, world, scenarios, out_dir):
    """Rank body: each scenario of ``scenarios`` (dicts of arch, cfg
    overrides, tcfg, steps, params and batches files, policy, kind) on a
    (world, 1) mesh; rank 0 writes ``<out_dir>/<name>.npz`` (losses and
    final params, or synced gradients) and ``<name>.json``.  The scenario
    of kind "elastic" comes last: it trains ``steps`` steps, checkpoints,
    then ranks 0 and 1 form a new 2-rank group, reshard the checkpoint
    onto the degraded mesh and train ``more`` steps with the microbatches
    multiplied by the plan."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import make_mesh
    mesh = make_mesh((world, 1), torch.device("cpu"))
    out_dir = Path(out_dir)
    for spec in scenarios:
        name = spec["name"]
        if spec.get("kind") == "grads":
            gs = _grads(rank, world, spec, mesh)
            if rank == 0:
                for c, g in gs.items():
                    save_tree(out_dir / f"{name}_{c}.npz", g)
                (out_dir / f"{name}.json").write_text(json.dumps(
                    {c: sorted({str(x.dtype) for _, x in _paths(g)})
                     for c, g in gs.items()}))
            continue
        if spec.get("kind") == "elastic":
            _elastic(rank, world, spec, mesh, out_dir)
            return
        if spec.get("kind") == "loop":
            _loop(rank, world, spec, out_dir)
            continue
        losses, params, _, sh, first = _run_one(rank, world, spec, mesh)
        full = _full(params)
        local = {n: list(p.to_local().shape) for n, p in
                 _paths(params)}
        if rank == 0:
            save_tree(out_dir / f"{name}.npz", full)
            save_tree(out_dir / f"{name}_step1.npz", first)
            placements = {n: [str(pl) for pl in p.placements]
                          for n, p in _paths(params)}
            (out_dir / f"{name}.json").write_text(json.dumps(
                {"losses": losses, "placements": placements,
                 "local_shapes": local}))
        dist.barrier()


def _loop(rank, world, spec, out_dir):
    """``launch.train.train_loop`` with ``mesh=(world, 1)`` as a torchrun
    rank runs it (the environment's RANK, WORLD_SIZE and LOCAL_RANK; the
    group is up already): ``steps`` steps with a checkpoint every 2, then
    a second loop that resumes from the step-2 checkpoint alone and runs
    the rest.  Rank 0 writes the losses of both."""
    import shutil
    from repro_torch.common.config import TrainConfig
    from repro_torch.launch.train import train_loop
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    ckpt = Path(out_dir) / "loop_ckpt"
    tcfg = TrainConfig(**spec["tcfg"], total_steps=spec["steps"],
                       checkpoint_every=2, checkpoint_dir=str(ckpt))
    kw = dict(reduced=True, batch=spec["batch"], seq=spec["seq"],
              mesh=(world, 1), device="cpu")
    _, losses = train_loop(spec["arch"], tcfg, resume=False, **kw)
    again = Path(out_dir) / "loop_again"
    if rank == 0:
        for sub in ("", "opt"):
            shutil.copytree(ckpt / sub / "step_2", again / sub / "step_2")
    import torch.distributed as dist
    dist.barrier()
    tcfg2 = TrainConfig(**spec["tcfg"], total_steps=spec["steps"],
                        checkpoint_every=0, checkpoint_dir=str(again))
    _, rest = train_loop(spec["arch"], tcfg2, resume=True, **kw)
    if rank == 0:
        (Path(out_dir) / f"{spec['name']}.json").write_text(json.dumps(
            {"losses": losses, "resumed": rest}))
    dist.barrier()


def _paths(tree):
    from repro_torch.common.tree import tree_paths
    return tree_paths(tree)


def _elastic(rank, world, spec, mesh, out_dir):
    import torch.distributed as dist
    from repro_torch.checkpoint import store
    from repro_torch.common.config import TrainConfig
    from repro_torch.distributed.params import (distribute_params,
                                                param_shardings)
    from repro_torch.fault.elastic import (adjust_train_config,
                                           degraded_mesh, plan_degraded_mesh,
                                           reshard_checkpoint)
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step, shard_batch
    ckpt = out_dir / "elastic_ckpt"
    losses, params, opt, _, _ = _run_one(rank, world, spec, mesh)
    store.save(str(ckpt), spec["steps"], params)
    store.save(str(ckpt / "opt"), spec["steps"], opt)
    dist.destroy_process_group()
    survivors = 2
    if rank >= survivors:
        return
    dist.init_process_group("gloo", init_method=f"file://{spec['rdzv2']}",
                            rank=rank, world_size=survivors)
    plan = plan_degraded_mesh(survivors, model=1, old_data=world)
    new_mesh = degraded_mesh(plan, "cpu")
    cfg = _cfg(spec)
    tcfg = adjust_train_config(TrainConfig(**spec["tcfg"]), plan)
    like = load_tree(spec["params"])
    sh = param_shardings(like, new_mesh, expert_dim=cfg.padded_experts or None)
    params = reshard_checkpoint(str(ckpt), spec["steps"], like, new_mesh, sh)
    host = store.restore(str(ckpt / "opt"), spec["steps"], adamw.init(like))
    opt = adamw.OptState(step=host.step, m=distribute_params(host.m, sh),
                         v=distribute_params(host.v, sh))
    step = make_train_step(cfg, tcfg, grad_shardings=sh)
    for b in _batches(spec["batches"])[spec["steps"]:
                                       spec["steps"] + spec["more"]]:
        local = shard_batch(b, rank, survivors, tcfg.microbatches)
        params, opt, m = step(params, opt, local)
        losses.append(float(m["loss"]))
    full = _full(params)
    if rank == 0:
        save_tree(out_dir / f"{spec['name']}.npz", full)
        (out_dir / f"{spec['name']}.json").write_text(json.dumps(
            {"losses": losses, "plan": dataclasses.asdict(plan),
             "microbatches": tcfg.microbatches}))


# ---------------------------------------------------------------------------
# the stand-alone check: reduced smollm on N gloo ranks against one process
# ---------------------------------------------------------------------------

def one_process(spec):
    """The scenario in one process, no process group: (losses, params)."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    cfg = _cfg(spec)
    tcfg = TrainConfig(**spec["tcfg"])
    params = load_tree(spec["params"])
    opt = adamw.init(params)
    step = make_train_step(cfg, tcfg)
    losses = []
    for b in _batches(spec["batches"])[: spec["steps"]]:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses, params


def write_inputs(spec, workdir, params, batches) -> dict:
    """Write a scenario's initial params and global batches under
    ``workdir``; returns the spec with their paths."""
    workdir = Path(workdir)
    p = workdir / f"{spec['name']}_params.npz"
    b = workdir / f"{spec['name']}_batches.npz"
    save_tree(p, params)
    np.savez(b, **{f"{i}/{k}": np.asarray(v) for i, bt in enumerate(batches)
                   for k, v in bt.items()})
    return {**spec, "params": str(p), "batches": str(b)}


def smoke(ranks: int, steps: int, workdir) -> dict:
    """Reduced smollm-360m on ``ranks`` gloo ranks against one process."""
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batches
    from repro_torch.models import registry
    cfg = get_config("smollm-360m", reduced=True)
    data = make_batches(cfg, DataConfig(global_batch=2 * ranks, seq_len=32,
                                        seed=1))
    spec = write_inputs(
        {"name": "smoke", "arch": "smollm-360m", "steps": steps,
         "tcfg": {"learning_rate": 3e-3, "warmup_steps": 2,
                  "total_steps": 30}},
        workdir, registry.init_params(cfg, seed=1, device="cpu"),
        [next(data) for _ in range(steps)])
    spawn(run_scenarios, ranks, workdir, [spec], str(workdir), timeout=300)
    want_l, want_p = one_process(spec)
    got = json.loads((Path(workdir) / "smoke.json").read_text())
    got_p = load_tree(Path(workdir) / "smoke.npz")
    return {"ranks": ranks, "steps": steps, "losses": got["losses"],
            "one_process_losses": want_l,
            "loss_gap": max(abs(a - b) for a, b in zip(got["losses"], want_l)),
            "param_gap": max(float((a - b).abs().max()) for a, b in zip(
                tree_leaves(got_p), tree_leaves(want_p)))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=("smoke",))
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as d:
        print(json.dumps(smoke(args.ranks, args.steps, d)))


if __name__ == "__main__":
    main()
