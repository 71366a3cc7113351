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
:func:`run_mesh_scenarios` and :func:`run_sp_scenarios` are the rank
bodies of the model-axis and sequence-parallel tests.

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
    join(start(fn, world, workdir, *args), timeout)


def start(fn, world: int, workdir, *args):
    """:func:`spawn` without waiting: returns the ranks' context for
    :func:`join`, so the caller can work while they run."""
    import torch.multiprocessing as mp
    init = Path(workdir) / f"rdzv_{time.monotonic_ns()}"
    return mp.start_processes(_entry, args=(fn, world, str(init), args),
                              nprocs=world, join=False, start_method="spawn")


def join(ctx, timeout: float = 300.0) -> None:
    """Wait for :func:`start`'s ranks: raises if a rank fails, and kills
    every rank and raises TimeoutError past ``timeout`` seconds."""
    world = len(ctx.processes)
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


def _policy(spec, cfg):
    return spec.get("policy") or cfg.sharding


def _rules(spec, cfg, mesh, rows):
    from repro_torch.distributed.sharding import rules_for
    return rules_for(_policy(spec, cfg), rows, mesh)


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


def as_dtype(spec, tree):
    """``tree`` (parameters or a batch) with its floating leaves in the
    scenario's ``dtype`` (float32 when it names none): a float64 run of
    an SSM family, whose float32 rounding the AdamW update amplifies."""
    from repro_torch.common.tree import tree_map
    dtype = getattr(torch, spec.get("dtype", "float32"))
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


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
    from repro_torch.distributed.sharding import batch_rank, batch_ranks
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step, shard_batch
    cfg = _cfg(spec)
    tcfg = TrainConfig(**spec["tcfg"])
    params = as_dtype(spec, load_tree(spec["params"]))
    batches = [as_dtype(spec, b)
               for b in _batches(spec["batches"])[: spec["steps"]]]
    rules = _rules(spec, cfg, mesh, next(iter(batches[0].values())).shape[0])
    sh = param_shardings(params, mesh, expert_dim=cfg.padded_experts or None,
                         policy=_policy(spec, cfg))
    params = distribute_params(params, sh)
    opt = adamw.init(params)
    step = make_train_step(cfg, tcfg, grad_shardings=sh, rules=rules)
    losses, first = [], None
    for b in batches:
        local = shard_batch(b, batch_rank(mesh, rules),
                            batch_ranks(mesh, rules), tcfg.microbatches)
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
    """Train ``steps`` steps on ``mesh``, checkpoint, then the first
    ``survivors`` ranks (default 2) form a new group on the degraded mesh
    (the model axis kept) and train ``more`` steps."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import (axis_size, batch_rank,
                                                  batch_ranks)
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
    model = axis_size(mesh, "model")
    old_data = axis_size(mesh, "data")
    dist.destroy_process_group()
    survivors = spec.get("survivors", 2)
    if rank >= survivors:
        return
    dist.init_process_group("gloo", init_method=f"file://{spec['rdzv2']}",
                            rank=rank, world_size=survivors)
    plan = plan_degraded_mesh(survivors, model=model, old_data=old_data)
    new_mesh = degraded_mesh(plan, "cpu")
    cfg = _cfg(spec)
    tcfg = adjust_train_config(TrainConfig(**spec["tcfg"]), plan)
    like = load_tree(spec["params"])
    batches = _batches(spec["batches"])[spec["steps"]:
                                        spec["steps"] + spec["more"]]
    rules = _rules(spec, cfg, new_mesh,
                   next(iter(batches[0].values())).shape[0])
    sh = param_shardings(like, new_mesh, expert_dim=cfg.padded_experts or None,
                         policy=_policy(spec, cfg))
    params = reshard_checkpoint(str(ckpt), spec["steps"], like, new_mesh, sh)
    host = store.restore(str(ckpt / "opt"), spec["steps"], adamw.init(like))
    opt = adamw.OptState(step=host.step, m=distribute_params(host.m, sh),
                         v=distribute_params(host.v, sh))
    step = make_train_step(cfg, tcfg, grad_shardings=sh, rules=rules)
    for b in batches:
        local = shard_batch(b, batch_rank(new_mesh, rules),
                            batch_ranks(new_mesh, rules), tcfg.microbatches)
        params, opt, m = step(params, opt, local)
        losses.append(float(m["loss"]))
    full = _full(params)
    if rank == 0:
        save_tree(out_dir / f"{spec['name']}.npz", full)
        (out_dir / f"{spec['name']}.json").write_text(json.dumps(
            {"losses": losses, "plan": dataclasses.asdict(plan),
             "microbatches": tcfg.microbatches}))


def run_mesh_scenarios(rank, world, scenarios, out_dir):
    """Rank body of the model-axis tests: each scenario on its own mesh
    (``spec["mesh"]``, re-formed per scenario over the same ranks).  Kind
    "train" (default): :func:`_run_one`; rank 0 writes the losses, the
    final and first-step parameters and their local shapes, and with
    ``ckpt`` every rank joins saving the final parameters there
    (``checkpoint.store``).  Kind "decode": teacher-forced serve steps of
    ``spec["tokens"]`` (.npy, (B, T)) on the mesh under the cell's rules
    (kv_seq where B does not divide over the batch ranks), the parameters
    this rank's model shards (``params.local_shards``); rank 0 writes the
    whole batch's logits (T, B, vocab), every batch rank's rows (the
    audio family's memory from ``spec["memory"]``, .npy (B, F, d)).  With
    ``grads`` a train scenario also writes its first batch's gradients
    on the mesh (:func:`_mesh_grads`).  Kind "elastic" comes last."""
    import torch.distributed as dist
    from repro_torch.distributed.sharding import make_mesh
    out_dir = Path(out_dir)
    for spec in scenarios:
        mesh = make_mesh(tuple(spec["mesh"]), torch.device("cpu"))
        name = spec["name"]
        kind = spec.get("kind", "train")
        if kind == "elastic":
            _elastic(rank, world, spec, mesh, out_dir)
            return
        if kind == "decode":
            logits, rules = _decode(spec, mesh)
            if rank == 0:
                np.save(out_dir / f"{name}.npy", logits)
                (out_dir / f"{name}.json").write_text(json.dumps(
                    {"kv_seq": rules["kv_seq"], "batch": rules["batch"]}))
            dist.barrier()
            continue
        losses, params, _, sh, first = _run_one(rank, world, spec, mesh)
        if spec.get("grads"):
            g = _mesh_grads(spec, mesh)
            if rank == 0:
                save_tree(out_dir / f"{name}_grad.npz", g)
        if spec.get("ckpt"):
            from repro_torch.checkpoint import store
            store.save(spec["ckpt"], spec["steps"], params)
        full = _full(params)
        if rank == 0:
            from repro_torch.common.tree import tree_map
            from repro_torch.distributed.params import (held_bytes,
                                                        sharded_bytes)
            save_tree(out_dir / f"{name}.npz", full)
            save_tree(out_dir / f"{name}_step1.npz", first)
            specs = tree_map(lambda s: s.spec, sh)
            (out_dir / f"{name}.json").write_text(json.dumps(
                {"losses": losses,
                 "local_shapes": {n: list(p.to_local().shape)
                                  for n, p in _paths(params)},
                 "held_bytes": held_bytes(params),
                 "sharded_bytes": sharded_bytes(full, specs, mesh)}))
        dist.barrier()


def _mesh_grads(spec, mesh):
    """The first batch's gradients on ``mesh`` as the train step takes
    them (each rank's local shards and batch rows, the layers' model
    shards through ``params.prepare``), synced over the batch ranks and
    gathered whole."""
    from repro_torch.distributed import params as dparams
    from repro_torch.distributed import sharding
    from repro_torch.distributed.params import param_shardings
    from repro_torch.train.steps import (loss_and_grads, make_loss_fn,
                                         shard_batch, sync_grads)
    cfg = _cfg(spec)
    params = as_dtype(spec, load_tree(spec["params"]))
    b = as_dtype(spec, _batches(spec["batches"])[0])
    rules = _rules(spec, cfg, mesh, next(iter(b.values())).shape[0])
    policy = _policy(spec, cfg)
    sh = param_shardings(params, mesh, expert_dim=cfg.padded_experts or None,
                         policy=policy)
    layout = dparams.model_layout(cfg, mesh, policy)
    local = dparams.local_shards(params, layout.specs, mesh)
    b = shard_batch(b, sharding.batch_rank(mesh, rules),
                    sharding.batch_ranks(mesh, rules))
    loss = make_loss_fn(cfg)
    with sharding.axis_rules(mesh, rules, layout.plan):
        _, _, g = loss_and_grads(
            lambda p, bt: loss(dparams.prepare(p, layout), bt), local, b)
    return _full(sync_grads(g, sh, "none", rules))


def _decode(spec, mesh):
    """Teacher-forced decode of one "decode" scenario on ``mesh``: returns
    (the whole batch's logits (T, B, vocab), each batch rank's rows
    gathered from the ranks in rank order, the rules)."""
    import torch.distributed as dist
    from repro_torch.distributed import params as dparams
    from repro_torch.distributed.sharding import batch_rank, batch_ranks
    from repro_torch.models import registry
    from repro_torch.train.steps import make_serve_step
    cfg = _cfg(spec)
    toks = torch.from_numpy(np.load(spec["tokens"]))
    B, T = toks.shape
    rules = _rules(spec, cfg, mesh, B)
    n = batch_ranks(mesh, rules)
    r = batch_rank(mesh, rules) if n > 1 else 0
    rows = slice(r * (B // n), (r + 1) * (B // n))
    toks = toks[rows]
    extra = ({"memory": torch.from_numpy(np.load(spec["memory"]))[rows]}
             if spec.get("memory") else {})
    layout = dparams.model_layout(cfg, mesh)
    params = dparams.local_shards(load_tree(spec["params"]), layout.specs,
                                  mesh)
    with dparams.mesh_context(cfg, mesh, rules, layout):
        cache = registry.init_cache(cfg, toks.shape[0], spec["max_len"],
                                    device="cpu")
    step = make_serve_step(cfg, spec.get("backend", "reference"), mesh, rules)
    out = []
    for t in range(T):
        _, cache, last = step(params, cache, {
            "tokens": toks[:, t:t + 1],
            "pos": torch.tensor(t, dtype=torch.int32), **extra})
        out.append(last.numpy().copy())
    mine = [None] * dist.get_world_size()
    dist.all_gather_object(mine, (r, np.stack(out)))
    rows = dict(reversed(mine))     # each batch rank's rows, first rank's
    return np.concatenate([rows[i] for i in range(n)], axis=1), rules


# ---------------------------------------------------------------------------
# sequence parallelism: each scenario with the seq_shard rule and without
# ---------------------------------------------------------------------------

def forward_logits(cfg, params, batch):
    """The cache-free forward's whole logits (B, S_total, padded vocab) of
    a decoder, SSM or hybrid model."""
    from repro_torch.models import decoder, hybrid, ssm_model
    if cfg.family in decoder.FAMILIES:
        return decoder.forward(params, batch["tokens"], cfg,
                               image_embeds=batch.get("image_embeds"))[0]
    mod = ssm_model if cfg.family == "ssm" else hybrid
    return mod.forward(params, batch["tokens"], cfg)[0]


class Residuals:
    """Inside it, the shapes of the tensors the models constrain to
    ("batch", "seq_shard", None), the residual between blocks, are
    recorded in ``shapes`` (each model module's ``constrain`` wrapped;
    a sequence shard where sequence parallelism ran).  chip_smoke's
    ``model_parallel`` phase uses it too."""
    MODULES = ("decoder", "ssm_model", "hybrid")

    def __enter__(self):
        import importlib
        self.shapes, self._old = [], {}
        for name in self.MODULES:
            mod = importlib.import_module(f"repro_torch.models.{name}")
            old = self._old[mod] = mod.constrain

            def rec(x, *axes, _old=old):
                if axes[1:2] == ("seq_shard",):
                    self.shapes.append(list(x.shape))
                return _old(x, *axes)
            mod.constrain = rec
        return self

    def __exit__(self, *exc):
        for mod, old in self._old.items():
            mod.constrain = old

    def layout(self):
        """The shapes seen, each once, in order."""
        out = []
        for sh in self.shapes:
            if sh not in out:
                out.append(sh)
        return out


def _sp_forward(cfg, mesh, rules, layout, params, batch):
    """(logits, the mean loss over the batch ranks, the residual shapes)
    of one no-grad forward on ``mesh`` under ``rules``."""
    from repro_torch.distributed import params as dparams
    from repro_torch.distributed import sharding
    from repro_torch.models import registry
    with torch.no_grad(), sharding.axis_rules(mesh, rules, layout.plan), \
            Residuals() as res:
        p = dparams.prepare(params, layout)
        logits = forward_logits(cfg, p, batch)
        loss = sharding.batch_mean(registry.loss_fn(p, batch, cfg)[1]["loss"])
    return logits, float(loss), res.shapes


def _sp_decode(cfg, mesh, rules, layout, params, tokens):
    """One reference decode step of ``tokens`` (B, 1) from an empty
    8-slot cache on ``mesh`` under ``rules``: (logits, residual shapes)."""
    from repro_torch.distributed import params as dparams
    from repro_torch.models import registry
    from repro_torch.train.steps import make_serve_step
    with dparams.mesh_context(cfg, mesh, rules, layout):
        cache = registry.init_cache(cfg, tokens.shape[0], 8, device="cpu")
    with Residuals() as res:
        _, _, last = make_serve_step(cfg, "reference", mesh, rules)(
            params, cache, {"tokens": tokens,
                            "pos": torch.tensor(0, dtype=torch.int32)})
    return last, res.shapes


def run_sp_scenarios(rank, world, scenarios, out_dir):
    """Rank body of the sequence-parallel tests: each scenario (an LM
    arch with overrides, its params and one global batch) on its mesh,
    the parameters this rank's model shards, the batch its batch rank's
    rows.  float32: the forward's logits and loss with the cell's rules
    (``seq_shard`` on ``model``) and with ``seq_shard: None``; the same
    for a prompt one token shorter (odd: the split does not apply) and
    for one decode step; the residual's shapes in each.  float64: the
    loss and the first gradient under the cell's rules, synced over the
    batch ranks.  Every rank writes ``<name>_rank<r>.json`` (losses,
    shapes) and ``<name>_rank<r>.npz`` (logits, and its gradient of
    every leaf gathered whole: its own copy of each replicated leaf)."""
    from repro_torch.distributed import params as dparams
    from repro_torch.distributed import sharding
    from repro_torch.models import registry
    from repro_torch.train.steps import (loss_and_grads, shard_batch,
                                         sync_grads)
    out_dir = Path(out_dir)
    for spec in scenarios:
        mesh = sharding.make_mesh(tuple(spec["mesh"]), torch.device("cpu"))
        cfg = _cfg(spec)
        full = load_tree(spec["params"])
        b = _batches(spec["batches"])[0]
        rules = _rules(spec, cfg, mesh, b["tokens"].shape[0])
        none = dict(rules, seq_shard=None)
        b = shard_batch(b, sharding.batch_rank(mesh, rules),
                        sharding.batch_ranks(mesh, rules))
        layout = dparams.model_layout(cfg, mesh)
        local = dparams.local_shards(full, layout.specs, mesh)
        odd = dict(b, tokens=b["tokens"][:, :-1], labels=b["labels"][:, :-1])
        rec, arrays = {"rank": rank}, {}
        for tag, rl in (("sp", rules), ("none", none)):
            for form, bt in (("", b), ("odd_", odd)):
                logits, loss, shapes = _sp_forward(cfg, mesh, rl, layout,
                                                   local, bt)
                arrays[f"{form}{tag}_logits"] = logits
                rec[f"{form}{tag}_loss"] = loss
                rec[f"{form}{tag}_residual"] = shapes
            logits, shapes = _sp_decode(cfg, mesh, rl, layout, local,
                                        b["tokens"][:, :1])
            arrays[f"decode_{tag}_logits"] = logits
            rec[f"decode_{tag}_residual"] = shapes
        p64 = as_dtype({"dtype": "float64"}, local)
        b64 = as_dtype({"dtype": "float64"}, b)
        with sharding.axis_rules(mesh, rules, layout.plan):
            loss, _, g = loss_and_grads(
                lambda p, bt: registry.loss_fn(dparams.prepare(p, layout),
                                               bt, cfg), p64, b64)
            rec["f64_loss"] = float(sharding.batch_mean(loss))
        sh = dparams.param_shardings(full, mesh,
                                     expert_dim=cfg.padded_experts or None)
        g = _full(sync_grads(g, sh, "none", rules))
        arrays.update({f"grad/{n}": x for n, x in _paths(g)})
        save_tree(out_dir / f"{spec['name']}_rank{rank}.npz", arrays)
        (out_dir / f"{spec['name']}_rank{rank}.json").write_text(
            json.dumps(rec))


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
    params = as_dtype(spec, load_tree(spec["params"]))
    opt = adamw.init(params)
    step = make_train_step(cfg, tcfg)
    losses = []
    for b in _batches(spec["batches"])[: spec["steps"]]:
        params, opt, m = step(params, opt, as_dtype(spec, b))
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
