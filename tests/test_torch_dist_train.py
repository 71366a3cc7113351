"""The port's data-parallel training over 4 gloo ranks on the CPU
(``torch.multiprocessing``, a ``file://`` rendezvous), against JAX on one
device at the same global batch and microbatches, and against the port in
one process:

* reduced agcn-2s (BatchNorm statistics over every rank's rows) and
  reduced granite-moe (the load-balance means over every rank's tokens),
  3 steps at data = 4 and 2 microbatches: losses within 1e-4 of JAX's;
  parameters after the first step within 1e-5 of JAX's wherever JAX's
  first gradient exceeds 1e-6 (PR 21's bound: AdamW's first update is
  g/(|g| + 1e-8), so near that eps a rounding difference moves a
  parameter by up to lr); after 3 steps within 1e-4 × the leaf's max
  |value| of JAX's one-device run with its gradients taken in float64
  (``jax.enable_x64``), wherever that gradient exceeds 1e-6 at every
  step, and within 1e-5 of the port's one-process run.  JAX's float32
  run is not the oracle after step 1: from its step-1 state its float32
  gradients of the first block and ``data_bn`` are up to 1e-2 of the
  leaf's max from the float64 ones (the port's float32 ones 7e-7), and
  AdamW carries that into parameters 2.2e-4 apart by step 3;
* reduced smollm-360m at data = 4 against the port in one process: 1e-5;
* the bf16-compressed gradient sync against the exact mean gradient,
  held to bf16 rounding (2^-7 of the leaf's max |g|: four bf16 payloads
  summed in bf16), not to 1e-5; the uncompressed sync to 1e-6;
* ``param_shardings`` under the "2d" policy at a width where leaves shard
  over ``data`` (d_model 128): those leaves are reduce-scattered into
  1/4 shards, and 2 steps equal one process within 1e-5;
* ``launch.train.train_loop`` on a (4, 1) mesh as torchrun ranks run it
  (host slices, rank-0 checkpoints, a resume onto DTensors) against one
  process on the concatenated slices: 1e-5;
* the elastic round trip: 2 steps at data = 4, a checkpoint, the plan
  for 2 survivors (data = 2, microbatches × 2), the checkpoint resharded
  onto the new 2-rank group, 2 more steps: within 1e-5 of 4
  uninterrupted steps in one process;
* ``plan_degraded_mesh`` and ``adjust_train_config`` equal to JAX's over
  a grid, with no process group.

All ranks run in one spawn (a module fixture) with a deadline of its own;
the rank code lives in the JAX-free ``torch_dist_workers`` module."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro.common.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro.fault import elastic as jelastic
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.common import tree
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.fault import elastic
from repro_torch.models import registry
from repro_torch.train.steps import loss_and_grads, make_loss_fn

RANKS = 4
TCFG = {"learning_rate": 3e-3, "warmup_steps": 3, "total_steps": 30}


def _np(t):
    return jax.tree.map(np.asarray, t)


def _jax_x64_run(arch, params, batches, microbatches):
    """JAX on one device with the gradients in float64: each step the mean
    of its microbatches' float64 gradients, then ``adamw.update`` (which
    takes them in float32, as the train step does).  Returns (losses,
    final params, where the gradient was at most 1e-6 at some step)."""
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = JTrainConfig(**dict(TCFG, microbatches=microbatches))
    def wide(t):
        return jax.tree.map(lambda x: jnp.asarray(
            np.asarray(x, np.float64) if np.asarray(x).dtype == np.float32
            else np.asarray(x)), t)

    with jax.enable_x64(True):
        lg = jax.jit(jax.value_and_grad(
            lambda q, b: jreg.loss_fn(q, b, jcfg)[0]))
        p, o = wide(params), jadamw.init(wide(params))
        small = jax.tree.map(lambda x: np.zeros(x.shape, bool), params)
        losses = []
        for b in batches:
            b = wide(b)
            per = b[next(iter(b))].shape[0] // microbatches
            out = [lg(p, {k: v[i * per:(i + 1) * per] for k, v in b.items()})
                   for i in range(microbatches)]
            g = jax.tree.map(lambda *x: sum(x) / microbatches,
                             *[gi for _, gi in out])
            small = jax.tree.map(
                lambda s, x: s | (np.abs(np.asarray(x)) <= 1e-6), small, g)
            p, o, _ = jadamw.update(p, g, o, tcfg)
            losses.append(sum(float(li) for li, _ in out) / microbatches)
        return losses, _np(p), small


def _jax_run(arch, params, batches, microbatches):
    """JAX on one device: (losses, final params, first-step gradients)."""
    jcfg = jax_get_config(arch, reduced=True)
    kw = dict(TCFG, microbatches=microbatches)
    step = jax.jit(jax_make_train_step(jcfg, JTrainConfig(**kw)))
    p, o = params, jadamw.init(params)
    b0 = jax.tree.map(jnp.asarray, batches[0])
    per = b0[next(iter(b0))].shape[0] // microbatches
    gs = [jax.grad(lambda q: jreg.loss_fn(q, {k: v[i * per:(i + 1) * per]
                                              for k, v in b0.items()},
                                          jcfg)[0])(params)
          for i in range(microbatches)]
    g = jax.tree.map(lambda *x: sum(x) / microbatches, *gs)
    losses = []
    for b in batches:
        p, o, m = step(p, o, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    return losses, _np(p), _np(g)


@pytest.fixture(scope="module")
def dist_run(tmp_path_factory):
    """Every scenario's inputs written, the 4 ranks spawned once, and the
    references computed: {name: (spec, reference)}."""
    work = tmp_path_factory.mktemp("dist")
    specs, refs = [], {}

    # gcn and moe against JAX on one device
    for name, arch, gb, seq in (("gcn", "agcn-2s", 16, 0),
                                ("moe", "granite-moe-3b-a800m", 8, 32)):
        jcfg = jax_get_config(arch, reduced=True)
        jp = jreg.init_params(jcfg, jax.random.PRNGKey(0))
        data = jpipe.make_batches(jcfg, jpipe.DataConfig(global_batch=gb,
                                                         seq_len=seq, seed=2))
        batches = [next(data) for _ in range(3)]
        spec = W.write_inputs({"name": name, "arch": arch, "steps": 3,
                               "tcfg": dict(TCFG, microbatches=2)},
                              work, _np(jp), batches)
        specs.append(spec)
        refs[name] = (_jax_run(arch, jp, batches[:1], 2),
                      _jax_run(arch, jp, batches, 2)[0], W.one_process(spec),
                      _jax_x64_run(arch, jp, batches, 2))

    # dense, the bf16 sync, the 2d policy and the elastic round trip
    smollm = get_config("smollm-360m", reduced=True)
    data = tpipe.make_batches(smollm, tpipe.DataConfig(8, 32, seed=3))
    lm_batches = [next(data) for _ in range(4)]
    lm_params = registry.init_params(smollm, seed=4, device="cpu")
    dense = W.write_inputs({"name": "dense", "arch": "smollm-360m",
                            "steps": 3, "tcfg": TCFG}, work, lm_params,
                           lm_batches)
    grads = {**dense, "name": "grads", "kind": "grads"}
    wide_cfg = {"d_model": 128}
    wide = dataclasses.replace(smollm, **wide_cfg)
    fsdp = W.write_inputs({"name": "fsdp", "arch": "smollm-360m",
                           "cfg": wide_cfg, "steps": 2, "tcfg": TCFG}, work,
                          registry.init_params(wide, seed=5, device="cpu"),
                          lm_batches)
    el = {**dense, "name": "elastic", "kind": "elastic", "steps": 2,
          "more": 2, "rdzv2": str(work / "rdzv_survivors")}
    loop_tcfg = {"learning_rate": 3e-3, "warmup_steps": 1}
    loop = {"name": "loop", "kind": "loop", "arch": "smollm-360m",
            "steps": 3, "batch": 8, "seq": 32, "tcfg": loop_tcfg}
    specs += [dense, grads, fsdp, loop, el]
    refs["dense"] = W.one_process(dense)
    refs["fsdp"] = W.one_process(fsdp)
    refs["elastic"] = W.one_process({**dense, "steps": 4})
    b0 = {k: torch.as_tensor(v) for k, v in lm_batches[0].items()}
    refs["grads"] = loss_and_grads(make_loss_fn(smollm), lm_params, b0)[2]
    # train_loop's global batch: the 4 hosts' slices, each from its own
    # stream (host_index seeds it), in rank order
    hosts = [tpipe.lm_batches(smollm, tpipe.DataConfig(
        8, 32, seed=0, host_index=r, host_count=RANKS)) for r in range(RANKS)]
    loop_batches = []
    for _ in range(3):
        parts = [next(h) for h in hosts]
        loop_batches.append({k: np.concatenate([p[k] for p in parts])
                             for k in parts[0]})
    refs["loop"] = W.one_process(W.write_inputs(
        {"name": "loop_ref", "arch": "smollm-360m", "steps": 3,
         "tcfg": {**loop_tcfg, "total_steps": 3}}, work,
        registry.init_params(smollm, seed=0, device="cpu"), loop_batches))

    W.spawn(W.run_scenarios, RANKS, work, specs, str(work), timeout=420)
    return work, refs


def _result(work, name):
    return (json.loads((work / f"{name}.json").read_text()),
            W.load_tree(work / f"{name}.npz"))


@pytest.mark.parametrize("name", ["gcn", "moe"])
def test_data_parallel_matches_jax_one_device(dist_run, name):
    work, refs = dist_run
    got, params = _result(work, name)
    (_, jax_p1, g), jax_losses, (_, one_p), (x64_l, x64_p, small) = \
        refs[name]
    assert len(got["losses"]) == 3
    np.testing.assert_allclose(got["losses"], jax_losses, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["losses"], x64_l, atol=1e-4, rtol=0)
    first = tree.tree_leaves(W.load_tree(work / f"{name}_step1.npz"))
    assert len(first) == len(jax.tree.leaves(jax_p1))
    for t, j, gj in zip(first, jax.tree.leaves(jax_p1), jax.tree.leaves(g)):
        big = np.abs(gj) > 1e-6
        np.testing.assert_allclose(t.numpy()[big], j[big], atol=1e-5, rtol=0)
    # the temporal conv's bias feeds a BatchNorm that removes it: its exact
    # gradient is 0, and both runs move it by AdamW-normalised noise
    for t, w, gj in zip(tree.tree_leaves(params), tree.tree_leaves(one_p),
                        jax.tree.leaves(g)):
        big = np.abs(gj) > 1e-6
        np.testing.assert_allclose(t.numpy()[big], w.numpy()[big],
                                   atol=1e-5, rtol=0)
    for (n, t), j, sm in zip(tree.tree_paths(params), jax.tree.leaves(x64_p),
                             jax.tree.leaves(small)):
        np.testing.assert_allclose(t.numpy()[~sm], j[~sm], rtol=0,
                                   atol=1e-4 * np.abs(j).max(), err_msg=n)


@pytest.mark.parametrize("name", ["dense", "fsdp", "elastic"])
def test_data_parallel_matches_one_process(dist_run, name):
    work, refs = dist_run
    got, params = _result(work, name)
    want_l, want_p = refs[name]
    np.testing.assert_allclose(got["losses"], want_l, atol=1e-5, rtol=0)
    for t, w in zip(tree.tree_leaves(params), tree.tree_leaves(want_p)):
        np.testing.assert_allclose(t.numpy(), w.numpy(), atol=1e-5, rtol=0)
    if name == "elastic":
        assert got["plan"] == {"data": 2, "model": 1, "pods": 1,
                               "microbatch_multiplier": 2}
        assert got["microbatches"] == 2 and len(got["losses"]) == 4


def test_train_loop_on_a_mesh_matches_one_process(dist_run):
    """``launch.train.train_loop(mesh=(4, 1))`` as four torchrun ranks run
    it: DTensor parameters, each rank's host slice, rank-0 checkpoints and
    a resume onto DTensors, against one process on the four host slices
    concatenated (1e-5)."""
    work, refs = dist_run
    got = json.loads((work / "loop.json").read_text())
    want, _ = refs["loop"]
    np.testing.assert_allclose(got["losses"], want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got["resumed"], want[2:], atol=1e-5, rtol=0)
    assert sorted(p.name for p in (work / "loop_ckpt").iterdir()
                  if p.name.startswith("step_")) == ["step_2"]


def test_2d_policy_reduce_scatters_into_data_shards(dist_run):
    work, _ = dist_run
    got, params = _result(work, "fsdp")
    # placements per mesh dim (data, model): "S(d)" shards tensor dim d
    sharded = {n: p for n, p in got["placements"].items()
               if p[0].startswith("S(")}
    assert {"embed", "layers/attn/wq", "layers/mlp/wi"} <= set(sharded)
    full = dict(tree.tree_paths(params))
    for n, pl in sharded.items():
        dim = int(pl[0][2:-1])
        want = list(full[n].shape)
        want[dim] //= RANKS
        assert got["local_shapes"][n] == want, n
    for n, pl in got["placements"].items():
        if n not in sharded:
            assert got["local_shapes"][n] == list(full[n].shape)


def test_grad_sync_exact_and_bf16(dist_run):
    work, refs = dist_run
    want = refs["grads"]
    exact = W.load_tree(work / "grads_none.npz")
    comp = W.load_tree(work / "grads_bf16.npz")
    assert json.loads((work / "grads.json").read_text()) == {
        "none": ["torch.float32"], "bf16": ["torch.bfloat16"]}
    for (n, w), e, c in zip(tree.tree_paths(want), tree.tree_leaves(exact),
                            tree.tree_leaves(comp)):
        scale = float(w.abs().max())
        np.testing.assert_allclose(e.numpy(), w.numpy(), atol=1e-6, rtol=0)
        assert torch.equal(c, c.bfloat16().float()), n
        # four bf16 payloads summed in bf16, then halved twice (exact)
        assert float((c - w).abs().max()) <= 2 ** -7 * scale, n


@pytest.mark.parametrize("pods", [1, 2])
@pytest.mark.parametrize("model", [1, 4, 16])
@pytest.mark.parametrize("old_data", [1, 4, 16])
def test_elastic_plan_matches_jax(old_data, model, pods):
    for alive in range(0, 2 * old_data * model * pods + 3):
        t = elastic.plan_degraded_mesh(alive, model=model, old_data=old_data,
                                       pods=pods)
        j = jelastic.plan_degraded_mesh(alive, model=model,
                                        old_data=old_data, pods=pods)
        assert (t is None) == (j is None), alive
        if t is None:
            continue
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        assert t.chips == j.chips
        for mb in (1, 3):
            assert elastic.adjust_train_config(
                TrainConfig(microbatches=mb), t).microbatches == \
                jelastic.adjust_train_config(
                    JTrainConfig(microbatches=mb), j).microbatches
