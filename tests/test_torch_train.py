"""The port's training path against the JAX package on the CPU, at the
reduced agcn-2s config: AdamW (update within 1e-6 of JAX's on identical
numpy params, grads and state; schedule, clipping), the train step over
3 steps at microbatches 1 and 2 and grad compression none and bf16 (losses
within 1e-4; gradients within 1e-4 × the leaf's max |g| plus 1e-6, the
floor below which a gradient is rounding noise — the temporal conv's bias
feeds a BatchNorm that removes it, so its exact gradient is 0; params
after the step within 1e-5 wherever |g| > 1e-6, since AdamW's first
update is g/(|g| + 1e-8) and near that eps a rounding difference moves a
parameter by up to lr), the data streams bit-equal, checkpoints that
restore bit-equal across the two packages, the monitors, the int8 quant
functions, the tree utilities and the training loop with a resume."""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as jstore
from repro.common import tree as jtree
from repro.common.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.core import quant as jquant
from repro.data import pipeline as jpipe
from repro.fault import monitor as jmon
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.bridge import (opt_state_from_numpy, opt_state_to_numpy,
                                params_from_numpy)
from repro_torch.checkpoint import store
from repro_torch.common import tree
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import quant
from repro_torch.data import pipeline as tpipe
from repro_torch.fault import monitor
from repro_torch.launch.train import train_loop
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.steps import (loss_and_grads, make_loss_fn,
                                     make_train_step)

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)


def _np(tree_):
    return jax.tree.map(np.asarray, tree_)


def _close_trees(got, want, atol, rtol=0.0):
    want = jax.tree.leaves(want)
    got = tree.tree_leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), atol=atol,
                                   rtol=rtol)


# ---------------------------------------------------------------- config

def test_train_config_matches_jax():
    t, j = TrainConfig(), JTrainConfig()
    for f in dataclasses.fields(t):
        if f.name != "checkpoint_dir":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    import os
    import tempfile
    assert t.checkpoint_dir == os.path.join(tempfile.gettempdir(),
                                            "repro_ckpt")


# ----------------------------------------------------------------- adamw

def _opt_inputs(seed, step):
    rng = np.random.default_rng(seed)
    shapes = {"w": (4, 6), "b": (6,), "blocks": [{"k": (3, 2, 5)},
                                                 {"s": ()}]}
    mk = lambda: jax.tree.map(
        lambda s: rng.standard_normal(s).astype(np.float32), shapes,
        is_leaf=lambda s: isinstance(s, tuple))
    params, grads, m = mk(), mk(), mk()
    v = jax.tree.map(np.abs, mk())
    return params, grads, m, v, np.int32(step)


@pytest.mark.parametrize("step", [0, 2, 5, 60, 150])
def test_adamw_update_matches_jax(step):
    params, grads, m, v, st = _opt_inputs(step, step)
    tcfg = dict(learning_rate=1e-2, warmup_steps=5, total_steps=100,
                grad_clip=1.0)
    jp, js, jm = jadamw.update(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jadamw.OptState(jnp.asarray(st), jax.tree.map(jnp.asarray, m),
                        jax.tree.map(jnp.asarray, v)), JTrainConfig(**tcfg))
    tstate = opt_state_from_numpy(jadamw.OptState(st, m, v), device="cpu")
    tp, ts, tm = adamw.update(params_from_numpy(params, device="cpu"),
                              params_from_numpy(grads, device="cpu"),
                              tstate, TrainConfig(**tcfg))
    _close_trees(tp, jp, 1e-6)
    _close_trees(ts.m, js.m, 1e-6)
    _close_trees(ts.v, js.v, 1e-6)
    assert int(ts.step) == int(js.step) == step + 1
    assert ts.step.dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)


def test_adamw_schedule_and_clip_match_jax():
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    jt = JTrainConfig(learning_rate=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(adamw.schedule(torch.tensor(s, dtype=torch.int32), tcfg))
           for s in range(120)]
    want = [float(jadamw.schedule(jnp.asarray(s, jnp.int32), jt))
            for s in range(120)]
    np.testing.assert_allclose(lrs, want, rtol=1e-6, atol=1e-9)
    assert lrs[0] < lrs[9] and lrs[-1] < lrs[50] < lrs[10]
    g = {"a": np.full((10,), 100.0, np.float32), "b": np.ones(3, np.float32)}
    tc, tn = adamw.clip_by_global_norm(params_from_numpy(g, device="cpu"), 1.0)
    jc, jn = jadamw.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    _close_trees(tc, jc, 1e-7)
    assert float(adamw.global_norm(tc)) == pytest.approx(1.0, rel=1e-5)
    small = params_from_numpy({"a": np.full(4, 0.1, np.float32)}, "cpu")
    assert adamw.clip_by_global_norm(small, 1.0)[0]["a"].equal(small["a"])


def test_adamw_converges_quadratic():
    params = {"w": torch.tensor([5.0, -3.0])}
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=1, total_steps=200,
                       weight_decay=0.0)
    state = adamw.init(params)
    for _ in range(200):
        params, state, _ = adamw.update(params, {"w": 2 * params["w"]},
                                        state, tcfg)
    assert float(params["w"].abs().max()) < 0.1


# ------------------------------------------------------------ train step

@pytest.fixture(scope="module")
def agcn():
    jp = jreg.init_params(JCFG, jax.random.PRNGKey(0))
    batch = next(jpipe.make_batches(JCFG, jpipe.DataConfig(global_batch=8,
                                                           seq_len=0)))
    return jp, params_from_numpy(_np(jp), device="cpu"), batch


def _tbatch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _jax_grads(jp, batch, nmb):
    """The mean of JAX's per-microbatch gradients, as its scan sums them."""
    per = batch["x"].shape[0] // nmb
    gs = []
    for i in range(nmb):
        mb = {k: jnp.asarray(v[i * per:(i + 1) * per]) for k, v in
              batch.items()}
        gs.append(jax.grad(lambda p: jreg.loss_fn(p, mb, JCFG)[0])(jp))
    return jax.tree.map(lambda *g: sum(g) / nmb, *gs)


def _port_grads(tp, batch, nmb):
    per = batch["x"].shape[0] // nmb
    loss_fn = make_loss_fn(CFG)
    acc = None
    for i in range(nmb):
        mb = {k: torch.as_tensor(v[i * per:(i + 1) * per])
              for k, v in batch.items()}
        g = loss_and_grads(loss_fn, tp, mb)[2]
        acc = g if acc is None else tree.tree_map(torch.add, acc, g)
    return tree.tree_map(lambda a: a / nmb, acc)


@pytest.mark.parametrize("nmb,comp", [(1, "none"), (1, "bf16"),
                                      (2, "none"), (2, "bf16")])
def test_train_step_matches_jax(agcn, nmb, comp):
    jp, tp, batch = agcn
    kw = dict(learning_rate=3e-3, warmup_steps=3, total_steps=30,
              microbatches=nmb, grad_compression=comp)
    # gradients of the first step, as the card check holds them
    jg, tg = _jax_grads(jp, batch, nmb), _port_grads(tp, batch, nmb)
    for t, j in zip(tree.tree_leaves(tg), jax.tree.leaves(jg)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-4 * np.abs(j).max() + 1e-6)
    jstep = jax.jit(jax_make_train_step(JCFG, JTrainConfig(**kw)))
    tstep = make_train_step(CFG, TrainConfig(**kw))
    jpp, jo = jp, jadamw.init(jp)
    tpp, to = tp, adamw.init(tp)
    for i in range(3):
        jpp, jo, jm = jstep(jpp, jo, jax.tree.map(jnp.asarray, batch))
        tpp, to, tm = tstep(tpp, to, _tbatch(batch))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4, i
        assert set(tm) == set(jm)
        if i == 0:          # where |g| > 1e-6 the first update agrees
            for t, j, g in zip(tree.tree_leaves(tpp), jax.tree.leaves(jpp),
                               jax.tree.leaves(jg)):
                big = np.abs(np.asarray(g)) > 1e-6
                np.testing.assert_allclose(t.numpy()[big],
                                           np.asarray(j)[big], atol=1e-5,
                                           rtol=0)
    assert int(to.step) == 3
    # the step made new trees: the inputs are unchanged
    _close_trees(tp, jp, 0.0)


def test_every_leaf_gets_a_gradient(agcn):
    """The loss runs the reference backend with dense spatial convs even
    though the config's serving backend is ``cuda``: every parameter
    reaches the loss (the cuda backend's plan packs the temporal weights
    through numpy and would leave ``tconv_w`` without a gradient)."""
    _, tp, batch = agcn
    assert CFG.gcn_backend == "cuda"
    _, metrics, grads = loss_and_grads(make_loss_fn(CFG), tp, _tbatch(batch))
    assert set(metrics) == {"loss", "acc"}
    for name, g in tree.tree_paths(grads):
        assert g.abs().max() > 0, name
        if not name.endswith("tconv_b"):     # BN removes the conv bias
            assert g.abs().max() > 1e-5, name


def test_inference_loss_applies_the_config_plan(agcn):
    jp, tp, batch = agcn
    pruned = dataclasses.replace(CFG, prune_channel_fracs=(1.0, 0.5, 0.5,
                                                           0.5))
    jpruned = dataclasses.replace(JCFG, prune_channel_fracs=(1.0, 0.5, 0.5,
                                                             0.5))
    tl, tm = registry.loss_fn(tp, _tbatch(batch), pruned, inference=True)
    jl, jm = jreg.loss_fn(jp, jax.tree.map(jnp.asarray, batch), jpruned,
                          inference=True)
    assert abs(float(tl) - float(jl)) <= 1e-4
    assert float(tm["acc"]) == float(jm["acc"])
    dense = registry.loss_fn(tp, _tbatch(batch), pruned)[0]
    assert abs(float(dense) - float(tl)) > 1e-4


# ------------------------------------------------------------------ data

def test_lm_and_gcn_batches_bit_equal_to_jax():
    lm, jlm = get_config("smollm-360m", reduced=True), jax_get_config(
        "smollm-360m", reduced=True)
    for host in (0, 1):
        kw = dict(global_batch=8, seq_len=32, seed=1, host_index=host,
                  host_count=2)
        t = tpipe.lm_batches(lm, tpipe.DataConfig(**kw))
        j = jpipe.lm_batches(jlm, jpipe.DataConfig(**kw))
        for _ in range(3):
            tb, jb = next(t), next(j)
            assert set(tb) == set(jb)
            for k in tb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
    assert next(tpipe.make_batches(lm, tpipe.DataConfig(8, 16)))[
        "tokens"].shape == (8, 16)
    g = tpipe.make_batches(CFG, tpipe.DataConfig(4, 0, seed=3))
    jg = jpipe.make_batches(JCFG, jpipe.DataConfig(4, 0, seed=3))
    for _ in range(2):
        tb, jb = next(g), next(jg)
        for k in tb:
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("arch", ["agcn-2s", "smollm-360m"])
def test_batches_start_skips_ahead(arch):
    cfg = get_config(arch, reduced=True)
    d = tpipe.DataConfig(global_batch=4, seq_len=8, seed=2)
    full = tpipe.make_batches(cfg, d)
    want = [next(full) for _ in range(4)][2:]
    late = tpipe.make_batches(cfg, d, start=2)
    for w in want:
        got = next(late)
        for k in w:
            np.testing.assert_array_equal(got[k], w[k])


# ----------------------------------------------------------- checkpoints

def _tree():
    return {"a": torch.arange(10.0), "b": {"c": torch.ones(
        (3, 4), dtype=torch.bfloat16) * 1.5, "i": torch.tensor(7,
                                                                dtype=torch.int32)},
            "l": [torch.randn(2, 3, generator=torch.Generator().manual_seed(0))]}


def test_store_roundtrip_and_names(tmp_path):
    t = _tree()
    store.save(str(tmp_path), 5, t)
    assert store.latest_step(str(tmp_path)) == 5
    back = store.restore(str(tmp_path), 5, t)
    for (n, a), (m, b) in zip(tree.tree_paths(back), tree.tree_paths(t)):
        assert n == m and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), n
    assert [n for n, _ in tree.tree_paths(t)] == ["a", "b/c", "b/i", "l/0"]
    ost = adamw.init({"w": torch.zeros(2, 2), "b": torch.zeros(2)})
    assert [n for n, _ in tree.tree_paths(ost)] == [
        ".step", ".m/b", ".m/w", ".v/b", ".v/w"]
    assert store.latest_step(str(tmp_path / "none")) is None


def test_store_detects_corruption_and_missing(tmp_path):
    t = {"a": torch.arange(16.0)}
    path = store.save(str(tmp_path), 1, t)
    leaf = next(pathlib.Path(path).glob("leaf_*.npy"))
    arr = np.load(leaf)
    arr[0] = 999.0
    np.save(leaf, arr)
    with pytest.raises(IOError, match="checksum"):
        store.restore(str(tmp_path), 1, t)
    with pytest.raises(ValueError, match="missing"):
        store.restore(str(tmp_path), 1, {"z": torch.zeros(1)})


def test_store_gc_and_async(tmp_path):
    for s in (1, 2, 3, 4, 5):
        store.save(str(tmp_path / "gc"), s, {"a": torch.zeros(4)}, keep=2)
    assert sorted(int(p.name.split("_")[1])
                  for p in (tmp_path / "gc").iterdir()) == [4, 5]
    src = {"a": torch.arange(8.0)}
    th = store.save_async(str(tmp_path / "async"), 7, src)
    src["a"].zero_()                  # the host copy was taken already
    th.join(timeout=30)
    assert store.latest_step(str(tmp_path / "async")) == 7
    back = store.restore(str(tmp_path / "async"), 7, src)
    assert torch.equal(back["a"], torch.arange(8.0))


def test_checkpoints_restore_across_packages(agcn, tmp_path):
    """Params and AdamW state written by JAX restore bit-equal in the port,
    and the port's restore bit-equal in JAX (bf16 leaves included)."""
    jp, tp, batch = agcn
    jstep = jax.jit(jax_make_train_step(JCFG, JTrainConfig()))
    jp1, jo1, _ = jstep(jp, jadamw.init(jp), jax.tree.map(jnp.asarray, batch))
    jstore.save(str(tmp_path / "j"), 1, jp1)
    jstore.save(str(tmp_path / "j" / "opt"), 1, jo1)
    got_p = store.restore(str(tmp_path / "j"), 1, tp)
    got_o = store.restore(str(tmp_path / "j" / "opt"), 1, adamw.init(tp))
    _close_trees(got_p, jp1, 0.0)
    _close_trees(got_o.m, jo1.m, 0.0)
    _close_trees(got_o.v, jo1.v, 0.0)
    assert got_o.step.dtype == torch.int32 and int(got_o.step) == 1

    tstep = make_train_step(CFG, TrainConfig())
    tp1, to1, _ = tstep(tp, adamw.init(tp), _tbatch(batch))
    mixed = {"p": tp1, "h": tree.cast_tree(tp1["fc_w"], torch.bfloat16)}
    store.save(str(tmp_path / "t"), 1, mixed)
    store.save(str(tmp_path / "t" / "opt"), 1, to1)
    jlike = {"p": jp, "h": jp["fc_w"].astype(jnp.bfloat16)}
    back = jstore.restore(str(tmp_path / "t"), 1, jlike)
    _close_trees(tp1, back["p"], 0.0)
    assert back["h"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(back["h"]).view(np.uint16),
        mixed["h"].view(torch.int16).numpy().view(np.uint16))
    jo = jstore.restore(str(tmp_path / "t" / "opt"), 1, jadamw.init(jp))
    want = opt_state_to_numpy(to1)
    assert int(jo.step) == int(want["step"]) == 1
    for a, b in zip(jax.tree.leaves(jo.m) + jax.tree.leaves(jo.v),
                    jax.tree.leaves(want["m"]) + jax.tree.leaves(want["v"])):
        np.testing.assert_array_equal(np.asarray(a), b)


# ------------------------------------------------- monitors, quant, trees

def test_monitors_match_jax():
    for mod in (monitor, jmon):
        hb = mod.HeartbeatMonitor(num_hosts=4, timeout_s=10.0)
        for h in range(4):
            hb.beat(h, now=0.0)
        for h in range(3):
            hb.beat(h, now=20.0)
        assert hb.dead_hosts(now=25.0) == [3] and not hb.healthy(now=25.0)
        sd = mod.StragglerDetector(num_hosts=8, k=3.0)
        assert sd.stragglers() == set()
        for _ in range(5):
            for h in range(8):
                sd.record(h, 1.0 + (3.0 if h == 6 else 0.0))
        assert sd.stragglers() == {6}
    assert dataclasses.asdict(monitor.FaultPolicy()) == dataclasses.asdict(
        jmon.FaultPolicy())


@pytest.mark.parametrize("axis", [0, -1])
def test_int8_quant_bit_equal(axis):
    w = np.random.default_rng(0).standard_normal((64, 64)).astype(np.float32)
    q, s = quant.quantize_int8(torch.from_numpy(w), axis=axis)
    jq, js = jquant.quantize_int8(jnp.asarray(w), axis=axis)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = quant.dequantize_int8(q, s)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jquant.dequantize_int8(jq, js)))
    assert float((back - torch.from_numpy(w)).abs().max()) / np.abs(w).max() \
        < 0.02
    x = np.random.default_rng(1).standard_normal((5, 64)).astype(np.float32)
    if axis == -1:      # a 2-D scale is applied transposed, as in JAX
        np.testing.assert_allclose(
            quant.int8_matmul(torch.from_numpy(x), q, s).numpy(),
            np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js)),
            rtol=1e-5, atol=1e-4)
    s1 = s.reshape(-1)
    np.testing.assert_allclose(
        quant.int8_matmul(torch.from_numpy(x), q, s1).numpy(),
        np.asarray(jquant.int8_matmul(jnp.asarray(x), jq, js.reshape(-1))),
        rtol=1e-5, atol=1e-4)


def test_tree_utils_match_jax(agcn):
    jp, tp, _ = agcn
    assert tree.param_count(tp) == jtree.param_count(jp)
    assert tree.tree_bytes(tp) == jtree.tree_bytes(jp)
    np.testing.assert_allclose(float(tree.tree_norm(tp)),
                               float(jtree.tree_norm(jp)), rtol=1e-6)
    half = tree.cast_tree(tp, torch.bfloat16)
    jhalf = jtree.cast_tree(jp, jnp.bfloat16)
    assert tree.tree_bytes(half) == jtree.tree_bytes(jhalf)
    mixed = tree.cast_tree({"a": torch.ones(2), "i": torch.ones(2,
                                                                dtype=torch.int32)},
                           torch.float16)
    assert mixed["a"].dtype == torch.float16 and mixed["i"].dtype == torch.int32
    leaves = tree.tree_leaves(tp)
    assert [l.shape for l in leaves] == [tuple(x.shape) for x in
                                         jax.tree.leaves(jp)]
    again = tree.tree_unflatten(tp, leaves)
    assert tree.tree_paths(again) == tree.tree_paths(tp)


def test_bridge_opt_state_roundtrip(agcn):
    jp, tp, _ = agcn
    jo = jadamw.init(jp)
    to = opt_state_from_numpy(jax.tree.map(np.asarray, jo), device="cpu")
    assert isinstance(to, adamw.OptState) and to.step.dtype == torch.int32
    back = opt_state_to_numpy(to)
    rebuilt = jadamw.OptState(**back)
    assert jax.tree.structure(rebuilt) == jax.tree.structure(
        jax.tree.map(np.asarray, jo))


# -------------------------------------------------------------- the loop

def test_train_loop_trains_and_resumes(tmp_path):
    """A reduced run's loss falls; a run that stops after a checkpoint and
    is resumed reads the state and batches the uninterrupted run did, so
    its losses equal it (the CPU's float32 is deterministic)."""
    _, losses = train_loop("agcn-2s", TrainConfig(
        learning_rate=3e-3, warmup_steps=3, total_steps=30,
        checkpoint_every=0), reduced=True, batch=8, seq=0, device="cpu",
        resume=False, log_every=100)
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])

    kw = dict(learning_rate=3e-3, warmup_steps=3, total_steps=6,
              checkpoint_every=3)
    _, full = train_loop("agcn-2s", TrainConfig(
        checkpoint_dir=str(tmp_path / "full"), **kw), reduced=True, batch=8,
        seq=0, device="cpu", resume=False, log_every=100)

    class Stop(Exception):
        pass

    seen = []

    def stop_after_4(step, params, opt, metrics, ms):
        seen.append((step, int(opt.step), float(metrics["loss"]), ms > 0))
        if step == 3:
            raise Stop

    tcfg = TrainConfig(checkpoint_dir=str(tmp_path / "r"), **kw)
    with pytest.raises(Stop):
        train_loop("agcn-2s", tcfg, reduced=True, batch=8, seq=0,
                   device="cpu", resume=False, on_step=stop_after_4)
    assert [s[:2] for s in seen] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    assert all(s[3] for s in seen)
    assert store.latest_step(str(tmp_path / "r")) == 3
    assert store.latest_step(str(tmp_path / "r" / "opt")) == 3
    _, rest = train_loop("agcn-2s", tcfg, reduced=True, batch=8, seq=0,
                         device="cpu", resume=True, log_every=100)
    assert len(rest) == 3
    np.testing.assert_allclose([s[2] for s in seen[:3]] + rest, full,
                               rtol=0, atol=1e-6)


def test_train_loop_refuses_lm_family():
    """Every LM family trains now (``tests/test_torch_lm_train.py``; the
    data-parallel step is the same for each); what stays refused is a
    model axis above 1 (tensor or expert parallelism), named by its
    ROADMAP item."""
    from repro_torch.distributed import sharding
    cfg = get_config("xlstm-1.3b", reduced=True)
    params = registry.init_params(cfg, seed=0, device="cpu")

    class Mesh:
        shape = {"data": 1, "model": 2}
        axis_names = ("data", "model")
    spec = sharding.NamedSharding(Mesh(), sharding.PartitionSpec())
    step = make_train_step(cfg, TrainConfig(total_steps=1),
                           grad_shardings=tree.tree_map(lambda _: spec,
                                                        params))
    toks = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        step(params, adamw.init(params), {"tokens": toks, "labels": toks})
