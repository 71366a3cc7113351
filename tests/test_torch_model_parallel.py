"""The port's model axis (tensor, expert and vocabulary parallelism) and
its kv_seq decode over 4 gloo ranks on the CPU, against JAX on one device
and against the port in one process.  Every scenario's weights are JAX's
``init_params`` (seed 0) carried across as numpy; batches and tokens come
from numpy seeds.

One spawn of 4 ranks (``torch_dist_workers.run_mesh_scenarios``, with a
deadline of its own) re-forms the mesh per scenario, while this process
computes the references (the GCN's two meshes are held to each other, so
they take the port's own weights):

* training, 2 steps on a (2, 2) mesh under the "2d" policy: reduced
  granite-moe (experts on ``model``, the two all-to-alls; the vocabulary
  on ``model``), h2o-danube with head_dim 32 (so wq, wkv and wo reach the
  128 columns at which ``param_specs`` shards them: attention by heads,
  the kv products gathered because wkv's column shards are not whole
  heads), smollm with head_dim 64 (3 query and 1 kv head: attention run
  whole after gathering its sharded weights) and llava (its decoder,
  image embeddings in front): losses within 1e-4 of JAX and 1e-5 of the
  port in one process, the parameters after 2 steps within 1e-4 of JAX
  and 1e-5 of one process wherever the first step's gradient exceeds 1e-6
  (AdamW's first update is g / (|g| + 1e-8), so below that a rounding
  difference moves a parameter by up to the learning rate);
* training likewise for the SSM, hybrid and audio families, whose
  layers take shards by heads: xlstm with d_model 128 (2 mLSTM and 2
  sLSTM heads; at 64 the sLSTM's norm and out_proj stay under the 128
  rows at which they shard, and it would run whole), zamba2 with
  head_dim 64 (the shared attention's wq reaches 128 columns; 4 Mamba2
  heads) and whisper with head_dim 32 (self- and cross-attention and the
  non-gated MLP).  These three run in float64 on the port (JAX's under
  ``jax.enable_x64``): in float32 their rounding, passed through AdamW's
  normalised first updates, moved parameters by 4e-5 (whisper), 7e-5
  (xlstm) and 5e-3 (zamba2) between the (2, 2) mesh and one process;
  in float64 the gap is 6e-8 at most.  Every leaf is held by name, the
  replicated leaves each rank reads only in part included (sLSTM ``r``,
  Mamba2 ``wb``/``wc``/``wdt``/``A_log``/``D``/``dt_bias``, mLSTM
  ``wif``/``if_bias``, the norms): also the mesh's first gradient, within
  1e-9 of each leaf's max |g| of one process and 5e-4 of it of
  ``jax.grad`` (JAX's float32 loss and states: the bound of
  ``test_torch_lm_train.py``).  zamba2's parameters are not held to
  JAX's: JAX's float32 parts flip AdamW's updates of its small
  gradients, which moved them by 5.7e-3 against the port's float64 run
  (its losses are, within 1e-4);
* agcn-2s (reduced) on (1, 4) under ``dp_only`` (batch on every axis)
  against (4, 1): the same losses;
* decode: reduced h2o-danube (its 16-slot SWA ring, 4 slots a rank,
  wrapped) and gemma3 (local:global, its 8-token window over a 16-slot
  cache) at batch 1 on (4, 1) under kv_seq, and the head-parallel
  danube, the expert-parallel granite and the head-parallel xlstm,
  zamba2 and whisper (its memory drawn from a numpy seed) at batch 2 on
  (2, 2), each teacher-forced: logits within 1e-4 of JAX's ``serve_fn``
  (its reference attention);
* a checkpoint of the (2, 2) granite state restored in one process
  bit-equal to its gathered parameters;
* the elastic re-mesh with the model axis kept: 2 steps on (2, 2), the
  plan for 2 survivors (data 1, model 2, microbatches × 2), 2 more steps:
  within 1e-5 of 4 uninterrupted steps in one process."""
import concurrent.futures
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
from repro.launch import dryrun as jdryrun
from repro.models import registry as jreg
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.checkpoint import store
from repro_torch.common import tree
from repro_torch.common.config import SHAPES
from repro_torch.configs import CONFIGS, get_config
from repro_torch.distributed import params as dparams
from repro_torch.distributed import sharding
from repro_torch.launch import mesh as lmesh
from repro_torch.models import registry
from repro_torch.train.steps import loss_and_grads, make_loss_fn

RANKS = 4
JAX_THREADS = 3     # threads computing JAX's references beside the ranks
TCFG = {"learning_rate": 3e-3, "warmup_steps": 1, "total_steps": 10}
# (name, arch, config overrides, global batch, seq)
TRAIN = [("moe", "granite-moe-3b-a800m", {}, 8, 16),
         ("dense", "h2o-danube-1.8b", {"head_dim": 32}, 8, 16),
         ("smollm", "smollm-360m", {"head_dim": 64}, 8, 16),
         ("vlm", "llava-next-mistral-7b", {}, 8, 16),
         ("xlstm", "xlstm-1.3b", {"d_model": 128}, 4, 8),
         ("zamba2", "zamba2-7b", {"head_dim": 64}, 8, 16),
         ("whisper", "whisper-small", {"head_dim": 32}, 4, 8)]
# the scenarios of the families whose layers take shards by heads: in
# float64, with the first gradient held too
HEADS = ("xlstm", "zamba2", "whisper")
# (name, arch, overrides, mesh, batch, steps, cache slots)
DECODE = [("kv_danube", "h2o-danube-1.8b", {}, (4, 1), 1, 20, 32),
          ("kv_gemma3", "gemma3-12b", {}, (4, 1), 1, 14, 16),
          ("tp_danube", "h2o-danube-1.8b", {"head_dim": 32}, (2, 2), 2, 6, 8),
          ("ep_granite", "granite-moe-3b-a800m", {}, (2, 2), 2, 6, 8),
          ("tp_xlstm", "xlstm-1.3b", {"d_model": 128}, (2, 2), 2, 6, 8),
          ("tp_zamba2", "zamba2-7b", {"head_dim": 64}, (2, 2), 2, 6, 8),
          ("tp_whisper", "whisper-small", {"head_dim": 32}, (2, 2), 2, 6,
           8)]


def _np(t):
    return jax.tree.map(np.asarray, t)


def _jcfg(arch, over):
    return dataclasses.replace(jax_get_config(arch, reduced=True), **over)


def _jax_train(jcfg, jp, batches):
    step = jax.jit(jax_make_train_step(jcfg, JTrainConfig(**TCFG)))
    p, o = jp, jax.tree.map(jnp.asarray, _jadamw_init(jp))
    losses = []
    for b in batches:
        p, o, m = step(p, o, jax.tree.map(jnp.asarray, b))
        losses.append(float(m["loss"]))
    return losses, _np(p)


def _f64(tree):
    return jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x).astype(np.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x), tree)


def _jax_train_f64(jcfg, jp, batches):
    """:func:`_jax_train` under ``jax.enable_x64`` from float64 copies of
    the parameters and batches, as JAX's train step computes it (its
    ``value_and_grad`` of the loss, then ``adamw.update``; one compile of
    each), and the first batch's gradient."""
    from repro.optim import adamw as jadamw
    tcfg = JTrainConfig(**TCFG)
    with jax.enable_x64(True):
        p, o = _f64(jp), None
        vg = jax.jit(jax.value_and_grad(
            lambda p, b: jreg.loss_fn(p, b, jcfg), has_aux=True))
        upd = jax.jit(lambda p, g, o: jadamw.update(p, g, o, tcfg))
        o = jax.tree.map(jnp.asarray, _jadamw_init(p))
        losses, first = [], None
        for b in batches:
            (_, m), g = vg(p, _f64(b))
            first = _np(g) if first is None else first
            p, o, _ = upd(p, g, o)
            losses.append(float(m["loss"]))
        return (losses, _np(p)), first


def _jadamw_init(p):
    from repro.optim import adamw as jadamw
    return jadamw.init(p)


def _jax_decode(jcfg, jp, toks, max_len, memory=None):
    serve = jax.jit(lambda p, b, c: jreg.serve_fn(p, b, c, jcfg))
    cache = jreg.init_cache(jcfg, toks.shape[0], max_len, jnp.float32)
    extra = {} if memory is None else {"memory": jnp.asarray(memory)}
    out = []
    for t in range(toks.shape[1]):
        logits, cache = serve(jp, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                   "pos": jnp.asarray(t, jnp.int32),
                                   **extra}, cache)
        out.append(np.asarray(logits)[:, -1, :jcfg.padded_vocab])
    return np.stack(out)


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """Every scenario's inputs written, the 4 ranks started, the
    references computed while they run: (workdir, refs)."""
    work = tmp_path_factory.mktemp("mesh")
    specs, refs, jax_jobs = [], {}, []
    for name, arch, over, gb, seq in TRAIN:
        jcfg = _jcfg(arch, over)
        jp = jreg.init_params(jcfg, jax.random.PRNGKey(0))
        data = jpipe.make_batches(jcfg, jpipe.DataConfig(
            global_batch=gb, seq_len=seq, seed=2))
        batches = [next(data) for _ in range(2)]
        head = {"dtype": "float64", "grads": True} if name in HEADS else {}
        spec = W.write_inputs({"name": name, "arch": arch, "cfg": over,
                               "steps": 2, "mesh": [2, 2], "tcfg": TCFG,
                               **head}, work, _np(jp), batches)
        if name == "moe":
            spec["ckpt"] = str(work / "moe_ckpt")
        specs.append(spec)
        jax_jobs.append((name, jcfg, jp, batches, spec))
    # the gcn scenario holds two meshes of the port to each other: the
    # port's own weights (JAX's GCN init is the slowest to draw)
    gcn = jax_get_config("agcn-2s", reduced=True)
    gdata = jpipe.make_batches(gcn, jpipe.DataConfig(global_batch=8,
                                                     seq_len=0, seed=2))
    gp = registry.init_params(get_config("agcn-2s", reduced=True), seed=0,
                              device="cpu")
    gb = [next(gdata) for _ in range(2)]
    for mesh in ((1, 4), (4, 1)):
        specs.append(W.write_inputs(
            {"name": f"gcn{mesh[0]}{mesh[1]}", "arch": "agcn-2s",
             "steps": 2, "mesh": list(mesh), "tcfg": TCFG,
             "policy": "dp_only"}, work, gp, gb))
    drawn = {(a, tuple(o.items())): j[2] for (_, a, o, _, _), j in
             zip(TRAIN, jax_jobs)}
    for name, arch, over, mesh, B, T, L in DECODE:
        jcfg = _jcfg(arch, over)
        jp = drawn.get((arch, tuple(over.items())))
        if jp is None:
            jp = jreg.init_params(jcfg, jax.random.PRNGKey(0))
        toks = np.random.default_rng(5).integers(
            0, jcfg.vocab_size, (B, T)).astype(np.int32)
        np.save(work / f"{name}_tokens.npy", toks)
        spec = W.write_inputs({"name": name, "arch": arch, "cfg": over,
                               "kind": "decode", "mesh": list(mesh),
                               "max_len": L}, work, _np(jp), [])
        spec["tokens"] = str(work / f"{name}_tokens.npy")
        memory = None
        if jcfg.family == "audio":
            memory = np.random.default_rng(6).standard_normal(
                (B, jcfg.encoder_frames, jcfg.d_model)).astype(np.float32)
            np.save(work / f"{name}_memory.npy", memory)
            spec["memory"] = str(work / f"{name}_memory.npy")
        specs.append(spec)
        jax_jobs.append((name, jcfg, jp, toks, L, memory))
    dense = next(s for s in specs if s["name"] == "dense")
    data = jpipe.make_batches(_jcfg("h2o-danube-1.8b", {"head_dim": 32}),
                              jpipe.DataConfig(global_batch=8, seq_len=16,
                                               seed=2))
    el_batches = [next(data) for _ in range(4)]
    el = W.write_inputs({**dense, "name": "elastic", "kind": "elastic",
                         "more": 2}, work, W.load_tree(dense["params"]),
                        el_batches)
    el["rdzv2"] = str(work / "rdzv_survivors")
    specs.append(el)

    ctx = W.start(W.run_mesh_scenarios, RANKS, work, specs, str(work))
    try:
        # JAX's references in threads (its compiles and runs release the
        # GIL; ``jax.enable_x64`` is a thread-local context), the port's
        # one-process ones meanwhile on this thread
        with concurrent.futures.ThreadPoolExecutor(JAX_THREADS) as pool:
            futures = {}
            # the float64 ones, the slowest, first
            for job in sorted(jax_jobs, key=lambda j: j[0] not in HEADS):
                name = job[0]
                if len(job) == 5:
                    _, jcfg, jp, batches, _ = job
                    futures[name] = pool.submit(
                        _jax_train_f64 if name in HEADS else
                        lambda *a: (_jax_train(*a), None), jcfg, jp, batches)
                else:
                    futures[name] = pool.submit(_jax_decode, *job[1:])
            for job in jax_jobs:
                if len(job) == 5:
                    refs[job[0]] = {"one": W.one_process(job[4]),
                                    "grad": _first_grad(job[4])}
            refs["elastic"] = W.one_process({**el, "steps": 4})
            for name, fut in futures.items():
                if name in refs:
                    refs[name]["jax"], refs[name]["jax_grad"] = fut.result()
                else:
                    refs[name] = fut.result()
    finally:
        W.join(ctx, timeout=420)
    return work, refs


def _first_grad(spec):
    """The port's first-step gradient in one process, by leaf."""
    cfg = W._cfg(spec)
    b = W.as_dtype(spec, W._batches(spec["batches"])[0])
    return tree.tree_leaves(loss_and_grads(
        make_loss_fn(cfg), W.as_dtype(spec, W.load_tree(spec["params"])),
        b)[2])


def _result(work, name):
    return (json.loads((work / f"{name}.json").read_text()),
            W.load_tree(work / f"{name}.npz"))


@pytest.mark.parametrize("name", [t[0] for t in TRAIN])
def test_model_axis_training_matches_jax_and_one_process(mesh_run, name):
    work, refs = mesh_run
    got, params = _result(work, name)
    (jax_losses, jax_p), (one_l, one_p) = refs[name]["jax"], \
        refs[name]["one"]
    assert len(got["losses"]) == 2
    np.testing.assert_allclose(got["losses"], jax_losses, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got["losses"], one_l, atol=1e-5, rtol=0)
    paths = [n for n, _ in tree.tree_paths(params)]
    for n, t, j, o, g in zip(paths, tree.tree_leaves(params),
                             jax.tree.leaves(jax_p), tree.tree_leaves(one_p),
                             refs[name]["grad"]):
        big = (g.abs() > 1e-6).numpy()
        if name != "zamba2":
            np.testing.assert_allclose(t.numpy()[big], j[big], atol=1e-4,
                                       rtol=0, err_msg=n)
        np.testing.assert_allclose(t.numpy()[big], o.numpy()[big], atol=1e-5,
                                   rtol=0, err_msg=n)
    if name in HEADS:
        mesh_g = W.load_tree(work / f"{name}_grad.npz")
        for (n, t), o, j in zip(tree.tree_paths(mesh_g), refs[name]["grad"],
                                jax.tree.leaves(refs[name]["jax_grad"])):
            top = float(o.abs().max())
            np.testing.assert_allclose(t.numpy(), o.numpy(), rtol=0,
                                       atol=1e-9 * top, err_msg=n)
            np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                       atol=5e-4 * np.abs(j).max(), err_msg=n)


def test_model_axis_shards_what_the_plan_says(mesh_run):
    """Each rank holds its (data, model) shard of every leaf the specs
    shard (``params.held_bytes`` of the laid-out tree equals
    ``sharded_bytes`` of the whole one); the decoders' plans: danube at
    head_dim 32 shards attention by heads, smollm's 3/1 heads run
    attention whole though its weights shard, the reduced granite's
    64-wide attention stays whole, and every decoder shards its
    vocabulary.  (The SSM, hybrid and audio plans:
    ``test_head_parallel_plans_and_caches``.)"""
    work, _ = mesh_run
    mesh = W.FakeMesh({"data": 2, "model": 2})
    for name, arch, over, _, _ in TRAIN:
        cfg = dataclasses.replace(get_config(arch, reduced=True), **over)
        layout = dparams.model_layout(cfg, mesh)
        got, params = _result(work, name)
        for (n, full), (_, spec) in zip(tree.tree_paths(params),
                                        tree.tree_paths(layout.specs)):
            want = list(full.shape)
            for i, ax in enumerate(spec):
                if ax is not None:
                    want[i] //= 2
            assert got["local_shapes"][n] == want, (name, n)
        assert got["held_bytes"] == got["sharded_bytes"] < sum(
            full.element_size() * full.numel()
            for full in tree.tree_leaves(params))
        if name in HEADS:
            continue
        plan = layout.plan
        assert plan.vocab and plan.mlp == (cfg.family != "moe")
        assert plan.moe == (cfg.family == "moe")
        assert plan.attn == (name == "dense"), name
        wq = dict(tree.tree_paths(layout.specs))["layers/attn/wq"]
        assert (dparams.model_dim(wq) == -1) == (name in ("dense", "smollm"))


# (arch, overrides, mesh) -> the plan's head-parallel groups
HEAD_PLANS = [
    ("xlstm-1.3b", {"d_model": 128}, {"data": 2, "model": 2},
     {"mlstm", "slstm", "vocab"}),
    # at d_model 64 the sLSTM's out_proj (64, 64) stays whole
    ("xlstm-1.3b", {}, {"data": 1, "model": 2}, {"mlstm", "vocab"}),
    ("zamba2-7b", {"head_dim": 64}, {"data": 2, "model": 2},
     {"attn", "mlp", "mamba", "vocab"}),
    ("whisper-small", {"head_dim": 32}, {"data": 2, "model": 2},
     {"attn", "mlp", "vocab"}),
    # full width: xlstm's 4 heads and whisper's 12 do not divide 8
    ("xlstm-1.3b", None, {"data": 1, "model": 8}, {"vocab"}),
    ("xlstm-1.3b", None, {"data": 2, "model": 4},
     {"mlstm", "slstm", "vocab"}),
    ("zamba2-7b", None, {"data": 1, "model": 8},
     {"attn", "mlp", "mamba", "vocab"}),
    ("whisper-small", None, {"data": 1, "model": 8}, {"mlp", "vocab"}),
    ("whisper-small", None, {"data": 2, "model": 4},
     {"attn", "mlp", "vocab"}),
]


@pytest.mark.parametrize("arch,over,shape,want", HEAD_PLANS)
def test_head_parallel_plans_and_caches(arch, over, shape, want):
    """``plan_of`` of the SSM, hybrid and audio families takes a layer by
    heads exactly where its leaves shard as it expects and its heads
    divide the axis, and ``init_cache`` inside the mesh's context gives
    each rank H / M heads of every such layer (mLSTM state (…, B, H/M,
    dh, dh + 1), sLSTM (…, B, H/M, dh), Mamba2 conv (…, B, K − 1,
    d_inner/M) and state (…, B, H/M, N, P), Hkv / M heads of the KV
    caches) and the whole heads of every other."""
    cfg = (get_config(arch) if over is None else dataclasses.replace(
        get_config(arch, reduced=True), **over))
    mesh = W.FakeMesh(shape)
    m = shape["model"]
    layout = dparams.model_layout(cfg, mesh)
    plan = layout.plan
    assert {k for k, v in plan._asdict().items() if v} == want
    with dparams.mesh_context(cfg, mesh, layout=layout):
        cache = registry.init_cache(cfg, 2, 8, device="meta")
    shapes = {n: tuple(t.shape) for n, t in tree.tree_paths(cache)}

    def share(n, on):
        return n // m if on else n
    H = cfg.num_heads
    if cfg.family == "ssm":
        dh = cfg.ssm_expand * cfg.d_model // H
        assert shapes["mlstm/ssm"][-4:] == (2, share(H, plan.mlstm), dh,
                                            dh + 1)
        for k in "cnhm":
            assert shapes[f"slstm/{k}"][-3:] == (
                2, share(H, plan.slstm), cfg.d_model // H)
        return
    kv = "groups/attn/k" if cfg.family == "hybrid" else "k"
    assert shapes[kv][-2:] == (share(cfg.num_kv_heads, plan.attn),
                               cfg.head_dim)
    if cfg.family == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        Hm = d_inner // 64
        assert shapes["groups/mamba/conv"][-3:] == (
            2, cfg.ssm_conv - 1, share(d_inner, plan.mamba))
        assert shapes["groups/mamba/ssm"][-4:] == (
            2, share(Hm, plan.mamba), cfg.ssm_state, 64)


def test_gcn_on_a_model_axis_is_data_parallel(mesh_run):
    """agcn-2s under ``dp_only`` on (1, 4): the model axis carries batch
    (4 batch ranks), so its losses are the (4, 1) mesh's."""
    work, _ = mesh_run
    a, pa = _result(work, "gcn14")
    b, pb = _result(work, "gcn41")
    mesh = W.FakeMesh({"data": 1, "model": 4})
    rules = sharding.rules_for("dp_only", 8, mesh)
    assert sharding.batch_ranks(mesh, rules) == 4
    np.testing.assert_allclose(a["losses"], b["losses"], atol=1e-7, rtol=0)
    for x, y in zip(tree.tree_leaves(pa), tree.tree_leaves(pb)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", [d[0] for d in DECODE])
def test_sharded_decode_matches_jax(mesh_run, name):
    work, refs = mesh_run
    spec = next(d for d in DECODE if d[0] == name)
    got = np.load(work / f"{name}.npy")
    rules = json.loads((work / f"{name}.json").read_text())
    want = refs[name]
    assert got.shape[:2] == want.shape[:2] == (spec[5], spec[4])
    np.testing.assert_allclose(got[..., :want.shape[-1]], want, atol=1e-4,
                               rtol=1e-4)
    if spec[3] == (4, 1):
        assert rules == {"kv_seq": "data", "batch": None}
    else:
        assert rules["kv_seq"] is None and rules["batch"] is not None


def test_model_sharded_checkpoint_restores_in_one_process(mesh_run):
    work, _ = mesh_run
    _, params = _result(work, "moe")
    like = W.load_tree(work / "moe_params.npz")
    got = store.restore(str(work / "moe_ckpt"), 2, like)
    for (n, a), b in zip(tree.tree_paths(got), tree.tree_leaves(params)):
        assert torch.equal(a, b), n


def test_elastic_remesh_keeps_the_model_axis(mesh_run):
    work, refs = mesh_run
    got, params = _result(work, "elastic")
    want_l, want_p = refs["elastic"]
    assert got["plan"] == {"data": 1, "model": 2, "pods": 1,
                           "microbatch_multiplier": 2}
    assert got["microbatches"] == 2 and len(got["losses"]) == 4
    np.testing.assert_allclose(got["losses"], want_l, atol=1e-5, rtol=0)
    for t, w in zip(tree.tree_leaves(params), tree.tree_leaves(want_p)):
        np.testing.assert_allclose(t.numpy(), w.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mesh_name", sorted(lmesh.MESHES))
def test_rules_for_matches_jax(mesh_name):
    """``sharding.rules_for`` of every arch and shape cell equals JAX's
    ``launch.dryrun._rules_for`` on a mesh of the same axis sizes."""
    from repro.common.config import GCN_SHAPES as JGCN, SHAPES as JSHAPES
    m = lmesh.named_mesh(mesh_name)

    class JMesh:
        shape = m.shape
    from repro_torch.launch.dryrun import cell_rules
    for arch in CONFIGS:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
        for shape in (JGCN if cfg.family == "gcn" else JSHAPES):
            assert cell_rules(cfg, shape, m) == jdryrun._rules_for(
                jcfg, shape, JMesh()), (arch, shape)
    assert set(SHAPES) <= set(JSHAPES)
