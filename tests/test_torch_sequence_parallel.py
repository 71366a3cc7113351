"""Sequence parallelism between blocks (JAX's ``seq_shard`` rule) on the
port's model axis, against the replicated layout on the same mesh, the
port in one process and JAX on one device.  Every scenario's weights are
JAX's ``init_params`` (seed 0) carried across as numpy; its batch comes
from JAX's data pipeline (seed 2).

One spawn of 4 gloo ranks (``torch_dist_workers.run_sp_scenarios``, with a
deadline of its own) runs each scenario on a (2, 2) mesh, while this
process computes the references: reduced granite-moe (experts on
``model``, attention run whole), h2o-danube with head_dim 32 (attention
by heads, its 16-token window inside a 32-token sequence), llava (8 image
embeddings before 8 text tokens), xlstm with d_model 128 (mLSTM and
sLSTM by heads) and zamba2 with head_dim 64 (the shared attention and the
Mamba2 layers by heads):

* float32: with the cell's rules the residual between blocks is each
  rank's (B/2, S/2, d) shard, and the logits and the loss are those of
  ``seq_shard: None`` within 1e-6; the loss is JAX's within 1e-4;
* float64: each rank's first gradient of every leaf, synced over the
  batch ranks and gathered whole (its own copy of each replicated leaf),
  within 1e-9 of the leaf's max |g| of one process, and the loss within
  1e-5 (a norm scale read on the shard alone, its gradient not summed
  over ``model``, misses by a share of its gradient);
* a prompt one token shorter (odd: the split does not apply) and one
  decode step stay replicated, with the numbers of ``seq_shard: None``.

The static checks run on meta tensors on a shape-only (1, 4) mesh."""
import concurrent.futures
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro.models import registry as jreg
from repro_torch.common import tree
from repro_torch.configs import get_config
from repro_torch.distributed import params as dparams
from repro_torch.distributed import sharding
from repro_torch.launch.op_cost import OpCost
from repro_torch.models import registry
from repro_torch.train.steps import loss_and_grads, make_loss_fn

RANKS, MESH = 4, (2, 2)
# (name, arch, config overrides, global batch, sequence: JAX's seq_len,
# the VLM's image embeddings included)
SCENARIOS = [("moe", "granite-moe-3b-a800m", {}, 8, 16),
             ("dense", "h2o-danube-1.8b", {"head_dim": 32}, 8, 32),
             ("vlm", "llava-next-mistral-7b", {}, 8, 16),
             ("xlstm", "xlstm-1.3b", {"d_model": 128}, 4, 8),
             ("zamba2", "zamba2-7b", {"head_dim": 64}, 4, 16)]
NAMES = [s[0] for s in SCENARIOS]
TIMEOUT = 240        # the ranks' deadline, seconds
# the leaves a rank reads on its sequence shard: the norms on the residual
SEQ_SHARD_LEAVES = {
    "granite-moe-3b-a800m": ["final_norm/scale", "layers/ln1/scale",
                             "layers/ln2/scale"],
    "h2o-danube-1.8b": ["final_norm/scale", "layers/ln1/scale",
                        "layers/ln2/scale"],
    "gemma3-12b": ["final_norm/scale", "layers/ln1/scale",
                   "layers/ln2/scale"],
    "llava-next-mistral-7b": ["final_norm/scale", "layers/ln1/scale",
                              "layers/ln2/scale"],
    "xlstm-1.3b": ["final_norm/scale", "layers/mlstm/ln/scale",
                   "layers/slstm/ln/scale"],
    "zamba2-7b": ["final_norm/scale", "mamba_groups/ln/scale",
                  "mamba_tail/ln/scale", "shared/ln2/scale",
                  "use_ln/scale"],
}


def _jcfg(arch, over):
    return dataclasses.replace(jax_get_config(arch, reduced=True), **over)


def _cfg(arch, over):
    return dataclasses.replace(get_config(arch, reduced=True), **over)


def _jax_loss(jcfg, jp, batch):
    """JAX's float32 cross-entropy of the whole batch on one device."""
    return float(jax.jit(lambda p, b: jreg.loss_fn(p, b, jcfg))(
        jp, batch)[1]["loss"])


def _one_process(spec):
    """The port's float64 loss and first gradient (by leaf path) in one
    process."""
    cfg = W._cfg(spec)
    f64 = {"dtype": "float64"}
    loss, _, g = loss_and_grads(
        make_loss_fn(cfg), W.as_dtype(f64, W.load_tree(spec["params"])),
        W.as_dtype(f64, W._batches(spec["batches"])[0]))
    return float(loss), dict(tree.tree_paths(g))


@pytest.fixture(scope="module")
def sp_run(tmp_path_factory):
    """Every scenario's inputs written, the ranks started, the references
    computed while they run: (workdir, refs by name)."""
    work = tmp_path_factory.mktemp("sp")
    specs, jax_jobs = [], {}
    for name, arch, over, gb, seq in SCENARIOS:
        jcfg = _jcfg(arch, over)
        jp = jreg.init_params(jcfg, jax.random.PRNGKey(0))
        batch = next(jpipe.make_batches(jcfg, jpipe.DataConfig(
            global_batch=gb, seq_len=seq, seed=2)))
        specs.append(W.write_inputs(
            {"name": name, "arch": arch, "cfg": over, "mesh": list(MESH)},
            work, jax.tree.map(np.asarray, jp),
            [jax.tree.map(np.asarray, batch)]))
        jax_jobs[name] = (jcfg, jp, batch)
    ctx = W.start(W.run_sp_scenarios, RANKS, work, specs, str(work))
    refs = {}
    try:
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            futures = {n: pool.submit(_jax_loss, *job)
                       for n, job in jax_jobs.items()}
            for spec in specs:
                refs[spec["name"]] = {"one": _one_process(spec)}
            for n, fut in futures.items():
                refs[n]["jax"] = fut.result()
    finally:
        W.join(ctx, timeout=TIMEOUT)
    return work, refs


def _rank(work, name, r):
    rec = json.loads((work / f"{name}_rank{r}.json").read_text())
    return rec, dict(tree.tree_paths(W.load_tree(
        work / f"{name}_rank{r}.npz")))


def _shapes(name):
    """(whole residual, sequence shard) shapes of a rank's rows."""
    _, arch, over, gb, seq = next(s for s in SCENARIOS if s[0] == name)
    d = _cfg(arch, over).d_model
    rows = gb // MESH[0]
    return (rows, seq, d), (rows, seq // MESH[1], d)


@pytest.mark.parametrize("name", NAMES)
def test_residual_is_a_sequence_shard_with_replicated_numbers(sp_run, name):
    work, _ = sp_run
    whole, shard = _shapes(name)
    for r in range(RANKS):
        rec, a = _rank(work, name, r)
        assert rec["sp_residual"] and all(
            tuple(s) == shard for s in rec["sp_residual"]), (r, shard)
        assert rec["none_residual"] and all(
            tuple(s) == whole for s in rec["none_residual"])
        np.testing.assert_allclose(rec["sp_loss"], rec["none_loss"],
                                   atol=1e-6, rtol=0)
        torch.testing.assert_close(a["sp_logits"], a["none_logits"],
                                   atol=1e-6, rtol=0)
        assert a["sp_logits"].shape[:2] == whole[:2]


@pytest.mark.parametrize("name", NAMES)
def test_first_gradient_of_every_leaf_on_every_rank(sp_run, name):
    work, refs = sp_run
    loss, grads = refs[name]["one"]
    for r in range(RANKS):
        rec, a = _rank(work, name, r)
        np.testing.assert_allclose(rec["f64_loss"], loss, atol=1e-5, rtol=0)
        assert {n[5:] for n in a if n.startswith("grad/")} == set(grads)
        for n, want in grads.items():
            top = float(want.abs().max())
            np.testing.assert_allclose(a[f"grad/{n}"].numpy(), want.numpy(),
                                       rtol=0, atol=1e-9 * top,
                                       err_msg=f"rank {r} {n}")


@pytest.mark.parametrize("name", NAMES)
def test_sequence_parallel_loss_matches_jax(sp_run, name):
    work, refs = sp_run
    for r in range(RANKS):
        rec, _ = _rank(work, name, r)
        np.testing.assert_allclose(rec["sp_loss"], refs[name]["jax"],
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", NAMES)
def test_indivisible_prompt_and_decode_stay_replicated(sp_run, name):
    """A sequence one token shorter (odd) and one decode token: the split
    does not apply, the residual stays whole and the numbers are those of
    ``seq_shard: None``, bit for bit."""
    work, _ = sp_run
    rows, S, d = _shapes(name)[0]
    for r in range(RANKS):
        rec, a = _rank(work, name, r)
        assert rec["odd_sp_residual"] and all(
            tuple(s) == (rows, S - 1, d) for s in rec["odd_sp_residual"])
        assert rec["decode_sp_residual"] and all(
            tuple(s) == (rows, 1, d) for s in rec["decode_sp_residual"])
        assert rec["odd_sp_loss"] == rec["odd_none_loss"]
        assert torch.equal(a["odd_sp_logits"], a["odd_none_logits"])
        assert torch.equal(a["decode_sp_logits"], a["decode_none_logits"])


@pytest.mark.parametrize("arch", sorted(SEQ_SHARD_LEAVES))
def test_seq_shard_leaves_are_the_norms_on_the_residual(arch):
    """The leaves whose gradients sum over ``model`` under sequence
    parallelism are exactly the scales of the norms on the residual
    between blocks, full config and reduced alike (the norms inside a
    head-parallel layer run on the gathered sequence)."""
    for cfg in (get_config(arch), get_config(arch, reduced=True)):
        paths = [n for n, _ in tree.tree_paths(registry.init_params(
            cfg, device="meta"))]
        assert sorted(dparams.seq_shard_leaves(paths)) == \
            SEQ_SHARD_LEAVES[arch], cfg.name


def _danube_step(seq_shard, B=2, S=32):
    """Reduced h2o-danube's loss and gradients on meta tensors on a
    shape-only (1, 4) mesh, counted: (its cost analysis, the config)."""
    cfg = get_config("h2o-danube-1.8b", reduced=True)
    mesh = W.FakeMesh({"data": 1, "model": 4})
    layout = dparams.model_layout(cfg, mesh)
    params = dparams.local_shards(registry.init_params(cfg, device="meta"),
                                  layout.specs, mesh)
    batch = {k: torch.empty((B, S), dtype=torch.int32, device="meta")
             for k in ("tokens", "labels")}
    rules = dict(sharding.rules_for(layout.policy, B, mesh),
                 seq_shard=seq_shard)
    loss = make_loss_fn(cfg)
    with OpCost() as c, sharding.axis_rules(mesh, rules, layout.plan):
        loss_and_grads(lambda p, b: loss(dparams.prepare(p, layout), b),
                       params, batch)
    return c.analyze(), cfg, layout.plan


def test_danube_train_step_counts_reduce_scatters_and_all_gathers():
    """Reduced danube at model 4 (attention run whole: 2 kv heads; the
    MLP by d_ff; the vocabulary sharded), B 2 x S 32.  Under sequence
    parallelism, with act the bytes of one (B, S, d) activation:
    all-gathers of 10 acts (per layer attention's input and, in the
    backward, its output slice's cotangent; the MLP's input and its
    output's cotangent; the final norm's output before the logits; the
    embedding's cotangent), reduce-scatters of 6 shards of act / 4 (the
    embedding's rows, per layer the MLP's output and its input's
    cotangent, the logits' input cotangent), and all-reduces of no
    activation: the loss's three (B, S − 1) vocabulary reductions and the
    norm scales' gradients.  Replicated: 6 all-reduces of act.  Equal
    FLOPs; a lower peak."""
    sp, cfg, plan = _danube_step("model")
    rep, _, _ = _danube_step(None)
    assert (plan.attn, plan.mlp, plan.vocab) == (False, True, True)
    B, S, M, L, d, f32 = 2, 32, 4, cfg.num_layers, cfg.d_model, 4
    act = B * S * d * f32
    xent = 3 * B * (S - 1) * f32
    norms = (2 * L * d + d) * f32
    assert sp["collectives"] == {
        "all-gather": (4 * L + 2) * act,
        "reduce-scatter": (2 * L + 2) * act / M,
        "all-reduce": xent + norms, "all-to-all": 0.0,
        "collective-permute": 0.0}
    assert rep["collectives"] == {
        "all-gather": 0.0, "reduce-scatter": 0.0,
        "all-reduce": xent + (2 * L + 2) * act, "all-to-all": 0.0,
        "collective-permute": 0.0}
    assert sp["flops"] == rep["flops"]
    assert sp["peak_live_bytes"] < rep["peak_live_bytes"]


def test_seq_parallel_applies_where_the_model_axis_splits_the_sequence():
    mesh = W.FakeMesh({"data": 1, "model": 4})
    rules = sharding.rules_for("2d", 2, mesh)
    assert rules["seq_shard"] == "model"
    assert not sharding.seq_parallel(16)            # outside a context
    with sharding.axis_rules(mesh, rules):
        assert sharding.seq_parallel(16)
        for S in (1, 15, 18):                       # M does not divide S
            assert not sharding.seq_parallel(S)
    with sharding.axis_rules(mesh, dict(rules, seq_shard=None)):
        assert not sharding.seq_parallel(16)
    with sharding.axis_rules(mesh, sharding.rules_for("dp_only", 4, mesh)):
        assert not sharding.seq_parallel(16)        # the batch on model
    with sharding.axis_rules(W.FakeMesh({"data": 4, "model": 1}),
                             sharding.rules_for("2d", 4, mesh)):
        assert not sharding.seq_parallel(16)
    with sharding.axis_rules(mesh, dict(rules, seq_shard="data")):
        with pytest.raises(NotImplementedError):
            sharding.seq_parallel(16)
