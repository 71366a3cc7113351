"""Port serving path on the CPU: the two-stream inference step against the
JAX one (atol=rtol=1e-3, the engine parity bound), the params bridge, and
the ``serve clip`` and ``serve stream`` CLIs end to end at the reduced
config."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import engine as jengine
from repro.core.agcn import model as jmodel
from repro.core.pruning.plan import build_prune_plan as jax_build_prune_plan
from repro.train.steps import make_gcn_infer_step as jax_infer_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.launch import serve
from repro_torch.train.steps import make_gcn_infer_step

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)


@pytest.fixture(scope="module")
def jparams():
    kj, kb = jax.random.split(jax.random.PRNGKey(5))
    return [jmodel.init_params(JCFG, k) for k in (kj, kb)]


def test_bridge_keeps_every_leaf(jparams):
    tree = jax.tree.map(np.asarray, jparams[0])
    tp = params_from_numpy(tree, device="cpu")
    leaves, treedef = jax.tree.flatten(tree)
    tleaves, ttreedef = jax.tree.flatten(
        jax.tree.map(lambda t: t.numpy(), tp))
    assert ttreedef == treedef and len(tleaves) == len(leaves)
    for a, b in zip(tleaves, leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # shapes of the port's own init match the JAX ones leaf for leaf
    own = jax.tree.map(lambda t: tuple(t.shape),
                       model.init_params(CFG, seed=1, device="cpu"))
    assert own == jax.tree.map(lambda a: a.shape, tree)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_two_stream_step_matches_jax(jparams, backend):
    sw = [np.asarray(b["Wk"]) for b in jparams[0]["blocks"]]
    fracs = [1.0, 0.5, 0.5, 0.5]
    jpp = jax_build_prune_plan(sw, JCFG.gcn_channels, fracs, input_skip=2)
    tpp = build_prune_plan(sw, CFG.gcn_channels, fracs, input_skip=2)
    x = np.random.default_rng(2).standard_normal(
        (3, CFG.gcn_frames, 25, 3)).astype(np.float32)
    jplans = tuple(jengine.build_execution_plan(p, JCFG, jpp, quant=True)
                   for p in jparams)
    want = jax.jit(jax_infer_step(JCFG))(jplans, jnp.asarray(x))
    tplans = tuple(engine.build_execution_plan(
        params_from_numpy(jax.tree.map(np.asarray, p), "cpu"), CFG, tpp,
        quant=True, backend=backend) for p in jparams)
    got = make_gcn_infer_step(CFG)(tplans, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-3, rtol=1e-3)
    # the bone stream of the step is the fixed NTU-25 one
    xt = torch.from_numpy(x)
    torch.testing.assert_close(
        model.bone_stream_parents(xt, tplans[1].arrays["parents"]),
        model.bone_stream(xt), atol=0, rtol=0)
    np.testing.assert_array_equal(model.bone_stream(xt).numpy(),
                                  np.asarray(jmodel.bone_stream(jnp.asarray(x))))


def test_serve_clip_cli_runs_on_cpu(capsys):
    serve.main(["clip", "--arch", "agcn-2s", "--reduced", "--device", "cpu",
                "--clips", "8", "--backend", "both"])
    out = capsys.readouterr().out
    assert out.count("clips/s") == 2
    assert "backend=cuda" in out and "backend=reference" in out
    assert "backend top-1 agreement: 100.0%" in out


def test_serve_gcn_backends_agree():
    res = serve.serve_gcn("agcn-2s", reduced=True, batch=4, clips=8,
                          backends=("cuda", "reference"), device="cpu")
    assert res["cuda"]["steps"] == 3
    a, b = res["cuda"]["logits"], res["reference"]["logits"]
    assert a.shape == (8, CFG.gcn_num_classes) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b, atol=1e-3, rtol=1e-3)


def test_serve_stream_cli_runs_on_cpu(capsys):
    serve.main(["stream", "--arch", "agcn-2s", "--reduced", "--device",
                "cpu", "--batch", "2", "--backend", "both"])
    out = capsys.readouterr().out
    assert out.count("frames/s") == 2
    assert out.count("clip-engine top-1 agreement 100.0%") == 2
    assert "backend top-1 agreement: 100.0%" in out


def test_serve_gcn_stream_drains_to_clip_logits():
    """Post-drain stream logits equal the clip engine's on the same plans,
    both backends agree, and CPU tensors launch no kernel."""
    res = serve.serve_gcn_stream("agcn-2s", reduced=True, batch=2,
                                 backends=("cuda", "reference"), device="cpu")
    for r in res.values():
        assert r["flush"] == 37 and r["steps"] == CFG.gcn_frames + 37 + 2
        assert r["logits"].shape == (2, CFG.gcn_num_classes)
        np.testing.assert_allclose(r["logits"], r["clip_logits"],
                                   atol=1e-3, rtol=1e-3)
        assert r["clip_agreement"] == 1.0
        assert r["frames_per_s"] > 0 and r["latency_ms_p50"] > 0
        for phase in ("calibration", "stream", "clip"):
            assert not any(r["launches"][phase].values())
    np.testing.assert_allclose(res["cuda"]["logits"],
                               res["reference"]["logits"], atol=1e-3,
                               rtol=1e-3)
