"""Port engine (clip mode) against the JAX reference engine on the reduced
config: plan arrays bit-equal, logits of {dense, pruned, pruned+quant} ×
{reference, cuda+RFC, cuda without RFC} within atol=rtol=1e-3 (the JAX
engine's own reference↔pallas bound, tests/test_engine.py), BN statistics
within 1e-5.  On the CPU the ``cuda`` backend runs the kernels' plain
versions through the same ops-layer packing and layouts."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import engine as jengine
from repro.core.agcn import model as jmodel
from repro.core.pruning.plan import build_prune_plan as jax_build_prune_plan
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)
FRACS = [1.0, 0.5, 0.5, 0.5]


@pytest.fixture(scope="module")
def jparams():
    return jmodel.init_params(JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def tparams(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).standard_normal(
        (4, CFG.gcn_frames, 25, 3)).astype(np.float32)


def _plans(jparams):
    sw = [np.asarray(b["Wk"]) for b in jparams["blocks"]]
    return (build_prune_plan(sw, CFG.gcn_channels, FRACS, "cav-70-1",
                             input_skip=2),
            jax_build_prune_plan(sw, JCFG.gcn_channels, FRACS, "cav-70-1",
                                 input_skip=2))


VARIANTS = {"dense": (False, False), "pruned": (True, False),
            "pruned_quant": (True, True)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_plan_arrays_bit_equal(jparams, tparams, variant):
    pruned, quant = VARIANTS[variant]
    tpp, jpp = _plans(jparams) if pruned else (None, None)
    tp = engine.build_execution_plan(tparams, CFG, tpp, quant=quant)
    jp = jengine.build_execution_plan(jparams, JCFG, jpp, quant=quant)
    tc = engine.build_execution_plan(tparams, CFG, tpp, quant=quant,
                                     backend="cuda")
    jc = jengine.build_execution_plan(jparams, JCFG, jpp, quant=quant,
                                      backend="pallas")
    assert tp.static.input_skip == jp.static.input_skip
    assert tc.static.use_rfc and not tp.static.use_rfc
    for tb, jb, tcb, jcb in zip(tp.arrays["blocks"], jp.arrays["blocks"],
                                tc.arrays["blocks"], jc.arrays["blocks"]):
        for k in ("G", "Wk", "tw", "tb", "kept_in", "kept_filters"):
            if jb[k] is None:
                assert tb[k] is None, k
                continue
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                          err_msg=k)
        for k in ("wp", "taps", "inv_perm"):
            np.testing.assert_array_equal(tcb[k].numpy(), np.asarray(jcb[k]),
                                          err_msg=k)
        np.testing.assert_array_equal(tcb["G"].numpy(), np.asarray(jb["G"]))
    np.testing.assert_array_equal(tp.arrays["parents"].numpy(),
                                  np.asarray(jp.arrays["parents"]))


BACKEND_CELLS = {"reference": ("reference", None), "cuda-rfc": ("cuda", True),
                 "cuda-norfc": ("cuda", False)}


@pytest.mark.parametrize("cell", list(BACKEND_CELLS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_execute_matches_jax_reference(jparams, tparams, x, variant, cell):
    pruned, quant = VARIANTS[variant]
    backend, rfc = BACKEND_CELLS[cell]
    tpp, jpp = _plans(jparams) if pruned else (None, None)
    want = jengine.execute(jengine.build_execution_plan(
        jparams, JCFG, jpp, quant=quant, backend="reference"), jnp.asarray(x))
    plan = engine.build_execution_plan(tparams, CFG, tpp, quant=quant,
                                       backend=backend, use_rfc=rfc)
    got = engine.execute(plan, torch.from_numpy(x))
    assert got.shape == (4, CFG.gcn_num_classes)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_collect_bn_stats_matches_jax(jparams, tparams, x, backend):
    tpp, jpp = _plans(jparams)
    want = jengine.collect_bn_stats(jengine.build_execution_plan(
        jparams, JCFG, jpp, quant=True), jnp.asarray(x))
    got = engine.collect_bn_stats(engine.build_execution_plan(
        tparams, CFG, tpp, quant=True, backend=backend), torch.from_numpy(x))
    assert sorted(got) == sorted(want)
    for site, s in want.items():
        for k in ("mean", "inv"):
            np.testing.assert_allclose(got[site][k].numpy(), np.asarray(s[k]),
                                       atol=1e-5, rtol=1e-5, err_msg=site)


def test_block_outputs_and_forward(jparams, tparams, x):
    tpp, jpp = _plans(jparams)
    tplan = engine.build_execution_plan(tparams, CFG, tpp, backend="cuda")
    outs = engine.block_outputs(tplan, torch.from_numpy(x))
    want = jengine.block_outputs(jengine.build_execution_plan(
        jparams, JCFG, jpp), jnp.asarray(x))
    assert [o.shape for o in outs] == [w.shape for w in want]
    for o, w in zip(outs, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=1e-3,
                                   rtol=1e-3)
    np.testing.assert_allclose(
        model.forward(tparams, torch.from_numpy(x), CFG, tpp, quant=True,
                      backend="cuda").numpy(),
        np.asarray(jmodel.forward(jparams, jnp.asarray(x), JCFG, jpp,
                                  quant=True, backend="reference")),
        atol=1e-3, rtol=1e-3)


def test_unported_plan_options_raise(tparams):
    """The CSR path is ported: ``sconv="csr"`` builds, and ``auto`` picks
    CSR on a sparse graph.  What still raises: an unknown backend or sconv
    mode, and a slab narrower than the skeleton."""
    csr = engine.build_execution_plan(tparams, CFG, sconv="csr")
    assert all(b.sconv == "csr" for b in csr.static.blocks)
    sparse = {**tparams, "blocks": [dict(b, Bk=torch.zeros_like(b["Bk"]))
                                    for b in tparams["blocks"]]}
    auto = engine.build_execution_plan(sparse, CFG)
    assert all(b.sconv == "csr" for b in auto.static.blocks)
    dense = engine.build_execution_plan(sparse, CFG, sconv="dense")
    assert all(b.sconv == "dense" for b in dense.static.blocks)
    with pytest.raises(ValueError, match="unknown backend"):
        engine.build_execution_plan(tparams, CFG, backend="pallas")
    with pytest.raises(ValueError, match="unknown sconv"):
        engine.build_execution_plan(tparams, CFG, sconv="ell")
    with pytest.raises(ValueError, match="narrower"):
        engine.build_execution_plan(tparams, CFG, pad_joints=24)
