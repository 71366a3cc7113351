"""The port's paper accounting against the JAX package on the CPU: the plain
RFC codec bit-equal to JAX's, C3's storage cost and Table III categories
equal whether counted from JAX's float mask, the port's bool mask or the
port's packed int16 bits; the E(D) scheduling model, the pruning summary,
Drop schemes, unstructured baseline and cavity balance equal to JAX's
number for number; per-block feature sparsity within 1e-3 (a ReLU zero can
flip by rounding between the two engines)."""
import dataclasses
import importlib
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import model as jmodel
from repro.core.pruning import cavity as jcavity
from repro.core.pruning import plan as jplan
from repro.core.rfc import format as jfmt
from repro.core.sched import expectation as jexp
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning import cavity as tcavity
from repro_torch.core.pruning import plan as tplan
from repro_torch.core.rfc import format as tfmt
from repro_torch.core.sched import expectation as texp
from repro_torch.kernels.rfc_pack import bits_from_hot, rfc_encode_plain

ROOT = Path(__file__).resolve().parents[1]


def _activations(seed, rows, banks, bank, sparsity):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, banks * bank)).astype(np.float32)
    x[rng.random(x.shape) < sparsity] = -1.0       # ReLU zeroes these
    return x


GRID = [(bank, rows, banks, sp) for bank in (4, 8, 16, 32)
        for rows, banks in ((1, 1), (5, 3), (16, 4))
        for sp in (0.0, 0.5, 0.9, 1.0)]


@pytest.mark.parametrize("bank", [4, 8, 16, 32])
def test_rfc_codec_bit_equal_to_jax(bank):
    for i, (b, rows, banks, sp) in enumerate(GRID):
        if b != bank:
            continue
        x = _activations(i, rows, banks, bank, sp)
        jv, jh = jfmt.rfc_encode(jnp.asarray(x), bank=bank)
        tv, th = tfmt.rfc_encode(torch.from_numpy(x), bank=bank)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        back = tfmt.rfc_decode(tv, th, bank=bank)
        np.testing.assert_array_equal(
            back.numpy(), np.asarray(jfmt.rfc_decode(jv, jh, bank=bank)))
        np.testing.assert_array_equal(back.numpy(), np.maximum(x, 0))
        np.testing.assert_array_equal(
            tfmt.mbhot(th).numpy(), np.asarray(jfmt.mbhot(jh)))


def test_rfc_encode_without_relu_and_bad_width():
    x = np.abs(_activations(3, 4, 2, 16, 0.6))
    x[x > 1.0] = 0.0
    jv, jh = jfmt.rfc_encode(jnp.asarray(x), apply_relu=False)
    tv, th = tfmt.rfc_encode(torch.from_numpy(x), apply_relu=False)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    with pytest.raises(ValueError, match="not divisible"):
        tfmt.rfc_encode(torch.zeros(2, 20))


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.65, 0.9, 1.0])
def test_storage_cost_same_from_mask_and_bits(sparsity):
    """JAX's float/bool mask, the port's mask and the port's packed bits
    of the same activations give identical storage numbers and Table III
    categories."""
    x = _activations(int(sparsity * 100), 64, 8, 16, sparsity)
    _, jh = jfmt.rfc_encode(jnp.asarray(x))
    want = jfmt.storage_cost(np.asarray(jh) > 0)
    cats = jfmt.expected_sparsity_categories(np.asarray(jh))
    _, th = tfmt.rfc_encode(torch.from_numpy(x))
    _, bits = rfc_encode_plain(torch.from_numpy(x))
    assert bits.dtype == torch.int16
    for hot in (np.asarray(jh), np.asarray(jh).astype(np.float32), th, bits,
                bits.numpy()):
        assert tfmt.storage_cost(hot) == want
        assert tfmt.expected_sparsity_categories(hot) == cats
    for mb, eb in ((2, 8), (4, 32)):
        assert tfmt.storage_cost(bits, minibank=mb, elem_bits=eb) == \
            jfmt.storage_cost(np.asarray(jh) > 0, minibank=mb, elem_bits=eb)
    with pytest.raises(ValueError, match="banks of 16"):
        tfmt.storage_cost(bits, bank=8)


def test_storage_cost_paper_scenario_equal():
    """Paper §V-C: a uniform mix of the four quartiles saves ~37.5%."""
    rng = np.random.default_rng(0)
    rows = []
    for lo in (0.0, 0.25, 0.5, 0.75):
        for _ in range(256):
            row = np.zeros(16, bool)
            row[rng.choice(16, int(16 * (1 - (lo + 0.125))),
                           replace=False)] = True
            rows.append(row)
    hot = np.stack(rows)
    c = tfmt.storage_cost(bits_from_hot(torch.from_numpy(hot)))
    assert c == jfmt.storage_cost(hot)
    assert 0.25 < c["rfc_vs_dense_reduction"] < 0.50


@pytest.mark.parametrize("quartiles", [(0.25, 0.25, 0.25, 0.25),
                                       (0.1, 0.4, 0.4, 0.1), (1, 0, 0, 0),
                                       (0.05, 0.15, 0.3, 0.5)])
def test_minibank_depths_equal(quartiles):
    for depth in (16, 64, 100):
        d = tfmt.minibank_depths(quartiles, depth)
        assert d == jfmt.minibank_depths(quartiles, depth)
        assert all(d[i] >= d[i + 1] for i in range(3))


@pytest.mark.parametrize("w", [1, 4, 6, 12])
def test_expectation_model_equal(w):
    for s in (0.0, 0.2, 0.35, 0.5, 0.65, 0.8, 1.0):
        np.testing.assert_array_equal(texp.valid_work_pmf(w, s),
                                      jexp.valid_work_pmf(w, s))
        assert texp.expected_valid(w, s) == jexp.expected_valid(w, s)
        assert texp.dsp_allocation(w, s) == jexp.dsp_allocation(w, s)
        for d in range(w + 1):
            assert texp.delay_probability(w, s, d) == \
                jexp.delay_probability(w, s, d)
        assert texp.scheduling_report(w, s) == jexp.scheduling_report(w, s)
    rep = texp.scheduling_report(6, 0.5)        # paper Table II ballpark
    assert rep["dsp_saving"] >= 0.2 and rep["delay_prob"] <= 0.15


def _weights(channels, seed=0):
    rng = np.random.default_rng(seed)
    cin, sw = 3, []
    for cout in channels:
        sw.append(rng.standard_normal((3, cin, cout)).astype(np.float32))
        cin = cout
    return sw


PAPER_CHANNELS = (64, 64, 64, 64, 128, 128, 128, 256, 256, 256)


@pytest.mark.parametrize("cavity", ["none", "cav-50-1", "cav-70-1",
                                    "cav-75-1", "cav-70-2"])
def test_prune_summary_equal(cavity):
    sw = _weights(PAPER_CHANNELS)
    for keeps in ([1.0] + [0.5] * 9, [1.0] + [0.3] * 9,
                  [1.0, 0.6, 0.6, 0.55, 0.5, 0.5, 0.45, 0.4, 0.35, 0.3]):
        t = tplan.build_prune_plan(sw, PAPER_CHANNELS, keeps, cavity)
        j = jplan.build_prune_plan(sw, PAPER_CHANNELS, keeps, cavity)
        for args in ((PAPER_CHANNELS, 3), (PAPER_CHANNELS, 3, 2, 9, 50)):
            assert t.summary(*args) == j.summary(*args)


def test_paper_compression_band():
    """Paper: 3.0×–8.4× compression; ~73% graph skipping at heavy drops."""
    sw = _weights(PAPER_CHANNELS)
    light = tplan.build_prune_plan(sw, PAPER_CHANNELS, [1.0] + [0.5] * 9,
                                   "cav-50-1").summary(PAPER_CHANNELS, 3)
    heavy = tplan.build_prune_plan(sw, PAPER_CHANNELS, [1.0] + [0.3] * 9,
                                   "cav-75-1").summary(PAPER_CHANNELS, 3)
    assert 2.4 < light["compression_ratio"] < 4.5
    assert 5.0 < heavy["compression_ratio"] < 9.0
    assert 0.6 < heavy["graph_skip_efficiency"] < 0.78


def test_drop_scheme_and_unstructured_equal():
    for sp in ([0.3, 0.5, 0.7], [0.0, 0.99, 0.5, 0.12]):
        for shift in (0.0, 0.1, 0.25):
            assert tplan.drop_scheme(sp, shift) == jplan.drop_scheme(sp, shift)
    rng = np.random.default_rng(0)
    for shape in ((64, 64), (3, 16, 32), (8, 8, 9)):
        w = rng.standard_normal(shape).astype(np.float32)
        for frac in (0.0, 0.3, 0.7, 0.95):
            out = tplan.unstructured_prune(w, frac)
            np.testing.assert_array_equal(out, jplan.unstructured_prune(w, frac))
    assert abs((tplan.unstructured_prune(w, 0.7) == 0).mean() - 0.7) < 0.02


@pytest.mark.parametrize("name", ["none", "cav-50-1", "cav-67-1", "cav-70-1",
                                  "cav-70-2", "cav-75-1", "cav-75-2"])
def test_cavity_report_and_balance_equal(name):
    assert tplan.cavity_report(name) == jplan.cavity_report(name)
    m = tcavity.cavity_pattern(name)
    assert tcavity.balance_stats(m) == jcavity.balance_stats(m)
    if name.endswith("-1"):
        assert tcavity.balance_stats(m)["balanced"]


def test_bench_compression_table_and_chip_smoke_pin_equal_jax():
    """The port's bench table equals JAX's ``pruning_bench`` table, and the
    copy ``chip_smoke.py`` holds the card's run to equals both."""
    sys.path.insert(0, str(ROOT))
    try:
        jbench = importlib.import_module("benchmarks.pruning_bench")
        tbench = importlib.import_module("benchmarks.torch_paper")
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        sys.path.remove(str(ROOT))
    want = [(s, c, d) for s, c, d in jbench.compression_table()]
    got = tbench.compression_table()
    assert got == want
    assert chip_smoke.COMPRESSION_TABLE == {
        f"{s}/{c}": (d["compression_ratio"], d["graph_skip_efficiency"])
        for s, c, d in want}
    assert tbench.cavity_balance_table() == {
        n: jcavity.balance_stats(jcavity.cavity_pattern(n))
        for n in tbench.BALANCE_CAVITIES}


CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)
# the reduced widths rounded up to whole RFC banks, for the bits' count
CFG16 = dataclasses.replace(CFG, gcn_channels=(16, 16, 32, 32))
JCFG16 = dataclasses.replace(JCFG, gcn_channels=(16, 16, 32, 32))


def _pair(cfg, jcfg, seed=0):
    jp = jmodel.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def clips():
    from repro.data.pipeline import DataConfig, skeleton_batches
    return next(skeleton_batches(JCFG, DataConfig(global_batch=8,
                                                  seq_len=0)))["x"]


@pytest.mark.parametrize("pruned", [False, True])
def test_feature_sparsity_per_block_within_1e3(clips, pruned):
    jp, tp = _pair(CFG, JCFG)
    plan = jplan.plan_from_config(dataclasses.replace(
        JCFG, prune_channel_fracs=(1.0, 0.5, 0.5, 0.5))) if pruned else None
    tpl = tplan.plan_from_config(dataclasses.replace(
        CFG, prune_channel_fracs=(1.0, 0.5, 0.5, 0.5))) if pruned else None
    want = jmodel.feature_sparsity_per_block(jp, jnp.asarray(clips), JCFG,
                                             plan)
    got = model.feature_sparsity_per_block(tp, torch.from_numpy(clips), CFG,
                                           tpl)
    assert len(got) == len(CFG.gcn_channels)
    assert all(0.0 <= v <= 1.0 for v in got) and any(v > 0.1 for v in got)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_storage_from_cuda_plan_bits_matches_reference_mask(clips):
    """C3's cost counted on the bits the ``cuda`` backend's clip path
    writes between blocks (plain versions on the CPU) against the JAX
    reference engine's block outputs' mask: within 1e-3 (a ReLU zero can
    flip by rounding), at the reduced depth with whole-bank widths."""
    from repro.core.agcn import engine as jengine
    jp, tp = _pair(CFG16, JCFG16)
    jep = jengine.build_execution_plan(jp, JCFG16, None, backend="reference")
    jouts = jengine.block_outputs(jep, jnp.asarray(clips))
    plan = engine.build_execution_plan(tp, CFG16, None, backend="cuda")
    leaves = engine.rfc_boundaries(plan, torch.from_numpy(clips))
    assert len(leaves) == len(CFG16.gcn_channels) - 1
    for (vals, bits), h in zip(leaves, jouts):
        h = np.asarray(h)
        hot = (h > 0).reshape(*h.shape[:-1], -1, 16)
        want = jfmt.storage_cost(hot)
        got = tfmt.storage_cost(bits)
        for k in ("rfc_vs_dense_reduction", "csc_vs_dense_reduction",
                  "sparsity"):
            assert abs(got[k] - want[k]) <= 1e-3, k
        np.testing.assert_allclose(tfmt.expected_sparsity_categories(bits),
                                   jfmt.expected_sparsity_categories(hot),
                                   atol=1e-3)
        assert bits.shape == vals.shape[:-1] + (vals.shape[-1] // 16,)
    with pytest.raises(ValueError, match="cuda plan"):
        engine.rfc_boundaries(engine.build_execution_plan(tp, CFG16, None),
                              torch.from_numpy(clips))
