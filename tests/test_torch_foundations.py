"""Port foundations are bit-equal to the JAX package: skeleton graph,
cavity patterns, prune plans, Q8.8 weights, synthetic clips and the packed
cavity layout (exact equality, no tolerance)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import graph as jgraph
from repro.core.pruning import cavity as jcavity
from repro.core.pruning import plan as jplan
from repro.core.quant import quantize_q88 as jquant
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.core.agcn import graph as tgraph
from repro_torch.core.pruning import cavity as tcavity
from repro_torch.core.pruning import plan as tplan
from repro_torch.core.quant import quantize_q88
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import ops as tops


@pytest.mark.parametrize("reduced", [False, True])
def test_config_fields_match_jax(reduced):
    t, j = get_config("agcn_2s", reduced=reduced), jax_get_config(
        "agcn-2s", reduced=reduced)
    for f in dataclasses.fields(t):
        if f.name != "gcn_backend":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert t.serve_batch("clip") == j.serve_batch("clip") == 8
    assert t.serve_batch("clip", 3) == 3


def test_unported_config_and_topology_raise():
    """Every arch of the reference is ported: an unknown arch raises
    KeyError, as in JAX, naming the archs there are."""
    for fn in (get_config, jax_get_config):
        with pytest.raises(KeyError, match="unknown arch 'gemma4-12b'"):
            fn("gemma4-12b")
    assert get_config("gemma3_12b").name == "gemma3-12b"
    # every registry skeleton is ported; an unknown name raises as in JAX
    with pytest.raises(KeyError, match="unknown topology"):
        tgraph.get_topology("ntu26")
    with pytest.raises(KeyError, match="unknown topology"):
        jgraph.get_topology("ntu26")


def test_ntu25_adjacency_and_parents_equal():
    jt, tt = jgraph.get_topology("ntu25"), tgraph.get_topology("ntu25")
    assert tgraph.NTU_EDGES == jgraph.NTU_EDGES
    assert tt.adjacency.dtype == jt.adjacency.dtype == np.float32
    np.testing.assert_array_equal(tt.adjacency, jt.adjacency)
    np.testing.assert_array_equal(tt.parents, jt.parents)
    np.testing.assert_array_equal(
        tgraph.build_subsets(tgraph.NTU_EDGES, 21, 25, 3),
        jgraph.build_subsets(jgraph.NTU_EDGES, 21, 25, 3))
    np.testing.assert_array_equal(
        tgraph.parents_from_edges(tgraph.NTU_EDGES, 25),
        jgraph.parents_from_edges(jgraph.NTU_EDGES, 25))


@pytest.mark.parametrize("name", ["none", "cav-50-1", "cav-70-1", "cav-75-1",
                                  "cav-70-2", "cav-75-2"])
def test_cavity_pattern_equal(name):
    t, j = tcavity.cavity_pattern(name), jcavity.cavity_pattern(name)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(tcavity.tile_pattern(t, 38),
                                  jcavity.tile_pattern(j, 38))


def _assert_plans_equal(t, j):
    assert (t.cavity_name, t.input_skip) == (j.cavity_name, j.input_skip)
    assert len(t.blocks) == len(j.blocks)
    for tb, jb in zip(t.blocks, j.blocks):
        assert tb.kept_in == jb.kept_in
        assert tb.kept_filters == jb.kept_filters
        assert (tb._cin, tb._cout) == (jb._cin, jb._cout)
        np.testing.assert_array_equal(tb.tap_mask, jb.tap_mask)


def test_plan_from_config_equal():
    cfg_t, cfg_j = get_config("agcn-2s"), jax_get_config("agcn-2s")
    _assert_plans_equal(tplan.plan_from_config(cfg_t),
                        jplan.plan_from_config(cfg_j))
    assert tplan.plan_from_config(get_config("agcn-2s", reduced=True)) is None
    kept = [len(b.kept_in) for b in tplan.plan_from_config(cfg_t).blocks]
    assert kept == [3, 38, 38, 35, 32, 64, 58, 51, 90, 77]


@pytest.mark.parametrize("fracs", [[1.0, 0.5, 0.5, 0.5], [1.0, 0.3, 0.7, 0.9]])
def test_build_prune_plan_equal(fracs):
    rng = np.random.default_rng(3)
    channels = (8, 8, 16, 16)
    cins = (3, 8, 8, 16)
    sw = [rng.standard_normal((3, ci, co)).astype(np.float32)
          for ci, co in zip(cins, channels)]
    _assert_plans_equal(
        tplan.build_prune_plan(sw, channels, fracs, "cav-70-1", input_skip=2),
        jplan.build_prune_plan(sw, channels, fracs, "cav-70-1", input_skip=2))


def test_quantize_q88_bit_equal():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32) * 40,
        # exact half steps: both frameworks round half to even
        (np.arange(-64, 64, dtype=np.float32) + 0.5) / 256,
        np.array([200.0, -200.0, 127.99, -128.01], np.float32)])
    t = quantize_q88(torch.from_numpy(x)).numpy()
    j = np.asarray(jquant(x))
    assert t.dtype == j.dtype == np.float32
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("reduced,batch,seed", [(True, 4, 0), (False, 2, 7)])
def test_skeleton_batches_bit_equal(reduced, batch, seed):
    tcfg, jcfg = get_config("agcn-2s", reduced), jax_get_config("agcn-2s", reduced)
    tdc = tpipe.DataConfig(global_batch=batch, seq_len=tcfg.gcn_frames, seed=seed)
    jdc = jpipe.DataConfig(global_batch=batch, seq_len=jcfg.gcn_frames, seed=seed)
    ts, js = tpipe.skeleton_batches(tcfg, tdc), jpipe.skeleton_batches(jcfg, jdc)
    for _ in range(2):
        tb, jb = next(ts), next(js)
        for k in ("x", "labels"):
            assert tb[k].dtype == jb[k].dtype
            np.testing.assert_array_equal(tb[k], jb[k])


@pytest.mark.parametrize("F,C,pattern", [
    (16, 8, "cav-70-1"), (38, 16, "cav-70-1"), (77, 8, "cav-70-1"),
    (35, 4, "cav-50-1"), (13, 8, "none"), (90, 4, "cav-75-2")])
def test_pack_cavity_weights_bit_equal(F, C, pattern):
    rng = np.random.default_rng(F * C)
    mask = tcavity.tile_pattern(tcavity.cavity_pattern(pattern), F)
    w = rng.standard_normal((F, C, 9)).astype(np.float32) * mask[:, None, :]
    t = tops.pack_cavity_weights(w, mask)
    j = jops.pack_cavity_weights(w, mask)
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
