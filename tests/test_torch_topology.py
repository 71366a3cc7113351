"""Port variable topologies and the CSR spatial conv against the JAX
package on the reduced config.

* registry, CSR factorization, ELL packing and synthetic clips of all four
  skeletons byte-equal to JAX's, with csr_eps in {0, 1e-5};
* plan statics (per-block ``sconv``, ``joints``, ``valid_joints``) and
  the CSR/ELL/stem/parent plan arrays equal to JAX's, and the ``auto``
  selector's density crossover;
* ``engine.execute`` on the port's ``reference`` and ``cuda`` backends
  (the kernels' plain versions on the CPU) against JAX
  ``backend="reference"`` for topology × {dense, csr} × {dense,
  pruned+quant}, within atol=rtol=1e-3 (the JAX package's own CSR↔dense
  bound, tests/test_topology.py);
* a plan padded to a 50-joint slab against the narrow plan on the stream
  path, within atol=rtol=1e-5: not bit for bit, since the JAX twin of this
  check (test_padded_plan_streams_bit_exact_on_reference) misses bit-
  exactness by 4.77e-07 on the installed jax, a change of summation order;
* a two-skeleton slab (ntu25 padded to 50 beside ntu50) against each
  session run alone;
* the topology-named K-mismatch errors;
* kernel 6's plain version against JAX ``graph_sconv_csr_pallas`` in
  interpret mode and ``ref.graph_sconv_csr_ref`` (atol=rtol=1e-5: float32
  sums in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import engine as jengine
from repro.core.agcn import graph as jgraph
from repro.core.agcn import model as jmodel
from repro.core.pruning.plan import build_prune_plan as jax_build_prune_plan
from repro.data import pipeline as jpipe
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, graph, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import graph_sconv as gs
from repro_torch.kernels import ops, ref
from repro_torch.train.steps import make_gcn_slab_step

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)
TOPOLOGIES = ("ntu25", "ntu50", "hand21", "body_hand46")
TOL = dict(atol=1e-3, rtol=1e-3)
EXACT_TOL = dict(atol=1e-5, rtol=1e-5)
FRACS = [1.0, 0.5, 0.5, 0.5]


def _cfgs(name):
    V = graph.get_topology(name).num_joints
    return (dataclasses.replace(CFG, gcn_joints=V),
            dataclasses.replace(JCFG, gcn_joints=V))


_PARAMS = {}


def _params(name):
    """(JAX params, the port's copy on the CPU) at the skeleton's width."""
    if name not in _PARAMS:
        jp = jmodel.init_params(_cfgs(name)[1], jax.random.PRNGKey(0))
        _PARAMS[name] = (jp, params_from_numpy(
            jax.tree.map(np.asarray, jp), device="cpu"))
    return _PARAMS[name]


def _prune_plans(jp):
    sw = [np.asarray(b["Wk"]) for b in jp["blocks"]]
    return (build_prune_plan(sw, CFG.gcn_channels, FRACS, "cav-70-1",
                             input_skip=2),
            jax_build_prune_plan(sw, JCFG.gcn_channels, FRACS, "cav-70-1",
                                 input_skip=2))


def _x(V, seed=1, n=2):
    return np.random.default_rng(seed).standard_normal(
        (n, CFG.gcn_frames, V, 3)).astype(np.float32)


def _np(t):
    return None if t is None else np.asarray(t)


# ---------------------------------------------------------------- registry

def test_registry_names_and_unknown_topology():
    assert graph.topology_names() == jgraph.topology_names()
    assert set(TOPOLOGIES) <= set(graph.topology_names())
    with pytest.raises(KeyError, match="unknown topology"):
        graph.get_topology("ntu26")


@pytest.mark.parametrize("name", TOPOLOGIES)
def test_topology_bit_equal(name):
    tt, jt = graph.get_topology(name), jgraph.get_topology(name)
    assert (tt.name, tt.num_joints, tt.center, tt.edges, tt.num_subsets) == (
        jt.name, jt.num_joints, jt.center, jt.edges, jt.num_subsets)
    for f in ("parents", "adjacency", "indptr", "indices", "values", "valid"):
        a, b = getattr(tt, f), getattr(jt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert tt.density == jt.density and 0.0 < tt.density < 0.5
    np.testing.assert_array_equal(tt.padded_valid(60), jt.padded_valid(60))
    assert graph.graph_sparsity(tt.adjacency) == jgraph.graph_sparsity(
        jt.adjacency)
    np.testing.assert_array_equal(
        graph.csr_to_dense(tt.indptr, tt.indices, tt.values), tt.adjacency)


def test_ntu50_is_two_ntu25_persons_with_a_spine_link():
    tp25, tp50 = graph.get_topology("ntu25"), graph.get_topology("ntu50")
    assert tp50.num_joints == 50
    assert (25 + 21, 21) in tp50.edges
    moved = tp25.parents != np.arange(25)
    assert (tp50.parents[25:][moved] == tp25.parents[moved] + 25).all()


@pytest.mark.parametrize("eps", [0.0, 1e-5])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_csr_and_ell_packing_bit_equal(name, eps):
    """dense_to_csr of ``A + B_k`` (B_k at its 1e-6 init) and the ELL pack
    at the skeleton's own width, its 8-aligned width and a wider slab."""
    g = jgraph.get_topology(name).adjacency + np.float32(1e-6)
    got, want = graph.dense_to_csr(g, eps), jgraph.dense_to_csr(g, eps)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    V = g.shape[-1]
    E = got[1].shape[-1]
    assert (E == V * V) if eps == 0 else (E < V * V)
    for vp in (V, (V + 7) // 8 * 8, 64):
        for a, b in zip(ops.pack_csr_ell(*got, vp),
                        jops.pack_csr_ell(*want, vp)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("joints,persons", [(21, 1), (46, 1), (50, 1),
                                            (50, 2), (7, 1)])
def test_clips_bit_equal(joints, persons):
    assert tpipe._skeleton_edges(joints) == jpipe._skeleton_edges(joints)
    tcfg = dataclasses.replace(CFG, gcn_joints=joints, gcn_persons=persons)
    jcfg = dataclasses.replace(JCFG, gcn_joints=joints, gcn_persons=persons)
    tb = tpipe.skeleton_batches(tcfg, tpipe.DataConfig(3, 32, seed=4))
    jb = jpipe.skeleton_batches(jcfg, jpipe.DataConfig(3, 32, seed=4))
    for _ in range(2):
        t, j = next(tb), next(jb)
        assert t["x"].shape == (3 * persons, CFG.gcn_frames, joints, 3)
        np.testing.assert_array_equal(t["x"], j["x"])
        np.testing.assert_array_equal(t["labels"], j["labels"])


# ---------------------------------------------------------------- plans

PLAN_CASES = [("dense", 0.0), ("csr", 0.0), ("csr", 1e-5), ("auto", 0.0),
              ("auto", 1e-5)]


@pytest.mark.parametrize("pad", [None, 50])
@pytest.mark.parametrize("sconv,eps", PLAN_CASES)
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_plan_statics_and_arrays_match_jax(name, sconv, eps, pad):
    jp, tp = _params(name)
    tcfg, jcfg = _cfgs(name)
    kw = dict(topology=name, pad_joints=pad, sconv=sconv, csr_eps=eps)
    want = jengine.build_execution_plan(jp, jcfg, **kw)
    V = want.static.joints
    for backend in ("reference", "cuda"):
        got = engine.build_execution_plan(tp, tcfg, backend=backend, **kw)
        assert (got.static.topology, got.static.joints,
                got.static.valid_joints) == (want.static.topology, V,
                                             want.static.valid_joints)
        assert [b.sconv for b in got.static.blocks] == [
            b.sconv for b in want.static.blocks]
        assert not any(b.use_ck for b in got.static.blocks)
        for k in ("scale", "bias"):
            np.testing.assert_array_equal(got.arrays["data_bn"][k].numpy(),
                                          _np(want.arrays["data_bn"][k]))
        np.testing.assert_array_equal(got.arrays["parents"].numpy(),
                                      _np(want.arrays["parents"]))
        for tb, jb, bs in zip(got.arrays["blocks"], want.arrays["blocks"],
                              got.static.blocks):
            if bs.sconv == "dense":
                np.testing.assert_array_equal(tb["G"].numpy(), _np(jb["G"]))
                continue
            assert tb["G"] is None
            if backend == "reference":
                for k in ("csr_indptr", "csr_indices", "csr_values"):
                    assert tb[k].dtype == torch.int32 or k == "csr_values"
                    np.testing.assert_array_equal(tb[k].numpy(), _np(jb[k]))
            else:
                ei, ev = jops.pack_csr_ell(_np(jb["csr_indptr"]),
                                           _np(jb["csr_indices"]),
                                           _np(jb["csr_values"]), V)
                assert tb["ell_idx"].dtype == torch.int32
                np.testing.assert_array_equal(tb["ell_idx"].numpy(), ei)
                np.testing.assert_array_equal(tb["ell_val"].numpy(), ev)


def test_auto_selector_density_crossover():
    """``auto``: B_k at its 1e-6 init keeps every graph at density 1 with
    csr_eps = 0 (dense, as before), and a threshold above that noise
    floor flips the sparse-skeleton blocks to CSR, as in JAX."""
    for name in ("ntu25", "ntu50"):
        jp, tp = _params(name)
        tcfg, jcfg = _cfgs(name)
        legacy = engine.build_execution_plan(tp, tcfg, topology=name)
        assert all(b.sconv == "dense" for b in legacy.static.blocks)
        sparse = engine.build_execution_plan(tp, tcfg, topology=name,
                                             csr_eps=1e-5)
        jsparse = jengine.build_execution_plan(jp, jcfg, topology=name,
                                               csr_eps=1e-5)
        assert [b.sconv for b in sparse.static.blocks] == [
            b.sconv for b in jsparse.static.blocks] == ["csr"] * 4
        # a density threshold below the skeleton's own keeps it dense
        tight = engine.build_execution_plan(tp, tcfg, topology=name,
                                            csr_eps=1e-5, csr_density=0.01)
        assert all(b.sconv == "dense" for b in tight.static.blocks)


def test_topology_object_and_padding_errors():
    jp, tp = _params("hand21")
    tcfg, _ = _cfgs("hand21")
    topo = graph.get_topology("hand21")
    plan = engine.build_execution_plan(tp, tcfg, topology=topo)
    assert plan.static.topology == "hand21" and plan.static.joints == 21
    with pytest.raises(ValueError, match="narrower"):
        engine.build_execution_plan(tp, tcfg, topology=topo, pad_joints=20)
    with pytest.raises(ValueError, match="different topology"):
        engine.build_execution_plan(tp, tcfg, topology="ntu25")


# ---------------------------------------------------------------- clip mode

_JAX_LOGITS = {}


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("variant", ["dense", "pruned_quant"])
@pytest.mark.parametrize("sconv", ["dense", "csr"])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_execute_matches_jax_reference(name, sconv, variant, backend):
    jp, tp = _params(name)
    tcfg, jcfg = _cfgs(name)
    V = tcfg.gcn_joints
    quant = variant == "pruned_quant"
    tpp, jpp = _prune_plans(jp) if quant else (None, None)
    x = _x(V)
    key = (name, sconv, variant)
    if key not in _JAX_LOGITS:
        _JAX_LOGITS[key] = np.asarray(jengine.execute(
            jengine.build_execution_plan(jp, jcfg, jpp, quant=quant,
                                         topology=name, sconv=sconv),
            jnp.asarray(x)))
    plan = engine.build_execution_plan(tp, tcfg, tpp, quant=quant,
                                       backend=backend, topology=name,
                                       sconv=sconv)
    assert all(b.sconv == sconv for b in plan.static.blocks)
    got = engine.execute(plan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _JAX_LOGITS[key], **TOL)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_csr_with_sparsity_threshold_matches_dense(backend):
    """csr_eps = 1e-5 drops B_k's 1e-6 noise: the CSR plan runs the
    skeleton's own degree and still matches the dense path within 1e-3."""
    jp, tp = _params("ntu50")
    tcfg, _ = _cfgs("ntu50")
    dense = engine.build_execution_plan(tp, tcfg, topology="ntu50",
                                        sconv="dense", backend=backend)
    csr = engine.build_execution_plan(tp, tcfg, topology="ntu50",
                                      sconv="csr", csr_eps=1e-5,
                                      backend=backend)
    ba = csr.arrays["blocks"][0]
    if backend == "cuda":
        assert ba["ell_idx"].shape[-1] < 50        # D: the skeleton's degree
    else:
        assert ba["csr_indices"].shape[-1] < 50 * 50
    x = torch.from_numpy(_x(50, seed=2))
    np.testing.assert_allclose(engine.execute(csr, x).numpy(),
                               engine.execute(dense, x).numpy(), **TOL)


# ---------------------------------------------------------------- padded plans

def _stream_logits(plan, bn, clip, width):
    """Per-step logits of one sequence: the clip, zero-padded to
    ``width`` joints, then the drain."""
    T, V, C = clip.shape
    state = engine.init_stream_state(plan, 1, bn_stats=bn)
    out = []
    for r in range(T + engine.stream_flush_frames(plan, T)):
        f = torch.zeros((1, width, C))
        if r < T:
            f[0, :V] = torch.from_numpy(clip[r])
        state, logits = engine.step_frame(plan, state, f, r < T)
        out.append(logits.numpy())
    return out


_JAX_PADDED = {}


@pytest.mark.parametrize("sconv", ["dense", "csr"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("name", ["ntu25", "hand21"])
def test_padded_plan_streams_like_narrow_plan(name, backend, sconv):
    """A plan padded to a 50-joint slab streams the narrow plan's logits
    within 1e-5 at every step, and JAX's padded plan's within 1e-3."""
    jp, tp = _params(name)
    tcfg, jcfg = _cfgs(name)
    V = tcfg.gcn_joints
    kw = dict(topology=name, sconv=sconv, csr_eps=1e-5, backend=backend)
    narrow = engine.build_execution_plan(tp, tcfg, **kw)
    padded = engine.build_execution_plan(tp, tcfg, pad_joints=50, **kw)
    assert (padded.static.joints, padded.static.valid_joints) == (50, V)
    xc = torch.from_numpy(_x(V, seed=3))
    bn = engine.collect_bn_stats(narrow, xc)
    # the padded plan calibrates at the skeleton's own width, the same
    bn_p = engine.collect_bn_stats(padded, xc)
    for site, s in bn.items():
        torch.testing.assert_close(bn_p[site]["mean"], s["mean"])
    clip = _x(V, seed=4, n=1)[0]
    want = _stream_logits(narrow, bn, clip, V)
    got = _stream_logits(padded, bn, clip, 50)
    assert len(got) == len(want) == CFG.gcn_frames + 37
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **EXACT_TOL, err_msg=f"step {r}")
    key = (name, sconv)
    if key not in _JAX_PADDED:
        jkw = dict(topology=name, sconv=sconv, csr_eps=1e-5)
        jplan = jengine.build_execution_plan(jp, jcfg, pad_joints=50, **jkw)
        jn = jengine.build_execution_plan(jp, jcfg, **jkw)
        jbn = jengine.collect_bn_stats(jn, jnp.asarray(xc.numpy()))
        st = jengine.init_stream_state(jplan, 1, bn_stats=jbn)
        step = jax.jit(jengine.step_frame)
        outs = []
        for r in range(len(want)):
            f = np.zeros((1, 50, 3), np.float32)
            if r < clip.shape[0]:
                f[0, :V] = clip[r]
            st, lg = step(jplan, st, jnp.asarray(f),
                          jnp.asarray(r < clip.shape[0]))
            outs.append(np.asarray(lg))
        _JAX_PADDED[key] = outs
    for r, (g, w) in enumerate(zip(got, _JAX_PADDED[key])):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {r}")


# ---------------------------------------------------------------- mixed slab

def test_two_skeleton_slab_matches_dedicated_runs():
    """One 4-slot slab at Vmax = 50: two ntu25 sessions (plans padded to
    50) and two ntu50 sessions, admitted at different ticks, stepped as
    the JAX service steps its skeleton groups: one two-stream slab step
    per group with that group's BN statistics, the other slots held.
    Each session's eviction logits equal its run alone on a narrow plan."""
    step = make_gcn_slab_step(CFG)
    plans, stats, narrow, bn_narrow = {}, {}, {}, {}
    for name in ("ntu25", "ntu50"):
        tcfg, _ = _cfgs(name)
        gen = torch.Generator().manual_seed(0)
        params = [model.init_params(tcfg, gen, device="cpu")
                  for _ in range(2)]
        kw = dict(topology=name, sconv="csr", csr_eps=1e-5, backend="cuda")
        plans[name] = tuple(engine.build_execution_plan(
            p, tcfg, pad_joints=50, **kw) for p in params)
        narrow[name] = tuple(engine.build_execution_plan(p, tcfg, **kw)
                             for p in params)
        xc = torch.from_numpy(_x(tcfg.gcn_joints, seed=5))
        bn_narrow[name] = tuple(
            engine.collect_bn_stats(p, x) for p, x in zip(
                narrow[name], (xc, model.bone_stream_parents(
                    xc, narrow[name][1].arrays["parents"]))))
        stats[name] = tuple(engine._pad_data_bn_stats(s, p.static)
                            for s, p in zip(bn_narrow[name], plans[name]))
    rng = np.random.default_rng(6)
    # (skeleton, slot, admission tick, frames)
    sessions = [("ntu25", 0, 0, 12), ("ntu50", 1, 0, 10),
                ("ntu25", 2, 3, 9), ("ntu50", 3, 5, 11)]
    clips = [rng.standard_normal((n, graph.get_topology(t).num_joints, 3))
             .astype(np.float32) for t, _, _, n in sessions]
    flush = [engine.stream_flush_frames(narrow[t][0], n)
             for t, _, _, n in sessions]
    slabs = tuple(engine.init_session_slab(p, 4, bn_stats=s)
                  for p, s in zip(plans["ntu25"], stats["ntu25"]))
    got = {}
    for tick in range(max(t0 + n + f for (_, _, t0, n), f
                          in zip(sessions, flush))):
        frames = torch.zeros((4, 50, 3))
        valid, reset = np.zeros(4, bool), np.zeros(4, bool)
        live = np.zeros(4, bool)
        for i, (t, s, t0, n) in enumerate(sessions):
            r = tick - t0
            if 0 <= r < n + flush[i]:
                live[s] = True
                reset[s] = r == 0
                if r < n:
                    frames[s, : clips[i].shape[1]] = torch.from_numpy(
                        clips[i][r])
                    valid[s] = True
        logits = torch.zeros((4, CFG.gcn_num_classes))
        for name in ("ntu25", "ntu50"):
            m = np.array([sessions[s][0] == name for s in range(4)])
            slabs, lg = step(plans[name], slabs, frames,
                             torch.from_numpy(valid & m),
                             torch.from_numpy(reset & m),
                             torch.from_numpy(~(m & live)),
                             stats=stats[name])
            logits[m] = lg[m]
        for i, (t, s, t0, n) in enumerate(sessions):
            if tick - t0 == n + flush[i] - 1:
                got[i] = logits[s].numpy()
    assert sorted(got) == [0, 1, 2, 3]
    slab_step = make_gcn_slab_step(CFG)
    for i, (t, s, t0, n) in enumerate(sessions):
        V = clips[i].shape[1]
        alone = tuple(engine.init_session_slab(p, 1, bn_stats=b)
                      for p, b in zip(narrow[t], bn_narrow[t]))
        no = torch.zeros(1, dtype=torch.bool)
        for r in range(n + flush[i]):
            f = (torch.from_numpy(clips[i][r])[None] if r < n
                 else torch.zeros((1, V, 3)))
            alone, want = slab_step(narrow[t], alone, f,
                                    torch.tensor([r < n]), no)
        np.testing.assert_allclose(got[i], want[0].numpy(), **EXACT_TOL,
                                   err_msg=f"session {i} ({t})")


# ---------------------------------------------------------------- errors

def test_subset_mismatch_errors_name_the_topology():
    x = torch.zeros((1, 2, 25, 4))
    g = torch.zeros((2, 25, 25))               # K = 2
    w = torch.zeros((3, 4, 4))                 # K = 3
    with pytest.raises(ValueError, match="subsets.*'ntu25'"):
        ops.graph_sconv(x, g, w, topology="ntu25")
    idx = torch.zeros((2, 32, 1), dtype=torch.int32)
    val = torch.zeros((2, 32, 1))
    with pytest.raises(ValueError, match="subsets.*'ntu50'"):
        ops.graph_sconv_csr(x, idx, val, w, topology="ntu50")
    with pytest.raises(ValueError, match="packed to 20 joints"):
        ops.graph_sconv_csr(x, idx[:, :20], val[:, :20], w[:2])
    with pytest.raises(ValueError, match="expected >= 25"):
        ops.graph_sconv(x, g[:, :20, :20], w[:2])


def test_wider_graph_is_sliced_to_x():
    """A slab-padded graph on a clip at the skeleton's own width equals
    the narrow graph (the dense and the ELL wrappers)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 3, 21, 5)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 5, 6)).astype(np.float32))
    a = graph.get_topology("hand21").adjacency
    g = torch.zeros((3, 50, 50))
    g[:, :21, :21] = torch.from_numpy(a)
    torch.testing.assert_close(ops.graph_sconv(x, g, w),
                               ops.graph_sconv(x, torch.from_numpy(a), w))
    csr = graph.dense_to_csr(a)
    wide = [torch.from_numpy(t) for t in ops.pack_csr_ell(*csr, 50)]
    narrow = [torch.from_numpy(t) for t in ops.pack_csr_ell(*csr, 21)]
    torch.testing.assert_close(ops.graph_sconv_csr(x, *wide, w),
                               ops.graph_sconv_csr(x, *narrow, w))


# ---------------------------------------------------------------- kernel 6

@pytest.mark.parametrize("eps", [0.0, 1e-5])
@pytest.mark.parametrize("name", TOPOLOGIES)
def test_graph_sconv_csr_plain_matches_jax(name, eps):
    rng = np.random.default_rng(8)
    g = jgraph.get_topology(name).adjacency + np.float32(1e-6)
    V = g.shape[-1]
    R, Cin, Cout = 6, 5, 7
    x = rng.standard_normal((R, V, Cin)).astype(np.float32)
    w = (rng.standard_normal((3, Cin, Cout)) / np.sqrt(Cin)).astype(np.float32)
    indptr, indices, values = jgraph.dense_to_csr(g, eps)
    want = np.asarray(jref.graph_sconv_csr_ref(x, indptr, indices, values, w))
    vp8 = (V + 7) // 8 * 8
    pallas = np.asarray(jops.graph_sconv_csr(
        jnp.asarray(x)[None], *map(jnp.asarray, jops.pack_csr_ell(
            indptr, indices, values, vp8)), w))[0]
    np.testing.assert_allclose(pallas, want, **EXACT_TOL)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    idx, val = map(torch.from_numpy, ops.pack_csr_ell(indptr, indices,
                                                      values, V))
    assert idx.shape[-1] == (V if eps == 0 else idx.shape[-1])
    for got in (gs.graph_sconv_csr_plain(tx, idx, val, tw),
                gs.graph_sconv_csr_cuda(tx, idx, val, tw),
                ops.graph_sconv_csr(tx[None], idx, val, tw)[0],
                ref.graph_sconv_csr_ref(tx, *map(torch.from_numpy, (
                    indptr, indices, values)), tw)):
        np.testing.assert_allclose(got.numpy(), want, **EXACT_TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **EXACT_TOL)
    # against the dense product of the same (thresholded) graph
    dense = torch.from_numpy(jgraph.csr_to_dense(indptr, indices, values))
    np.testing.assert_allclose(gs.graph_sconv_plain(tx, dense, tw).numpy(),
                               want, **EXACT_TOL)
