"""Port adaptive streaming (the windowed C_k graph) against the JAX package
on the reduced config with ``use_ck=True``.

* ``adaptive.windowed_ck`` against JAX's (atol=rtol=1e-6: the same
  float32 formula) and ``clip_windowed_ck`` (atol=rtol=1e-5: its window
  sums of projections are summed in another order);
* kernel 7's plain version (and its ``ops`` wrapper) against JAX
  ``windowed_similarity_pallas`` in interpret mode and
  ``windowed_ck(ring.sum(1))``, with every column live, with a column
  mask, and on all-zero rings (a fresh slot: uniform rows), within
  atol=rtol=1e-6;
* per-step stream logits of both port backends against JAX ``step_frame``
  (``backend="reference"``) for dense and pruned+quant plans, and the
  post-drain logits against clip mode, within atol=rtol=1e-3 (the JAX
  package's own C_k streaming bound, tests/test_streaming.py);
* θ/φ in the params, the plan and the bridge; the C_k rings through a
  snapshot and restore (exact) and through the state bridge; C_k changes
  the logits; a plan padded to a 50-joint slab streams the narrow plan's
  logits within atol=rtol=1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import adaptive as jadaptive
from repro.core.agcn import engine as jengine
from repro.core.agcn import model as jmodel
from repro.core.pruning.plan import build_prune_plan as jax_build_prune_plan
from repro.kernels import ops as jops
from repro.kernels.window_sim import windowed_similarity_pallas
from repro_torch.bridge import (params_from_numpy, stream_state_from_numpy,
                                stream_state_to_numpy)
from repro_torch.configs import get_config
from repro_torch.core.agcn import adaptive, engine, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.kernels import _build, ops
from repro_torch.kernels import window_sim as ws

CFG = dataclasses.replace(get_config("agcn-2s", reduced=True), use_ck=True)
JCFG = dataclasses.replace(jax_get_config("agcn-2s", reduced=True),
                           use_ck=True)
N = 2
TOL = dict(atol=1e-3, rtol=1e-3)
EXACT_TOL = dict(atol=1e-5, rtol=1e-5)
FN_TOL = dict(atol=1e-6, rtol=1e-6)
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
        (N, CFG.gcn_frames, 25, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def prune_plans(jparams):
    sw = [np.asarray(b["Wk"]) for b in jparams["blocks"]]
    return (build_prune_plan(sw, CFG.gcn_channels, FRACS, "cav-70-1",
                             input_skip=2),
            jax_build_prune_plan(sw, JCFG.gcn_channels, FRACS, "cav-70-1",
                                 input_skip=2))


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------- adaptive

@pytest.mark.parametrize("valid", [0, 20, 25])
def test_windowed_ck_matches_jax(valid):
    th, ph = _rand(0, 3, 25, 8), _rand(1, 3, 25, 8)
    want = np.asarray(jadaptive.windowed_ck(th, ph, valid_joints=valid))
    got = adaptive.windowed_ck(torch.from_numpy(th), torch.from_numpy(ph),
                               valid_joints=valid).numpy()
    np.testing.assert_allclose(got, want, **FN_TOL)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-6)
    if 0 < valid < 25:
        assert not got[..., valid:].any()


@pytest.mark.parametrize("k,valid", [(9, 0), (9, 21), (3, 0)])
def test_clip_windowed_ck_matches_jax(k, valid):
    x, wt, wp = _rand(2, 2, 12, 25, 6), _rand(3, 6, 4), _rand(4, 6, 4)
    want = np.asarray(jadaptive.clip_windowed_ck(x, wt, wp, k, valid))
    got = adaptive.clip_windowed_ck(*map(torch.from_numpy, (x, wt, wp)), k,
                                    valid).numpy()
    np.testing.assert_allclose(got, want, **EXACT_TOL)
    e = torch.from_numpy(x[..., :4])
    np.testing.assert_array_equal(
        adaptive._trailing_window_sum(e, k).numpy(),
        np.asarray(jadaptive._trailing_window_sum(x[..., :4], k)))


# ---------------------------------------------------------------- kernel 7

WS_CASES = [(1, 9, 25, 4, 0), (3, 9, 25, 16, 0), (3, 9, 50, 16, 25),
            (2, 9, 21, 32, 0), (8, 9, 50, 64, 46), (2, 3, 7, 4, 5)]


@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("S,K,V,Ce,valid", WS_CASES)
def test_windowed_similarity_plain_matches_jax(S, K, V, Ce, valid, zero):
    th = _rand(S, S, K, V, Ce) * (0 if zero else 0.3)
    ph = _rand(V, S, K, V, Ce) * (0 if zero else 0.3)
    live = valid if 0 < valid < V else V
    oracle = np.asarray(jadaptive.windowed_ck(th.sum(1), ph.sum(1),
                                              valid_joints=valid))
    pallas = np.asarray(jops.windowed_similarity(th, ph, valid_joints=valid))
    direct = np.asarray(windowed_similarity_pallas(
        jops._pad_to(jnp.asarray(th), 2, 8), jops._pad_to(jnp.asarray(ph), 2, 8),
        valid=live))[:, :V, :V]
    np.testing.assert_allclose(pallas, oracle, **FN_TOL)
    np.testing.assert_array_equal(direct, pallas)
    tth, tph = torch.from_numpy(th), torch.from_numpy(ph)
    _build.reset_launch_counts()
    for got in (ws.windowed_similarity_plain(tth, tph, live),
                ws.windowed_similarity_cuda(tth, tph, live),
                ops.windowed_similarity(tth, tph, valid_joints=valid),
                adaptive.windowed_ck(tth.sum(1), tph.sum(1), valid)):
        assert got.shape == (S, V, V)
        np.testing.assert_allclose(got.numpy(), oracle, **FN_TOL)
        np.testing.assert_allclose(got.numpy(), pallas, **FN_TOL)
    assert _build.LAUNCHES["windowed_similarity"] == 0   # CPU: plain version
    if zero:        # a fresh slot: every row uniform over the live columns
        want = np.zeros((S, V, V), np.float32)
        want[..., :live] = 1.0 / live
        np.testing.assert_allclose(got.numpy(), want, atol=1e-7)


def test_windowed_similarity_cuda_rejects_bad_valid():
    ring = torch.zeros(1, 9, 25, 4)
    for valid in (0, 26):
        with pytest.raises(ValueError, match="valid"):
            ws.windowed_similarity_cuda(ring, ring, valid)
    with pytest.raises(ValueError, match="do not match"):
        ws.windowed_similarity_cuda(ring, ring[:, :3], 25)


# ---------------------------------------------------------------- params, plan

def test_params_and_plan_carry_theta_phi(jparams, tparams, prune_plans):
    cin = CFG.gcn_in_channels
    for b, (tb, jb) in enumerate(zip(tparams["blocks"], jparams["blocks"])):
        ce = max(4, cin // 4)
        assert tb["theta"].shape == tb["phi"].shape == (cin, ce)
        np.testing.assert_array_equal(tb["theta"].numpy(),
                                      np.asarray(jb["theta"]))
        cin = CFG.gcn_channels[b]
    own = model.init_params(CFG, seed=0, device="cpu")
    assert [b["theta"].shape for b in own["blocks"]] == [
        b["theta"].shape for b in tparams["blocks"]]
    tpp, jpp = prune_plans
    for backend in ("reference", "cuda"):
        tp = engine.build_execution_plan(tparams, CFG, tpp, quant=True,
                                         backend=backend)
        jp = jengine.build_execution_plan(jparams, JCFG, jpp, quant=True)
        assert all(bs.use_ck and bs.sconv == "dense"
                   for bs in tp.static.blocks)
        for tb, jb in zip(tp.arrays["blocks"], jp.arrays["blocks"]):
            for k in ("theta", "phi", "G"):
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    # C_k blocks stay dense whatever sconv asks for, as in JAX
    csr = engine.build_execution_plan(tparams, CFG, sconv="csr")
    assert all(bs.sconv == "dense" for bs in csr.static.blocks)


# ---------------------------------------------------------------- streaming

def _frames(x, flush):
    T = x.shape[1]
    return [(x[:, r], True) if r < T else (np.zeros_like(x[:, 0]), False)
            for r in range(T + flush)]


def _stream_torch(plan, x, state=None):
    xt = torch.from_numpy(x)
    if state is None:
        state = engine.init_stream_state(plan, x.shape[0], x_calib=xt)
    out = []
    for frame, valid in _frames(x, engine.stream_flush_frames(plan,
                                                              x.shape[1])):
        state, logits = engine.step_frame(plan, state,
                                          torch.from_numpy(frame), valid)
        out.append(logits.numpy())
    return state, out


_JAX = {}


def _stream_jax(plan, x, key):
    if key not in _JAX:
        state = jengine.init_stream_state(plan, x.shape[0],
                                          x_calib=jnp.asarray(x))
        step = jax.jit(jengine.step_frame)
        out = []
        for frame, valid in _frames(x, jengine.stream_flush_frames(
                plan, x.shape[1])):
            state, logits = step(plan, state, jnp.asarray(frame),
                                 jnp.asarray(valid))
            out.append(np.asarray(logits))
        _JAX[key] = (out, np.asarray(jengine.execute(plan, jnp.asarray(x))))
    return _JAX[key]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("variant", ["dense", "pruned_quant"])
def test_ck_stream_matches_jax_every_step(jparams, tparams, x, prune_plans,
                                          variant, backend):
    pq = variant == "pruned_quant"
    tpp, jpp = prune_plans if pq else (None, None)
    tplan = engine.build_execution_plan(tparams, CFG, tpp, quant=pq,
                                        backend=backend)
    jplan = jengine.build_execution_plan(jparams, JCFG, jpp, quant=pq)
    want, jclip = _stream_jax(jplan, x, variant)
    _build.reset_launch_counts()
    state, got = _stream_torch(tplan, x)
    assert all(set(b) >= {"ck_th", "ck_ph"} for b in state.blocks)
    assert len(got) == len(want) == CFG.gcn_frames + 37
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {r}")
    clip = engine.execute(tplan, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(clip, jclip, **TOL)
    np.testing.assert_allclose(got[-1], clip, **TOL)
    assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0)


def test_ck_changes_logits(tparams, x):
    on = engine.execute(engine.build_execution_plan(tparams, CFG),
                        torch.from_numpy(x)).numpy()
    off_cfg = dataclasses.replace(CFG, use_ck=False)
    off = engine.execute(engine.build_execution_plan(tparams, off_cfg),
                         torch.from_numpy(x)).numpy()
    assert not np.allclose(on, off, atol=1e-3)


def test_ck_snapshot_restore_roundtrip(tparams, x):
    """The embedding rings are per-slot leaves: a mid-stream C_k slot
    snapshot, trampled, restored, resumes exactly as the uninterrupted
    stream (logits and rings bit for bit)."""
    plan = engine.build_execution_plan(tparams, CFG, backend="cuda")
    xt = torch.from_numpy(x)
    state = engine.init_stream_state(plan, N, x_calib=xt)
    for r in range(6):
        state, _ = engine.step_frame(plan, state, xt[:, r])
    snap = engine.snapshot_slots(state, 0)
    assert all("ck_th" in b for b in snap["blocks"])
    trampled = state
    for r in range(6, 10):
        trampled, _ = engine.step_frame(plan, trampled, xt[:, r] * 3.0)
    restored = engine.restore_slots(trampled, 0, snap)
    ref_state = state
    for r in range(6, 12):
        ref_state, want = engine.step_frame(plan, ref_state, xt[:, r])
        restored, got = engine.step_frame(plan, restored, xt[:, r])
    assert torch.equal(want[0], got[0])
    for rb, gb in zip(ref_state.blocks, restored.blocks):
        assert torch.equal(rb["ck_th"][0], gb["ck_th"][0])
        assert torch.equal(rb["ck_ph"][0], gb["ck_ph"][0])
    ring = engine.init_snapshot_ring(state, 2)
    assert all(b["ck_th"].shape[0] == 2 for b in ring["blocks"])
    # a reset clears the rings of the admitted slot only
    reset = engine.reset_slots(state, torch.tensor([True, False]))
    assert not reset.blocks[0]["ck_th"][0].any()
    assert torch.equal(reset.blocks[0]["ck_th"][1], state.blocks[0]["ck_th"][1])


def test_ck_state_bridge_continues_a_jax_stream(jparams, tparams, x):
    """A JAX C_k stream state taken mid-stream, moved to the port, goes on
    like the JAX stream (the rings travel with the state), and back."""
    jplan = jengine.build_execution_plan(jparams, JCFG)
    tplan = engine.build_execution_plan(tparams, CFG)
    jstate = jengine.init_stream_state(jplan, N, x_calib=jnp.asarray(x))
    step = jax.jit(jengine.step_frame)
    for r in range(20):
        jstate, _ = step(jplan, jstate, jnp.asarray(x[:, r]), jnp.asarray(True))
    tstate = stream_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    assert all(b["ck_th"].shape == (N, 9, 25, jb["ck_th"].shape[-1])
               for b, jb in zip(tstate.blocks, jstate.blocks))
    for r in range(20, 26):
        jstate, jl = step(jplan, jstate, jnp.asarray(x[:, r]),
                          jnp.asarray(True))
        tstate, tl = engine.step_frame(tplan, tstate, torch.from_numpy(
            x[:, r]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    back = stream_state_to_numpy(tstate)
    for b, jb in zip(back["blocks"], jstate.blocks):
        np.testing.assert_allclose(b["ck_th"], np.asarray(jb["ck_th"]),
                                   **TOL)


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_padded_ck_plan_streams_like_narrow_plan(tparams, x, backend):
    """C_k on a plan padded to a 50-joint slab: the padded columns are
    masked out of every row's softmax, so each step's logits equal the
    narrow plan's within 1e-5."""
    narrow = engine.build_execution_plan(tparams, CFG, backend=backend)
    padded = engine.build_execution_plan(tparams, CFG, backend=backend,
                                         pad_joints=50)
    assert padded.static.valid_joints == 25 and padded.static.joints == 50
    bn = engine.collect_bn_stats(narrow, torch.from_numpy(x))
    sn = engine.init_stream_state(narrow, N, bn_stats=bn)
    sp = engine.init_stream_state(padded, N, bn_stats=bn)
    assert sp.blocks[0]["ck_th"].shape[2] == 50
    for frame, valid in _frames(x, engine.stream_flush_frames(
            narrow, x.shape[1])):
        fp = np.zeros((N, 50, 3), np.float32)
        fp[:, :25] = frame
        sn, ln = engine.step_frame(narrow, sn, torch.from_numpy(frame), valid)
        sp, lp = engine.step_frame(padded, sp, torch.from_numpy(fp), valid)
        np.testing.assert_allclose(lp.numpy(), ln.numpy(), **EXACT_TOL)
    # the padded joints never enter a ring
    for b in sp.blocks:
        assert not b["ring_s"][:, :, 25:].any()
        assert not b["ck_th"][:, :, 25:].any()
