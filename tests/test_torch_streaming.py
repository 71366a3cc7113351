"""Port streaming against the JAX reference engine on the reduced config:
per-frame logits of ``step_frame`` on both backends (the ``cuda`` backend
takes the kernels' plain versions on the CPU) equal JAX ``step_frame`` on
``backend="reference"`` at every step, and post-drain stream logits equal
clip logits, for {dense, pruned, pruned+quant}, within atol=rtol=1e-3 (the
JAX package's own streaming-parity bound, tests/test_streaming.py).  Also
the two-stream step, the odd-stride-length drain, the emission count, the
sliding-window pool, the RFC carry, the calibration precondition and the
drain arithmetic.  Mirrors tests/test_streaming.py; its C_k cells are in
test_torch_adaptive.py."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import engine as jengine
from repro.core.agcn import model as jmodel
from repro.core.pruning.plan import build_prune_plan as jax_build_prune_plan
from repro.train.steps import make_gcn_stream_step as jax_stream_step
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.kernels import ops
from repro_torch.kernels import rfc_pack as rp
from repro_torch.train.steps import make_gcn_infer_step, make_gcn_stream_step

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)
N = 2
TOL = dict(atol=1e-3, rtol=1e-3)
VARIANTS = {"dense": (False, False), "pruned": (True, False),
            "pruned_quant": (True, True)}


@pytest.fixture(scope="module")
def jparams():
    return [jmodel.init_params(JCFG, k)
            for k in jax.random.split(jax.random.PRNGKey(0))]


@pytest.fixture(scope="module")
def tparams(jparams):
    return [params_from_numpy(jax.tree.map(np.asarray, p), device="cpu")
            for p in jparams]


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(1).standard_normal(
        (N, CFG.gcn_frames, 25, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def prune_plans(jparams):
    sw = [np.asarray(b["Wk"]) for b in jparams[0]["blocks"]]
    fracs = [1.0, 0.5, 0.5, 0.5]
    return (build_prune_plan(sw, CFG.gcn_channels, fracs, "cav-70-1",
                             input_skip=2),
            jax_build_prune_plan(sw, JCFG.gcn_channels, fracs, "cav-70-1",
                                 input_skip=2))


def _plans(jp, tp, prune_plans, variant, backend, cfg=CFG, jcfg=JCFG):
    pruned, quant = VARIANTS[variant]
    tpp, jpp = prune_plans if pruned else (None, None)
    return (engine.build_execution_plan(tp, cfg, tpp, quant=quant,
                                        backend=backend),
            jengine.build_execution_plan(jp, jcfg, jpp, quant=quant,
                                         backend="reference"))


def _frames(x, flush):
    """The stream's raw frames: the clip, then ``flush`` zero frames."""
    T = x.shape[1]
    return [(x[:, r], True) if r < T else (np.zeros_like(x[:, 0]), False)
            for r in range(T + flush)]


def _stream_torch(plan, x, state=None):
    """Port: feed a clip frame by frame plus the drain; per-step logits."""
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


_JAX_CACHE = {}


def _stream_jax(plan, x, key):
    """JAX reference: the same stream, per-step logits (cached by key)."""
    if key not in _JAX_CACHE:
        state = jengine.init_stream_state(plan, x.shape[0],
                                          x_calib=jnp.asarray(x))
        step = jax.jit(jengine.step_frame)
        out = []
        for frame, valid in _frames(
                x, jengine.stream_flush_frames(plan, x.shape[1])):
            state, logits = step(plan, state, jnp.asarray(frame),
                                 jnp.asarray(valid))
            out.append(np.asarray(logits))
        _JAX_CACHE[key] = out
    return _JAX_CACHE[key]


# ------------------------------------------------------------------- parity

@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_step_frame_matches_jax_every_step(jparams, tparams, x, prune_plans,
                                           variant, backend):
    tplan, jplan = _plans(jparams[0], tparams[0], prune_plans, variant,
                          backend)
    want = _stream_jax(jplan, x, variant)
    state, got = _stream_torch(tplan, x)
    assert len(got) == len(want) == CFG.gcn_frames + 37
    for r, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, **TOL, err_msg=f"step {r}")
    # post-drain stream logits equal the clip engine's (port and JAX)
    np.testing.assert_allclose(
        got[-1], engine.execute(tplan, torch.from_numpy(x)).numpy(), **TOL)
    np.testing.assert_allclose(
        got[-1], np.asarray(jengine.execute(jplan, jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_stream_step_matches_clip_ensemble(jparams, tparams, x,
                                               prune_plans, variant):
    """make_gcn_stream_step (joint + bone, the served ``cuda`` backend)
    drains to the clip ensemble step's logits, and its last step equals
    the JAX two-stream step's."""
    pairs = [_plans(jp, tp, prune_plans, variant, "cuda")
             for jp, tp in zip(jparams, tparams)]
    tplans = tuple(p[0] for p in pairs)
    jplans = tuple(p[1] for p in pairs)
    xt = torch.from_numpy(x)
    states = (engine.init_stream_state(tplans[0], N, x_calib=xt),
              engine.init_stream_state(tplans[1], N,
                                       x_calib=model.bone_stream(xt)))
    step = make_gcn_stream_step(CFG)
    jstates = (jengine.init_stream_state(jplans[0], N, x_calib=jnp.asarray(x)),
               jengine.init_stream_state(
                   jplans[1], N, x_calib=jmodel.bone_stream(jnp.asarray(x))))
    jstep = jax.jit(jax_stream_step(JCFG))
    for frame, valid in _frames(x, engine.stream_flush_frames(
            tplans[0], x.shape[1])):
        states, logits = step(tplans, states, torch.from_numpy(frame), valid)
        jstates, jlogits = jstep(jplans, jstates, jnp.asarray(frame),
                                 jnp.asarray(valid))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    want = make_gcn_infer_step(CFG)(tplans, xt)
    np.testing.assert_allclose(logits.numpy(), want.numpy(), **TOL)


def test_streaming_matches_clip_odd_stride_length(jparams, tparams,
                                                  prune_plans):
    """30 frames -> skip 2 -> 15 -> the stride-2 block gets an odd length:
    the drain still reaches clip parity (JAX reference clip logits)."""
    x_odd = np.random.default_rng(3).standard_normal(
        (N, 30, 25, 3)).astype(np.float32)
    tplan, jplan = _plans(jparams[0], tparams[0], prune_plans,
                          "pruned_quant", "cuda")
    want = np.asarray(jengine.execute(jplan, jnp.asarray(x_odd)))
    np.testing.assert_allclose(
        engine.execute(tplan, torch.from_numpy(x_odd)).numpy(), want, **TOL)
    _, got = _stream_torch(tplan, x_odd)
    np.testing.assert_allclose(got[-1], want, **TOL)


# -------------------------------------------------------- state machinery

def test_emission_count_matches_clip_output_length(tparams, x):
    """Exactly the clip engine's pooled frame count reaches the pool."""
    plan = engine.build_execution_plan(tparams[0], CFG, backend="cuda")
    state, _ = _stream_torch(plan, x)
    t = -(-x.shape[1] // CFG.input_skip)
    for s in CFG.gcn_strides:
        t = (t - 1) // s + 1
    np.testing.assert_array_equal(state.pool_t.numpy(), t)
    assert state.t_raw.dtype == torch.int32
    np.testing.assert_array_equal(state.t_raw.numpy(),
                                  x.shape[1] + 37)


def test_step_frame_is_functional(tparams, x):
    """A state kept aside continues identically twice; the step does not
    modify its input state."""
    plan = engine.build_execution_plan(tparams[0], CFG, backend="cuda")
    xt = torch.from_numpy(x)
    state = engine.init_stream_state(plan, N, x_calib=xt)
    for r in range(6):       # an even raw count: the next frame is an input
        state, _ = engine.step_frame(plan, state, xt[:, r])
    kept = [b["ring_s"].clone() for b in state.blocks]
    a_state, a = engine.step_frame(plan, state, xt[:, 6])
    b_state, b = engine.step_frame(plan, state, xt[:, 6])
    assert torch.equal(a, b)
    for k, blk in zip(kept, state.blocks):
        assert torch.equal(k, blk["ring_s"])
    assert not torch.equal(a_state.blocks[0]["ring_s"],
                           state.blocks[0]["ring_s"])


@pytest.mark.parametrize("window", [16, 3])
def test_sliding_window_pool(jparams, tparams, x, window):
    """gcn_stream_pool=W: equal to JAX's sliding pool at every step; a
    window at least as long as the emission count is the clip logits, a
    shorter one changes them and stays finite."""
    cfg = dataclasses.replace(CFG, gcn_stream_pool=window)
    jcfg = dataclasses.replace(JCFG, gcn_stream_pool=window)
    tplan = engine.build_execution_plan(tparams[0], cfg, backend="cuda")
    jplan = jengine.build_execution_plan(jparams[0], jcfg)
    assert tplan.static.stream_pool == jplan.static.stream_pool == window
    state, got = _stream_torch(tplan, x)
    for g, w in zip(got, _stream_jax(jplan, x, f"pool{window}")):
        np.testing.assert_allclose(g, w, **TOL)
    assert state.pool_ring.shape == (N, window, CFG.gcn_channels[-1])
    clip = engine.execute(tplan, torch.from_numpy(x)).numpy()
    assert np.isfinite(got[-1]).all()
    if window == 16:
        np.testing.assert_allclose(got[-1], clip, **TOL)
    else:
        assert not np.allclose(got[-1], clip, atol=1e-3)


def test_rfc_state_holds_encoded_interlayer_activations(tparams, x,
                                                        prune_plans):
    """``cuda`` streams keep the RFC-encoded activations of each boundary's
    last emitted frame: a valid encoding (int16 bank words whose popcount
    is the number of non-zero values, front-packed non-negative values),
    equal to the re-encoding of its own decode."""
    plan = engine.build_execution_plan(tparams[0], CFG, prune_plans[0],
                                       backend="cuda")
    assert plan.static.use_rfc
    ref_plan = engine.build_execution_plan(tparams[0], CFG, prune_plans[0])
    assert not ref_plan.static.use_rfc
    state, _ = _stream_torch(plan, x)
    assert len(state.rfc) == len(plan.static.blocks) - 1
    for boundary, bs in zip(state.rfc, plan.static.blocks):
        vals, bits = boundary["vals"], boundary["bits"]
        assert vals.shape == (N, 25, bs.cout)
        assert bits.dtype == torch.int16
        assert bits.shape == (N, 25, -(-bs.cout // rp.BANK))
        hot = rp.hot_from_bits(bits)
        assert int((vals != 0).sum()) == int(hot.sum()) > 0
        assert bool((vals >= 0).all())
        v2, b2 = ops.rfc_encode(ops.rfc_decode(vals, bits))
        assert torch.equal(v2, vals) and torch.equal(b2, bits)


# -------------------------------------------------------- preconditions

def test_calibration_required(tparams):
    plan = engine.build_execution_plan(tparams[0], CFG, backend="cuda")
    with pytest.raises(ValueError, match="frozen BN statistics"):
        engine.init_stream_state(plan, N)


@pytest.mark.parametrize("reduced", [True, False])
def test_drain_arithmetic_matches_jax(reduced):
    """stream_flush_frames and stream_first_logit_delay equal JAX's; the
    full config's 300-frame clip drains in 149 steps and its first logit
    lands 153 raw frames after admission."""
    cfg = get_config("agcn-2s", reduced=reduced)
    jcfg = jax_get_config("agcn-2s", reduced=reduced)
    tplan = engine.build_execution_plan(
        model.init_params(cfg, seed=0, device="cpu"), cfg)
    # the JAX functions read only the plan's static part
    jplan = jengine.ExecutionPlan(arrays={}, static=jengine.PlanStatic(
        backend="reference", interpret=True, input_skip=jcfg.input_skip,
        use_rfc=False, rfc_bank=jcfg.rfc_bank, tkernel=jcfg.gcn_tkernel,
        joints=jcfg.gcn_joints, in_channels=jcfg.gcn_in_channels,
        stream_pool=jcfg.gcn_stream_pool, blocks=tuple(
            jengine.BlockStatic(stride=s, cin=0, cout=0, n_kept_filters=0,
                                tkernel=jcfg.gcn_tkernel, use_ck=False,
                                pruned_in=False, pruned_filters=False)
            for s in jcfg.gcn_strides)))
    for frames in (0, 1, 2, 7, 30, 32, 64, 299, 300):
        assert (engine.stream_flush_frames(tplan, frames)
                == jengine.stream_flush_frames(jplan, frames)), frames
    assert (engine.stream_first_logit_delay(tplan)
            == jengine.stream_first_logit_delay(jplan))
    if not reduced:
        assert engine.stream_flush_frames(tplan, 300) == 149
        assert engine.stream_first_logit_delay(tplan) == 153
