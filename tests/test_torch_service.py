"""The port's ``GcnService`` on the CPU at the reduced ``agcn-2s`` config:
the handle API against the same session streamed alone, the service
against the JAX ``GcnService(backend="reference")`` on one short script
(bridged weights and BN statistics; equal outcome logs, logits within
atol=rtol=1e-3), elastic migration parity, poll states and errors,
``export_session``/``import_session``, a mixed-skeleton and a ``use_ck``
service, the readback discipline, ``model.init_stream``, ``run_sessions``
and the ``serve sessions`` CLI."""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import engine as jengine
from repro.core.agcn import model as jmodel
from repro.core.pruning.plan import build_prune_plan as jax_build_prune_plan
from repro.serving import GcnService as JaxService
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.launch import serve
from repro_torch.serving import (CapacityConfig, GcnService, SessionHandle,
                                 run_sessions)

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)
V, C = CFG.gcn_joints, CFG.gcn_in_channels
TOL = dict(atol=1e-3, rtol=1e-3)
ELASTIC = CapacityConfig(tiers=(2, 4), grow_patience=1, shrink_patience=2,
                         cooldown=3)
TRACES = pathlib.Path(__file__).resolve().parent / "data" / "traces"
XCAL = np.random.default_rng(1).standard_normal(
    (2, CFG.gcn_frames, V, C)).astype(np.float32)


@pytest.fixture(scope="module")
def jparams():
    # one compiled program instead of many eager ops (seconds on the CPU)
    return jax.jit(jmodel.init_params, static_argnums=0)(
        JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def fracs_plans(jparams):
    sw = [np.asarray(b["Wk"]) for b in jparams["blocks"]]
    fr = [1.0, 0.5, 0.5, 0.5]
    return (build_prune_plan(sw, CFG.gcn_channels, fr, "cav-70-1",
                             input_skip=2),
            jax_build_prune_plan(sw, JCFG.gcn_channels, fr, "cav-70-1",
                                 input_skip=2))


def _tplan(jparams, prune_plan, backend, cfg=CFG):
    p = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    plan = engine.build_execution_plan(p, cfg, prune_plan, quant=True,
                                       backend=backend)
    return plan, engine.collect_bn_stats(plan, torch.from_numpy(XCAL))


@pytest.fixture(scope="module")
def plans(jparams, fracs_plans):
    return {b: _tplan(jparams, fracs_plans[0], b)
            for b in ("reference", "cuda")}


def _alone(plan, bn, clip):
    """One session alone: a batch-1 stream over the clip and the drain."""
    state = engine.init_stream_state(plan, 1, bn_stats=bn)
    x = torch.from_numpy(clip)[None]
    T = x.shape[1]
    logits = None
    with torch.inference_mode():
        for r in range(T + engine.stream_flush_frames(plan, T)):
            frame = x[:, r] if r < T else torch.zeros_like(x[:, 0])
            state, logits = engine.step_frame(plan, state, frame, r < T)
    return logits[0].numpy()


def _drive(svc, arrivals, max_ticks=600):
    """Open + submit each (arrival, clip, kwargs), run to idle; returns
    {index: final logits}."""
    handles, out = {}, {}
    order = sorted(range(len(arrivals)), key=lambda i: arrivals[i][0])
    i = 0
    while svc.now < max_ticks:
        while i < len(order) and arrivals[order[i]][0] <= svc.now:
            at, clip, kw = arrivals[order[i]]
            h = svc.open_session(arrival=at, **kw)
            svc.submit_clip(h, clip)
            handles[order[i]] = h
            i += 1
        if svc.idle():
            if i == len(order):
                break
            svc.advance_clock(arrivals[order[i]][0])
            continue
        svc.tick()
    assert svc.idle()
    for k, h in handles.items():
        st = svc.poll(h)
        assert st.state == "done"
        out[k] = st.logits
    return out


def _clips(seed, lengths):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((T, V, C)).astype(np.float32)
            for T in lengths]


# ------------------------------------------------------- handle protocol

@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_handle_api_matches_independent(plans, backend):
    """open/submit/poll/close with starved ticks (held, not padded) equals
    the session streamed alone."""
    plan, bn = plans[backend]
    svc = GcnService(CFG, backend=backend, plans=(plan,), bn_stats=(bn,),
                     capacity_tiers=(2,), device="cpu")
    clip = _clips(5, (10,))[0]
    h = svc.open_session()
    fed = 0
    for burst in (1, 0, 2, 0, 0, 3, 1, 0, 3):
        for _ in range(burst):
            svc.submit(h, clip[fed])
            fed += 1
        assert svc.poll(h).state in ("queued", "active")
        svc.tick()
    svc.close(h)
    assert svc.poll(h).state in ("active", "draining")
    svc.run_until_idle()
    st = svc.poll(h)
    assert st.state == "done" and st.record.frames == 10
    np.testing.assert_allclose(st.logits, _alone(plan, bn, clip), **TOL)


def test_poll_states_errors_and_readbacks(plans):
    """poll walks queued -> active -> draining -> done; a plain tick
    copies nothing back; poll(wait=True) and a finishing session each
    force one copy; bad frames, closed streams and unknown handles
    raise; a never-closed session makes run_until_idle raise."""
    plan, bn = plans["reference"]
    svc = GcnService(CFG, backend="reference", plans=(plan,),
                     bn_stats=(bn,), capacity_tiers=(1,), device="cpu")
    h0, h1 = svc.open_session(), svc.open_session()
    assert svc.poll(h0).state == svc.poll(h1).state == "queued"
    clip = np.zeros((2, V, C), np.float32)
    svc.submit_clip(h0, clip)
    svc.tick()
    assert svc.poll(h0).state == "active" and svc.poll(h1).state == "queued"
    svc.tick()
    svc.tick()
    assert svc.readbacks == 0
    st = svc.poll(h0)
    assert st.state == "draining" and st.logits is None
    assert svc.poll(h0, wait=True).logits is not None
    assert svc.readbacks == 1
    with pytest.raises(ValueError):
        svc.submit(h0, clip[0])
    with pytest.raises(ValueError):
        svc.submit(h1, np.zeros((V + 1, C)))
    with pytest.raises(KeyError):
        svc.poll(SessionHandle(sid=999))
    svc.submit_clip(h1, clip)
    svc.run_until_idle()
    assert svc.poll(h0).state == svc.poll(h1).state == "done"
    assert svc.readbacks == 3               # the poll and two finishes
    m = svc.metrics()
    assert m["device"] == "cpu" and m["readbacks"] == 3
    assert m["tick_ms_p50"] > 0 and m["device_dispatches"] == svc.now
    assert 0 < m["wall_dispatch_s"] < m["wall_host_s"]
    h2 = svc.open_session()
    svc.submit(h2, clip[0])
    with pytest.raises(RuntimeError, match="close"):
        svc.run_until_idle(max_ticks=5)


def test_service_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GcnService(CFG)


# ------------------------------------------------- against the JAX service

def _script_arrivals():
    """Five sessions over 2 -> 4 tiers under preempt: priorities, a grow
    with active sessions, preemptions into the snapshot ring."""
    clips = _clips(7, (14, 9, 6, 11, 5))
    prio = (0, 0, 1, 0, 2)
    at = (0, 1, 3, 3, 6)
    return [(a, c, {"priority": p}) for a, c, p in zip(at, clips, prio)]


SCRIPT_KW = dict(qos="preempt", capacity_tiers=(2, 4),
                 capacity_config=ELASTIC, record_outcomes=True)
METRIC_KEYS = ("sessions", "ticks", "preemptions", "restores",
               "resize_events", "capacity_final", "tier_ticks")


@pytest.fixture(scope="module")
def jax_script(jparams, fracs_plans):
    """The JAX service (reference backend, fused tick) on the script:
    (outcome log, {session: logits}, metrics)."""
    jplan = jengine.build_execution_plan(jparams, JCFG, fracs_plans[1],
                                         quant=True)
    jbn = jengine.collect_bn_stats(jplan, jnp.asarray(XCAL))
    jsvc = JaxService(JCFG, backend="reference", plans=(jplan,),
                      bn_stats=(jbn,), warm=False, **SCRIPT_KW)
    got = _drive(jsvc, _script_arrivals())
    return jsvc.outcomes, got, jsvc.metrics()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_service_matches_jax_reference(plans, jax_script, backend, fused):
    """The port's service (either backend, fused or legacy tick) and the
    JAX service (reference backend) on the same script with the same
    weights and BN statistics: the same per-tick outcome log and
    counters, and every session's logits within 1e-3."""
    plan, bn = plans[backend]
    tsvc = GcnService(CFG, backend=backend, plans=(plan,), bn_stats=(bn,),
                      device="cpu", fused=fused, **SCRIPT_KW)
    got = _drive(tsvc, _script_arrivals())
    outcomes, want, jm = jax_script
    assert tsvc.outcomes == outcomes
    assert tsvc.sched.preemptions > 0 and tsvc.capman.events
    for i in want:
        np.testing.assert_allclose(got[i], want[i], **TOL,
                                   err_msg=f"session {i}")
    tm = tsvc.metrics()
    for k in METRIC_KEYS:
        assert tm[k] == jm[k], k
    # the legacy tick reads the logits back every tick
    assert (tm["readbacks"] == tm["ticks"]) != fused


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_elastic_migration_parity(plans, backend):
    """Sessions migrated across tiers (a grow with two active sessions,
    a shrink with one) equal their runs alone, and the tier slabs stay
    all zero (nothing writes into them)."""
    plan, bn = plans[backend]
    svc = GcnService(CFG, backend=backend, plans=(plan,), bn_stats=(bn,),
                     capacity_tiers=(2, 4), capacity_config=ELASTIC,
                     device="cpu")
    clips = _clips(9, (26, 20, 8, 8))
    got = _drive(svc, [(0, clips[0], {}), (1, clips[1], {}),
                       (4, clips[2], {}), (4, clips[3], {})])
    ev = svc.capman.events
    assert any(e.new > e.old and e.busy > 0 for e in ev)
    assert any(e.new < e.old and e.busy > 0 for e in ev)
    for i, clip in enumerate(clips):
        np.testing.assert_allclose(got[i], _alone(plan, bn, clip), **TOL,
                                   err_msg=f"session {i}")
    for slabs in svc._tier_slabs.values():
        for slab in slabs:
            leaves = engine._tree_map(lambda t: t, engine.snapshot_slots(
                slab, torch.arange(slab.t_raw.shape[0])))
            flat = []
            engine._tree_map(lambda t: flat.append(t), leaves)
            assert all(not t.any() for t in flat)


def test_elastic_bystander_bit_identity(plans):
    """A session riding through grow and shrink migrations is bit-equal to
    the same session served at fixed capacity."""
    plan, bn = plans["reference"]
    clips = _clips(10, (26, 8, 8))
    arrivals = [(0, clips[0], {}), (2, clips[1], {}), (2, clips[2], {})]
    fixed = GcnService(CFG, backend="reference", plans=(plan,),
                       bn_stats=(bn,), capacity_tiers=(4,), device="cpu")
    elastic = GcnService(CFG, backend="reference", plans=(plan,),
                         bn_stats=(bn,), capacity_tiers=(2, 4),
                         capacity_config=ELASTIC, device="cpu")
    want, got = _drive(fixed, arrivals), _drive(elastic, arrivals)
    assert elastic.capman.events
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])


# ------------------------------------------------- cross-service migration

@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_export_import_round_trip(plans, fused):
    """A session exported mid-stream (once from a slot, once as a
    preempted session awaiting re-admission) and imported into another
    service ends with the logits of its uninterrupted run; a bystander
    on the origin is bit-equal to its run without the export."""
    plan, bn = plans["reference"]

    def mk():
        return GcnService(CFG, backend="reference", plans=(plan,),
                          bn_stats=(bn,), capacity_tiers=(1,),
                          qos="preempt", fused=fused, device="cpu")

    c_lo, c_hi, c_by = _clips(11, (16, 12, 10))
    want_lo = _alone(plan, bn, c_lo)
    # from a slot: export after 5 ticks, finish on the other service
    a, b = mk(), mk()
    h = a.open_session()
    a.submit_clip(h, c_lo)
    for _ in range(5):
        a.tick()
    pkg = a.export_session(h)
    assert pkg["snaps"] is not None
    with pytest.raises(KeyError):
        a.poll(h)
    hb = b.import_session(pkg)
    b.run_until_idle()
    np.testing.assert_allclose(b.poll(hb).logits, want_lo, **TOL)
    # preempted: a high-priority open evicts it into the ring (or the held
    # snapshots), it is exported from the queue; the bystander stays
    a, b = mk(), mk()
    h = a.open_session(priority=0)
    a.submit_clip(h, c_lo)
    for _ in range(4):
        a.tick()
    hh = a.open_session(priority=1)
    a.submit_clip(hh, c_by)
    a.tick()
    assert a.poll(h).state == "queued"
    hb = b.import_session(a.export_session(h))
    a.run_until_idle()
    b.run_until_idle()
    np.testing.assert_allclose(b.poll(hb).logits, want_lo, **TOL)
    ref = mk()
    hr = ref.open_session(priority=1)
    ref.submit_clip(hr, c_by)
    ref.run_until_idle()
    np.testing.assert_allclose(a.poll(hh).logits, ref.poll(hr).logits,
                               atol=1e-6, rtol=1e-6)
    with pytest.raises(ValueError, match="already finished"):
        a.export_session(hh)


# ------------------------------------------------- skeletons and C_k

def test_mixed_topology_service():
    """A two-skeleton service (ntu25 padded to 50, ntu50) built from the
    config: each session's logits equal its run alone on the service's
    own plans of its skeleton (1e-4), slots are reused across skeletons,
    and a tick of both groups is two steps."""
    svc = GcnService(CFG, backend="reference",
                     topologies=("ntu25", "ntu50"), capacity_tiers=(2,),
                     device="cpu")
    assert svc.vmax == 50
    rng = np.random.default_rng(12)
    spec = [("ntu25", 0, 7), ("ntu50", 0, 9), ("ntu50", 2, 5),
            ("ntu25", 3, 6)]
    handles, clips = [], []
    for topo, at, T in spec:
        vt = 25 if topo == "ntu25" else 50
        clips.append(rng.standard_normal((T, vt, C)).astype(np.float32))
    i = 0
    while i < len(spec) or not svc.idle():
        while i < len(spec) and spec[i][1] <= svc.now:
            h = svc.open_session(topology=spec[i][0])
            svc.submit_clip(h, clips[i])
            handles.append(h)
            i += 1
        svc.tick()
    assert svc.device_dispatches > svc.now
    with pytest.raises(ValueError, match="unknown topology"):
        svc.open_session(topology="hand21")
    for (topo, _, T), h, clip in zip(spec, handles, clips):
        plans_t, stats_t = svc._topo_plans[topo], svc._topo_stats[topo]
        x = torch.zeros((1, T, 50, C))
        x[0, :, : clip.shape[1]] = torch.from_numpy(clip)
        st = tuple(engine.init_stream_state(p, 1, bn_stats=s)
                   for p, s in zip(plans_t, stats_t))
        from repro_torch.train.steps import make_gcn_stream_step
        step = make_gcn_stream_step(CFG)
        for r in range(T + svc.flush_frames(T)):
            st, want = step(plans_t, st, x[:, r] if r < T
                            else torch.zeros_like(x[:, 0]), r < T)
        np.testing.assert_allclose(svc.poll(h).logits, want[0].numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=topo)


def _ck_arrivals():
    clips = _clips(13, (9, 6, 7))
    return [(0, clips[0], {}), (1, clips[1], {}), (2, clips[2], {})]


@pytest.fixture(scope="module")
def jax_ck(jparams):
    """A ``use_ck`` JAX service's run of a short script, and its weights:
    (params, outcomes, {session: logits}).  The weights are ``jparams``
    with seeded θ/φ embeddings (Cin, max(4, Cin // 4)) added per block."""
    jcfg = dataclasses.replace(JCFG, use_ck=True)
    rng = np.random.default_rng(3)
    blocks = []
    for b in jparams["blocks"]:
        cin = b["Wk"].shape[1]
        ce = max(4, cin // 4)
        blocks.append({**b, **{k: jnp.asarray(rng.standard_normal(
            (cin, ce)).astype(np.float32) / np.float32(np.sqrt(cin)))
            for k in ("theta", "phi")}})
    jp = {**jparams, "blocks": blocks}
    jplan = jengine.build_execution_plan(jp, jcfg)
    jbn = jengine.collect_bn_stats(jplan, jnp.asarray(XCAL))
    jsvc = JaxService(jcfg, plans=(jplan,), bn_stats=(jbn,),
                      capacity_tiers=(2,), record_outcomes=True, warm=False)
    return jp, jsvc.outcomes, _drive(jsvc, _ck_arrivals())


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_ck_service_matches_jax(jax_ck, backend):
    """A ``use_ck`` service against the JAX one (reference backend, the
    same weights and BN statistics) on a short script: equal outcomes,
    logits within 1e-3."""
    cfg = dataclasses.replace(CFG, use_ck=True)
    jp, outcomes, want = jax_ck
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    plan = engine.build_execution_plan(tp, cfg, backend=backend)
    bn = engine.collect_bn_stats(plan, torch.from_numpy(XCAL))
    tsvc = GcnService(cfg, backend=backend, plans=(plan,), bn_stats=(bn,),
                      capacity_tiers=(2,), record_outcomes=True,
                      device="cpu")
    got = _drive(tsvc, _ck_arrivals())
    assert tsvc.outcomes == outcomes
    assert tsvc.metrics()["ck"] is True
    for i in want:
        np.testing.assert_allclose(got[i], want[i], **TOL)


# ------------------------------------------------- helpers and drivers

def test_init_stream_matches_jax(jparams, fracs_plans):
    """``model.init_stream`` builds the plan and a calibrated state whose
    first stream steps give the JAX ``init_stream``'s logits (1e-3)."""
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    plan, state = model.init_stream(tp, CFG, torch.from_numpy(XCAL),
                                    fracs_plans[0], quant=True,
                                    backend="reference")
    jplan, jstate = jmodel.init_stream(jparams, JCFG, jnp.asarray(XCAL),
                                       fracs_plans[1], quant=True,
                                       backend="reference")
    assert state.t_raw.shape == (2,)
    for k, v in jstate.bn_stats.items():
        for f in ("mean", "inv"):
            np.testing.assert_allclose(state.bn_stats[k][f].numpy(),
                                       np.asarray(v[f]), **TOL)
    _, lt = engine.step_frame(plan, state, torch.from_numpy(XCAL[:, 0]))
    _, lj = jengine.step_frame(jplan, jstate, jnp.asarray(XCAL[:, 0]))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    plan2, _ = model.init_stream(None, CFG, torch.from_numpy(XCAL),
                                 exec_plan=plan)
    assert plan2 is plan


def test_run_sessions_end_to_end():
    """The ``serve sessions`` driver on Poisson traffic: every session
    completes with finite logits, the first logit after 41 frames and
    clip + 37 flush ticks in a slot (the reduced config's pipeline)."""
    res = run_sessions(CFG, slots=2, n_sessions=3, mean_interarrival=4.0,
                       lengths=(8, 12), backend="reference", seed=0,
                       device="cpu")
    assert res["sessions"] == 3 and res["load"] == "poisson"
    assert res["first_logit_frames"] == 41
    for rec in res["records"]:
        assert np.isfinite(rec.logits).all()
        assert rec.finished - rec.admitted + 1 == rec.frames + 37


def test_serve_sessions_cli(tmp_path, capsys):
    """``serve sessions --reduced --device cpu --trace smoke.json`` replays
    the trace on the card's default backend (its plain versions here) and
    merges its row, keyed by device, into the bench file."""
    bench = tmp_path / "BENCH_torch_sessions.json"
    serve.main(["sessions", "--arch", "agcn-2s", "--reduced", "--device",
                "cpu", "--trace", str(TRACES / "smoke.json"),
                "--capacity-tiers", "2,4", "--bench", str(bench)])
    out = capsys.readouterr().out
    assert "trace=smoke-v1" in out and "device=cpu" in out
    rows = json.loads(bench.read_text())
    assert len(rows) == 1 and rows[0]["device"] == "cpu"
    assert rows[0]["backend"] == "cuda" and rows[0]["sessions"] == 14
    assert rows[0]["load"] == "trace" and "records" not in rows[0]
    with pytest.raises(SystemExit):
        serve.main(["sessions", "--arch", "agcn-2s", "--reduced",
                    "--device", "cpu", "--replicas", "2"])
    assert "Queue 1 item 4" in capsys.readouterr().err
