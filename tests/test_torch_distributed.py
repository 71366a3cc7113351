"""The port's distributed serving tier on the CPU at the reduced
``agcn-2s`` config: ``GcnService(mesh=...)`` over logical CPU shards
(``make_batch_mesh(n, device="cpu")``) and the ``ReplicaRouter``.  Every
case of ``tests/test_distributed.py`` is mirrored and held both to the
port's unsharded service and to the JAX single-device
``GcnService(backend="reference")`` (bridged weights and BN statistics):
equal outcome logs and counters, logits within atol=rtol=1e-3, bystanders
bit-equal.  Beyond them: a snapshot and a restore of one ring row on
different shards in one tick, export/import between a sharded and an
unsharded service, the golden digests through a 2-shard mesh, a
mixed-skeleton sharded service and the ``serve sessions --mesh/--replicas``
CLI."""
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
from repro.distributed.router import ReplicaRouter as JaxRouter
from repro.serving import CapacityConfig as JaxCapacityConfig
from repro.serving import GcnService as JaxService
from repro_torch.bridge import params_from_numpy
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.distributed import (BatchMesh, ReplicaRouter, RouterHandle,
                                     collective_cost_ms, make_batch_mesh,
                                     run_routed_sessions)
from repro_torch.launch import serve
from repro_torch.serving import (CapacityConfig, GcnService, SloConfig,
                                 Trace, outcome_digest, trace_requests)
from repro_torch.serving.scheduler import max_events_for, pad_event_orders

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)
V, C = CFG.gcn_joints, CFG.gcn_in_channels
TOL = dict(atol=1e-3, rtol=1e-3)
XCAL = np.random.default_rng(1).standard_normal(
    (2, CFG.gcn_frames, V, C)).astype(np.float32)
# grow_patience=3: the tick-1 high-priority arrivals preempt while the
# 4-slot tier is still full, and the preempted backlog drives the grow
ELASTIC = dict(tiers=(4, 8), grow_patience=3, shrink_patience=2, cooldown=3)
TRACES = pathlib.Path(__file__).resolve().parent / "data" / "traces"
GOLDEN = json.loads((TRACES / "golden_smoke.json").read_text())


def cpu_mesh(n):
    return make_batch_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def jparams():
    return jax.jit(jmodel.init_params, static_argnums=0)(
        JCFG, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def plans(jparams):
    """{backend: (plan, bn)} for the port and ``"jax"``: (plan, bn) of the
    JAX reference engine, from the same weights, prune plan and
    calibration batch."""
    sw = [np.asarray(b["Wk"]) for b in jparams["blocks"]]
    fr = [1.0, 0.5, 0.5, 0.5]
    pp = build_prune_plan(sw, CFG.gcn_channels, fr, "cav-70-1", input_skip=2)
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    out = {}
    for b in ("reference", "cuda"):
        plan = engine.build_execution_plan(tp, CFG, pp, quant=True,
                                           backend=b)
        out[b] = (plan, engine.collect_bn_stats(plan, torch.from_numpy(XCAL)))
    jplan = jengine.build_execution_plan(
        jparams, JCFG, jax_build_prune_plan(sw, JCFG.gcn_channels, fr,
                                            "cav-70-1", input_skip=2),
        quant=True)
    out["jax"] = (jplan, jengine.collect_bn_stats(jplan, jnp.asarray(XCAL)))
    return out


def _svc(plans, backend="reference", mesh=None, **kw):
    plan, bn = plans[backend]
    if backend == "jax":
        return JaxService(JCFG, backend="reference", plans=(plan,),
                          bn_stats=(bn,), **kw)
    return GcnService(CFG, backend=backend, plans=(plan,), bn_stats=(bn,),
                      mesh=mesh, device="cpu", **kw)


def _script(seed, spec):
    """(arrival, priority, clip) per (arrival, priority, frames) of
    ``spec``, clips drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    return [(a, p, rng.standard_normal((T, V, C)).astype(np.float32))
            for a, p, T in spec]


QOS_SPEC = [(0, 0, 12)] * 4 + [(1, 1, 6)] * 2
FIXED_SPEC = [(0, 0, 8)] * 4 + [(1, 1, 4)]


def _drive(svc, script, max_ticks=600):
    """Feed ``script`` through the handle API and run to idle; returns
    ({sid: final logits}, metrics).  Either package's service."""
    order = sorted(range(len(script)), key=lambda i: script[i][0])
    i = 0
    while svc.now < max_ticks:
        while i < len(order) and script[order[i]][0] <= svc.now:
            a, p, clip = script[order[i]]
            h = svc.open_session(priority=p, arrival=a)
            svc.submit_clip(h, clip)
            i += 1
        if svc.idle():
            if i == len(order):
                break
            svc.advance_clock(script[order[i]][0])
            continue
        svc.tick()
    assert svc.idle(), "service did not drain within the tick budget"
    m = svc.metrics()
    return {r.sid: r.logits for r in m["records"]}, m


def _alone(plan, bn, clip):
    """One session streamed alone (batch 1) through the clip and drain."""
    state = engine.init_stream_state(plan, 1, bn_stats=bn)
    x = torch.from_numpy(clip)[None]
    T = x.shape[1]
    with torch.inference_mode():
        for r in range(T + engine.stream_flush_frames(plan, T)):
            frame = x[:, r] if r < T else torch.zeros_like(x[:, 0])
            state, logits = engine.step_frame(plan, state, frame, r < T)
    return logits[0].numpy()


def _close(got, want, **tol):
    assert set(got) == set(want)
    for k in sorted(want):
        np.testing.assert_allclose(got[k], want[k], **(tol or TOL),
                                   err_msg=f"session {k}")


# ------------------------------------------------------------- mesh tier

def test_make_batch_mesh_overask_raises():
    """More CUDA devices than visible is a loud error naming the count,
    not a short mesh or a CPU mesh; logical shards need a device."""
    with pytest.raises(RuntimeError, match="device_count"):
        make_batch_mesh(torch.cuda.device_count() + 1)
    m = cpu_mesh(4)
    assert m.size == 4 and m.axis_names == ("data",)
    assert set(m.devices) == {torch.device("cpu")}
    with pytest.raises(ValueError, match="at least 1"):
        make_batch_mesh(0, device="cpu")


def test_mesh_divisibility_validation(plans):
    """Every capacity tier must be a multiple of the mesh size, and the
    mesh must be 1-D."""
    with pytest.raises(ValueError, match="divide"):
        _svc(plans, mesh=cpu_mesh(4), capacity_tiers=(4, 6), warm=False)
    flat = BatchMesh(devices=cpu_mesh(4).devices, axis_names=("a", "b"))
    with pytest.raises(ValueError, match="1-D"):
        _svc(plans, mesh=flat, capacity_tiers=(4,), warm=False)


@pytest.fixture(scope="module")
def jax_runs(plans):
    """The JAX single-device reference service on the QoS trace (tiers 4,
    8, preempt) and on the fixed 4-slot preemption script: per script
    ({sid: logits}, metrics, outcome log)."""
    out = {}
    for name, spec, seed, kw in (
            ("qos", QOS_SPEC, 7, dict(capacity_tiers=(4, 8),
                                      capacity_config=JaxCapacityConfig(
                                          **ELASTIC))),
            ("fixed", FIXED_SPEC, 11, dict(capacity_tiers=(4,)))):
        svc = _svc(plans, "jax", qos="preempt", record_outcomes=True,
                   warm=False, **kw)
        out[name] = (*_drive(svc, _script(seed, spec)), svc.outcomes)
    return out


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "legacy"])
def test_sharded_parity_reference(plans, jax_runs, fused):
    """A QoS trace with preemptions, restores and an elastic 4 -> 8 grow
    through a 4-shard slab: the outcome log, preemption and migration
    counts of the unsharded port service and of the JAX service, session
    logits within 1e-3 of both (the shards' tiles may round differently
    from the whole slab's)."""
    runs = {}
    for mesh in (cpu_mesh(4), None):
        svc = _svc(plans, mesh=mesh, qos="preempt", capacity_tiers=(4, 8),
                   capacity_config=CapacityConfig(**ELASTIC),
                   record_outcomes=True, fused=fused)
        runs[mesh is not None] = (*_drive(svc, _script(7, QOS_SPEC)),
                                  svc.outcomes)
    (osh, msh, lsh), (o1, m1, l1) = runs[True], runs[False]
    oj, mj, lj = jax_runs["qos"]
    assert msh["mesh"] == 4 and m1["mesh"] == 1
    assert msh["preemptions"] > 0 and msh["migrations"] > 0
    for m in (m1, mj):
        assert msh["preemptions"] == m["preemptions"]
        assert msh["restores"] == m["restores"]
        assert msh["migrations"] == m["migrations"]
    assert lsh == l1 == lj
    # each shard steps once a tick (the legacy snapshots and restores are
    # one dispatch per event and stream either way)
    run = sum(m1["tier_ticks"].values())
    assert (msh["device_dispatches"] - 4 * run
            == m1["device_dispatches"] - run)
    _close(osh, o1)
    _close(osh, oj)


def test_sharded_parity_cuda_backend(plans, jax_runs):
    """The same lock on the ``cuda`` backend (its wrappers run the plain
    versions on CPU tensors): a fixed 4-slot tier split over 4 shards with
    a preemption round trip, against the unsharded port service and the
    JAX reference service."""
    runs = {}
    for mesh in (cpu_mesh(4), None):
        svc = _svc(plans, "cuda", mesh=mesh, qos="preempt",
                   capacity_tiers=(4,), record_outcomes=True)
        runs[mesh is not None] = (*_drive(svc, _script(11, FIXED_SPEC)),
                                  svc.outcomes)
    (osh, msh, lsh), (o1, m1, l1) = runs[True], runs[False]
    oj, mj, lj = jax_runs["fixed"]
    assert msh["preemptions"] == m1["preemptions"] == mj["preemptions"] > 0
    assert lsh == l1 == lj
    _close(osh, o1)
    _close(osh, oj)


def _rows(slab):
    """Every per-slot leaf of ``slab``, all rows."""
    return tree_leaves(engine.snapshot_slots(
        slab, torch.arange(slab.t_raw.shape[0])))


def test_cross_shard_snapshot_and_restore_in_one_tick(plans):
    """A snapshot of slot 1 (shard 0) into ring row 3 and a restore of row
    3 into slot 2 (shard 1) in one sharded fused tick move the session:
    the shards and the ring equal ``engine.fused_tick`` on the whole slab
    with the global orders, and slot 2 holds slot 1's state."""
    svc = _svc(plans, mesh=cpu_mesh(2), capacity_tiers=(4,))
    for _, _, clip in _script(3, [(0, 0, 9)] * 3):
        svc.submit_clip(svc.open_session(), clip)
    for _ in range(6):
        svc.tick()
    plan, bn = plans["reference"]
    before = [torch.cat(xs) for xs in zip(*(_rows(sh[0])
                                            for sh in svc.slabs))]
    assert any(x[1].any() for x in before)      # slot 1 holds a live state
    whole = engine.restore_slots(
        engine.init_session_slab(plan, 4, bn_stats=bn), torch.arange(4),
        tree_map(lambda a, b: torch.cat([a, b]),
                 *(engine.snapshot_slots(sh[0], torch.arange(2))
                   for sh in svc.slabs)))
    E = max_events_for(4)
    frames = torch.randn(4, V, C)
    no, yes = torch.zeros(4, dtype=torch.bool), torch.ones(4, dtype=torch.bool)
    ins = [(frames[:2], no[:2], no[:2], yes[:2], []),
           (frames[2:], no[2:], no[2:], yes[2:], [])]
    snap = [torch.from_numpy(pad_event_orders([(1, 3)], E)), None]
    rest = [None, torch.from_numpy(pad_event_orders([(0, 3)], E))]
    slabs, logits, rings = svc._fused_tick(svc.slabs, ins, snap, rest,
                                           svc._rings)
    want_slab, want_logits, want_ring = engine.fused_tick(
        plan, whole, frames, no, no, yes, pad_event_orders([(1, 3)], E),
        pad_event_orders([(2, 3)], E), svc._rings[0])
    got = [torch.cat(xs) for xs in zip(*(_rows(sh[0]) for sh in slabs))]
    for g, w, b in zip(got, _rows(want_slab), before):
        assert torch.equal(g, w)
        assert torch.equal(g[2], b[1])          # the session moved
        assert torch.equal(g[[0, 1, 3]], b[[0, 1, 3]])
    for g, w in zip(tree_leaves(rings[0]), tree_leaves(want_ring)):
        assert torch.equal(g, w)
    np.testing.assert_allclose(torch.cat(logits).numpy(),
                               want_logits.numpy(), atol=1e-6, rtol=1e-6)


def test_collective_cost_measurable(plans):
    """The per-tick cost of the split step is a finite non-negative
    number, the ``collective_ms_per_tick`` bench axis."""
    svc = _svc(plans, mesh=cpu_mesh(4), capacity_tiers=(4,))
    ms = collective_cost_ms(svc, iters=2)
    assert np.isfinite(ms) and ms >= 0.0


def test_export_import_between_sharded_and_unsharded(plans):
    """An active session exported from shard 0 of a 2-shard service into
    an unsharded one and, three ticks later, back (admitted into shard 1),
    and a preempted session exported from the sharded service's ring: each
    ends with the logits of its run alone (1e-3), the ring row returns to
    the free list, and the bystanders equal their runs without an export
    bit for bit."""
    plan, bn = plans["reference"]
    c_a, c_b, c_lo, c_hi = (c for _, _, c in _script(
        12, [(0, 0, 16), (0, 0, 10), (0, 0, 16), (0, 1, 8)]))

    def mk(mesh=None, tiers=(2,)):
        return _svc(plans, mesh=mesh, capacity_tiers=tiers, qos="preempt")

    def active(export):
        # shard 0 holds slots 0, 1 and shard 1 slots 2, 3 of a 4-slot tier
        a, b = mk(cpu_mesh(2), (4,)), mk(None, (4,))
        ha, hb = a.open_session(), a.open_session()
        a.submit_clip(ha, c_a)
        a.submit_clip(hb, c_b)
        for _ in range(5):
            a.tick()
        if export:
            hx = b.import_session(a.export_session(ha))
            for _ in range(3):
                b.tick()
        a.submit_clip(a.open_session(), c_hi)    # takes slot 0 if free
        a.tick()
        if export:
            ha = a.import_session(b.export_session(hx))
            a.tick()
            assert a.sched.slots[2].req.sid == ha.sid    # back on shard 1
        a.run_until_idle()
        return a.poll(hb).logits, a.poll(ha).logits

    by, moved = active(True)
    np.testing.assert_allclose(moved, _alone(plan, bn, c_a), **TOL)
    np.testing.assert_array_equal(by, active(False)[0])

    def preempted(export):
        a, b = mk(cpu_mesh(2)), mk()
        hs = []
        for c in (c_lo, c_b):
            hs.append(a.open_session(priority=0))
            a.submit_clip(hs[-1], c)
        for _ in range(4):
            a.tick()
        hh = a.open_session(priority=1)
        a.submit_clip(hh, c_hi)
        a.tick()                     # evicts slot 0's session (the tie's
        victim = hs[0]               # lowest slot) into the ring
        assert a.poll(victim).state == "queued" and a.sched.preemptions == 1
        if export:
            hv = b.import_session(a.export_session(victim))
            b.run_until_idle()
            np.testing.assert_allclose(b.poll(hv).logits,
                                       _alone(plan, bn, c_lo), **TOL)
        a.run_until_idle()
        assert len(a.sched._ring_free) == a.snap_capacity
        return a.poll(hh).logits, a.poll(hs[1]).logits

    for x, y in zip(preempted(True), preempted(False)):
        np.testing.assert_array_equal(x, y)


def _replay_mesh(trace, mesh, qos, policy, plans_bn):
    """``serving.replay``'s loop through a ``GcnService(mesh=...)`` (replay
    itself takes no mesh, as the JAX one takes none)."""
    from collections import deque
    pol = "slo" if policy.startswith("slo") else "demand"
    slo = (SloConfig(**{**GOLDEN["slo"], "shed_mode": "degrade"
                        if policy == "slo-degrade" else "reject"})
           if pol == "slo" else None)
    svc = _svc(plans_bn, mesh=mesh, qos=qos, policy=pol,
               capacity_tiers=tuple(GOLDEN["tiers"]), slo_config=slo,
               record_outcomes=True)
    reqs = trace_requests(trace, CFG.gcn_joints, CFG.gcn_in_channels)
    if qos == "deadline":
        for r in reqs:
            if r.deadline is None:
                r.deadline = (r.arrival + len(r.clip)
                              + svc.flush_frames(len(r.clip)) + 25)
    pending = deque(sorted(reqs, key=lambda r: (r.arrival, r.sid)))
    while svc.now < 100_000:
        while pending and pending[0].arrival <= svc.now:
            r = pending.popleft()
            h = svc.open_session(priority=r.priority, deadline=r.deadline,
                                 arrival=r.arrival)
            if svc.poll(h).state != "rejected":
                svc.submit_clip(h, r.clip)
        if svc.idle():
            if not pending:
                break
            svc.advance_clock(pending[0].arrival)
            continue
        svc.tick()
    return svc.metrics(), svc.outcomes


@pytest.mark.parametrize("cell", sorted(GOLDEN["cells"]))
def test_golden_digests_through_a_2_shard_mesh(plans, cell):
    """Every cell of ``golden_smoke.json`` replayed through a 2-shard
    service reaches the golden outcome digest and counters."""
    qos, policy = cell.split("/")
    trace = Trace.load(str(TRACES / "smoke.json"))
    m, outcomes = _replay_mesh(trace, cpu_mesh(2), qos, policy, plans)
    want = GOLDEN["cells"][cell]
    assert m["mesh"] == 2
    assert outcome_digest(outcomes) == want["outcome_digest"]
    for k in ("ticks", "sessions", "preemptions", "restores",
              "deadline_missed", "capacity_final"):
        assert m[k] == want[k], k
    assert m["resize_events"] == want["migrations"]


def test_mixed_skeleton_sharded_service():
    """A two-skeleton service (ntu25 padded to 50, ntu50) split over two
    shards: every session done, each skeleton group stepped once per shard
    a tick, logits within 1e-4 of the unsharded service's."""
    rng = np.random.default_rng(12)
    spec = [("ntu25", 0, 7), ("ntu50", 0, 9), ("ntu50", 2, 5),
            ("ntu25", 3, 6)]
    clips = [rng.standard_normal((T, 25 if t == "ntu25" else 50, C))
             .astype(np.float32) for t, _, T in spec]
    got = {}
    for mesh in (cpu_mesh(2), None):
        svc = GcnService(CFG, backend="reference",
                         topologies=("ntu25", "ntu50"), capacity_tiers=(2,),
                         mesh=mesh, device="cpu")
        hs, i = [], 0
        while i < len(spec) or not svc.idle():
            while i < len(spec) and spec[i][1] <= svc.now:
                hs.append(svc.open_session(topology=spec[i][0]))
                svc.submit_clip(hs[-1], clips[i])
                i += 1
            svc.tick()
        assert all(svc.poll(h).state == "done" for h in hs)
        got[mesh is not None] = (svc, [svc.poll(h).logits for h in hs])
    (sh, a), (one, b) = got[True], got[False]
    assert sh.now == one.now
    assert sh.device_dispatches == 2 * one.device_dispatches > 2 * one.now
    for x, y in zip(a, b):
        np.testing.assert_allclose(x, y, atol=1e-4, rtol=1e-4)


# ------------------------------------------------------------ router tier

def _two_replicas(plans, **kw):
    return ReplicaRouter([_svc(plans, **kw), _svc(plans, **kw)])


def test_cross_replica_active_migration_parity(plans):
    """A session drained mid-clip out of replica 0's slot and resumed on
    replica 1 matches its run alone within 1e-3; the bystander sharing
    replica 0 is bit-equal to a run where no migration happened."""
    plan, bn = plans["reference"]
    clip_a, clip_b = (c for _, _, c in _script(3, [(0, 0, 14), (0, 0, 10)]))

    def run(migrate):
        router = _two_replicas(plans, capacity_tiers=(2,))
        ha = router.open_session(replica=0)
        router.submit_clip(ha, clip_a)
        hb = router.open_session(replica=0)
        router.submit_clip(hb, clip_b)
        for _ in range(5):
            router.tick()
        if migrate:
            assert router.replica_of(ha) == 0
            router.migrate_session(ha, 1)
            assert router.replica_of(ha) == 1
            assert router.rebalances == 1
        router.run_until_idle()
        return router.poll(ha).logits, router.poll(hb).logits

    logits_a, bystander = run(migrate=True)
    np.testing.assert_allclose(logits_a, _alone(plan, bn, clip_a), **TOL)
    np.testing.assert_array_equal(bystander, run(migrate=False)[1])


def test_cross_replica_preempted_export_parity(plans):
    """A preempted session (its state in the snapshot ring) exports through
    the ring row and resumes on the other replica with its run-alone
    logits; the row returns to replica 0's free list."""
    plan, bn = plans["reference"]
    clip_lo, clip_hi = (c for _, _, c in _script(5, [(0, 0, 16), (0, 0, 12)]))
    router = _two_replicas(plans, capacity_tiers=(1,), qos="preempt")
    h_lo = router.open_session(replica=0, priority=0)
    router.submit_clip(h_lo, clip_lo)
    for _ in range(4):
        router.tick()
    h_hi = router.open_session(replica=0, priority=1)
    router.submit_clip(h_hi, clip_hi)
    router.tick()
    assert router.poll(h_lo).state == "queued"
    src = router.services[0]
    assert src.sched.preemptions == 1
    router.migrate_session(h_lo, 1)
    router.run_until_idle()
    np.testing.assert_allclose(router.poll(h_lo).logits,
                               _alone(plan, bn, clip_lo), **TOL)
    assert router.poll(h_hi).state == "done"
    assert len(src.sched._ring_free) == src.snap_capacity


def test_router_pinning_and_feedback(plans):
    """Placement follows the load feedback (least busy + queued replica,
    index tie-break), handles stay pinned, an unknown handle raises."""
    router = _two_replicas(plans, capacity_tiers=(2,))
    hs = [router.open_session() for _ in range(4)]
    for h, (_, _, c) in zip(hs, _script(2, [(0, 0, 6)] * 4)):
        router.submit_clip(h, c)
    assert [router.replica_of(h) for h in hs] == [0, 1, 0, 1]
    fb = router.feedback()
    assert [f["replica"] for f in fb] == [0, 1]
    assert all(f["busy"] + f["queued"] == 2 for f in fb)
    router.run_until_idle()
    assert all(router.poll(h).state == "done" for h in hs)
    with pytest.raises(KeyError):
        router.poll(RouterHandle(rsid=999))


def test_router_rebalance_drains_hot_replica(plans):
    """Sessions pinned onto one replica rebalance onto the idle one
    (queued sessions first), and the move count lands in the merged
    row."""
    router = _two_replicas(plans, capacity_tiers=(2,))
    hs = []
    for _, _, c in _script(4, [(0, 0, 8)] * 4):
        hs.append(router.open_session(replica=0))
        router.submit_clip(hs[-1], c)
    router.tick()
    assert router.feedback()[0]["queued"] == 2
    assert router.rebalance(threshold=2) == 2
    assert sorted(router.replica_of(h) for h in hs) == [0, 0, 1, 1]
    router.run_until_idle()
    m = router.metrics()
    assert m["rebalances"] == 2 and m["replicas"] == 2
    assert m["sessions"] == 4 and m["device"] == "cpu"


def test_run_routed_sessions_row():
    """``run_routed_sessions`` serves every session and emits the merged row
    with the distributed axes and the fields the summary prints."""
    m = run_routed_sessions(CFG, replicas=2, slots=2, n_sessions=6,
                            mean_interarrival=2.0, lengths=(6,), seed=0,
                            qos="fifo", rebalance_every=4, max_ticks=4000,
                            backend="reference", device="cpu")
    assert m["sessions"] == 6 and m["replicas"] == 2
    assert m["rebalances"] >= 0 and len(m["per_replica"]) == 2
    for k in ("slots", "frames_per_s", "occupancy", "latency_ms_p50",
              "latency_ms_p99", "load", "mesh", "device"):
        assert k in m, k
    assert m["frames_per_s"] > 0


def _route_script(router, script):
    """Four sessions pinned to replica 0, the rest placed by feedback, one
    tick, a rebalance, then to idle: (placements after open, placements
    after the rebalance, moves, logits per session)."""
    hs = []
    for k, (_, p, clip) in enumerate(script):
        hs.append(router.open_session(priority=p,
                                      replica=0 if k < 4 else None))
        router.submit_clip(hs[-1], clip)
    placed = [router.replica_of(h) for h in hs]
    router.tick()
    moved = router.rebalance(threshold=2)
    after = [router.replica_of(h) for h in hs]
    router.run_until_idle()
    return placed, after, moved, [router.poll(h).logits for h in hs]


def test_router_matches_jax_router(plans):
    """The port's router and the JAX ``ReplicaRouter`` (reference backend,
    the same weights) on one script: the same placements before and after
    the rebalance, the same move count, logits within 1e-3."""
    script = _script(6, [(0, 0, 8), (0, 0, 10), (0, 1, 6), (0, 0, 7),
                         (0, 0, 9)])
    jplan, jbn = plans["jax"]
    jr = JaxRouter.build(JCFG, replicas=2, backend="reference",
                         plans=(jplan,), bn_stats=(jbn,), capacity_tiers=(2,),
                         warm=False)
    plan, bn = plans["reference"]
    tr = ReplicaRouter.build(CFG, replicas=2, backend="reference",
                             plans=(plan,), bn_stats=(bn,),
                             capacity_tiers=(2,), device="cpu")
    want, got = _route_script(jr, script), _route_script(tr, script)
    assert got[:3] == want[:3] and got[2] > 0
    for x, y in zip(got[3], want[3]):
        np.testing.assert_allclose(x, y, **TOL)


# ------------------------------------------------------------ the CLI

def test_serve_sessions_mesh_and_replicas_cli(tmp_path, capsys):
    """``serve sessions --device cpu --mesh 2 --replicas 2`` writes the
    sharded row (mesh 2, collective_ms_per_tick) and the routed row
    (replicas 2, rebalances) per backend; ``--mesh`` with ``--trace`` is
    refused, and ``--mesh 2`` on the default device without CUDA
    raises."""
    bench = tmp_path / "b.json"
    serve.main(["sessions", "--arch", "agcn-2s", "--reduced", "--device",
                "cpu", "--mesh", "2", "--replicas", "2", "--slots", "2",
                "--n-sessions", "4", "--backend", "both", "--bench",
                str(bench)])
    out = capsys.readouterr().out
    assert "sharded: 2 devices, collective cost" in out
    assert "replicas=2 rebalances=" in out
    rows = json.loads(bench.read_text())
    assert sorted((r["backend"], r.get("mesh"), r.get("replicas", 1))
                  for r in rows) == [("cuda", 1, 2), ("cuda", 2, 1),
                                     ("reference", 1, 2), ("reference", 2, 1)]
    for r in rows:
        assert r["sessions"] == 4 and r["device"] == "cpu"
        if r.get("replicas", 1) > 1:
            assert r["rebalances"] >= 0
        else:
            assert r["collective_ms_per_tick"] >= 0.0
    with pytest.raises(ValueError, match="replay takes no mesh"):
        serve.main(["sessions", "--arch", "agcn-2s", "--reduced", "--device",
                    "cpu", "--mesh", "2", "--trace",
                    str(TRACES / "smoke.json"), "--bench", str(bench)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_count"):
            serve.main(["sessions", "--arch", "agcn-2s", "--reduced",
                        "--mesh", "2", "--bench", str(bench)])
