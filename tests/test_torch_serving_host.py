"""The port's serving host layer (``repro_torch.serving``: scheduler,
capacity, SLO controller, saliency gate, traffic model and trace format)
held against the JAX package's classes on the same seeded inputs — the
same tick plans over scripted request sequences under the three QoS
policies, the same controller decisions, bit-equal saliency indices, the
same generated events, clip bytes and trace digests — plus the JAX-free
unit tests of ``test_sessions.py``, ``test_serving.py``,
``test_traffic.py`` and ``test_saliency.py`` run on the port's classes,
and the port's own ``bench_key`` device axis."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from repro.serving import capacity as jcap
from repro.serving import saliency as jsal
from repro.serving import scheduler as jsched
from repro.serving import slo as jslo
from repro.serving import traffic as jtraffic
from repro_torch.serving import capacity as tcap
from repro_torch.serving import saliency as tsal
from repro_torch.serving import scheduler as tsched
from repro_torch.serving import slo as tslo
from repro_torch.serving import traffic as ttraffic
from repro_torch.serving.capacity import CapacityConfig, CapacityManager
from repro_torch.serving.saliency import SaliencyConfig, SaliencyGate
from repro_torch.serving.scheduler import (AdmissionQueue, SessionRequest,
                                           SlabScheduler, bench_key,
                                           bursty_arrivals, poisson_arrivals,
                                           write_bench)
from repro_torch.serving.slo import (CONTROL_POLICIES, SHED_MODES, SloConfig,
                                     SloController)
from repro_torch.serving.traffic import (TRACE_SCHEMA_VERSION, Trace,
                                         TraceEvent, TraceGenerator,
                                         TrafficConfig, event_clip,
                                         generate_trace)

ROOT = pathlib.Path(__file__).resolve().parents[1]
DATA = ROOT / "tests" / "data" / "traces"
V, C = 25, 3


# ---------------------------------------------------------------------------
# the port against the JAX classes
# ---------------------------------------------------------------------------

def _script(seed, n=14):
    """A seeded session script: (sid, arrival, frames, priority, deadline,
    degrade, open) with every clip drawn up front."""
    rng = np.random.default_rng(seed)
    out = []
    for sid in range(n):
        T = int(rng.integers(1, 9))
        clip = rng.standard_normal((T, V, C)).astype(np.float32)
        clip[rng.random(T) < 0.4] = 0.0          # frozen frames for saliency
        out.append(dict(sid=sid, arrival=int(rng.integers(0, 24)), clip=clip,
                        priority=int(rng.integers(0, 3)),
                        deadline=(int(rng.integers(8, 40))
                                  if rng.random() < 0.5 else None),
                        degrade=int(rng.choice([1, 1, 2])),
                        open=bool(rng.random() < 0.3)))
    return out


def _drive(mod, sal_mod, script, qos, saliency, seed):
    """Run one implementation's scheduler over ``script``: returns the list
    of per-tick observations (tick plan fields, finished records)."""
    gate = (sal_mod.SaliencyGate(sal_mod.SaliencyConfig(threshold=1.05))
            if saliency else None)
    sched = mod.SlabScheduler(3, V, C, flush_frames=lambda T: 2 + T % 3,
                              first_logit_delay=3, policy=qos, snap_ring=12,
                              saliency=gate)
    reqs = {}
    rng = np.random.default_rng(seed + 100)
    log = []
    for tick in range(120):
        for s in script:
            if s["arrival"] == tick:
                r = mod.SessionRequest(
                    sid=s["sid"], arrival=tick,
                    clip=None if s["open"] else s["clip"],
                    priority=s["priority"], deadline=s["deadline"],
                    degrade=s["degrade"])
                reqs[s["sid"]] = r
                sched.submit(r)
        for s in script:     # open sessions: one frame per tick, then close
            r = reqs.get(s["sid"])
            if r is not None and s["open"] and not r.is_closed():
                k = r.n_frames()
                if k < len(s["clip"]):
                    r.push_frame(s["clip"][k])
                else:
                    r.close()
        if tick == 30 and sched.busy() <= 2:
            log.append(("resize", sched.resize(2)))
        if tick == 60:
            log.append(("resize", sched.resize(4)))
        tp = sched.tick_inputs(tick, float(tick))
        logits = rng.standard_normal((len(sched.slots), 5))
        done = sched.tick_outputs(tick, logits, float(tick) + 0.5)
        log.append((tick, tp.frames.copy(), tp.valid.copy(), tp.reset.copy(),
                    tp.hold.copy(), list(tp.snapshot), list(tp.restore),
                    tp.snap_order.copy(), tp.rest_order.copy(),
                    [(r.sid, r.frames, r.admitted, r.finished, r.preemptions,
                      r.first_logit_tick, r.degrade, r.frames_skipped,
                      r.logits.tolist()) for r in done]))
    totals = (sched.n_completed, sched.n_missed, sched.preemptions,
              sched.restores, sched.valid_frames, sched.occ_sum,
              sched.frames_skipped, sorted(sched.missed_sids),
              gate.frames_skipped if gate else None)
    return log, totals


@pytest.mark.parametrize("saliency", [False, True], ids=["plain", "saliency"])
@pytest.mark.parametrize("qos", ["fifo", "preempt", "deadline"])
def test_tick_plans_match_jax(qos, saliency):
    """The port's SlabScheduler builds the same TickPlan as the JAX one on
    every tick of a scripted sequence (closed and open sessions, three
    priorities, deadlines, degrade strides, two resizes), finishes the
    same sessions with the same records, and ends on the same counters."""
    script = _script(seed=3)
    got, got_tot = _drive(tsched, tsal, script, qos, saliency, 3)
    want, want_tot = _drive(jsched, jsal, script, qos, saliency, 3)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    assert got_tot == want_tot
    assert got_tot[0] > 0
    if qos == "preempt":
        assert got_tot[2] > 0                   # the script preempts
    if qos == "deadline":
        assert got_tot[1] > 0                   # and misses deadlines


def test_event_buffers_match_jax():
    """``max_events_for``, ``pad_event_orders`` and the sentinel equal the
    JAX ones, and the scheduler's sentinel equals the port engine's."""
    from repro_torch.core.agcn.engine import SNAP_SENTINEL
    assert tsched.SNAP_SENTINEL == jsched.SNAP_SENTINEL == int(SNAP_SENTINEL)
    for S in (1, 2, 3, 8, 9, 64, 256, 1000):
        assert tsched.max_events_for(S) == jsched.max_events_for(S)
    ev = [(1, 4), (0, 2)]
    np.testing.assert_array_equal(tsched.pad_event_orders(ev, 4),
                                  jsched.pad_event_orders(ev, 4))
    with pytest.raises(ValueError):
        tsched.pad_event_orders(ev * 3, 4)


def test_capacity_manager_matches_jax():
    """The same busy/queued sequence gives the same resize decisions and
    event log."""
    rng = np.random.default_rng(0)
    cfgs = [dict(tiers=(2, 4, 8, 16), grow_patience=2, shrink_patience=5,
                 cooldown=3), dict(tiers=(3, 1, 9), grow_patience=1,
                                   shrink_patience=2, cooldown=4)]
    for kw in cfgs:
        a = tcap.CapacityManager(tcap.CapacityConfig(**kw))
        b = jcap.CapacityManager(jcap.CapacityConfig(**kw))
        for tick in range(400):
            demand = int(rng.integers(0, 20)) if tick % 50 < 25 else 1
            busy = min(demand, a.capacity)
            assert a.observe(busy, demand - busy, tick) == b.observe(
                busy, demand - busy, tick)
            assert a.capacity == b.capacity
        assert ([dataclasses.astuple(e) for e in a.events]
                == [dataclasses.astuple(e) for e in b.events])
        assert len(a.events) > 2


@pytest.mark.parametrize("shed_mode", SHED_MODES)
def test_slo_controller_matches_jax(shed_mode):
    """The same latch samples, loads and admission requests give the same
    resize decisions, shedding windows, verdicts and degrade strides."""
    kw = dict(target_p99_ticks=30, window=12, breach_patience=2,
              recover_patience=3, cooldown=3, shed_mode=shed_mode,
              degrade_stride_max=8)
    a = tslo.SloController(tslo.SloConfig(**kw), tiers=(2, 4, 8),
                           latency_floor=7)
    b = jslo.SloController(jslo.SloConfig(**kw), tiers=(2, 4, 8),
                           latency_floor=7)
    rng = np.random.default_rng(1)
    trail = []
    for tick in range(500):
        phase = (tick // 60) % 3
        for _ in range(int(rng.integers(0, 3))):
            p, t = int(rng.integers(0, 2)), int(rng.integers(
                5, 90 if phase == 1 else 35))
            a.record_first_logit(p, t)
            b.record_first_logit(p, t)
        obs = dict(busy=int(rng.integers(0, 9)), queued=int(rng.integers(
            0, 6)), tick=tick, queue_age=int(rng.integers(0, 30)),
            inflight_age=int(rng.integers(0, 35)))
        ra, rb = a.observe(**obs), b.observe(**obs)
        assert ra == rb
        prio = int(rng.integers(0, 2))
        va, vb = a.admit(prio), b.admit(prio)
        assert va == vb
        assert a.degrade_stride_now() == b.degrade_stride_now()
        assert a.measured_p99() == b.measured_p99()
        if tick == 250:
            a.idle_reset()
            b.idle_reset()
        trail.append((ra, va, a.shedding))
    assert ([dataclasses.astuple(e) for e in a.events]
            == [dataclasses.astuple(e) for e in b.events])
    assert (a.shed_rejected, a.shed_degraded, a.shed_windows, a.shed_depth) \
        == (b.shed_rejected, b.shed_degraded, b.shed_windows, b.shed_depth)
    assert a.shed_windows > 0 and len(a.events) > 1


@pytest.mark.parametrize("thresh,cap", [(1.05, 3), (0.8, 1), (1.5, 5)])
def test_saliency_indices_match_jax(thresh, cap):
    """The gate keeps bit-equal raw indices, with equal scorer state and
    counters, on clips with freezes and motion spikes, scored in one go
    and frame by frame."""
    rng = np.random.default_rng(int(thresh * 100) + cap)
    clip = rng.standard_normal((60, V, C)).astype(np.float32)
    clip[10:25] = clip[10]
    clip[40] *= 30.0
    for incremental in (False, True):
        ga = tsal.SaliencyGate(tsal.SaliencyConfig(
            threshold=thresh, max_consecutive_skips=cap))
        gb = jsal.SaliencyGate(jsal.SaliencyConfig(
            threshold=thresh, max_consecutive_skips=cap))
        ra = tsched.SessionRequest(sid=0, arrival=0, clip=None)
        rb = jsched.SessionRequest(sid=0, arrival=0, clip=None)
        for k, f in enumerate(clip):
            ra.push_frame(f)
            rb.push_frame(f)
            if incremental or k == len(clip) - 1:
                ga.extend(ra)
                gb.extend(rb)
        assert ra.sal_kept == rb.sal_kept
        assert dataclasses.astuple(ra.sal_state)[:1] == \
            dataclasses.astuple(rb.sal_state)[:1]
        assert ra.sal_state.mean == rb.sal_state.mean
        assert (ra.sal_state.nm, ra.sal_state.consec) == \
            (rb.sal_state.nm, rb.sal_state.consec)
        assert (ga.frames_scored, ga.frames_skipped) == \
            (gb.frames_scored, gb.frames_skipped)
        assert 0 < len(ra.sal_kept) < len(clip)


_TRAFFIC_CONFIGS = {
    "lognormal": dict(n_sessions=40, mean_interarrival=6.0,
                      diurnal_amplitude=0.7, diurnal_period=120.0,
                      flash_crowd_prob=0.3, flash_crowd_size=3.0,
                      flash_crowd_span=4.0, length_dist="lognormal",
                      mean_frames=12.0, length_sigma=0.5, min_frames=3,
                      max_frames=40, high_priority_ratio=0.25, seed=9),
    "pareto": dict(n_sessions=30, length_dist="pareto", mean_frames=20.0,
                   pareto_alpha=1.8, high_priority_ratio=0.5, seed=4),
    "fixed": dict(n_sessions=16, length_dist="fixed", mean_frames=48.0,
                  min_frames=16, max_frames=96, high_priority_ratio=0.3,
                  seed=7),
    "chip": dict(n_sessions=16, mean_frames=48.0, min_frames=16,
                 max_frames=96, high_priority_ratio=0.3, seed=7),
}


@pytest.mark.parametrize("name", sorted(_TRAFFIC_CONFIGS))
def test_trace_generator_matches_jax(name):
    """The same TrafficConfig draws the same events, in the same order,
    with the same clip bytes and digest, and serializes to the same JSON."""
    kw = _TRAFFIC_CONFIGS[name]
    a = generate_trace(TrafficConfig(**kw), name=name)
    b = jtraffic.generate_trace(jtraffic.TrafficConfig(**kw), name=name)
    assert [e.to_json() for e in a.events] == [e.to_json() for e in b.events]
    assert a.to_json() == b.to_json()
    assert a.digest() == b.digest()
    for e in a.events[:6]:
        assert event_clip(e, V, C).tobytes() == jtraffic.event_clip(
            jtraffic.TraceEvent(**e.to_json()), V, C).tobytes()
    assert TrafficConfig(**kw).rate(37.5) == jtraffic.TrafficConfig(
        **kw).rate(37.5)


def test_load_generators_match_jax():
    """``poisson_arrivals`` and ``bursty_arrivals`` draw the same arrivals,
    priorities and clips as the JAX ones from the same seed."""
    for kind in ("poisson", "bursty"):
        if kind == "poisson":
            a = poisson_arrivals(12, 5.0, (4, 9), V, C, seed=3,
                                 high_priority_ratio=0.4)
            b = jsched.poisson_arrivals(12, 5.0, (4, 9), V, C, seed=3,
                                        high_priority_ratio=0.4)
        else:
            a = bursty_arrivals(12, (4, 9), V, C, burst_size=3, seed=3,
                                high_priority_ratio=0.4)
            b = jsched.bursty_arrivals(12, (4, 9), V, C, burst_size=3,
                                       seed=3, high_priority_ratio=0.4)
        assert [(r.sid, r.arrival, r.priority) for r in a] == \
            [(r.sid, r.arrival, r.priority) for r in b]
        for ra, rb in zip(a, b):
            assert ra.clip.tobytes() == rb.clip.tobytes()


def test_trace_files_are_pinned():
    """The checked-in traces load through the port to the pinned digests:
    the smoke trace to the golden files' ``trace_digest``, the bursty
    diurnal one to ``bed3d1610297``; the saliency golden pins the same
    smoke trace."""
    golden = json.loads((DATA / "golden_smoke.json").read_text())
    sal = json.loads((DATA / "golden_saliency.json").read_text())
    smoke = Trace.load(str(DATA / "smoke.json"))
    assert smoke.digest() == golden["trace_digest"] == sal["trace_digest"]
    assert smoke.name == golden["trace"] == "smoke-v1"
    big = Trace.load(str(DATA / "bursty_diurnal.json"))
    assert big.name == "bursty-diurnal-v1"
    assert big.digest() == "bed3d1610297"
    assert len(big.events) == 64
    jbig = jtraffic.Trace.load(str(DATA / "bursty_diurnal.json"))
    assert big.to_json() == jbig.to_json()


def test_outcome_digest_matches_jax():
    outcomes = [{"tick": t, "admitted": [t], "shed": [{"sid": t,
                 "mode": "reject"}]} for t in range(5)]
    assert ttraffic.outcome_digest(outcomes) == jtraffic.outcome_digest(
        outcomes)


# ---------------------------------------------------------------------------
# bench rows: the device axis
# ---------------------------------------------------------------------------

def test_bench_key_device_axis_and_merge(tmp_path):
    """The port's merge key carries the device (default ``cuda``): a CPU
    row lands beside — not over — the card's row of the same cell, legacy
    defaults key like the JAX ones otherwise, and re-writing a key
    replaces only its row."""
    row = {"backend": "cuda", "slots": 4, "qos": "fifo"}
    assert bench_key(row) == ("cuda", "cuda", 4, "fifo", "fixed", "poisson",
                              1, 1, "demand", "", "ntu25", False, 0.0)
    assert bench_key(row) == bench_key({**row, "device": "cuda"})
    assert bench_key(row) != bench_key({**row, "device": "cpu"})
    assert bench_key(row)[:1] + bench_key(row)[2:] == jsched.bench_key(row)
    assert tsched.DEFAULT_BENCH_PATH == "BENCH_torch_sessions.json"
    path = str(tmp_path / "BENCH_torch_sessions.json")
    card = {**row, "device": "cuda", "frames_per_s": 900.0,
            "records": ["dropme"], "outcomes": [1]}
    cpu = {**row, "device": "cpu", "frames_per_s": 50.0}
    write_bench([card], path)
    write_bench([cpu], path)
    rows = json.loads(open(path).read())
    assert [r["device"] for r in rows] == ["cuda", "cpu"]
    assert "records" not in rows[0] and "outcomes" not in rows[0]
    write_bench([{**cpu, "frames_per_s": 51.0}], path)
    rows = json.loads(open(path).read())
    assert len(rows) == 2 and rows[0]["frames_per_s"] == 900.0
    assert rows[1]["frames_per_s"] == 51.0


def test_write_bench_elastic_rows_do_not_collide(tmp_path):
    """Capacity and load are merge axes: an elastic run, its fixed burst
    baseline and a steady-state row of the same (backend, slots, qos)
    coexist; an unreadable file starts afresh."""
    path = str(tmp_path / "b.json")
    with open(path, "w") as f:
        f.write("{not json")
    legacy = {"backend": "reference", "slots": 2, "qos": "fifo"}
    elastic = {**legacy, "capacity": "elastic:2,4,8", "load": "burst"}
    fixed_burst = {**legacy, "capacity": "fixed", "load": "burst"}
    write_bench([legacy, elastic, fixed_burst], path)
    assert len(json.loads(open(path).read())) == 3
    assert bench_key(elastic) != bench_key(fixed_burst) != bench_key(legacy)


# ---------------------------------------------------------------------------
# the JAX-free unit tests, on the port's classes
# ---------------------------------------------------------------------------

def _mini_sched(slots=2, flush=3, first=2, **kw):
    return SlabScheduler(slots, V, C, flush_frames=lambda T: flush,
                         first_logit_delay=first, **kw)


def test_scheduler_admission_queueing_and_recycling():
    sched = _mini_sched(slots=1, flush=2)
    clip = np.zeros((3, V, C), np.float32)
    sched.submit(SessionRequest(sid=0, arrival=0, clip=clip))
    sched.submit(SessionRequest(sid=1, arrival=0, clip=clip))
    logits = np.zeros((1, 4))
    done_at = {}
    for tick in range(12):
        if sched.idle():
            break
        tp = sched.tick_inputs(tick, 0.0)
        assert tp.reset[0] == (tick in (0, 5))
        assert tp.valid[0] == (tick in (0, 1, 2, 5, 6, 7))
        assert not tp.hold.any()
        for rec in sched.tick_outputs(tick, logits, 0.0):
            done_at[rec.sid] = tick
    assert done_at == {0: 4, 1: 9}
    assert [r.sid for r in sched.completed] == [0, 1]
    assert sched.completed[1].admitted == 5


def test_scheduler_counts_valid_frames_and_occupancy():
    sched = _mini_sched(slots=2, flush=1)
    sched.submit(SessionRequest(sid=0, arrival=0,
                                clip=np.zeros((2, V, C), np.float32)))
    for tick in range(3):
        sched.tick_inputs(tick, 0.0)
        sched.tick_outputs(tick, np.zeros((2, 4)), 0.0)
    assert sched.valid_frames == 2
    assert sched.occupancy_samples == [0.5, 0.5, 0.5]


def test_admission_queue_strict_priority_arrival_order():
    q = AdmissionQueue()
    clip = np.zeros((1, V, C), np.float32)
    for sid, prio, arr in [(0, 0, 0), (1, 1, 5), (2, 1, 3), (3, 0, 1),
                           (4, 2, 9), (5, 0, 0)]:
        q.push(SessionRequest(sid=sid, arrival=arr, clip=clip,
                              priority=prio))
    assert q.get(2).sid == 2 and q.get(42) is None
    assert q.remove(3).sid == 3 and q.remove(3) is None
    assert [q.pop().sid for _ in range(len(q))] == [4, 2, 1, 0, 5]
    assert q.peek_priority() is None and q.peek() is None


def test_deadline_policy_drops_expected():
    sched = _mini_sched(slots=1, flush=2, policy="deadline")
    clip = np.zeros((3, V, C), np.float32)
    sched.submit(SessionRequest(sid=0, arrival=0, clip=clip, deadline=10))
    sched.submit(SessionRequest(sid=1, arrival=0, clip=clip, deadline=3))
    for tick in range(20):
        if tick == 6:
            sched.submit(SessionRequest(sid=2, arrival=6, clip=clip,
                                        deadline=8))
        if tick > 6 and sched.idle():
            break
        sched.tick_inputs(tick, 0.0)
        sched.tick_outputs(tick, np.zeros((1, 4)), 0.0)
    assert [r.sid for r in sched.completed] == [0]
    assert sorted(r.sid for r in sched.missed) == [1, 2]


def test_first_logit_sentinel_and_latch():
    """A session too short to reach the first-logit delay keeps the -1.0
    sentinel; a short one that reaches it latches at rel == delay - 1."""
    sched = _mini_sched(slots=1, flush=0, first=5)
    sched.submit(SessionRequest(sid=0, arrival=0,
                                clip=np.zeros((2, V, C), np.float32)))
    for tick in range(4):
        sched.tick_inputs(tick, now=1.0)
        sched.tick_outputs(tick, np.zeros((1, 4)), now=1.0)
    assert sched.idle() and sched.completed[0].wall_first_logit == -1.0
    sched = SlabScheduler(1, V, C, flush_frames=lambda T: 4 - T,
                          first_logit_delay=3)
    sched.submit(SessionRequest(sid=0, arrival=0,
                                clip=np.zeros((1, V, C), np.float32)))
    for tick in range(6):
        sched.tick_inputs(tick, now=float(tick))
        sched.tick_outputs(tick, np.zeros((1, 4)), now=float(tick))
    assert sched.completed[0].wall_first_logit == 2.0


def test_scheduler_resize_compacts_and_validates():
    sched = _mini_sched(slots=4, flush=1, first=1)
    for sid in range(3):
        sched.submit(SessionRequest(sid=sid, arrival=0,
                                    clip=np.zeros((3, V, C), np.float32)))
    sched.tick_inputs(0, 0.0)
    sched.tick_outputs(0, np.zeros((4, 8)), 0.0)
    sched.slots[1] = None
    assert sched.resize(2) == {0: 0, 2: 1}
    assert sched.busy() == 2 and len(sched.slots) == 2
    with pytest.raises(ValueError):
        sched.resize(1)


def test_scheduler_holds_starved_open_session():
    sched = _mini_sched(slots=1, flush=2, first=1)
    req = SessionRequest(sid=0, arrival=0)
    sched.submit(req)
    tp = sched.tick_inputs(0, 0.0)
    assert tp.hold[0] and not tp.valid[0]
    sched.tick_outputs(0, np.zeros((1, 8)), 0.0)
    assert sched.slots[0].rel == 0
    req.push_frame(np.ones((V, C), np.float32))
    tp = sched.tick_inputs(1, 0.0)
    assert tp.valid[0] and not tp.hold[0]
    sched.tick_outputs(1, np.zeros((1, 8)), 0.0)
    req.close()
    done = []
    for tick in range(2, 6):
        tp = sched.tick_inputs(tick, 0.0)
        assert not tp.hold[0] and not tp.valid[0]
        done += sched.tick_outputs(tick, np.zeros((1, 8)), 0.0)
    assert [r.sid for r in done] == [0] and done[0].frames == 1
    with pytest.raises(ValueError):
        req.push_frame(np.ones((V, C), np.float32))


def test_tickplan_tuple_unpack_deprecated():
    sched = _mini_sched(slots=1)
    sched.submit(SessionRequest(sid=0, arrival=0,
                                clip=np.zeros((2, V, C), np.float32)))
    tp = sched.tick_inputs(0, 0.0)
    with pytest.warns(DeprecationWarning, match="TickPlan"):
        frames, valid, reset = tp
    np.testing.assert_array_equal(frames, tp.frames)


def test_sweep_expired_and_ring_allocator():
    """sweep_expired drops expired queued sessions, is idempotent and a
    no-op outside the deadline policy; the snapshot-ring allocator hands
    out and takes back rows and raises when exhausted."""
    sched = _mini_sched(slots=1, flush=1, first=1, policy="deadline")
    clip = np.zeros((2, V, C), np.float32)
    for sid in range(4):
        sched.submit(SessionRequest(sid=sid, arrival=0, clip=clip,
                                    deadline=2))
    sched.submit(SessionRequest(sid=9, arrival=0, clip=clip, deadline=50))
    assert sched.sweep_expired(5) == 4 and len(sched.queue) == 1
    assert sched.sweep_expired(5) == 0 and sched.n_missed == 4
    fifo = _mini_sched(slots=1, flush=1, first=1, snap_ring=2)
    fifo.submit(SessionRequest(sid=0, arrival=0, clip=clip, deadline=-1))
    assert fifo.sweep_expired(10) == 0 and len(fifo.queue) == 1
    rows = {fifo.ring_adopt(7), fifo.ring_adopt(8)}
    assert rows == {0, 1}
    with pytest.raises(RuntimeError, match="exhausted"):
        fifo.ring_adopt(9)
    assert fifo.ring_release(7) in rows
    with pytest.raises(RuntimeError, match="snapshot ring"):
        _mini_sched().ring_adopt(1)


def test_scheduler_bounded_memory_soak():
    """3k sessions (half with hopeless deadlines) through a retain=64
    scheduler keep every record structure bounded while the lifetime
    aggregates count them all."""
    retain = 64
    sched = SlabScheduler(8, V, C, flush_frames=lambda T: 0,
                          first_logit_delay=1, policy="deadline",
                          retain=retain)
    clip = np.zeros((1, V, C), np.float32)
    logits = np.zeros((8, 4))
    tick = submitted = 0
    while submitted < 3000 or not sched.idle():
        while submitted < 3000 and len(sched.queue) < 16:
            dl = tick - 1 if submitted % 2 == 0 else tick + 100
            sched.submit(SessionRequest(sid=submitted, arrival=tick,
                                        clip=clip, deadline=dl))
            submitted += 1
        sched.tick_inputs(tick, 0.0)
        sched.tick_outputs(tick, logits, 0.0)
        tick += 1
    assert sched.n_completed + sched.n_missed == 3000
    assert len(sched.completed) <= retain and len(sched.missed) <= retain
    assert len(sched.missed_sids) <= retain
    assert len(sched.occupancy_samples) <= retain


def test_capacity_manager_hysteresis_never_thrashes():
    cm = CapacityManager(CapacityConfig(tiers=(2, 4, 8), grow_patience=1,
                                        shrink_patience=1, cooldown=3))
    for tick in range(60):
        demand = 5 if tick % 2 == 0 else 1
        busy = min(demand, cm.capacity)
        cm.observe(busy, demand - busy, tick)
    for a, b in zip(cm.events, cm.events[1:]):
        assert b.tick - a.tick >= 3
    cm = CapacityManager(CapacityConfig(tiers=(2, 4, 8), grow_patience=2,
                                        shrink_patience=4, cooldown=4))
    for tick in range(30):
        cm.observe(min(6, cm.capacity), 6 - min(6, cm.capacity), tick)
    assert [e.new for e in cm.events] == [8]
    for tick in range(30, 60):
        cm.observe(1, 0, tick)
    assert [e.new for e in cm.events] == [8, 4, 2]


def test_capacity_manager_validation():
    with pytest.raises(ValueError):
        CapacityConfig(tiers=())
    with pytest.raises(ValueError):
        CapacityConfig(tiers=(2, 2))
    with pytest.raises(ValueError):
        CapacityConfig(tiers=(2, 4), cooldown=1)
    with pytest.raises(ValueError):
        CapacityManager(CapacityConfig(tiers=(2, 4)), start_tier=3)
    cm = CapacityManager(CapacityConfig(tiers=(8, 2, 4)), start_tier=4)
    assert cm.capacity == 4 and cm.tiers == (2, 4, 8)


def _controller(**kw):
    base = dict(target_p99_ticks=50, window=16, breach_patience=2,
                recover_patience=3, cooldown=3, shed_mode="reject")
    base.update(kw)
    return SloController(SloConfig(**base), tiers=(2, 4), start_tier=2)


def test_slo_config_validation():
    for bad in (dict(target_p99_ticks=0), dict(shed_mode="drop"),
                dict(degrade_stride=1), dict(cooldown=2),
                dict(shrink_margin=0.0),
                dict(degrade_stride=4, degrade_stride_max=2)):
        with pytest.raises(ValueError):
            SloConfig(**bad)
    assert CONTROL_POLICIES == ("demand", "slo")
    assert SHED_MODES == ("reject", "degrade")


def test_slo_grows_then_sheds_then_recovers_then_shrinks():
    c = _controller()
    for p in (1, 1, 1):
        c.record_first_logit(p, 80)
    t, target = 0, None
    while target is None:
        target = c.observe(busy=2, queued=3, tick=t)
        t += 1
    assert target == 4 and not c.shedding
    t += c.config.cooldown
    while not c.shedding:
        c.observe(busy=4, queued=3, tick=t)
        t += 1
    assert c.admit(0) == "reject" and c.admit(1) == "accept"
    c._samples.clear()
    for _ in range(8):
        c.record_first_logit(1, 10)
    while c.shedding:
        assert c.observe(busy=1, queued=0, tick=t) is None
        t += 1
    target = None
    while target is None:
        target = c.observe(busy=1, queued=0, tick=t)
        t += 1
    assert [(e.old, e.new) for e in c.events] == [(2, 4), (4, 2)]


def test_slo_anticipates_breach_and_prefers_protected_class():
    c = SloController(SloConfig(target_p99_ticks=50, breach_patience=2,
                                cooldown=3), tiers=(2, 4), start_tier=2,
                      latency_floor=41)
    assert c.breached(queue_age=10) and not c.breached(queue_age=9)
    c.observe(busy=2, queued=1, tick=0, queue_age=10)
    assert c.observe(busy=2, queued=1, tick=1, queue_age=11) == 4
    c = _controller()
    for _ in range(4):
        c.record_first_logit(0, 900)
    c.record_first_logit(1, 30)
    assert c.measured_p99() == 30.0
    assert c.measured_p99(protected_only=False) == 900.0
    c.shedding = True
    c.idle_reset()
    assert c.measured_p99() is None and c.admit(0) == "accept"


def test_saliency_gate_contract():
    """Frame 0 always kept, the consecutive-skip cap bounds a freeze,
    motion spikes are kept, and the kept list composes with the degrade
    stride through ``eff_frames``."""
    with pytest.raises(ValueError):
        SaliencyConfig(threshold=0.0)
    with pytest.raises(ValueError):
        SaliencyConfig(max_consecutive_skips=0)
    clip = np.ones((13, V, C), np.float32)
    gate = SaliencyGate(SaliencyConfig(threshold=1.0,
                                       max_consecutive_skips=3))
    req = SessionRequest(sid=0, arrival=0, clip=clip)
    gate.extend(req)
    assert req.sal_kept == [0, 4, 8, 12]
    assert gate.frames_skipped == 9 and req.eff_frames() == 4
    req.degrade = 2
    assert req.eff_frames() == 2
    spike = np.zeros((9, V, C), np.float32)
    spike[5] = 100.0
    r2 = SessionRequest(sid=1, arrival=0, clip=spike)
    SaliencyGate(SaliencyConfig(threshold=1.0,
                                max_consecutive_skips=8)).extend(r2)
    assert {5, 6} <= set(r2.sal_kept)
    assert not {1, 2, 3, 4} & set(r2.sal_kept)


def test_trace_roundtrip_and_schema():
    trace = generate_trace(TrafficConfig(**_TRAFFIC_CONFIGS["lognormal"]),
                           name="rt")
    back = Trace.from_json(trace.to_json())
    assert back == trace and back.events == trace.events
    bad = json.loads(trace.to_json())
    bad["version"] = TRACE_SCHEMA_VERSION + 1
    with pytest.raises(ValueError, match="schema version"):
        Trace.from_json(json.dumps(bad))
    e = TraceEvent(sid=3, arrival=5, frames=7, priority=1, clip_seed=11,
                   deadline=40)
    assert TraceEvent.from_json(e.to_json()) == e
    arr = [ev.arrival for ev in trace.events]
    assert arr == sorted(arr)
    assert [ev.sid for ev in trace.events] == list(range(len(arr)))


def test_interleaved_generators_reproduce_solo():
    ca = TrafficConfig(**_TRAFFIC_CONFIGS["lognormal"])
    cb = dataclasses.replace(ca, seed=2, mean_frames=20.0)
    solo_a, solo_b = list(TraceGenerator(ca)), list(TraceGenerator(cb))
    ga, gb = TraceGenerator(ca), TraceGenerator(cb)
    inter = [(next(ga), next(gb)) for _ in range(ca.n_sessions)]
    assert [a for a, _ in inter] == solo_a
    assert [b for _, b in inter] == solo_b


def test_cross_process_determinism_without_jax():
    """A fresh interpreter where jax and repro cannot be imported draws
    the same trace digest from the same config."""
    cfg = TrafficConfig(**_TRAFFIC_CONFIGS["pareto"])
    code = ("import sys\n"
            "sys.modules['jax'] = None\nsys.modules['repro'] = None\n"
            "from repro_torch.serving.traffic import (TrafficConfig,\n"
            "    generate_trace)\n"
            f"cfg = TrafficConfig(**{dataclasses.asdict(cfg)!r})\n"
            "print(generate_trace(cfg).digest())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == generate_trace(cfg).digest()
