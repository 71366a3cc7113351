"""Port session slab against the JAX reference engine on the reduced
config: the slab equals independent streams, ``reset_slots`` isolates a
slot, snapshot -> foreign traffic -> restore resumes, the snapshot ring's
sentinel-padded scatters equal JAX's exactly (data movement), ``hold``
freezes a slot, and the two-stream slab step and fused tick equal JAX's
(``backend="reference"``) over a seeded event script, logits and slab
state within atol=rtol=1e-3.  Mid-stream slabs move between the two
frameworks through ``bridge.stream_state_from_numpy``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_get_config
from repro.core.agcn import engine as jengine
from repro.core.agcn import model as jmodel
from repro.core.pruning.plan import build_prune_plan as jax_build_prune_plan
from repro.train.steps import make_gcn_fused_tick as jax_fused_tick
from repro.train.steps import make_gcn_slab_step as jax_slab_step
from repro_torch.bridge import (params_from_numpy, stream_state_from_numpy,
                                stream_state_to_numpy)
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.kernels import cavity_tconv as ct
from repro_torch.train.steps import make_gcn_fused_tick, make_gcn_slab_step

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)
V, C = CFG.gcn_joints, CFG.gcn_in_channels
TOL = dict(atol=1e-3, rtol=1e-3)
SENT = int(engine.SNAP_SENTINEL)


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
        (2, CFG.gcn_frames, V, C)).astype(np.float32)


@pytest.fixture(scope="module")
def prune_plans(jparams):
    sw = [np.asarray(b["Wk"]) for b in jparams[0]["blocks"]]
    fracs = [1.0, 0.5, 0.5, 0.5]
    return (build_prune_plan(sw, CFG.gcn_channels, fracs, "cav-70-1",
                             input_skip=2),
            jax_build_prune_plan(sw, JCFG.gcn_channels, fracs, "cav-70-1",
                                 input_skip=2))


def _tplan(tparams, prune_plans, backend, i=0):
    return engine.build_execution_plan(tparams[i], CFG, prune_plans[0],
                                       quant=True, backend=backend)


def _jplan(jparams, prune_plans, i=0):
    return jengine.build_execution_plan(jparams[i], JCFG, prune_plans[1],
                                        quant=True)


def _assert_tree_close(got, want, exact=False, path="state"):
    if want is None:
        assert got is None, path
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _assert_tree_close(got[k], want[k], exact, f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree_close(g, w, exact, f"{path}[{i}]")
    else:
        w = np.asarray(want)
        assert got.dtype == w.dtype and got.shape == w.shape, path
        if exact or w.dtype != np.float32:
            np.testing.assert_array_equal(got, w, err_msg=path)
        else:
            np.testing.assert_allclose(got, w, **TOL, err_msg=path)


def _slot_trees_equal(a, b, slot):
    for la, lb in zip(jax.tree.leaves(stream_state_to_numpy(a)),
                      jax.tree.leaves(stream_state_to_numpy(b))):
        if la.ndim and la.shape[0] > slot and la.shape == lb.shape:
            np.testing.assert_array_equal(la[slot], lb[slot])


# ------------------------------------------------------------ slab parity

def _independent(plan, bn, clip):
    """One session alone: batch-1 step_frame over its clip and drain."""
    state = engine.init_stream_state(plan, 1, bn_stats=bn)
    T = clip.shape[0]
    for r in range(T + engine.stream_flush_frames(plan, T)):
        frame = clip[None, r] if r < T else torch.zeros(1, V, C)
        state, logits = engine.step_frame(plan, state, frame, r < T)
    return logits[0]


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_slab_matches_independent_streams(tparams, x, prune_plans, backend):
    """Staggered sessions of different lengths through a 2-slot slab, one
    admitted into a recycled slot, equal independent single-stream runs."""
    plan = _tplan(tparams, prune_plans, backend)
    bn = engine.collect_bn_stats(plan, torch.from_numpy(x))
    rng = np.random.default_rng(3)
    clips = [torch.from_numpy(rng.standard_normal((T, V, C)).astype(
        np.float32)) for T in (24, 14, 10)]
    arrival = (0, 4, 9)
    slab = engine.init_session_slab(plan, 2, bn_stats=bn)
    slot_of, pos, got, queue = {}, {}, {}, [0, 1, 2]
    for tick in range(300):
        free = [s for s in (0, 1) if s not in slot_of.values()]
        reset = np.zeros(2, bool)
        while queue and free and arrival[queue[0]] <= tick:
            sid = queue.pop(0)
            slot_of[sid], pos[sid] = free.pop(0), 0
            reset[slot_of[sid]] = True
        if not slot_of and not queue:
            break
        frames = torch.zeros(2, V, C)
        valid = np.zeros(2, bool)
        for sid, s in slot_of.items():
            if pos[sid] < len(clips[sid]):
                frames[s], valid[s] = clips[sid][pos[sid]], True
        slab, logits = engine.step_frames(plan, slab, frames, valid, reset)
        for sid in list(slot_of):
            pos[sid] += 1
            T = len(clips[sid])
            if pos[sid] == T + engine.stream_flush_frames(plan, T):
                got[sid] = logits[slot_of.pop(sid)]
    assert sorted(got) == [0, 1, 2]
    for sid, clip in enumerate(clips):
        torch.testing.assert_close(got[sid], _independent(plan, bn, clip),
                                   **TOL)


def test_reset_slots_isolates(tparams, x, prune_plans):
    plan = _tplan(tparams, prune_plans, "cuda")
    xt = torch.from_numpy(x)
    slab = engine.init_session_slab(plan, 2, x_calib=xt)
    for r in range(8):
        slab, _ = engine.step_frames(plan, slab, xt[:, r], [True, True])
    out = engine.reset_slots(slab, torch.tensor([False, True]))
    _slot_trees_equal(out, slab, 0)
    for leaf in jax.tree.leaves(stream_state_to_numpy(
            engine.snapshot_slots(out, 1))):
        assert not leaf.any()
    assert int(slab.t_raw[1]) == 8           # the input slab is untouched
    assert out.bn_stats is slab.bn_stats


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_snapshot_restore_roundtrip(tparams, x, prune_plans, backend):
    """snapshot -> evict -> foreign traffic in the slot -> restore ->
    resume equals the uninterrupted session; the bystander slot is
    bit-identical throughout."""
    plan = _tplan(tparams, prune_plans, backend)
    xt = torch.from_numpy(x)
    slab = engine.init_session_slab(plan, 2, x_calib=xt)
    for r in range(10):
        slab, _ = engine.step_frames(plan, slab, xt[:, r], [True, True])
    snap = engine.snapshot_slots(slab, 0)
    ref = slab
    foreign = slab
    for r in range(6):     # a foreign session in slot 0, admitted by reset
        foreign, _ = engine.step_frames(
            plan, foreign, torch.stack([xt[1, 20 + r], xt[1, 10 + r]]),
            [True, True], reset=[r == 0, False])
    restored = engine.restore_slots(foreign, torch.tensor(0), snap)
    ref_plain = ref
    for r in range(6):     # the bystander (slot 1) ran on meanwhile
        ref_plain, _ = engine.step_frames(plan, ref_plain, xt[:, 10 + r],
                                          [True, True])
    _slot_trees_equal(restored, ref_plain, 1)
    _slot_trees_equal(restored, ref, 0)
    for r in range(10, 24):
        ref, want = engine.step_frames(plan, ref, xt[:, r], [True, True])
        restored, got = engine.step_frames(
            plan, restored, torch.stack([xt[0, r], xt[1, r + 6]]),
            [True, True])
        torch.testing.assert_close(got[0], want[0], **TOL)


def test_hold_freezes_state_and_repeats_logits(tparams, x, prune_plans):
    plan = _tplan(tparams, prune_plans, "cuda")
    xt = torch.from_numpy(x)
    slab = engine.init_session_slab(plan, 2, x_calib=xt)
    for r in range(16):
        slab, prev = engine.step_frames(plan, slab, xt[:, r], [True, True])
    held, logits = engine.step_frames(plan, slab, xt[:, 16], [True, True],
                                      hold=torch.tensor([True, False]))
    _slot_trees_equal(held, slab, 0)
    assert torch.equal(logits[0], prev[0])
    assert int(held.t_raw[1]) == 17 and int(held.t_raw[0]) == 16
    _, free_run = engine.step_frames(plan, slab, xt[:, 16], [True, True])
    assert torch.equal(logits[1], free_run[1])


# ----------------------------------------------------- snapshot ring vs JAX

@pytest.fixture(scope="module")
def jax_mid_slab(jparams, prune_plans, x):
    """A JAX reference slab of 3 slots, 12 frames into seeded traffic."""
    plan = _jplan(jparams, prune_plans)
    slab = jengine.init_session_slab(plan, 3, x_calib=jnp.asarray(x))
    step = jax.jit(jengine.step_frames)
    rng = np.random.default_rng(7)
    for r in range(12):
        valid = jnp.asarray(rng.random(3) < 0.8)
        slab, _ = step(plan, slab,
                       jnp.asarray(rng.standard_normal((3, V, C)),
                                   jnp.float32), valid)
    return slab


ORDERS = {
    # (snapshot order, restore order), rows of (slot, ring row)
    "one_each": ([[1, 2], [SENT, SENT], [SENT, SENT]],
                 [[0, 0], [SENT, SENT], [SENT, SENT]]),
    "same_tick": ([[2, 1], [0, 3], [SENT, SENT]],       # 2 -> row 1 -> 0
                  [[0, 1], [SENT, SENT], [2, 3]]),      # and 0 <-> 2
    "all_sentinel": ([[SENT, SENT]] * 3, [[SENT, SENT]] * 3),
    "sentinel_half": ([[SENT, 0], [1, SENT]],           # clamped, dropped
                      [[SENT, 1], [2, SENT]]),
}


@pytest.mark.parametrize("case", list(ORDERS))
def test_snapshot_ring_matches_jax(jax_mid_slab, case):
    jslab = jax_mid_slab
    jring = jengine.init_snapshot_ring(jslab, 4)
    # a ring with content: every row holds some slot's state
    jring = jengine.snapshot_to_ring(jslab, jring,
                                     jnp.asarray([[0, 0], [1, 1], [2, 2],
                                                  [1, 3]], jnp.int32))
    tslab = stream_state_from_numpy(jax.tree.map(np.asarray, jslab), "cpu")
    tring = stream_state_from_numpy(jax.tree.map(np.asarray, jring), "cpu")
    assert isinstance(tslab, engine.StreamState) and isinstance(tring, dict)
    snap, rest = (np.asarray(o, np.int32) for o in ORDERS[case])
    want_ring = jengine.snapshot_to_ring(jslab, jring, jnp.asarray(snap))
    want_slab = jengine.restore_from_ring(jslab, want_ring,
                                          jnp.asarray(rest))
    got_ring = engine.snapshot_to_ring(tslab, tring, torch.from_numpy(snap))
    got_slab = engine.restore_from_ring(tslab, got_ring,
                                        torch.from_numpy(rest))
    _assert_tree_close(stream_state_to_numpy(got_ring),
                       jax.tree.map(np.asarray, want_ring), exact=True)
    want = jax.tree.map(np.asarray, want_slab)
    _assert_tree_close(stream_state_to_numpy(got_slab),
                       {f: getattr(want, f) for f in
                        ("t_raw", "blocks", "pool_ring", "pool_sum",
                         "pool_t", "bn_stats", "rfc")}, exact=True)
    if case == "all_sentinel":
        _assert_tree_close(stream_state_to_numpy(got_ring),
                           jax.tree.map(np.asarray, jring), exact=True)


def test_bridge_roundtrip_is_exact(jax_mid_slab):
    want = jax.tree.map(np.asarray, jax_mid_slab)
    back = stream_state_to_numpy(stream_state_from_numpy(want, "cpu"))
    rebuilt = jengine.StreamState(**back)
    for a, b in zip(jax.tree.leaves(rebuilt), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ----------------------------------------------- the serving tick vs JAX

def _port_slab(jslab, tplan):
    """A JAX reference slab handed to the port; a ``cuda`` plan also gets
    the (zeroed) RFC carry the reference slab does not have."""
    st = stream_state_from_numpy(jax.tree.map(np.asarray, jslab), "cpu")
    if tplan.static.use_rfc:
        st.rfc = engine.init_stream_state(tplan, st.t_raw.shape[0],
                                          bn_stats=st.bn_stats).rfc
    return st


def _two_stream(jparams, tparams, prune_plans, backend):
    tplans = tuple(_tplan(tparams, prune_plans, backend, i) for i in (0, 1))
    jplans = tuple(_jplan(jparams, prune_plans, i) for i in (0, 1))
    return tplans, jplans


def _jax_slabs(jplans, x, slots):
    return tuple(jengine.init_session_slab(
        p, slots, x_calib=jnp.asarray(xx))
        for p, xx in zip(jplans, (x, np.asarray(jmodel.bone_stream(
            jnp.asarray(x))))))


def test_slab_step_matches_jax(jparams, tparams, prune_plans, x):
    """make_gcn_slab_step (two streams, reset and hold masks) equals JAX's
    on a slab handed over mid-stream."""
    S = 3
    tplans, jplans = _two_stream(jparams, tparams, prune_plans, "cuda")
    jslabs = _jax_slabs(jplans, x, S)
    jstep = jax.jit(jax_slab_step(JCFG))
    tstep = make_gcn_slab_step(CFG)
    rng = np.random.default_rng(11)
    tslabs = None
    for tick in range(14):
        if tick == 4:          # hand the slabs over mid-stream
            tslabs = tuple(_port_slab(s, p) for s, p in zip(jslabs, tplans))
        frames = rng.standard_normal((S, V, C)).astype(np.float32)
        valid = rng.random(S) < 0.8
        reset = rng.random(S) < 0.15
        hold = rng.random(S) < 0.15
        jslabs, jlogits = jstep(jplans, jslabs, jnp.asarray(frames),
                                jnp.asarray(valid), jnp.asarray(reset),
                                jnp.asarray(hold))
        if tslabs is not None:
            tslabs, logits = tstep(tplans, tslabs, torch.from_numpy(frames),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(reset),
                                   torch.from_numpy(hold))
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       **TOL, err_msg=f"tick {tick}")


def _event_script(rng, S, R, E, ticks):
    """Seeded ticks of (frames, valid, reset, hold, snap, rest): distinct
    slots and ring rows within an order, the rest sentinel padding; some
    ticks snapshot and restore the same row."""
    script = []
    for tick in range(ticks):
        orders = []
        for _ in range(2):
            k = int(rng.integers(0, 3)) if rng.random() < 0.5 else 0
            o = np.full((E, 2), SENT, np.int32)
            o[:k, 0] = rng.choice(S, k, replace=False)
            o[:k, 1] = rng.choice(R, k, replace=False)
            orders.append(rng.permutation(o))
        if tick % 9 == 5:                    # same-tick snapshot -> restore
            orders[0][0] = [0, R - 1]
            orders[1][0] = [S - 1, R - 1]
        script.append((rng.standard_normal((S, V, C)).astype(np.float32),
                       rng.random(S) < 0.8, rng.random(S) < 0.1,
                       rng.random(S) < 0.1, *orders))
    return script


@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_fused_tick_matches_jax_event_script(jparams, tparams, prune_plans,
                                             x, backend):
    """40 ticks of the two-stream fused tick (admissions, holds, snapshot
    and restore events padded by SNAP_SENTINEL) equal JAX's, logits at
    every tick and slabs and rings at the end."""
    S, R, E = 3, 4, 3
    tplans, jplans = _two_stream(jparams, tparams, prune_plans, backend)
    jslabs = _jax_slabs(jplans, x, S)
    jrings = tuple(jengine.init_snapshot_ring(s, R) for s in jslabs)
    tslabs = tuple(_port_slab(s, p) for s, p in zip(jslabs, tplans))
    trings = tuple(engine.init_snapshot_ring(s, R) for s in tslabs)
    jtick = jax.jit(jax_fused_tick(JCFG))
    ttick = make_gcn_fused_tick(CFG)
    for tick, ev in enumerate(_event_script(np.random.default_rng(5), S, R,
                                            E, 40)):
        jslabs, jlogits, jrings = jtick(jplans, jslabs,
                                        *map(jnp.asarray, ev), jrings)
        tslabs, logits, trings = ttick(tplans, tslabs,
                                       *map(torch.from_numpy, ev), trings)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   **TOL, err_msg=f"tick {tick}")
    for ts, js, tr, jr in zip(tslabs, jslabs, trings, jrings):
        want = jax.tree.map(np.asarray, js)
        assert (ts.rfc is not None) == (backend == "cuda")
        assert want.rfc is None     # the reference slab carries no RFC
        got = stream_state_to_numpy(ts)
        got.pop("rfc")
        _assert_tree_close(got, {f: getattr(want, f) for f in
                                 ("t_raw", "blocks", "pool_ring", "pool_sum",
                                  "pool_t", "bn_stats")})
        _assert_tree_close(
            {k: v for k, v in stream_state_to_numpy(tr).items()
             if k != "rfc"},
            {k: v for k, v in jax.tree.map(np.asarray, jr).items()
             if k != "rfc"})


class _HostSyncOps(TorchDispatchMode):
    """Records the operators that read a tensor's value on the host
    (``.item()``, ``.tolist()``, ``bool(t)``) or give a data-dependent
    shape (boolean-mask indexing, ``nonzero``): on a card, each syncs."""

    SYNCING = ("_local_scalar_dense", "is_nonzero", "nonzero",
               "masked_select", "unique")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.__name__.split(".")[0]
        if name in self.SYNCING:
            self.seen.append(func.__name__)
        if name in ("index", "index_put", "index_put_") and any(
                torch.is_tensor(i) and i.dtype in (torch.bool, torch.uint8)
                for i in args[1] if i is not None):
            self.seen.append(func.__name__ + " with a boolean mask")
        return func(*args, **(kwargs or {}))


def test_fused_tick_reads_nothing_back_to_the_host(tparams, prune_plans, x,
                                                   monkeypatch):
    """The ``cuda`` path of the fused tick, with every event kind, calls no
    operator that reads device values on the host.  The streaming kernel's
    plain version (which reads its taps on the host) is swapped for a
    stand-in of its shape; on a card the kernel takes its place and
    chip_smoke checks the same tick under ``set_sync_debug_mode``."""
    def stand_in(ring, head, wp, taps, slot_col, bias):
        return ring.new_zeros((ring.shape[0], ring.shape[2], bias.shape[0]))

    monkeypatch.setattr(ct, "cavity_tconv_step_ring_cuda", stand_in)
    S, R, E = 3, 4, 3
    tplans = tuple(_tplan(tparams, prune_plans, "cuda", i) for i in (0, 1))
    slabs = tuple(engine.init_session_slab(p, S, x_calib=torch.from_numpy(x))
                  for p in tplans)
    rings = tuple(engine.init_snapshot_ring(s, R) for s in slabs)
    tick = make_gcn_fused_tick(CFG)
    events = _event_script(np.random.default_rng(2), S, R, E, 12)
    events[3][4][0] = [0, 1]                 # a snapshot, a restore, a hold
    events[3][5][0] = [2, 1]
    events[3][3][1] = True
    mode = _HostSyncOps()
    for ev in events:
        inputs = tuple(map(torch.from_numpy, ev))
        with mode:
            slabs, logits, rings = tick(tplans, slabs, *inputs, rings)
    assert mode.seen == []
    assert torch.isfinite(logits).all()
