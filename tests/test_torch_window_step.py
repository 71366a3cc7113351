"""The step form of kernel 7 (``windowed_similarity``): the streaming C_k
ring writes fused with the window sums and the graph.

* ``windowed_similarity_step_plain`` (and the CPU routes of its CUDA and
  ``ops`` wrappers) against the JAX side on numpy-seeded inputs: the new
  rings equal the JAX engine's ring write rebuilt in numpy (``array_equal``:
  the same copies), the graph matches ``windowed_similarity_pallas`` in
  interpret mode and ``jadaptive.windowed_ck(ring.sum(1))`` within
  atol=rtol=1e-6 (``FN_TOL``), on ``WS_CASES``' shapes with slots that
  differ in ``has_input`` and ``in_valid`` (a flush frame, an input-skip
  frame) and clocks past K; the input rings are left as they were;
* ``sim_plan`` at every path shape: each row of each slot in exactly one
  block, one warp a row, one load round, shared memory under 48 KB;
* a CPU emulation of the kernel's walk (``csrc/window_sim.cu``: blocks of
  ``rows`` joints, entries of 4 channels in rounds of ``ROUND`` per
  thread, Φ's rows then the block's Θ rows, the written ring row chosen
  after the loads, a warp a row and a lane its columns) held to the plain
  versions: window sums and rings bit-equal, every ring and graph element
  written exactly once, the graph within 1e-6;
* a ``cuda``-backend C_k stream on CPU tensors (the step form's plain
  route) against the ``reference`` backend over mixed slots: an input-skip
  plan, a slot reset mid-stream (its clock out of phase) and a slot
  flushing early; logits within 1e-5, block 0's rings equal.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.agcn import adaptive as jadaptive
from repro.kernels import ops as jops
from repro.kernels.window_sim import windowed_similarity_pallas
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.kernels import _build, ops
from repro_torch.kernels import window_sim as ws
from test_torch_adaptive import FN_TOL, WS_CASES

# (has_input, in_valid) per slot, cycled: a live frame, a flush frame, an
# input-skip frame, and a skip with in_valid set (the ring is kept)
SLOT_FLAGS = [(True, True), (True, False), (False, False), (False, True)]


def _inputs(seed, S, K, V, Ce):
    rng = np.random.default_rng(seed)
    ring_th, ring_ph = (rng.standard_normal((S, K, V, Ce)).astype(np.float32)
                        * np.float32(0.3) for _ in range(2))
    e_th, e_ph = (rng.standard_normal((S, V, Ce)).astype(np.float32)
                  * np.float32(0.3) for _ in range(2))
    t = rng.integers(0, 3 * K, S).astype(np.int32)
    flags = [SLOT_FLAGS[(s + seed) % len(SLOT_FLAGS)] for s in range(S)]
    has = np.array([f[0] for f in flags])
    inv = np.array([f[1] for f in flags])
    return ring_th, ring_ph, e_th, e_ph, t, has, inv


def _jax_ring_write(ring, e, t, has, inv):
    """The JAX engine's C_k ring write (repro.core.agcn.engine.step_frame)
    in numpy: e zeroed where not in_valid, set at row t % K of each slot
    with has_input."""
    K = ring.shape[1]
    e = np.where(inv[:, None, None], e, np.float32(0.0))
    new = ring.copy()
    for s in range(ring.shape[0]):
        if has[s]:
            new[s, t[s] % K] = e[s]
    return new


def _torch(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("S,K,V,Ce,valid", WS_CASES)
def test_window_step_plain_matches_jax(S, K, V, Ce, valid):
    ring_th, ring_ph, e_th, e_ph, t, has, inv = _inputs(S + V, S, K, V, Ce)
    want_th = _jax_ring_write(ring_th, e_th, t, has, inv)
    want_ph = _jax_ring_write(ring_ph, e_ph, t, has, inv)
    live = valid if 0 < valid < V else V
    oracle = np.asarray(jadaptive.windowed_ck(want_th.sum(1), want_ph.sum(1),
                                              valid_joints=valid))
    pallas = np.asarray(windowed_similarity_pallas(
        jops._pad_to(jnp.asarray(want_th), 2, 8),
        jops._pad_to(jnp.asarray(want_ph), 2, 8), valid=live))[:, :V, :V]
    np.testing.assert_allclose(pallas, oracle, **FN_TOL)
    args = _torch(ring_th, ring_ph, e_th, e_ph, t, has, inv)
    before = [a.clone() for a in args]
    _build.reset_launch_counts()
    for got in (ws.windowed_similarity_step_plain(*args, live),
                ws.windowed_similarity_step_cuda(*args, live),
                ops.windowed_similarity_step(*args, valid_joints=valid)):
        new_th, new_ph, graph = got
        np.testing.assert_array_equal(new_th.numpy(), want_th)
        np.testing.assert_array_equal(new_ph.numpy(), want_ph)
        assert graph.shape == (S, V, V)
        np.testing.assert_allclose(graph.numpy(), pallas, **FN_TOL)
        np.testing.assert_allclose(graph.numpy(), oracle, **FN_TOL)
    assert _build.LAUNCHES["windowed_similarity"] == 0   # CPU: plain version
    assert all(torch.equal(a, b) for a, b in zip(args, before))


def test_window_step_cuda_rejects_bad_inputs():
    ring = torch.zeros(2, 9, 25, 4)
    e = torch.zeros(2, 25, 4)
    t = torch.zeros(2, dtype=torch.int32)
    m = torch.ones(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="do not match"):
        ws.windowed_similarity_step_cuda(ring, ring, e[:, :7], e, t, m, m, 25)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        ws.windowed_similarity_step_cuda(ring, ring, e, e, t[:1], m, m, 25)
    with pytest.raises(ValueError, match="valid"):
        ws.windowed_similarity_step_cuda(ring, ring, e, e, t, m, m, 26)


# ---------------------------------------------------------------- the planner

@pytest.mark.parametrize("S", [1, 3, 8, 32])
@pytest.mark.parametrize("V", [7, 21, 25, 46, 50])
def test_sim_plan_covers_every_row_at_path_shapes(V, S):
    for Ce in (4, 16, 32, 64):
        p = ws.sim_plan(S, 9, V, Ce)
        chunks, slots = p.grid
        assert slots == S and chunks * p.rows >= V > (chunks - 1) * p.rows
        owners = np.zeros((S, V), np.int64)
        for s in range(S):
            for cx in range(chunks):
                owners[s, cx * p.rows:min(V, (cx + 1) * p.rows)] += 1
        assert (owners == 1).all()
        assert chunks * S <= max(132, S)          # one wave where S allows
        assert p.smem == ws.sim_smem_bytes(V, Ce, p.rows) <= 48 * 1024
        assert p.threads in ws.THREADS and p.threads >= 32 * min(p.rows, 16)
        assert ws.ROUND * p.threads >= (V + p.rows) * (Ce // 4)   # one round
        assert p == ws.make_sim_plan(S, 9, V, Ce, p.rows, p.threads)


def test_sim_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="V=129"):
        ws.sim_plan(1, 9, 129, 4)
    for kw in (dict(rows=0, threads=256), dict(rows=26, threads=256),
               dict(rows=5, threads=48), dict(rows=5, threads=1024)):
        with pytest.raises(ValueError, match="no plan"):
            ws.make_sim_plan(2, 9, 25, 16, **kw)
    with pytest.raises(ValueError, match="no plan"):       # shared memory
        ws.make_sim_plan(1, 9, 128, 512, 8, 256)


# ---------------------------------------------------------------- emulation

def _emulate(plan, ring_th, ring_ph, valid, step=None):
    """csrc/window_sim.cu's walk in numpy float32, block by block, entry by
    entry, lane by lane.  ``step`` = (e_th, e_ph, t, has, inv) or None.
    Returns (new_th, new_ph, out, sums) with write counts checked."""
    S, K, V, Ce = ring_th.shape
    VEC = 4 if Ce % 4 == 0 else 1
    W = Ce // VEC
    new = {True: np.full_like(ring_th, np.nan),
           False: np.full_like(ring_ph, np.nan)}
    writes = {True: np.zeros(ring_th.shape, np.int64),
              False: np.zeros(ring_ph.shape, np.int64)}
    out = np.full((S, V, V), np.nan, np.float32)
    out_writes = np.zeros((S, V, V), np.int64)
    sums = {True: np.zeros((S, V, Ce), np.float32),
            False: np.zeros((S, V, Ce), np.float32)}
    rings = {True: ring_th, False: ring_ph}
    chunks, _ = plan.grid
    scale = np.float32(np.sqrt(np.float32(Ce)))
    for s in range(S):
        for cx in range(chunks):
            v0 = cx * plan.rows
            nrows = min(plan.rows, V - v0)
            n_ph = V * W
            n = n_ph + nrows * W
            sth = np.zeros((plan.rows, Ce), np.float32)
            sph = np.zeros(V * (Ce + 1), np.float32)   # odd row stride
            for base in range(0, n, ws.ROUND * plan.threads):
                for q in range(ws.ROUND):
                    for tid in range(plan.threads):
                        i = base + q * plan.threads + tid
                        if i >= n:
                            continue
                        th = i >= n_ph
                        j = i - n_ph if th else i
                        v, c = j // W, j % W
                        if th:
                            v += v0
                        cols = slice(c * VEC, (c + 1) * VEC)
                        x = [rings[th][s, k, v, cols].copy()
                             for k in range(K)]
                        if step is not None:
                            e_th, e_ph, t, has, inv = step
                            if has[s]:
                                r = int(t[s]) % K
                                x[r] = ((e_th if th else e_ph)[s, v, cols]
                                        if inv[s] else np.zeros(VEC,
                                                                np.float32))
                        acc = x[0]
                        for k in range(1, K):
                            acc = acc + x[k]
                        sums[th][s, v, cols] = acc
                        if th:
                            sth[v - v0, cols] = acc
                        else:
                            sph[v * (Ce + 1) + c * VEC:
                                v * (Ce + 1) + (c + 1) * VEC] = acc
                        own = th or v0 <= v < v0 + nrows
                        if step is not None and own:
                            for k in range(K):
                                new[th][s, k, v, cols] = x[k]
                                writes[th][s, k, v, cols] += 1
            nwarps = plan.threads // 32
            for warp in range(nwarps):
                for lr in range(warp, nrows, nwarps):
                    lg = np.full((32, 4), -np.inf, np.float32)
                    for lane in range(32):
                        for jc in range(4):
                            w = lane + 32 * jc
                            if w >= V:
                                continue
                            if w >= valid:
                                lg[lane, jc] = np.float32(-1e30)
                                continue
                            ph = sph[w * (Ce + 1):w * (Ce + 1) + Ce]
                            dot = np.float32(0.0)
                            for e in range(Ce):      # one chain, in order
                                dot += sth[lr, e] * ph[e]
                            lg[lane, jc] = dot / scale
                    m = lg.max()
                    ex = np.where(np.arange(32)[:, None]
                                  + 32 * np.arange(4)[None, :] < V,
                                  np.exp(lg - m), np.float32(0.0))
                    row = (ex / ex.sum(dtype=np.float32)).astype(np.float32)
                    for lane in range(32):
                        for jc in range(4):
                            w = lane + 32 * jc
                            if w < V:
                                out[s, v0 + lr, w] = row[lane, jc]
                                out_writes[s, v0 + lr, w] += 1
    assert (out_writes == 1).all()
    if step is not None:
        assert (writes[True] == 1).all() and (writes[False] == 1).all()
    return new[True], new[False], out, sums


# (S, K, V, Ce, valid, rows, threads): the planner's choices, rows that do
# not divide V, several load rounds (few threads), more rows than warps,
# a generic K and a width that is not a multiple of 4 (scalar entries)
EMU_CASES = [(2, 9, 25, 16, 25, None, None), (3, 9, 50, 16, 25, None, None),
             (2, 9, 21, 8, 21, 5, 32), (1, 9, 46, 4, 40, 16, 64),
             (2, 3, 7, 4, 5, None, None), (2, 9, 9, 6, 9, 4, 32)]


@pytest.mark.parametrize("step", [False, True])
@pytest.mark.parametrize("S,K,V,Ce,valid,rows,threads", EMU_CASES)
def test_kernel_walk_emulation_matches_plain(S, K, V, Ce, valid, rows,
                                             threads, step):
    ring_th, ring_ph, e_th, e_ph, t, has, inv = _inputs(7 * S + V, S, K, V,
                                                        Ce)
    plan = (ws.sim_plan(S, K, V, Ce) if rows is None
            else ws.make_sim_plan(S, K, V, Ce, rows, threads))
    args = _torch(ring_th, ring_ph, e_th, e_ph, t, has, inv)
    if step:
        want_th, want_ph, want = ws.windowed_similarity_step_plain(*args,
                                                                   valid)
        got_th, got_ph, got, sums = _emulate(plan, ring_th, ring_ph, valid,
                                             (e_th, e_ph, t, has, inv))
        np.testing.assert_array_equal(got_th, want_th.numpy())
        np.testing.assert_array_equal(got_ph, want_ph.numpy())
    else:
        want_th, want_ph = args[:2]
        want = ws.windowed_similarity_plain(want_th, want_ph, valid)
        _, _, got, sums = _emulate(plan, ring_th, ring_ph, valid)
    # the plain version's window sums, in its ring order: bit-equal
    for th, ring in ((True, want_th), (False, want_ph)):
        acc = ring[:, 0]
        for k in range(1, K):
            acc = acc + ring[:, k]
        np.testing.assert_array_equal(sums[th], acc.numpy())
    np.testing.assert_allclose(got, want.numpy(), **FN_TOL)


def test_kernel_walk_padded_plan_matches_narrow_bitwise():
    """A plan padded to 50 joints (zero rings past 25, 25 live columns):
    the emulated kernel gives the narrow plan's graph rows bit for bit,
    whatever blocks the rows fall in."""
    ring_th, ring_ph, e_th, e_ph, t, has, inv = _inputs(3, 2, 3, 25, 8)
    pad = ((0, 0), (0, 0), (0, 25), (0, 0))
    step = (e_th, e_ph, t, has, inv)
    step_p = (np.pad(e_th, pad[1:]), np.pad(e_ph, pad[1:]), t, has, inv)
    narrow = _emulate(ws.sim_plan(2, 3, 25, 8), ring_th, ring_ph, 25, step)
    padded = _emulate(ws.sim_plan(2, 3, 50, 8), np.pad(ring_th, pad),
                      np.pad(ring_ph, pad), 25, step_p)
    np.testing.assert_array_equal(padded[2][:, :25, :25], narrow[2])
    np.testing.assert_array_equal(padded[0][:, :, :25], narrow[0])
    assert not padded[2][:, :, 25:].any()


# ---------------------------------------------------------------- streaming

CFG = dataclasses.replace(get_config("agcn-2s", reduced=True), use_ck=True)


def test_cuda_backend_ck_stream_mixed_slots_matches_reference():
    """The ``cuda`` backend's C_k step on CPU tensors (the step form's
    plain route) against the ``reference`` backend's ring writes and
    ``windowed_ck``, with input skip 2, a slot reset mid-stream (its block
    clocks and input phase off the others') and a slot flushing early."""
    params = model.init_params(CFG, seed=0, device="cpu")
    sw = [b["Wk"].numpy() for b in params["blocks"]]
    pp = build_prune_plan(sw, CFG.gcn_channels, [1.0, 0.5, 0.5, 0.5],
                          "cav-70-1", input_skip=2)
    plans = {b: engine.build_execution_plan(params, CFG, pp, quant=True,
                                            backend=b)
             for b in ("cuda", "reference")}
    S, T = 3, 24
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (S, T, 25, 3)).astype(np.float32))
    bn = engine.collect_bn_stats(plans["reference"], x)
    states = {b: engine.init_stream_state(p, S, bn_stats=bn)
              for b, p in plans.items()}
    _build.reset_launch_counts()
    skip_mixed = False
    for r in range(T):
        valid = torch.tensor([True, True, r < 15])
        got = {}
        for b, p in plans.items():
            st = states[b]
            if r == 7:                          # slot 1 starts over
                st = engine.reset_slots(st, torch.tensor([False, True,
                                                          False]))
            states[b], got[b] = engine.step_frame(p, st, x[:, r], valid)
        has = (states["cuda"].t_raw - 1) % 2 == 0
        skip_mixed |= bool(has.any() and not has.all())
        np.testing.assert_allclose(got["cuda"].numpy(),
                                   got["reference"].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=f"step {r}")
        c0, r0 = states["cuda"].blocks[0], states["reference"].blocks[0]
        assert torch.equal(c0["ck_th"], r0["ck_th"])
        assert torch.equal(c0["ck_ph"], r0["ck_ph"])
        for cb, rb in zip(states["cuda"].blocks, states["reference"].blocks):
            for k in ("ck_th", "ck_ph"):
                torch.testing.assert_close(cb[k], rb[k], atol=1e-5,
                                           rtol=1e-5)
    assert skip_mixed                   # slots did differ in has_input
    assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0)
