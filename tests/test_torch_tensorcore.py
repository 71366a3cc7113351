"""The tensor-core designs of the dense spatial conv and the clip cavity
tconv, on the CPU.

- The 3-pass TF32 split the two kernels use, emulated: TF32 rounding is
  round-to-nearest-away on the float32 bits (``cvt.rna.tf32.f32``), each
  operand a splits into hi = tf32(a) and lo = tf32(a − hi), and a·b is
  a_lo·b_hi + a_hi·b_lo + a_hi·b_hi summed in float32.  At the model's
  shapes and scales the split's Σ_k (G_k·x)·W_k is within 1e-5 of the
  float64 einsum, and a single TF32 pass misses 1e-4, the tolerance the
  kernels are held to: that is why the kernels take three passes.
- ``graph_sconv``'s tile plan: it fits shared memory, its blocks cover every
  (row, joint, output channel) exactly once, and the grid reaches
  min(132, output 16×8 tiles) blocks.
- ``cavity_tconv``'s new layout: the plain version on (N, T, V, C) in place,
  natural filter order, equals the previous pad → transpose → packed →
  gather path; and its tile plan covers every (row, step) pair once.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.agcn import engine
from repro_torch.core.agcn.graph import dense_to_csr, get_topology
from repro_torch.core.pruning.cavity import cavity_pattern, tile_pattern
from repro_torch.kernels import cavity_tconv as ct
from repro_torch.kernels import graph_sconv as gs
from repro_torch.kernels import ops


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _sconv_inputs(R, V, Ci, Co, K):
    """The model's scales, as tests/test_torch_kernels.py makes them."""
    return (_rand(R, R, V, Ci), _rand(V, K, V, V, scale=1.0 / V),
            _rand(Ci, K, Ci, Co, scale=np.sqrt(2.0 / Ci)))


# --------------------------------------------------------- 3-pass TF32 split

def _tf32(a: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 as cvt.rna does: to nearest, ties away from
    zero, on the bits (the low 13 mantissa bits cleared)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(eq, a, b, passes):
    """a·b as the tensor cores form it: one TF32 pass, or three passes of
    the split operands (small terms first), summed in float32."""
    if passes == 1:
        return torch.einsum(eq, _tf32(a), _tf32(b))
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    a = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, -(1.0 + 3 * 2 ** -11),
                      1.0 + 2 ** -12], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -(1.0 + 2 ** -9),
                         1.0], dtype=torch.float32)
    assert torch.equal(_tf32(a), want)
    hi = _tf32(a)
    assert torch.equal(hi + _tf32(a - hi), a)      # the split is exact here


@pytest.mark.parametrize("V,Ci,Co", [(50, 90, 256), (25, 38, 64), (25, 3, 64)])
def test_three_pass_split_holds_graph_sconv_to_float32(V, Ci, Co):
    """The kernel's two stages: y_k = G_k·x (split, float32 result), then
    Σ_k y_k·W_k with y split again."""
    R, K = 16, 3
    x, g, w = _sconv_inputs(R, V, Ci, Co, K)
    want = np.einsum("rvc,kwv,kco->rwo", *(a.astype(np.float64)
                                          for a in (x, g, w)))
    tx, tg, tw = map(torch.from_numpy, (x, g, w))
    err = {}
    for passes in (1, 3):
        out = sum(_product("rwc,co->rwo",
                           _product("wv,rvc->rwc", tg[k], tx, passes),
                           tw[k], passes) for k in range(K))
        err[passes] = float(np.abs(out.numpy() - want).max())
    assert err[3] < 1e-5
    assert err[1] > 1e-4


# -------------------------------------------------------- graph_sconv plan

PLAN_R = (1, 3, 8, 1200, 2400)
PLAN_V = (21, 25, 46, 50)
PLAN_CIN = (3, 38, 77, 90, 256)
PLAN_COUT = (20, 64, 256)


def _plan_blocks(p, R, V, Cout):
    """The (rows, joints, channels) each block owns, as the kernel derives
    them from blockIdx."""
    njt = -(-V // p.wt)
    for bx in range(p.grid[0]):
        r0, w0 = bx // njt * p.rows, bx % njt * p.wt
        for by in range(p.grid[1]):
            o0 = by * p.bn
            yield ((r0, min(r0 + p.rows, R)), (w0, min(w0 + p.wt, V)),
                   (o0, min(o0 + p.bn, Cout)))


@pytest.mark.parametrize("V", PLAN_V)
@pytest.mark.parametrize("R", PLAN_R)
def test_graph_sconv_plan_fits_covers_and_fills_the_card(R, V):
    for Cin in PLAN_CIN:
        for Cout in PLAN_COUT:
            p = gs.sconv_plan(R, V, Cin, Cout, 3)
            assert p.smem <= 227 * 1024
            wm, wn, mt, nt, _, warps = gs.SCONV_TILES[p.tile]
            assert (p.bm, p.bn, p.threads) == (16 * wm * mt, 8 * wn * nt,
                                               32 * warps)
            assert warps >= wm * wn
            assert p.rows * p.wt <= p.bm
            assert p.wt == V or (p.wt % 16 == 0 and p.rows == 1)
            # the blocks of one channel tile cover every (row, joint) once,
            # those of one (row, joint) tile every channel once; each block
            # is one of each
            pairs = np.zeros((p.grid[1], R, V), np.int32)
            chans = np.zeros((p.grid[0], Cout), np.int32)
            for i, ((ra, rb), (wa, wb), (oa, ob)) in enumerate(
                    _plan_blocks(p, R, V, Cout)):
                assert ra < rb and wa < wb and oa < ob
                pairs[i % p.grid[1], ra:rb, wa:wb] += 1
                chans[i // p.grid[1], oa:ob] += 1
            assert (pairs == 1).all() and (chans == 1).all()
            assert (p.grid[0] * p.grid[1]
                    >= min(gs.SM_COUNT, gs.output_tiles(R, V, Cout)))


def test_graph_sconv_plan_forms_y_once_per_row_tile_on_clips():
    """At the clip path's widths one block owns every output channel, so
    G·x is formed once per row tile where the grid already fills the card;
    at R = 608 (two row tiles per SM would be too few) it splits Cout."""
    for R, V, Cout in [(2400, 25, 64), (2400, 25, 128), (1200, 25, 256),
                       (1200, 50, 64), (600, 50, 128), (304, 50, 256)]:
        assert gs.sconv_plan(R, V, 51, Cout, 3).grid[1] == 1
    assert gs.sconv_plan(608, 25, 77, 256, 3).grid[1] == 2


def test_graph_sconv_plan_rejects_what_the_kernel_cannot_take():
    with pytest.raises(ValueError):
        gs.sconv_plan(8, 129, 16, 64, 3)
    with pytest.raises(ValueError):
        gs.sconv_plan(0, 25, 16, 64, 3)


def _emulate_sconv(x, g, w, p):
    """graph_sconv block by block as the plan tiles it, each block forming
    its own G·x from whole x rows and only its joints' rows of G."""
    R, V, _ = x.shape
    Cout = w.shape[-1]
    out = torch.full((R, V, Cout), float("nan"))
    for (ra, rb), (wa, wb), (oa, ob) in _plan_blocks(p, R, V, Cout):
        y = torch.einsum("kwv,rvc->krwc", g[:, wa:wb], x[ra:rb])
        out[ra:rb, wa:wb, oa:ob] = torch.einsum("krwc,kco->rwo", y,
                                                w[:, :, oa:ob])
    return out


@pytest.mark.parametrize("R,V,Ci,Co", [(8, 25, 77, 256), (3, 46, 51, 128),
                                       (40, 50, 90, 256), (17, 21, 35, 20)])
def test_graph_sconv_plan_tiles_compute_the_whole_product(R, V, Ci, Co):
    x, g, w = map(torch.from_numpy, _sconv_inputs(R, V, Ci, Co, 3))
    got = _emulate_sconv(x, g, w, gs.sconv_plan(R, V, Ci, Co, 3))
    torch.testing.assert_close(got, gs.graph_sconv_plain(x, g, w),
                               atol=1e-5, rtol=1e-5)


# -------------------------------------------------- cavity_tconv, new layout

def _old_path(x, wp, taps, inv, num_filters, kernel_size, stride):
    """The previous clip path: (N, T, V, C) transposed to (N·V, T, C)
    rows, zero-padded on T, the packed (B, T_out, L, Fg) product, the
    filters gathered by inv_perm, the result permuted back."""
    N, T, V, C = x.shape
    xb = x.permute(0, 2, 1, 3).reshape(N * V, T, C)
    pad = kernel_size // 2
    t_out = (T + 2 * pad - kernel_size) // stride + 1
    t_pad = kernel_size - 1 + t_out * stride
    xp = F.pad(xb, (0, 0, pad, t_pad - T - pad))
    L, n_keep, _, Fg = wp.shape
    out = torch.zeros((N * V, t_out, L, Fg))
    for g, row in enumerate(taps.tolist()):
        for j, off in enumerate(row):
            out[:, :, g] += xp[:, off: off + t_out * stride: stride] @ wp[g, j]
    flat = out.reshape(N * V, t_out, L * Fg).index_select(-1, inv)
    return flat[..., :num_filters].reshape(N, V, t_out, -1).permute(0, 2, 1, 3)


def _packed(F_, C, pattern, seed):
    mask = tile_pattern(cavity_pattern(pattern), F_)
    wp, taps, inv = ops.pack_cavity_weights(
        _rand(seed, F_, C, 9) * mask[:, None, :], mask)
    return (torch.from_numpy(wp), torch.from_numpy(taps),
            torch.from_numpy(inv).long())


# (N, T, V, C, F, stride, pattern): odd T into stride 2, F not a multiple
# of 8, V = 1 (the 3-D view) and V = 25
LAYOUT_CASES = [(2, 15, 1, 8, 38, 2, "cav-70-1"), (2, 9, 25, 6, 13, 2, "cav-70-1"),
                (3, 20, 25, 8, 77, 1, "cav-70-1"), (1, 11, 5, 4, 24, 2, "none"),
                (2, 7, 3, 5, 21, 1, "cav-50-1")]


@pytest.mark.parametrize("N,T,V,C,F_,stride,pattern", LAYOUT_CASES)
def test_cavity_tconv_plain_in_place_equals_the_old_path(N, T, V, C, F_,
                                                         stride, pattern):
    wp, taps, inv = _packed(F_, C, pattern, F_ + C)
    x = torch.from_numpy(_rand(T, N, T, V, C))
    got = ct.cavity_tconv_plain(x, wp, taps, inv, F_, 9, stride)
    want = _old_path(x, wp, taps, inv, F_, 9, stride)
    assert got.shape == (N, (T - 1) // stride + 1, V, F_)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    # ops takes (N, T, V, C) and its V = 1 view (B, T, C) alike
    torch.testing.assert_close(ops.cavity_tconv(x, wp, taps, inv, F_, 9,
                                                stride), got)
    if V == 1:
        torch.testing.assert_close(
            ops.cavity_tconv(x[:, :, 0], wp, taps, inv, F_, 9, stride),
            got[:, :, 0])


@pytest.mark.parametrize("B,T_out,n_keep,Fg,stride", [
    (400, 150, 3, 5, 1), (400, 75, 3, 8, 2), (400, 38, 3, 32, 1),
    (2, 5, 9, 2, 2), (7, 1, 3, 3, 1), (1, 300, 3, 10, 1)])
def test_cavity_tconv_plan_covers_every_pair_once(B, T_out, n_keep, Fg, stride):
    p = ct.tconv_plan(B, T_out, 8, n_keep, Fg, 9, stride)
    assert p.smem <= 227 * 1024 and p.nb * p.tt <= ct.TCONV_PAIRS
    seen = np.zeros((B, T_out), np.int32)
    ntt = -(-T_out // p.tt)
    for bx in range(p.grid[0]):
        b0, t0 = bx // ntt * p.nb, bx % ntt * p.tt
        seen[b0:b0 + p.nb, t0:t0 + p.tt] += 1
    assert (seen == 1).all()
    assert p.grid[1] == -(-Fg // 8)


# ------------------------------------------------- graph_sconv_csr, ELL form

def _ell(name, eps):
    """The ELL pack (idx, val) of a registry skeleton's graph plus B_k's
    1e-6 init, at threshold ``eps``: D = its degree (1e-5) or V (0)."""
    g = get_topology(name).adjacency + np.float32(1e-6)
    return ops.pack_csr_ell(*dense_to_csr(g, eps), g.shape[-1])


@pytest.mark.parametrize("name", ("ntu25", "ntu50", "hand21", "body_hand46"))
@pytest.mark.parametrize("R", PLAN_R)
def test_csr_plan_fits_covers_and_fills_the_card(R, name):
    """The ELL tile plan at the skeleton's degree and at D = V: it fits
    shared memory (counted with the block's ELL rows), its blocks cover
    every (row, joint, output channel) once, and the grid reaches
    min(132, output 16×8 tiles) blocks."""
    V = get_topology(name).num_joints
    for D in sorted({_ell(name, 1e-5)[0].shape[-1], V}):
        for Cin in PLAN_CIN:
            for Cout in PLAN_COUT:
                p = gs.csr_plan(R, V, Cin, Cout, 3, D)
                wm, wn, mt, nt, kc, _ = gs.SCONV_TILES[p.tile]
                assert p.smem == gs._smem_bytes(p.bm, p.bn, kc, p.rows, p.wt,
                                                V, Cin, p.xres, D)
                assert p.smem <= 227 * 1024
                assert p.rows * p.wt <= p.bm
                assert p.wt == V or (p.wt % 16 == 0 and p.rows == 1)
                pairs = np.zeros((p.grid[1], R, V), np.int32)
                chans = np.zeros((p.grid[0], Cout), np.int32)
                for i, ((ra, rb), (wa, wb), (oa, ob)) in enumerate(
                        _plan_blocks(p, R, V, Cout)):
                    pairs[i % p.grid[1], ra:rb, wa:wb] += 1
                    chans[i // p.grid[1], oa:ob] += 1
                assert (pairs == 1).all() and (chans == 1).all()
                assert (p.grid[0] * p.grid[1]
                        >= min(gs.SM_COUNT, gs.output_tiles(R, V, Cout)))


def test_csr_plan_forms_y_once_per_row_tile_on_clips():
    """As the dense plan: at the clip path's widths one block owns every
    output channel; and the ELL rows take less room than G_k's."""
    for R, V, Cout, D in [(1200, 50, 64, 5), (1200, 50, 256, 50),
                          (2400, 25, 64, 4), (304, 50, 256, 5)]:
        assert gs.csr_plan(R, V, 51, Cout, 3, D).grid[1] == 1
    assert (gs._smem_bytes(128, 64, 16, 2, 50, 50, 90, True, 5)
            < gs._smem_bytes(128, 64, 16, 2, 50, 50, 90, True))
    with pytest.raises(ValueError):
        gs.csr_plan(8, 50, 16, 64, 3, 0)


def _emulate_csr(x, idx, val, w, p):
    """graph_sconv_csr block by block as the plan tiles it: each block
    gathers its joints' y from whole x rows, slot by slot in float32, then
    the 1×1 product of its channels."""
    R, V, _ = x.shape
    Cout = w.shape[-1]
    out = torch.full((R, V, Cout), float("nan"))
    for (ra, rb), (wa, wb), (oa, ob) in _plan_blocks(p, R, V, Cout):
        y = torch.zeros((w.shape[0], rb - ra, wb - wa, x.shape[-1]))
        for d in range(idx.shape[-1]):
            y = y + (x[ra:rb][:, idx[:, wa:wb, d].long()].permute(1, 0, 2, 3)
                     * val[:, wa:wb, d][:, None, :, None])
        out[ra:rb, wa:wb, oa:ob] = torch.einsum("krwc,kco->rwo", y,
                                                w[:, :, oa:ob])
    return out


@pytest.mark.parametrize("R,name,eps,Ci,Co", [
    (8, "ntu50", 1e-5, 77, 256), (3, "body_hand46", 0.0, 51, 128),
    (40, "hand21", 1e-5, 90, 256), (17, "ntu25", 0.0, 35, 20)])
def test_csr_plan_tiles_compute_the_whole_product(R, name, eps, Ci, Co):
    idx, val = map(torch.from_numpy, _ell(name, eps))
    V, D = idx.shape[1], idx.shape[2]
    x, _, w = map(torch.from_numpy, _sconv_inputs(R, V, Ci, Co, 3))
    got = _emulate_csr(x, idx, val, w, gs.csr_plan(R, V, Ci, Co, 3, D))
    torch.testing.assert_close(got, gs.graph_sconv_csr_plain(x, idx, val, w),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name,eps,Ci,Co", [
    ("ntu50", 1e-5, 90, 256), ("ntu50", 0.0, 90, 256), ("hand21", 1e-5, 3, 64),
    ("body_hand46", 0.0, 38, 64)])
def test_three_pass_split_holds_the_ell_product_to_float32(name, eps, Ci, Co):
    """The ELL kernel's stages: y_k gathered in float32, slot by slot, then
    split, and Σ_k y_k·W_k in three TF32 passes: within 1e-4 of float64."""
    idx, val = _ell(name, eps)
    R, (K, V, D) = 16, idx.shape
    x, _, w = _sconv_inputs(R, V, Ci, Co, K)
    g = np.zeros((K, V, V))
    for k in range(K):
        np.add.at(g[k], (np.arange(V)[:, None], idx[k]), val[k])
    want = np.einsum("rvc,kwv,kco->rwo", x.astype(np.float64), g,
                     w.astype(np.float64))
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    y = torch.zeros((K, R, V, Ci))
    for d in range(D):
        y = y + (tx[:, torch.from_numpy(idx[:, :, d]).long()].permute(
            1, 0, 2, 3) * torch.from_numpy(val[:, :, d])[:, None, :, None])
    out = sum(_product("rwc,co->rwo", y[k], tw[k], 3) for k in range(K))
    assert float(np.abs(out.numpy() - want).max()) < 1e-4


# ------------------------------------------- cavity_tconv_step, ring form

def _emulate_step(ring, head, wp, taps, slot_col, bias, p):
    """cavity_tconv_step's blocks as the plan tiles them: each block's
    (row, tap, channel) values read from the flat ring at the index the
    kernel computes (frame (head[s] + tap) mod K), its share of the steps'
    products, the shares added in rank order, then the store through
    slot_col with the bias and the zero columns.  Returns (out, the staged
    rows (B, L, n_keep, C) and how often each was staged)."""
    S, K, V, C = ring.shape
    L, n_keep, _, Fg = wp.shape
    cout, B = bias.shape[0], S * V
    flat = ring.reshape(-1, C)
    spt = -(-C // 8)
    NS, bm = n_keep * spt, 16 * p.wm
    staged = torch.zeros((B, L, n_keep, C))
    seen = torch.zeros((B, L, n_keep, spt), dtype=torch.int32)
    out = torch.full((B, cout), float("nan"))
    for bx in range(p.grid[0]):
        for g in range(L):
            tile = torch.zeros((bm, Fg))
            for part in range(p.parts):
                s0, s1 = part * NS // p.parts, (part + 1) * NS // p.parts
                for r in range(bm):
                    b = bx * bm + r
                    if b >= B:
                        continue
                    s, v = divmod(b, V)
                    for q in range(s0, s1):
                        j, c0 = q // spt, q % spt * 8
                        off = int(taps[g, j])
                        f = (s * K + (int(head[s]) + off) % K) * V + v
                        a = flat[f, c0:c0 + 8]
                        staged[b, g, j, c0:c0 + 8] = a
                        seen[b, g, j, q % spt] += 1
                        tile[r] += a @ wp[g, j, c0:c0 + 8]
            for r in range(bm):
                b = bx * bm + r
                if b >= B:
                    continue
                for i in range(Fg):
                    col = int(slot_col[g * Fg + i])
                    if col >= 0:
                        out[b, col] = tile[r, i] + bias[col]
    dead = sorted(set(range(cout)) - set(slot_col.tolist()))
    out[:, dead] = 0.0
    return out.reshape(S, V, cout), staged, seen


@pytest.mark.parametrize("S,V,C,F_,pattern,heads", [
    (3, 5, 12, 24, "cav-70-1", [7, 0, 4]), (9, 2, 8, 13, "cav-70-1",
                                            list(range(9))),
    (1, 25, 6, 38, "none", [5])])
def test_step_kernel_grid_reads_the_chronological_rows(S, V, C, F_, pattern,
                                                       heads):
    """The kernel's index arithmetic, over torch tensors: every (row,
    group, tap, 8-channel step) is staged exactly once, from the frame
    ``_gather_k(ring, chrono)`` holds at that tap, and the tiles' products
    stored through the map equal the plain version."""
    K = 9
    mask = tile_pattern(cavity_pattern(pattern), F_)
    wp, taps, inv = ops.pack_cavity_weights(
        _rand(F_, F_, C, K) * mask[:, None, :], mask)
    kept = np.sort(np.random.default_rng(C).choice(F_ + 7, F_, replace=False))
    slot_col = torch.from_numpy(ops.slot_columns(inv, F_, kept))
    bias = torch.from_numpy(_rand(1, F_ + 7))
    ring = torch.from_numpy(_rand(S, S, K, V, C))
    head = torch.tensor(heads, dtype=torch.int32)
    wp, taps = torch.from_numpy(wp), torch.from_numpy(taps)
    L, n_keep, _, Fg = wp.shape
    p = ct.step_plan(S * V, C, L, n_keep, Fg, F_ + 7)
    assert p.smem == ct._step_smem_bytes(
        p.wm, -(-n_keep * -(-C // 8) // p.parts) * 8, -(-Fg // 8) * 8,
        n_keep, L * Fg, F_ + 7)
    got, staged, seen = _emulate_step(ring, head, wp, taps, slot_col, bias, p)
    assert (seen == 1).all()
    chrono = ((head.long()[:, None] + torch.arange(K)[None, :]) % K)
    win = engine._gather_k(ring, chrono)               # (S, K, V, C)
    rows = win.permute(0, 2, 1, 3).reshape(S * V, K, C)
    for g in range(L):
        for j in range(n_keep):
            assert torch.equal(staged[:, g, j], rows[:, int(taps[g, j])])
    torch.testing.assert_close(got, ct.cavity_tconv_step_ring_plain(
        ring, head, wp, taps, slot_col, bias), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("V", (25, 50))
@pytest.mark.parametrize("S", (1, 3, 8))
def test_step_plan_fits_and_fills_the_card(S, V):
    """At the model's widths (C 64..256, F 64..256, n_keep 3 of 9) the plan
    fits shared memory, its clusters are portable (≤ 8 blocks) and split
    no step, and S = 1, 3, 8 slots reach 128 blocks or more, (row tiles)
    × 8 groups × parts, and no more than 512 unless 16-row tiles in
    clusters of 1 would pass that."""
    for C, F_ in ((64, 64), (128, 128), (256, 256), (64, 38)):
        Fg = -(-F_ // 8)
        p = ct.step_plan(S * V, C, 8, 3, Fg, F_)
        assert p.smem <= 227 * 1024 and p.parts in (1, 2, 4, 8)
        assert p.parts <= 3 * -(-C // 8)
        assert p.grid == (-(-S * V // (16 * p.wm)), 8, p.parts)
        blocks = p.grid[0] * p.grid[1] * p.grid[2]
        assert 128 <= blocks and (blocks <= 512 or p.parts == 1)
    with pytest.raises(ValueError):
        ct.step_plan(8, 64, 8, 3, 65, 64)
