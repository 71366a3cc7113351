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
