"""The port's CUDA kernels against their plain versions on the card.

Every test here is marked ``cuda`` and skips without a card.  The module
imports neither ``jax`` nor the JAX package ``repro`` (the card's machine
has no JAX), so ``chip_smoke.py``'s ``card_tests`` phase runs it there:

    PYTHONPATH=src python3 -m pytest -q --noconftest -p no:cacheprovider \
        -m cuda tests/test_torch_cuda_kernels.py

The case lists and input helpers are shared with the CPU tests that hold
the plain versions to the JAX oracles (``tests/test_torch_kernels.py``).
Tolerance: atol = rtol = 1e-4 against the plain version, RFC bit-equal.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.pruning.cavity import cavity_pattern, tile_pattern
from repro_torch.kernels import _build, ops
from repro_torch.kernels import cavity_tconv as ct
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import graph_sconv as gs
from repro_torch.kernels import rfc_pack as rp
from repro_torch.kernels import window_sim as ws


def _rand(seed, *shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _sconv_inputs(R, V, Ci, Co, K):
    """Inputs at the model's scales (a normalized graph plus noise, He-
    initialized weights), so outputs are O(1) like the model's."""
    return (_rand(R, R, V, Ci), _rand(V, K, V, V, scale=1.0 / V),
            _rand(Ci, K, Ci, Co, scale=np.sqrt(2.0 / Ci)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernels run only there)")
    return torch.device("cuda")


# ------------------------------------------------------------ case lists

SCONV_SHAPES = [(32, 25, 16, 32, 3), (64, 25, 3, 8, 3), (7, 25, 38, 64, 3),
                (16, 5, 9, 20, 2)]

# (B, T, C, F, stride, pattern): odd T into stride 2, F not a multiple of 8
TCONV_CASES = [(4, 32, 16, 16, 1, "cav-70-1"), (3, 15, 8, 38, 2, "cav-70-1"),
               (2, 75, 4, 77, 2, "cav-70-1"), (5, 20, 8, 13, 1, "none"),
               (2, 9, 6, 24, 2, "cav-50-1")]

# (B, C, F, pattern): F not a multiple of 8, dense and pruned tap sets
STEP_CASES = [(25, 16, 16, "cav-70-1"), (75, 8, 38, "cav-70-1"),
              (50, 4, 77, "none"), (3, 6, 24, "cav-50-1"),
              (200, 12, 13, "cav-70-1")]

# (rows, C): C not a multiple of 16 in the ops cases
RFC_SHAPES = [(8, 16), (32, 64), (100, 48), (7, 160), (9, 38), (5, 3)]

# the fused epilogue and encode: name -> (shape of t, res ("same", a
# "strided" view h[:, ::2] of an odd-length h, which the wrapper copies,
# or None), live joints (or
# None), a mixed keep over the leading axis, the values: "randn", "cold"
# (every bank empty), "hot" (every bank full) or "signed_zero" (±0.0 with
# a few values)).  Odd row counts and rows x C off a multiple of 128 are
# among them.
RFC_CASES = {
    "no_res": ((100, 48), None, None, False, "randn"),
    "res": ((8, 25, 256), "same", None, False, "randn"),
    "res_strided": ((2, 9, 25, 64), "strided", None, False, "randn"),
    "live": ((3, 25, 48), "same", 20, False, "randn"),
    "keep_mixed": ((5, 25, 16), "same", None, True, "randn"),
    "keep_live": ((8, 50, 64), "same", 25, True, "randn"),
    "cold_banks": ((33, 48), "same", None, False, "cold"),
    "hot_banks": ((7, 256), None, None, False, "hot"),
    "signed_zero": ((9, 3, 16), "same", None, True, "signed_zero"),
    "odd_rows": ((7, 1, 16), "same", None, False, "randn"),
}


def _rfc_values(seed, shape, kind):
    if kind == "cold":
        return -np.abs(_rand(seed, *shape)) - 0.5
    if kind == "hot":
        return np.abs(_rand(seed, *shape)) + 0.5
    x = _rand(seed, *shape)
    if kind == "signed_zero":
        x = np.where(np.abs(x) < 1.0, np.float32(-0.0), x)
        x[..., ::3] = 0.0
    return x


def _rfc_inputs(name, device):
    """The arguments (t, res, live, keep, old) of one ``RFC_CASES`` case
    on ``device``, made with numpy from a seed; a strided ``res`` is a view
    into a tensor on the device."""
    from repro_torch.kernels.rfc_pack import rfc_encode_plain
    shape, res_kind, n_live, keep, kind = RFC_CASES[name]
    seed = len(name) + sum(shape)
    t = torch.from_numpy(_rfc_values(seed, shape, kind)).to(device)
    res = None
    if res_kind == "same":
        res = torch.from_numpy(_rfc_values(seed + 1, shape, kind)).to(device)
    elif res_kind == "strided":
        h = (shape[0], 2 * shape[1] - 1) + shape[2:]
        res = torch.from_numpy(_rfc_values(seed + 1, h, kind)).to(device)
        res = res[:, ::2]
    live = None
    if n_live is not None:
        live = torch.arange(shape[-2], device=device) < n_live
    old = keep_m = None
    if keep:
        keep_m = torch.arange(shape[0], device=device) % 2 == 0
        old = dict(zip(("vals", "bits"), rfc_encode_plain(torch.from_numpy(
            _rand(seed + 2, *shape)).to(device))))
    return t, res, live, keep_m, old

# (R, V, Cin, Cout, topology, csr_eps): the clip and stream-tick shapes of
# an ntu50 plan, D = the skeleton's degree (eps 1e-5) and D = V (eps 0)
CSR_CASES = [(32, 50, 16, 32, "ntu50", 1e-5), (8, 50, 256, 256, "ntu50", 1e-5),
             (7, 50, 38, 64, "ntu50", 0.0), (2400, 50, 3, 64, "ntu50", 1e-5),
             (5, 21, 9, 20, "hand21", 0.0), (64, 46, 77, 128, "body_hand46",
                                              1e-5)]

# the full-width ntu50 clip (batch 8: R = 1200 rows into the first block,
# 304 into the last) and S = 8 stream shapes, at D = degree and D = V
CSR_FULL_WIDTH = [(R, 50, Ci, Co, "ntu50", eps) for eps in (1e-5, 0.0)
                  for R, Ci, Co in ((1200, 3, 64), (304, 256, 256),
                                    (8, 3, 64), (8, 256, 256))]

# dense plans of hand21 (V = 21: 6 rows a 128-pair tile) and body_hand46
# (V = 46: 2 rows a tile), agcn-2s's first and last blocks (Cin 3 -> 64,
# 256 -> 256): clip rows at batch 8 of one person (T = 150, then 38 after
# the strides) and an S = 8 stream tick
DENSE_SKELETON_SHAPES = [(R, V, Ci, Co, 3) for V in (21, 46)
                         for R, Ci, Co in ((1200, 3, 64), (304, 256, 256),
                                           (8, 3, 64), (8, 256, 256))]

# (B, S, Hkv, G, D, valid): the JAX package's three shapes, a small odd one
# (D = 20 as in reduced smollm, one live slot) and reduced danube's ring
FD_SHAPES = [(1, 512, 2, 4, 32, 512), (2, 1024, 4, 3, 64, 700),
             (3, 512, 1, 1, 128, 17), (2, 48, 1, 3, 20, 1),
             (2, 16, 2, 2, 16, 16)]


# (B, S, Hkv, G, D, valid): the split kernel's masking cases: valid 0
# (every slot masked: the mean of V), 1, S and past S; a valid that leaves
# most splits empty; S not a multiple of the 16-row tile; D = 16, 20, 64
# and 80 (16-byte staging)
FD_SPLIT_CASES = [(2, 100, 2, 3, 16, 0), (2, 100, 2, 3, 20, 1),
                  (2, 100, 2, 3, 64, 100), (2, 100, 2, 3, 80, 150),
                  (2, 512, 2, 3, 64, 17), (1, 200, 3, 4, 80, 37),
                  (3, 47, 1, 2, 16, 47)]

# (B, S, Hkv, G, D, valid, window): the zoo's shapes (zamba2's shared
# attention D 112 G 1, internlm2's G 6, whisper's cross-attention over
# 1 500 frames, gemma3's D 256 with its 1 024-token window over a longer
# cache), the wide instantiations (D 132 and 256 at G 3 and 5; D 130:
# 4-byte staging) and the window's edges: a window at least valid (no
# bound), valid 0, valid past S with the bound inside S and past it (no
# live slot: every slot masked), odd D
FD_WIDE_CASES = [(2, 40, 32, 1, 112, 33, 0), (4, 64, 8, 6, 128, 40, 0),
                 (4, 1500, 12, 1, 64, 1500, 0),
                 (1, 1108, 8, 2, 256, 1101, 1024),
                 (1, 1108, 8, 2, 256, 1101, 0), (2, 300, 2, 3, 256, 300, 0),
                 (1, 64, 1, 5, 132, 40, 0), (1, 100, 2, 3, 130, 77, 0),
                 (2, 512, 2, 3, 64, 500, 128), (2, 100, 2, 3, 20, 90, 16),
                 (2, 100, 2, 3, 64, 30, 64), (2, 100, 2, 3, 64, 0, 16),
                 (2, 48, 1, 2, 16, 52, 8), (2, 48, 1, 2, 16, 200, 8),
                 (1, 300, 2, 2, 256, 290, 100)]

# (B, S, Hkv, G, D, valid, window) over a bf16 cache: smollm's served step
# and its 32 768-slot context, gemma3 at D = 256 windowed and global,
# whisper's cross-attention shape, danube's ring (D = 80), valid 0 (every
# slot masked: the mean of V) and an early step (valid 17)
FD_BF16_CASES = [(4, 512, 5, 3, 64, 497, 0), (8, 32768, 5, 3, 64, 32768, 0),
                 (1, 1108, 8, 2, 256, 1101, 1024),
                 (1, 1108, 8, 2, 256, 1101, 0),
                 (4, 1500, 12, 1, 64, 1500, 0), (4, 4096, 8, 4, 80, 4096, 0),
                 (2, 100, 2, 3, 16, 0, 0), (2, 512, 2, 3, 64, 17, 0)]
# both round each probability to bf16 against the row's max, but another
# float32 sum order can tip a rounding, which moves a result by a share of
# the rounding's own effect: the bound is fd.bf16_bound's (a share of
# fd.bf16_rounding_gap under fd.BF16_CAP_RANDOM)

# (splits, warps, stages) forced through make_plan; splits None: the most
# the cache's 16-row tiles allow (at most 16)
FD_FORCED = [(1, 4, 3), (2, 2, 4), (None, 1, 6), (None, 8, 2)]


def _fd_forced(B, S, Hkv, G, D):
    """The decode plan's pick, then each FD_FORCED plan that fits."""
    plans = [fd.decode_plan(B, S, Hkv, G, D)]
    for splits, warps, stages in FD_FORCED:
        top = min(fd.MAX_SPLITS, -(-S // fd.TILE_ROWS))
        try:
            plans.append(fd.make_plan(B, S, Hkv, G, D, splits or top, warps,
                                      stages))
        except ValueError:
            pass
    return plans


def _fd_inputs(B, S, Hkv, G, D):
    return (_rand(B * S, B, Hkv, G, D), _rand(B * S + 1, B, S, Hkv, D),
            _rand(B * S + 2, B, S, Hkv, D))


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,Ci,Co,K", SCONV_SHAPES + [
    (2400, 25, 3, 64, 3), (608, 25, 77, 256, 3), (1200, 50, 90, 256, 3),
    (8, 50, 90, 256, 3), (8, 25, 77, 256, 3), (300, 50, 256, 256, 3)]
    + DENSE_SKELETON_SHAPES)
def test_graph_sconv_kernel_matches_plain(cuda, R, V, Ci, Co, K):
    x, g, w = (torch.from_numpy(a).to(cuda)
               for a in _sconv_inputs(R, V, Ci, Co, K))
    torch.testing.assert_close(gs.graph_sconv_cuda(x, g, w),
                               gs.graph_sconv_plain(x, g, w),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,C,F,stride,pattern,V", [
    c + (1,) for c in TCONV_CASES] + [(2, 75, 256, 77, 2, "cav-70-1", 1),
                                      (2, 75, 64, 38, 1, "cav-70-1", 25)])
def test_cavity_tconv_kernel_matches_plain(cuda, B, T, C, F, stride, pattern,
                                           V):
    """(N, T, V, C) in place; V = 1 is the 3-D interface's view."""
    mask = tile_pattern(cavity_pattern(pattern), F)
    wp, taps, inv = ops.pack_cavity_weights(
        _rand(F, F, C, 9) * mask[:, None, :], mask)
    x = torch.from_numpy(_rand(T, B, T, V, C)).to(cuda)
    wp, taps = torch.from_numpy(wp).to(cuda), torch.from_numpy(taps).to(cuda)
    inv = torch.from_numpy(inv).long().to(cuda)
    torch.testing.assert_close(
        ct.cavity_tconv_cuda(x, wp, taps, inv, F, 9, stride),
        ct.cavity_tconv_plain(x, wp, taps, inv, F, 9, stride),
        atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,F,pattern", STEP_CASES + [
    (200, 256, 256, "cav-70-1"), (25, 64, 64, "cav-70-1"),
    (75, 128, 52, "none")])
def test_cavity_tconv_step_kernel_matches_plain(cuda, B, C, F, pattern):
    mask = tile_pattern(cavity_pattern(pattern), F)
    wp, taps, _ = ops.pack_cavity_weights(
        _rand(F, F, C, 9) * mask[:, None, :] / np.float32(np.sqrt(C)), mask)
    x = torch.from_numpy(_rand(B, B, 9, C)).to(cuda)
    wp, taps = torch.from_numpy(wp).to(cuda), torch.from_numpy(taps).to(cuda)
    if C % 4:       # 4-byte copies take any C; zero-padded C agrees too
        torch.testing.assert_close(ct.cavity_tconv_step_cuda(x, wp, taps),
                                   ct.cavity_tconv_step_plain(x, wp, taps),
                                   atol=1e-4, rtol=1e-4)
        x, wp = ops._pad_to(x, 2, 4), ops._pad_to(wp, 2, 4).contiguous()
    torch.testing.assert_close(ct.cavity_tconv_step_cuda(x, wp, taps),
                               ct.cavity_tconv_step_plain(x, wp, taps),
                               atol=1e-4, rtol=1e-4)


# (S, V, C, F, cout, pattern): the ring-form step at S = 1, 3 and 8 slots,
# at the model's widths, with pruned columns (cout > F) and an odd C
RING_CASES = [(1, 25, 64, 64, 64, "cav-70-1"),
              (3, 25, 128, 90, 128, "cav-70-1"),
              (8, 25, 256, 256, 256, "cav-70-1"),
              (8, 50, 256, 180, 256, "cav-70-1"),
              (3, 25, 38, 38, 51, "none"), (8, 25, 7, 13, 20, "cav-50-1")]


@pytest.mark.cuda
@pytest.mark.parametrize("S,V,C,F,cout,pattern", RING_CASES)
def test_cavity_tconv_step_ring_kernel_matches_plain(cuda, S, V, C, F, cout,
                                                     pattern):
    """The ring read in place at mixed phases, the kept filters stored at
    their columns with the bias, the pruned columns exactly 0."""
    mask = tile_pattern(cavity_pattern(pattern), F)
    wp, taps, inv = ops.pack_cavity_weights(
        _rand(F, F, C, 9) * mask[:, None, :] / np.float32(np.sqrt(C)), mask)
    rng = np.random.default_rng(S + C)
    kept = np.sort(rng.choice(cout, F, replace=False))
    head = rng.integers(0, 9, S).astype(np.int32)
    args = (torch.from_numpy(_rand(S * C, S, 9, V, C)).to(cuda),
            torch.from_numpy(head).to(cuda), torch.from_numpy(wp).to(cuda),
            torch.from_numpy(taps).to(cuda),
            torch.from_numpy(ops.slot_columns(inv, F, kept)).to(cuda),
            torch.from_numpy(_rand(cout, cout)).to(cuda))
    want = ct.cavity_tconv_step_ring_plain(*args)
    _build.reset_launch_counts()
    got = ct.cavity_tconv_step_ring_cuda(*args)
    assert _build.LAUNCHES["cavity_tconv_step"] == 1
    torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
    pruned = np.setdiff1d(np.arange(cout), kept)
    assert (got[..., pruned] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [r for r in RFC_SHAPES if r[1] % 16 == 0])
def test_rfc_kernels_match_plain_exactly(cuda, rows, cols):
    x = torch.from_numpy(_rand(rows, rows, cols)).to(cuda)
    v, b = rp.rfc_encode_cuda(x)
    v2, b2 = rp.rfc_encode_plain(x)
    assert torch.equal(v, v2) and torch.equal(b, b2)
    assert torch.equal(rp.rfc_decode_cuda(v, b), rp.rfc_decode_plain(v, b))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(RFC_CASES))
def test_rfc_epilogue_kernels_match_plain_exactly(cuda, name):
    """The fused epilogue and encode, then the decode, bit-equal to their
    plain versions (the values' bits too, so -0.0 and +0.0 differ), one
    launch each, and bit-equal again on a repeated call."""
    args = _rfc_inputs(name, cuda)
    _build.reset_launch_counts()
    v, b = rp.rfc_encode_cuda(*args)
    out = rp.rfc_decode_cuda(v, b)
    assert _build.LAUNCHES["rfc_encode"] == _build.LAUNCHES["rfc_decode"] == 1
    v2, b2 = rp.rfc_encode_plain(*args)
    assert torch.equal(v.view(torch.int32), v2.view(torch.int32))
    assert torch.equal(b, b2)
    assert torch.equal(out.view(torch.int32),
                       rp.rfc_decode_plain(v2, b2).view(torch.int32))
    v3, b3 = rp.rfc_encode_cuda(*args)
    assert torch.equal(v3.view(torch.int32), v.view(torch.int32))
    assert torch.equal(b3, b)
    assert torch.equal(rp.rfc_decode_cuda(v, b).view(torch.int32),
                       out.view(torch.int32))


@pytest.mark.cuda
def test_rfc_encode_copies_what_it_cannot_read_in_place(cuda):
    """A non-contiguous t and res and contiguous views off a 16-byte
    boundary are copied by the wrapper; the answer is the plain
    version's."""
    h = torch.from_numpy(_rand(3, 2, 9, 6, 5, 32)).to(cuda)
    t = h[:, :8:2, ::2, :, :16]               # non-contiguous, C = 16
    res = h[:, 1::2, 1::2, :, 16:]
    assert not t.is_contiguous() and not res.is_contiguous()
    v, b = rp.rfc_encode_cuda(t, res)
    v2, b2 = rp.rfc_encode_plain(t, res)
    assert torch.equal(v, v2) and torch.equal(b, b2)
    # contiguous views that start one float off a 16-byte boundary
    flat = torch.from_numpy(_rand(4, 2 * t.numel() + 1)).to(cuda)
    t_off = flat[1:1 + t.numel()].view(t.shape)
    res_off = flat[1 + t.numel():].view(t.shape)
    v, b = rp.rfc_encode_cuda(t_off, res_off)
    v2, b2 = rp.rfc_encode_plain(t_off, res_off)
    assert torch.equal(v, v2) and torch.equal(b, b2)
    assert torch.equal(rp.rfc_decode_cuda(flat[1:1 + v.numel()].view(
        v.shape), b), rp.rfc_decode_plain(flat[1:1 + v.numel()].view(
            v.shape), b))
    with pytest.raises(ValueError, match="C % 16"):
        rp.rfc_encode_cuda(torch.zeros(4, 20, device=cuda))
    with pytest.raises(ValueError, match="keep needs"):
        rp.rfc_encode_cuda(t.contiguous(), keep=torch.ones(
            2, dtype=torch.bool, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,Ci,Co,name,eps", CSR_CASES + CSR_FULL_WIDTH)
def test_graph_sconv_csr_kernel_matches_plain(cuda, R, V, Ci, Co, name, eps):
    from repro_torch.core.agcn.graph import dense_to_csr, get_topology
    g = get_topology(name).adjacency + np.float32(1e-6)
    idx, val = (torch.from_numpy(a).to(cuda) for a in ops.pack_csr_ell(
        *dense_to_csr(g, eps), V))
    x, _, w = (torch.from_numpy(a).to(cuda)
               for a in _sconv_inputs(R, V, Ci, Co, 3))
    _build.reset_launch_counts()
    got = gs.graph_sconv_csr_cuda(x, idx, val, w)
    assert _build.LAUNCHES["graph_sconv_csr"] == 1
    torch.testing.assert_close(got, gs.graph_sconv_csr_plain(x, idx, val, w),
                               atol=1e-4, rtol=1e-4)
    with pytest.raises(TypeError, match="int32"):
        gs.graph_sconv_csr_cuda(x, idx.long(), val, w)


# (S, K, V, Ce, valid): agcn-2s's widths at V = 25, V = 50 with 25 live
# (a padded plan), hand21 and body_hand46, S up to 32, K = 9 (the kernel's
# unrolled ring) and 3 (its generic walk), widths off a multiple of 4
# (scalar entries)
WS_KERNEL_CASES = [
    (1, 9, 25, 4, 25), (3, 9, 25, 16, 25), (8, 9, 25, 32, 20),
    (8, 9, 25, 64, 25), (32, 9, 25, 16, 25), (8, 9, 50, 64, 25),
    (32, 9, 50, 32, 25), (8, 9, 21, 64, 21), (3, 9, 46, 32, 46),
    (2, 3, 7, 4, 5), (3, 3, 25, 64, 25), (2, 9, 9, 6, 9), (2, 3, 21, 6, 15)]

# (has_input, in_valid) per slot, cycled: a live frame, a flush frame, an
# input-skip frame, a skip with in_valid set (the ring is kept)
WS_SLOT_FLAGS = [(True, True), (True, False), (False, False), (False, True)]


def _ws_rings(S, K, V, Ce, zero, device):
    """Two (S, K, V, Ce) rings at the model's scale; ``zero``: "all" (a
    fresh slab: uniform rows), "slot" (slot 0 all zero) or "none"."""
    th, ph = (_rand(s, S, K, V, Ce, scale=0.3) for s in (1, 2))
    if zero == "all":
        th[:], ph[:] = 0.0, 0.0
    elif zero == "slot":
        th[0], ph[0] = 0.0, 0.0
    return tuple(torch.from_numpy(a).to(device) for a in (th, ph))


def _ws_step_inputs(S, K, V, Ce, device):
    """Embeddings, clocks past K and mixed slot flags of a step."""
    rng = np.random.default_rng(S + K + V)
    e_th, e_ph = (torch.from_numpy(_rand(s, S, V, Ce, scale=0.3)).to(device)
                  for s in (3, 4))
    t = torch.from_numpy(rng.integers(0, 3 * K, S).astype(np.int32)).to(device)
    flags = [WS_SLOT_FLAGS[s % len(WS_SLOT_FLAGS)] for s in range(S)]
    has, inv = (torch.tensor([f[i] for f in flags], device=device)
                for i in (0, 1))
    return e_th, e_ph, t, has, inv


@pytest.mark.cuda
@pytest.mark.parametrize("zero", ["none", "slot", "all"])
@pytest.mark.parametrize("S,K,V,Ce,valid", WS_KERNEL_CASES)
def test_windowed_similarity_kernel_matches_plain(cuda, S, K, V, Ce, valid,
                                                  zero):
    th, ph = _ws_rings(S, K, V, Ce, zero, cuda)
    _build.reset_launch_counts()
    got = ws.windowed_similarity_cuda(th, ph, valid)
    assert _build.LAUNCHES["windowed_similarity"] == 1
    torch.testing.assert_close(got, ws.windowed_similarity_plain(th, ph, valid),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("zero", ["none", "slot"])
@pytest.mark.parametrize("S,K,V,Ce,valid", WS_KERNEL_CASES)
def test_windowed_similarity_step_kernel_matches_plain(cuda, S, K, V, Ce,
                                                       valid, zero):
    th, ph = _ws_rings(S, K, V, Ce, zero, cuda)
    step = _ws_step_inputs(S, K, V, Ce, cuda)
    old = (th.clone(), ph.clone())
    want = ws.windowed_similarity_step_plain(th, ph, *step, valid)
    _build.reset_launch_counts()
    got = ws.windowed_similarity_step_cuda(th, ph, *step, valid)
    assert _build.LAUNCHES["windowed_similarity"] == 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    torch.testing.assert_close(got[2], want[2], atol=1e-4, rtol=1e-4)
    assert torch.equal(th, old[0]) and torch.equal(ph, old[1])
    with pytest.raises(TypeError, match="int32"):
        ws.windowed_similarity_step_cuda(th, ph, step[0], step[1],
                                         step[2].long(), *step[3:], valid)


@pytest.mark.cuda
@pytest.mark.parametrize("Ce", [4, 16, 32, 64])
def test_windowed_similarity_padded_plan_matches_narrow(cuda, Ce):
    """Rings padded from 25 to 50 joints with zeros, 25 live columns (a
    padded plan): both forms give the narrow rings' graph rows and new
    ring rows bit for bit."""
    th, ph = _ws_rings(8, 9, 25, Ce, "none", cuda)
    step = _ws_step_inputs(8, 9, 25, Ce, cuda)
    pad = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 25))
    step_p = (pad(step[0]), pad(step[1]), *step[2:])
    narrow = ws.windowed_similarity_step_cuda(th, ph, *step, 25)
    padded = ws.windowed_similarity_step_cuda(pad(th), pad(ph), *step_p, 25)
    assert torch.equal(padded[2][:, :25, :25], narrow[2])
    assert torch.equal(padded[0][:, :, :25], narrow[0])
    assert torch.equal(padded[1][:, :, :25], narrow[1])
    assert not padded[2][:, :, 25:].any()
    assert torch.equal(ws.windowed_similarity_cuda(pad(th), pad(ph), 25)[
        :, :25, :25], ws.windowed_similarity_cuda(th, ph, 25))


@pytest.mark.cuda
@pytest.mark.parametrize("S,K,V,Ce,valid", [(8, 9, 25, 64, 25),
                                            (8, 9, 50, 16, 25),
                                            (3, 3, 21, 6, 21)])
def test_windowed_similarity_every_plan_matches_plain(cuda, S, K, V, Ce,
                                                      valid):
    """Plans the planner does not pick (a row a block, rows past the
    warps, several load rounds) in both forms."""
    th, ph = _ws_rings(S, K, V, Ce, "none", cuda)
    step = _ws_step_inputs(S, K, V, Ce, cuda)
    want = ws.windowed_similarity_plain(th, ph, valid)
    want_step = ws.windowed_similarity_step_plain(th, ph, *step, valid)
    for rows in (1, 4, 7, V):
        for threads in (32, 128, 512):
            p = ws.make_sim_plan(S, K, V, Ce, rows, threads)
            torch.testing.assert_close(
                ws.windowed_similarity_cuda(th, ph, valid, plan=p), want,
                atol=1e-4, rtol=1e-4)
            got = ws.windowed_similarity_step_cuda(th, ph, *step, valid,
                                                   plan=p)
            assert torch.equal(got[0], want_step[0])
            assert torch.equal(got[1], want_step[1])
            torch.testing.assert_close(got[2], want_step[2], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hkv,G,D,valid", FD_SHAPES + [
    (4, 512, 5, 3, 64, 497), (4, 4096, 8, 4, 80, 4096), (2, 100, 2, 5, 16, 0),
    (2, 100, 2, 5, 16, 300), (1, 300, 1, 9, 128, 129)])
def test_flash_decode_kernel_matches_plain(cuda, B, S, Hkv, G, D, valid):
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _fd_inputs(B, S, Hkv, G, D))
    want = fd.flash_decode_plain(q, k, v, valid)
    _build.reset_launch_counts()
    for vt in (valid, torch.tensor([valid], dtype=torch.int32, device=cuda)):
        torch.testing.assert_close(fd.flash_decode(q, k, v, vt), want,
                                   atol=1e-4, rtol=1e-4)
    assert _build.LAUNCHES["flash_decode"] == 2
    with pytest.raises(TypeError, match="int32"):
        fd.flash_decode(q, k, v, torch.tensor([valid], device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hkv,G,D,valid", FD_SPLIT_CASES + [
    (4, 512, 5, 3, 64, 17), (8, 32768, 5, 3, 64, 30000),
    (2, 300, 2, 3, 33, 200), (1, 64, 1, 6, 33, 0)])
def test_flash_decode_split_plans_match_plain(cuda, B, S, Hkv, G, D, valid):
    """Every forced plan (1, 2 and the most splits; 1 to 8 warps; 2 to 6
    stages) against the plain version, and two calls bit-equal: the
    served early step, the long context, odd D (4-byte staging)."""
    q, k, v = (torch.from_numpy(a).to(cuda) for a in _fd_inputs(B, S, Hkv, G, D))
    vt = torch.tensor([valid], dtype=torch.int32, device=cuda)
    want = fd.flash_decode_plain(q, k, v, vt)
    plans = _fd_forced(B, S, Hkv, G, D)
    assert {p.splits for p in plans} >= {1, 2}
    for plan in plans:
        got = fd.flash_decode(q, k, v, vt, plan=plan)
        assert torch.equal(got, fd.flash_decode(q, k, v, vt, plan=plan)), plan
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"{plan}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hkv,G,D,valid,window", FD_WIDE_CASES)
def test_flash_decode_wide_and_window_match_plain(cuda, B, S, Hkv, G, D,
                                                  valid, window):
    """D up to 256 (the wide instantiations) and the sliding window's
    lower bound, read from valid on the card: the decode plan and every
    forced plan that fits against the plain version (atol = rtol =
    1e-4), two calls bit-equal, one launch a call."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _fd_inputs(B, S, Hkv, G, D))
    vt = torch.tensor([valid], dtype=torch.int32, device=cuda)
    want = fd.flash_decode_plain(q, k, v, vt, window)
    plans = _fd_forced(B, S, Hkv, G, D)
    _build.reset_launch_counts()
    for plan in plans:
        got = fd.flash_decode(q, k, v, vt, window=window, plan=plan)
        assert torch.equal(got, fd.flash_decode(q, k, v, vt, window=window,
                                                plan=plan)), plan
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4,
                                   msg=lambda m: f"{plan}: {m}")
    assert _build.LAUNCHES["flash_decode"] == 2 * len(plans)
    if window:      # the window changes the result where it bounds
        full = fd.flash_decode_plain(q, k, v, vt)
        assert torch.equal(want, full) == (valid - window <= 0)



@pytest.mark.cuda
@pytest.mark.parametrize("B,S,Hkv,G,D,valid,window", FD_BF16_CASES)
def test_flash_decode_bf16_cache_matches_plain(cuda, B, S, Hkv, G, D, valid,
                                               window):
    """A bf16 cache (float32 q and out): the decode plan and every forced
    plan that fits against the plain version's bf16 rules within
    ``fd.bf16_bound`` (which the plain version under float32 rules
    exceeds wherever the rounding moves the result), two calls bit-equal,
    one launch a call; a mixed or a float16 cache raises."""
    q, k, v = (torch.from_numpy(a).to(cuda)
               for a in _fd_inputs(B, S, Hkv, G, D))
    k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
    vt = torch.tensor([valid], dtype=torch.int32, device=cuda)
    want = fd.flash_decode_plain(q, k, v, vt, window)
    assert want.dtype == torch.float32
    gap = fd.bf16_rounding_gap(q, k, v, vt, window, want)
    bound = fd.bf16_bound(gap, fd.BF16_CAP_RANDOM)
    assert gap > bound or gap <= 2 * fd.BF16_FLOOR, (gap, bound)
    plans = _fd_forced(B, S, Hkv, G, D)
    _build.reset_launch_counts()
    for plan in plans:
        got = fd.flash_decode(q, k, v, vt, window=window, plan=plan)
        assert got.dtype == torch.float32
        assert torch.equal(got, fd.flash_decode(q, k, v, vt, window=window,
                                                plan=plan)), plan
        err = float((got - want).abs().max())
        assert err <= bound, (plan, err, bound, gap)
    assert _build.LAUNCHES["flash_decode"] == 2 * len(plans)
    with pytest.raises(TypeError, match="bfloat16"):
        fd.flash_decode(q, k, v.float(), vt)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fd.flash_decode(q, k.half(), v.half(), vt)
