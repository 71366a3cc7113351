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
    v, h = rp.rfc_encode_cuda(x)
    v2, h2 = rp.rfc_encode_plain(x)
    assert torch.equal(v, v2) and torch.equal(h, h2)
    assert torch.equal(rp.rfc_decode_cuda(v, h), rp.rfc_decode_plain(v, h))


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


@pytest.mark.cuda
@pytest.mark.parametrize("zero", [False, True])
@pytest.mark.parametrize("S,K,V,Ce,valid", [
    (1, 9, 25, 4, 25), (3, 9, 25, 16, 25), (8, 9, 50, 64, 25),
    (8, 9, 25, 32, 20), (2, 3, 7, 4, 5)])
def test_windowed_similarity_kernel_matches_plain(cuda, S, K, V, Ce, valid,
                                                  zero):
    scale = 0.0 if zero else 0.3
    th, ph = (torch.from_numpy(_rand(s, S, K, V, Ce) * scale).to(cuda)
              for s in (1, 2))
    _build.reset_launch_counts()
    got = ws.windowed_similarity_cuda(th, ph, valid)
    assert _build.LAUNCHES["windowed_similarity"] == 1
    torch.testing.assert_close(got, ws.windowed_similarity_plain(th, ph, valid),
                               atol=1e-4, rtol=1e-4)


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
