"""Port kernels on the CPU: each plain version and ``ops`` wrapper against
the JAX oracles in ``repro.kernels.ref`` (the CSR spatial conv and the
windowed similarity are held to JAX in test_torch_topology.py and
test_torch_adaptive.py), and the streaming cavity tconv
against the JAX reference engine's einsum (atol=rtol=1e-5: both sides sum
in float32, in different orders), graph_sconv and RFC also against the Pallas
kernels in interpret mode (1e-4 for graph_sconv, whose interpret-mode
error against its own oracle reaches 2.3e-5; RFC is data movement and
must match exactly), and flash_decode against the Pallas kernel in
interpret mode and its oracle (3e-5, the JAX package's own bound).  The
CUDA kernels against their plain versions run
only on a card (marked ``cuda``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.pruning.cavity import cavity_pattern, tile_pattern
from repro_torch.kernels import _build, ops
from repro_torch.kernels import cavity_tconv as ct
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import graph_sconv as gs
from repro_torch.kernels import ref
from repro_torch.kernels import rfc_pack as rp
from repro_torch.kernels import window_sim as ws

TOL = dict(atol=1e-5, rtol=1e-5)


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


# ---------------------------------------------------------------- graph_sconv

SCONV_SHAPES = [(32, 25, 16, 32, 3), (64, 25, 3, 8, 3), (7, 25, 38, 64, 3),
                (16, 5, 9, 20, 2)]


@pytest.mark.parametrize("R,V,Ci,Co,K", SCONV_SHAPES)
def test_graph_sconv_matches_jax(R, V, Ci, Co, K):
    x, g, w = _sconv_inputs(R, V, Ci, Co, K)
    want = np.asarray(jref.graph_sconv_ref(x, g, w))
    tx, tg, tw = map(torch.from_numpy, (x, g, w))
    for got in (gs.graph_sconv_plain(tx, tg, tw), gs.graph_sconv_cuda(tx, tg, tw),
                ref.graph_sconv_ref(tx, tg, tw)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    got = ops.graph_sconv(tx.reshape(1, R, V, Ci), tg, tw).reshape(R, V, Co)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    pallas = np.asarray(jops.graph_sconv(jnp.asarray(x)[None], g, w))[0]
    np.testing.assert_allclose(got.numpy(), pallas, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------- cavity_tconv

# (B, T, C, F, stride, pattern): odd T into stride 2, F not a multiple of 8
TCONV_CASES = [(4, 32, 16, 16, 1, "cav-70-1"), (3, 15, 8, 38, 2, "cav-70-1"),
               (2, 75, 4, 77, 2, "cav-70-1"), (5, 20, 8, 13, 1, "none"),
               (2, 9, 6, 24, 2, "cav-50-1")]


@pytest.mark.parametrize("B,T,C,F,stride,pattern", TCONV_CASES)
def test_cavity_tconv_matches_jax(B, T, C, F, stride, pattern):
    mask = tile_pattern(cavity_pattern(pattern), F)
    w = _rand(F, F, C, 9) * mask[:, None, :]
    x = _rand(B * T, B, T, C)
    want = np.asarray(jref.cavity_tconv_ref(x, w, stride=stride))
    assert want.shape[1] == (T - 1) // stride + 1
    np.testing.assert_allclose(
        ref.cavity_tconv_ref(torch.from_numpy(x), torch.from_numpy(w),
                             stride).numpy(), want, **TOL)
    wp, taps, inv = ops.pack_cavity_weights(w, mask)
    got = ops.cavity_tconv(torch.from_numpy(x), torch.from_numpy(wp),
                           torch.from_numpy(taps),
                           torch.from_numpy(inv).long(), F, stride=stride)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_cavity_tconv_plain_is_the_kernel_contract():
    """The plain version computes the kernel's function: on (N, T, V, C)
    as it lies, every group's kept taps, 'same' zero padding, strided, each
    filter in its natural place of the (N, T_out, V, F) output."""
    F_, C, V = 24, 8, 3
    mask = tile_pattern(cavity_pattern("cav-70-1"), F_)
    w = _rand(1, F_, C, 9) * mask[:, None, :]
    wp, taps, inv = ops.pack_cavity_weights(w, mask)
    x = torch.from_numpy(_rand(2, 2, 17, V, C))
    out = ct.cavity_tconv_cuda(x, torch.from_numpy(wp), torch.from_numpy(taps),
                               torch.from_numpy(inv).long(), F_ - 2,
                               kernel_size=9, stride=2)
    assert out.shape == (2, 9, V, F_ - 2)
    for f in range(F_ - 2):
        for v in range(V):
            want = torch.nn.functional.conv1d(
                x[:, :, v].transpose(1, 2), torch.from_numpy(w[f:f + 1]),
                stride=2, padding=4)
            torch.testing.assert_close(out[:, :, v, f], want[:, 0], **TOL)


# ------------------------------------------------------ cavity_tconv, step

# (B, C, F, pattern): F not a multiple of 8, dense and pruned tap sets
STEP_CASES = [(25, 16, 16, "cav-70-1"), (75, 8, 38, "cav-70-1"),
              (50, 4, 77, "none"), (3, 6, 24, "cav-50-1"),
              (200, 12, 13, "cav-70-1")]


@pytest.mark.parametrize("B,C,F,pattern", STEP_CASES)
def test_cavity_tconv_step_matches_reference_einsum(B, C, F, pattern):
    """The plain version through the packing, and ``ops.cavity_tconv_step``
    with its filter permutation, equal the JAX reference backend's einsum
    over the dense masked weights (``engine.temporal_step``)."""
    mask = tile_pattern(cavity_pattern(pattern), F)
    w = _rand(F, F, C, 9) * mask[:, None, :]
    x = _rand(B + C, B, 9, C)
    win = x.transpose(1, 0, 2)[None]          # (N=1, K, V=B, C)
    want = np.asarray(jnp.einsum("nkvc,fck->nvf", win, w))[0]
    np.testing.assert_allclose(
        ref.cavity_tconv_step_ref(torch.from_numpy(win),
                                  torch.from_numpy(w))[0].numpy(), want, **TOL)
    wp, taps, inv = ops.pack_cavity_weights(w, mask)
    twp, ttaps = torch.from_numpy(wp), torch.from_numpy(taps)
    tx = torch.from_numpy(x)
    got = ops.cavity_tconv_step(tx, twp, ttaps, torch.from_numpy(inv).long(),
                                F)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    plain = ct.cavity_tconv_step_plain(tx, twp, ttaps)
    assert plain.shape == (B, 8, wp.shape[-1])
    assert torch.equal(ct.cavity_tconv_step_cuda(tx, twp, ttaps), plain)
    for g in range(8):       # group g, slot i holds filter g + 8 i
        for i in range(wp.shape[-1]):
            if g + 8 * i < F:
                np.testing.assert_allclose(plain[:, g, i].numpy(),
                                           want[:, g + 8 * i], **TOL)


def test_cavity_tconv_step_reads_only_kept_taps():
    """The pruned taps' frames do not reach the output: poisoning them
    changes nothing."""
    F_, C = 16, 8
    mask = tile_pattern(cavity_pattern("cav-70-1"), F_)
    wp, taps, _ = ops.pack_cavity_weights(_rand(2, F_, C, 9), mask)
    x = torch.from_numpy(_rand(3, 10, 9, C))
    kept = set(np.asarray(taps).ravel().tolist())
    poisoned = x.clone()
    for k in set(range(9)) - kept:
        poisoned[:, k] = float("nan")
    args = (torch.from_numpy(wp), torch.from_numpy(taps))
    assert torch.equal(ct.cavity_tconv_step_plain(poisoned, *args),
                       ct.cavity_tconv_step_plain(x, *args))


# ------------------------------------------------------------------------ RFC

# (rows, C): C not a multiple of 16 in the ops cases
RFC_SHAPES = [(8, 16), (32, 64), (100, 48), (7, 160), (9, 38), (5, 3)]


@pytest.mark.parametrize("rows,cols", RFC_SHAPES)
def test_rfc_encode_decode_match_jax(rows, cols):
    x = _rand(rows + cols, rows, cols)
    x[x > 1.0] = 0.0                              # some all-cold banks too
    tx = torch.from_numpy(x)
    v_ops, h_ops = ops.rfc_encode(tx)
    v_pal, h_pal = jops.rfc_encode(jnp.asarray(x))
    np.testing.assert_array_equal(v_ops.numpy(), np.asarray(v_pal))
    np.testing.assert_array_equal(h_ops.numpy(), np.asarray(h_pal))
    dec = ops.rfc_decode(v_ops, h_ops)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jops.rfc_decode(v_pal, h_pal)))
    if cols % 16 == 0:
        v_ref, h_ref = jref.rfc_encode_ref(x)
        for enc in (rp.rfc_encode_plain(tx), rp.rfc_encode_cuda(tx),
                    ref.rfc_encode_ref(tx)):
            np.testing.assert_allclose(enc[0].numpy(), np.asarray(v_ref), **TOL)
            np.testing.assert_array_equal(enc[1].numpy(), np.asarray(h_ref))
        want = np.asarray(jref.rfc_decode_ref(v_ref, h_ref))
        for dec in (rp.rfc_decode_plain(v_ops, h_ops),
                    rp.rfc_decode_cuda(v_ops, h_ops),
                    ref.rfc_decode_ref(v_ops, h_ops)):
            np.testing.assert_allclose(dec.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", [(100, 48), (2, 5, 64), (3, 7, 25, 38)])
def test_rfc_roundtrip_equals_relu_bit_for_bit(shape):
    x = torch.from_numpy(_rand(len(shape), *shape))
    out = ops.rfc_decode(*ops.rfc_encode(x))
    assert out.shape == x.shape
    assert torch.equal(out, torch.relu(x))


def test_rfc_wrapper_rejects_partial_banks():
    with pytest.raises(ValueError, match="not divisible"):
        rp.rfc_encode_cuda(torch.zeros(4, 20))


# ---------------------------------------------------------------- flash_decode

# (B, S, Hkv, G, D, valid): the JAX package's three shapes, a small odd one
# (D = 20 as in reduced smollm, one live slot) and reduced danube's ring
FD_SHAPES = [(1, 512, 2, 4, 32, 512), (2, 1024, 4, 3, 64, 700),
             (3, 512, 1, 1, 128, 17), (2, 48, 1, 3, 20, 1),
             (2, 16, 2, 2, 16, 16)]


def _fd_inputs(B, S, Hkv, G, D):
    return (_rand(B * S, B, Hkv, G, D), _rand(B * S + 1, B, S, Hkv, D),
            _rand(B * S + 2, B, S, Hkv, D))


@pytest.mark.parametrize("B,S,Hkv,G,D,valid", FD_SHAPES)
def test_flash_decode_matches_jax(B, S, Hkv, G, D, valid):
    from repro.kernels.flash_decode import flash_decode_pallas
    q, k, v = _fd_inputs(B, S, Hkv, G, D)
    pallas = np.asarray(flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(valid, jnp.int32)))
    oracle = np.asarray(jref.flash_decode_ref(q, k, v, valid))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for vt in (valid, torch.tensor([valid], dtype=torch.int32)):
        for got in (fd.flash_decode_plain(tq, tk, tv, vt),
                    fd.flash_decode(tq, tk, tv, vt),
                    ref.flash_decode_ref(tq, tk, tv, vt)):
            for want in (pallas, oracle):
                np.testing.assert_allclose(got.numpy(), want, atol=3e-5,
                                           rtol=3e-5)


def test_flash_decode_wrapper_rejects_mismatched_shapes():
    q, k, v = map(torch.from_numpy, _fd_inputs(2, 16, 2, 3, 8))
    with pytest.raises(ValueError, match="does not match"):
        fd.flash_decode(q[:, :1], k, v, 4)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, v[:, :8], 4)


def test_cpu_dispatch_counts_no_launches():
    _build.reset_launch_counts()
    x = torch.from_numpy(_rand(0, 4, 25, 3))
    gs.graph_sconv_cuda(x, torch.ones(3, 25, 25), torch.ones(3, 3, 8))
    ops.rfc_decode(*ops.rfc_encode(x))
    wp = torch.ones(8, 3, 3, 1)
    taps = torch.zeros(8, 3, dtype=torch.int32)
    ct.cavity_tconv_cuda(torch.ones(2, 12, 1, 3), wp, taps,
                         torch.arange(8, dtype=torch.int64), 8, 9, 1)
    ct.cavity_tconv_step_cuda(torch.ones(2, 9, 3), wp, taps)
    gs.graph_sconv_csr_cuda(x, torch.zeros(3, 25, 2, dtype=torch.int32),
                            torch.ones(3, 25, 2), torch.ones(3, 3, 8))
    ws.windowed_similarity_cuda(torch.ones(2, 9, 25, 4),
                                torch.ones(2, 9, 25, 4), 20)
    fd.flash_decode(torch.ones(2, 1, 3, 20), torch.ones(2, 8, 1, 20),
                    torch.ones(2, 8, 1, 20), 3)
    assert {"cavity_tconv_step", "graph_sconv_csr", "windowed_similarity",
            "flash_decode"} <= set(_build.KERNELS)
    assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0)


# ------------------------------------------------ CUDA kernels (card only)

@pytest.mark.cuda
@pytest.mark.parametrize("R,V,Ci,Co,K", SCONV_SHAPES + [
    (2400, 25, 3, 64, 3), (608, 25, 77, 256, 3), (1200, 50, 90, 256, 3),
    (8, 50, 90, 256, 3), (8, 25, 77, 256, 3), (300, 50, 256, 256, 3)])
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
        _rand(F, F, C, 9) * mask[:, None, :] / np.sqrt(C), mask)
    x = torch.from_numpy(_rand(B, B, 9, C)).to(cuda)
    wp, taps = torch.from_numpy(wp).to(cuda), torch.from_numpy(taps).to(cuda)
    if C % 4:       # the kernel takes whole float4s; ops pads C with zeros
        with pytest.raises(ValueError, match="multiple of 4"):
            ct.cavity_tconv_step_cuda(x, wp, taps)
        x, wp = ops._pad_to(x, 2, 4), ops._pad_to(wp, 2, 4).contiguous()
    torch.testing.assert_close(ct.cavity_tconv_step_cuda(x, wp, taps),
                               ct.cavity_tconv_step_plain(x, wp, taps),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [r for r in RFC_SHAPES if r[1] % 16 == 0])
def test_rfc_kernels_match_plain_exactly(cuda, rows, cols):
    x = torch.from_numpy(_rand(rows, rows, cols)).to(cuda)
    v, h = rp.rfc_encode_cuda(x)
    v2, h2 = rp.rfc_encode_plain(x)
    assert torch.equal(v, v2) and torch.equal(h, h2)
    assert torch.equal(rp.rfc_decode_cuda(v, h), rp.rfc_decode_plain(v, h))


# (R, V, Cin, Cout, topology, csr_eps): the clip and stream-tick shapes of
# an ntu50 plan, D = the skeleton's degree (eps 1e-5) and D = V (eps 0)
CSR_CASES = [(32, 50, 16, 32, "ntu50", 1e-5), (8, 50, 256, 256, "ntu50", 1e-5),
             (7, 50, 38, 64, "ntu50", 0.0), (2400, 50, 3, 64, "ntu50", 1e-5),
             (5, 21, 9, 20, "hand21", 0.0), (64, 46, 77, 128, "body_hand46",
                                              1e-5)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,V,Ci,Co,name,eps", CSR_CASES)
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
