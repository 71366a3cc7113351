"""Port kernels on the CPU: each plain version and ``ops`` wrapper against
the JAX oracles in ``repro.kernels.ref`` (the CSR spatial conv and the
windowed similarity are held to JAX in test_torch_topology.py and
test_torch_adaptive.py), and the streaming cavity tconv
against the JAX reference engine's einsum (atol=rtol=1e-5: both sides sum
in float32, in different orders), graph_sconv and RFC also against the Pallas
kernels in interpret mode (1e-4 for graph_sconv, whose interpret-mode
error against its own oracle reaches 2.3e-5; RFC is data movement and
must match exactly), and flash_decode against the Pallas kernel in
interpret mode and its oracle (3e-5, the JAX package's own bound), also
through a torch emulation of the CUDA kernel's split-and-merge at forced
plans, beside checks of ``decode_plan``'s picks.  The
CUDA kernels against their plain versions run only on a card, from the
JAX-free ``tests/test_torch_cuda_kernels.py``, which also holds the case
lists and input helpers shared here."""
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
from test_torch_cuda_kernels import (FD_SHAPES, FD_SPLIT_CASES, RFC_SHAPES,
                                     SCONV_SHAPES, STEP_CASES, TCONV_CASES,
                                     _fd_forced, _fd_inputs, _rand,
                                     _sconv_inputs)

TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- graph_sconv

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


@pytest.mark.parametrize("shape,want", [
    ((4, 512, 5, 3, 64), (4, 4, 2)),      # served smollm-360m step
    ((8, 32768, 5, 3, 64), (8, 8, 2)),    # long context
    ((4, 4096, 8, 4, 80), (2, 8, 2)),     # h2o-danube's ring
    ((2, 48, 1, 3, 20), (1, 1, 2)),       # small odd: 3 tiles
    ((1, 300, 1, 9, 128), (4, 2, 2))])    # G = 9: 3 blocks of 3 rows
def test_decode_plan_picks(shape, want):
    p = fd.decode_plan(*shape)
    assert (p.splits, p.warps, p.stages) == want
    B, S, Hkv, G, D = shape
    assert p.grid == (p.splits, Hkv * -(-G // fd.query_rows(G, D)), B)
    assert p == fd.make_plan(*shape, *want)


@pytest.mark.parametrize("S", [1, 16, 17, 47, 100, 512, 4096, 32768])
@pytest.mark.parametrize("B,Hkv,G,D", [(1, 1, 1, 16), (4, 5, 3, 64),
                                       (2, 2, 9, 128), (1, 1, 6, 33)])
def test_decode_plan_never_more_splits_than_tiles(B, S, Hkv, G, D):
    p = fd.decode_plan(B, S, Hkv, G, D)
    tiles = -(-S // fd.TILE_ROWS)
    assert 1 <= p.splits <= min(tiles, fd.MAX_SPLITS)
    assert p.warps in fd.WARPS and p.stages in fd.STAGES
    assert p.smem == fd.decode_smem_bytes(D, G, p.splits, p.warps, p.stages)
    assert p.smem <= fd.SMEM_MAX
    with pytest.raises(ValueError):
        fd.make_plan(B, S, Hkv, G, D, tiles + 1, 1, 2)


def test_decode_plan_query_rows():
    assert [fd.query_rows(G, 64) for G in (1, 3, 4, 5, 8, 9)] == \
        [1, 3, 4, 3, 4, 3]
    assert fd.query_rows(3, 33) == 4          # 4-byte staging: 4 rows


def _merge(parts):
    """(m, l, acc) partials merged in list order, base 2; an empty
    partial (m = -inf) weighs 0."""
    M = torch.stack([m for m, _, _ in parts]).amax(0)
    ref = torch.where(M == -torch.inf, torch.zeros_like(M), M)
    L, A = None, None
    for m, l, acc in parts:
        w = torch.exp2(m - ref)
        L = l * w if L is None else L + l * w
        A = acc * w[..., None] if A is None else A + acc * w[..., None]
    return M, L, A


def _fd_split_emulation(q, k, v, valid, plan):
    """csrc/flash_decode.cu's split-and-merge in torch (tests only): split
    p of the cluster takes rows [p·span, (p+1)·span) of the first n, span
    = ceil(n / splits) rounded up to 16; warp w its 16-row tiles w, w + W,
    ...; 8-lane group j rows j, j + 4, ... of each tile, one online-softmax
    update per tile on base-2 logits (q prescaled by log2(e)/sqrt(D));
    then groups merge pairwise (0+1, 2+3, then both), warps and splits in
    order, and the sum divides by max(l, 1e-20)."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    n = valid if 1 <= valid < S else S
    s2 = torch.einsum("bhgd,bshd->bhgs", q * (np.log2(np.e) / np.sqrt(D)), k)
    if valid <= 0:
        s2 = torch.full_like(s2, -1e30)
    empty = (torch.full(q.shape[:3], -torch.inf), torch.zeros(q.shape[:3]),
             torch.zeros(q.shape))
    span = -(-(-(-n // plan.splits)) // 16) * 16
    splits = []
    for p in range(plan.splits):
        r0, r1 = min(n, p * span), min(n, p * span + span)
        starts = list(range(r0, r1, 16))
        warps = []
        for w in range(plan.warps):
            groups = []
            for j in range(4):
                m, l, acc = empty
                for s0 in starts[w::plan.warps]:
                    rows = [r for r in range(s0 + j, min(s0 + 16, r1), 4)]
                    if not rows:
                        continue
                    s = s2[..., rows]
                    mn = torch.maximum(m, s.amax(-1))
                    corr = torch.exp2(m - mn)
                    pr = torch.exp2(s - mn[..., None])
                    l = l * corr + pr.sum(-1)
                    acc = acc * corr[..., None] + torch.einsum(
                        "bhgs,bshd->bhgd", pr, v[:, rows])
                    m = mn
                groups.append((m, l, acc))
            warps.append(_merge([_merge(groups[:2]), _merge(groups[2:])]))
        splits.append(_merge(warps))
    _, L, A = _merge(splits)
    return A / torch.clamp(L, min=1e-20)[..., None]


@pytest.mark.parametrize("B,S,Hkv,G,D,valid", FD_SPLIT_CASES)
def test_flash_decode_split_merge_matches_jax(B, S, Hkv, G, D, valid):
    """The kernel's split-and-merge, emulated at every forced plan, against
    the Pallas kernel (interpret mode) and the JAX oracle (3e-5)."""
    from repro.kernels.flash_decode import flash_decode_pallas
    q, k, v = _fd_inputs(B, S, Hkv, G, D)
    pallas = np.asarray(flash_decode_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(valid, jnp.int32)))
    oracle = np.asarray(jref.flash_decode_ref(q, k, v, valid))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    plans = _fd_forced(B, S, Hkv, G, D)
    assert len({p.splits for p in plans}) >= 3
    for plan in plans:
        got = _fd_split_emulation(tq, tk, tv, valid, plan).numpy()
        for want in (pallas, oracle):
            np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5,
                                       err_msg=str(plan))


def test_flash_decode_split_emulation_leaves_splits_empty():
    """valid = 17 of 512 slots at 16 splits: two splits hold rows, the
    other fourteen are empty partials, and the merge still matches."""
    q, k, v = map(torch.from_numpy, _fd_inputs(2, 512, 2, 3, 64))
    plan = fd.make_plan(2, 512, 2, 3, 64, 16, 2, 3)
    got = _fd_split_emulation(q, k, v, 17, plan)
    torch.testing.assert_close(got, fd.flash_decode_plain(q, k, v, 17),
                               atol=3e-5, rtol=3e-5)


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
