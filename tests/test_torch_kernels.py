"""Port kernels on the CPU: each plain version and ``ops`` wrapper against
the JAX oracles in ``repro.kernels.ref`` (the CSR spatial conv and the
windowed similarity are held to JAX in test_torch_topology.py and
test_torch_adaptive.py), and the streaming cavity tconv
against the JAX reference engine's einsum (atol=rtol=1e-5: both sides sum
in float32, in different orders), graph_sconv and RFC also against the Pallas
kernels in interpret mode (1e-4 for graph_sconv, whose interpret-mode
error against its own oracle reaches 2.3e-5; RFC is data movement and
must match exactly, its fused epilogue and packed bits included, also
through a torch emulation of the CUDA kernels' lane math), and
flash_decode against the Pallas kernel in interpret mode and its oracle
(3e-5, the JAX package's own bound), also
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
from test_torch_cuda_kernels import (FD_BF16_CASES, FD_SHAPES,
                                     FD_SPLIT_CASES, RFC_CASES,
                                     RFC_SHAPES, SCONV_SHAPES, STEP_CASES,
                                     TCONV_CASES, _fd_forced, _fd_inputs,
                                     _rand, _rfc_inputs, _sconv_inputs)

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

def _hot(bits, cols):
    """The JAX float hot mask of the port's bank words, cut to ``cols``."""
    return rp.hot_from_bits(bits)[..., :cols].numpy()


@pytest.mark.parametrize("rows,cols", RFC_SHAPES)
def test_rfc_encode_decode_match_jax(rows, cols):
    x = _rand(rows + cols, rows, cols)
    x[x > 1.0] = 0.0                              # some all-cold banks too
    tx = torch.from_numpy(x)
    v_ops, b_ops = ops.rfc_encode(tx)
    assert b_ops.dtype == torch.int16 and b_ops.shape == (rows,
                                                          -(-cols // 16))
    v_pal, h_pal = jops.rfc_encode(jnp.asarray(x))
    np.testing.assert_array_equal(v_ops.numpy(), np.asarray(v_pal))
    np.testing.assert_array_equal(_hot(b_ops, cols), np.asarray(h_pal))
    dec = ops.rfc_decode(v_ops, b_ops)
    np.testing.assert_array_equal(
        dec.numpy(), np.asarray(jops.rfc_decode(v_pal, h_pal)))
    if cols % 16 == 0:
        v_ref, h_ref = jref.rfc_encode_ref(x)
        for v, b in (rp.rfc_encode_plain(tx), rp.rfc_encode_cuda(tx)):
            np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
            np.testing.assert_array_equal(_hot(b, cols), np.asarray(h_ref))
        v, h = ref.rfc_encode_ref(tx)
        np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
        assert torch.equal(rp.bits_from_hot(h), b_ops)
        want = np.asarray(jref.rfc_decode_ref(v_ref, h_ref))
        for dec in (rp.rfc_decode_plain(v_ops, b_ops),
                    rp.rfc_decode_cuda(v_ops, b_ops),
                    ref.rfc_decode_ref(v_ops, rp.hot_from_bits(b_ops))):
            np.testing.assert_array_equal(dec.numpy(), want)


def _jax_epilogue_encode(t, res, live, keep, old):
    """The JAX side of the fused epilogue: relu(t + res), masked joints
    zeroed, through the Pallas encode in interpret mode (``jops`` pads C);
    slots outside ``keep`` take the old values and mask."""
    x = np.maximum(t + (0 if res is None else res), 0).astype(np.float32)
    if live is not None:
        x = np.where(live[:, None], x, np.float32(0))
    v, h = (np.array(a) for a in jops.rfc_encode(jnp.asarray(x)))
    if keep is not None:
        k = keep.reshape((-1,) + (1,) * (t.ndim - 1))
        v = np.where(k, v, old["vals"].numpy())
        h = np.where(k, h, _hot(old["bits"], t.shape[-1]))
    return v, h


@pytest.mark.parametrize("name", list(RFC_CASES))
def test_rfc_epilogue_encode_matches_jax(name):
    """``ops.rfc_encode(t, res, live=, keep=, old=)`` against JAX's
    ReLU and Pallas encode (interpret mode) and, with the float mask, its
    ``ref`` oracle: values bit-equal, the bits the JAX mask packed; the
    decode equals relu(t + res) masked, bit for bit."""
    t, res, live, keep, old = _rfc_inputs(name, "cpu")
    cols = t.shape[-1]
    vals, bits = ops.rfc_encode(t, res, live=live, keep=keep, old=old)
    np_args = (t.numpy(), None if res is None else res.numpy(),
               None if live is None else live.numpy(),
               None if keep is None else keep.numpy(), old)
    v_pal, h_pal = _jax_epilogue_encode(*np_args)
    assert torch.equal(vals, torch.from_numpy(v_pal))
    assert torch.equal(bits, rp.bits_from_hot(torch.from_numpy(h_pal)))
    if keep is None:
        x = np.maximum(np_args[0] + (0 if res is None else np_args[1]), 0)
        if live is not None:
            x = np.where(np_args[2][:, None], x, np.float32(0))
        v_ref, h_ref = jref.rfc_encode_ref(x.reshape(-1, cols))
        np.testing.assert_array_equal(vals.numpy().reshape(-1, cols),
                                      np.asarray(v_ref))
        np.testing.assert_array_equal(_hot(bits, cols).reshape(-1, cols),
                                      np.asarray(h_ref))
        want = torch.relu(t if res is None else t + res)
        if live is not None:
            want = torch.where(live[:, None], want, 0.0)
        assert torch.equal(ops.rfc_decode(vals, bits), want)
    else:
        rows = keep.reshape((-1,) + (1,) * (t.dim() - 1))
        assert torch.equal(torch.where(rows, 0, bits),
                           torch.where(rows, 0, old["bits"]))
    np.testing.assert_array_equal(
        ops.rfc_decode(vals, bits).numpy(),
        np.asarray(jops.rfc_decode(jnp.asarray(v_pal), jnp.asarray(h_pal))))


@pytest.mark.parametrize("shape", [(100, 48), (2, 5, 64), (3, 7, 25, 38)])
def test_rfc_roundtrip_equals_relu_bit_for_bit(shape):
    x = torch.from_numpy(_rand(len(shape), *shape))
    out = ops.rfc_decode(*ops.rfc_encode(x))
    assert out.shape == x.shape
    assert torch.equal(out, torch.relu(x))


def test_rfc_wrapper_rejects_partial_banks():
    with pytest.raises(ValueError, match="not divisible"):
        rp.rfc_encode_cuda(torch.zeros(4, 20))


def test_rfc_bits_and_hot_mask_convert_both_ways():
    """Bit j of a bank's int16 word is its channel j (bit 15 makes the
    word negative), and the two conversions invert each other."""
    hot = torch.zeros(3, 32)
    hot[0, 0] = hot[1, 15] = hot[2, 16] = hot[2, 31] = 1.0
    bits = rp.bits_from_hot(hot)
    assert bits.dtype == torch.int16
    assert bits.tolist() == [[1, 0], [-32768, 0], [0, 1 + 32768 - 65536]]
    assert torch.equal(rp.hot_from_bits(bits), hot)
    rand = torch.from_numpy(_rand(4, 6, 5, 64) > 0).float()
    assert torch.equal(rp.hot_from_bits(rp.bits_from_hot(rand)), rand)


# -- a torch emulation of csrc/rfc_pack.cu's lane math (no card needed) -------

def _popc_below(word, j):
    """popc(word & ((1 << j) - 1)) for (...,) words and (16,) channels."""
    bits = (word[..., None] >> torch.arange(16)) & 1          # (..., 16)
    below = torch.arange(16)[None, :] < j[:, None]            # (16 j, 16)
    return (bits[..., None, :] * below).sum(-1)               # (..., 16 j)


def _emulate_encode(t, res, live, keep, old):
    """The encode kernel's arithmetic on (..., C), one quad a lane: a
    lane's nibble shifted into
    its bank's word (the two xor shuffles OR four nibbles), each hot
    channel to stage slot popc(word below it), each lane zeroing its slots
    at or past popc(word); the stage starts as NaN, as shared memory holds
    whatever it held."""
    C = t.shape[-1]
    rows = t.numel() // C
    r = torch.arange(rows)
    x = t.reshape(rows, C).clone()
    if res is not None:
        x = x + res.reshape(rows, C)
    if live is not None:
        x = torch.where(live[r % t.shape[-2]][:, None], x, 0.0)
    x = torch.clamp_min(x, 0.0)
    q = x.reshape(rows, C // 16, 4, 4)                        # bank, lane, k
    nib = ((q > 0).to(torch.int64) << torch.arange(4)).sum(-1)
    word = (nib << (4 * torch.arange(4))).sum(-1)             # the OR
    j = torch.arange(16)
    hot = ((word[..., None] >> j) & 1).bool()                 # (rows, nb, 16)
    slot = _popc_below(word, j)
    n_hot = hot.sum(-1, keepdim=True)
    stage = torch.full((rows, C // 16, 16 + 1), float("nan"))
    stage.scatter_(-1, torch.where(hot, slot, 16), x.reshape(rows, -1, 16))
    stage[..., :16] = torch.where(j >= n_hot, 0.0, stage[..., :16])
    vals = stage[..., :16].reshape(t.shape)
    bits = rp.bits_from_hot(hot.reshape(rows, C).float()).reshape(
        t.shape[:-1] + (C // 16,))
    if keep is not None:
        k = keep[r // (rows // t.shape[0])]
        vals = torch.where(k[:, None], vals.reshape(rows, C),
                           old["vals"].reshape(rows, C)).reshape(t.shape)
        bits = torch.where(k[:, None], bits.reshape(rows, -1),
                           old["bits"].reshape(rows, -1)).reshape(bits.shape)
    return vals, bits


def _emulate_decode(vals, bits):
    """The decode kernel's arithmetic: channel j of a bank reads stage
    slot popc(word below j) where bit j is set, else 0."""
    C = vals.shape[-1]
    v = vals.reshape(-1, C // 16, 16)
    word = bits.reshape(-1, C // 16).to(torch.int64) & 0xFFFF
    j = torch.arange(16)
    hot = ((word[..., None] >> j) & 1).bool()
    got = torch.gather(v, -1, _popc_below(word, j).clamp_max(15))
    return torch.where(hot, got, 0.0).reshape(vals.shape)


@pytest.mark.parametrize("name", list(RFC_CASES))
def test_rfc_lane_math_emulation_matches_plain(name):
    """The kernels' index math, emulated in torch on the CPU, against the
    plain versions, bit for bit: every stage slot written (no NaN left)."""
    args = _rfc_inputs(name, "cpu")
    vals, bits = _emulate_encode(*args)
    assert not torch.isnan(vals).any()
    v2, b2 = rp.rfc_encode_plain(*args)
    assert torch.equal(vals.view(torch.int32), v2.view(torch.int32))
    assert torch.equal(bits, b2)
    assert torch.equal(_emulate_decode(vals, bits).view(torch.int32),
                       rp.rfc_decode_plain(v2, b2).view(torch.int32))


@pytest.mark.parametrize("view", ["contiguous", "h[:, ::2] even T",
                                  "h[:, ::2] odd T", "h[1:, 1:]",
                                  "four strides", "off 16 bytes"])
def test_rfc_aligned_copies_only_what_the_kernel_cannot_read(view):
    """``_aligned`` hands a contiguous, 16-byte-aligned input through as it
    is and copies any other view into storage of its own, equal to it."""
    if view == "four strides":
        h = torch.from_numpy(_rand(9, 2, 9, 6, 5, 32))
        res = h[:, 1::2, 1::2, :, 16:]
    elif view == "off 16 bytes":              # contiguous, one float in
        h = torch.from_numpy(_rand(9, 2 * 8 * 5 * 32 + 1))
        res = h[1:].view(2, 8, 5, 32)
    else:
        h = torch.from_numpy(_rand(9, 2, 9 if "odd" in view else 8, 5, 32))
        res = {"contiguous": h, "h[:, ::2] even T": h[:, ::2],
               "h[:, ::2] odd T": h[:, ::2], "h[1:, 1:]": h[1:, 1:]}[view]
    got = rp._aligned(res)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, res)
    # h[1:, 1:] of a (2, ...) h is contiguous and starts on a row of 128 B
    kept = view in ("contiguous", "h[1:, 1:]")
    assert (got.data_ptr() == res.data_ptr()) == kept


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


def _fd_split_emulation(q, k, v, valid, plan, window=0):
    """csrc/flash_decode.cu's split-and-merge in torch (tests only): the
    live rows are [lo, n), n the first ``valid`` (all S when valid <= 0 or
    past S), lo = max(0, valid − window) under a window (0 without one;
    every slot masked, as valid <= 0, when lo >= n); split p of the
    cluster takes rows [lo + p·span, lo + (p+1)·span) of them, span =
    ceil((n − lo) / splits) rounded up to 16; warp w its 16-row tiles w,
    w + W, ...; 8-lane group j rows j, j + 4, ... of each tile, one
    online-softmax update per tile on base-2 logits (q prescaled by
    log2(e)/sqrt(D)); then groups merge pairwise (0+1, 2+3, then both),
    warps and splits in order, and the sum divides by max(l, 1e-20)."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    n = valid if 1 <= valid < S else S
    lo, masked = 0, valid <= 0
    if window > 0:
        lo = max(0, valid - window)
        if lo >= n:
            lo, masked = 0, True
    s2 = torch.einsum("bhgd,bshd->bhgs", q * (np.log2(np.e) / np.sqrt(D)), k)
    if masked:
        s2 = torch.full_like(s2, -1e30)
    empty = (torch.full(q.shape[:3], -torch.inf), torch.zeros(q.shape[:3]),
             torch.zeros(q.shape))
    span = -(-(-(-(n - lo) // plan.splits)) // 16) * 16
    splits = []
    for p in range(plan.splits):
        r0 = lo + min(n - lo, p * span)
        r1 = min(n, r0 + span)
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


# (B, S, Hkv, G, D, valid, window): windows inside the cache (gemma3's
# local layers at a reduced size), a window past valid (no bound), odd D,
# D 112 and 256
FD_WINDOW_CASES = [(2, 100, 2, 3, 16, 90, 16), (1, 64, 2, 2, 32, 64, 8),
                   (2, 100, 2, 3, 20, 37, 50), (1, 80, 1, 1, 112, 70, 33),
                   (1, 60, 2, 2, 256, 41, 24)]


@pytest.mark.parametrize("B,S,Hkv,G,D,valid,window", FD_WINDOW_CASES)
def test_flash_decode_window_matches_jax_flash_attention(B, S, Hkv, G, D,
                                                         valid, window):
    """The plain version and the kernel's split-and-merge (emulated at
    every forced plan) with a window, against JAX's ``flash_attention``
    for one query at position valid − 1 under that window (3e-5); with
    window 0 the plain version equals JAX's ``flash_decode_ref``."""
    from repro.models.layers.attention import flash_attention
    q, k, v = _fd_inputs(B, S, Hkv, G, D)
    want = np.asarray(flash_attention(
        jnp.asarray(q.reshape(B, 1, Hkv * G, D)), jnp.asarray(k),
        jnp.asarray(v), causal=True, window=window, q_offset=valid - 1,
        kv_valid=jnp.asarray(valid))).reshape(B, Hkv, G, D)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    vt = torch.tensor([valid], dtype=torch.int32)
    for got in (ref.flash_decode_ref(tq, tk, tv, vt, window),
                fd.flash_decode(tq, tk, tv, vt, window=window)):
        np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=3e-5)
    for plan in _fd_forced(B, S, Hkv, G, D):
        got = _fd_split_emulation(tq, tk, tv, valid, plan, window).numpy()
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=3e-5,
                                   err_msg=str(plan))
    np.testing.assert_allclose(
        ref.flash_decode_ref(tq, tk, tv, vt, 0).numpy(),
        np.asarray(jref.flash_decode_ref(q, k, v, valid)), atol=3e-5,
        rtol=3e-5)



@pytest.mark.parametrize("B,S,Hkv,G,D,valid,window", FD_BF16_CASES)
def test_flash_decode_bf16_bound_rejects_float32_rules(B, S, Hkv, G, D,
                                                       valid, window):
    """The bound the bf16 kernel is held to (``fd.bf16_bound`` at the card
    tests' cap) sits between a sound kernel and one that skips the rounding
    of p: the plain version's bf16 rules in float64 arithmetic (another
    sum order, the same rounding points) lie within it, and the plain
    version under float32 rules lies outside it wherever the rounding
    moves the result."""
    q, k, v = (torch.from_numpy(a) for a in _fd_inputs(B, S, Hkv, G, D))
    k, v = k.bfloat16(), v.bfloat16()
    want = fd.flash_decode_plain(q, k, v, valid, window)
    f32 = fd.flash_decode_plain(q, k.float(), v.float(), valid, window)
    gap = fd.bf16_rounding_gap(q, k, v, valid, window, want)
    assert gap == float((want - f32).abs().max())
    bound = fd.bf16_bound(gap, fd.BF16_CAP_RANDOM)
    s = torch.einsum("bhgd,bshd->bhgs", q.double(), k.double()) / D ** 0.5
    slots = torch.arange(S)
    live = (slots < valid) & ((slots >= valid - window) if window else True)
    s = torch.where(live, s, -1e30)
    p = torch.exp((s - s.amax(-1, keepdim=True)).bfloat16().double())
    p = p.bfloat16().double()
    sound = (torch.einsum("bhgs,bshd->bhgd", p, v.double())
             / p.sum(-1, keepdim=True)).float()
    assert float((sound - want).abs().max()) <= bound
    if valid > 0:
        assert gap > 2 * fd.BF16_FLOOR
        assert float((f32 - want).abs().max()) > bound

def test_flash_decode_window_leaving_no_slot_masks_all():
    """valid past S with its window's bound past S too: no live slot, so
    the plain version and the emulation give the mean of v over all S,
    as valid <= 0 does."""
    q, k, v = map(torch.from_numpy, _fd_inputs(2, 48, 1, 2, 16))
    mean = v.mean(1)[:, :, None].expand(2, 1, 2, 16)
    torch.testing.assert_close(ref.flash_decode_ref(q, k, v, 200, 8), mean)
    plan = fd.make_plan(2, 48, 1, 2, 16, 2, 1, 2)
    torch.testing.assert_close(_fd_split_emulation(q, k, v, 200, plan, 8),
                               mean, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("shape", [(1, 1108, 8, 2, 256), (2, 40, 32, 1, 112),
                                   (1, 64, 1, 5, 132), (1, 100, 2, 3, 130),
                                   (4, 1500, 12, 1, 64), (4, 64, 8, 6, 128)])
def test_decode_plan_takes_the_zoo_shapes(shape):
    """The wide instantiations (D > 128) take at most 2 query rows a block
    (the cap itself under 4-byte staging); their plans fit shared memory;
    D above 256 is refused."""
    B, S, Hkv, G, D = shape
    p = fd.decode_plan(*shape)
    cap = 2 if D > 128 else 4
    gq = fd.query_rows(G, D)
    assert gq <= cap and (gq == cap if D % 4 else gq <= G)
    assert p.smem <= fd.SMEM_MAX and p.grid[1] == Hkv * -(-G // gq)
    with pytest.raises(ValueError):
        fd.decode_plan(B, S, Hkv, G, 260)


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
    ws.windowed_similarity_step_cuda(
        torch.ones(2, 9, 25, 4), torch.ones(2, 9, 25, 4),
        torch.ones(2, 25, 4), torch.ones(2, 25, 4),
        torch.zeros(2, dtype=torch.int32), torch.ones(2, dtype=torch.bool),
        torch.ones(2, dtype=torch.bool), 20)
    fd.flash_decode(torch.ones(2, 1, 3, 20), torch.ones(2, 8, 1, 20),
                    torch.ones(2, 8, 1, 20), 3)
    assert {"cavity_tconv_step", "graph_sconv_csr", "windowed_similarity",
            "flash_decode"} <= set(_build.KERNELS)
    assert _build.LAUNCHES == dict.fromkeys(_build.KERNELS, 0)
