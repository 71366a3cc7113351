"""``flash_decode``'s partial form over a cache sharded by slots (JAX's
``kv_seq`` rule) on the CPU: the plain partial output and log-sum-exp of
each shard (``kernels.ref.flash_decode_partial_ref``, which the wrapper
takes for CPU tensors), merged in rank order
(``kernels.ref.flash_decode_merge``), against the unsharded plain version
and JAX's ``flash_decode_ref`` on the whole cache: P in {1, 2, 4, 8}
shards, whole-cache ``valid`` and window bounds read relative to each
shard, shards with no live slot (o = 0, lse = -inf, no NaN), 1e-6 in
float32.  The kernel against this plain version is
``tests/test_torch_cuda_kernels.py``'s (on the card)."""
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ref

TOL = dict(atol=1e-6, rtol=1e-6)


def _inputs(B, S, Hkv, G, D, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hkv, G, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    return q, k, v


def _split_merge(q, k, v, valid, window, P, shared_max=False):
    """Each shard's partial through the wrapper, merged in rank order;
    with ``shared_max`` against the shards' maxima's max (the bf16 path)."""
    Ls = k.shape[1] // P
    ks = [k[:, r * Ls:(r + 1) * Ls].contiguous() for r in range(P)]
    vs = [v[:, r * Ls:(r + 1) * Ls].contiguous() for r in range(P)]
    row_max = None
    if shared_max:
        row_max = torch.stack([fd.flash_decode_row_max(
            q, ks[r], valid, window=window, offset=r * Ls)
            for r in range(P)]).amax(0)
    parts = [fd.flash_decode_partial(q, ks[r], vs[r], valid, window=window,
                                     offset=r * Ls, row_max=row_max)
             for r in range(P)]
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    return ref.flash_decode_merge(o, lse), o, lse


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("valid", [1, 13, 37, 64])
def test_split_merge_matches_unsharded_and_jax(P, valid):
    q, k, v = _inputs(2, 64, 2, 3, 16)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    vt = torch.tensor([valid], dtype=torch.int32)
    got, _, lse = _split_merge(tq, tk, tv, vt, 0, P)
    np.testing.assert_allclose(got.numpy(), ref.flash_decode_ref(
        tq, tk, tv, vt).numpy(), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jref.flash_decode_ref(q, k, v, valid)), **TOL)
    # the shards wholly past valid hold nothing
    Ls = 64 // P
    for r in range(P):
        assert bool(torch.isfinite(lse[r]).all()) == (r * Ls < valid)


@pytest.mark.parametrize("P", [2, 4, 8])
@pytest.mark.parametrize("valid,window", [(64, 10), (40, 16), (9, 4),
                                          (64, 64), (30, 1)])
def test_split_merge_window_bounds(P, valid, window):
    """A window's lower bound valid - window lands inside one shard (or on
    a shard's edge): the shards below it and past valid are empty."""
    q, k, v = _inputs(1, 64, 2, 2, 8, seed=1)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got, o, lse = _split_merge(tq, tk, tv, valid, window, P)
    np.testing.assert_allclose(got.numpy(), ref.flash_decode_ref(
        tq, tk, tv, valid, window).numpy(), **TOL)
    Ls = 64 // P
    for r in range(P):
        live = r * Ls < valid and (r + 1) * Ls > valid - window
        assert bool(torch.isfinite(lse[r]).all()) == live, r


def test_empty_shard_gives_zero_and_minus_inf():
    q, k, v = map(torch.from_numpy, _inputs(2, 16, 2, 2, 8, seed=2))
    for valid, window, offset in ((10, 0, 16), (0, 0, 0), (40, 8, 16),
                                  (20, 4, 0)):
        o, lse = fd.flash_decode_partial(q, k, v, valid, window=window,
                                         offset=offset)
        assert torch.equal(o, torch.zeros_like(o))
        assert bool(torch.isneginf(lse).all())
    # a merge with an empty rank weighs it 0 and stays finite
    o1, l1 = fd.flash_decode_partial(q, k, v, 10, offset=0)
    o2, l2 = fd.flash_decode_partial(q, k, v, 10, offset=16)
    merged = ref.flash_decode_merge(torch.stack([o1, o2]),
                                    torch.stack([l1, l2]))
    assert torch.isfinite(merged).all()
    np.testing.assert_allclose(merged.numpy(), o1.numpy(), **TOL)


def test_lse_is_the_shards_log_sum_exp():
    q, k, v = map(torch.from_numpy, _inputs(1, 32, 1, 2, 8, seed=3))
    o, lse = fd.flash_decode_partial(q, k, v, 30, window=12, offset=0)
    s = torch.einsum("bhgd,bshd->bhgs", q, k) / np.sqrt(8)
    want = torch.logsumexp(s[..., 18:30], -1)
    np.testing.assert_allclose(lse.numpy(), want.numpy(), **TOL)
    assert o.dtype == torch.float32 and lse.shape == (1, 1, 2)


@pytest.mark.parametrize("P", [1, 2, 4, 8])
@pytest.mark.parametrize("window", [0, 20])
def test_bf16_partials_round_against_the_whole_rows_max(P, window):
    """On a bf16 cache the shards' partials against the rows' maxima over
    every shard (``flash_decode_row_max``, maxed over the shards) merge
    into the unsharded plain version up to float32 sum order (1e-6);
    against each shard's own max they miss it by about the whole gap the
    bf16 rounding of p opens (the rounding points move), which is why the
    kv_seq decode takes the shared max."""
    q, k, v = map(torch.from_numpy, _inputs(2, 64, 2, 3, 16, seed=4))
    kb, vb = k.bfloat16(), v.bfloat16()
    want = ref.flash_decode_ref(q, kb, vb, 50, window)
    got, _, _ = _split_merge(q, kb, vb, 50, window, P, shared_max=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    if P == 4 and window == 0:
        own, _, _ = _split_merge(q, kb, vb, 50, window, P)
        gap = fd.bf16_rounding_gap(q, kb, vb, 50, want=want)
        assert float((own - want).abs().max()) > fd.bf16_bound(gap)
