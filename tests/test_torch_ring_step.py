"""The streaming cavity tconv in its ring form, on the CPU.

The ``cuda`` backend's ``temporal_step`` reads each slot's ring in place
at its phase (``head``, the oldest frame) and stores the block's output
layout: each kept filter at its column with its bias, pruned columns 0.
Held on every block of the reduced config's plans (dense, pruned, pruned
with Q8.8 weights) against the JAX reference engine's step: the
``nkvc,fck->nvf`` einsum on the chronologically gathered window, its bias
and its kept-filter scatter (atol=rtol=1e-5: both sides sum in float32,
in different orders).  Every phase head ∈ [0, K) occurs, and slots of one
ring sit at distinct phases.  The port's reference backend still gathers
and runs its einsum, bit for bit as before, and the ``cuda`` backend's CPU
dispatch equals, bit for bit, the path it replaced (gather, transpose,
packed product, filter permutation, bias, scatter)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.agcn import engine as jengine
from repro.core.agcn import model as jmodel
from repro.core.pruning.plan import build_prune_plan as jax_build_prune_plan
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.kernels import cavity_tconv as ct
from repro_torch.kernels import ops

CFG = get_config("agcn-2s", reduced=True)
JCFG = jax_get_config("agcn-2s", reduced=True)
K = CFG.gcn_tkernel
TOL = dict(atol=1e-5, rtol=1e-5)
VARIANTS = {"dense": (False, False), "pruned": (True, False),
            "pruned_quant": (True, True)}
# (S, heads): every phase once, one slot each; three slots at random phases
HEADS = {"every_phase": np.arange(K), "mixed": np.array([7, 0, 4])}


@pytest.fixture(scope="module")
def plans():
    jp = jmodel.init_params(JCFG, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    sw = [np.asarray(b["Wk"]) for b in jp["blocks"]]
    fracs = [1.0, 0.5, 0.5, 0.5]
    pp = (build_prune_plan(sw, CFG.gcn_channels, fracs, "cav-70-1"),
          jax_build_prune_plan(sw, JCFG.gcn_channels, fracs, "cav-70-1"))
    out = {}
    for variant, (pruned, quant) in VARIANTS.items():
        tpp, jpp = pp if pruned else (None, None)
        out[variant] = (
            jengine.build_execution_plan(jp, JCFG, jpp, quant=quant,
                                         backend="reference"),
            *(engine.build_execution_plan(tp, CFG, tpp, quant=quant,
                                          backend=b)
              for b in ("cuda", "reference")))
    return out


def _ring(seed, S, C):
    return np.random.default_rng(seed).standard_normal(
        (S, K, 25, C)).astype(np.float32)


@pytest.mark.parametrize("heads", HEADS)
@pytest.mark.parametrize("variant", VARIANTS)
def test_ring_step_matches_jax_reference_step(plans, variant, heads):
    jplan, cplan, rplan = plans[variant]
    head = HEADS[heads]
    S = len(head)
    chrono = (head[:, None] + np.arange(K)[None, :]) % K
    th = torch.from_numpy(head.astype(np.int32))
    n_pruned = 0
    for b, (jba, jbs, cba, cbs, rba, rbs) in enumerate(zip(
            jplan.arrays["blocks"], jplan.static.blocks,
            cplan.arrays["blocks"], cplan.static.blocks,
            rplan.arrays["blocks"], rplan.static.blocks)):
        ring = _ring(b, S, cbs.cout)
        win = ring[np.arange(S)[:, None], chrono]      # oldest first
        want = np.asarray(jengine.get_backend("reference").temporal_step(
            jnp.asarray(win), jba, jbs))
        tring = torch.from_numpy(ring)
        got = engine.CudaBackend().temporal_step(tring, th, cba, cbs)
        assert got.shape == (S, 25, cbs.cout)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        plain = ct.cavity_tconv_step_ring_plain(
            tring, th, cba["wp"], cba["taps"], cba["slot_col"], cba["tb_col"])
        assert torch.equal(plain, got)
        ref_out = engine.ReferenceBackend().temporal_step(tring, th, rba, rbs)
        np.testing.assert_allclose(ref_out.numpy(), want, **TOL)

        # bit for bit, the paths these replaced: the reference einsum on
        # the window gathered from the block clock t (head = (t + 1) mod
        # K), and the cuda path's gather, transpose, packed product,
        # permutation, bias and scatter
        t = torch.from_numpy(head.astype(np.int64)) - 1 + K
        old_chrono = ((t[:, None] + 1 + torch.arange(K)[None, :]) % K).long()
        old_win = engine._gather_k(tring, old_chrono)
        old_ref = torch.einsum("nkvc,fck->nvf", old_win, rba["tw"]) + rba["tb"]
        if rbs.pruned_filters:
            old_ref = engine._scatter_filters(old_ref, rba["kept_filters"],
                                              rbs.cout)
        assert torch.equal(ref_out, old_ref)
        xb = old_win.permute(0, 2, 1, 3).reshape(S * 25, K, cbs.cout)
        old = ops.cavity_tconv_step(xb, cba["wp"], cba["taps"],
                                    cba["inv_perm"], cbs.n_kept_filters)
        old = old.reshape(S, 25, -1) + cba["tb"]
        if cbs.pruned_filters:
            old = engine._scatter_filters(old, cba["kept_filters"], cbs.cout)
            pruned = np.setdiff1d(np.arange(cbs.cout),
                                  cba["kept_filters"].numpy())
            assert (got[..., pruned] == 0).all()
            n_pruned += len(pruned)
        assert torch.equal(got, old)
    assert n_pruned or variant == "dense"


def test_slot_columns_compose_the_permutation_slice_and_scatter():
    """Packed slot inv_perm[f] of kept filter f < F goes to column
    kept[f]; padding slots and filters past F go nowhere."""
    F_, kept = 13, np.array([0, 2, 3, 5, 8, 9, 11, 12, 14, 15, 17, 18, 19])
    _, _, inv = ops.pack_cavity_weights(np.zeros((F_, 4, 9), np.float32),
                                        np.ones((F_, 9), bool))
    col = ops.slot_columns(inv, F_, kept)
    assert col.dtype == np.int32 and col.shape == (16,)
    assert sorted(col[col >= 0]) == sorted(kept)
    for f in range(F_):
        assert col[inv[f]] == kept[f]
    assert (col[inv[F_:]] == -1).all()
    src = ct.column_sources(torch.from_numpy(col), 20)
    assert src.tolist() == [int(np.flatnonzero(col == o)[0]) if o in kept
                            else 16 for o in range(20)]
