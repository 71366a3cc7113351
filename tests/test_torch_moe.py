"""The port's MoE layer (``repro_torch.models.layers.moe``) against the JAX
package's on the CPU: ``moe_ffn``'s output and load-balance loss within
1e-5 on bridged weights (the same float32 operations; the capacity
buffer's scatter adds in another order), with padded experts (5 -> 8) and
with a capacity small enough to drop tokens; ``torch.topk`` picks the
experts ``jax.lax.top_k`` picks; the gradients agree (1e-4 relative, 1e-6
absolute); and the four properties of ``tests/test_moe.py`` on the port's own weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import moe as jmoe
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.models import decoder, registry
from repro_torch.models.layers.moe import moe_ffn, moe_init

TOL = dict(atol=1e-5, rtol=1e-5)

# (E real, E padded, top_k, d, f, B, S, capacity factor, act)
CASES = [(8, 8, 2, 16, 32, 2, 8, 8.0, "silu"),
         (5, 8, 2, 16, 32, 2, 16, 4.0, "silu"),
         (4, 4, 2, 8, 16, 1, 32, 0.25, "silu"),
         (5, 16, 3, 24, 40, 3, 12, 1.25, "gelu"),
         (40, 48, 8, 32, 16, 2, 24, 1.25, "silu")]


def _case(E, Ep, k, d, f, B, S, seed=0):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), d, f, E, Ep)
    x = np.random.default_rng(seed + 1).standard_normal((B, S, d)).astype(
        np.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), x


@pytest.mark.parametrize("E,Ep,k,d,f,B,S,cf,act", CASES)
def test_moe_ffn_matches_jax(E, Ep, k, d, f, B, S, cf, act):
    jp, tp, x = _case(E, Ep, k, d, f, B, S)
    jout, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), num_experts=E, top_k=k,
                              capacity_factor=cf, act=act)
    out, aux = moe_ffn(tp, torch.from_numpy(x), num_experts=E, top_k=k,
                       capacity_factor=cf, act=act)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)


@pytest.mark.parametrize("E,Ep,k,d,f,B,S,cf,act", CASES)
def test_routing_matches_jax_top_k(E, Ep, k, d, f, B, S, cf, act):
    """The same experts in the same order; the small-capacity cases do
    send some (token, choice) pairs past their expert's capacity."""
    jp, tp, x = _case(E, Ep, k, d, f, B, S)
    logits = (x @ np.asarray(jp["router"])).astype(np.float32)
    logits = np.where(np.arange(Ep) < E, logits, -1e30)
    jprobs = jax.nn.softmax(jnp.asarray(logits), -1)
    _, jidx = jax.lax.top_k(jprobs, k)
    tprobs = torch.softmax(torch.from_numpy(logits), -1)
    _, tidx = torch.topk(tprobs, k, dim=-1)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert int(tidx.max()) < E                       # pads never routed
    onehot = np.eye(Ep, dtype=np.int64)[np.asarray(jidx)].reshape(B, -1, Ep)
    slot = ((np.cumsum(onehot, 1) - onehot) * onehot).sum(-1)
    cap = max(1, int(k * S * cf / Ep))
    assert (slot >= cap).any() == (cf <= 1.25)       # tokens dropped


def test_moe_ffn_gradients_match_jax():
    E, Ep, k, d, f, B, S = 5, 8, 2, 16, 32, 2, 16
    jp, tp, x = _case(E, Ep, k, d, f, B, S, seed=3)

    def jloss(p, xx):
        out, aux = jmoe.moe_ffn(p, xx, num_experts=E, top_k=k,
                                capacity_factor=1.0)
        return (out ** 2).mean() + 0.01 * aux

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = {n: t.clone().requires_grad_(True) for n, t in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    out, aux = moe_ffn(leaves, xt, num_experts=E, top_k=k,
                       capacity_factor=1.0)
    ((out ** 2).mean() + 0.01 * aux).backward()
    for n, t in leaves.items():
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg[n]),
                                   atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-6,
                               rtol=1e-4)


# ---------------------------------------------- tests/test_moe.py, ported

def _own(E, Ep, d, f, seed=0):
    return moe_init(torch.Generator().manual_seed(seed), d, f, E, Ep)


def dense_moe_oracle(p, x, num_experts, top_k):
    """Every expert on every token, combined with the top-k gates: the
    no-capacity-limit ground truth."""
    B, S, d = x.shape
    E = p["router"].shape[-1]
    logits = x.reshape(-1, d) @ p["router"]
    logits = torch.where(torch.arange(E) < num_experts, logits,
                         torch.tensor(-1e30))
    gv, gi = torch.topk(torch.softmax(logits, -1), top_k, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True)
    xt = x.reshape(-1, d)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", xt, p["wg"])) \
        * torch.einsum("td,edf->tef", xt, p["wi"])
    out_all = torch.einsum("tef,efd->ted", h, p["wo"])
    gates = torch.zeros(B * S, E).scatter(1, gi, gv)
    return torch.einsum("ted,te->td", out_all, gates).reshape(B, S, d)


def test_moe_matches_dense_oracle_with_big_capacity():
    E, k, d, ff = 8, 2, 16, 32
    p = _own(E, E, d, ff)
    x = torch.randn((2, 8, d), generator=torch.Generator().manual_seed(1))
    out, aux = moe_ffn(p, x, num_experts=E, top_k=k, capacity_factor=8.0)
    torch.testing.assert_close(out, dense_moe_oracle(p, x, E, k), atol=1e-4,
                               rtol=1e-4)
    assert float(aux) > 0


def test_moe_padded_experts_never_routed():
    E, Ep, k, d, ff = 5, 8, 2, 16, 32
    p = _own(E, Ep, d, ff)
    assert float(p["wi"][E:].abs().sum()) == 0.0
    x = torch.randn((2, 16, d), generator=torch.Generator().manual_seed(1))
    logits = x.reshape(-1, d) @ p["router"]
    logits = torch.where(torch.arange(Ep) < E, logits, torch.tensor(-1e30))
    _, gi = torch.topk(torch.softmax(logits, -1), k, dim=-1)
    assert int(gi.max()) < E
    out, _ = moe_ffn(p, x, num_experts=E, top_k=k, capacity_factor=4.0)
    assert not bool(torch.isnan(out).any())


def test_moe_capacity_drops_dont_nan():
    E, k, d, ff = 4, 2, 8, 16
    p = _own(E, E, d, ff)
    x = torch.randn((1, 32, d), generator=torch.Generator().manual_seed(1))
    out, _ = moe_ffn(p, x, num_experts=E, top_k=k, capacity_factor=0.25)
    assert not bool(torch.isnan(out).any())
    norms = out[0].norm(dim=-1)           # some tokens produce zero output
    assert float(norms.min()) < float(norms.max())
    assert float(norms.min()) == 0.0


def test_moe_gates_sum_preserved():
    E, k, d, ff = 4, 2, 8, 16
    p = _own(E, E, d, ff)
    x = torch.randn((1, 8, d), generator=torch.Generator().manual_seed(1))
    out1, _ = moe_ffn(p, x, num_experts=E, top_k=k, capacity_factor=8.0)
    assert out1.shape == x.shape


@pytest.mark.parametrize("cf", [8.0, 0.25])
def test_moe_without_aux_gives_the_same_output(cf):
    """``need_aux=False`` (the serving step) skips the load-balance loss
    and changes nothing else: the output is bit-equal, with and without
    capacity drops, and a MoE decoder's logits too."""
    E, Ep, k, d, ff = 5, 8, 2, 16, 32
    p = _own(E, Ep, d, ff)
    x = torch.randn((2, 16, d), generator=torch.Generator().manual_seed(2))
    out, aux = moe_ffn(p, x, num_experts=E, top_k=k, capacity_factor=cf)
    bare, none = moe_ffn(p, x, num_experts=E, top_k=k, capacity_factor=cf,
                         need_aux=False)
    assert none is None and float(aux) > 0
    assert torch.equal(out, bare)
    cfg = get_config("granite-moe-3b-a800m", reduced=True)
    params = registry.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(3))
    want, _, a = decoder.forward(params, toks, cfg, backend="reference")
    got, _, z = decoder.forward(params, toks, cfg, backend="reference",
                                need_aux=False)
    assert torch.equal(want, got) and float(a) > 0 and float(z) == 0.0
