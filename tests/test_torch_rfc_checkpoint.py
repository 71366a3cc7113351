"""RFC-checkpointed squared-ReLU MLP: the port's ``torch.autograd.Function``
against JAX's ``custom_vjp`` on the same numpy inputs (output and the three
gradients within 1e-5; on the CPU the saved residual goes through the RFC
kernels' plain versions), ``torch.autograd.gradcheck`` in float64, and
``checkpoint_bytes`` equal to JAX's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rfc import checkpoint as jck
from repro_torch.core.rfc import checkpoint as tck


def _inputs(seed, m=8, d=32, f=64, do=32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            (rng.standard_normal((d, f)) * 0.2).astype(np.float32),
            (rng.standard_normal((f, do)) * 0.2).astype(np.float32))


@pytest.mark.parametrize("shape", [(8, 32, 64, 32), (3, 16, 48, 8),
                                   (2, 5, 8, 32, 4)])
def test_forward_and_grads_match_jax_custom_vjp(shape):
    lead, (d, f, do) = shape[:-3], shape[-3:]
    x, wi, wo = _inputs(sum(shape), int(np.prod(lead)), d, f, do)
    x = x.reshape(*lead, d)

    def jloss(x, wi, wo):
        return jnp.sum(jnp.square(jck.mlp_relu2_rfc(x, wi, wo)))

    jy = jck.mlp_relu2_rfc(jnp.asarray(x), jnp.asarray(wi), jnp.asarray(wo))
    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(wi),
                                            jnp.asarray(wo))
    tx, twi, two = (torch.from_numpy(a).requires_grad_(True)
                    for a in (x, wi, wo))
    ty = tck.mlp_relu2_rfc(tx, twi, two)
    ty.square().sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    for t, j in zip((tx.grad, twi.grad, two.grad), jg):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                   rtol=1e-5)


@pytest.mark.parametrize("f", [64, 20])
def test_grads_equal_plain_autograd(f):
    """The RFC round trip is lossless: the gradients are the plain
    autograd's of relu(x·wi)²·wo up to the rounding of √(relu(z)²); a
    hidden width that is not a whole number of banks is padded cold."""
    x, wi, wo = (torch.from_numpy(a) for a in _inputs(1, f=f))
    a = [t.clone().requires_grad_(True) for t in (x, wi, wo)]
    b = [t.clone().requires_grad_(True) for t in (x, wi, wo)]
    tck.mlp_relu2_rfc(*a).square().sum().backward()
    (torch.relu(b[0] @ b[1]).square() @ b[2]).square().sum().backward()
    for ta, tb in zip(a, b):
        torch.testing.assert_close(ta.grad, tb.grad, atol=1e-5, rtol=1e-5)


def test_gradcheck_float64():
    rng = np.random.default_rng(2)
    args = [torch.tensor(rng.standard_normal(s), dtype=torch.float64,
                         requires_grad=True)
            for s in ((4, 8), (8, 16), (16, 6))]
    assert torch.autograd.gradcheck(tck.mlp_relu2_rfc, args, eps=1e-6,
                                    atol=1e-5, rtol=1e-4)


def test_saved_residual_is_the_rfc_pair():
    x, wi, wo = (torch.from_numpy(a).requires_grad_(True)
                 for a in _inputs(3))
    y = tck.mlp_relu2_rfc(x, wi, wo)
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5
    vals, bits = saved[1], saved[2]
    assert vals.shape == (8, 64) and vals.dtype == torch.float32
    assert bits.shape == (8, 4) and bits.dtype == torch.int16


@pytest.mark.parametrize("shift", [0.0, 0.3, 1.0])
def test_checkpoint_bytes_equal_jax(shift):
    x = np.random.default_rng(4).standard_normal((64, 128)).astype(np.float32)
    h = np.square(np.maximum(x - shift, 0))
    want = jck.checkpoint_bytes(jnp.asarray(h))
    got = tck.checkpoint_bytes(torch.from_numpy(h))
    assert got == want
    dense, rfc = got
    assert dense == h.size * 4
    if shift > 0:
        assert rfc < dense * 0.8               # >20% modelled saving
    # what the graph holds: full-width values plus a word per bank
    assert tck.held_bytes(torch.from_numpy(h)) == h.size * 4 + 64 * 8 * 2
    assert tck.held_bytes(torch.zeros(3, 20)) == 3 * 20 * 4 + 3 * 2 * 2
