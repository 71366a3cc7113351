"""The SSM and hybrid layers of the port on the CPU: the chunked SSD scan
against the port's own step recurrence over B, S, H and the chunk
(atol = rtol = 1e-3, as ``tests/test_ssd.py`` holds JAX's), the Mamba2,
mLSTM and sLSTM layers' one-token decode against their parallel form
(2e-3, as there), and ``ssd_scan``, ``ssd_step``, ``mlstm_layer``,
``slstm_layer`` and ``mamba2_layer`` against JAX's on the same numpy
inputs within a relative bound: |port − JAX| <= 1e-4 · (|JAX| + max |JAX|)
elementwise (rtol 1e-4 and atol 1e-4 of the output's largest magnitude,
since mLSTM's exponential input gate reaches e^10 ≈ 22 026 and its sums
meet float32 rounding at that scale).  Gradients of the scan stay finite
where the decay mask's upper triangle would overflow ``exp``.  In float64
the reduced xlstm and zamba2 decode equals their cache-free forward within
1e-10."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import mamba2 as jmamba2
from repro.models.layers import ssd as jssd
from repro.models.layers import xlstm as jxlstm
from repro_torch.bridge import params_from_numpy
from repro_torch.models.layers import mamba2, ssd, xlstm


def _rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _ssd_inputs(seed, B, S, H, P=5, N=4):
    x = _rand(seed, B, S, H, P)
    log_a = -np.abs(_rand(seed + 1, B, S, H)) * 0.2
    dt = np.abs(_rand(seed + 2, B, S, H))
    return x, log_a, dt, _rand(seed + 3, B, S, N), _rand(seed + 4, B, S, N)


def _close_rel(got, want, rel=1e-4, msg=""):
    """|got − want| <= rel · (|want| + max |want|) elementwise."""
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale,
                               err_msg=msg)


def _naive(x, log_a, dt, Bm, Cm):
    """The port's step recurrence over the sequence."""
    B, S, H, P = x.shape
    s = torch.zeros((B, H, Bm.shape[-1], P))
    ys = []
    for t in range(S):
        y, s = ssd.ssd_step(s, x[:, t], log_a[:, t], dt[:, t], Bm[:, t],
                            Cm[:, t])
        ys.append(y)
    return torch.stack(ys, 1), s


@pytest.mark.parametrize("B,S,H,chunk", [(1, 3, 1, 4), (2, 17, 3, 4),
                                         (3, 40, 2, 16), (2, 33, 4, 8),
                                         (1, 16, 1, 16), (2, 9, 2, 128)])
def test_ssd_chunked_equals_recurrence(B, S, H, chunk):
    args = [torch.from_numpy(a) for a in _ssd_inputs(B * S + H, B, S, H)]
    y, s = ssd.ssd_scan(*args, chunk=chunk)
    y_ref, s_ref = _naive(*args)
    torch.testing.assert_close(y, y_ref, atol=1e-3, rtol=1e-3)
    torch.testing.assert_close(s, s_ref, atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("B,S,H,chunk,head_group", [
    (2, 20, 3, 8, 0), (2, 37, 4, 16, 2), (1, 5, 2, 128, 0),
    (2, 24, 6, 8, 3)])
def test_ssd_scan_and_step_match_jax(B, S, H, chunk, head_group):
    x, log_a, dt, Bm, Cm = _ssd_inputs(7 + S, B, S, H)
    init = _rand(3, B, H, Bm.shape[-1], x.shape[-1])
    jy, js = jssd.ssd_scan(*map(jnp.asarray, (x, log_a, dt, Bm, Cm)),
                           init_state=jnp.asarray(init), chunk=chunk,
                           head_group=head_group)
    ty, ts = ssd.ssd_scan(*map(torch.from_numpy, (x, log_a, dt, Bm, Cm)),
                          init_state=torch.from_numpy(init), chunk=chunk,
                          head_group=head_group)
    _close_rel(ty.numpy(), jy, msg="y")
    _close_rel(ts.numpy(), js, msg="state")
    jy1, js1 = jssd.ssd_step(jnp.asarray(init), *(jnp.asarray(a[:, 0]) for a
                                                  in (x, log_a, dt, Bm, Cm)))
    ty1, ts1 = ssd.ssd_step(torch.from_numpy(init), *(
        torch.from_numpy(a[:, 0]) for a in (x, log_a, dt, Bm, Cm)))
    _close_rel(ty1.numpy(), jy1, msg="step y")
    _close_rel(ts1.numpy(), js1, msg="step state")


def test_ssd_scan_gradients_stay_finite():
    """A strong decay over a long chunk: exp of the decay mask's upper
    triangle would overflow, so the mask goes on before exp and the
    gradients of every input stay finite."""
    B, S, H = 2, 128, 2
    x, log_a, dt, Bm, Cm = (torch.from_numpy(a).requires_grad_(True) for a in
                            _ssd_inputs(5, B, S, H))
    with torch.no_grad():
        log_a.mul_(500.0)                       # cumulative decay ~ -1e4
    y, s = ssd.ssd_scan(x, log_a, dt, Bm, Cm, chunk=128)
    (y.square().sum() + s.sum()).backward()
    for t in (x, log_a, dt, Bm, Cm):
        assert torch.isfinite(t.grad).all()


def _jax_tree(tree):
    return jax.tree.map(np.asarray, tree)


# the JAX layers, jitted (the head count and state width static)
_jmlstm = jax.jit(jxlstm.mlstm_layer, static_argnums=2)
_jslstm = jax.jit(jxlstm.slstm_layer, static_argnums=2)
_jmamba2 = jax.jit(jmamba2.mamba2_layer, static_argnums=2)


@pytest.mark.parametrize("gate_scale", [1.0, 100.0])
def test_mlstm_layer_matches_jax(gate_scale):
    """The parallel form and a decode step; at gate_scale 100 the input
    gate's exp reaches its e^10 clamp."""
    d, B, S, H = 32, 2, 9, 2
    p = _jax_tree(jxlstm.mlstm_init(jax.random.PRNGKey(0), d, H))
    p["wif"] = p["wif"] * gate_scale
    x = _rand(1, B, S, d, scale=0.5)
    tp = params_from_numpy(p, device="cpu")
    jy, _ = _jmlstm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               H)
    ty, _ = xlstm.mlstm_layer(tp, torch.from_numpy(x), H)
    gates = x @ p["wif"] + p["if_bias"]
    assert (gates[..., :H].max() > 10) == (gate_scale > 1)
    _close_rel(ty.numpy(), jy)
    dh = 2 * d // H
    cache = _rand(2, B, H, dh, dh + 1)
    jy1, jc = _jmlstm(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x[:, :1]), H,
                                 cache={"ssm": jnp.asarray(cache)})
    ty1, tc = xlstm.mlstm_layer(tp, torch.from_numpy(x[:, :1]), H,
                                cache={"ssm": torch.from_numpy(cache)})
    _close_rel(ty1.numpy(), jy1)
    _close_rel(tc["ssm"].numpy(), jc["ssm"])


def test_slstm_layer_matches_jax():
    d, B, S, H = 32, 2, 8, 2
    p = _jax_tree(jxlstm.slstm_init(jax.random.PRNGKey(0), d, H))
    x = _rand(1, B, S, d, scale=0.5)
    tp = params_from_numpy(p, device="cpu")
    jy, _ = _jslstm(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                               H)
    ty, _ = xlstm.slstm_layer(tp, torch.from_numpy(x), H)
    _close_rel(ty.numpy(), jy)
    dh = d // H
    state = {k: _rand(i, B, H, dh, scale=0.3)
             for i, k in enumerate(("c", "n", "h", "m"))}
    state["n"] = np.abs(state["n"]) + 1.0
    jy1, jc = _jslstm(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x[:, :3]), H, cache={
                                     k: jnp.asarray(v)
                                     for k, v in state.items()})
    ty1, tc = xlstm.slstm_layer(tp, torch.from_numpy(x[:, :3]), H, cache={
        k: torch.from_numpy(v) for k, v in state.items()})
    _close_rel(ty1.numpy(), jy1)
    for k in state:
        _close_rel(tc[k].numpy(), jc[k], msg=k)


def test_mamba2_layer_matches_jax():
    d, B, S, N = 128, 2, 12, 8
    p = _jax_tree(jmamba2.mamba2_init(jax.random.PRNGKey(0), d, N))
    x = _rand(1, B, S, d, scale=0.3)
    tp = params_from_numpy(p, device="cpu")
    jy, _ = _jmamba2(jax.tree.map(jnp.asarray, p),
                                 jnp.asarray(x), N)
    ty, _ = mamba2.mamba2_layer(tp, torch.from_numpy(x), N)
    _close_rel(ty.numpy(), jy)
    cache = {"conv": _rand(2, B, 3, 2 * d), "ssm": _rand(3, B, 2 * d // 64, N,
                                                          64)}
    jy1, jc = _jmamba2(jax.tree.map(jnp.asarray, p),
                                   jnp.asarray(x[:, :1]), N, cache={
                                       k: jnp.asarray(v)
                                       for k, v in cache.items()})
    ty1, tc = mamba2.mamba2_layer(tp, torch.from_numpy(x[:, :1]), N, cache={
        k: torch.from_numpy(v) for k, v in cache.items()})
    _close_rel(ty1.numpy(), jy1)
    for k in cache:
        _close_rel(tc[k].numpy(), jc[k], msg=k)


def _decode_seq(layer, x, cache):
    ys = []
    for t in range(x.shape[1]):
        y, cache = layer(x[:, t:t + 1], cache)
        ys.append(y)
    return torch.cat(ys, 1)


def test_mamba_decode_matches_parallel():
    d, B, S = 128, 2, 12
    gen = torch.Generator().manual_seed(0)
    p = mamba2.mamba2_init(gen, d, 8)
    x = torch.from_numpy(_rand(1, B, S, d, scale=0.1))
    y_par, _ = mamba2.mamba2_layer(p, x, 8)
    cache = {"conv": torch.zeros(B, 3, 2 * d),
             "ssm": torch.zeros(B, 2 * d // 64, 8, 64)}
    y_seq = _decode_seq(lambda xt, c: mamba2.mamba2_layer(p, xt, 8, cache=c),
                        x, cache)
    torch.testing.assert_close(y_par, y_seq, atol=2e-3, rtol=2e-3)


def test_mlstm_decode_matches_parallel():
    d, B, S, H = 64, 2, 10, 2
    p = xlstm.mlstm_init(torch.Generator().manual_seed(0), d, H)
    x = torch.from_numpy(_rand(1, B, S, d, scale=0.1))
    y_par, _ = xlstm.mlstm_layer(p, x, H)
    dh = 2 * d // H
    y_seq = _decode_seq(lambda xt, c: xlstm.mlstm_layer(p, xt, H, cache=c),
                        x, {"ssm": torch.zeros(B, H, dh, dh + 1)})
    torch.testing.assert_close(y_par, y_seq, atol=2e-3, rtol=2e-3)


def test_slstm_decode_matches_scan():
    d, B, S, H = 32, 2, 8, 2
    p = xlstm.slstm_init(torch.Generator().manual_seed(0), d, H)
    x = torch.from_numpy(_rand(1, B, S, d, scale=0.2))
    y_par, _ = xlstm.slstm_layer(p, x, H)
    zeros = torch.zeros(B, H, d // H)
    y_seq = _decode_seq(lambda xt, c: xlstm.slstm_layer(p, xt, H, cache=c),
                        x, {k: zeros for k in ("c", "n", "h", "m")})
    torch.testing.assert_close(y_par, y_seq, atol=2e-3, rtol=2e-3)


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b"])
def test_float64_decode_equals_cache_free_forward(arch):
    """The reduced model's weights in float64: every teacher-forced
    ``reference`` decode step (the step recurrences, float64 caches)
    against the float64 cache-free forward (the chunked scan) within
    1e-10, where float32 leaves about 1e-5 (the check chip_smoke makes at
    full depth with F64_BOUND).  The float64 run keeps float64 through
    every norm, gate, state and accumulator: its float32 run of the same
    weights lies about 1e-5 off it."""
    from repro_torch.common.tree import tree_leaves, tree_map
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid, registry, ssm_model
    cfg = get_config(arch, reduced=True)
    mod = ssm_model if cfg.family == "ssm" else hybrid
    p32 = registry.init_params(cfg, seed=0, device="cpu")
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, p32)
    B, S = 2, 12
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32))
    with torch.inference_mode():
        free = mod.forward(p64, toks, cfg)[0]
        free32 = mod.forward(p32, toks, cfg)[0]
        cache = registry.init_cache(cfg, B, S, device="cpu",
                                    dtype=torch.float64)
        assert all(t.dtype == torch.float64 for t in tree_leaves(cache)
                   if t.is_floating_point())
        steps = [registry.serve_fn(p64, {
            "tokens": toks[:, t:t + 1],
            "pos": torch.tensor(t, dtype=torch.int32)}, cache, cfg,
            "reference")[0][:, -1] for t in range(S)]
    dec = torch.stack(steps, 1)
    assert free.dtype == dec.dtype == torch.float64
    np.testing.assert_allclose(dec.numpy(), free.numpy(), rtol=0, atol=1e-10)
    assert float((free32.double() - free).abs().max()) > 1e-8
