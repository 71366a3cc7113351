"""LM path of the port on the CPU (every LM family: dense, MoE, VLM, SSM,
hybrid, audio), held to the JAX package at the reduced configs: the layer
primitives (1e-6: the same float32 operations in the same order), the
blockwise attention, the cache-free forward and its loss, the per-step
serve logits and caches, the greedy tokens of ``generate`` (1e-4: small
models, float32 sums in another order), and decoding resumed from a JAX
cache.  JAX weights come across through the bridge; inputs come from numpy
seeds.  h2o-danube's reduced config has a 16-slot window, so its runs of
more than 16 steps wrap the SWA ring; gemma3's reduced local:global stack
has an 8-token window over a 14-slot cache, so its local layers' later
steps bound the window inside the cache.  The MoE configs' reduced
capacity factor drops no token, so a one-token decode step routes as the
cache-free forward does; the VLM's forward takes image embeddings before
the text, and its decode serves text alone, as JAX's does; whisper's
decoder attends to an encoder memory drawn from the seed.  The cached
decode of the SSM and hybrid families (the step recurrence) is held to
their cache-free forward (the chunked scan) at JAX's own 2e-2."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import generate as jax_generate
from repro.models import registry as jregistry
from repro.models.layers import attention as jattention
from repro.models.layers import common as jcommon
from repro.models.layers import mlp as jmlp
from repro_torch.bridge import (kv_cache_from_numpy, kv_cache_to_numpy,
                                params_from_numpy)
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import decoder, encdec, registry
from repro_torch.models.layers import attention, common, mlp
from repro_torch.train.steps import make_prefill_step, make_serve_step

ARCHS = ["smollm-360m", "h2o-danube-1.8b", "granite-moe-3b-a800m",
         "qwen3-moe-30b-a3b", "llava-next-mistral-7b", "gemma3-12b",
         "internlm2-20b", "xlstm-1.3b", "zamba2-7b", "whisper-small"]
LAYER_TOL = dict(atol=1e-6, rtol=1e-6)
TOL = dict(atol=1e-4, rtol=1e-4)
# cached decode (the step recurrence) against the cache-free forward (the
# chunked scan): JAX's own bound for the SSM and hybrid families
# (tests/test_models_smoke.py), the port's 1e-4 for the others
DECODE_TOL = {"ssm": dict(atol=2e-2, rtol=2e-2),
              "hybrid": dict(atol=2e-2, rtol=2e-2)}
# (prompt_len, gen) per arch: danube's 16-slot ring wraps; gemma3's
# 14-slot cache outgrows its 8-token window
RUN = {"smollm-360m": (5, 11), "h2o-danube-1.8b": (7, 15),
       "granite-moe-3b-a800m": (5, 7), "qwen3-moe-30b-a3b": (4, 6),
       "llava-next-mistral-7b": (5, 7), "gemma3-12b": (5, 9),
       "internlm2-20b": (4, 6), "xlstm-1.3b": (4, 6), "zamba2-7b": (4, 6),
       "whisper-small": (4, 6)}


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture(scope="module")
def jparams():
    """{arch: JAX init_params of the reduced config, seed 3}."""
    return {a: jregistry.init_params(jax_get_config(a, reduced=True),
                                     jax.random.PRNGKey(3)) for a in ARCHS}


@functools.lru_cache(maxsize=None)
def _jax_serve(arch):
    """JAX's ``serve_fn`` of the reduced ``arch``, jitted once per arch
    (its greedy token is the argmax that JAX's ``make_serve_step``
    takes)."""
    jcfg = jax_get_config(arch, reduced=True)
    return jax.jit(lambda p, b, c: jregistry.serve_fn(p, b, c, jcfg))


@functools.lru_cache(maxsize=None)
def _jax_generate(arch, P, G):
    """JAX's ``generate`` tokens (batch 2, seed 3), run once per arch."""
    return np.asarray(jax_generate(arch, reduced=True, batch=2, prompt_len=P,
                                   gen=G, seed=3)[0])


def _bridged(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _port_logits(params, toks, cfg, extra=None):
    """The port's cache-free logits of any LM family: ``extra`` holds the
    VLM's "image_embeds" or the audio family's "frames" (tensors)."""
    extra = extra or {}
    if cfg.family == "audio":
        memory = encdec.encode(params, extra["frames"], cfg)
        return encdec.decode(params, toks, memory, cfg)[0]
    if cfg.family in decoder.FAMILIES:
        return decoder.forward(params, toks, cfg,
                               image_embeds=extra.get("image_embeds"))[0]
    from repro_torch.models import hybrid, ssm_model
    return {"ssm": ssm_model, "hybrid": hybrid}[cfg.family].forward(
        params, toks, cfg)[0]


# ---------------------------------------------------------------- configs

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_config_fields_match_jax(arch, reduced):
    t, j = get_config(arch, reduced=reduced), jax_get_config(arch,
                                                             reduced=reduced)
    for f in dataclasses.fields(t):
        if f.name != "gcn_backend":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    for prop in ("padded_vocab", "q_dim", "kv_dim", "padded_experts"):
        assert getattr(t, prop) == getattr(j, prop), prop
    assert t.param_count_estimate() == j.param_count_estimate()
    assert t.active_param_count_estimate() == j.active_param_count_estimate()
    assert t.serve_batch("lm") == j.serve_batch("lm") == 4


def test_head_dim_defaults_to_d_model_over_heads():
    cfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                              head_dim=0)
    assert cfg.head_dim == 60 // 3
    assert get_config("agcn-2s").head_dim == 0


# ---------------------------------------------------------------- layers

def test_rmsnorm_matches_jax():
    x, scale = _rand(0, 2, 5, 60), _rand(1, 60)
    want = jcommon.rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)})
    got = common.rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("D,theta", [(20, 10_000.0), (16, 500_000.0)])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches_jax(D, theta, batched):
    x = _rand(D, 2, 7, 3, D)
    pos = np.arange(7, dtype=np.int32) + 9
    if batched:
        pos = np.stack([pos, pos + 13])
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu", "relu2"])
@pytest.mark.parametrize("pruned", [False, True])
def test_mlp_matches_jax(act, pruned):
    p = {"wi": _rand(1, 60, 128) * 0.1, "wg": _rand(2, 60, 128) * 0.1,
         "wo": _rand(3, 128, 60) * 0.1}
    x = _rand(4, 2, 5, 60)
    kept = np.sort(np.random.default_rng(5).permutation(128)[:80]) \
        if pruned else None
    want = jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x), act,
                    None if kept is None else jnp.asarray(kept))
    got = mlp.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x), act,
                  None if kept is None else torch.from_numpy(kept))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


# (Sq, Skv, causal, window, q_offset, kv_valid, q_block, kv_block)
FLASH_CASES = [(9, 9, True, 0, 0, None, 512, 1024),
               (9, 9, True, 4, 0, None, 4, 4),
               (1, 24, True, 0, 17, 18, 512, 1024),
               (3, 20, True, 0, 10, 13, 2, 8),
               (1, 16, False, 0, 0, 16, 512, 1024),
               (6, 11, False, 0, 0, None, 4, 3)]


@pytest.mark.parametrize("Sq,Skv,causal,window,q_offset,kv_valid,qb,kb",
                         FLASH_CASES)
def test_flash_attention_matches_jax(Sq, Skv, causal, window, q_offset,
                                     kv_valid, qb, kb):
    q, k, v = _rand(1, 2, Sq, 6, 8), _rand(2, 2, Skv, 2, 8), _rand(
        3, 2, Skv, 2, 8)
    want = jattention.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, q_offset=q_offset,
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
        q_block=qb, kv_block=kb)
    got = attention.flash_attention(
        *map(torch.from_numpy, (q, k, v)), causal=causal, window=window,
        q_offset=torch.tensor(q_offset, dtype=torch.int32),
        kv_valid=None if kv_valid is None else torch.tensor(kv_valid),
        q_block=qb, kv_block=kb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("arch", ARCHS)
def test_params_bridge_matches_own_init_layout(jparams, arch):
    cfg = get_config(arch, reduced=True)
    tp = _bridged(jparams[arch])
    own = registry.init_params(cfg, seed=1, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), tp)
    assert jax.tree.map(lambda t: tuple(t.shape), own) == shapes
    if cfg.family in decoder.FAMILIES:
        assert shapes["layers"]["attn"]["wq"] == (
            decoder.num_groups(cfg), decoder.scan_group_size(cfg),
            cfg.d_model, cfg.q_dim)
    assert shapes["embed"] == (cfg.padded_vocab, cfg.d_model)
    # a seeded generator gives the same weights again
    again = registry.init_params(cfg, seed=1, device="cpu")
    assert torch.equal(own["embed"], again["embed"])


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b",
                                  "whisper-small"])
def test_cache_specs_and_shapes_match_jax(arch):
    """The SSM, hybrid and audio caches: the logical axes of each leaf
    equal JAX's ``cache_specs``, and the zero caches have JAX's shapes
    (float32 throughout, where JAX's default is bfloat16 for the KV and
    conv leaves)."""
    from repro.models import encdec as jencdec
    from repro.models import hybrid as jhybrid
    from repro.models import ssm_model as jssm
    from repro_torch.models import hybrid, ssm_model
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    mod, jmod = {"ssm": (ssm_model, jssm), "hybrid": (hybrid, jhybrid),
                 "audio": (encdec, jencdec)}[cfg.family]
    assert mod.cache_specs(cfg) == jmod.cache_specs(jcfg)
    got = registry.init_cache(cfg, 2, 12, device="cpu")
    want = jregistry.init_cache(jcfg, 2, 12, jnp.float32)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda t: tuple(t.shape), want)
    assert all(t.dtype in (torch.float32, torch.int32)
               for t in jax.tree.leaves(got))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_jax(jparams, arch):
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    toks = _tokens(cfg, 2, 24)
    batch = {"tokens": toks, "labels": toks}
    if cfg.family == "vlm":
        batch["image_embeds"] = _rand(9, 2, cfg.num_image_tokens, cfg.d_model)
    if cfg.family == "audio":
        batch["frames"] = _rand(9, 2, cfg.encoder_frames, cfg.d_model)
    extra = {k: v for k, v in batch.items() if k in ("image_embeds",
                                                      "frames")}

    def jax_side(p, b):
        """JAX's logits, aux and ``loss_fn`` of the batch, in one jit."""
        from repro.models import decoder as jdecoder
        from repro.models import encdec as jencdec
        from repro.models import hybrid as jhybrid
        from repro.models import ssm_model as jssm
        loss = jregistry.loss_fn(p, b, jcfg, inference=True)
        if jcfg.family in decoder.FAMILIES:
            logits, _, aux = jdecoder.forward(
                p, b["tokens"], jcfg, image_embeds=b.get("image_embeds"))
            return logits, aux, loss
        if jcfg.family == "audio":
            mem = jencdec.encode(p, b["frames"], jcfg)
            return jencdec.decode(p, b["tokens"], mem, jcfg)[0], 0.0, loss
        jmod = jssm if jcfg.family == "ssm" else jhybrid
        return jmod.forward(p, b["tokens"], jcfg)[0], 0.0, loss

    jlogits, jaux, (jloss, jm) = jax.jit(jax_side)(
        jparams[arch], jax.tree.map(jnp.asarray, batch))
    tp = _bridged(jparams[arch])
    if cfg.family in decoder.FAMILIES:
        logits, caches, aux = decoder.forward(
            tp, torch.from_numpy(toks), cfg, image_embeds=(
                torch.from_numpy(extra["image_embeds"]) if extra else None))
        assert caches is None
        np.testing.assert_allclose(float(aux), float(jaux), **TOL)
        assert (float(aux) > 0) == (cfg.family == "moe")
    else:
        logits = _port_logits(tp, torch.from_numpy(toks), cfg, {
            k: torch.from_numpy(v) for k, v in extra.items()})
    n_img = cfg.num_image_tokens if "image_embeds" in extra else 0
    assert logits.shape == (2, n_img + 24, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    metrics = make_prefill_step(cfg)(tp, tbatch)
    assert set(metrics) == set(jm) == {"loss", "aux"}
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), **TOL)
    total, _ = registry.loss_fn(tp, tbatch, cfg)
    np.testing.assert_allclose(float(total), float(jloss), **TOL)


def _run_serve(jp, arch, backend, steps, start=None):
    """Teacher-forced serve steps of the port and of JAX side by side (JAX
    picks the greedy token).  ``start`` = (JAX cache, first token, pos)
    resumes both from a JAX cache bridged to the port.  Yields per step
    (JAX logits, JAX next token, JAX cache, port logits, port next token,
    port cache)."""
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    P, G = RUN[arch]
    prompt = _tokens(cfg, 2, P, seed=7)
    mem = {}
    if cfg.family == "audio":
        mem = {"memory": _rand(8, 2, cfg.encoder_frames, cfg.d_model)}
    jlogits_fn = _jax_serve(arch)
    step = make_serve_step(cfg, backend)
    tp = _bridged(jp)
    if start is None:
        jc = jregistry.init_cache(jcfg, 2, P + G, jnp.float32)
        tc = kv_cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
        tok, pos0 = prompt[:, :1], 0
    else:
        jc, tok, pos0 = start
        tc = kv_cache_from_numpy(jax.tree.map(np.asarray, jc), device="cpu")
    for pos in range(pos0, pos0 + steps):
        jb = {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32),
              **{k: jnp.asarray(v) for k, v in mem.items()}}
        jl, jc = jlogits_fn(jp, jb, jc)
        jtok = np.argmax(np.asarray(jl)[:, -1, :cfg.padded_vocab], -1).astype(
            np.int32)
        ttok, tc, tl = step(tp, tc, {
            "tokens": torch.from_numpy(np.array(tok)),
            "pos": torch.tensor(pos, dtype=torch.int32),
            **{k: torch.from_numpy(v) for k, v in mem.items()}})
        yield np.asarray(jl)[:, -1], np.asarray(jtok), jc, tl, ttok, tc
        tok = (prompt[:, pos + 1: pos + 2] if pos + 1 < P
               else np.asarray(jtok)[:, None])


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_steps_and_caches_match_jax(jparams, arch, backend):
    P, G = RUN[arch]
    n = 0
    for jl, jtok, jc, tl, ttok, tc in _run_serve(jparams[arch], arch,
                                                 backend, P + G - 1):
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        got = kv_cache_to_numpy(tc)
        want = jax.tree_util.tree_leaves_with_path(jc)
        assert len(jax.tree.leaves(got)) == len(want)
        for (path, w), g in zip(want, jax.tree.leaves(got)):
            np.testing.assert_allclose(g, np.asarray(w), **TOL,
                                       err_msg=str(path))
        n += 1
    assert n == P + G - 1
    cfg = get_config(arch, reduced=True)
    if arch == "h2o-danube-1.8b":      # the ring wrapped
        assert got["k"].shape[3] == cfg.window_size < P + G - 1
    if arch == "gemma3-12b":           # the cache outgrew the window
        assert got["k"].shape[3] == P + G > cfg.window_size + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_resumes_from_jax_cache(jparams, arch):
    """JAX runs the first steps; the port continues from its cache (and
    hands its own cache back to JAX, which continues too)."""
    P, G = RUN[arch]
    first = list(_run_serve(jparams[arch], arch, "cuda", P + 4))
    jl, jtok, jc, tl, ttok, tc = first[-1]
    start = (jc, np.asarray(jtok)[:, None], P + 4)
    for jl, jtok, jc2, tl, ttok, tc2 in _run_serve(jparams[arch], arch,
                                                   "cuda", G - 5, start=start):
        np.testing.assert_allclose(tl.numpy(), jl, **TOL)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
    # the port's cache, back in JAX, continues as JAX's own does
    jcfg = jax_get_config(arch, reduced=True)
    back = jax.tree.map(jnp.asarray, kv_cache_to_numpy(tc2))
    b = {"tokens": jnp.asarray(np.asarray(jtok)[:, None]),
         "pos": jnp.asarray(P + G - 1, jnp.int32)}
    if jcfg.family == "audio":
        b["memory"] = jnp.asarray(_rand(8, 2, jcfg.encoder_frames,
                                        jcfg.d_model))
    mine, _ = _jax_serve(arch)(jparams[arch], b, back)
    theirs, _ = _jax_serve(arch)(jparams[arch], b, jc2)
    np.testing.assert_allclose(np.asarray(mine), np.asarray(theirs), **TOL)


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_jax(jparams, arch, backend):
    P, G = RUN[arch]
    want = _jax_generate(arch, P, G)
    got = serve.generate(arch, reduced=True, batch=2, prompt_len=P, gen=G,
                         seed=3, backend=backend, device="cpu",
                         params=_bridged(jparams[arch]))
    np.testing.assert_array_equal(got["tokens"], np.asarray(want))
    assert got["steps"] == P + G - 1 and got["tokens_per_s"] > 0


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cached_decode_matches_cache_free_forward(arch, backend):
    cfg = get_config(arch, reduced=True)
    P, G = RUN[arch]
    params = registry.init_params(cfg, seed=2, device="cpu")
    res = serve.generate(arch, reduced=True, batch=3, prompt_len=P, gen=G,
                         seed=4, backend=backend, device="cpu", params=params,
                         keep_logits=True)
    toks = torch.from_numpy(res["tokens"])
    _, memory = serve.prompt_and_memory(cfg, 3, P, 4)
    if memory is not None:      # the memory generate drew from the seed
        full = encdec.decode(params, toks[:, :-1], torch.from_numpy(memory),
                             cfg)[0]
    else:
        full = _port_logits(params, toks[:, :-1], cfg)
    # a ring attends to the last `window` tokens, so does the forward's mask
    torch.testing.assert_close(res["logits"].transpose(0, 1), full,
                               **DECODE_TOL.get(cfg.family, TOL))


@pytest.mark.parametrize("arch", ARCHS)
def test_cuda_and_reference_backends_agree_on_cpu(arch):
    cfg = get_config(arch, reduced=True)
    params = registry.init_params(cfg, seed=5, device="cpu")
    res = {b: serve.generate(arch, reduced=True, batch=2, prompt_len=4,
                             gen=16, seed=6, backend=b, device="cpu",
                             params=params, keep_logits=True)
           for b in ("cuda", "reference")}
    np.testing.assert_array_equal(res["cuda"]["tokens"],
                                  res["reference"]["tokens"])
    torch.testing.assert_close(res["cuda"]["logits"],
                               res["reference"]["logits"], **TOL)


def test_decode_dispatch_counts_kernel_calls(monkeypatch):
    """The cuda backend sends every one-token step with a full cache or a
    ring to flash_decode (even on the CPU, where it runs the plain
    version), and prompts of more than one token and the reference
    backend to flash_attention; a window shorter than the cache (gemma3's
    local layers) is sent to flash_decode with the window as its lower
    bound, where the global layers pass none and a ring passes none."""
    calls = []
    real = attention.flash_decode

    def counting(q, k, v, valid, window=0):
        calls.append((tuple(q.shape), tuple(k.shape), valid.dtype, window))
        return real(q, k, v, valid, window=window)

    monkeypatch.setattr(attention, "flash_decode", counting)
    smollm = get_config("smollm-360m", reduced=True)
    for cfg, per_step in ((smollm, 2),
                          (get_config("h2o-danube-1.8b", reduced=True), 2)):
        params = registry.init_params(cfg, seed=0, device="cpu")
        for backend, n in (("cuda", per_step), ("reference", 0)):
            calls.clear()
            cache = registry.init_cache(cfg, 2, 12, device="cpu")
            step = make_serve_step(cfg, backend)
            for pos in range(3):
                step(params, cache, {
                    "tokens": torch.zeros((2, 1), dtype=torch.int32),
                    "pos": torch.tensor(pos, dtype=torch.int32)})
            assert len(calls) == 3 * n, (cfg.name, backend)
            G = cfg.num_heads // cfg.num_kv_heads
            assert all(c[0] == (2, cfg.num_kv_heads, G, cfg.head_dim)
                       and c[2] == torch.int32 and c[3] == 0 for c in calls)
        calls.clear()
        cache = registry.init_cache(cfg, 2, 12, device="cpu")
        registry.serve_fn(params, {
            "tokens": torch.zeros((2, 4), dtype=torch.int32),
            "pos": torch.tensor(0, dtype=torch.int32)}, cache, cfg, "cuda")
        assert not calls and cache["pos"].eq(4).all()
    # one local layer whose 6-token window is shorter than the 12-slot
    # cache, one global layer: the local layer's steps carry the window
    mixed = dataclasses.replace(smollm, window_size=6, local_global_ratio=1)
    assert decoder.layer_kinds(mixed) == ["local", "global"]
    params = registry.init_params(mixed, seed=0, device="cpu")
    cache = registry.init_cache(mixed, 2, 12, device="cpu")
    assert cache["k"].shape[3] == 12
    step = make_serve_step(mixed, "cuda")
    calls.clear()
    for pos in range(9):
        step(params, cache, {"tokens": torch.zeros((2, 1), dtype=torch.int32),
                             "pos": torch.tensor(pos, dtype=torch.int32)})
    assert [c[3] for c in calls] == [6, 0] * 9
    # the window past the cache's live slots: the cuda and reference
    # backends agree on a layer's step at every position
    lp = {k: v[0, 0] for k, v in params["layers"]["attn"].items()}
    D, Hkv = smollm.head_dim, smollm.num_kv_heads
    x = torch.from_numpy(_rand(3, 2, 1, smollm.d_model))
    kv = torch.from_numpy(_rand(4, 2, 2, 12, Hkv, D))
    for pos in (2, 7, 11):
        outs = []
        for backend in attention.BACKENDS:
            cache = {"k": kv[0].clone(), "v": kv[1].clone(),
                     "pos": torch.tensor(pos, dtype=torch.int32)}
            outs.append(attention.attention_layer(
                lp, x, common.rope_tables(torch.full((1,), pos), D, 1e4),
                num_heads=smollm.num_heads, num_kv_heads=Hkv, head_dim=D,
                window=6, cache=cache, backend=backend)[0])
        torch.testing.assert_close(outs[0], outs[1], **TOL)


def test_serve_fn_refuses_a_multi_token_step_past_the_cache():
    """The reference clamps the start of a write that would run past the
    cache; the port raises instead, for a ring (danube, 16 slots) and a
    full cache alike, and still takes a step that fits exactly."""
    for arch in ("h2o-danube-1.8b", "smollm-360m"):
        cfg = get_config(arch, reduced=True)
        params = registry.init_params(cfg, seed=0, device="cpu")
        cache = registry.init_cache(cfg, 2, 16, device="cpu")
        assert cache["k"].shape[3] == 16
        for pos, ok in ((12, True), (13, False)):
            batch = {"tokens": torch.zeros((2, 4), dtype=torch.int32),
                     "pos": torch.tensor(pos, dtype=torch.int32)}
            if ok:
                logits, _ = registry.serve_fn(params, batch, cache, cfg)
                assert logits.shape == (2, 4, cfg.padded_vocab)
            else:
                with pytest.raises(ValueError, match="do not fit"):
                    registry.serve_fn(params, batch, cache, cfg)


def test_registry_raises_for_unported_families():
    """Every family of the reference is ported: an unknown family raises
    ValueError, as in JAX, and ``serve lm`` still refuses the gcn
    family."""
    cfg = dataclasses.replace(get_config("smollm-360m", reduced=True),
                              family="rnn")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    for fn in (lambda: registry.init_params(cfg, device="cpu"),
               lambda: registry.init_cache(cfg, 1, 4, device="cpu"),
               lambda: registry.loss_fn({}, {"tokens": toks,
                                             "labels": toks}, cfg),
               lambda: registry.serve_fn({}, {
                   "tokens": toks, "pos": torch.tensor(0)}, {}, cfg)):
        with pytest.raises(ValueError, match="unknown family"):
            fn()
    with pytest.raises(ValueError):
        jregistry.init_params(dataclasses.replace(
            jax_get_config("smollm-360m", reduced=True), family="rnn"),
            jax.random.PRNGKey(0))
    with pytest.raises(ValueError, match="gcn-family"):
        serve.generate("agcn-2s", device="cpu")


def test_serve_lm_cli(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    argv = ["lm", "--arch", "smollm-360m", "--reduced", "--batch", "2",
            "--prompt-len", "3", "--gen", "4"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(argv)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.generate("smollm-360m", prompt_len=3, gen=2)
    serve.main(argv + ["--device", "cpu", "--backend", "both"])
    out = capsys.readouterr().out
    assert "backend=cuda" in out and "backend=reference" in out
    assert "tokens/s" in out and "token agreement: 100.0%" in out


# bf16 caches, one arch per family with an attention cache: the leaf
# dtypes of the zero cache equal JAX's (k, v and the hybrid's conv context
# bf16, the SSM states float32, positions int32) and stay JAX's after the
# steps (the hybrid's conv context widened to float32, as JAX's conv step
# returns it).  Both round every cache write and every probability to
# bf16, but the port's float32 sums run in another order, so a value near
# a bf16 rounding boundary can round the other way, and the hybrid's
# recurrence carries such a difference on.  So each step's logits are
# held to JAX's bf16-cache logits within BF16_SHARE of the distance JAX's
# own bf16 rounding moves them from its float32-cache logits (plus 1e-4):
# the worst share measured here is 0.41 (smollm; zamba2 0.28).
BF16_ARCHS = ["smollm-360m", "granite-moe-3b-a800m", "whisper-small",
              "zamba2-7b"]
BF16_SHARE = 0.75


@pytest.mark.parametrize("backend", ["cuda", "reference"])
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_bf16_cache_decode_matches_jax(jparams, arch, backend):
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    P, G = RUN[arch]
    tc = registry.init_cache(cfg, 2, P + G, device="cpu",
                             dtype=torch.bfloat16)
    jc = jregistry.init_cache(jcfg, 2, P + G, jnp.bfloat16)
    got_dt = [str(t.dtype).replace("torch.", "") for t in jax.tree.leaves(tc)]
    assert got_dt == [str(t.dtype) for t in jax.tree.leaves(jc)]
    assert jax.tree.map(lambda t: tuple(t.shape), tc) == jax.tree.map(
        lambda t: tuple(t.shape), jc)
    prompt = _tokens(cfg, 2, P, seed=7)
    mem = {}
    if cfg.family == "audio":
        mem = {"memory": _rand(8, 2, cfg.encoder_frames, cfg.d_model)}
    jfn = _jax_serve(arch)
    step = make_serve_step(cfg, backend)
    tp = _bridged(jparams[arch])
    jc32 = jregistry.init_cache(jcfg, 2, P + G, jnp.float32)
    tok = prompt[:, :1]
    for pos in range(P + G - 1):
        jb = {"tokens": jnp.asarray(tok), "pos": jnp.asarray(pos, jnp.int32),
              **{k: jnp.asarray(v) for k, v in mem.items()}}
        jl, jc = jfn(jparams[arch], jb, jc)
        jl32, jc32 = jfn(jparams[arch], jb, jc32)
        _, tc, tl = step(tp, tc, {
            "tokens": torch.from_numpy(np.array(tok)),
            "pos": torch.tensor(pos, dtype=torch.int32),
            **{k: torch.from_numpy(v) for k, v in mem.items()}})
        jl, jl32 = np.asarray(jl)[:, -1], np.asarray(jl32)[:, -1]
        own = float(np.abs(jl - jl32).max())
        gap = float(np.abs(tl.numpy() - jl).max())
        assert gap <= BF16_SHARE * own + 1e-4, (pos, gap, own)
        jtok = np.argmax(jl[:, :cfg.padded_vocab], -1).astype(np.int32)
        tok = (prompt[:, pos + 1: pos + 2] if pos + 1 < P
               else jtok[:, None])
    got_dt = [str(t.dtype).replace("torch.", "") for t in jax.tree.leaves(tc)]
    assert got_dt == [str(t.dtype) for t in jax.tree.leaves(jc)]
