"""LM training on the port against the JAX package on the CPU, at the
reduced smollm-360m (dense), granite-moe (MoE: the loss carries 0.01 × the
load-balance aux) and llava (VLM: image embeddings before the text)
configs, and the reduced xlstm (SSM), zamba2 (hybrid) and whisper
(audio) configs (their first step's gradient of every leaf against JAX's
too): ``make_train_step`` over 3 steps from bridged JAX weights on the
JAX pipeline's batches, losses within 1e-4 of JAX's and parameters within
1e-4 × the leaf's max |value| wherever JAX's gradient exceeded 1e-6 at
every step (AdamW's normalised update carries a rounding difference in a
vanishing gradient at full size, as the gcn train step's bound does; the new
families' mask and bound are in their test's docstring), at
microbatches 1 and 2 and with bf16 gradient compression; the batches of
the port's pipeline bit-equal to JAX's (the VLM's image embeddings from
the same stream); and ``launch.train`` running each family a few steps
with a checkpoint and a resume."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.data import pipeline as jpipe
from repro.models import registry as jreg
from repro.optim import adamw as jadamw
from repro.train.steps import make_train_step as jax_make_train_step
from repro_torch.bridge import params_from_numpy
from repro_torch.common import tree
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import train_loop
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

ARCHS = ["smollm-360m", "granite-moe-3b-a800m", "llava-next-mistral-7b"]


@pytest.mark.parametrize("nmb,comp", [(1, "none"), (2, "none"),
                                      (2, "bf16")])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_jax(arch, nmb, comp):
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    seq = 24 + cfg.num_image_tokens
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(1))
    data = jpipe.make_batches(jcfg, jpipe.DataConfig(4, seq, seed=5))
    batches = [next(data) for _ in range(3)]
    kw = dict(learning_rate=3e-3, warmup_steps=3, total_steps=30,
              microbatches=nmb, grad_compression=comp)
    jstep = jax.jit(jax_make_train_step(jcfg, JTrainConfig(**kw)))
    jgrad = jax.jit(jax.grad(lambda p, b: jreg.loss_fn(p, b, jcfg)[0]))
    tstep = make_train_step(cfg, TrainConfig(**kw))
    jpp, jo = jp, jadamw.init(jp)
    tpp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    to = adamw.init(tpp)
    small = jax.tree.map(lambda p: np.zeros(p.shape, bool), jp)
    for i, b in enumerate(batches):
        jb = jax.tree.map(jnp.asarray, b)
        per = 4 // nmb          # the step's gradient: its microbatches' mean
        g = jax.tree.map(lambda *x: sum(x) / nmb, *[jgrad(jpp, {
            k: v[m * per:(m + 1) * per] for k, v in jb.items()})
            for m in range(nmb)])
        small = jax.tree.map(lambda s, x: s | (np.abs(np.asarray(x)) <= 1e-6),
                             small, g)
        jpp, jo, jm = jstep(jpp, jo, jb)
        tpp, to, tm = tstep(tpp, to, {k: torch.as_tensor(v)
                                      for k, v in b.items()})
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4, i
        assert set(tm) == set(jm), (set(tm), set(jm))
        if "aux" in jm:
            assert abs(float(tm["aux"]) - float(jm["aux"])) <= 1e-4
    # held where the step's gradient exceeded 1e-6 at every step: AdamW's
    # update m/(sqrt(v) + 1e-8) carries a rounding difference in a vanishing
    # gradient (two microbatches' near-cancelling ones) at full size (up to
    # lr), as PR 21's gcn bound says
    for (n, t), j, sm in zip(tree.tree_paths(tpp), jax.tree.leaves(jpp),
                             jax.tree.leaves(small)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy()[~sm], j[~sm], rtol=0,
                                   atol=1e-4 * np.abs(j).max(), err_msg=n)
    assert int(to.step) == 3


@pytest.mark.parametrize("arch", ["xlstm-1.3b", "zamba2-7b",
                                  "whisper-small"])
def test_ssm_hybrid_audio_train_step_matches_jax(arch):
    """``make_train_step`` of the SSM, hybrid and audio families from
    bridged JAX weights on the JAX pipeline's batches (whisper's frames
    from the same stream), 3 steps.  The first step's gradient of every
    leaf (zamba2's shared block, applied once per group, included: autograd
    sums its uses) against ``jax.grad`` of JAX's loss within 5e-4 of the
    leaf's max |g| (zamba2's float32 rounding reaches 7e-5 of it in either
    package).  At each step: the gradient norm finite (so is every
    gradient: the SSD decay mask goes on before its exp), the loss within
    1e-4 of JAX's, and the parameters within max(1e-4 × the leaf's max
    |value|, 0.1 × lr) of JAX's wherever JAX's gradient exceeded
    max(1e-6, 1e-3 × the leaf's max |g|) at every step so far.  zamba2's
    gradients carry float32 rounding up to 1e-4 of a leaf's max |g| in
    either package (against a float64 run of the port), so an element at
    1e-3 of the max carries up to 10% relative rounding, which AdamW's
    normalised update m / sqrt(v) passes on as up to 0.1 × lr (its
    dt_bias starts at 0, so its leaf's max |value| is a few lr); an
    element below that may flip sign, and its first update, lr · sign(g),
    then moves it by 2 · lr between the two.  Learning rate 3e-4: at the
    3e-3 of the tests above zamba2's rounding puts 6e-4 between the
    second steps' losses."""
    from repro_torch.models import registry
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    jp = jreg.init_params(jcfg, jax.random.PRNGKey(1))
    data = jpipe.make_batches(jcfg, jpipe.DataConfig(2, 16, seed=5))
    batches = [next(data) for _ in range(3)]
    lr = 3e-4
    kw = dict(learning_rate=lr, warmup_steps=3, total_steps=30)
    jstep = jax.jit(jax_make_train_step(jcfg, JTrainConfig(**kw)))
    jgrad = jax.jit(jax.grad(lambda p, b: jreg.loss_fn(p, b, jcfg)[0]))
    tstep = make_train_step(cfg, TrainConfig(**kw))
    jpp, jo = jp, jadamw.init(jp)
    tpp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    to = adamw.init(tpp)
    small = jax.tree.map(lambda p: np.zeros(p.shape, bool), jp)
    for i, b in enumerate(batches):
        jb = jax.tree.map(jnp.asarray, b)
        tb = {k: torch.as_tensor(v) for k, v in b.items()}
        g = jgrad(jpp, jb)
        if i == 0:
            paths = tree.tree_paths(tpp)
            leaves = [t.detach().clone().requires_grad_(True)
                      for _, t in paths]
            tp = tree.tree_unflatten(tpp, leaves)
            tg = torch.autograd.grad(registry.loss_fn(tp, tb, cfg)[0],
                                     leaves)
            for (n, _), t, j in zip(paths, tg, jax.tree.leaves(g)):
                j = np.asarray(j)
                np.testing.assert_allclose(
                    t.numpy(), j, rtol=0, atol=5e-4 * np.abs(j).max(),
                    err_msg=n)
            if cfg.family == "hybrid":
                assert any(n.startswith("shared/") for n, _ in paths)
        small = jax.tree.map(
            lambda s, x: s | (np.abs(np.asarray(x)) <= max(
                1e-6, 1e-3 * float(np.abs(np.asarray(x)).max()))), small, g)
        jpp, jo, jm = jstep(jpp, jo, jb)
        tpp, to, tm = tstep(tpp, to, tb)
        assert bool(torch.isfinite(tm["grad_norm"])), i
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-4, i
        assert float(tm["aux"]) == float(jm["aux"]) == 0.0
        for (n, t), j, sm in zip(tree.tree_paths(tpp), jax.tree.leaves(jpp),
                                 jax.tree.leaves(small)):
            j = np.asarray(j)
            np.testing.assert_allclose(
                t.numpy()[~sm], j[~sm], rtol=0,
                atol=max(1e-4 * np.abs(j).max(), 0.1 * lr),
                err_msg=f"step {i}: {n}")


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-moe-30b-a3b",
                                          "whisper-small"])
def test_lm_batches_bit_equal_to_jax(arch):
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    for host in (0, 1):
        kw = dict(global_batch=4, seq_len=16 + cfg.num_image_tokens, seed=1,
                  host_index=host, host_count=2)
        t = tpipe.make_batches(cfg, tpipe.DataConfig(**kw))
        j = jpipe.make_batches(jcfg, jpipe.DataConfig(**kw))
        for _ in range(2):
            tb, jb = next(t), next(j)
            assert set(tb) == set(jb)
            for k in tb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
    if cfg.family == "vlm":
        assert tb["tokens"].shape == (2, 16)
        assert tb["image_embeds"].shape == (2, cfg.num_image_tokens,
                                            cfg.d_model)
    if cfg.family == "audio":
        assert tb["frames"].shape == (2, cfg.encoder_frames, cfg.d_model)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loop_trains_and_resumes_lm(arch, tmp_path):
    import shutil
    cfg = get_config(arch, reduced=True)
    seq = 32 + cfg.num_image_tokens
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=2, total_steps=6,
                       checkpoint_every=3, checkpoint_dir=str(tmp_path / "a"))
    _, losses = train_loop(arch, tcfg, batch=4, seq=seq, device="cpu",
                           resume=False)
    assert len(losses) == 6 and np.isfinite(losses).all()
    # a run resumed from the step-3 checkpoint reads the batches the
    # uninterrupted run read and gives its losses
    for sub in ("", "opt"):
        shutil.copytree(tmp_path / "a" / sub / "step_3",
                        tmp_path / "b" / sub / "step_3")
    again = TrainConfig(**{**tcfg.__dict__, "checkpoint_every": 0,
                           "checkpoint_dir": str(tmp_path / "b")})
    _, rest = train_loop(arch, again, batch=4, seq=seq, device="cpu",
                         resume=True)
    np.testing.assert_allclose(rest, losses[3:], atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ["agcn-2s", "granite-moe-3b-a800m"])
def test_train_step_leaves_no_reference_cycles(arch):
    """A train step frees its gradients, moments and activations as it
    returns: no tensor it made waits for the cyclic collector (a
    self-referencing closure in the tree walk once held every leaf of each
    flattened tree until the collector ran, which doubled training memory
    on the card)."""
    import gc
    cfg = get_config(arch, reduced=True)
    from repro_torch.models import registry
    p = registry.init_params(cfg, seed=0, device="cpu")
    o = adamw.init(p)
    b = {k: torch.as_tensor(v) for k, v in next(tpipe.make_batches(
        cfg, tpipe.DataConfig(2, 16 if cfg.family != "gcn" else 0))).items()}
    step = make_train_step(cfg, TrainConfig(microbatches=2))
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        p, o, _ = step(p, o, b)
        gc.collect()
        held = [x for x in gc.garbage if torch.is_tensor(x)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []
