"""The port's analysis tools against the JAX package's: the op-level cost
counter (``launch.op_cost``) against ``launch.hlo_cost``'s FLOPs of the
compiled step, the dry run's model FLOPs and bytes and the roofline terms
against ``launch.dryrun`` and ``launch.roofline`` given the same
constants, the kernels' work functions counted once through their plain
versions, the gradient sync's plan, and ``run_cell``'s records."""
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JAX_CONFIGS
from repro.configs import get_config as jax_get_config
from repro.launch import dryrun as jdryrun
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.roofline import roofline_terms as jax_roofline_terms
from repro.models import registry as jregistry
from repro.train import steps as jsteps
from repro_torch.common.config import GCN_SHAPES, SHAPES
from repro_torch.configs import get_config
from repro_torch.distributed.params import param_shardings
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import graph_sconv as gs
from repro_torch.launch import dryrun, mesh
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models import registry
from repro_torch.train import steps

# the prefill cells at reduced size: B = 2 sequences of S = 16 tokens (24
# text tokens after the VLM's image tokens), 4 clips for the GCN
PREFILL_ARCHS = ["smollm-360m", "agcn-2s", "granite-moe-3b-a800m",
                 "whisper-small", "gemma3-12b", "llava-next-mistral-7b",
                 "h2o-danube-1.8b", "internlm2-20b"]
# The two SSD families count more FLOPs than JAX's compiled step at
# S = 16, because the sequence fits one 128-token chunk: the inter-chunk
# carry is then the zero initial state, and XLA's simplifier drops the
# y_inter dot against it (the zeros folded through the length-1 scan),
# while the port computes that dot (and gets zeros).  The gap is exactly
# one y_inter dot per SSD layer; at two chunks (S = 256) the counts are
# equal.  (port, JAX) at S = 16:
SSD_PINNED = {"xlstm-1.3b": (13_701_120, 12_636_160),
              "zamba2-7b": (72_957_952, 71_122_944)}


def _batch(cfg, S):
    rng = np.random.default_rng(0)
    if cfg.family == "gcn":
        return {"x": rng.standard_normal(
                    (4, cfg.gcn_frames, cfg.gcn_joints,
                     cfg.gcn_in_channels)).astype(np.float32),
                "labels": rng.integers(0, cfg.gcn_num_classes,
                                       4).astype(np.int32)}
    b = {}
    if cfg.family == "vlm":
        S = 24
        b["image_embeds"] = rng.standard_normal(
            (2, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        b["frames"] = rng.standard_normal(
            (2, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    b["tokens"] = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    b["labels"] = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    return b


def _jax_flops(fn, *args) -> float:
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text())["flops"]


def _meta(tree):
    return {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype,
                           device="meta") for k, v in tree.items()}


def _sds(tree):
    return {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in tree.items()}


def _prefill_flops(arch, S):
    """(the port's counted prefill FLOPs, JAX's from the compiled HLO) at
    the reduced config."""
    cfg, jcfg = get_config(arch, reduced=True), jax_get_config(arch,
                                                               reduced=True)
    b = _batch(cfg, S)
    jp = jax.eval_shape(lambda: jregistry.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    want = _jax_flops(jsteps.make_prefill_step(jcfg), jp, _sds(b))
    with OpCost() as c:
        steps.make_prefill_step(cfg)(registry.init_params(
            cfg, device="meta"), _meta(b))
    return c.analyze()["flops"], want


def test_op_cost_counts_one_matmul():
    a, b = torch.randn(128, 128), torch.randn(128, 128)
    with OpCost() as c:
        a @ b
    r = c.analyze()
    assert r["flops"] == 2 * 128 ** 3
    assert r["collective_bytes"] == 0 and set(r["collectives"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute"}
    assert r["ops"] == 1 and r["bytes"] == 3 * 128 * 128 * 4
    assert r["peak_live_bytes"] == 128 * 128 * 4


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_op_cost_scales_with_a_python_loop(device):
    """A loop of 16 matmul + tanh counts 16 times one iteration's flops,
    bytes and ops, under inference_mode too (composite ops reach the mode
    whole there and are decomposed)."""
    w = torch.randn(96, 96, device=device)
    x0 = torch.randn(32, 96, device=device)

    def count(n):
        x = x0
        with OpCost() as c, torch.inference_mode():
            for _ in range(n):
                x = torch.tanh(x @ w)
        return c.analyze()

    one, many = count(1), count(16)
    assert one["flops"] == 2 * 32 * 96 * 96
    for k in ("flops", "bytes", "ops"):
        assert many[k] == 16 * one[k], k
    assert many["flops_by_op"] == {"mm": 16 * one["flops"]}


@pytest.mark.parametrize("arch", PREFILL_ARCHS)
def test_prefill_flops_match_jax_hlo(arch):
    got, want = _prefill_flops(arch, 16)
    assert got == want


@pytest.mark.parametrize("arch", list(SSD_PINNED))
def test_ssd_prefill_flop_gap_is_the_zero_carry_dot(arch):
    """The pinned S = 16 counts, their gap equal to one y_inter dot per
    SSD layer (2·batch·heads·L·N·P for chunk length L = S), and equal
    counts at two chunks."""
    cfg = get_config(arch, reduced=True)
    got, want = _prefill_flops(arch, 16)
    assert (got, want) == SSD_PINNED[arch]
    S = 16
    if cfg.family == "ssm":     # mLSTM: heads folded into the batch, H = 1
        from repro_torch.models.ssm_model import group_size, num_groups
        layers = num_groups(cfg) * (group_size(cfg) - 1)
        dh = cfg.ssm_expand * cfg.d_model // cfg.num_heads
        dot = 2 * (2 * cfg.num_heads) * 1 * S * dh * (dh + 1)
    else:                       # Mamba2: H heads of P = HEAD_P
        from repro_torch.models.hybrid import structure
        from repro_torch.models.layers.mamba2 import HEAD_P
        ng, per, tail = structure(cfg)
        layers = ng * per + tail
        H = cfg.ssm_expand * cfg.d_model // HEAD_P
        dot = 2 * 2 * H * S * cfg.ssm_state * HEAD_P
    assert got - want == layers * dot
    got, want = _prefill_flops(arch, 256)
    assert got == want


def test_decode_step_flops_match_jax_hlo():
    """smollm's decode step on a bf16 cache (reference backend): the same
    FLOPs as JAX's compiled serve step."""
    cfg, jcfg = (get_config("smollm-360m", reduced=True),
                 jax_get_config("smollm-360m", reduced=True))
    jp = jax.eval_shape(lambda: jregistry.init_params(
        jcfg, jax.random.PRNGKey(0), jnp.float32))
    jc = jax.eval_shape(lambda: jregistry.init_cache(jcfg, 2, 16,
                                                     jnp.bfloat16))
    jb = {"tokens": jax.ShapeDtypeStruct((2, 1), jnp.int32),
          "pos": jax.ShapeDtypeStruct((), jnp.int32)}
    want = _jax_flops(jsteps.make_serve_step(jcfg), jp, jc, jb)
    cache = registry.init_cache(cfg, 2, 16, device="meta",
                                dtype=torch.bfloat16)
    batch = {"tokens": torch.empty((2, 1), dtype=torch.int32, device="meta"),
             "pos": torch.empty((), dtype=torch.int32, device="meta")}
    with OpCost() as c:
        steps.make_serve_step(cfg, "reference")(
            registry.init_params(cfg, device="meta"), cache, batch)
    assert c.analyze()["flops"] == want


@pytest.mark.parametrize("arch", sorted(JAX_CONFIGS))
def test_model_flops_bytes_and_roofline_match_jax(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    cost = {"flops": 3.0e12, "bytes": 5.0e10, "collective_bytes": 2.0e8,
            "collectives": {"all-reduce": 2.0e8}}
    for shape in (*SHAPES, *GCN_SHAPES):
        if (shape in GCN_SHAPES) != (cfg.family == "gcn"):
            continue
        mf = dryrun.model_flops(cfg, shape)
        mb = dryrun.model_bytes(cfg, shape, 2.0, 2.0)
        assert mf == jdryrun.model_flops(jcfg, shape)
        assert mb == jdryrun.model_bytes(jcfg, shape)
        for chips in (1, 8, 256):
            assert roofline_terms(cost, mf, chips, mb, 197e12, 819e9,
                                  50e9) == jax_roofline_terms(
                cost, mf, chips, mb, 197e12, 819e9, 50e9)
    # the port's own itemsizes: float32 parameters, a bf16 cache
    if cfg.family != "gcn":
        assert dryrun.model_bytes(cfg, "train_4k") == (
            cfg.param_count_estimate() * 24.0)


def test_roofline_defaults_are_the_h100s():
    r = roofline_terms({"flops": 67e12, "bytes": 3.35e12 / 2,
                        "collective_bytes": 0.0}, 67e12, 1)
    assert r["t_compute_s"] == 1.0 and r["t_memory_s"] == 0.5
    assert r["dominant"] == "compute" and r["roofline_fraction"] == 1.0
    assert (mesh.HBM_BW, mesh.PEAK_FLOPS_F32, mesh.PEAK_FLOPS_TF32,
            mesh.PEAK_FLOPS_BF16) == (3.35e12, 67e12, 495e12, 989e12)
    assert mesh.HBM_BYTES == 80 * 2 ** 30
    m1, m8 = mesh.make_production_mesh(), mesh.make_production_mesh(
        multi=True)
    assert (m1.name, m1.shape, m8.name, m8.shape) == (
        "h100x1", {"data": 1, "model": 1}, "h100x8", {"data": 8, "model": 1})


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_counted_once_by_its_work_function(dtype):
    """A kernel wrapper on CPU tensors runs its plain version, which the
    counter does not see: one op of the work function's flops and bytes
    (a bf16 cache moves 2 bytes a value)."""
    B, S, Hkv, G, D = 2, 48, 2, 3, 16
    q = torch.randn(B, Hkv, G, D)
    k, v = (torch.randn(B, S, Hkv, D).to(dtype) for _ in range(2))
    with OpCost() as c:
        fd.flash_decode(q, k, v, 40)
    r = c.analyze()
    flops, nbytes = fd.flash_decode_work(B, S, Hkv, G, D, k.element_size())
    assert (r["flops"], r["bytes"], r["ops"]) == (flops, nbytes, 1)
    assert flops == 4 * B * Hkv * G * S * D
    assert r["flops_by_op"] == {"flash_decode": flops}
    assert r["kernels"] == {"flash_decode": {"calls": 1, "flops": flops,
                                             "bytes": nbytes}}
    x, g, w = torch.randn(4, 25, 8), torch.rand(3, 25, 25), torch.randn(
        3, 8, 16)
    with OpCost() as c:
        gs.graph_sconv_cuda(x, g, w)
    assert (c.analyze()["flops"], c.analyze()["ops"]) == (
        gs.graph_sconv_work(4, 25, 8, 16, 3)[0], 1)


def test_grad_sync_plan_on_a_shape_only_mesh():
    """On h100x8 a leaf sharded over data gets a reduce-scatter (its
    shard's bytes), the others an all-reduce; bf16 compression halves
    the bytes; one card syncs nothing."""
    cfg = get_config("smollm-360m")          # full widths, on meta
    params = registry.init_params(cfg, device="meta")
    m8 = mesh.make_production_mesh(multi=True)
    plan = steps.grad_sync_plan(params, param_shardings(params, m8))
    kinds = {st.kind for leaf in plan for st in leaf}
    assert kinds == {"all-reduce", "reduce-scatter"}
    leaves = [t for t in jax.tree.leaves(params)]
    for t, leaf in zip(leaves, plan):
        (st,) = leaf
        n = math.prod(t.shape) * 4
        assert st.nbytes == (n // 8 if st.kind == "reduce-scatter" else n)
    half = steps.grad_sync_plan(params, param_shardings(params, m8), "bf16")
    assert [s.nbytes * 2 for leaf in half for s in leaf] == [
        s.nbytes for leaf in plan for s in leaf]
    one = steps.grad_sync_plan(params, param_shardings(
        params, mesh.make_production_mesh()))
    assert all(leaf == [] for leaf in one)


def test_run_cell_writes_records(tmp_path):
    rec = dryrun.run_cell("smollm-360m", "decode_32k", True, tmp_path,
                          verbose=False)
    path = tmp_path / "smollm-360m__decode_32k__h100x8.json"
    assert json.loads(path.read_text()) == rec
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["dtype"] == {"params": "float32", "cache": "bfloat16"}
    cfg = get_config("smollm-360m")
    cache = 2 * cfg.num_layers * 16 * 32768 * cfg.num_kv_heads * \
        cfg.head_dim * 2
    assert rec["memory"]["argument_bytes"] > cache
    assert rec["memory"]["fits_hbm"]
    jterms = jax_roofline_terms({"flops": 1.0}, 1.0, 1)
    assert set(rec["roofline"]) == set(jterms)
    assert rec["roofline"]["dominant"] == "memory"
    assert rec["cost_analysis"]["flops"] == sum(rec["flops_by_op"].values())

    rec = dryrun.run_cell("agcn-2s", "gcn_infer", False, tmp_path,
                          verbose=False)
    assert rec["status"] == "ok" and rec["kind"] == "prefill"
    assert (tmp_path / "agcn-2s__gcn_infer__h100x1.json").exists()
    assert rec["roofline"]["hlo_flops"] > 0 and rec["dtype"]["cache"] is None

    for arch, shape, why in (("xlstm-1.3b", "long_500k", "kv_seq"),
                             ("smollm-360m", "long_500k", "sub-quadratic")):
        rec = dryrun.run_cell(arch, shape, True, tmp_path, verbose=False)
        assert rec["status"] == "skipped" and why in rec["reason"]
        assert json.loads((tmp_path / f"{rec['cell']}.json").read_text(
        )) == rec
