"""The port's config registry and shape cells, held to the JAX package's:
the invariants of ``tests/test_configs.py`` for the port, and for every
arch × shape cell the same applicability and reason, and input specs of
JAX's shapes and logical axes (meta tensors; tokens, labels and pos
int32, the activations float32 where JAX's are bfloat16: the port's
parameter dtype)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import GCN_SHAPES as JAX_GCN_SHAPES
from repro.common.config import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import input_specs as jax_input_specs
from repro.configs import shape_applicable as jax_shape_applicable
from repro_torch.common.config import GCN_SHAPES, SHAPES
from repro_torch.configs import (ASSIGNED, CONFIGS, applicable_shapes,
                                 get_config, input_specs, shape_applicable,
                                 sub_quadratic)

EXPECTED_ARCHS = {
    "h2o-danube-1.8b", "gemma3-12b", "internlm2-20b", "smollm-360m",
    "whisper-small", "llava-next-mistral-7b", "qwen3-moe-30b-a3b",
    "granite-moe-3b-a800m", "xlstm-1.3b", "zamba2-7b", "agcn-2s",
}
CELLS = [(a, s) for a in sorted(CONFIGS) for s in (*SHAPES, *GCN_SHAPES)]


def test_registry_complete():
    assert set(CONFIGS) == EXPECTED_ARCHS
    assert len(ASSIGNED) == 10 and "agcn-2s" not in ASSIGNED


def test_get_config_accepts_underscores():
    assert get_config("h2o_danube_1_8b").name == "h2o-danube-1.8b"
    with pytest.raises(KeyError):
        get_config("not-an-arch")


def test_shape_cells_match_jax():
    for mine, theirs in ((SHAPES, JAX_SHAPES), (GCN_SHAPES, JAX_GCN_SHAPES)):
        assert list(mine) == list(theirs)
        for name in mine:
            assert dataclasses.asdict(mine[name]) == dataclasses.asdict(
                theirs[name])
            assert mine[name].is_decode == theirs[name].is_decode


def test_long500k_applicability_matches_spec():
    """long_500k runs for SSM / hybrid / SWA / local-global; pure full
    attention is skipped."""
    runs = {a for a in ASSIGNED
            if shape_applicable(get_config(a), "long_500k")[0]}
    assert runs == {"h2o-danube-1.8b", "gemma3-12b", "xlstm-1.3b",
                    "zamba2-7b"}
    assert runs == {a for a in ASSIGNED if sub_quadratic(get_config(a))}


def test_40_cells_accounted():
    total = 0
    for a in ASSIGNED:
        for s in SHAPES:
            ok, reason = shape_applicable(get_config(a), s)
            assert ok or reason
            total += 1
    assert total == 40


def test_gcn_shapes():
    cfg = get_config("agcn-2s")
    assert applicable_shapes(cfg) == list(GCN_SHAPES)
    assert not shape_applicable(cfg, "decode_32k")[0]
    batch, _ = input_specs(cfg, "gcn_train")
    n = GCN_SHAPES["gcn_train"].global_batch * cfg.gcn_persons
    assert batch["x"].shape == (n, cfg.gcn_frames, 25, 3)


def test_padded_sizes():
    assert get_config("granite-moe-3b-a800m").padded_experts == 48
    assert get_config("whisper-small").padded_vocab % 256 == 0
    assert get_config("gemma3-12b").padded_vocab == 262144


@pytest.mark.parametrize("arch,shape", CELLS)
def test_cell_applicability_and_input_specs_match_jax(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    ok, reason = shape_applicable(cfg, shape)
    assert (ok, reason) == jax_shape_applicable(jcfg, shape)
    if not ok:
        assert reason and shape not in applicable_shapes(cfg)
        return
    assert shape in applicable_shapes(cfg)
    batch, axes = input_specs(cfg, shape)
    jbatch, jaxes = jax_input_specs(jcfg, shape)
    assert axes == jaxes and set(batch) == set(jbatch) == set(axes)
    for name, t in batch.items():
        j = jbatch[name]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(j.shape), name
        assert len(axes[name]) == t.dim(), name
        if j.dtype == jnp.int32:
            assert t.dtype == torch.int32, name
        else:
            assert j.dtype in (jnp.float32, jnp.bfloat16), name
            assert t.dtype == torch.float32, name
    shp = (SHAPES | GCN_SHAPES)[shape]
    if shp.is_decode:
        assert batch["tokens"].shape == (shp.global_batch, 1)
        assert batch["pos"].shape == ()
    elif cfg.family == "vlm":
        assert (batch["tokens"].shape[1] + cfg.num_image_tokens
                == shp.seq_len)
    assert np.prod(batch["tokens" if "tokens" in batch else "x"].shape) > 0
