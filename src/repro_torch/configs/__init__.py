"""Architecture registry: ``get_config(name, reduced=...)``.

The paper's own model, ``agcn-2s``, and the reference's whole LM zoo: the
dense decoders ``h2o-danube-1.8b``, ``gemma3-12b`` (local:global),
``internlm2-20b`` and ``smollm-360m``, the audio encoder-decoder
``whisper-small``, the VLM ``llava-next-mistral-7b``, the MoE LMs
``qwen3-moe-30b-a3b`` and ``granite-moe-3b-a800m``, the SSM
``xlstm-1.3b`` and the hybrid ``zamba2-7b``, in the reference's order.

Shape cells, as ``repro.configs``: ``shape_applicable`` and
``applicable_shapes`` (``long_500k`` only for the sub-quadratic archs,
the decode cells not for the GCN, whose inference cell is ``gcn_infer``)
and ``input_specs(cfg, shape)``, the batch of a cell as meta tensors (the
port's ``jax.ShapeDtypeStruct``: shapes and dtypes, no storage) with the
logical axes of each input.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from repro_torch.common.config import GCN_SHAPES, SHAPES, ModelConfig
from repro_torch.configs import (agcn_2s, gemma3_12b, granite_moe_3b_a800m,
                                h2o_danube_1_8b, internlm2_20b,
                                llava_next_mistral_7b, qwen3_moe_30b_a3b,
                                smollm_360m, whisper_small, xlstm_1_3b,
                                zamba2_7b)

_MODULES = (h2o_danube_1_8b, gemma3_12b, internlm2_20b, smollm_360m,
            whisper_small, llava_next_mistral_7b, qwen3_moe_30b_a3b,
            granite_moe_3b_a800m, xlstm_1_3b, zamba2_7b, agcn_2s)
CONFIGS: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
REDUCED: Dict[str, ModelConfig] = {m.CONFIG.name: m.REDUCED for m in _MODULES}
ASSIGNED = [n for n in CONFIGS if n != "agcn-2s"]


def _norm(name: str) -> str:
    return name.replace("_", "-").replace(".", "-").lower()


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    """Config by dash or underscore id (``agcn-2s`` / ``agcn_2s``)."""
    table = REDUCED if reduced else CONFIGS
    for k, v in table.items():
        if _norm(k) == _norm(name):
            return v
    raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")


def sub_quadratic(cfg: ModelConfig) -> bool:
    """A sliding window, a local:global stack, an SSM or a hybrid."""
    return (cfg.family in ("ssm", "hybrid") or cfg.window_size > 0
            or cfg.local_global_ratio > 0)


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """(applicable, the reason when not)."""
    if cfg.family == "gcn":
        if shape in GCN_SHAPES:
            return True, ""
        return False, "GCN model uses gcn_train/gcn_infer cells"
    if shape not in SHAPES:
        return False, f"unknown shape {shape}"
    if shape == "long_500k" and not sub_quadratic(cfg):
        return False, ("pure full attention at 524k context (sub-quadratic "
                       "required)")
    return True, ""


def applicable_shapes(cfg: ModelConfig) -> List[str]:
    pool = GCN_SHAPES if cfg.family == "gcn" else SHAPES
    return [s for s in pool if shape_applicable(cfg, s)[0]]


def input_specs(cfg: ModelConfig, shape_name: str
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, tuple]]:
    """(meta tensors, logical axes) of a cell's batch inputs, JAX's shapes
    and axes.  Train and prefill cells describe the whole batch {tokens,
    labels, ...}; decode cells the per-step inputs {tokens (B, 1), pos}
    (the cache comes from ``registry.init_cache``).  Tokens, labels and
    pos are int32; the activations (``x``, ``image_embeds``, ``frames``,
    ``memory``) take the port's parameter dtype, float32, where JAX's
    cells give ``image_embeds``, ``frames`` and ``memory`` its bfloat16
    parameter dtype: the port's models run float32 parameters only."""
    shp = (GCN_SHAPES | SHAPES)[shape_name]
    B, S = shp.global_batch, shp.seq_len
    i32, f32 = torch.int32, torch.float32

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.family == "gcn":
        n = B * cfg.gcn_persons
        return ({"x": meta((n, cfg.gcn_frames, cfg.gcn_joints,
                            cfg.gcn_in_channels), f32),
                 "labels": meta((n,), i32)},
                {"x": ("batch", None, None, None), "labels": ("batch",)})
    if shp.is_decode:
        batch = {"tokens": meta((B, 1), i32), "pos": meta((), i32)}
        axes = {"tokens": ("batch", None), "pos": ()}
        if cfg.family == "audio":
            batch["memory"] = meta((B, cfg.encoder_frames, cfg.d_model), f32)
            axes["memory"] = ("batch", None, None)
        return batch, axes
    if cfg.family == "vlm":
        s_text = S - cfg.num_image_tokens
        batch = {"tokens": meta((B, s_text), i32),
                 "image_embeds": meta((B, cfg.num_image_tokens, cfg.d_model),
                                      f32),
                 "labels": meta((B, s_text), i32)}
        axes = {"tokens": ("batch", None),
                "image_embeds": ("batch", None, None),
                "labels": ("batch", None)}
    elif cfg.family == "audio":
        batch = {"frames": meta((B, cfg.encoder_frames, cfg.d_model), f32),
                 "tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
        axes = {"frames": ("batch", None, None), "tokens": ("batch", None),
                "labels": ("batch", None)}
    else:
        batch = {"tokens": meta((B, S), i32), "labels": meta((B, S), i32)}
        axes = {"tokens": ("batch", None), "labels": ("batch", None)}
    return batch, axes
