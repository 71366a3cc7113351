"""Architecture registry: ``get_config(name, reduced=...)``.

The paper's own model, ``agcn-2s``, and the reference's whole LM zoo: the
dense decoders ``h2o-danube-1.8b``, ``gemma3-12b`` (local:global),
``internlm2-20b`` and ``smollm-360m``, the audio encoder-decoder
``whisper-small``, the VLM ``llava-next-mistral-7b``, the MoE LMs
``qwen3-moe-30b-a3b`` and ``granite-moe-3b-a800m``, the SSM
``xlstm-1.3b`` and the hybrid ``zamba2-7b``, in the reference's order.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.common.config import ModelConfig
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


def _norm(name: str) -> str:
    return name.replace("_", "-").replace(".", "-").lower()


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    """Config by dash or underscore id (``agcn-2s`` / ``agcn_2s``)."""
    table = REDUCED if reduced else CONFIGS
    for k, v in table.items():
        if _norm(k) == _norm(name):
            return v
    raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
