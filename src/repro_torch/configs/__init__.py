"""Architecture registry: ``get_config(name, reduced=...)``.

The paper's own model, ``agcn-2s``, the dense decoder LMs ``smollm-360m``
and ``h2o-danube-1.8b``, the MoE LMs ``granite-moe-3b-a800m`` and
``qwen3-moe-30b-a3b`` and the VLM ``llava-next-mistral-7b`` are ported;
the rest of the LM zoo's configs follow with their slices (ROADMAP.md,
Queue 1 item 6).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.common.config import ModelConfig
from repro_torch.configs import (agcn_2s, granite_moe_3b_a800m,
                                h2o_danube_1_8b, llava_next_mistral_7b,
                                qwen3_moe_30b_a3b, smollm_360m)

_MODULES = (agcn_2s, smollm_360m, h2o_danube_1_8b, granite_moe_3b_a800m,
            qwen3_moe_30b_a3b, llava_next_mistral_7b)
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
    raise KeyError(
        f"unknown arch {name!r}; the port has {sorted(table)} (the other "
        f"architectures are still to be ported, see ROADMAP.md)")
