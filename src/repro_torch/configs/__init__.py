"""Architecture registry: ``get_config(name, reduced=...)``.

Only the paper's own model, ``agcn-2s``, is ported so far; the LM zoo's
configs follow with their slice (ROADMAP.md, Queue 1 item 13).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.common.config import ModelConfig
from repro_torch.configs import agcn_2s

CONFIGS: Dict[str, ModelConfig] = {agcn_2s.CONFIG.name: agcn_2s.CONFIG}
REDUCED: Dict[str, ModelConfig] = {agcn_2s.CONFIG.name: agcn_2s.REDUCED}


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
