"""Gated MLP with optional structured channel pruning (kept d_ff channels).
Port of ``repro.models.layers.mlp``."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.models.layers.common import activation, he_init


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int) -> Dict:
    return {
        "wi": he_init(generator, (d_model, d_ff), d_model),
        "wg": he_init(generator, (d_model, d_ff), d_model),
        "wo": he_init(generator, (d_ff, d_model), d_ff),
    }


def mlp(p: Dict, x: torch.Tensor, act: str = "silu",
        kept_ff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: (B, S, d).  kept_ff: optional kept d_ff channel indices."""
    wi, wg, wo = p["wi"], p["wg"], p["wo"]
    if kept_ff is not None:
        wi = wi.index_select(1, kept_ff)
        wg = wg.index_select(1, kept_ff)
        wo = wo.index_select(0, kept_ff)
    return (activation(act)(x @ wg) * (x @ wi)) @ wo
