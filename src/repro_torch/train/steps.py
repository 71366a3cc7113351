"""Batched GCN inference step over prebuilt ExecutionPlans.  Port of the
gcn inference part of ``repro.train.steps``."""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.config import ModelConfig


def _gcn_bone_fn(plans) -> Callable:
    """Bone transform for the ensemble's second stream: the plan's own
    (V,) parent map when present, else the fixed NTU-25 bone stream."""
    from repro_torch.core.agcn.model import bone_stream, bone_stream_parents

    parents = plans[1].arrays.get("parents") if len(plans) > 1 else None
    if parents is None:
        return bone_stream
    return lambda x: bone_stream_parents(x, parents[: x.shape[-2]])


def make_gcn_infer_step(cfg: ModelConfig) -> Callable:
    """``step(plans, x) -> logits`` for a tuple of one (joint) or two
    (joint, bone) ExecutionPlans; two plans average their logits.  ``x``
    lies on the plans' device."""
    from repro_torch.core.agcn import engine

    @torch.inference_mode()
    def infer_step(plans, x):
        logits = engine.execute(plans[0], x)
        if len(plans) > 1:
            logits = 0.5 * (logits + engine.execute(
                plans[1], _gcn_bone_fn(plans)(x)))
        return logits

    return infer_step
