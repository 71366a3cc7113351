"""Elastic re-meshing: when hosts die mid-run, plan a smaller mesh,
re-derive every sharding for it, and restore the latest checkpoint onto
it.  Port of ``repro.fault.elastic``.

The planner keeps the model axis intact and shrinks the data axis to the
largest power of two that the surviving chip count supports — the
standard elastic-DP policy.  The global batch is preserved by raising the
gradient-accumulation microbatches, so optimization is comparable before
and after the shrink.  The survivors form a new process group (one rank a
chip) before :func:`degraded_mesh` builds the mesh on it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.common.config import TrainConfig


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    data: int
    model: int
    pods: int
    microbatch_multiplier: int

    @property
    def chips(self) -> int:
        return self.data * self.model * self.pods


def plan_degraded_mesh(
    alive_chips: int,
    *,
    model: int = 16,
    old_data: int = 16,
    pods: int = 1,
) -> Optional[MeshPlan]:
    """Largest power-of-two data axis that fits the survivors (model axis
    fixed).  Returns None if fewer than one model group survives."""
    if alive_chips < model:
        return None
    data = 1
    while data * 2 * model * pods <= alive_chips and data * 2 <= old_data:
        data *= 2
    return MeshPlan(
        data=data, model=model, pods=pods,
        microbatch_multiplier=old_data // data,
    )


def degraded_mesh(plan: MeshPlan, device_type: str = "cuda"):
    """The plan's ``DeviceMesh`` over the current process group (which must
    hold ``plan.chips`` ranks): dims ``("data", "model")``, or ``("pod",
    "data", "model")`` with more than one pod."""
    from repro_torch.distributed.sharding import make_mesh
    shape = ((plan.pods, plan.data, plan.model) if plan.pods > 1
             else (plan.data, plan.model))
    return make_mesh(shape, device_type)


def adjust_train_config(tcfg: TrainConfig, plan: MeshPlan) -> TrainConfig:
    return dataclasses.replace(
        tcfg, microbatches=tcfg.microbatches * plan.microbatch_multiplier
    )


def reshard_checkpoint(ckpt_dir: str, step: int, like, mesh, shardings):
    """Restore a checkpoint saved under any mesh onto a new mesh: leaves are
    stored whole (one ``.npy`` each), so a restore then a distribute with
    the new ``shardings`` (a tree of ``sharding.NamedSharding`` on
    ``mesh``) is the reshard.  ``like`` gives the structure, dtypes and
    device (plain tensors)."""
    from repro_torch.checkpoint.store import restore
    from repro_torch.distributed.params import distribute_params
    host_tree = restore(ckpt_dir, step, like)
    return distribute_params(host_tree, shardings)
