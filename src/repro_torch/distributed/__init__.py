"""`repro_torch.distributed` — the distributed serving tier, the port of
``repro.distributed.router`` and ``repro.distributed.serving``.

* :class:`~repro_torch.distributed.router.ReplicaRouter`,
  :func:`~repro_torch.distributed.router.run_routed_sessions` — N
  :class:`~repro_torch.serving.GcnService` replicas in one process behind
  consistent pinning, load-feedback placement and drain-and-rebalance.
* :func:`~repro_torch.distributed.serving.make_batch_mesh`,
  :func:`~repro_torch.distributed.serving.collective_cost_ms`,
  :func:`~repro_torch.distributed.serving.run_sharded_sessions` — the 1-D
  slot mesh that ``GcnService(mesh=...)`` splits its session slab over.

Like the JAX tier it is single-controller: one process and one host
scheduler address every device explicitly (no ``torch.distributed``
ranks), and the collectives XLA inserts there are device-to-device
copies here.

The training half runs over ``torch.distributed`` ranks instead:
:mod:`~repro_torch.distributed.sharding` (the logical-axis rules,
``constrain``, ``batch_mean``) and :mod:`~repro_torch.distributed.params`
(the reference's parameter specs as DTensor placements) feed
``train.steps.make_train_step``'s data-parallel step and
``fault.elastic``."""
from repro_torch.distributed.router import (ReplicaRouter, RouterHandle,
                                            run_routed_sessions)
from repro_torch.distributed.serving import (BATCH_AXIS, BatchMesh,
                                             collective_cost_ms,
                                             make_batch_mesh,
                                             run_sharded_sessions)

__all__ = [
    "BATCH_AXIS",
    "BatchMesh",
    "ReplicaRouter",
    "RouterHandle",
    "collective_cost_ms",
    "make_batch_mesh",
    "run_routed_sessions",
    "run_sharded_sessions",
]
