"""2s-AGCN parameters and model API (paper §II).  Port of
``repro.core.agcn.model``.

Data layout: (N, T, V, C) with the person axis folded into N.  Ten
TCN-GCN blocks + global pool + FC:

    block(x) = relu( bn(tconv(gcnunit(x), stride)) + residual(x) )
    gcnunit(x) = relu( bn(sum_k (G_k·x)·W_k) + down(x) )

BatchNorm is stateless (batch statistics); the learned scale/bias are the
parameters.  With ``cfg.use_ck`` each block also has the θ/φ embeddings
(Cin, max(4, Cin//4)) of the windowed C_k graph.  The per-op math lives in ``repro_torch.core.agcn.engine``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.config import ModelConfig
from repro_torch.common.device import DeviceLike, resolve_device
from repro_torch.common.tree import tree_map
from repro_torch.core.agcn.graph import NTU_EDGES
from repro_torch.core.pruning.plan import PrunePlan


def _conv_init(gen: torch.Generator, shape, fan_in: int) -> torch.Tensor:
    return torch.randn(shape, generator=gen) * np.sqrt(2.0 / fan_in)


def _bn_init(c: int) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones(c), "bias": torch.zeros(c)}


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
                *, seed: int = 0, device: DeviceLike = None) -> Dict[str, Any]:
    """Parameter tree for one (single-stream) AGCN model, with the JAX
    package's shapes.  Numbers come from ``generator`` (a CPU generator,
    else one seeded with ``seed``), drawn on the CPU so every device gets
    the same weights, then moved to ``device`` (default CUDA)."""
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(seed)
    V, K, TK = cfg.gcn_joints, cfg.gcn_kv, cfg.gcn_tkernel
    cin = cfg.gcn_in_channels
    blocks = []
    for b, cout in enumerate(cfg.gcn_channels):
        blk: Dict[str, Any] = {
            "Bk": torch.full((K, V, V), 1e-6),
            "Wk": _conv_init(gen, (K, cin, cout), cin),
            "bn_s": _bn_init(cout),
            "tconv_w": _conv_init(gen, (cout, cout, TK), cout * TK),
            "tconv_b": torch.zeros(cout),
            "bn_t": _bn_init(cout),
        }
        if cfg.use_ck:          # the windowed C_k embeddings θ and φ
            ce = max(4, cin // 4)
            blk["theta"] = _conv_init(gen, (cin, ce), cin)
            blk["phi"] = _conv_init(gen, (cin, ce), cin)
        if cin != cout:
            blk["down_w"] = _conv_init(gen, (cin, cout), cin)
            blk["bn_down"] = _bn_init(cout)
        if cin != cout or cfg.gcn_strides[b] != 1:
            blk["short_w"] = _conv_init(gen, (cin, cout), cin)
            blk["bn_short"] = _bn_init(cout)
        blocks.append(blk)
        cin = cout
    params = {
        "data_bn": _bn_init(cfg.gcn_in_channels * V),
        "blocks": blocks,
        "fc_w": _conv_init(gen, (cin, cfg.gcn_num_classes), cin),
        "fc_b": torch.zeros(cfg.gcn_num_classes),
    }
    return tree_map(lambda t: t.to(dev), params)


def forward(
    params: Dict[str, Any],
    x: torch.Tensor,                      # (N, T, V, C)
    cfg: ModelConfig,
    plan: Optional[PrunePlan] = None,
    quant: bool = False,
    backend: Optional[str] = None,
    exec_plan=None,
) -> torch.Tensor:
    """Logits (N, num_classes).  A prebuilt ``exec_plan`` skips plan
    compilation (the serving hot path); otherwise one is compiled here
    with ``backend`` (default ``cfg.gcn_backend``)."""
    from repro_torch.core.agcn import engine
    if exec_plan is None:
        exec_plan = engine.build_execution_plan(
            params, cfg, plan, quant=quant,
            backend=backend or cfg.gcn_backend)
    return engine.execute(exec_plan, x)


def init_stream(
    params: Dict[str, Any],
    cfg: ModelConfig,
    x_calib: torch.Tensor,                # (N, T, V, C) representative clip
    plan: Optional[PrunePlan] = None,
    quant: bool = False,
    backend: Optional[str] = None,
    exec_plan=None,
):
    """State init for per-frame continual inference: ``(exec_plan,
    StreamState)``.  ``x_calib`` fixes the stream's batch size and
    calibrates the frozen batch-norm statistics with which
    ``engine.step_frame`` reproduces the clip engine after the drain.  A
    prebuilt ``exec_plan`` skips plan compilation; otherwise one is
    compiled as in :func:`forward`."""
    from repro_torch.core.agcn import engine
    ep = exec_plan
    if ep is None:
        ep = engine.build_execution_plan(
            params, cfg, plan, quant=quant,
            backend=backend or cfg.gcn_backend)
    return ep, engine.init_stream_state(ep, x_calib.shape[0], x_calib=x_calib)


def bone_stream(x: torch.Tensor) -> torch.Tensor:
    """Second stream of 2s-AGCN: bone vectors = joint − parent joint on the
    NTU-25 skeleton (the root's stays zero)."""
    out = torch.zeros_like(x)
    for j, p in NTU_EDGES:
        out[..., j - 1, :] = x[..., j - 1, :] - x[..., p - 1, :]
    return out


def bone_stream_parents(x: torch.Tensor, parents) -> torch.Tensor:
    """Bone stream from a (V,) parent map (``plan.arrays["parents"]``):
    one gather; roots parent themselves, so their bone vector is zero."""
    idx = torch.as_tensor(parents, dtype=torch.int64, device=x.device)
    return x - x.index_select(-2, idx)


def two_stream_logits(params_joint, params_bone, x, cfg, plan=None,
                      quant=False, backend=None):
    """Ensemble of the joint and bone streams (the '2s' in 2s-AGCN)."""
    lj = forward(params_joint, x, cfg, plan, quant, backend=backend)
    lb = forward(params_bone, bone_stream(x), cfg, plan, quant,
                 backend=backend)
    return 0.5 * (lj + lb)


@torch.no_grad()
def feature_sparsity_per_block(params, x: torch.Tensor, cfg: ModelConfig,
                               plan: Optional[PrunePlan] = None
                               ) -> List[float]:
    """Post-ReLU sparsity (share of exact zeros) of each block's output on
    clip batch ``x``, through a ``reference`` plan on the params' device,
    as JAX does: drives RFC mini-bank sizing and the Drop-* channel
    schedules (paper Fig. 9, Table III)."""
    from repro_torch.core.agcn import engine
    ep = engine.build_execution_plan(params, cfg, plan, backend="reference")
    return [int((h == 0).sum()) / h.numel()
            for h in engine.block_outputs(ep, x)]
