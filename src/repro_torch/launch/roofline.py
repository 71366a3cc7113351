"""Roofline terms of one step from its op-level cost
(``launch.op_cost``), with ``repro.launch.roofline``'s formula and keys:

  compute term    = flops / peak FLOP/s            (per card)
  memory term     = bytes / HBM bandwidth          (per card)
  collective term = collective bytes / link bandwidth (per card)

The counted step is the per-card program (the dry run cuts the batch to
one card's share), so nothing is divided by the card count; the model's
whole-system FLOPs and bytes are.  The defaults are the H100's
(``launch.mesh``); the caller passes the peak for the dtype the step
computes in: the port runs float32 with TF32 off, ``PEAK_FLOPS_F32``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_F32


def roofline_terms(cost: Dict, model_flops_total: float, chips: int,
                   model_bytes_total: float = 0.0,
                   peak_flops: float = PEAK_FLOPS_F32,
                   hbm_bw: float = HBM_BW,
                   link_bw: float = NVLINK_BW) -> Dict:
    """The three terms, the dominant one, the model's share per card, and
    ``ideal_s`` (the larger of the model's FLOPs at peak and its bytes at
    full bandwidth, per card) over the dominant term: the roofline
    fraction."""
    flops = float(cost.get("flops", 0.0))
    hbm_bytes = float(cost.get("bytes", 0.0))
    coll = float(cost.get("collective_bytes", 0.0))
    t_compute = flops / peak_flops
    t_memory = hbm_bytes / hbm_bw
    t_collective = coll / link_bw
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_collective), key=lambda kv: kv[1])[0]
    bound = max(t_compute, t_memory, t_collective, 1e-30)
    model_per_chip = model_flops_total / chips
    ideal = max(model_per_chip / peak_flops,
                (model_bytes_total / chips) / hbm_bw)
    return {
        "hlo_flops": flops,
        "hlo_bytes": hbm_bytes,
        "collective_bytes": coll,
        "collectives": cost.get("collectives", {}),
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_collective,
        "dominant": dominant,
        "model_flops_per_chip": model_per_chip,
        "model_bytes_per_chip": model_bytes_total / chips,
        "useful_flop_ratio": (model_per_chip / flops) if flops else 0.0,
        "ideal_s": ideal,
        "roofline_fraction": ideal / bound,
    }
