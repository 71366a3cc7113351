"""Dynamic data scheduling expectation model (paper §V-B, eq. 6, Table II).

On the FPGA, a Dyn-Mult-PE holds ``w`` kept weights (waiting queues) and a
*smaller* number of multipliers (DSPs); valid work per cycle is the number of
queues whose feature operand is non-zero, d ~ Binomial(w, 1-s) for feature
sparsity ``s``.  The expectation E(D) = w·(1-s) sizes the DSP pool; dynamic
scheduling dispatches the d valid MACs onto E(D)-ish DSPs, trading a small
queueing delay for hardware savings.

A GPU's tensor cores are statically scheduled too, so the *mechanism* does
not transfer; the *statistical sizing* does: E(D) sizes compacted tiles
(RFC mini-bank depths).  A copy of ``repro.core.sched.expectation``
(numpy and ``math``), number for number.
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np


def valid_work_pmf(w: int, sparsity: float) -> np.ndarray:
    """P(d valid MACs) for d=0..w with feature sparsity ``sparsity``."""
    p = 1.0 - sparsity
    return np.array(
        [math.comb(w, d) * p**d * (1 - p) ** (w - d) for d in range(w + 1)]
    )


def expected_valid(w: int, sparsity: float) -> float:
    """E(D) = sum_d d·p(d) = w·(1-s).  (The paper's printed eq. (6) is the
    w=6 case with grouped terms.)"""
    pmf = valid_work_pmf(w, sparsity)
    return float(sum(d * pmf[d] for d in range(w + 1)))


def dsp_allocation(w: int, sparsity: float, guard: float = 0.15) -> int:
    """Number of multipliers to provision: ceil(E(D)·(1+guard)), ≥1, ≤w."""
    return max(1, min(w, math.ceil(expected_valid(w, sparsity) * (1.0 + guard))))


def delay_probability(w: int, sparsity: float, dsps: int) -> float:
    """P(valid work exceeds provisioned multipliers in a cycle) — the
    paper's 'max delay' proxy (Table II)."""
    pmf = valid_work_pmf(w, sparsity)
    return float(pmf[dsps + 1:].sum())


def scheduling_report(w: int, sparsity: float, guard: float = 0.15) -> Dict[str, float]:
    """Full Table-II row for one (queue width, sparsity) point: E(D), the
    provisioned multiplier count, its saving/efficiency, and delay prob."""
    d = dsp_allocation(w, sparsity, guard)
    return {
        "kept_weights": w,
        "sparsity": sparsity,
        "expected_valid": expected_valid(w, sparsity),
        "dsps": d,
        "dsp_saving": 1.0 - d / w,
        "delay_prob": delay_probability(w, sparsity, d),
        "efficiency": expected_valid(w, sparsity) / d,
    }
