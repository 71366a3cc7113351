"""Hybrid pruning plan (paper §IV): channel compaction (C1) plus coarse and
fine temporal pruning (C2), numpy on the host; the same decisions as
``repro.core.pruning.plan``.

The plan is static: it names the spatial-conv input channels each block
keeps, the temporal filters it keeps (= the next block's kept inputs,
Fig. 2), and the cavity tap mask of those filters.  The accounting —
compression ratio, graph-skip efficiency (paper §VI: 3.0–8.4×, 73.20%),
the Drop-* keep schedules from feature sparsity, the unstructured
baseline and the cavity balance report — is the JAX package's, number for
number.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.pruning.cavity import (balance_stats, cavity_pattern,
                                             tile_pattern)


@dataclasses.dataclass(frozen=True)
class BlockPrunePlan:
    """Static pruning decisions for one conv block."""

    kept_in: Tuple[int, ...]        # spatial-conv input channels kept (C1)
    kept_filters: Tuple[int, ...]   # temporal filters kept (C2 coarse)
    tap_mask: np.ndarray            # (num_kept_filters, K) cavity mask (C2 fine)
    _cin: int = 0
    _cout: int = 0


@dataclasses.dataclass(frozen=True)
class PrunePlan:
    """Whole-model plan: per-block C1/C2 decisions, the cavity pattern's
    name and the C5 input-frame skip."""

    blocks: Tuple[BlockPrunePlan, ...]
    cavity_name: str
    input_skip: int = 1

    def summary(self, channels: Sequence[int], in_channels: int,
                kv: int = 3, tkernel: int = 9, joints: int = 25) -> Dict:
        """Compression and skip accounting (paper Fig. 8, §VI): parameters
        of the spatial 1×1 convs (kv × kept inputs × cout) and temporal
        convs (kept taps × cout) before and after pruning, and the share
        of graph-matmul work (∝ input channels entering G·f) skipped."""
        dense_params = kept_params = 0
        dense_graph = kept_graph = 0
        cin = in_channels
        for b, plan in enumerate(self.blocks):
            cout = channels[b]
            dense_params += kv * cin * cout + cout * cout * tkernel
            kept_params += (kv * len(plan.kept_in) * cout
                            + int(plan.tap_mask.sum()) * cout)
            dense_graph += cin * joints * joints
            kept_graph += len(plan.kept_in) * joints * joints
            cin = cout
        return {
            "compression_ratio": dense_params / max(1, kept_params),
            "graph_skip_efficiency": 1.0 - kept_graph / max(1, dense_graph),
            "param_reduction": 1.0 - kept_params / max(1, dense_params),
            "dense_params": dense_params,
            "kept_params": kept_params,
        }


def select_channels_by_magnitude(w: np.ndarray, keep_frac: float) -> Tuple[int, ...]:
    """C1: keep the input channels with the largest mean |W|.
    w: (K_v, C_in, C_out)."""
    cin = w.shape[1]
    keep = max(1, int(round(cin * keep_frac)))
    score = np.abs(w).mean(axis=(0, 2))
    kept = np.argsort(-score, kind="stable")[:keep]
    return tuple(sorted(int(i) for i in kept))


def _plan(kept_ins, channels, pat, cins, cavity_name, input_skip) -> PrunePlan:
    blocks = []
    for b, cout in enumerate(channels):
        # filters of block b feeding pruned inputs of block b+1 are dropped
        kept_filters = (kept_ins[b + 1] if b + 1 < len(channels)
                        else tuple(range(cout)))
        blocks.append(BlockPrunePlan(
            kept_in=kept_ins[b], kept_filters=kept_filters,
            tap_mask=tile_pattern(pat, len(kept_filters)),
            _cin=cins[b], _cout=cout))
    return PrunePlan(blocks=tuple(blocks), cavity_name=cavity_name,
                     input_skip=input_skip)


def build_prune_plan(
    spatial_weights: List[np.ndarray],
    channels: Sequence[int],
    keep_fracs: Sequence[float],
    cavity_name: str = "cav-70-1",
    tkernel: int = 9,
    input_skip: int = 1,
) -> PrunePlan:
    """The hybrid plan from each block's spatial weights (K_v, C_in, C_out)
    by magnitude; block 0 (3 input channels) is never pruned."""
    nblocks = len(channels)
    if len(spatial_weights) != nblocks or len(keep_fracs) != nblocks:
        raise ValueError("need one spatial weight and keep fraction per block")
    kept_ins = [tuple(range(spatial_weights[0].shape[1]))]
    kept_ins += [select_channels_by_magnitude(spatial_weights[b], keep_fracs[b])
                 for b in range(1, nblocks)]
    pat = cavity_pattern(cavity_name, kernel=tkernel)
    cins = [int(w.shape[1]) for w in spatial_weights]
    return _plan(kept_ins, channels, pat, cins, cavity_name, input_skip)


def plan_from_config(cfg) -> Optional[PrunePlan]:
    """Static plan from a ModelConfig without weights: kept channels are
    the first ⌈frac·cin⌉ (channel identity changes no shape).  ``None``
    when the config sets no prune fractions."""
    if not cfg.prune_channel_fracs:
        return None
    channels, fracs = cfg.gcn_channels, cfg.prune_channel_fracs
    if len(fracs) != len(channels):
        raise ValueError("need one prune fraction per block")
    pat = cavity_pattern(cfg.cavity_pattern or "none", kernel=cfg.gcn_tkernel)
    kept_ins, cins = [], []
    cin = cfg.gcn_in_channels
    for b, cout in enumerate(channels):
        keep = cin if b == 0 else max(1, int(round(cin * fracs[b])))
        kept_ins.append(tuple(range(keep)))
        cins.append(cin)
        cin = cout
    return _plan(kept_ins, channels, pat, cins, cfg.cavity_pattern,
                 cfg.input_skip)


def drop_scheme(sparsities: Sequence[float], shift: float = 0.0) -> List[float]:
    """Channel keep fractions from observed feature sparsity (paper Fig. 9):
    each block drops about its sparsity, Drop-2/3 ``shift`` more; clamped
    to [0.05, 1]."""
    return [max(0.05, min(1.0, 1.0 - (s + shift))) for s in sparsities]


def unstructured_prune(w: np.ndarray, frac: float) -> np.ndarray:
    """The paper's baseline (Fig. 8): zero the ``frac`` smallest-magnitude
    weights (ties at the threshold go too)."""
    flat = np.abs(w).ravel()
    k = int(len(flat) * frac)
    if k == 0:
        return w.copy()
    thresh = np.partition(flat, k - 1)[k - 1]
    out = w.copy()
    out[np.abs(out) <= thresh] = 0.0
    return out


def cavity_report(name: str, tkernel: int = 9) -> Dict:
    """:func:`~repro_torch.core.pruning.cavity.balance_stats` of a named
    cavity pattern (paper Fig. 10)."""
    return balance_stats(cavity_pattern(name, kernel=tkernel))
