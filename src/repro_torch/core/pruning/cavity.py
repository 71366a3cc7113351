"""Fine-grained "cavity" pruning patterns for temporal filters (paper
§IV-B), numpy on the host; the same construction as
``repro.core.pruning.cavity``, so the masks are equal.

A cavity pattern is a (loop, K) binary mask — ``loop`` recurring 9×1
kernels applied cyclically across the temporal filters of a block.  A zero
tap means "do not sample this time offset".  Variant 1 is balanced (every
tap position kept ⌊k/K⌋ or ⌈k/K⌉ times), variant 2 the paper's unbalanced
baseline.
"""
from __future__ import annotations

import numpy as np


def cavity_pattern(name: str, kernel: int = 9, loop: int = 8) -> np.ndarray:
    """Mask of shape (loop, kernel), dtype bool, True = kept.

    ``name`` is ``cav-<percent>-<variant>``; ``"none"``/empty keeps all."""
    if not name or name == "none":
        return np.ones((loop, kernel), dtype=bool)
    parts = name.split("-")
    if len(parts) != 3 or parts[0] != "cav":
        raise ValueError(f"bad cavity pattern name: {name!r}")
    percent, variant = int(parts[1]), int(parts[2])
    total = loop * kernel
    keep_total = total - int(round(total * percent / 100.0))
    base, extra = divmod(keep_total, kernel)
    quotas = [base + (1 if c < extra else 0) for c in range(kernel)]
    if variant != 1:                                # skew odd -> even columns
        for c in range(0, kernel - 1, 2):
            move = min(quotas[c + 1], loop - quotas[c], 2)
            quotas[c] += move
            quotas[c + 1] -= move
    # each column claims the rows with the lowest keep count so far, ties
    # broken by a rotating offset so kept taps spread across time offsets
    mask = np.zeros((loop, kernel), dtype=bool)
    row_count = np.zeros(loop, dtype=int)
    for c, q in enumerate(quotas):
        order = sorted(range(loop), key=lambda r: (row_count[r], (r - c) % loop))
        for r in order[:q]:
            mask[r, c] = True
            row_count[r] += 1
    return mask


def tile_pattern(mask: np.ndarray, num_filters: int) -> np.ndarray:
    """Tile the (loop, K) pattern over ``num_filters`` filters -> (F, K)."""
    loop = mask.shape[0]
    reps = int(np.ceil(num_filters / loop))
    return np.tile(mask, (reps, 1))[:num_filters]


def balance_stats(mask: np.ndarray) -> dict:
    """The balance of a (loop, K) pattern (paper Fig. 10): kept fraction,
    per-tap-position and per-kernel keep counts, and whether every
    position is kept within one of every other."""
    col = mask.sum(axis=0)
    row = mask.sum(axis=1)
    return {
        "keep_frac": float(mask.mean()),
        "per_position_min": int(col.min()),
        "per_position_max": int(col.max()),
        "per_kernel_min": int(row.min()),
        "per_kernel_max": int(row.max()),
        "balanced": bool(col.max() - col.min() <= 1),
    }
