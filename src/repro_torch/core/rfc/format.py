"""RFC — Runtime Sparse Feature Compress format (paper §V-C, Fig. 7).
Port of ``repro.core.rfc.format``.

A feature vector is split along channels into *banks* of width 16.  Each
bank is ReLU'd, its non-zero elements are compacted to the front, a 16-bit
*hot code* records which positions were non-zero, and an *mbhot* code
records how many 4-deep *mini-banks* the compacted data occupies.

Two forms of the hot code meet here:
  * the plain codec's bool mask (..., C/bank, bank) of :func:`rfc_encode`,
    the JAX oracle's form (any bank width);
  * the int16 words (..., C/16) that the card's encode writes
    (``repro_torch.kernels.rfc_pack``, bank 16).
:func:`storage_cost` and :func:`expected_sparsity_categories` take either
(an int16 tensor or array is read as words), so C3's cost can be counted on
what the card's encode really wrote; both forms give identical numbers for
the same activations.  The counting runs on the input's device and moves
only per-bank counts to the host.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels.rfc_pack import BANK, hot_from_bits

HotLike = Union[np.ndarray, torch.Tensor]


def rfc_encode(x: torch.Tensor, bank: int = 16, apply_relu: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode the last axis of ``x`` bank by bank: (values, hot), values of
    x's shape with each bank's non-zeros front-packed in order (a stable
    partition) and zeros behind, hot (..., C/bank, bank) bool."""
    if x.shape[-1] % bank:
        raise ValueError(f"channels {x.shape[-1]} not divisible by bank {bank}")
    if apply_relu:
        x = torch.clamp_min(x, 0)
    banks = x.reshape(*x.shape[:-1], x.shape[-1] // bank, bank)
    hot = banks != 0
    order = torch.sort((~hot).to(torch.uint8), dim=-1, stable=True).indices
    values = torch.gather(banks, -1, order)
    return values.reshape(x.shape), hot


def rfc_decode(values: torch.Tensor, hot: torch.Tensor,
               bank: int = 16) -> torch.Tensor:
    """Inverse of :func:`rfc_encode`: scatter the packed values back."""
    vb = values.reshape(*values.shape[:-1], values.shape[-1] // bank, bank)
    hot = hot.reshape(vb.shape) != 0
    pos = (torch.cumsum(hot.to(torch.int32), -1) - 1).clamp_min(0)
    out = torch.where(hot, torch.gather(vb, -1, pos.long()),
                      torch.zeros((), dtype=vb.dtype, device=vb.device))
    return out.reshape(values.shape)


def mbhot(hot: torch.Tensor, minibank: int = 4) -> torch.Tensor:
    """Mini-banks each bank occupies, ceil(nnz / minibank), from a hot
    mask (..., bank)."""
    nnz = (hot != 0).sum(-1)
    return (nnz + minibank - 1) // minibank


def _is_words(hot: HotLike) -> bool:
    return hot.dtype in (torch.int16, np.int16)


def bank_nnz(hot: HotLike, bank: int = 16) -> np.ndarray:
    """Non-zeros per bank (int64, one entry per bank) of a hot mask
    (..., n_banks, bank) — bool or 0/1, numpy or a tensor — or of the
    card's int16 words (..., n_banks), whose banks are 16 wide.  The
    words of a width that is not a multiple of 16 cover its cold padding
    too, which the counts then include (the mask form, like JAX's encode,
    has whole banks only)."""
    if _is_words(hot):
        if bank != BANK:
            raise ValueError(f"packed hot words hold banks of {BANK}, not "
                             f"{bank}")
        words = torch.as_tensor(hot)
        nnz = hot_from_bits(words, torch.int32).reshape(-1, BANK).sum(-1)
    elif isinstance(hot, torch.Tensor):
        nnz = (hot.reshape(-1, bank) != 0).sum(-1)
    else:
        return (np.asarray(hot).reshape(-1, bank) != 0).sum(-1).astype(
            np.int64)
    return nnz.to(torch.int64).cpu().numpy()


# ---------------------------------------------------------------------------
# Storage-cost model (paper Fig. 11): bits to hold one layer's activations.
# ---------------------------------------------------------------------------

def storage_cost(hot: HotLike, bank: int = 16, minibank: int = 4,
                 elem_bits: int = 16) -> Dict[str, float]:
    """Dense, CSC and RFC storage of activations with hot code ``hot``
    (a mask (..., n_banks, bank) or the card's int16 words, see
    :func:`bank_nnz`): CSC holds each non-zero with an 8-bit index plus a
    16-bit pointer per bank; RFC holds mini-bank-rounded values plus the
    16-bit hot and 4-bit mbhot codes per bank."""
    per_bank = bank_nnz(hot, bank)
    n_banks = int(per_bank.size)
    n_elems = n_banks * bank
    nnz = int(per_bank.sum())
    dense_bits = n_elems * elem_bits
    csc_bits = nnz * (elem_bits + 8) + n_banks * 16
    mini_used = int(((per_bank + minibank - 1) // minibank).sum())
    rfc_bits = mini_used * minibank * elem_bits + n_banks * (bank + 4)
    return {
        "dense_bits": float(dense_bits),
        "csc_bits": float(csc_bits),
        "rfc_bits": float(rfc_bits),
        "rfc_vs_dense_reduction": 1.0 - rfc_bits / dense_bits,
        "csc_vs_dense_reduction": 1.0 - csc_bits / dense_bits,
        "sparsity": 1.0 - nnz / n_elems,
    }


def minibank_depths(sparsity_quartiles: Tuple[float, float, float, float],
                    total_depth: int, minibank: int = 4) -> Tuple[int, ...]:
    """Mini-bank depths from the offline sparsity distribution (paper
    §V-C): the fraction of vectors in quartiles I..IV (75-100%, 50-75%,
    25-50%, 0-25% sparse, needing 1..4 mini-banks); mini-bank m serves the
    vectors that need at least m+1."""
    q = np.asarray(sparsity_quartiles, dtype=np.float64)
    q = q / q.sum()
    need = np.cumsum(q[::-1])[::-1]
    depths = np.ceil(need * total_depth).astype(int)
    return tuple(int(d) for d in depths)


def expected_sparsity_categories(hot: HotLike, bank: int = 16
                                 ) -> Tuple[float, ...]:
    """The share of bank vectors in the paper's four sparsity categories
    (Table III): I 75-100%, II 50-75%, III 25-50%, IV 0-25% sparse."""
    s = 1.0 - bank_nnz(hot, bank) / bank
    return (
        float((s >= 0.75).mean()),
        float(((s >= 0.5) & (s < 0.75)).mean()),
        float(((s >= 0.25) & (s < 0.5)).mean()),
        float((s < 0.25).mean()),
    )
