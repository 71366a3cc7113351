"""GQA decode attention: one query token per (batch, kv head, group
member) against a KV cache whose slots >= ``valid`` are masked, with an
online softmax over the cache.

Port of ``repro.kernels.flash_decode.flash_decode_pallas``; the CUDA
kernel is ``csrc/flash_decode.cu`` (flash-decoding: a cluster of
``splits`` blocks per (batch, kv head, up to 4 query rows) shares the first
``valid`` rows, each warp streams 16-row tiles through its own
``cp.async`` ring, and the partial softmaxes merge in a fixed order
through distributed shared memory; ``valid`` is read on the card).
:func:`decode_plan` sizes a launch from the shapes and the SM count.  Its
oracle is ``ref.flash_decode_ref``, which the plain version is.

Layouts: q (B, Hkv, G, D), k and v (B, S, Hkv, D) float32, ``valid`` an
int or a one-element int32 tensor on the card -> (B, Hkv, G, D).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_ref as flash_decode_plain

MAX_HEAD_DIM = 128        # the kernel's limit on D
SMEM_MAX = 227 * 1024     # dynamic shared memory a block may use
TILE_ROWS = 16            # rows of a warp's tile (csrc/flash_decode.cu)
MAX_QUERY_ROWS = 4        # query rows per block
MAX_SPLITS = 16           # cluster size; above 8 a non-portable one
WARPS = (1, 2, 4, 8)
STAGES = (2, 3, 4, 5, 6)  # ring slots per warp: stages - 1 tiles in flight
H100_SMS = 132


class DecodePlan(NamedTuple):
    """One launch: ``splits`` blocks (a cluster) per (b, h, query rows),
    each of ``warps`` warps with ``stages`` ring slots of 16 rows."""
    splits: int
    warps: int
    stages: int
    grid: tuple
    smem: int


def query_rows(G: int, D: int) -> int:
    """Query rows per block (csrc/flash_decode.cu): G up to 4, else G's
    chunks of at most 4 evened out; 4 under 4-byte staging (D % 4 != 0)."""
    if D % 4:
        return MAX_QUERY_ROWS
    chunks = -(-G // MAX_QUERY_ROWS)
    return -(-G // chunks)


def decode_smem_bytes(D: int, G: int, splits: int, warps: int,
                      stages: int) -> int:
    """Shared memory of one block (csrc/flash_decode.cu:smem_bytes): the
    cluster's gather buffer, then each warp's ring of K and V tiles with
    rows padded by 4 floats."""
    d4, gq = -(-D // 4), query_rows(G, D)
    own = -(-gq * d4 // splits)
    gather = -(-2 * splits * gq // 4) * 4 + 4 * splits * own
    return 4 * (gather + warps * stages * 2 * TILE_ROWS * (4 * d4 + 4))


def make_plan(B: int, S: int, Hkv: int, G: int, D: int, splits: int,
              warps: int, stages: int) -> DecodePlan:
    """A :class:`DecodePlan` of the given sizes; raises if the kernel
    does not take them."""
    smem = decode_smem_bytes(D, G, splits, warps, stages)
    if not (1 <= splits <= min(MAX_SPLITS, -(-S // TILE_ROWS))
            and warps in WARPS and stages in STAGES and smem <= SMEM_MAX):
        raise ValueError(f"flash_decode: no plan with splits={splits} "
                         f"warps={warps} stages={stages} at S={S} D={D}")
    return DecodePlan(splits, warps, stages,
                      (splits, Hkv * -(-G // query_rows(G, D)), B), smem)


def _pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


MIN_BLOCKS_PER_SM = 0.45  # decode_plan: blocks a launch should reach
MAX_WARP_TILES = 32       # decode_plan: a warp's tiles before more splits


@functools.lru_cache(maxsize=512)
def decode_plan(B: int, S: int, Hkv: int, G: int, D: int,
                sms: int = H100_SMS) -> DecodePlan:
    """The launch for these shapes on a card of ``sms`` SMs, never from
    ``valid`` (a decode step does not read its position on the host).

    Splits: the least power of two whose clusters reach 0.45 blocks per
    SM (60 on the H100).  Warps: up to 8, about half a split's 16-row
    tiles, as many as shared memory holds.  Then splits double while a
    warp would walk more than 32 tiles.  Splits stay at most 16 and at
    most a quarter of the cache's tiles (a split costs a cluster barrier,
    about a tile's wait).  Stages: 2 (the tile being read and the next in
    flight).  On the H100 (``tools/torch_kernel_plans.py``, PERF.md) this
    picks 4/4/2 at the served smollm-360m step (B 4, S 512) and 8/8/2 at
    the long context (B 8, S 32 768), the sweep's fastest plans, and 2/8/2
    at h2o-danube's ring (B 4, S 4 096, Hkv 8, D 80), 2–6% behind 12/1/2
    there."""
    if min(B, S, Hkv, G, D) <= 0 or D > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: no plan for B={B} S={S} Hkv={Hkv} "
                         f"G={G} D={D}")
    heads = B * Hkv * -(-G // query_rows(G, D))
    tiles = -(-S // TILE_ROWS)
    top = min(MAX_SPLITS, _pow2_floor(tiles // 4))
    splits = 1
    while heads * splits < MIN_BLOCKS_PER_SM * sms and splits < top:
        splits *= 2
    warps = min(8, _pow2_floor(-(-tiles // splits) // 2))
    while decode_smem_bytes(D, G, splits, warps, 2) > SMEM_MAX:
        warps //= 2
    while -(-tiles // (splits * warps)) > MAX_WARP_TILES and splits < top:
        splits *= 2
    return make_plan(B, S, Hkv, G, D, splits, warps, 2)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: Union[int, torch.Tensor],
                 plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """(B, Hkv, G, D) queries against a (B, S, Hkv, D) cache, slots >=
    ``valid`` masked: launches the CUDA kernel for CUDA tensors (sized by
    ``plan``, default :func:`decode_plan`); CPU tensors take
    :func:`flash_decode_plain`."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hkv, G, D = q.shape
    if k.shape[0] != B or k.shape[2] != Hkv or k.shape[3] != D:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"the cache {tuple(k.shape)}")
    if _build.dispatch_device("flash_decode", q) == "cpu":
        return flash_decode_plain(q, k, v, valid)
    _build.check_cuda_f32("flash_decode", q, k, v)
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: head_dim {D} > {MAX_HEAD_DIM}")
    if not torch.is_tensor(valid):
        valid = torch.full((1,), int(valid), dtype=torch.int32,
                           device=q.device)
    if (valid.dtype != torch.int32 or valid.numel() != 1
            or valid.device != q.device):
        raise TypeError(f"flash_decode: valid must be one int32 on "
                        f"{q.device}, got {valid.dtype} {tuple(valid.shape)} "
                        f"on {valid.device}")
    out = torch.empty_like(q)
    if out.numel():
        S = k.shape[1]
        if plan is None:
            plan = decode_plan(B, S, Hkv, G, D, _build.sm_count(q.device))
        # 16-byte staging needs 16-byte rows and pointers; else 4-byte
        vec = int(D % 4 == 0 and k.data_ptr() % 16 == 0
                  and v.data_ptr() % 16 == 0)
        _build.launch("flash_decode", "flash_decode_f32", q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      valid.data_ptr(), out.data_ptr(), B, S, Hkv, G, D,
                      plan.splits, plan.warps, plan.stages, vec)
    return out
