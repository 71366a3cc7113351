"""GQA decode attention: one query token per (batch, kv head, group
member) against a KV cache whose slots >= ``valid`` are masked (and, with
a sliding ``window``, the slots below ``valid − window``), with an online
softmax over the cache.

Port of ``repro.kernels.flash_decode.flash_decode_pallas``; the CUDA
kernel is ``csrc/flash_decode.cu`` (flash-decoding: a cluster of
``splits`` blocks per (batch, kv head, up to 4 query rows) shares the first
``valid`` rows, each warp streams 16-row tiles through its own
``cp.async`` ring, and the partial softmaxes merge in a fixed order
through distributed shared memory; ``valid`` is read on the card).
:func:`decode_plan` sizes a launch from the shapes and the SM count.  Its
oracle is ``ref.flash_decode_ref``, which the plain version is.

Layouts: q (B, Hkv, G, D) float32, k and v (B, S, Hkv, D) float32 or
both bfloat16 (a bf16 cache: ``csrc/flash_decode_bf16.cu``, D % 8 == 0,
the probabilities rounded to bf16 as the reference's bf16 attention
rounds them) with D <= 256, ``valid`` an int or a one-element int32
tensor on the card -> (B, Hkv, G, D) float32.  Head dims up to 128 run
the kernel's narrow instantiations (up to 4 query rows a block); 129 to
256 the wide ones (up to 2 query rows, so a lane's query and
accumulator registers stay the narrow path's).
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_ref as flash_decode_plain
from repro_torch.common.cost import reports_work

MAX_HEAD_DIM = 256        # the kernel's limit on D
NARROW_HEAD_DIM = 128     # D above this takes the wide instantiations
SMEM_MAX = 227 * 1024     # dynamic shared memory a block may use
TILE_ROWS = 16            # rows of a warp's tile (csrc/flash_decode.cu)
MAX_QUERY_ROWS = 4        # query rows per block
WIDE_QUERY_ROWS = 2       # query rows per block at D > 128
MAX_SPLITS = 16           # cluster size; above 8 a non-portable one
WARPS = (1, 2, 4, 8)
STAGES = (2, 3, 4, 5, 6)  # ring slots per warp: stages - 1 tiles in flight
H100_SMS = 132
# How far the kernel may lie from the plain version on a bf16 cache.  Both
# round each probability to bf16 against the row's max, so they differ
# only where another float32 sum order tips a value across a bf16 rounding
# boundary, which moves an output by a share of what the rounding moves it
# by; a kernel that skipped the rounding reads the whole of it
# (bf16_rounding_gap).  The bound is a share of that gap under a fixed cap
# for the kind of input (bf16_bound).
BF16_SHARE = 0.5
BF16_FLOOR = 1e-5        # float32 accumulation where the gap is ~0 (valid 0)
BF16_CAP_SERVED = 1e-3   # a served model's steps: peaked rows, where a
                         # tipped rounding weighs most (H100: 5.1e-4 read)
BF16_CAP_RANDOM = 3e-4   # random q, k and v (H100: 1.24e-4 at most read)


class DecodePlan(NamedTuple):
    """One launch: ``splits`` blocks (a cluster) per (b, h, query rows),
    each of ``warps`` warps with ``stages`` ring slots of 16 rows."""
    splits: int
    warps: int
    stages: int
    grid: tuple
    smem: int


def query_rows(G: int, D: int) -> int:
    """Query rows per block (csrc/flash_decode.cu): G up to the cap (4,
    or 2 at D > 128), else G's chunks of at most the cap evened out; the
    cap itself under 4-byte staging (D % 4 != 0)."""
    cap = MAX_QUERY_ROWS if D <= NARROW_HEAD_DIM else WIDE_QUERY_ROWS
    if D % 4:
        return cap
    chunks = -(-G // cap)
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


def flash_decode_work(B: int, S: int, Hkv: int, G: int, D: int,
                      itemsize: int = 4, rows: int = None) -> tuple:
    """(flops, bytes) of one call reading ``rows`` cache rows (default all
    S: a shape-only count cannot read ``valid``, and reading it on the
    card would sync): the q·k and p·v dot products as flops (the softmax
    is not a dot), q, the rows of k and v (``itemsize`` bytes a value),
    ``valid`` and the output moved once."""
    n = S if rows is None else rows
    return (4 * B * Hkv * G * n * D,
            4 * 2 * B * Hkv * G * D + itemsize * 2 * B * n * Hkv * D + 4)


def bf16_rounding_gap(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: Union[int, torch.Tensor], window: int = 0,
                      want: Optional[torch.Tensor] = None) -> float:
    """max |:func:`flash_decode_plain` − the plain version under float32
    rules| on the same bf16 cache: what a kernel that read the bf16 cache
    but skipped the rounding of the probabilities would read (``want``,
    the plain version's output, is computed when not given)."""
    if want is None:
        want = flash_decode_plain(q, k, v, valid, window)
    f32 = flash_decode_plain(q, k.float(), v.float(), valid, window)
    return float((want - f32).abs().max())


def bf16_bound(gap: float, cap: float = BF16_CAP_RANDOM) -> float:
    """How far the kernel may lie from :func:`flash_decode_plain` on a
    bf16 cache whose :func:`bf16_rounding_gap` is ``gap``: ``BF16_SHARE``
    of that gap plus ``BF16_FLOOR``, at most ``cap``.  A kernel that
    skips the rounding of p reads the whole gap, above the bound wherever
    the gap exceeds twice the floor."""
    return min(BF16_SHARE * gap + BF16_FLOOR, cap)


def _check_cache(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is float32 and k and v are both float32 or both
    bfloat16, contiguous and on q's device (nothing is cast)."""
    _build.check_cuda_f32("flash_decode", q)
    for t in (k, v):
        if t.device != q.device:
            raise ValueError(f"flash_decode: tensors on {t.device} and "
                             f"{q.device}")
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"flash_decode: expected a float32 or bfloat16 "
                            f"cache, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash_decode: expected contiguous tensors")
    if k.dtype != v.dtype:
        raise TypeError(f"flash_decode: k is {k.dtype} and v {v.dtype}")


@reports_work("flash_decode", lambda q, k, v, valid, window=0, plan=None:
              flash_decode_work(*k.shape[:3], q.shape[2], q.shape[3],
                                k.element_size()))
def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: Union[int, torch.Tensor], window: int = 0,
                 plan: Optional[DecodePlan] = None) -> torch.Tensor:
    """(B, Hkv, G, D) queries against a (B, S, Hkv, D) cache, slots >=
    ``valid`` masked, and with ``window`` > 0 (a host int) the slots
    below ``valid − window`` too (the kernel reads that bound from
    ``valid`` on the card): launches the CUDA kernel for CUDA tensors
    (sized by ``plan``, default :func:`decode_plan`); CPU tensors take
    :func:`flash_decode_plain`.  A bf16 cache needs D % 8 == 0 and 16-byte
    aligned k and v (16-byte staging of 8 values)."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    B, Hkv, G, D = q.shape
    if k.shape[0] != B or k.shape[2] != Hkv or k.shape[3] != D:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} does not match "
                         f"the cache {tuple(k.shape)}")
    window = int(window)
    if window < 0:
        raise ValueError(f"flash_decode: window {window} < 0")
    if _build.dispatch_device("flash_decode", q) == "cpu":
        return flash_decode_plain(q, k, v, valid, window)
    _check_cache(q, k, v)
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: head_dim {D} > {MAX_HEAD_DIM}")
    bf16 = k.dtype == torch.bfloat16
    if bf16 and (D % 8 or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(f"flash_decode: a bf16 cache needs D % 8 == 0 and "
                         f"16-byte aligned k and v (D = {D})")
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
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                out.data_ptr(), B, S, Hkv, G, D, plan.splits, plan.warps,
                plan.stages)
        if bf16:
            _build.launch("flash_decode", "flash_decode_bf16", q.device,
                          *args, window)
        else:
            # 16-byte staging needs 16-byte rows and pointers; else 4-byte
            vec = int(D % 4 == 0 and k.data_ptr() % 16 == 0
                      and v.data_ptr() % 16 == 0)
            _build.launch("flash_decode", "flash_decode_f32", q.device,
                          *args, vec, window)
    return out
