"""Windowed similarity graph C(t) of adaptive streaming, per slab slot:
the K-deep window sums of the θ/φ embedding rings, Θ·Φᵀ/√Ce, the input-
joint columns >= ``valid`` set to -1e30, and a row softmax.

Port of ``repro.kernels.window_sim.windowed_similarity_pallas``; the CUDA
kernel is ``csrc/window_sim.cu``.  Two forms of one kernel:

* the bare form :func:`windowed_similarity_cuda`, (S, K, V, Ce) rings ->
  (S, V, V), the Pallas kernel's counterpart;
* the step form :func:`windowed_similarity_step_cuda`, which first writes
  this frame's embeddings into the rings as the streaming step does (row
  ``t % K`` of each slot with ``has_input``, zeros where ``in_valid`` is
  false), out of place, and returns the new rings with the graph.

:func:`sim_plan` spreads each slot over blocks of ``rows`` joints (grid
(ceil(V / rows), S)).  The oracle is
``repro_torch.core.agcn.adaptive.windowed_ck(ring.sum(1), ...)``, which
the plain version calls.

Layouts: ring_th, ring_ph (S, K, V, Ce) float32 (any ring phase: the
window sum does not depend on it); e_th, e_ph (S, V, Ce) float32; t (S,)
int32 (the block clock); has_input, in_valid (S,) bool -> (S, V, V).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.agcn.adaptive import windowed_ck
from repro_torch.kernels import _build

MAX_V = 128               # joints: a lane owns at most 4 columns
MAX_THREADS = 512
ROUND = 2                 # 16-byte entries a thread loads at once (K = 9)
ROWS = 4                  # sim_plan: joints a block owns, one warp each
SMEM_MAX = 227 * 1024
THREADS = (128, 256, 512)


class SimPlan(NamedTuple):
    """One launch: blocks of ``threads`` threads, each owning ``rows``
    joints of one slot."""
    rows: int
    threads: int
    grid: tuple
    smem: int


def sim_smem_bytes(V: int, Ce: int, rows: int) -> int:
    """Shared memory of one block (csrc/window_sim.cu): its rows of Θ's
    window sum, then all of Φ's with an odd row stride Ce + 1."""
    return 4 * (rows * Ce + V * (Ce + 1))


def make_sim_plan(S: int, K: int, V: int, Ce: int, rows: int,
                  threads: int) -> SimPlan:
    """A :class:`SimPlan` of the given sizes; raises if the kernel does
    not take them."""
    smem = sim_smem_bytes(V, Ce, rows)
    if not (1 <= S <= 65535 and K >= 1 and 1 <= V <= MAX_V and Ce >= 1
            and 1 <= rows <= V and 32 <= threads <= MAX_THREADS
            and threads % 32 == 0 and smem <= SMEM_MAX):
        raise ValueError(f"windowed_similarity: no plan with rows={rows} "
                         f"threads={threads} at S={S} K={K} V={V} Ce={Ce}")
    return SimPlan(rows, threads, (-(-V // rows), S), smem)


def sim_plan(S: int, K: int, V: int, Ce: int, sms: int = 132) -> SimPlan:
    """The launch for these shapes on a card of ``sms`` SMs.

    Rows: blocks of up to ``ROWS`` joints, one warp a row, as many blocks
    per slot as fit ``sms`` over all slots (at least one), the rows evened
    out over them.  Threads: the fewest of ``THREADS`` that give each row
    a warp and each of the block's entries (Φ's V rows and its own Θ rows,
    4 channels an entry where Ce % 4 == 0) a thread, else the most, which
    load them in one round of ``ROUND`` at every path shape.  Every block
    loads all of Φ, so fewer rows a block only add blocks: on the H100
    (``tools/torch_kernel_plans.py --only windowed_similarity``, PERF.md)
    the step form with 4 rows is within 0.16 µs of the sweep's fastest
    plan at every S = 1, 3, 8 shape of 25 and 50 joints, where 7–8 rows a
    block cost up to 0.6 µs a launch more at Ce = 64."""
    if not 1 <= V <= MAX_V:
        raise ValueError(f"windowed_similarity: V={V} outside [1, {MAX_V}]")
    chunks = max(1, min(-(-V // ROWS), sms // max(S, 1)))
    rows = -(-V // chunks)
    entries = (V + rows) * (Ce // 4 if Ce % 4 == 0 else Ce)
    threads = next((n for n in THREADS if n >= 32 * min(rows, 16)
                    and n >= entries), MAX_THREADS)
    return make_sim_plan(S, K, V, Ce, rows, threads)


def windowed_similarity_plain(ring_th: torch.Tensor, ring_ph: torch.Tensor,
                              valid: int) -> torch.Tensor:
    """Plain version: the ring rows summed in ring order (the kernel's),
    then the oracle ``adaptive.windowed_ck`` with columns >= ``valid``
    masked."""
    th, ph = ring_th[:, 0], ring_ph[:, 0]
    for k in range(1, ring_th.shape[1]):
        th = th + ring_th[:, k]
        ph = ph + ring_ph[:, k]
    return windowed_ck(th, ph, valid_joints=valid)


def windowed_similarity_step_plain(
        ring_th: torch.Tensor, ring_ph: torch.Tensor, e_th: torch.Tensor,
        e_ph: torch.Tensor, t: torch.Tensor, has_input: torch.Tensor,
        in_valid: torch.Tensor, valid: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the step form, the streaming step's own sequence:
    the embeddings zeroed where ``in_valid`` is false, written at row
    ``t % K`` of each slot with ``has_input`` (new rings), then
    :func:`windowed_similarity_plain` on the new rings."""
    K = ring_th.shape[1]
    keep = in_valid[:, None, None]
    e_th = torch.where(keep, e_th, 0.0)
    e_ph = torch.where(keep, e_ph, 0.0)
    write = ((torch.arange(K, device=t.device)[None, :] == (t % K)[:, None])
             & has_input[:, None])[:, :, None, None]
    new_th = torch.where(write, e_th.unsqueeze(1), ring_th)
    new_ph = torch.where(write, e_ph.unsqueeze(1), ring_ph)
    return new_th, new_ph, windowed_similarity_plain(new_th, new_ph, valid)


def _check_rings(name: str, ring_th: torch.Tensor, ring_ph: torch.Tensor,
                 valid: int) -> None:
    if ring_th.dim() != 4 or ring_ph.shape != ring_th.shape:
        raise ValueError(f"{name}: rings {tuple(ring_th.shape)} and "
                         f"{tuple(ring_ph.shape)} do not match")
    V = ring_th.shape[2]
    if not 1 <= valid <= V:
        raise ValueError(f"{name}: valid={valid} outside [1, {V}]")


def _plan(ring: torch.Tensor, plan: Optional[SimPlan]) -> SimPlan:
    S, K, V, Ce = ring.shape
    return plan or sim_plan(S, K, V, Ce, _build.sm_count(ring.device))


def windowed_similarity_cuda(ring_th: torch.Tensor, ring_ph: torch.Tensor,
                             valid: int,
                             plan: Optional[SimPlan] = None) -> torch.Tensor:
    """(S, K, V, Ce) rings -> (S, V, V) graphs, columns >= ``valid``
    (1 <= valid <= V) masked: launches the CUDA kernel for CUDA tensors
    (sized by ``plan``, default :func:`sim_plan`); CPU tensors take
    :func:`windowed_similarity_plain`."""
    _check_rings("windowed_similarity", ring_th, ring_ph, valid)
    S, K, V, Ce = ring_th.shape
    if _build.dispatch_device("windowed_similarity", ring_th) == "cpu":
        return windowed_similarity_plain(ring_th, ring_ph, valid)
    _build.check_cuda_f32("windowed_similarity", ring_th, ring_ph)
    out = torch.empty((S, V, V), dtype=ring_th.dtype, device=ring_th.device)
    if S:
        p = _plan(ring_th, plan)
        _build.launch("windowed_similarity", "window_sim_f32",
                      ring_th.device, ring_th.data_ptr(), ring_ph.data_ptr(),
                      *(None,) * 7, out.data_ptr(), S, K, V, Ce, int(valid),
                      p.rows, p.threads)
    return out


def windowed_similarity_step_cuda(
        ring_th: torch.Tensor, ring_ph: torch.Tensor, e_th: torch.Tensor,
        e_ph: torch.Tensor, t: torch.Tensor, has_input: torch.Tensor,
        in_valid: torch.Tensor, valid: int, plan: Optional[SimPlan] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The step form: (new ring_th, new ring_ph, graph).  Each slot with
    ``has_input`` gets row ``t % K`` of both rings replaced by its
    embedding (by zeros where ``in_valid`` is false), the other rows and
    slots copied; the input rings are not modified.  The graph is the bare
    form's on the new rings.  Launches the CUDA kernel for CUDA tensors;
    CPU tensors take :func:`windowed_similarity_step_plain`."""
    name = "windowed_similarity_step"
    _check_rings(name, ring_th, ring_ph, valid)
    S, K, V, Ce = ring_th.shape
    if e_th.shape != (S, V, Ce) or e_ph.shape != (S, V, Ce):
        raise ValueError(f"{name}: embeddings {tuple(e_th.shape)} and "
                         f"{tuple(e_ph.shape)} do not match rings "
                         f"{tuple(ring_th.shape)}")
    if not t.shape == has_input.shape == in_valid.shape == (S,):
        raise ValueError(f"{name}: t, has_input and in_valid must be ({S},)")
    if _build.dispatch_device(name, ring_th) == "cpu":
        return windowed_similarity_step_plain(ring_th, ring_ph, e_th, e_ph,
                                              t, has_input, in_valid, valid)
    _build.check_cuda_f32(name, ring_th, ring_ph, e_th, e_ph)
    if t.dtype != torch.int32 or has_input.dtype != torch.bool or (
            in_valid.dtype != torch.bool):
        raise TypeError(f"{name}: t must be int32, has_input and in_valid "
                        f"bool")
    for m in (t, has_input, in_valid):
        if m.device != ring_th.device or not m.is_contiguous():
            raise ValueError(f"{name}: t, has_input and in_valid must be "
                             f"contiguous on the rings' device")
    new_th, new_ph = torch.empty_like(ring_th), torch.empty_like(ring_ph)
    out = torch.empty((S, V, V), dtype=ring_th.dtype, device=ring_th.device)
    if S:
        p = _plan(ring_th, plan)
        _build.launch("windowed_similarity", "window_sim_f32",
                      ring_th.device, ring_th.data_ptr(), ring_ph.data_ptr(),
                      e_th.data_ptr(), e_ph.data_ptr(), t.data_ptr(),
                      has_input.data_ptr(), in_valid.data_ptr(),
                      new_th.data_ptr(), new_ph.data_ptr(), out.data_ptr(),
                      S, K, V, Ce, int(valid), p.rows, p.threads)
    return new_th, new_ph, out
