"""RFC encode/decode (paper §V-C): the runtime sparse inter-layer format.

Port of ``repro.kernels.rfc_pack.rfc_encode_pallas`` and
``rfc_decode_pallas``.  Encode takes the block's epilogue with it:
``relu(t + res)`` (joints outside ``live`` zeroed), then front-packs the
non-zeros of each 16-channel bank in order (stable compaction); decode
scatters them back.  On the TPU the compaction is a one-hot permutation
matmul; the CUDA kernels (``csrc/rfc_pack.cu``) give each thread 4
channels and each bank 4 threads.

The format: values (rows, C) float32, each bank's hot values at its front
in channel order and zeros behind, and bits (rows, C/16) int16, bit j of a
bank's word set where its channel j is hot.  This is what
``rfc_encode_pallas`` computes: the same values, and its float hot mask
packed into bits.  :func:`hot_from_bits` and :func:`bits_from_hot` convert
between bits and the JAX float mask: the plain versions below build on the
float-mask cumsum code through them, and the tests and ``bridge.py`` use
them to meet the JAX side; the CUDA wrappers never call them.

The step form (streaming): with ``keep`` (S,) bool over the leading axis
and ``old`` ``{"vals", "bits"}``, a slot whose ``keep`` is False keeps its
old leaves.  Layouts: t, res (..., C) with C % 16 == 0 (``ops`` pads C);
``live`` (V,) bool over the second-to-last axis.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

BANK = 16


def bits_from_hot(hot: torch.Tensor) -> torch.Tensor:
    """A hot mask (..., C) (float 0/1 or bool) -> its bank words
    (..., ceil(C/16)) int16, bit j of a word for channel j of its bank
    (channels past C are cold)."""
    h = (hot > 0).to(torch.int32)
    h = torch.nn.functional.pad(h, (0, -h.shape[-1] % BANK))
    h = h.reshape(*hot.shape[:-1], -1, BANK)
    w = (h << torch.arange(BANK, dtype=torch.int32, device=hot.device)).sum(-1)
    return torch.where(w >= 1 << 15, w - (1 << 16), w).to(torch.int16)


def hot_from_bits(bits: torch.Tensor,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Bank words (..., C/16) int16 -> the hot mask (..., C) as 0/1 of
    ``dtype`` (the JAX kernels' float mask)."""
    w = bits.to(torch.int32) & 0xFFFF
    h = (w[..., None] >> torch.arange(BANK, dtype=torch.int32,
                                      device=bits.device)) & 1
    return h.reshape(*bits.shape[:-1], -1).to(dtype)


def _banks(name: str, x: torch.Tensor):
    rows, cols = x.shape
    if cols % BANK:
        raise ValueError(f"{name}: C={cols} not divisible by bank={BANK}")
    return x.reshape(rows, cols // BANK, BANK)


def _encode_cumsum(x: torch.Tensor):
    """(rows, C) -> (values, hot float mask): ReLU, then a cumsum-based
    scatter of each bank's non-zeros to its front (zeros fill the tail)."""
    b = _banks("rfc_encode", torch.clamp_min(x, 0.0))
    hot = b > 0
    n_hot = hot.sum(-1, keepdim=True)
    # a permutation: hot values to their rank, cold ones behind them
    dest = torch.where(hot, torch.cumsum(hot, -1) - 1,
                       n_hot + torch.cumsum(~hot, -1) - 1)
    vals = torch.zeros_like(b).scatter_(-1, dest, torch.where(hot, b, 0.0))
    return vals.reshape(x.shape), hot.to(x.dtype).reshape(x.shape)


def _decode_cumsum(values: torch.Tensor, hot: torch.Tensor) -> torch.Tensor:
    """(values, hot float mask) (rows, C) -> dense: a cumsum-based gather
    of each hot position's value."""
    v = _banks("rfc_decode", values)
    h = _banks("rfc_decode", hot) > 0
    pos = (torch.cumsum(h, -1) - 1).clamp_min(0)
    return torch.where(h, torch.gather(v, -1, pos), 0.0).reshape(values.shape)


def rfc_encode_plain(t: torch.Tensor, res: Optional[torch.Tensor] = None,
                     live: Optional[torch.Tensor] = None,
                     keep: Optional[torch.Tensor] = None,
                     old: Optional[Dict[str, torch.Tensor]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``relu(t + res)``, rows of joints outside ``live``
    zeroed, packed by :func:`_encode_cumsum`; slots outside ``keep`` take
    ``old``'s leaves.  Returns (values (..., C), bits (..., C/16))."""
    x = torch.relu(t if res is None else t + res)
    if live is not None:
        x = torch.where(live.reshape(-1, 1), x, 0.0)
    C = t.shape[-1]
    vals, hot = _encode_cumsum(x.reshape(-1, C))
    vals = vals.reshape(t.shape)
    bits = bits_from_hot(hot).reshape(*t.shape[:-1], C // BANK)
    if keep is not None:
        k = keep.reshape((-1,) + (1,) * (t.dim() - 1))
        vals = torch.where(k, vals, old["vals"])
        bits = torch.where(k, bits, old["bits"])
    return vals, bits


def rfc_decode_plain(values: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Plain version: :func:`_decode_cumsum` on the unpacked mask."""
    C = values.shape[-1]
    out = _decode_cumsum(values.reshape(-1, C),
                        hot_from_bits(bits, values.dtype).reshape(-1, C))
    return out.reshape(values.shape)


def _check_width(name: str, x: torch.Tensor) -> int:
    if x.dim() < 2 or x.shape[-1] % BANK:
        raise ValueError(f"{name}: expected (..., C) with C % {BANK} == 0, "
                         f"got {tuple(x.shape)}")
    return x.shape[-1]


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernel can read it with 16-byte accesses, else a
    contiguous copy in storage of its own (a contiguous view that starts
    off a 16-byte boundary is copied too)."""
    if x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _check_mask(name: str, m: torch.Tensor, n: int, what: str,
                dev: torch.device) -> torch.Tensor:
    m = m.reshape(-1)
    if m.dtype != torch.bool or m.numel() != n or m.device != dev:
        raise ValueError(f"{name}: {what} must be a bool mask of {n} entries "
                         f"on {dev}, got {m.dtype} {tuple(m.shape)} on "
                         f"{m.device}")
    return m.contiguous()


def rfc_encode_cuda(t: torch.Tensor, res: Optional[torch.Tensor] = None,
                    live: Optional[torch.Tensor] = None,
                    keep: Optional[torch.Tensor] = None,
                    old: Optional[Dict[str, torch.Tensor]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block epilogue and the encode in one launch: (values, bits) of
    ``relu(t + res)`` (see :func:`rfc_encode_plain`).  An input the kernel
    cannot read with 16-byte accesses is copied first (no main-path input
    is).  CUDA tensors launch the kernel; CPU tensors take the plain
    version."""
    if _build.dispatch_device("rfc_encode", t) == "cpu":
        return rfc_encode_plain(t, res, live, keep, old)
    C = _check_width("rfc_encode", t)
    t = _aligned(t)
    rows = t.numel() // C if C else 0
    dev = t.device
    if res is not None:
        if (res.shape != t.shape or res.dtype != torch.float32
                or res.device != dev):
            raise ValueError(f"rfc_encode: res {res.dtype} "
                             f"{tuple(res.shape)} on {res.device} does not "
                             f"match t {tuple(t.shape)} on {dev}")
        res = _aligned(res)
    V = t.shape[-2]
    if live is not None:
        live = _check_mask("rfc_encode", live, V, "live", dev)
    old_vals = old_bits = None
    if keep is not None:
        keep = _check_mask("rfc_encode", keep, t.shape[0], "keep", dev)
        if old is None:
            raise ValueError("rfc_encode: keep needs the old leaves")
        old_vals, old_bits = _aligned(old["vals"]), old["bits"].contiguous()
        if (old_vals.shape != t.shape or old_bits.dtype != torch.int16
                or old_bits.shape != t.shape[:-1] + (C // BANK,)
                or old_bits.device != dev):
            raise ValueError("rfc_encode: the old leaves do not match t")
    _build.check_cuda_f32("rfc_encode", t,
                          *([] if old_vals is None else [old_vals]))
    vals = torch.empty_like(t)
    bits = torch.empty(t.shape[:-1] + (C // BANK,), dtype=torch.int16,
                       device=dev)
    if rows:
        def ptr(a):
            return None if a is None else a.data_ptr()
        _build.launch("rfc_encode", "rfc_encode_f32", dev, t.data_ptr(),
                      ptr(res), ptr(live), ptr(keep), ptr(old_vals),
                      ptr(old_bits), vals.data_ptr(), bits.data_ptr(), rows,
                      C, V, rows // t.shape[0])
    return vals, bits


def rfc_decode_cuda(values: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Bank decompaction (values (..., C), bits (..., C/16)) -> dense
    (..., C): launches the CUDA kernel for CUDA tensors; CPU tensors take
    :func:`rfc_decode_plain`."""
    if _build.dispatch_device("rfc_decode", values) == "cpu":
        return rfc_decode_plain(values, bits)
    C = _check_width("rfc_decode", values)
    if bits.dtype != torch.int16 or bits.shape != values.shape[:-1] + (
            C // BANK,) or bits.device != values.device:
        raise ValueError(f"rfc_decode: bits {bits.dtype} {tuple(bits.shape)}"
                         f" do not match values {tuple(values.shape)}")
    values, bits = _aligned(values), bits.contiguous()
    _build.check_cuda_f32("rfc_decode", values)
    out = torch.empty_like(values)
    if values.numel():
        _build.launch("rfc_decode", "rfc_decode_f32", values.device,
                      values.data_ptr(), bits.data_ptr(), out.data_ptr(),
                      values.numel() // C, C)
    return out
