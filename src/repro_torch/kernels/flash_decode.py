"""GQA decode attention: one query token per (batch, kv head, group
member) against a KV cache whose slots >= ``valid`` are masked, with an
online softmax over the cache.

Port of ``repro.kernels.flash_decode.flash_decode_pallas``; the CUDA
kernel is ``csrc/flash_decode.cu`` (one block per (batch, kv head), the
cache read once in 64-row tiles staged by ``cp.async`` one tile ahead,
``valid`` read from device memory).  Its
oracle is ``ref.flash_decode_ref``, which the plain version is.

Layouts: q (B, Hkv, G, D), k and v (B, S, Hkv, D) float32, ``valid`` an
int or a one-element int32 tensor on the card -> (B, Hkv, G, D).
"""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_decode_ref as flash_decode_plain

MAX_HEAD_DIM = 128        # the kernel's limit on D


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: Union[int, torch.Tensor]) -> torch.Tensor:
    """(B, Hkv, G, D) queries against a (B, S, Hkv, D) cache, slots >=
    ``valid`` masked: launches the CUDA kernel for CUDA tensors; CPU
    tensors take :func:`flash_decode_plain`."""
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
        _build.launch("flash_decode", "flash_decode_f32", q.device,
                      q.data_ptr(), k.data_ptr(), v.data_ptr(),
                      valid.data_ptr(), out.data_ptr(), B, k.shape[1], Hkv,
                      G, D)
    return out
