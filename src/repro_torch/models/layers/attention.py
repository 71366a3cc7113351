"""GQA attention with blockwise (flash-style) softmax, sliding-window
masks and a KV-cache decode path.  Port of
``repro.models.layers.attention`` (self-attention only: cross-attention
belongs to the audio family, not ported).

``flash_attention`` is the plain blockwise version (online softmax over KV
blocks, float32 running max and sum); it serves the ``reference`` backend
and every call with more than one query token.  With the ``cuda`` backend a
one-token decode step against the cache goes to the ``flash_decode``
kernel instead.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.models.layers.common import he_init, rotate

NEG_INF = -1e30
BACKENDS = ("reference", "cuda")

Scalar = Union[int, torch.Tensor]


def attn_init(generator: torch.Generator, d_model: int, num_heads: int,
              num_kv_heads: int, head_dim: int) -> Dict:
    """q and the fused k|v projections, and the output projection."""
    return {
        "wq": he_init(generator, (d_model, num_heads * head_dim), d_model),
        "wkv": he_init(generator, (d_model, 2 * num_kv_heads * head_dim),
                       d_model),
        "wo": he_init(generator, (num_heads * head_dim, d_model),
                      num_heads * head_dim),
    }


def _mask(qi: torch.Tensor, kj: torch.Tensor, causal: bool, window: int,
          kv_valid: Optional[Scalar]) -> torch.Tensor:
    """qi: (qb,), kj: (kb,) global indices -> (qb, kb) additive mask."""
    m = torch.zeros((qi.shape[0], kj.shape[0]), dtype=torch.float32,
                    device=qi.device)
    if causal:
        m = torch.where(kj[None, :] > qi[:, None], NEG_INF, m)
    if window > 0:
        m = torch.where(qi[:, None] - kj[None, :] >= window, NEG_INF, m)
    if kv_valid is not None:
        m = torch.where(kj[None, :] >= kv_valid, NEG_INF, m)
    return m


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0,
                    q_offset: Scalar = 0, kv_valid: Optional[Scalar] = None,
                    q_block: int = 512, kv_block: int = 1024) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> (B, Sq, H, D).  Query head
    h = hkv * G + g attends with kv head hkv.  ``q_offset`` is the global
    position of query 0 and ``kv_valid`` the number of valid cache slots
    (ints or device scalars)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    qb, kb = min(q_block, Sq), min(kv_block, Skv)
    Sq_p, Skv_p = -(-Sq // qb) * qb, -(-Skv // kb) * kb
    if Skv_p != Skv:
        k = F.pad(k, (0, 0, 0, 0, 0, Skv_p - Skv))
        v = F.pad(v, (0, 0, 0, 0, 0, Skv_p - Skv))
        kv_valid = Skv if kv_valid is None else kv_valid
    if Sq_p != Sq:
        q = F.pad(q, (0, 0, 0, 0, 0, Sq_p - Sq))
    nq, nk = Sq_p // qb, Skv_p // kb
    qg = q.reshape(B, nq, qb, Hkv, G, D)
    kg = k.reshape(B, nk, kb, Hkv, D)
    vg = v.reshape(B, nk, kb, Hkv, D)
    dev = q.device
    outs = []
    for qidx in range(nq):
        qblk = qg[:, qidx]                        # (B, qb, Hkv, G, D)
        qi = q_offset + qidx * qb + torch.arange(qb, device=dev)
        m_run = torch.full((B, Hkv, G, qb), NEG_INF, device=dev)
        l_run = torch.zeros((B, Hkv, G, qb), device=dev)
        acc = torch.zeros((B, Hkv, G, qb, D), device=dev)
        for kidx in range(nk):
            kj = kidx * kb + torch.arange(kb, device=dev)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qblk,
                             kg[:, kidx]).float() * scale
            s = s + _mask(qi, kj, causal, window, kv_valid)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp((s - m_new[..., None]).to(v.dtype))
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.float().sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p, vg[:, kidx]).float()
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp_min(l_run[..., None], 1e-20)
        outs.append(out.permute(0, 3, 1, 2, 4))   # (B, qb, Hkv, G, D)
    out = torch.stack(outs, 1).reshape(B, Sq_p, H, D)[:, :Sq]
    return out.to(q.dtype)


def attention_layer(p: Dict, x: torch.Tensor,
                    rope: Tuple[torch.Tensor, torch.Tensor], *,
                    num_heads: int, num_kv_heads: int, head_dim: int,
                    causal: bool = True, window: int = 0,
                    cache: Optional[Dict] = None, backend: str = "cuda"
                    ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x (B, S, d) -> (B, S, d).  ``rope`` holds the tokens' RoPE tables
    (``common.rope_tables`` of their positions; the reference takes the
    positions and theta and builds them in every layer).
    ``cache`` = {"k", "v": (B, L, Hkv, D),
    "pos": int32 device scalar} is updated in place (the tokens' k/v
    written at their slots, pos advanced by S) and returned; the reference
    returns a new cache instead.  With a sliding window the cache holds at
    most ``window`` slots and is a ring: one token is written at pos % L
    and attends to every live slot.  A cache longer than the window
    (gemma3's local layers) is not ported.

    With ``backend="cuda"`` a one-token step against the cache calls the
    ``flash_decode`` kernel with valid = pos + 1 (min(pos + 1, L) in a
    ring), read on the card; every other call runs
    :func:`flash_attention`."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    B, S, _ = x.shape
    q = (x @ p["wq"]).reshape(B, S, num_heads, head_dim)
    k, v = (x @ p["wkv"]).chunk(2, dim=-1)
    k = k.reshape(B, S, num_kv_heads, head_dim)
    v = v.reshape(B, S, num_kv_heads, head_dim)
    q, k = rotate(q, rope), rotate(k, rope)

    kv_valid, q_offset, ring = None, 0, False
    if cache is not None:
        pos = cache["pos"]                              # int32 device scalar
        L = cache["k"].shape[1]
        if 0 < window < L:
            raise NotImplementedError(
                f"a {L}-slot cache under a {window}-token window needs a "
                f"lower bound on the window (gemma3's local layers; see "
                f"ROADMAP.md, Queue 1 item 13)")
        ring = window > 0 and S == 1
        slot = pos % L if ring else pos
        # a device index: the write never reads the position on the host
        idx = slot.reshape(1).long() + torch.arange(S, device=x.device)
        cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
        k, v = cache["k"], cache["v"]
        kv_valid = torch.clamp(pos + S, max=L) if ring else pos + S
        q_offset = pos

    if backend == "cuda" and cache is not None and S == 1:
        G = num_heads // num_kv_heads
        out = flash_decode(q.reshape(B, num_kv_heads, G, head_dim), k, v,
                           kv_valid.reshape(1))
    else:
        out = flash_attention(q, k, v, causal=causal and not ring,
                              window=0 if ring else window,
                              q_offset=0 if ring else q_offset,
                              kv_valid=kv_valid)
    if cache is not None:
        cache["pos"].add_(S)             # after every read of the old pos
    return out.reshape(B, S, num_heads * head_dim) @ p["wo"], cache
