"""Shared layer primitives: norms, RoPE, inits, activations, and the
vocab-parallel embedding lookup, logits and cross-entropy a model axis
takes where its plan shards the vocabulary.  Port of
``repro.models.layers.common``."""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding


def he_init(generator: Optional[torch.Generator], shape: Sequence[int],
            fan_in: int) -> torch.Tensor:
    """float32 normal weights with variance 2 / fan_in, drawn from
    ``generator`` on the generator's device.  Without a generator, an
    uninitialised tensor on the default device: the shape-only init under
    ``torch.device("meta")``."""
    if generator is None:
        return torch.empty(tuple(shape), dtype=torch.float32)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w * math.sqrt(2.0 / max(1, fan_in))


def lecun_init(generator: Optional[torch.Generator], shape: Sequence[int],
               fan_in: int) -> torch.Tensor:
    """float32 normal weights with variance 1 / fan_in, as
    :func:`he_init` draws them (shape-only without a generator)."""
    if generator is None:
        return torch.empty(tuple(shape), dtype=torch.float32)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return w * math.sqrt(1.0 / max(1, fan_in))


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` in float32 for statistics, states and accumulators, or as it
    is when it is float64: a float64 run (chip_smoke's exact-arithmetic
    check of the SSM and hybrid recurrences) stays float64 throughout."""
    return x if x.dtype == torch.float64 else x.float()


def wide_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype :func:`wide` gives a tensor of ``dtype``."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def rmsnorm_init(d: int, device: Optional[torch.device] = None) -> Dict:
    return {"scale": torch.ones(d, device=device)}


def rmsnorm(x: torch.Tensor, p: Dict, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with float32 statistics and the elementwise product in
    ``x``'s dtype."""
    var = wide(x).square().mean(-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


def rmsnorm_heads(x: torch.Tensor, p: Dict, layer: str, eps: float = 1e-6
                  ) -> torch.Tensor:
    """:func:`rmsnorm` of ``layer``'s heads.  Where the active plan shards
    ``layer`` by heads (``sharding.takes_shards``), ``x``'s last dim and
    ``p["scale"]`` are this model rank's contiguous share of the
    normalised dim and the sum of squares is summed over the ranks (a
    norm over the share alone is another function); its backward sums
    too, since each rank's output reads the statistic for its own share
    only.  :func:`rmsnorm` itself elsewhere."""
    if not sharding.takes_shards(layer):
        return rmsnorm(x, p, eps)
    ssq = wide(x).square().sum(-1, keepdim=True)
    ssq = sharding.copy_to_model(sharding.reduce_from_model(ssq))
    n = x.shape[-1] * sharding.model_group().size
    inv = torch.rsqrt(ssq / n + eps).to(x.dtype)
    return x * inv * p["scale"].to(x.dtype)


def layernorm_init(d: int, device: Optional[torch.device] = None) -> Dict:
    return {"scale": torch.ones(d, device=device),
            "bias": torch.zeros(d, device=device)}


def layernorm(x: torch.Tensor, p: Dict, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (the biased variance), cast back to ``x``'s
    dtype."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = (x32 - mean).square().mean(-1, keepdim=True)
    return ((x32 - mean) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def stack_layers(make: Callable[[], Dict], shape: Sequence[int]) -> Dict:
    """A tree whose leaves stack ``prod(shape)`` calls of ``make()`` (one
    layer's parameters) into leaves of shape (*shape, ...), drawn in
    row-major order; each layer is copied into its slot as it is drawn,
    so the tree is never held twice.  Under ``torch.device("meta")`` the
    leaves are shapes alone."""
    from repro_torch.common.tree import tree_map
    out = None
    n = math.prod(shape)
    for i in range(n):
        lp = make()
        if out is None:
            out = tree_map(lambda t: t.new_empty((*shape, *t.shape)), lp)
        idx = _unravel(i, shape)
        tree_map(lambda dst, src: dst[idx].copy_(src), out, lp)
    return out


def _unravel(i: int, shape: Sequence[int]) -> Tuple[int, ...]:
    idx = []
    for n in reversed(shape):
        idx.append(i % n)
        i //= n
    return tuple(reversed(idx))


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "silu":
        return F.silu
    if name == "gelu":                   # jax.nn.gelu's default: tanh form
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "relu2":                  # squared ReLU
        return lambda x: torch.relu(x).square()
    raise ValueError(name)


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float,
                device: Optional[torch.device] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos|cos, -sin|sin) of shape (B or 1, S, 1, head_dim) for positions
    (B, S) or (S,): computed once per forward and shared by every layer's
    :func:`rotate`."""
    freqs = rope_freqs(head_dim, theta, device)               # (D/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs                # (B, S, D/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    return torch.cat([cos, cos], -1), torch.cat([-sin, sin], -1)


def rotate(x: torch.Tensor, tables: Tuple[torch.Tensor, torch.Tensor]
           ) -> torch.Tensor:
    """RoPE of x (B, S, H, D) from :func:`rope_tables`: the two halves of
    each head rotate (not interleaved pairs), as the reference does;
    x1·cos + x2·(−sin) and x2·cos + x1·sin equal the reference's
    x1·cos − x2·sin and x2·cos + x1·sin exactly."""
    cos2, sin2 = tables
    xf = wide(x)
    x1, x2 = xf.chunk(2, dim=-1)
    return (xf * cos2 + torch.cat([x2, x1], -1) * sin2).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) or (S,)."""
    return rotate(x, rope_tables(positions, x.shape[-1], theta, x.device))


def _vocab_sharded() -> bool:
    plan = sharding.model_plan()
    return plan is not None and plan.vocab


def _vocab_range(embed: torch.Tensor) -> Tuple[int, int]:
    """(first row, rows) of this model rank's vocabulary shard."""
    n = embed.shape[0]
    return sharding.model_group().rank * n, n


def embed_lookup(tokens: torch.Tensor, embed: torch.Tensor,
                 scale: Optional[float] = None,
                 prefix: Optional[torch.Tensor] = None,
                 seq_shard: bool = False) -> torch.Tensor:
    """``F.embedding(tokens, embed)``, times ``scale`` when given, after
    ``prefix`` (B, P, d) when given (the VLM's projected image
    embeddings, put before the text).  Where the plan shards the
    vocabulary ``embed`` is this model rank's rows: each rank looks up the
    tokens in its range (zero elsewhere) and the ranks' rows are summed
    (each token's row lies on one rank, so the sum, scaled before it, is
    the one process's exactly).

    With ``seq_shard`` the result is this model rank's sequence shard of
    the P + S positions: the ranks' rows reduce-scattered, or the rank's
    slice of the whole lookup.  The prefix, whole on every rank, stands as
    zeros in the reduce-scatter and the rank's slice of it is added
    after."""
    sharded = _vocab_sharded()
    if sharded:
        lo, n = _vocab_range(embed)
        t = tokens.long() - lo
        inside = ((t >= 0) & (t < n)).to(embed.dtype)[..., None]
        x = F.embedding(t.clamp(0, n - 1), embed) * inside
    else:
        x = F.embedding(tokens, embed)
    if scale is not None:
        x = x * scale
    if prefix is None:
        return sharding.layer_out(x, sharded, seq_shard)
    prefix = prefix.to(x.dtype)
    if not seq_shard:
        return torch.cat([prefix, sharding.layer_out(x, sharded, False)], 1)
    if not sharded:
        return sharding.layer_out(torch.cat([prefix, x], 1), False, True)
    return (sharding.layer_out(torch.cat([torch.zeros_like(prefix), x], 1),
                               True, True)
            + sharding.layer_out(torch.cat([prefix, torch.zeros_like(x)], 1),
                                 False, True))


def tied_logits(x: torch.Tensor, embed: torch.Tensor,
                gather: bool = True, seq_shard: bool = False
                ) -> torch.Tensor:
    """``x @ embed.T``.  Where the plan shards the vocabulary: this model
    rank's vocabulary columns (column-parallel), all-gathered into the
    whole vocabulary unless ``gather`` is False (the loss takes them
    sharded: :func:`xent`).  With ``seq_shard`` ``x`` is this rank's
    sequence shard, all-gathered first (``sharding.layer_in``), so the
    logits cover the whole sequence on every rank and the loss is one
    number there."""
    sharded = _vocab_sharded()
    local = sharding.layer_in(x, sharded, seq_shard) @ embed.T
    if not sharded:
        return local
    return sharding.gather_from_model(local, -1) if gather else local


def xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy over the logits' last axis plus the 1e-4 z-loss
    (the reference's logit drift regulariser).  Where the plan shards the
    vocabulary, ``logits`` are this model rank's columns
    (``tied_logits(..., gather=False)``): the max, the sum of exps and the
    target's logit are each reduced over the model ranks.  float32 (float64
    logits stay float64: :func:`wide`)."""
    logits = wide(logits)
    if not _vocab_sharded():
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return (logz - gold).mean() + 1e-4 * logz.square().mean()
    ax = sharding.model_group()
    n = logits.shape[-1]
    lo = ax.rank * n
    m = sharding.max_over(logits.amax(-1), ax)
    # exp in place on the shifted copy: one (B, S, V/M) temporary beside
    # the logits, not two (the largest tensors of a long prefill's loss)
    sumexp = sharding.reduce_from_model(
        (logits - m[..., None]).exp_().sum(-1))
    logz = torch.log(sumexp) + m
    t = labels.long() - lo
    inside = ((t >= 0) & (t < n)).to(logits.dtype)
    gold = sharding.reduce_from_model(torch.gather(
        logits, -1, t.clamp(0, n - 1)[..., None])[..., 0] * inside)
    return (logz - gold).mean() + 1e-4 * logz.square().mean()
