"""Backend-dispatched AGCN execution engine, clip mode
(plan-compile-then-execute).  Port of ``repro.core.agcn.engine``.

An ``ExecutionPlan`` is compiled once from ``(params, PrunePlan,
ModelConfig)``: kept-channel gathers, the graphs ``A + B_k``, the temporal
filter gather with its cavity tap mask, packed cavity weights and Q8.8
weights.  The hot loop only executes it.  Two backends implement the
per-block ops:

  reference — plain torch einsum and conv (the JAX reference backend's
              counterpart).
  cuda      — the hand-written kernels in ``repro_torch.kernels.ops``:
              ``graph_sconv`` (graph product + 1×1 conv fused),
              packed ``cavity_tconv`` (kept taps only) and the RFC
              encode/decode round trip between blocks.  On CPU tensors the
              kernels' plain versions run instead (the tests' path).

Not ported yet (ROADMAP.md): streaming and the session slab, the CSR
spatial conv (``sconv="csr"``), the windowed C_k graph (``use_ck``), and
skeletons other than ``ntu25``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.core.agcn.graph import get_topology
from repro_torch.core.pruning.plan import PrunePlan
from repro_torch.core.quant import quantize_q88
from repro_torch.kernels import ops

BACKENDS = ("reference", "cuda")


# ---------------------------------------------------------------------------
# plan containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockStatic:
    """Per-block shapes and flags."""

    stride: int
    cout: int
    n_kept_filters: int
    tkernel: int
    pruned_filters: bool     # kept_filters scatter present


@dataclasses.dataclass(frozen=True)
class PlanStatic:
    """Whole-plan metadata: backend, C5 input skip, the RFC inter-layer
    format flags and the per-block ``BlockStatic`` tuple."""

    backend: str
    input_skip: int
    use_rfc: bool            # RFC round trip between blocks
    rfc_bank: int
    blocks: Tuple[BlockStatic, ...]


@dataclasses.dataclass
class ExecutionPlan:
    """Compiled, engine-ready form of one AGCN stream: ``arrays`` holds the
    tensors (pre-gathered / pre-quantized / pre-packed weights, graphs
    ``A + B_k``, kept-index vectors), all on one device."""

    arrays: Dict[str, Any]
    static: PlanStatic


# ---------------------------------------------------------------------------
# shared math
# ---------------------------------------------------------------------------

def _bn_stats(x: torch.Tensor, eps: float = 1e-5):
    """(mean, inv) over all-but-channel axes: the clip-mode batch stats.
    Population variance, as ``jnp.var``."""
    dims = tuple(range(x.dim() - 1))
    mean = x.mean(dims, keepdim=True)
    var = x.var(dims, keepdim=True, correction=0)
    return mean, torch.rsqrt(var + eps)


def _bn_norm(x, p, mean, inv):
    return (x - mean) * inv * p["scale"] + p["bias"]


def batch_norm(x: torch.Tensor, p: Dict[str, torch.Tensor],
               eps: float = 1e-5) -> torch.Tensor:
    """Stateless batch norm with the batch's own statistics."""
    mean, inv = _bn_stats(x, eps)
    return _bn_norm(x, p, mean, inv)


def _bn_live(site: str, x, p):
    """Default BN tap: clip-mode batch statistics, site ignored."""
    return batch_norm(x, p)


class _BNRecorder:
    """BN tap that records each site's (mean, inv) while normalizing
    exactly like the live tap (the calibration pass for frozen stats)."""

    def __init__(self):
        self.stats: Dict[str, Dict[str, torch.Tensor]] = {}

    def __call__(self, site, x, p):
        mean, inv = _bn_stats(x)
        self.stats[site] = {"mean": mean.reshape(-1), "inv": inv.reshape(-1)}
        return _bn_norm(x, p, mean, inv)


def _proj(x, w, bnp, stride, bn=_bn_live, site=""):
    if stride != 1:
        x = x[:, ::stride]
    return bn(site, torch.einsum("ntvc,co->ntvo", x, w), bnp)


def _scatter_filters(out: torch.Tensor, fidx: torch.Tensor, cout: int):
    """Scatter compacted filter outputs back to full width; pruned filters
    stay zero."""
    full = out.new_zeros((*out.shape[:-1], cout))
    full[..., fidx] = out
    return full


def _gather_in(x: torch.Tensor, ba: Dict[str, Any]) -> torch.Tensor:
    if ba["kept_in"] is not None:
        return x.index_select(-1, ba["kept_in"])
    return x


# ---------------------------------------------------------------------------
# backends
# ---------------------------------------------------------------------------

class Backend(Protocol):
    """Per-block op provider.  ``ba`` are the block's plan arrays, ``bs``
    its static metadata; activations are (N, T, V, C)."""

    name: str

    def spatial(self, x: torch.Tensor, ba: Dict[str, Any],
                bs: BlockStatic) -> torch.Tensor:
        """Graph spatial conv Σ_k (G_k·x)·W_k: (N,T,V,Cin) -> (N,T,V,Cout)."""
        ...

    def temporal(self, x: torch.Tensor, ba: Dict[str, Any],
                 bs: BlockStatic) -> torch.Tensor:
        """Clip-mode temporal conv over T: (N,T,V,C) -> (N,T_out,V,Cout)."""
        ...

    def transfer(self, h: torch.Tensor, ps: PlanStatic) -> torch.Tensor:
        """Inter-block activation transfer (identity / RFC round trip)."""
        ...


class ReferenceBackend:
    """Plain torch einsum and conv, executed from the plan."""

    name = "reference"

    def spatial(self, x, ba, bs):
        """Kept-channel gather + the Σ_k (G_k·x)·W_k einsum."""
        return torch.einsum("ntvc,kwv,kco->ntwo", _gather_in(x, ba), ba["G"],
                            ba["Wk"])

    def temporal(self, x, ba, bs):
        """Dense masked temporal conv, 'same' padding, stride on T; pruned
        filters are scattered back to full width for the residual path."""
        w = ba["tw"]                                   # (F_kept, C, K) masked
        out = F.conv2d(x.permute(0, 3, 1, 2), w.unsqueeze(-1),
                       stride=(bs.stride, 1), padding=(w.shape[-1] // 2, 0))
        out = out.permute(0, 2, 3, 1) + ba["tb"]       # (N, T_out, V, F)
        if bs.pruned_filters:
            out = _scatter_filters(out, ba["kept_filters"], bs.cout)
        return out

    def transfer(self, h, ps):
        """Identity — reference activations cross blocks uncompressed."""
        return h


class CudaBackend:
    """The hand-written kernels; RFC round trip is the inter-layer format.
    The counterpart of the JAX ``PallasBackend``."""

    name = "cuda"

    def spatial(self, x, ba, bs):
        """Fused graph + 1×1 kernel on the kept channels."""
        return ops.graph_sconv(_gather_in(x, ba), ba["G"], ba["Wk"])

    def temporal(self, x, ba, bs):
        """Packed cavity tconv kernel over the (N·V, T, C) rows — only the
        kept taps are computed (the paper's C2 FLOP skip)."""
        N, T, V, C = x.shape
        xb = x.permute(0, 2, 1, 3).reshape(N * V, T, C)
        out = ops.cavity_tconv(
            xb, ba["wp"], ba["taps"], ba["inv_perm"],
            num_filters=bs.n_kept_filters, kernel_size=bs.tkernel,
            stride=bs.stride)                          # (N*V, T_out, F_kept)
        out = out.reshape(N, V, out.shape[1], -1).permute(0, 2, 1, 3)
        out = out + ba["tb"]
        if bs.pruned_filters:
            out = _scatter_filters(out, ba["kept_filters"], bs.cout)
        return out

    def transfer(self, h, ps):
        """RFC encode/decode round trip (lossless on post-ReLU values)."""
        if not ps.use_rfc:
            return h
        vals, hot = ops.rfc_encode(h, bank=ps.rfc_bank)
        return ops.rfc_decode(vals, hot, bank=ps.rfc_bank)


def get_backend(name: str) -> Backend:
    """Backend registry lookup: ``reference`` | ``cuda``."""
    if name == "reference":
        return ReferenceBackend()
    if name == "cuda":
        return CudaBackend()
    raise ValueError(f"unknown backend {name!r} (expected one of {BACKENDS})")


# ---------------------------------------------------------------------------
# plan compilation
# ---------------------------------------------------------------------------

def build_execution_plan(
    params: Dict[str, Any],
    cfg: ModelConfig,
    prune_plan: Optional[PrunePlan] = None,
    *,
    quant: bool = False,
    backend: str = "reference",
    use_rfc: Optional[bool] = None,
    sconv: str = "auto",
) -> ExecutionPlan:
    """Compile ``(params, PrunePlan, ModelConfig)`` into an ExecutionPlan
    for the ``ntu25`` skeleton, on the params' device.

    ``use_rfc`` defaults to on for the ``cuda`` backend, as the JAX Pallas
    backend's does.  ``sconv="auto"`` picks the dense spatial conv whenever
    the JAX engine would (with its default thresholds): it would pick CSR
    for a graph with at most half of ``A + B_k`` non-zero, and the CSR path
    is not ported yet, so such a plan raises, as ``sconv="csr"`` does."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    if sconv not in ("auto", "dense", "csr"):
        raise ValueError(f"unknown sconv mode {sconv!r}")
    if sconv == "csr":
        raise NotImplementedError(
            "sconv='csr' is not ported yet (ROADMAP.md Queue 1 item 8, "
            "Queue 2 kernel 6)")
    if cfg.use_ck:
        raise NotImplementedError(
            "use_ck (windowed C_k) is not ported yet (ROADMAP.md Queue 1 "
            "item 9, Queue 2 kernel 7)")
    topo = get_topology("ntu25", cfg.gcn_kv)
    V = topo.num_joints
    strides = cfg.gcn_strides
    device = params["fc_w"].device
    A = torch.as_tensor(topo.adjacency, dtype=torch.float32, device=device)

    blocks_a: List[Dict[str, Any]] = []
    blocks_s: List[BlockStatic] = []
    for b, blk in enumerate(params["blocks"]):
        pb = prune_plan.blocks[b] if prune_plan is not None else None
        cout = int(blk["tconv_w"].shape[0])
        if tuple(blk["Bk"].shape[-2:]) != (V, V):
            raise ValueError(
                f"block {b}: learned graph B_k is {tuple(blk['Bk'].shape)} "
                f"but topology {topo.name!r} has V={V} joints")
        G = A + blk["Bk"].to(torch.float32)
        if sconv == "auto":
            density = float((G != 0).float().mean())
            if density <= 0.5:
                raise NotImplementedError(
                    f"block {b}: graph density {density:.3f} <= 0.5 selects "
                    f"the CSR spatial conv, which is not ported yet "
                    f"(ROADMAP.md Queue 2 kernel 6); pass sconv='dense'")

        # --- spatial: kept-channel gather + quant --------------------------
        Wk = quantize_q88(blk["Wk"]) if quant else blk["Wk"]
        kept_in = None
        if pb is not None:
            kept_in = torch.as_tensor(pb.kept_in, dtype=torch.int64,
                                      device=device)
            Wk = Wk.index_select(1, kept_in)

        # --- temporal: filter gather + cavity mask + quant -----------------
        tw = quantize_q88(blk["tconv_w"]) if quant else blk["tconv_w"]
        tb = blk["tconv_b"]
        kept_filters = None
        tap_mask = np.ones((cout, cfg.gcn_tkernel), bool)
        if pb is not None:
            kept_filters = torch.as_tensor(pb.kept_filters, dtype=torch.int64,
                                           device=device)
            tw = tw.index_select(0, kept_filters)
            tb = tb.index_select(0, kept_filters)
            tap_mask = np.asarray(pb.tap_mask, bool)
            tw = tw * torch.as_tensor(tap_mask, dtype=tw.dtype,
                                      device=device)[:, None, :]
        n_kept = int(tw.shape[0])

        ba: Dict[str, Any] = {
            "G": G.contiguous(), "Wk": Wk.contiguous(), "kept_in": kept_in,
            "bn_s": blk["bn_s"], "bn_t": blk["bn_t"],
            "tw": tw, "tb": tb, "kept_filters": kept_filters,
            "down_w": blk.get("down_w"), "bn_down": blk.get("bn_down"),
            "short_w": blk.get("short_w"), "bn_short": blk.get("bn_short"),
            "wp": None, "taps": None, "inv_perm": None,
        }
        if backend == "cuda":
            # host-side cavity packing — dense blocks pack all K taps
            wp, taps, inv = ops.pack_cavity_weights(
                tw.detach().cpu().numpy(), tap_mask[:n_kept])
            ba["wp"] = torch.as_tensor(wp, device=device)
            ba["taps"] = torch.as_tensor(taps, device=device)
            ba["inv_perm"] = torch.as_tensor(inv, dtype=torch.int64,
                                             device=device)
            ba["tw"] = None          # the packed form replaces the dense one

        blocks_a.append(ba)
        blocks_s.append(BlockStatic(
            stride=int(strides[b]), cout=cout, n_kept_filters=n_kept,
            tkernel=int(cfg.gcn_tkernel),
            pruned_filters=kept_filters is not None))

    input_skip = (prune_plan.input_skip if prune_plan is not None
                  else cfg.input_skip)
    if use_rfc is None:
        use_rfc = backend == "cuda"
    static = PlanStatic(
        backend=backend, input_skip=int(input_skip), use_rfc=bool(use_rfc),
        rfc_bank=int(cfg.rfc_bank), blocks=tuple(blocks_s))
    arrays = {
        "data_bn": params["data_bn"],
        "blocks": blocks_a,
        "fc_w": params["fc_w"], "fc_b": params["fc_b"],
        "parents": torch.as_tensor(topo.parents, dtype=torch.int64,
                                   device=device),
    }
    return ExecutionPlan(arrays=arrays, static=static)


# ---------------------------------------------------------------------------
# execution (clip mode)
# ---------------------------------------------------------------------------

def _stem(arrays, x, input_skip: int, bn=_bn_live) -> torch.Tensor:
    """C5 input skip, then the stem BN over the joint-major (V·C)
    flattened channels."""
    x = x.to(arrays["data_bn"]["scale"].dtype)
    if input_skip > 1:
        x = x[:, ::input_skip]
    N, T, V, C = x.shape
    return bn("data_bn", x.reshape(N, T, V * C), arrays["data_bn"]
              ).reshape(N, T, V, C)


def _run_block(h, ba, bs, backend: Backend, bn=_bn_live, tag: str = ""):
    s = backend.spatial(h, ba, bs)
    s = bn(tag + "bn_s", s, ba["bn_s"])
    down = (_proj(h, ba["down_w"], ba["bn_down"], 1, bn, tag + "bn_down")
            if ba["down_w"] is not None else h)
    s = torch.relu(s + down)
    t = backend.temporal(s, ba, bs)
    t = bn(tag + "bn_t", t, ba["bn_t"])
    if ba["short_w"] is not None:
        res = _proj(h, ba["short_w"], ba["bn_short"], bs.stride, bn,
                    tag + "bn_short")
    else:
        res = h if bs.stride == 1 else h[:, ::bs.stride]
    return torch.relu(t + res)


def _blocks(plan: ExecutionPlan, x: torch.Tensor, bn):
    """Yield each block's post-ReLU output (before the inter-block
    transfer that feeds the next block)."""
    backend = get_backend(plan.static.backend)
    h = _stem(plan.arrays, x, plan.static.input_skip, bn)
    nblocks = len(plan.static.blocks)
    for b, (ba, bs) in enumerate(zip(plan.arrays["blocks"],
                                     plan.static.blocks)):
        h = _run_block(h, ba, bs, backend, bn, tag=f"b{b}/")
        yield h
        if b < nblocks - 1:
            h = backend.transfer(h, plan.static)


def block_outputs(plan: ExecutionPlan, x: torch.Tensor) -> List[torch.Tensor]:
    """Per-block post-ReLU activations (drives the sparsity probe)."""
    return list(_blocks(plan, x, _bn_live))


def _forward(plan: ExecutionPlan, x: torch.Tensor, bn) -> torch.Tensor:
    for h in _blocks(plan, x, bn):
        pass
    pooled = h.mean(dim=(1, 2))                        # (N, C_last)
    return pooled @ plan.arrays["fc_w"] + plan.arrays["fc_b"]


def execute(plan: ExecutionPlan, x: torch.Tensor) -> torch.Tensor:
    """Run the compiled plan on a clip batch (N, T, V, C) -> logits."""
    return _forward(plan, x, _bn_live)


def collect_bn_stats(plan: ExecutionPlan, x: torch.Tensor
                     ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Run one clip batch through the plan's own backend, recording every
    batch-norm site's (mean, inv): the frozen statistics streaming needs."""
    rec = _BNRecorder()
    _forward(plan, x, rec)
    return rec.stats
