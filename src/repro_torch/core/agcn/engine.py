"""Backend-dispatched AGCN execution engine (plan-compile-then-execute):
clip mode, per-frame streaming and the multi-session slab tick.  Port of
``repro.core.agcn.engine``.

An ``ExecutionPlan`` is compiled once from ``(params, PrunePlan,
ModelConfig)``: kept-channel gathers, the graphs ``A + B_k``, the temporal
filter gather with its cavity tap mask, packed cavity weights and Q8.8
weights.  The hot loop only executes it.  Two backends implement the
per-block ops:

  reference — plain torch einsum and conv (the JAX reference backend's
              counterpart).
  cuda      — the hand-written kernels in ``repro_torch.kernels.ops``:
              ``graph_sconv`` (graph product + 1×1 conv fused) and its
              sparse form ``graph_sconv_csr`` (ELL graph), packed
              ``cavity_tconv`` (kept taps only) and its streaming form
              ``cavity_tconv_step``, the RFC encode/decode round trip
              between blocks, and ``windowed_similarity`` (the streaming
              C_k graph).  On CPU tensors the kernels' plain versions run
              instead (the tests' path).

A plan is compiled for a skeleton topology (``ntu25`` by default, any
registry name or a ``GraphTopology``), optionally padded to a wider slab
width so skeletons share one session slab; each block picks the dense or
the CSR spatial conv (``sconv``), and ``cfg.use_ck`` adds the windowed
data-dependent graph C_k (``repro_torch.core.agcn.adaptive``).

Every plan runs clip mode (``execute``) and streaming (``step_frame``
against a ``StreamState`` of per-slot temporal rings; ``step_frames`` and
``fused_tick`` are the session slab's scheduler tick).  See the streaming
section below.  The JAX engine's slot-axis sharding hint (``constrain``
on the slab's slot axis) has no counterpart and needs none: the hint asks
GSPMD to keep one slab split over a slot mesh, while the port's sharded
slab (``GcnService(mesh=...)``, ``repro_torch.distributed.serving``) keeps
one slab per shard and runs each shard's step on that shard's own device,
so no tensor here ever spans shards.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Protocol, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.common.config import ModelConfig
from repro_torch.common.tree import tree_map
from repro_torch.core.agcn import adaptive
from repro_torch.core.agcn.graph import (GraphTopology, dense_to_csr,
                                         get_topology)
from repro_torch.core.pruning.plan import PrunePlan
from repro_torch.core.quant import quantize_q88
from repro_torch.distributed import sharding
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rfc_pack import BANK as RFC_BANK

BACKENDS = ("reference", "cuda")


# ---------------------------------------------------------------------------
# plan containers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BlockStatic:
    """Per-block shapes and flags."""

    stride: int
    cin: int                 # full block-input width (before kept_in)
    cout: int
    n_kept_filters: int
    tkernel: int
    pruned_filters: bool     # kept_filters scatter present
    use_ck: bool = False     # windowed C_k graph (theta/phi present)
    sconv: str = "dense"     # spatial-conv path: "dense" | "csr"


@dataclasses.dataclass(frozen=True)
class PlanStatic:
    """Whole-plan metadata: backend, C5 input skip, the RFC inter-layer
    format flags, the streaming shape constants, the per-block
    ``BlockStatic`` tuple and the skeleton (``joints`` is the slab width,
    ``valid_joints`` the skeleton's own joint count)."""

    backend: str
    input_skip: int
    use_rfc: bool            # RFC round trip between blocks (banks of
                             # kernels.rfc_pack.BANK channels)
    tkernel: int
    joints: int
    in_channels: int
    stream_pool: int         # streaming logit pool: 0 = cumulative (clip
                             # parity), W > 0 = sliding window of W frames
    blocks: Tuple[BlockStatic, ...]
    topology: str = "ntu25"  # skeleton this plan was compiled for
    valid_joints: int = 0    # the skeleton's own V (< joints when padded to
                             # a slab; 0 reads as == joints)


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
    Population variance, as ``jnp.var``.  Under a data-parallel mesh each
    rank holds an equal share of the rows, and both moments are taken over
    every rank's rows (``sharding.batch_mean``), as GSPMD keeps JAX's
    global."""
    dims = tuple(range(x.dim() - 1))
    if sharding.batch_ranks() > 1:
        mean = sharding.batch_mean(x.mean(dims, keepdim=True))
        var = sharding.batch_mean((x - mean).square().mean(dims,
                                                           keepdim=True))
        return mean, torch.rsqrt(var + eps)
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


class _BNFrozen:
    """BN tap applying recorded statistics (the streaming hot path).  Flat
    (C,) stats broadcast over any leading layout, so the same stats serve
    clip (N,T,V,C) and frame (N,V,C) shapes."""

    def __init__(self, stats: Dict[str, Dict[str, torch.Tensor]]):
        self.stats = stats

    def __call__(self, site, x, p):
        s = self.stats[site]
        return _bn_norm(x, p, s["mean"], s["inv"])


def _proj(x, w, bnp, stride, bn=_bn_live, site=""):
    if stride != 1:
        x = x[:, ::stride]
    return bn(site, torch.einsum("ntvc,co->ntvo", x, w), bnp)


def _scatter_filters(out: torch.Tensor, fidx: torch.Tensor, cout: int):
    """Scatter compacted filter outputs back to full width; pruned filters
    stay zero."""
    full = out.new_zeros((*out.shape[:-1], cout))
    return full.index_copy_(out.dim() - 1, fidx, out)


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

    def spatial(self, x: torch.Tensor, ba: Dict[str, Any], bs: BlockStatic,
                ck: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Graph spatial conv Σ_k (G_k·x)·W_k: (N,T,V,Cin) -> (N,T,V,Cout).
        ``ck`` optionally adds a precomputed per-frame (N,T,V,V) graph to
        every subset's G_k (the windowed C_k)."""
        ...

    def temporal(self, x: torch.Tensor, ba: Dict[str, Any],
                 bs: BlockStatic) -> torch.Tensor:
        """Clip-mode temporal conv over T: (N,T,V,C) -> (N,T_out,V,Cout)."""
        ...

    def temporal_step(self, ring: torch.Tensor, head: torch.Tensor,
                      ba: Dict[str, Any], bs: BlockStatic) -> torch.Tensor:
        """One output frame per slot from its K-frame ring (N,K,V,C), whose
        oldest frame is at ``head`` (N,): -> (N,V,Cout)."""
        ...

    def epilogue(self, t: torch.Tensor, res: torch.Tensor,
                 encode: bool) -> torch.Tensor:
        """A block's last step, ``relu(t + res)``; ``encode`` marks a block
        whose output crosses to the next one in the RFC format, where a
        backend that has the format round-trips it."""
        ...


def _spatial_einsum(x: torch.Tensor, ba: Dict[str, Any],
                    ck: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Σ_k (G_k·x)·W_k as einsums, with the optional per-frame (N,T,V,V)
    windowed C_k added to every subset's ``A_k + B_k``.  A graph wider
    than x (a slab-padded plan run on a clip at the skeleton's own V) is
    sliced: it is zero outside its valid joints."""
    G = ba["G"].to(x.dtype)
    V = x.shape[2]
    if G.shape[-1] != V:
        G = G[:, :V, :V]
    Wk = ba["Wk"].to(x.dtype)
    if ck is not None:
        Gn = G[None, None] + ck.to(x.dtype)[:, :, None]   # (N,T,K,V,V)
        y = torch.einsum("ntvc,ntkwv->ntkwc", x, Gn)
        return torch.einsum("ntkwc,kco->ntwo", y, Wk)
    return torch.einsum("ntvc,kwv,kco->ntwo", x, G, Wk)


def _spatial_csr_ref(x: torch.Tensor, ba: Dict[str, Any]) -> torch.Tensor:
    """CSR gather-accumulate over the plan's indptr/indices.  The CSR is
    built at the skeleton's own V; wider (slab-padded) frames get zero
    output rows past it, since the graph references no padded joint."""
    N, T, V, C = x.shape
    out = ref.graph_sconv_csr_ref(
        x.reshape(N * T, V, C), ba["csr_indptr"], ba["csr_indices"],
        ba["csr_values"].to(x.dtype), ba["Wk"].to(x.dtype))
    if out.shape[1] < V:
        out = F.pad(out, (0, 0, 0, V - out.shape[1]))
    return out.reshape(N, T, V, -1)


class ReferenceBackend:
    """Plain torch einsum and conv, executed from the plan."""

    name = "reference"

    def spatial(self, x, ba, bs, ck=None):
        """Kept-channel gather + the Σ_k (G_k·x)·W_k einsum (with the
        windowed C_k when given), or the CSR gather-accumulate when the
        plan chose ``sconv="csr"``."""
        xg = _gather_in(x, ba)
        if bs.sconv == "csr":            # never set on a C_k block
            return _spatial_csr_ref(xg, ba)
        return _spatial_einsum(xg, ba, ck)

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

    def temporal_step(self, ring, head, ba, bs):
        """One output frame from each slot's window, gathered oldest first
        from its ring (N, K, V, C): the streaming form of ``temporal`` (the
        engine gates emission by the stride; the window always yields one
        output)."""
        K = ring.shape[1]
        chrono = (head.long()[:, None]
                  + torch.arange(K, device=ring.device)[None, :]) % K
        win = _gather_k(ring, chrono)
        out = torch.einsum("nkvc,fck->nvf", win, ba["tw"]) + ba["tb"]
        if bs.pruned_filters:
            out = _scatter_filters(out, ba["kept_filters"], bs.cout)
        return out

    def epilogue(self, t, res, encode):
        """``relu(t + res)``: reference activations cross blocks
        uncompressed."""
        return torch.relu(t + res)


class CudaBackend:
    """The hand-written kernels; RFC round trip is the inter-layer format.
    The counterpart of the JAX ``PallasBackend``."""

    name = "cuda"

    def spatial(self, x, ba, bs, ck=None):
        """Fused graph + 1×1 kernel on the kept channels, or its ELL form
        when the plan chose ``sconv="csr"``.  C_k blocks add the
        precomputed ``ck`` through the einsum, as the JAX Pallas backend
        does (its product runs outside any TPU kernel there too)."""
        xg = _gather_in(x, ba)
        if bs.use_ck:
            return _spatial_einsum(xg, ba, ck)
        if bs.sconv == "csr":
            return ops.graph_sconv_csr(xg, ba["ell_idx"], ba["ell_val"],
                                       ba["Wk"])
        return ops.graph_sconv(xg, ba["G"], ba["Wk"])

    def temporal(self, x, ba, bs):
        """Packed cavity tconv kernel on (N, T, V, C) as it lies — only the
        kept taps are computed (the paper's C2 FLOP skip); the kernel
        writes (N, T_out, V, F_kept) in natural filter order."""
        out = ops.cavity_tconv(
            x, ba["wp"], ba["taps"], ba["inv_perm"],
            num_filters=bs.n_kept_filters, kernel_size=bs.tkernel,
            stride=bs.stride)
        out = out + ba["tb"]
        if bs.pruned_filters:
            out = _scatter_filters(out, ba["kept_filters"], bs.cout)
        return out

    def temporal_step(self, ring, head, ba, bs):
        """Single-step packed cavity tconv kernel on the ring (N, K, V, C)
        as it lies, each slot read at its ``head``: one launch that also
        adds the bias and stores the kept filters at their columns (the
        pruned ones 0), with the clip form's packed weights and taps."""
        return ops.cavity_tconv_step_ring(ring, head, ba["wp"], ba["taps"],
                                          ba["slot_col"], ba["tb_col"])

    def epilogue(self, t, res, encode):
        """``relu(t + res)``, or with ``encode`` the RFC round trip of it:
        the add and the ReLU run inside the encode kernel; the decode is
        bit-equal to ``relu(t + res)``."""
        if not encode:
            return torch.relu(t + res)
        return ops.rfc_decode(*ops.rfc_encode(t, res))


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

def _graph_density(g: torch.Tensor, eps: float) -> float:
    """Fraction of entries with ``|g| > eps``."""
    return float((g.abs() > eps).to(torch.float32).mean())


def build_execution_plan(
    params: Dict[str, Any],
    cfg: ModelConfig,
    prune_plan: Optional[PrunePlan] = None,
    *,
    quant: bool = False,
    backend: str = "reference",
    use_rfc: Optional[bool] = None,
    topology: Optional[Any] = None,
    pad_joints: Optional[int] = None,
    sconv: str = "auto",
    csr_eps: float = 0.0,
    csr_density: float = 0.5,
) -> ExecutionPlan:
    """Compile ``(params, PrunePlan, ModelConfig)`` into an ExecutionPlan
    on the params' device.

    ``use_rfc`` defaults to on for the ``cuda`` backend, as the JAX Pallas
    backend's does.  ``topology`` is a registry name or a
    :class:`~repro_torch.core.agcn.graph.GraphTopology` (default
    ``ntu25``); ``pad_joints`` pads every joint-indexed array to a wider
    slab width Vmax (zero graph rows and columns, stem BN scale 1 and bias
    0, padded joints parent themselves), so plans of different skeletons
    share one slab.  ``sconv`` picks each block's spatial conv: ``dense``,
    ``csr`` (a gather-accumulate over the entries of ``A + B_k`` with
    ``|G| > csr_eps``), or ``auto``: CSR when at most ``csr_density`` of
    the entries are above ``csr_eps``.  With ``csr_eps = 0`` the learned
    B_k (1e-6 at init) keeps every graph at density 1, so ``auto`` stays
    dense.  Blocks with the windowed C_k (``cfg.use_ck``) stay dense."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} (expected one of "
                         f"{BACKENDS})")
    if sconv not in ("auto", "dense", "csr"):
        raise ValueError(f"unknown sconv mode {sconv!r}")
    if isinstance(topology, GraphTopology):
        topo = topology
    else:
        topo = get_topology(topology or "ntu25", cfg.gcn_kv)
    vj = topo.num_joints                          # the skeleton's own V
    V = int(pad_joints) if pad_joints is not None else vj
    if V < vj:
        raise ValueError(f"pad_joints={V} is narrower than topology "
                         f"{topo.name!r} (V={vj})")
    strides = cfg.gcn_strides
    device = params["fc_w"].device
    A = torch.as_tensor(topo.adjacency, dtype=torch.float32, device=device)

    blocks_a: List[Dict[str, Any]] = []
    blocks_s: List[BlockStatic] = []
    for b, blk in enumerate(params["blocks"]):
        pb = prune_plan.blocks[b] if prune_plan is not None else None
        cout = int(blk["tconv_w"].shape[0])
        use_ck = bool(cfg.use_ck and "theta" in blk)
        if tuple(blk["Bk"].shape[-2:]) != (vj, vj):
            raise ValueError(
                f"block {b}: learned graph B_k is {tuple(blk['Bk'].shape)} "
                f"but topology {topo.name!r} has V={vj} joints: the params "
                f"were built for a different topology")
        Gv = A + blk["Bk"].to(torch.float32)
        G = Gv
        if V != vj:     # pad to the slab width; padded joints stay isolated
            G = Gv.new_zeros((Gv.shape[0], V, V))
            G[:, :vj, :vj] = Gv

        # --- spatial: kept-channel gather + quant --------------------------
        Wk = quantize_q88(blk["Wk"]) if quant else blk["Wk"]
        theta, phi = blk.get("theta"), blk.get("phi")
        kept_in = None
        if pb is not None:
            kept_in = torch.as_tensor(pb.kept_in, dtype=torch.int64,
                                      device=device)
            Wk = Wk.index_select(1, kept_in)
            if use_ck:
                theta = theta.index_select(0, kept_in)
                phi = phi.index_select(0, kept_in)

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

        # --- spatial path: dense or CSR ------------------------------------
        block_sconv = "dense"
        if not use_ck and (sconv == "csr" or (
                sconv == "auto" and _graph_density(Gv, csr_eps)
                <= csr_density)):
            block_sconv = "csr"

        ba: Dict[str, Any] = {
            "G": G.contiguous(), "Wk": Wk.contiguous(), "kept_in": kept_in,
            "theta": theta if use_ck else None,
            "phi": phi if use_ck else None,
            "bn_s": blk["bn_s"], "bn_t": blk["bn_t"],
            "tw": tw, "tb": tb, "kept_filters": kept_filters,
            "down_w": blk.get("down_w"), "bn_down": blk.get("bn_down"),
            "short_w": blk.get("short_w"), "bn_short": blk.get("bn_short"),
            "wp": None, "taps": None, "inv_perm": None,
            "slot_col": None, "tb_col": None,
            "csr_indptr": None, "csr_indices": None, "csr_values": None,
            "ell_idx": None, "ell_val": None,
        }
        if block_sconv == "csr":
            # entries with |G| <= csr_eps (B_k's noise floor when eps > 0)
            # are dropped: that is the CSR path's budget against the dense
            indptr, indices, values = dense_to_csr(
                Gv.detach().cpu().numpy(), csr_eps)
            if backend == "cuda":
                # the kernel takes unpadded joints: rows at the plan's width
                ei, ev = ops.pack_csr_ell(indptr, indices, values, V)
                ba["ell_idx"] = torch.as_tensor(ei, device=device)
                ba["ell_val"] = torch.as_tensor(ev, device=device)
            else:
                ba["csr_indptr"] = torch.as_tensor(indptr, device=device)
                ba["csr_indices"] = torch.as_tensor(indices, device=device)
                ba["csr_values"] = torch.as_tensor(values, device=device)
            ba["G"] = None          # the CSR paths never read the dense form
        if backend == "cuda":
            # host-side cavity packing — dense blocks pack all K taps
            wp, taps, inv = ops.pack_cavity_weights(
                tw.detach().cpu().numpy(), tap_mask[:n_kept])
            ba["wp"] = torch.as_tensor(wp, device=device)
            ba["taps"] = torch.as_tensor(taps, device=device)
            ba["inv_perm"] = torch.as_tensor(inv, dtype=torch.int64,
                                             device=device)
            # the streaming kernel's store: packed slot -> output column,
            # and the bias per column (0 on pruned filters)
            ba["slot_col"] = torch.as_tensor(ops.slot_columns(
                inv, n_kept, None if kept_filters is None
                else pb.kept_filters), device=device)
            ba["tb_col"] = (tb if kept_filters is None else tb.new_zeros(
                cout).index_copy_(0, kept_filters, tb))
            ba["tw"] = None          # the packed form replaces the dense one

        blocks_a.append(ba)
        blocks_s.append(BlockStatic(
            stride=int(strides[b]), cin=int(blk["Wk"].shape[1]), cout=cout,
            n_kept_filters=n_kept,
            tkernel=int(cfg.gcn_tkernel),
            pruned_filters=kept_filters is not None,
            use_ck=use_ck, sconv=block_sconv))

    input_skip = (prune_plan.input_skip if prune_plan is not None
                  else cfg.input_skip)
    if use_rfc is None:
        use_rfc = backend == "cuda"
    if use_rfc and cfg.rfc_bank != RFC_BANK:
        raise ValueError(f"the RFC format packs banks of {RFC_BANK} "
                         f"channels, not rfc_bank={cfg.rfc_bank}")
    static = PlanStatic(
        backend=backend, input_skip=int(input_skip), use_rfc=bool(use_rfc),
        tkernel=int(cfg.gcn_tkernel), joints=V,
        in_channels=int(cfg.gcn_in_channels),
        stream_pool=int(cfg.gcn_stream_pool), blocks=tuple(blocks_s),
        topology=topo.name, valid_joints=vj)
    data_bn = params["data_bn"]
    if V != vj:
        # the joint-major (V·C) stem BN: scale 1, bias 0 on padded joints
        pad = (V - vj) * int(cfg.gcn_in_channels)
        data_bn = {
            "scale": torch.cat([data_bn["scale"],
                                data_bn["scale"].new_ones(pad)]),
            "bias": torch.cat([data_bn["bias"],
                               data_bn["bias"].new_zeros(pad)]),
        }
    parents = np.arange(V, dtype=np.int32)      # padded joints self-parent
    parents[:vj] = topo.parents
    arrays = {
        "data_bn": data_bn,
        "blocks": blocks_a,
        "fc_w": params["fc_w"], "fc_b": params["fc_b"],
        "parents": torch.as_tensor(parents, dtype=torch.int64, device=device),
    }
    return ExecutionPlan(arrays=arrays, static=static)


# ---------------------------------------------------------------------------
# execution (clip mode)
# ---------------------------------------------------------------------------

def _slice_data_bn(p: Dict[str, torch.Tensor], width: int):
    """The joint-major (V·C) stem BN params cut to a narrower clip: a
    slab-padded plan calibrates at the skeleton's own V, and the padding
    tail (scale 1, bias 0) carries nothing."""
    if p["scale"].shape[0] == width:
        return p
    return {k: v[:width] for k, v in p.items()}


def _stem(arrays, x, input_skip: int, bn=_bn_live) -> torch.Tensor:
    """C5 input skip, then the stem BN over the joint-major (V·C)
    flattened channels."""
    x = x.to(arrays["data_bn"]["scale"].dtype)
    if input_skip > 1:
        x = x[:, ::input_skip]
    N, T, V, C = x.shape
    p = _slice_data_bn(arrays["data_bn"], V * C)
    return bn("data_bn", x.reshape(N, T, V * C), p).reshape(N, T, V, C)


def _run_block(h, ba, bs, backend: Backend, bn=_bn_live, tag: str = "",
               vj: int = 0, encode: bool = False):
    ck = None
    if bs.use_ck:
        # the windowed C_k at every frame index: the trailing-K recurrence
        # the streaming embedding rings evaluate
        ck = adaptive.clip_windowed_ck(
            _gather_in(h, ba), ba["theta"], ba["phi"], bs.tkernel,
            valid_joints=vj if 0 < vj < h.shape[2] else 0)
    s = backend.spatial(h, ba, bs, ck=ck)
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
    return backend.epilogue(t, res, encode)


def _blocks(plan: ExecutionPlan, x: torch.Tensor, bn,
            backend: Optional[Backend] = None):
    """Yield each block's post-ReLU output, the activation the next block
    reads (on a ``use_rfc`` plan its RFC round trip, bit-equal to it).
    ``backend`` defaults to the plan's own."""
    ps = plan.static
    backend = backend or get_backend(ps.backend)
    h = _stem(plan.arrays, x, ps.input_skip, bn)
    nblocks = len(ps.blocks)
    for b, (ba, bs) in enumerate(zip(plan.arrays["blocks"], ps.blocks)):
        h = _run_block(h, ba, bs, backend, bn, tag=f"b{b}/",
                       vj=ps.valid_joints,
                       encode=ps.use_rfc and b < nblocks - 1)
        yield h


def block_outputs(plan: ExecutionPlan, x: torch.Tensor) -> List[torch.Tensor]:
    """Per-block post-ReLU activations (drives the sparsity probe)."""
    return list(_blocks(plan, x, _bn_live))


class _RecordingCuda(CudaBackend):
    """The ``cuda`` backend, keeping the (values, bits) each encoding
    epilogue writes."""

    def __init__(self):
        self.leaves: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def epilogue(self, t, res, encode):
        if not encode:
            return torch.relu(t + res)
        vals, bits = ops.rfc_encode(t, res)
        self.leaves.append((vals, bits))
        return ops.rfc_decode(vals, bits)


def rfc_boundaries(plan: ExecutionPlan, x: torch.Tensor
                   ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The RFC leaves (values, bits) a ``cuda`` plan with ``use_rfc``
    writes between blocks on clip batch ``x``: one pair per block but the
    last, exactly as ``execute`` writes them (same kernels, same
    launches), for counting C3's storage on the card's own bits."""
    if plan.static.backend != "cuda" or not plan.static.use_rfc:
        raise ValueError("rfc_boundaries needs a cuda plan with use_rfc")
    rec = _RecordingCuda()
    for _ in _blocks(plan, x, _bn_live, rec):
        pass
    return rec.leaves


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


# ---------------------------------------------------------------------------
# execution (streaming mode): per-frame continual inference
# ---------------------------------------------------------------------------
#
# The same compiled plan runs frame by frame against per-block temporal
# rings: each block holds the last K (= tkernel) spatial outputs (its tconv
# input) and the last K block inputs (the residual source), and emits one
# output whenever the frame that just arrived completes a clip-mode window:
# every ``stride``-th input, ``pad = K//2`` frames behind real time.
# Invalid frames (input-skip gaps, the post-clip flush) write zeros into
# the tconv ring, which is the clip conv's zero padding, so after the drain
# streaming logits equal clip logits.  The RFC round trip is applied to
# every inter-block frame (``cuda``) and the encoded activations of the
# last emitted frame are kept in the state.
#
# Every clock is per slot (the leading axis of every state leaf), so a
# StreamState is both a lockstep batch and a session slab of independent
# sessions admitted at different times.  All per-slot control is masking
# with static shapes (``torch.where`` over one-hot ring positions, gathers
# with computed indices): a tick syncs nothing with the host, and free or
# held slots cost the same work as busy ones.

@dataclasses.dataclass
class StreamState:
    """State of S concurrent stream slots (the session slab).

    ``blocks[b]``: ring_s (S, K, V, cout) tconv-input ring, ring_h
    (S, K, V, cin) residual-source ring, valid (S, K) clip-validity bits,
    t (S,) int32 inputs seen at this block's time scale; ``use_ck`` blocks
    also carry ck_th / ck_ph (S, K, V, Ce), the windowed C_k embedding
    rings (per-slot leaves like the others, so resets, snapshots and the
    snapshot ring carry them).  ``t_raw`` (S,)
    counts raw frames per slot; ``pool_*`` hold the running logit pool;
    ``bn_stats`` the frozen calibration (shared by all slots); ``rfc`` the
    per-slot RFC-encoded inter-block activations of the last emitted frame
    (``cuda`` plans): vals (S, V, cout) float32 and bits
    (S, V, ceil(cout/16)) int16, the format of ``kernels.rfc_pack``."""

    t_raw: torch.Tensor
    blocks: List[Dict[str, torch.Tensor]]
    pool_ring: Optional[torch.Tensor]
    pool_sum: torch.Tensor
    pool_t: torch.Tensor
    bn_stats: Dict[str, Dict[str, torch.Tensor]]
    rfc: Optional[List[Dict[str, torch.Tensor]]]


def _slot_tree(state: StreamState) -> Dict[str, Any]:
    """Every per-slot leaf of ``state`` (all but the shared bn_stats), in
    the layout of a :func:`snapshot_slots` capture."""
    return {"t_raw": state.t_raw, "blocks": state.blocks,
            "pool_ring": state.pool_ring, "pool_sum": state.pool_sum,
            "pool_t": state.pool_t, "rfc": state.rfc}


def _with_slot_tree(state: StreamState, tree: Dict[str, Any]) -> StreamState:
    return StreamState(bn_stats=state.bn_stats, **tree)


def _slot_mask(m, S: int, device: torch.device) -> torch.Tensor:
    """A scalar or (S,) mask as an (S,) bool tensor on ``device``.  A
    Python bool becomes a fill on the device (no host copy)."""
    if isinstance(m, (bool, np.bool_)):
        return torch.full((S,), bool(m), dtype=torch.bool, device=device)
    m = torch.as_tensor(m, device=device).to(torch.bool)
    return m.expand(S)


def _bcast(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (leaf.dim() - mask.dim()))


def _pad_data_bn_stats(bn_stats: Dict[str, Dict[str, torch.Tensor]],
                       ps: PlanStatic) -> Dict[str, Dict[str, torch.Tensor]]:
    """Pad the stem BN statistics of a topology-V calibration to the slab
    width (mean 0, inv 1: identity on the masked padded joints).  The
    other sites are per-channel and do not depend on the joint count."""
    want = ps.joints * ps.in_channels
    db = bn_stats.get("data_bn")
    if db is None or db["mean"].shape[0] == want:
        return bn_stats
    pad = want - db["mean"].shape[0]
    out = dict(bn_stats)
    out["data_bn"] = {
        "mean": torch.cat([db["mean"], db["mean"].new_zeros(pad)]),
        "inv": torch.cat([db["inv"], db["inv"].new_ones(pad)]),
    }
    return out


def init_stream_state(
    plan: ExecutionPlan,
    batch: int,
    *,
    x_calib: Optional[torch.Tensor] = None,
    bn_stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    dtype: torch.dtype = torch.float32,
) -> StreamState:
    """Fresh zeroed StreamState for ``batch`` stream slots, on the plan's
    device.

    Streaming needs frozen batch-norm statistics: pass ``x_calib`` (a
    representative clip batch; one clip-mode pass of the plan's own
    backend records them) or ``bn_stats`` from :func:`collect_bn_stats`.
    They are shared by every slot."""
    ps = plan.static
    if bn_stats is None:
        if x_calib is None:
            raise ValueError(
                "streaming needs frozen BN statistics: pass x_calib (a "
                "representative clip batch) or bn_stats from "
                "collect_bn_stats()")
        bn_stats = collect_bn_stats(plan, x_calib)
    bn_stats = _pad_data_bn_stats(bn_stats, ps)
    dev = plan.arrays["fc_w"].device
    K, V = ps.tkernel, ps.joints

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    blocks = []
    for ba, bs in zip(plan.arrays["blocks"], ps.blocks):
        d = {"ring_s": zeros(batch, K, V, bs.cout),
             "ring_h": zeros(batch, K, V, bs.cin),
             "valid": zeros(batch, K, dt=torch.bool),
             "t": zeros(batch, dt=torch.int32)}
        if bs.use_ck:
            # zero rows stand in for the frames before the stream starts,
            # so a fresh slot's first windows match clip mode's leading edge
            ce = int(ba["theta"].shape[-1])
            d["ck_th"] = zeros(batch, K, V, ce)
            d["ck_ph"] = zeros(batch, K, V, ce)
        blocks.append(d)
    rfc = None
    if ps.use_rfc:
        rfc = [{"vals": zeros(batch, V, bs.cout),
                "bits": zeros(batch, V, -(-bs.cout // RFC_BANK),
                              dt=torch.int16)} for bs in ps.blocks[:-1]]
    c_last = ps.blocks[-1].cout
    return StreamState(
        t_raw=zeros(batch, dt=torch.int32), blocks=blocks,
        pool_ring=(zeros(batch, ps.stream_pool, c_last)
                   if ps.stream_pool > 0 else None),
        pool_sum=zeros(batch, c_last), pool_t=zeros(batch, dt=torch.int32),
        bn_stats=bn_stats, rfc=rfc)


def init_session_slab(plan: ExecutionPlan, slots: int, *,
                      x_calib: Optional[torch.Tensor] = None,
                      bn_stats: Optional[Dict[str, Dict[str, torch.Tensor]]]
                      = None,
                      dtype: torch.dtype = torch.float32) -> StreamState:
    """A session slab of ``slots`` independent stream slots: the same as
    :func:`init_stream_state`, named for what serving code means by it."""
    return init_stream_state(plan, slots, x_calib=x_calib,
                             bn_stats=bn_stats, dtype=dtype)


def _select_slots(keep_old, old: StreamState, new: StreamState
                  ) -> StreamState:
    """Per-slot select: slots where ``keep_old`` is True keep ``old``'s
    leaves, the others take ``new``'s (``step_frames``'s hold)."""
    keep = _slot_mask(keep_old, new.t_raw.shape[0], new.t_raw.device)
    return _with_slot_tree(new, tree_map(
        lambda n, o: torch.where(_bcast(keep, n), o, n),
        _slot_tree(new), _slot_tree(old)))


def reset_slots(state: StreamState, free) -> StreamState:
    """Zero every per-slot leaf of the slots where the (S,) mask ``free``
    is True (an admission).  The shared BN statistics stay."""
    free = _slot_mask(free, state.t_raw.shape[0], state.t_raw.device)
    return _with_slot_tree(state, tree_map(
        lambda v: torch.where(_bcast(free, v), torch.zeros_like(v), v),
        _slot_tree(state)))


def _index(idx, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(idx, device=device).to(torch.int64)


def snapshot_slots(state: StreamState, idx) -> Dict[str, Any]:
    """Gather slot ``idx`` (a scalar, or a (k,) vector of slots) out of the
    slab: every per-slot leaf, without the shared ``bn_stats``, which
    travel with the plan.  The preemption capture."""
    idx = _index(idx, state.t_raw.device)

    def g(leaf):
        rows = leaf.index_select(0, idx.reshape(-1))
        return rows.reshape(idx.shape + leaf.shape[1:])

    return tree_map(g, _slot_tree(state))


def restore_slots(state: StreamState, idx, snap: Dict[str, Any]
                  ) -> StreamState:
    """Write a :func:`snapshot_slots` capture back into slot(s) ``idx``;
    the other slots and the shared BN statistics are untouched, so the
    slot resumes where the snapshot left it."""
    idx = _index(idx, state.t_raw.device).reshape(-1)

    def s(leaf, sv):
        sv = torch.as_tensor(sv, dtype=leaf.dtype, device=leaf.device)
        return leaf.index_copy(0, idx, sv.reshape(idx.shape + leaf.shape[1:]))

    return _with_slot_tree(state, tree_map(s, _slot_tree(state), snap))


# Slot or ring index of a padded no-op event in the fixed-shape event
# buffers of fused_tick: far out of range of any slab or ring, so its
# gather is clamped (the value is discarded) and its write is dropped
SNAP_SENTINEL = np.int32(2 ** 30)


def _put_rows(buf: torch.Tensor, idx: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``rows[i]`` written to row ``idx[i]``; an index outside
    [0, len(buf)) writes nothing (JAX's ``mode="drop"``).  Such writes go
    to a spare row that is cut off, so shapes stay static."""
    n = buf.shape[0]
    idx = torch.where((idx >= 0) & (idx < n), idx, n)
    spare = torch.cat([buf, buf[:1]])
    return spare.index_copy_(0, idx, rows.to(buf.dtype))[:n]


def init_snapshot_ring(slab: StreamState, capacity: int) -> Dict[str, Any]:
    """A zeroed snapshot ring of ``capacity`` rows, each shaped like one
    slot's :func:`snapshot_slots` capture (independent of the slab's S)."""
    idx = torch.zeros(int(capacity), dtype=torch.int64,
                      device=slab.t_raw.device)
    return tree_map(torch.zeros_like, snapshot_slots(slab, idx))


def snapshot_to_ring(slab: StreamState, ring: Dict[str, Any],
                     order) -> Dict[str, Any]:
    """For each (slot, row) pair of the (E, 2) ``order``, copy the slab's
    slot into ring row ``row``.  Rows padded with :data:`SNAP_SENTINEL`
    are no-ops (their gather is clamped, their write dropped).  Returns
    the new ring; the slab is only read.  The ring may lie on another
    device than the slab (a sharded slab's ring on the mesh's first
    device): the gathered rows are copied across, device to device."""
    order = _index(order, slab.t_raw.device)
    S = slab.t_raw.shape[0]
    rows = snapshot_slots(slab, order[:, 0].clamp(0, S - 1))
    dev = ring["t_raw"].device
    dst = order[:, 1].to(dev)
    return tree_map(lambda r, x: _put_rows(r, dst, x.to(dev)), ring, rows)


def restore_from_ring(slab: StreamState, ring: Dict[str, Any],
                      order) -> StreamState:
    """For each (slot, row) pair of the (E, 2) ``order``, copy ring row
    ``row`` into slab slot ``slot``; sentinel rows touch no slot.  The
    inverse of :func:`snapshot_to_ring` (the ring may lie on another
    device than the slab, as there).  Returns the new slab."""
    order = _index(order, slab.t_raw.device)
    R = ring["t_raw"].shape[0]
    dev = slab.t_raw.device
    slot = order[:, 0]
    src = order[:, 1].clamp(0, R - 1).to(ring["t_raw"].device)
    return _with_slot_tree(slab, tree_map(
        lambda leaf, rl: _put_rows(leaf, slot, rl.index_select(0, src)
                                   .to(dev)),
        _slot_tree(slab), ring))


def stream_flush_frames(plan: ExecutionPlan, frames: int) -> int:
    """Raw flush steps (zero frames, valid=False) after a ``frames``-long
    clip that drain its last valid output through every block's
    ``pad``-frame latency; after them streaming logits equal clip
    logits."""
    ps = plan.static
    pad = ps.tkernel // 2
    t = -(-frames // ps.input_skip)            # frames surviving input skip
    for bs in ps.blocks:
        t = (t - 1) // bs.stride + 1           # clip-mode output length
    o = t - 1                                  # last valid final-block output
    for bs in reversed(ps.blocks):
        o = o * bs.stride + pad                # input index that triggers it
    return max(0, o * ps.input_skip + 1 - frames)


def stream_first_logit_delay(plan: ExecutionPlan) -> int:
    """Raw frames from a slot's admission until its first valid logit
    contribution reaches the pool: the recurrence of
    :func:`stream_flush_frames` for output 0."""
    ps = plan.static
    pad = ps.tkernel // 2
    o = 0
    for bs in reversed(ps.blocks):
        o = o * bs.stride + pad
    return o * ps.input_skip + 1


def _pooled_logits(arrays, ps: PlanStatic, pool_sum: torch.Tensor,
                   pool_t: torch.Tensor) -> torch.Tensor:
    """Running prediction: the pool's mean over the pooled frame count
    (clamped to the window when ``stream_pool`` > 0, and to at least 1),
    through the fc head."""
    n_eff = pool_t.clamp_max(ps.stream_pool) if ps.stream_pool > 0 else pool_t
    pooled = pool_sum / n_eff.clamp_min(1)[:, None].to(pool_sum.dtype)
    return pooled @ arrays["fc_w"] + arrays["fc_b"]


def _stem_frame(arrays, frame: torch.Tensor, bn) -> torch.Tensor:
    """Per-frame stem: data_bn on one (N, V, C) frame."""
    x = frame.to(arrays["data_bn"]["scale"].dtype)
    N, V, C = x.shape
    return bn("data_bn", x.reshape(N, V * C), arrays["data_bn"]
              ).reshape(N, V, C)


def _ring_write(ring: torch.Tensor, write: torch.Tensor,
                rows: torch.Tensor) -> torch.Tensor:
    """``ring`` (S, K, ...) with ``rows`` (S, ...) written at the (S, K)
    one-hot positions of ``write``; slots with no position keep theirs."""
    return torch.where(_bcast(write, ring), rows.unsqueeze(1), ring)


def _gather_k(ring: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``ring`` (S, K, ...) gathered at the (S, J) positions ``idx``."""
    shape = idx.shape + ring.shape[2:]
    return torch.gather(ring, 1, idx.reshape(idx.shape + (1,) * (
        ring.dim() - 2)).expand(shape))


def step_frame(
    plan: ExecutionPlan,
    state: StreamState,
    frame: torch.Tensor,             # (S, V, C) one raw frame per slot
    valid=True,                      # False -> flush step (post-clip drain)
    bn_stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
) -> Tuple[StreamState, torch.Tensor]:
    """Advance every slot by one raw frame; returns (new state, logits).

    ``valid`` is a scalar (a lockstep batch) or an (S,) mask (a session
    slab, each slot in its own clip or flush phase).  ``bn_stats``
    overrides the state's frozen calibration for this step (one dispatch
    per skeleton group over a shared slab, each with its own statistics).
    The input state is not modified.  Input-skip gaps, stride-decimated
    emission, the validity of flushed windows and the ring phases are all
    per-slot masking, so the step issues the same kernels whatever the
    slots do.

    A plan narrower than its slab (``valid_joints`` < ``joints``) zeroes
    the padded joints after the stem and after each block's ReLUs (BN
    bias would leak into them) and pools logits over the valid joints
    only, so a session's logits equal its run on a narrow plan.  ``use_ck``
    blocks write the frame's θ/φ embeddings into their rings (zeros for an
    invalid frame) and build C_k from the window before the spatial conv:
    on ``cuda`` the step form of the ``windowed_similarity`` kernel does
    both, on ``reference`` the ring writes and ``adaptive.windowed_ck``."""
    ps = plan.static
    backend = get_backend(ps.backend)
    bn = _BNFrozen(state.bn_stats if bn_stats is None
                   else _pad_data_bn_stats(bn_stats, ps))
    K = ps.tkernel
    pad = K // 2
    nblocks = len(ps.blocks)
    S = frame.shape[0]
    ks = torch.arange(K, device=frame.device)
    vj = ps.valid_joints or ps.joints
    live_j = live = None               # a slab-padded plan's joint mask
    if vj < ps.joints:
        live_j = torch.arange(ps.joints, device=frame.device) < vj
        live = live_j[None, :, None]

    def mask_joints(a: torch.Tensor) -> torch.Tensor:
        return a if live is None else torch.where(live, a, 0.0)

    valid = _slot_mask(valid, S, frame.device)
    has_input = (state.t_raw % ps.input_skip) == 0     # C5 input skip (S,)
    in_valid = valid & has_input
    h_in = mask_joints(_stem_frame(plan.arrays, frame, bn))

    new_blocks: List[Dict[str, torch.Tensor]] = []
    new_rfc: List[Dict[str, torch.Tensor]] = []
    for b, (ba, bs) in enumerate(zip(plan.arrays["blocks"], ps.blocks)):
        sb = state.blocks[b]
        tag = f"b{b}/"
        t = sb["t"]                                    # (S,) block clock
        # masked per-slot ring position: only slots with an input write
        write = (ks[None, :] == (t % K)[:, None]) & has_input[:, None]
        nb: Dict[str, torch.Tensor] = {}

        # --- windowed C_k: embedding-ring update, then the graph -----------
        ck = None
        if bs.use_ck:
            xg = _gather_in(h_in, ba)
            e_th = torch.einsum("nvc,ce->nve", xg, ba["theta"].to(h_in.dtype))
            e_ph = torch.einsum("nvc,ce->nve", xg, ba["phi"].to(h_in.dtype))
            vjs = 0 if live is None else vj
            # invalid (flush) frames write zero embeddings: they trail every
            # valid frame, so valid windows match clip mode
            if ps.backend == "cuda":
                # one kernel: both ring writes, the window sums, the graph
                nb["ck_th"], nb["ck_ph"], ck = ops.windowed_similarity_step(
                    sb["ck_th"], sb["ck_ph"], e_th, e_ph, t, has_input,
                    in_valid, valid_joints=vjs)
            else:
                e_th = torch.where(in_valid[:, None, None], e_th, 0.0)
                e_ph = torch.where(in_valid[:, None, None], e_ph, 0.0)
                nb["ck_th"] = _ring_write(sb["ck_th"], write, e_th)
                nb["ck_ph"] = _ring_write(sb["ck_ph"], write, e_ph)
                ck = adaptive.windowed_ck(nb["ck_th"].sum(1),
                                          nb["ck_ph"].sum(1),
                                          valid_joints=vjs)

        # --- frame-local gcn unit (spatial graph conv + down residual) ----
        s = backend.spatial(h_in[:, None], ba, bs,
                            ck=None if ck is None else ck[:, None])[:, 0]
        s = bn(tag + "bn_s", s, ba["bn_s"])
        down = (bn(tag + "bn_down",
                   torch.einsum("nvc,co->nvo", h_in, ba["down_w"]),
                   ba["bn_down"])
                if ba["down_w"] is not None else h_in)
        s = mask_joints(torch.relu(s + down))  # BN bias leaks into padding
        # invalid inputs become the clip conv's zero padding at this level
        s = torch.where(in_valid[:, None, None], s, 0.0)

        # --- ring writes -----------------------------------------------------
        ring_s = _ring_write(sb["ring_s"], write, s)
        ring_h = _ring_write(sb["ring_h"], write, h_in)
        vring = torch.where(write, in_valid[:, None], sb["valid"])
        new_blocks.append({"ring_s": ring_s, "ring_h": ring_h,
                           "valid": vring,
                           "t": t + has_input.to(t.dtype), **nb})

        # --- stride-decimated emission (per slot) --------------------------
        # clip output o completes when input t = o*stride + pad arrives; its
        # centre tap (and residual source) is input t - pad
        emit = has_input & (t >= pad) & ((t - pad) % bs.stride == 0)
        head = ((t + 1) % K).to(torch.int32)           # oldest frame
        out = backend.temporal_step(ring_s, head, ba, bs)
        out = bn(tag + "bn_t", out, ba["bn_t"])
        center = ((t - pad) % K).long()[:, None]       # (S, 1)
        h_c = _gather_k(ring_h, center)[:, 0]
        if ba["short_w"] is not None:
            res = bn(tag + "bn_short",
                     torch.einsum("nvc,co->nvo", h_c, ba["short_w"]),
                     ba["bn_short"])
        else:
            res = h_c
        out_valid = torch.gather(vring, 1, center)[:, 0]
        if b < nblocks - 1 and ps.use_rfc:
            # --- the epilogue in the RFC format, frame by frame -----------
            # one kernel: add, ReLU, joint mask, encode, and the old leaves
            # kept for slots that do not emit; a non-emitting slot's decoded
            # row is its last emitted frame, which nothing downstream reads
            # (the next block writes its rings only where has_input = emit)
            vals, bits = ops.rfc_encode(out, res, live=live_j, keep=emit,
                                        old=state.rfc[b])
            new_rfc.append({"vals": vals, "bits": bits})
            out = ops.rfc_decode(vals, bits)
        else:
            out = mask_joints(torch.relu(out + res))
        if b < nblocks - 1:
            h_in = out
        has_input = emit
        in_valid = out_valid

    # --- running temporal logit pool (per slot) ----------------------------
    take = has_input & in_valid                        # (S,)
    contrib = out[:, :vj].mean(dim=1)                  # (S, C_last), valid
                                                       # joints pooled
    if ps.stream_pool > 0:
        W = ps.stream_pool
        pwrite = (torch.arange(W, device=frame.device)[None, :]
                  == (state.pool_t % W)[:, None]) & take[:, None]
        pool_ring = _ring_write(state.pool_ring, pwrite, contrib)
        # summed anew from the ring (W is small): a running add/subtract
        # would drift over an unbounded live stream
        pool_sum = pool_ring.sum(dim=1)
    else:
        pool_ring = None
        pool_sum = state.pool_sum + torch.where(take[:, None], contrib, 0.0)
    pool_t = state.pool_t + take.to(state.pool_t.dtype)
    logits = _pooled_logits(plan.arrays, ps, pool_sum, pool_t)

    new_state = StreamState(
        t_raw=state.t_raw + 1, blocks=new_blocks, pool_ring=pool_ring,
        pool_sum=pool_sum, pool_t=pool_t, bn_stats=state.bn_stats,
        rfc=new_rfc if ps.use_rfc else None)
    return new_state, logits


def step_frames(
    plan: ExecutionPlan,
    slab: StreamState,
    frames: torch.Tensor,            # (S, V, C) one raw frame per slot
    valid,                           # (S,) bool: clip (True) or flush/free
    reset=None,                      # optional (S,) bool: admission reset
    hold=None,                       # optional (S,) bool: freeze the slot
    bn_stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
) -> Tuple[StreamState, torch.Tensor]:
    """One scheduler tick of the session slab; returns (slab, logits[S]).

    ``reset`` zeroes the marked slots before the frame is consumed, so an
    admission's first frame lands in clean rings; every slot then advances
    one raw frame with its own ``valid`` bit.  ``hold`` freezes the marked
    slots: their state is untouched (no clock advance, no ring write, not
    the flush path) and their logits row is their previous running
    prediction.  All of it is masking: the tick launches the same kernels
    whatever the occupancy and syncs nothing with the host."""
    if reset is not None:
        slab = reset_slots(slab, reset)
    new, logits = step_frame(plan, slab, frames, valid, bn_stats=bn_stats)
    if hold is not None:
        new = _select_slots(hold, slab, new)
        logits = _pooled_logits(plan.arrays, plan.static, new.pool_sum,
                                new.pool_t)
    return new, logits


def fused_tick(
    plan: ExecutionPlan,
    slab: StreamState,
    frames: torch.Tensor,            # (S, V, C) one raw frame per slot
    valid,                           # (S,) bool: per-slot clip/flush phase
    reset,                           # (S,) bool: admission reset
    hold,                            # (S,) bool: freeze starved open slots
    snap_order,                      # (E, 2) int32 (slot, ring row), padded
    rest_order,                      # (E, 2) int32 (slot, ring row), padded
    snap_ring: Dict[str, Any],       # init_snapshot_ring state
    bn_stats: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
) -> Tuple[StreamState, torch.Tensor, Dict[str, Any]]:
    """One serving tick: snapshot gathers, restore scatters, admission
    resets, hold masking and the slab step; returns ``(slab, logits,
    snap_ring)``.

    ``snap_order`` and ``rest_order`` are fixed-shape (E, 2) event buffers
    padded with :data:`SNAP_SENTINEL` no-ops, so any number of events per
    tick takes the same path.  Snapshots gather from the pre-tick slab;
    restores read ring rows written this tick or earlier (a snapshot and a
    restore of one row in one tick move the session); then ``reset``
    zeroes fresh admissions.  Functional: the input slab and ring are not
    modified and new ones are returned.  With its inputs on the card the
    tick syncs nothing with the host (the precondition of capturing it in
    a CUDA graph)."""
    new_ring = snapshot_to_ring(slab, snap_ring, snap_order)
    slab = restore_from_ring(slab, new_ring, rest_order)
    new_slab, logits = step_frames(plan, slab, frames, valid, reset, hold,
                                   bn_stats=bn_stats)
    return new_slab, logits, new_ring
