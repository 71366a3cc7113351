"""Kernel micro-benchmarks of the port: each hand-written CUDA kernel
(through its ``kernels.ops`` wrapper) against its plain oracle in
``kernels.ref``, the dense-vs-CSR spatial conv crossover behind the
engine's ``csr_density=0.5`` default, and the whole forward per backend.
The counterpart of ``benchmarks/kernels_bench.py``.

    PYTHONPATH=src python -m benchmarks.torch_kernels_bench \\
        [--reduced] [--device cuda|cpu] [--backend cuda|reference|both]

The kernel inputs come from the same ExecutionPlan compiler the model uses
(``engine.build_execution_plan`` on the benches' pruning plan): the
``cuda`` plan gives the packed forms, the ``reference`` plan the dense
ones.  Full ``agcn-2s`` (the default) runs the kernels at the clip step's
block shapes (8 clips, 2 persons folded, 150 frames after input skip 2);
``--reduced`` runs the JAX bench's own shapes.  On the CPU the wrappers
run their kernels' plain versions, so the ``_cuda`` rows time PyTorch.
Times are medians of synchronised host-clock calls.
"""
from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmarks.torch_common import (demo_prune_plan, device_name, emit,
                                     parse_backends, parse_setup, time_fn)
from repro_torch.common.device import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine
from repro_torch.core.agcn.graph import dense_to_csr, get_topology
from repro_torch.core.agcn.model import init_params
from repro_torch.kernels import ops, ref

CSR_TOPOLOGIES = ("ntu25", "ntu50")
CSR_TARGETS = (0.25, 0.50)
CSR_SEED = 7                      # the JAX bench's draws
FEATURE_SEED = 8                  # full-size features of the CSR sweep
FORWARD_ROWS = 8                  # clip rows of the whole-forward rows


def shapes(reduced: bool) -> Dict[str, tuple]:
    """Input shapes of each row: the JAX bench's at the reduced config;
    at full ``agcn-2s`` the clip step's (N = 16 rows of 8 clips × 2
    persons, T = 150 frames after input skip 2, V = 25, block 1's 64
    channels)."""
    if reduced:
        return {"rfc": (512, 256), "tconv_bt": (16, 128), "sconv_nt": (4, 64),
                "csr_c": 16, "csr_nt": (2, 16)}
    n, t, v = 16, 150, 25
    return {"rfc": (n * t * v, 64), "tconv_bt": (n * v, t),
            "sconv_nt": (n, t), "csr_c": 64, "csr_nt": (n, t)}


def _block_inputs(reduced: bool, dev: torch.device):
    """The benches' plan compiled for both backends: the ``cuda`` plan
    supplies the packed kernel inputs, the ``reference`` plan the dense
    oracle forms (``cuda`` plans drop them)."""
    cfg = get_config("agcn-2s", reduced=reduced)
    params = init_params(cfg, seed=0, device=dev)
    prune = demo_prune_plan(cfg, params)
    cuda_plan = engine.build_execution_plan(params, cfg, prune,
                                            backend="cuda")
    ref_plan = engine.build_execution_plan(params, cfg, prune,
                                           backend="reference")
    return cfg, params, prune, cuda_plan, ref_plan


def csr_sweep_graphs():
    """The CSR sweep's inputs, drawn as the JAX bench draws them from
    ``np.random.default_rng(7)`` at its sizes: per topology the spatial
    weights (K, 16, 16), the features (2, 16, V, 16) and the graphs (the
    skeleton's own adjacency, then random graphs at density 0.25 and
    0.50).  Yields ``(topology, V, w, x, [(tag, graph), ...])``."""
    sh = shapes(reduced=True)
    C = sh["csr_c"]
    rng = np.random.default_rng(CSR_SEED)
    for tname in CSR_TOPOLOGIES:
        topo = get_topology(tname)
        V, K = topo.num_joints, topo.num_subsets
        w = rng.standard_normal((K, C, C)).astype(np.float32)
        x = rng.standard_normal((*sh["csr_nt"], V, C)).astype(np.float32)
        sweeps = [(f"d{int(round(topo.density * 100)):02d}", topo.adjacency)]
        for target in CSR_TARGETS:
            mask = rng.random((K, V, V)) < target
            sweeps.append((f"d{int(target * 100):02d}",
                           (rng.standard_normal((K, V, V)) * mask)
                           .astype(np.float32)))
        yield tname, V, w, x, sweeps


def csr_pack(g: np.ndarray):
    """(density, CSR triple, ELL pack at V rounded up to 8) of one graph,
    as the JAX bench packs it."""
    V = g.shape[-1]
    dens = float((np.abs(g) > 0).mean())
    indptr, indices, values = dense_to_csr(g)
    idx, val = ops.pack_csr_ell(indptr, indices, values, -(-V // 8) * 8)
    return dens, (indptr, indices, values), (idx, val)


def row_names(backends: Sequence[str] = ("cuda",)) -> List[str]:
    """The row names :func:`main` emits for ``backends``."""
    out = [f"kernels/{k}_{s}" for k in ("rfc_encode", "cavity_tconv",
                                        "graph_sconv")
           for s in ("cuda", "ref")]
    for tname, _, _, _, sweeps in csr_sweep_graphs():
        out += [f"kernels/sconv_csr/{tname}/{tag}/{form}_{impl}"
                for tag, _ in sweeps for impl in ("ref", "cuda")
                for form in ("dense", "csr")]
        out.append(f"kernels/sconv_csr/{tname}/crossover")
    out += [f"kernels/backend_forward_{b}" for b in backends]
    if len(backends) > 1:
        out.append("kernels/backend_forward_ratio")
    return out


def _csr_rows(dev: torch.device, reduced: bool, tag_note: str) -> None:
    sh = shapes(reduced)
    frng = np.random.default_rng(FEATURE_SEED)
    for tname, V, w_np, x_np, sweeps in csr_sweep_graphs():
        if not reduced:          # the graphs stay the draws above
            C = sh["csr_c"]
            K = w_np.shape[0]
            w_np = frng.standard_normal((K, C, C)).astype(np.float32)
            x_np = frng.standard_normal((*sh["csr_nt"], V, C)).astype(
                np.float32)
        w = torch.as_tensor(w_np, device=dev)
        xg = torch.as_tensor(x_np, device=dev)
        xr = xg.reshape(-1, V, xg.shape[-1])
        speed = []
        for tag, g in sweeps:
            dens, csr, ell = csr_pack(g)
            gj = torch.as_tensor(g, device=dev)
            ip, ix, vl = (torch.as_tensor(a, device=dev) for a in csr)
            ej, ev = (torch.as_tensor(a, device=dev) for a in ell)
            t_d = time_fn(lambda a, g_=gj: ref.graph_sconv_ref(a, g_, w),
                          xr, iters=3)
            t_c = time_fn(lambda a, p=ip, i=ix, v=vl:
                          ref.graph_sconv_csr_ref(a, p, i, v, w), xr, iters=3)
            emit(f"kernels/sconv_csr/{tname}/{tag}/dense_ref", t_d,
                 f"V={V} density={dens:.2f}")
            emit(f"kernels/sconv_csr/{tname}/{tag}/csr_ref", t_c,
                 f"nnz_skip={(1 - dens) * 100:.0f}%")
            t_dk = time_fn(lambda a, g_=gj: ops.graph_sconv(a, g_, w),
                           xg, iters=3)
            t_ck = time_fn(lambda a, e=ej, v=ev:
                           ops.graph_sconv_csr(a, e, v, w), xg, iters=3)
            emit(f"kernels/sconv_csr/{tname}/{tag}/dense_cuda", t_dk,
                 f"V={V} density={dens:.2f}")
            emit(f"kernels/sconv_csr/{tname}/{tag}/csr_cuda", t_ck,
                 f"ell_deg={ell[0].shape[-1]} "
                 f"nnz_skip={(1 - dens) * 100:.0f}%")
            speed.append(f"{tag}:{dens:.2f}:{t_dk / t_ck:.2f}x")
        # dense/csr time per graph: CSR wins where the ratio exceeds 1;
        # the engine's auto mode picks CSR at density <= 0.5
        emit(f"kernels/sconv_csr/{tname}/crossover", 0.0,
             "tag:density:dense/csr=" + " ".join(speed)
             + f" x={tuple(xg.shape)} ({tag_note})")


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Emit every ``kernels/*`` row (see the module docstring)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    setup = parse_setup(argv)
    backends = parse_backends(argv)
    dev = resolve_device(setup.device)
    note = device_name(dev)
    sh = shapes(setup.reduced)
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    with torch.inference_mode():
        # RFC encode (the block epilogue's encode, no residual)
        x = randn(*sh["rfc"])
        t_k = time_fn(lambda a: ops.rfc_encode(a), x, iters=3)
        t_r = time_fn(lambda a: ref.rfc_encode_ref(a), x, iters=3)
        emit("kernels/rfc_encode_cuda", t_k, f"x={tuple(x.shape)} ({note})")
        emit("kernels/rfc_encode_ref", t_r, "")

        cfg, params, prune, cplan, rplan = _block_inputs(setup.reduced, dev)
        # cavity tconv: block 1's packed kernel inputs (pruned filters and
        # cavity taps) against the dense masked conv
        pa, bs = cplan.arrays["blocks"][1], cplan.static.blocks[1]
        ra = rplan.arrays["blocks"][1]
        C = ra["tw"].shape[1]
        xt = randn(*sh["tconv_bt"], C)
        t_k = time_fn(lambda a: ops.cavity_tconv(
            a, pa["wp"], pa["taps"], pa["inv_perm"], bs.n_kept_filters), xt,
            iters=3)
        t_r = time_fn(lambda a: ref.cavity_tconv_ref(a, ra["tw"]), xt,
                      iters=3)
        n_keep, K = pa["wp"].shape[1], bs.tkernel
        emit("kernels/cavity_tconv_cuda", t_k,
             f"taps={n_keep}/{K} flop_skip={(1 - n_keep / K) * 100:.0f}% "
             f"x={tuple(xt.shape)} ({note})")
        emit("kernels/cavity_tconv_ref", t_r, "")

        # fused graph + spatial conv on the plan's graph and gathered W
        xg = randn(*sh["sconv_nt"], cfg.gcn_joints, pa["Wk"].shape[1])
        t_k = time_fn(lambda a: ops.graph_sconv(a, pa["G"], pa["Wk"]), xg,
                      iters=3)
        t_r = time_fn(lambda a: ref.graph_sconv_ref(
            a.reshape(-1, cfg.gcn_joints, ra["Wk"].shape[1]), ra["G"],
            ra["Wk"]), xg, iters=3)
        emit("kernels/graph_sconv_cuda", t_k,
             f"fused G-matmul+1x1 x={tuple(xg.shape)} ({note})")
        emit("kernels/graph_sconv_ref", t_r, "")

        _csr_rows(dev, setup.reduced, note)

        # the whole forward through the engine, per backend
        xm = randn(FORWARD_ROWS, cfg.gcn_frames, cfg.gcn_joints,
                   cfg.gcn_in_channels)
        times = {}
        for backend in backends:
            ep = engine.build_execution_plan(params, cfg, prune, quant=True,
                                             backend=backend)
            times[backend] = time_fn(engine.execute, ep, xm, iters=3)
            emit(f"kernels/backend_forward_{backend}", times[backend],
                 f"clips_per_s={xm.shape[0] / (times[backend] * 1e-6):.1f} "
                 f"({note})")
        if len(times) > 1:
            emit("kernels/backend_forward_ratio", 0.0,
                 f"cuda/reference={times['cuda'] / times['reference']:.2f}x "
                 f"({note})")


if __name__ == "__main__":
    main()
