#!/usr/bin/env python3
"""Same-call timings, on one NVIDIA GPU, of the port's redesigned streaming,
sparse spatial and decode-attention kernels over their plan choices.

    python3 tools/torch_kernel_plans.py [--only step|csr|flash_decode]

- ``cavity_tconv_step`` (ring form) at S = 1, 3, 8 slots of 25 and 50
  joints and C = F = 64, 128, 256 (agcn-2s's widths, cav-70-1): every
  (16-row tiles, cluster parts) plan that fits, beside the plan
  ``step_plan`` picks.
- ``graph_sconv_csr`` at the ntu50 clip (R = 1200, 600, 300 rows) and
  S = 8 stream shapes, D = the skeleton's degree and D = V, beside the
  dense ``graph_sconv`` and the 3-operand einsum on the densified graph.

Times are microseconds per launch by ``chip_smoke.cuda_ms`` (CUDA events
behind a spin kernel longer than the host's queueing); every kernel output
is held against its plain version at atol = rtol = 1e-4.  Imports torch,
numpy and ``repro_torch`` only; needs the CUDA toolkit's nvcc.
"""
import argparse
import itertools
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.core.agcn.graph import dense_to_csr, get_topology  # noqa: E402
from repro_torch.core.pruning.cavity import cavity_pattern, tile_pattern  # noqa: E402
from repro_torch.kernels import cavity_tconv as ct  # noqa: E402
from repro_torch.kernels import flash_decode as fd  # noqa: E402
from repro_torch.kernels import graph_sconv as gs  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402


def step_cases(dev, gen):
    print("cavity_tconv_step: us per launch")
    for V, S, C in itertools.product((25, 50), (1, 3, 8), (64, 128, 256)):
        mask = tile_pattern(cavity_pattern("cav-70-1"), C)
        w = (np.random.default_rng(C).standard_normal((C, C, 9))
             .astype(np.float32) * mask[:, None, :] / np.float32(np.sqrt(C)))
        wp, taps, inv = ops.pack_cavity_weights(w, mask)
        L, n_keep, _, Fg = wp.shape
        args = (torch.randn(S, 9, V, C, generator=gen, device=dev),
                torch.randint(0, 9, (S,), generator=gen, device=dev,
                              dtype=torch.int32),
                torch.from_numpy(wp).to(dev), torch.from_numpy(taps).to(dev),
                torch.from_numpy(ops.slot_columns(inv, C)).to(dev),
                torch.randn(C, generator=gen, device=dev))
        want = ct.cavity_tconv_step_ring_plain(*args)
        steps = n_keep * -(-C // 8)
        rows = []
        for wm, parts in itertools.product(ct.STEP_WM, ct.STEP_PARTS):
            smem = ct._step_smem_bytes(wm, -(-steps // parts) * 8,
                                       -(-Fg // 8) * 8, n_keep, L * Fg, C)
            if parts > steps or smem > ct.SMEM_MAX:
                continue
            p = ct.StepPlan(wm, parts, (-(-S * V // (16 * wm)), L, parts),
                            smem)
            ok = torch.allclose(ct.cavity_tconv_step_ring_cuda(
                *args, plan=p), want, atol=1e-4, rtol=1e-4)
            t = cs.cuda_ms(lambda: ct.cavity_tconv_step_ring_cuda(*args,
                                                                  plan=p))
            rows.append((t, wm, parts, ok))
        rows.sort()
        pick = ct.step_plan(S * V, C, L, n_keep, Fg, C)
        t = cs.cuda_ms(lambda: ct.cavity_tconv_step_ring_cuda(*args))
        print(f"S={S} V={V} C={C}: picked wm={pick.wm} parts={pick.parts} "
              f"{t * 1e3:.1f}; " + "; ".join(
                  f"wm={wm} parts={p} {a * 1e3:.1f}"
                  + ("" if ok else " DISAGREES")
                  for a, wm, p, ok in rows))


def csr_cases(dev, gen):
    print("graph_sconv_csr on ntu50: us per launch, beside the dense "
          "kernel and the einsum")
    adj = get_topology("ntu50").adjacency + np.float32(1e-6)
    for (R, Ci, Co), eps in itertools.product(
            ((1200, 3, 64), (1200, 64, 64), (600, 128, 128), (300, 256, 256),
             (8, 3, 64), (8, 64, 64), (8, 128, 128), (8, 256, 256)),
            (1e-5, 0.0)):
        idx, val = (torch.from_numpy(a).to(dev) for a in ops.pack_csr_ell(
            *dense_to_csr(adj, eps), 50))
        D = idx.shape[-1]
        x = torch.randn(R, 50, Ci, generator=gen, device=dev)
        w = torch.randn(3, Ci, Co, generator=gen, device=dev) / Ci ** 0.5
        g = torch.zeros(3, 50, 50, device=dev).scatter_add_(2, idx.long(),
                                                            val)
        ok = torch.allclose(gs.graph_sconv_csr_cuda(x, idx, val, w),
                            gs.graph_sconv_csr_plain(x, idx, val, w),
                            atol=1e-4, rtol=1e-4)
        p = gs.csr_plan(R, 50, Ci, Co, 3, D)
        t, td, te = (cs.cuda_ms(f) for f in (
            lambda: gs.graph_sconv_csr_cuda(x, idx, val, w),
            lambda: gs.graph_sconv_cuda(x, g, w),
            lambda: torch.einsum("rvc,kwv,kco->rwo", x, g, w)))
        print(f"R={R} Cin={Ci} Cout={Co} D={D}: csr {t * 1e3:.1f} (tile "
              f"{p.tile}, {p.rows} x {p.wt}, grid {p.grid}"
              f"{'' if ok else ', DISAGREES'}); dense {td * 1e3:.1f}; "
              f"einsum {te * 1e3:.1f}")


# (label, B, S, Hkv, G, D, valid)
DECODE_CASES = [("served last step", 4, 512, 5, 3, 64, 511),
                ("served early step", 4, 512, 5, 3, 64, 17),
                ("long context", 8, 32768, 5, 3, 64, 30000),
                ("danube ring", 4, 4096, 8, 4, 80, 4096)]


def decode_cases(dev, gen):
    import torch.nn.functional as F
    print("flash_decode: us per launch (splits/warps/stages), beside masked "
          "SDPA with enable_gqa")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, B, S, Hkv, G, D, valid in DECODE_CASES:
        q = torch.randn(B, Hkv, G, D, generator=gen, device=dev)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
                for _ in range(2))
        vt = torch.full((1,), valid, dtype=torch.int32, device=dev)
        want = fd.flash_decode_plain(q, k, v, vt)
        live = (torch.arange(S, device=dev) < valid).view(1, 1, 1, S)
        kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
        t_sdpa = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
            q.reshape(B, Hkv * G, 1, D), kh, vh, attn_mask=live,
            enable_gqa=True))
        rows = []
        for splits, warps, stages in itertools.product(
                (1, 2, 4, 8, 12, 16), fd.WARPS, (2, 3, 4, 6)):
            try:
                p = fd.make_plan(B, S, Hkv, G, D, splits, warps, stages)
            except ValueError:
                continue
            try:
                ok = torch.allclose(fd.flash_decode(q, k, v, vt, plan=p),
                                    want, atol=1e-4, rtol=1e-4)
            except RuntimeError as e:     # a cluster the card refuses
                print(f"  {splits}/{warps}/{stages} refused: {e}")
                continue
            t = cs.cuda_ms(lambda: fd.flash_decode(q, k, v, vt, plan=p))
            rows.append((t, splits, warps, stages, ok))
        rows.sort()
        pick = fd.decode_plan(B, S, Hkv, G, D, sms)
        t = cs.cuda_ms(lambda: fd.flash_decode(q, k, v, vt))
        print(f"{label} (B={B} S={S} Hkv={Hkv} G={G} D={D} valid={valid}): "
              f"picked {pick.splits}/{pick.warps}/{pick.stages} "
              f"{t * 1e3:.1f}; sdpa {t_sdpa * 1e3:.1f}; " + "; ".join(
                  f"{sp}/{w}/{st} {a * 1e3:.1f}"
                  + ("" if ok else " DISAGREES")
                  for a, sp, w, st, ok in rows))
        del q, k, v


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--only", choices=("step", "csr", "flash_decode"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, sweep in (("step", step_cases), ("csr", csr_cases),
                        ("flash_decode", decode_cases)):
        if args.only in (None, name):
            sweep(dev, gen)
    return 0


if __name__ == "__main__":
    sys.exit(main())
