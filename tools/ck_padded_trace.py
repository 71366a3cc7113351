#!/usr/bin/env python3
"""Trace, on one NVIDIA GPU, how far a C_k stream on a plan padded to 50
joints parts from the same stream on the narrow 25-joint plan.

    python3 tools/ck_padded_trace.py

Full ``agcn-2s`` with ``use_ck`` on the ``cuda`` backend, 8 sequences of
one batch (300 frames, then the drain), both plans stepped in lockstep
from the same frozen statistics, as ``chip_smoke.py``'s ck phase runs
them.  Prints the step where the logits part most beyond the ck phase's
bound (atol = rtol = 1e-4: the printed excess is the largest
``|a - b| - 1e-4 * |b|``), then every 25th step and every step within
2e-5 of the bound: the logits' largest difference, and the largest
difference of the ``windowed_similarity`` graphs (the padded plan's first
25 rows and columns) and of the new θ rings over the step's 20 launches.
The graph of the padded plan equals the narrow plan's on equal rings
(``tests/test_torch_cuda_kernels.py``), so the parting comes from the
other operations, which round differently at the two widths, and from
how the stream amplifies that.  Imports torch, numpy and ``repro_torch``
only; needs the CUDA toolkit's nvcc.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src")]

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.agcn import engine  # noqa: E402
from repro_torch.core.agcn.model import bone_stream, init_params  # noqa: E402
from repro_torch.core.pruning.plan import plan_from_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, skeleton_batches  # noqa: E402
from repro_torch.kernels import window_sim as ws  # noqa: E402
from repro_torch.train.steps import make_gcn_stream_step  # noqa: E402

S, VMAX, TOL = 8, 50, 1e-4


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("agcn-2s")
    cfg_ck = dataclasses.replace(cfg, use_ck=True)
    gen = torch.Generator().manual_seed(0)
    params = [init_params(cfg_ck, gen, device=dev) for _ in range(2)]

    def plans(**kw):
        return tuple(engine.build_execution_plan(
            p, cfg_ck, plan_from_config(cfg), quant=True, backend="cuda",
            **kw) for p in params)

    narrow, padded = plans(), plans(pad_joints=VMAX)
    # persons fold into the batch: the first S sequences, as chip_smoke
    xs = torch.from_numpy(next(skeleton_batches(cfg, DataConfig(
        global_batch=S, seq_len=cfg.gcn_frames, seed=0)))["x"]).to(dev)[:S]
    V = xs.shape[2]
    xsp = F.pad(xs, (0, 0, 0, VMAX - V))
    step = make_gcn_stream_step(cfg)
    sn = tuple(engine.init_stream_state(p, S, x_calib=x)
               for p, x in zip(narrow, (xs, bone_stream(xs))))
    sp = tuple(engine.init_stream_state(p, S, bn_stats=s_.bn_stats)
               for p, s_ in zip(padded, sn))

    calls = []
    orig = ws.windowed_similarity_step_cuda

    def record(*args, **kwargs):
        out = orig(*args, **kwargs)
        calls.append((out[0], out[2]))          # new θ ring, graph
        return out

    ws.windowed_similarity_step_cuda = record
    T = cfg.gcn_frames
    flush = engine.stream_flush_frames(narrow[0], T)
    rows = []
    try:
        for r in range(T + flush):
            live = r < T
            calls.clear()
            sn, ln = step(narrow, sn, xs[:, r] if live else
                          torch.zeros_like(xs[:, 0]), live)
            cn = list(calls)
            calls.clear()
            sp, lp = step(padded, sp, xsp[:, r] if live else
                          torch.zeros_like(xsp[:, 0]), live)
            diff = (ln - lp).abs()
            graph = max(float((a[1] - b[1][:, :V, :V]).abs().max())
                        for a, b in zip(cn, calls))
            ring = max(float((a[0] - b[0][:, :, :V]).abs().max())
                       for a, b in zip(cn, calls))
            rows.append((r, float(diff.max()),
                         float((diff - TOL * lp.abs()).max()), graph, ring))
    finally:
        ws.windowed_similarity_step_cuda = orig
    worst = max(rows, key=lambda x: x[2])
    print(f"worst excess over the {TOL:g} bound {worst[2]:.3g} at step "
          f"{worst[0]}; largest logit difference "
          f"{max(x[1] for x in rows):.3g}")
    for r, d, ex, graph, ring in rows:
        if r % 25 == 0 or ex > -2e-5:
            print(f"  step {r}: logits {d:.3g} (excess {ex:.3g}), graphs "
                  f"{graph:.3g}, rings {ring:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
