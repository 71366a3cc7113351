"""Quickstart with the PyTorch port: the paper's whole pipeline at the
reduced 2s-AGCN.  The port's counterpart of ``examples/quickstart.py``.

Trains the dense model a few steps on synthetic NTU-like skeletons,
measures each block's post-ReLU sparsity to pick the Drop scheme's kept
channel fractions, builds the RFC-HyPGCN hybrid prune plan (C1 channel
pruning + C2 cavity pattern ``cav-70-1``), runs quantised (Q8.8),
compressed inference on the ``cuda`` backend (the hand-written kernels)
and reports the RFC storage of the activations that backend writes
between blocks.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions then stand in for them).
"""
import argparse
import os
import tempfile

import numpy as np
import torch

from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine
from repro_torch.core.agcn.model import feature_sparsity_per_block, forward
from repro_torch.core.pruning.plan import build_prune_plan, drop_scheme
from repro_torch.core.rfc.format import storage_cost
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. train the dense model for a few steps
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=args.steps,
                       warmup_steps=max(1, args.steps // 10),
                       checkpoint_every=0, checkpoint_dir=os.path.join(
                           tempfile.gettempdir(), "torch_quickstart"))
    params, losses = train_loop("agcn-2s", tcfg, reduced=True, batch=16,
                                seq=0, resume=False, device=dev,
                                log_every=max(1, args.steps // 3))
    print(f"\ntrained: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # 2. per-block feature sparsity drives the Drop scheme (Fig. 9)
    cfg = get_config("agcn-2s", reduced=True)
    batch = next(make_batches(cfg, DataConfig(global_batch=8, seq_len=0)))
    x = torch.from_numpy(batch["x"]).to(dev)
    sparsity = feature_sparsity_per_block(params, x, cfg)
    keep = drop_scheme(sparsity)
    keep[0] = 1.0
    print("per-block sparsity:", [f"{s:.2f}" for s in sparsity])

    # 3. hybrid prune: C1 channel drop + C2 cavity pattern cav-70-1
    sw = [b["Wk"].cpu().numpy() for b in params["blocks"]]
    plan = build_prune_plan(sw, cfg.gcn_channels, keep, "cav-70-1",
                            input_skip=2)
    s = plan.summary(cfg.gcn_channels, cfg.gcn_in_channels)
    print(f"compression {s['compression_ratio']:.2f}x, "
          f"graph-skip {s['graph_skip_efficiency'] * 100:.1f}%")

    # 4. quantised, compressed inference on the cuda backend
    with torch.inference_mode():
        ep = engine.build_execution_plan(params, cfg, plan, quant=True,
                                         backend="cuda")
        logits = forward(params, x, cfg, exec_plan=ep)
        labels = torch.from_numpy(batch["labels"]).to(dev)
        acc = float((logits.argmax(-1) == labels).float().mean())
        print(f"pruned+quantised accuracy on batch: {acc:.3f} (cuda "
              f"backend, device={dev.type})")

        # 5. the RFC storage of the activations written between blocks
        words = [bits.cpu().numpy() for _, bits in
                 engine.rfc_boundaries(ep, x)]
    c = storage_cost(np.concatenate([w.reshape(-1) for w in words]))
    print(f"RFC storage saving on {len(words)} block boundaries: "
          f"{c['rfc_vs_dense_reduction'] * 100:.1f}% (sparsity "
          f"{c['sparsity'] * 100:.1f}%)")


if __name__ == "__main__":
    main()
