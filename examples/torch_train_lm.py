"""End-to-end LM training on the PyTorch port: trains a reduced model of
the port's LM zoo (dense, MoE or VLM) with checkpointing and the fault
monitors active, then resumes from the mid-run checkpoint to show a
restart.  The port's counterpart of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py \\
        --arch granite-moe-3b-a800m [--steps 200] [--device cpu]
"""
import argparse
import dataclasses
import os
import shutil
import tempfile

from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.launch.train import train_loop


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    ckpt = args.ckpt_dir or os.path.join(tempfile.gettempdir(),
                                         f"example_torch_lm_{args.arch}")
    shutil.rmtree(ckpt, ignore_errors=True)
    seq = args.seq + get_config(args.arch, reduced=True).num_image_tokens
    tcfg = TrainConfig(
        learning_rate=1e-3, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 10),
        checkpoint_every=max(1, args.steps // 2), checkpoint_dir=ckpt,
    )
    _, losses = train_loop(args.arch, tcfg, reduced=True, batch=8, seq=seq,
                           device=args.device, resume=False)
    print(f"\nphase 1: loss {losses[0]:.3f} -> {losses[-1]:.3f}")

    # a restart: resume from the last checkpoint and train further
    more = max(1, args.steps // 4)
    tcfg2 = dataclasses.replace(tcfg, total_steps=args.steps + more)
    _, losses2 = train_loop(args.arch, tcfg2, reduced=True, batch=8,
                            seq=seq, device=args.device, resume=True)
    print(f"phase 2 (resumed): {len(losses2)} more steps, "
          f"final loss {losses2[-1]:.3f}")


if __name__ == "__main__":
    main()
