"""Batched serving with the PyTorch port: a token-by-token prefill and
cached greedy decoding across architecture families (dense GQA, MoE,
SSM, hybrid), at the reduced configs with random weights.  The port's
counterpart of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py [--device cpu]

Runs on the card unless ``--device cpu`` is given (the kernels' plain
versions then stand in for them).
"""
import argparse

from repro_torch.launch.serve import generate

ARCHS = ["smollm-360m", "qwen3-moe-30b-a3b", "xlstm-1.3b", "zamba2-7b"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        res = generate(arch, reduced=True, batch=2, prompt_len=8, gen=24,
                       device=args.device)
        seqs = res["tokens"]
        print(f"{arch:24s} {seqs.shape[1]} tokens/seq  "
              f"{res['tokens_per_s']:7.1f} tok/s  "
              f"sample={seqs[0, 8:16].tolist()}")


if __name__ == "__main__":
    main()
