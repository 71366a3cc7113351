"""The port's bench harness: one module per paper table or figure, the
counterpart of ``benchmarks/run.py``.  Prints ``name,us_per_call,derived``
CSV rows.

    PYTHONPATH=src python -m benchmarks.torch_run [--only MODULE] [--json] \\
        [--smoke] [--out-dir DIR] [--device cuda|cpu] [--reduced] \\
        [--backend cuda|reference|both]

Modules: ``pruning_bench``, ``agcn_ablation``, ``rfc_storage`` and
``dyn_sched`` (the ``benchmarks/torch_paper.py`` subcommands of those
names), ``throughput``, ``kernels_bench`` (``--only kernels`` also) and
``roofline_report``.  With ``--only MODULE`` (or ``--json`` for a whole
run) a module's rows go to ``DIR/BENCH_torch_<module>.json``.  ``--smoke``
times one call a row, cuts the measured axes as the JAX harness's smoke
tier does and trains the accuracy comparison one step.  The device
defaults to CUDA (no CPU fallback); ``--device cpu`` and ``--reduced``
run the plain paths on the CPU.  A module that raises emits
``<module>/ERROR`` and the run exits 1.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import traceback
from typing import Optional, Sequence

import torch

from benchmarks import torch_common as common

PAPER_MODULES = ("pruning_bench",      # Fig. 8/9/10 — hybrid pruning
                 "agcn_ablation",      # Table I    — C_k cost
                 "rfc_storage",        # Table III + Fig. 11 — RFC storage
                 "dyn_sched")          # Table II   — Dyn-Mult-PE sizing
MODULES = [
    *PAPER_MODULES,
    "throughput",         # Tables IV/V — throughput, measured and counted
    "kernels_bench",      # kernel micro-benchmarks and the CSR crossover
    "roofline_report",    # the dry run's roofline tables
]


def run_module(name: str, args: argparse.Namespace, rest: Sequence[str]
               ) -> None:
    """Run one module; its rows land in ``torch_common.ROWS``."""
    if name in PAPER_MODULES:
        from benchmarks import torch_paper
        st = torch_paper.Setup(
            reduced=args.reduced, device=args.device,
            backends=common.parse_backends(rest),
            steps=1 if args.smoke else args.steps)
        for sub in torch_paper.GROUPS.get(name, (name,)):
            torch_paper.SUBCOMMANDS[sub](st)
        return
    argv = [*rest, *(("--device", args.device) if args.device else ()),
            *(("--reduced",) if args.reduced else ())]
    importlib.import_module(f"benchmarks.torch_{name}").main(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the modules and write their rows; returns the exit code."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0],
                                 allow_abbrev=False)
    ap.add_argument("--only", default=None,
                    help="one module ('kernels' for kernels_bench)")
    ap.add_argument("--json", action="store_true",
                    help="write BENCH_torch_<module>.json for every module")
    ap.add_argument("--smoke", action="store_true",
                    help="one timed call a row, cut axes, 1 training step")
    ap.add_argument("--out-dir", default=".",
                    help="directory of the BENCH_torch_<module>.json files")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=120,
                    help="training steps of each accuracy run")
    # unknown flags (--backend, --dryrun-dir...) pass to the modules
    args, rest = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    common.SMOKE = args.smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    only = args.only
    if only and only not in MODULES and f"{only}_bench" in MODULES:
        only = f"{only}_bench"           # `--only kernels`
    if only and only not in MODULES:
        ap.error(f"unknown module {only!r} (one of {MODULES})")
    print("name,us_per_call,derived")
    failed = []
    for m in [only] if only else MODULES:
        try:
            run_module(m, args, rest)
        except Exception as e:  # noqa: BLE001 — recorded as an ERROR row
            failed.append(m)
            traceback.print_exc()
            common.emit(f"{m}/ERROR", 0.0, repr(e))
        rows = common.drain_rows()
        if rows and (only or args.json):
            path = os.path.join(args.out_dir, f"BENCH_torch_{m}.json")
            with open(path, "w") as f:
                json.dump(rows, f, indent=1)
            print(f"# wrote {len(rows)} rows -> {path}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
