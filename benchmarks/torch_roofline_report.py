"""Roofline report of the port's dry run: reads the per-cell records that
``repro_torch.launch.dryrun`` writes and emits the roofline tables (CSV
rows and a markdown file).  The counterpart of
``benchmarks/roofline_report.py``, on the H100 meshes of
``repro_torch.launch.mesh``.

    PYTHONPATH=src python -m benchmarks.torch_roofline_report \\
        [--dryrun-dir experiments/torch_dryrun] \\
        [--baseline-dir experiments/torch_dryrun_baseline] \\
        [--out experiments/torch_roofline.md]

Tables: ``h100x1`` (one card), ``h100x8`` (each row the per-card step of
one 8-card node, data-parallel) and, apart, ``h100x8m4`` (the same node
with a model axis of 4).  Skipped and failed cells are listed under them;
when the baseline directory holds records, a comparison of each cell's
roofline fraction follows.  The terms are counted on meta tensors (no
card): they are the step's counted FLOPs and bytes over the H100's rates,
not device measurements.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Dict, List, Optional, Sequence

from benchmarks.torch_common import emit

MESH_TABLES = (("h100x1", "one card"),
               ("h100x8", "per card of one 8-card node, data 8"))
MESH_APART = ("h100x8m4", "per card of one 8-card node, data 2 × model 4")


def load_cells(dryrun_dir: str) -> List[Dict]:
    """Every ``*.json`` record under ``dryrun_dir``, sorted by file name."""
    return [json.loads(p.read_text())
            for p in sorted(pathlib.Path(dryrun_dir).glob("*.json"))]


def cell_mesh(c: Dict) -> str:
    """A record's mesh: its ``mesh`` field, or the last ``__`` part of its
    cell id (skipped and failed records carry only the id)."""
    return c.get("mesh") or c["cell"].rsplit("__", 1)[-1]


def mesh_table(cells: List[Dict], mesh: str) -> str:
    """The markdown roofline table of the ok cells of ``mesh``."""
    lines = [
        "| arch | shape | dominant | t_comp (s) | t_mem (s) | t_coll (s) | "
        "useful FLOP ratio | roofline frac | peak (GiB) | fits 80 GiB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for c in cells:
        if c.get("status") != "ok" or cell_mesh(c) != mesh:
            continue
        r, m = c["roofline"], c.get("memory", {})
        lines.append(
            f"| {c['arch']} | {c['shape']} | {r['dominant']} "
            f"| {r['t_compute_s']:.3e} | {r['t_memory_s']:.3e} "
            f"| {r['t_collective_s']:.3e} | {r['useful_flop_ratio']:.3f} "
            f"| {r['roofline_fraction']:.4f} "
            f"| {m.get('peak_bytes', 0) / 2 ** 30:.2f} "
            f"| {m.get('fits_hbm', '—')} |")
    return "\n".join(lines)


def skip_list(cells: List[Dict]) -> List[str]:
    """``cell (reason)`` of every skipped or failed record."""
    out = []
    for c in cells:
        if c.get("status") == "skipped":
            out.append(f"{c['cell']} ({c.get('reason', '')})")
        elif c.get("status") == "error":
            out.append(f"{c['cell']} (error: {c.get('error', '')[:120]})")
    return out


def comparison_table(final: List[Dict], baseline: List[Dict]) -> str:
    """Each ok cell's roofline fraction against the baseline's."""
    base = {c["cell"]: c for c in baseline if c.get("status") == "ok"}
    lines = [
        "| cell | frac (baseline) | frac (final) | Δ | dominant (final) |",
        "|---|---|---|---|---|",
    ]
    for c in final:
        if c.get("status") != "ok":
            continue
        rf = c["roofline"]["roofline_fraction"]
        b = base.get(c["cell"])
        if b is None:
            lines.append(f"| {c['cell']} | — | {rf:.4f} | — | "
                         f"{c['roofline']['dominant']} |")
            continue
        bf = b["roofline"]["roofline_fraction"]
        ratio = f"{rf / bf:.2f}x" if bf else "—"
        lines.append(f"| {c['cell']} | {bf:.4f} | {rf:.4f} | {ratio} "
                     f"| {c['roofline']['dominant']} |")
    return "\n".join(lines)


def report(cells: List[Dict], baseline: Optional[List[Dict]] = None) -> str:
    """The whole markdown report."""
    parts = ["# Roofline of the port's dry run (H100 terms, counted on "
             "meta tensors)", ""]
    for mesh, what in (*MESH_TABLES, MESH_APART):
        parts += [f"## {mesh} ({what})", "", mesh_table(cells, mesh), ""]
    skips = skip_list(cells)
    parts += ["## Skipped or failed cells", "",
              "; ".join(skips) if skips else "none", ""]
    if baseline:
        parts += ["## Baseline against final", "",
                  comparison_table(cells, baseline), ""]
    return "\n".join(parts)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """Emit the ``roofline/*`` rows and write the markdown report."""
    ap = argparse.ArgumentParser(add_help=False, allow_abbrev=False)
    ap.add_argument("--dryrun-dir", default="experiments/torch_dryrun")
    ap.add_argument("--baseline-dir",
                    default="experiments/torch_dryrun_baseline")
    ap.add_argument("--out", default="experiments/torch_roofline.md")
    args, _ = ap.parse_known_args(sys.argv[1:] if argv is None else argv)
    cells = load_cells(args.dryrun_dir)
    ok = [c for c in cells if c.get("status") == "ok"]
    counts = " ".join(
        f"{m}={sum(1 for c in ok if cell_mesh(c) == m)}"
        for m in (*(m for m, _ in MESH_TABLES), MESH_APART[0]))
    emit("roofline/cells_ok", 0.0,
         f"{counts} "
         f"skipped={sum(1 for c in cells if c.get('status') == 'skipped')} "
         f"errors={sum(1 for c in cells if c.get('status') == 'error')} "
         f"(from {args.dryrun_dir})")
    for c in ok:
        r = c["roofline"]
        bound = max(r["t_compute_s"], r["t_memory_s"], r["t_collective_s"])
        emit(f"roofline/{cell_mesh(c)}/{c['arch']}/{c['shape']}", 0.0,
             f"dominant={r['dominant']} frac={r['roofline_fraction']:.4f} "
             f"useful={r['useful_flop_ratio']:.3f} bound_s={bound:.4g}")
    base_dir = pathlib.Path(args.baseline_dir)
    baseline = load_cells(str(base_dir)) if base_dir.is_dir() else None
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(report(cells, baseline))
    emit("roofline/report", 0.0, str(out))


if __name__ == "__main__":
    main()
