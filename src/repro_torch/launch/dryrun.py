"""Static dry run of every (arch × shape × mesh) cell on H100 terms: the
port's counterpart of ``repro.launch.dryrun``.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out experiments/torch_dryrun

Each cell builds the per-card step of its mesh on meta tensors (shapes
and dtypes, nothing allocated, no card needed): the parameters from
``registry.init_params(device="meta")``, the batch from
``configs.input_specs`` cut to the global batch (× persons for the GCN)
over the mesh's data axis, and for decode a bfloat16 cache from
``registry.init_cache``.  Train runs the loss, autograd's backward and the
AdamW update over ``TRAIN_MICROBATCHES`` microbatches, with the gradient
sync's collectives read from ``train.steps.grad_sync_plan``; prefill runs
``make_prefill_step``; decode runs ``make_serve_step(cfg, "reference")``.
The step runs under ``launch.op_cost.OpCost`` and each cell writes one
JSON record: JAX's record with a ``dtype`` field, ``memory`` (argument,
output and peak-live bytes, and whether the peak fits the card's 80 GiB)
and ``roofline`` (``launch.roofline`` on the H100's float32 peak, the
port's compute dtype: TF32 is off).

Meshes (``launch.mesh``): ``h100x1``, ``h100x8`` (data 8) and
``h100x8m4`` (data 2, model 4).  Each cell takes JAX's rules for it
(``sharding.rules_for``, JAX's ``_rules_for``): a batch that does not
divide over the batch ranks (``long_500k``'s single sequence on
``h100x8``) is run whole on every rank against its share of the cache's
slots (``kv_seq``), and a model axis shards the LM families' layers
(``params.model_layout``: the parameters are this rank's model shards)
and, under JAX's default ``seq_shard`` rule, holds the residual between
blocks as a sequence shard wherever the model axis divides the sequence
(``sharding.seq_parallel``: train and prefill; decode's one token stays
replicated).  Such a cell runs under the mesh's context on the
shape-only mesh, where the layers' collectives return meta results and
count their bytes, so the roofline's collective term holds the model
axis's traffic (the reduce-scatters and all-gathers of sequence
parallelism, the norm scales' gradient sums) and the kv_seq merge
beside the gradient sync.

A cell the port cannot run is recorded ``skipped`` with its reason: a
shape the arch does not take (``configs.shape_applicable``).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
import traceback
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.common.config import (GCN_SHAPES, SHAPES, ModelConfig,
                                       TrainConfig)
from repro_torch.common.tree import tree_leaves, tree_map
from repro_torch.configs import (CONFIGS, get_config, input_specs,
                                 shape_applicable)
from repro_torch.distributed import params as dparams
from repro_torch.distributed.sharding import (NamedSharding, axis_size,
                                              batch_ranks, rules_for)
from repro_torch.launch.mesh import (HBM_BYTES, MESHES, PEAK_FLOPS_F32,
                                     make_production_mesh, named_mesh)
from repro_torch.launch.op_cost import OpCost
from repro_torch.launch.roofline import roofline_terms
from repro_torch.models import registry

# JAX's train cells accumulate over cfg.train_microbatches = 2 microbatches
# (src/repro/common/config.py:119); the port's ModelConfig has no such field
TRAIN_MICROBATCHES = 2
CACHE_DTYPE = torch.bfloat16       # the reference's decode cache dtype


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    """The model's mandatory FLOPs for the whole step (all cards): 2·N per
    token forward, 6·N per token in training (3× for the GCN)."""
    shp = (GCN_SHAPES | SHAPES)[shape_name]
    n_active = cfg.active_param_count_estimate()
    if cfg.family == "gcn":
        tokens = shp.global_batch * cfg.gcn_persons * (
            cfg.gcn_frames // max(1, cfg.input_skip))
        return 2.0 * n_active * tokens * (3 if shp.kind == "train" else 1)
    if shp.kind == "train":
        return 6.0 * n_active * shp.global_batch * shp.seq_len
    if shp.kind == "prefill":
        return 2.0 * n_active * shp.global_batch * shp.seq_len
    return 2.0 * n_active * shp.global_batch        # decode: one token


def model_bytes(cfg: ModelConfig, shape_name: str, param_bytes: float = 4.0,
                cache_bytes: float = 2.0) -> float:
    """The mandatory HBM traffic of one step (all cards), JAX's formula
    with the itemsizes as arguments (JAX's are 2 and 2; the port's
    float32 parameters and bf16 cache 4 and 2): the parameters read once;
    decode also reads the KV cache (``cache_bytes`` a value) or the
    float32 SSM states; train reads the parameters, writes the gradients
    and reads and writes the float32 moments (2·param_bytes + 16 a
    parameter)."""
    shp = (GCN_SHAPES | SHAPES)[shape_name]
    n = cfg.param_count_estimate()
    if shp.kind == "train":
        return n * (2 * param_bytes + 16.0)
    base = n * param_bytes
    if shp.kind == "decode" and cfg.family != "gcn":
        if cfg.family in ("dense", "moe", "vlm", "audio"):
            kv_len = shp.seq_len
            if cfg.window_size > 0 and cfg.local_global_ratio == 0:
                kv_len = min(kv_len, cfg.window_size)   # SWA ring buffer
            base += (2 * cfg.num_layers * shp.global_batch * kv_len
                     * cfg.num_kv_heads * cfg.head_dim * cache_bytes)
        elif cfg.family == "hybrid":
            ng = cfg.num_layers // (cfg.shared_attn_every + 1)
            base += (2 * ng * shp.global_batch * shp.seq_len
                     * cfg.num_kv_heads * cfg.head_dim * cache_bytes)
            base += (cfg.num_layers * shp.global_batch
                     * (cfg.ssm_expand * cfg.d_model) * cfg.ssm_state * 4.0)
        elif cfg.family == "ssm":
            d_inner = cfg.ssm_expand * cfg.d_model
            dh = d_inner // cfg.num_heads
            base += (cfg.num_layers * shp.global_batch * cfg.num_heads
                     * dh * (dh + 1) * 4.0)
    return base


# --mesh values: the meshes each one runs
MESH_CHOICES = {"single": ["h100x1"], "multi": ["h100x8"],
                "model": ["h100x8m4"], "both": ["h100x1", "h100x8"],
                "all": list(MESHES)}


class Cell(NamedTuple):
    """One cell's per-card step: ``step(*args)``, its kind, and for train
    the gradient sync's plan (one list of ``SyncStep`` a leaf)."""
    kind: str
    step: object
    args: tuple
    sync: list


def cell_skip(cfg: ModelConfig, shape_name: str, mesh) -> str:
    """Why the port cannot run this cell ('' when it can)."""
    ok, reason = shape_applicable(cfg, shape_name)
    return "" if ok else reason


def cell_rules(cfg: ModelConfig, shape_name: str, mesh) -> Dict:
    """The cell's logical rules (JAX's ``_rules_for``)."""
    shp = (GCN_SHAPES | SHAPES)[shape_name]
    rows = shp.global_batch * (cfg.gcn_persons if cfg.family == "gcn" else 1)
    return rules_for(cfg.sharding, rows, mesh)


def _fill(t: torch.Tensor, gen: torch.Generator, high: int,
          device) -> torch.Tensor:
    """A real tensor like meta ``t`` on ``device``, drawn on the CPU from
    ``gen``: integers in [0, high), or normal floats."""
    if t.dtype.is_floating_point:
        x = torch.randn(t.shape, generator=gen, dtype=t.dtype)
    elif t.dim() == 0:
        x = torch.zeros((), dtype=t.dtype)
    else:
        x = torch.randint(0, high, t.shape, generator=gen, dtype=t.dtype)
    return x.to(device)


def build_cell(cfg: ModelConfig, shape_name: str, mesh,
               device: str = "meta", backend: str = "reference",
               seed: int = 0) -> Cell:
    """The per-card step of one cell on ``mesh``: meta tensors by default
    (the static count), or real ones on ``device`` (random weights and
    inputs from ``seed``; decode at position S − 1, so the step writes the
    cache's last slot and attends to all S).  ``backend`` is the decode
    step's (the dry run counts ``reference``).  The batch is split over
    the cell's batch ranks (:func:`cell_rules`); on a model axis the
    parameters are rank 0's model shards and the step runs under the
    mesh's context, as it does under ``kv_seq`` (the cache rank 0's slot
    range)."""
    import contextlib
    from repro_torch.optim import adamw
    from repro_torch.train.steps import (grad_sync_plan, make_loss_fn,
                                         make_prefill_step, make_serve_step,
                                         make_train_step)
    shp = (GCN_SHAPES | SHAPES)[shape_name]
    rules = cell_rules(cfg, shape_name, mesh)
    ranks = batch_ranks(mesh, rules)
    layout = dparams.model_layout(cfg, mesh)
    on_mesh = axis_size(mesh, "model") > 1 or rules["kv_seq"] is not None
    meta = torch.device(device).type == "meta"
    gen = torch.Generator().manual_seed(seed)
    params = registry.init_params(cfg, seed=seed, device=device)
    if on_mesh:
        params = dparams.local_shards(params, layout.specs, mesh)
    specs, _ = input_specs(cfg, shape_name)
    high = cfg.gcn_num_classes if cfg.family == "gcn" else cfg.vocab_size
    batch = {}
    for k, t in specs.items():
        if t.dim():
            t = torch.empty((t.shape[0] // ranks, *t.shape[1:]),
                            dtype=t.dtype, device="meta")
        batch[k] = t if meta else _fill(t, gen, high, device)
    def context():
        return (dparams.mesh_context(cfg, mesh, rules, layout) if on_mesh
                else contextlib.nullcontext())
    if shp.kind == "train":
        opt = adamw.init(params)
        loss = make_loss_fn(cfg)
        tcfg = TrainConfig(microbatches=TRAIN_MICROBATCHES)
        inner = make_train_step(cfg, tcfg) if not on_mesh else \
            make_train_step(cfg, tcfg, loss_fn=lambda p, b: loss(
                dparams.prepare(p, layout), b))

        def step(*args):
            with context():
                return inner(*args)
        # the gradients' layout, as JAX's cells constrain them: the
        # policy's (2D: a reduce-scatter into the data shard; the GCN's
        # dp_only: replicated), each rank's gradient its model shard
        sync = grad_sync_plan(params, tree_map(
            lambda sp: NamedSharding(mesh, sp), layout.specs), rules=rules)
        return Cell("train", step, (params, opt, batch), sync)
    if shp.kind == "prefill":
        return Cell("prefill", make_prefill_step(
            cfg, mesh if on_mesh else None, rules), (params, batch), [])
    B = shp.global_batch // ranks
    with context():
        cache = registry.init_cache(cfg, B, shp.seq_len, device=device,
                                    dtype=CACHE_DTYPE)
    if not meta:
        pos = shp.seq_len - 1
        batch["pos"] = torch.full((), pos, dtype=torch.int32, device=device)
        for leaf in cache_positions(cache):
            leaf.fill_(pos)
    return Cell("decode", make_serve_step(
        cfg, backend, mesh if on_mesh else None, rules),
        (params, cache, batch), [])


def cache_positions(cache) -> list:
    """The position leaves of a decode cache (its int32 leaves)."""
    return [t for t in tree_leaves(cache) if t.dtype == torch.int32]


def _storage_bytes(tree, skip=()) -> int:
    """Bytes of the distinct storages of ``tree``'s tensors, leaving out
    those in ``skip`` (storage keys)."""
    seen, total = set(skip), 0
    for t in tree_leaves(tree):
        if not isinstance(t, torch.Tensor):
            continue
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            total += st.nbytes()
    return total


def count_cell(cell: Cell) -> Tuple[Dict, Dict, float]:
    """Run ``cell``'s step once under an :class:`OpCost` counter, with the
    gradient sync's collectives; returns (cost, memory, seconds)."""
    args_bytes = _storage_bytes(cell.args)
    arg_keys = {t.untyped_storage()._cdata for t in tree_leaves(cell.args)
                if isinstance(t, torch.Tensor)}
    t0 = time.perf_counter()
    with OpCost() as c:
        for steps in cell.sync:
            for st in steps:
                c.collective(st.kind, st.nbytes)
        out = cell.step(*cell.args)
    seconds = time.perf_counter() - t0
    cost = c.analyze()
    out_bytes = _storage_bytes(out, arg_keys)
    peak = args_bytes + cost["peak_live_bytes"]
    memory = {"argument_bytes": args_bytes, "output_bytes": out_bytes,
              "peak_live_bytes": cost["peak_live_bytes"],
              "peak_bytes": peak, "fits_hbm": peak <= HBM_BYTES}
    return cost, memory, seconds


def run_cell(arch: str, shape_name: str, multi, out_dir: pathlib.Path,
             verbose: bool = True) -> Optional[Dict]:
    """Count one cell and write its record to ``out_dir/<cell>.json``.
    ``multi``: a mesh name of ``launch.mesh.MESHES``, or True for
    ``h100x8`` and False for ``h100x1``."""
    cfg = get_config(arch)
    mesh = (named_mesh(multi) if isinstance(multi, str)
            else make_production_mesh(multi=multi))
    cell_id = f"{cfg.name}__{shape_name}__{mesh.name}"
    out_path = out_dir / f"{cell_id}.json"
    reason = cell_skip(cfg, shape_name, mesh)
    if reason:
        rec = {"cell": cell_id, "status": "skipped", "reason": reason}
        out_path.write_text(json.dumps(rec, indent=2))
        if verbose:
            print(f"[skip] {cell_id}: {reason}")
        return rec
    shp = (GCN_SHAPES | SHAPES)[shape_name]
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape_name, mesh)
    t_build = time.perf_counter() - t0
    cost, memory, t_count = count_cell(cell)
    terms = roofline_terms(cost, model_flops(cfg, shape_name), mesh.size,
                           model_bytes_total=model_bytes(cfg, shape_name),
                           peak_flops=PEAK_FLOPS_F32)
    rec = {
        "cell": cell_id,
        "status": "ok",
        "arch": cfg.name,
        "shape": shape_name,
        "mesh": mesh.name,
        "chips": mesh.size,
        "kind": shp.kind,
        "dtype": {"params": "float32",
                  "cache": "bfloat16" if shp.kind == "decode" else None},
        "build_s": round(t_build, 2),
        "count_s": round(t_count, 2),
        "memory": memory,
        "cost_analysis": {k: v for k, v in cost.items()
                          if k not in ("flops_by_op", "kernels")},
        "flops_by_op": cost["flops_by_op"],
        "roofline": terms,
    }
    out_path.write_text(json.dumps(rec, indent=2))
    if verbose:
        print(f"[ok]   {cell_id}: count={t_count:.1f}s "
              f"flops={terms['hlo_flops']:.3e} bytes={terms['hlo_bytes']:.3e} "
              f"coll={terms['collective_bytes']:.3e}B "
              f"dominant={terms['dominant']} "
              f"roofline_frac={terms['roofline_fraction']:.3f} "
              f"peak={memory['peak_bytes'] / 2 ** 30:.1f}GiB")
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=sorted(MESH_CHOICES),
                    help="single (h100x1), multi (h100x8), model "
                         "(h100x8m4), both (h100x1 and h100x8) or all")
    ap.add_argument("--out", default="experiments/torch_dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = list(CONFIGS) if args.arch == "all" else [args.arch]
    meshes = MESH_CHOICES[args.mesh]
    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        cfg = get_config(arch)
        if args.shape == "all":
            shapes = list(GCN_SHAPES if cfg.family == "gcn" else SHAPES)
        else:
            shapes = [args.shape]
        for shape_name in shapes:
            for name in meshes:
                cell = f"{cfg.name}__{shape_name}__{name}"
                if args.skip_existing and (out_dir / f"{cell}.json").exists():
                    print(f"[keep] {cell}")
                    continue
                try:
                    run_cell(arch, shape_name, name, out_dir)
                except Exception as e:  # noqa: BLE001 — record and go on
                    failures.append((cell, repr(e)))
                    (out_dir / f"{cell}.json").write_text(json.dumps(
                        {"cell": cell, "status": "error", "error": repr(e),
                         "traceback": traceback.format_exc()}, indent=2))
                    print(f"[FAIL] {cell}: {e}")
    print(f"\n{len(failures)} failures in {time.perf_counter() - t0:.1f} s")
    for c, e in failures:
        print(f"  {c}: {e[:200]}")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
