"""The paper's own tables on the PyTorch port (``repro_torch``): hybrid
pruning's compression, graph skipping and cavity balance (Fig. 8/9/10),
pruned against dense inference, the dense/hybrid/unstructured accuracy
comparison after prune-aware training (Fig. 8), RFC storage and sparsity
categories (Table III, Fig. 11), dynamic-scheduling DSP sizing (Table II)
and the C_k and backend ablation (Table I).  Imports torch and
``repro_torch`` only.

    PYTHONPATH=src python -m benchmarks.torch_paper SUBCOMMAND... \\
        [--reduced] [--device cuda|cpu] [--backend cuda|reference|both] \\
        [--steps N] [--out BENCH_torch_paper.json]

Subcommands: ``compression``, ``cavity``, ``rfc_storage``, ``dyn_sched``
(the tables), ``inference``, ``accuracy``, ``agcn_ablation``,
``pruning_bench`` (compression, cavity, inference and accuracy) and
``all``.  Rows print as ``name,us_per_call,derived`` and are merged by name
into ``--out``.  Model subcommands run full ``agcn-2s`` unless
``--reduced``; the device defaults to CUDA (no CPU fallback).  Times are
medians of synchronised host-clock calls.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.common.config import TrainConfig
from repro_torch.common.device import resolve_device, synchronize
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine
from repro_torch.core.agcn import model as M
from repro_torch.core.pruning.cavity import balance_stats, cavity_pattern
from repro_torch.core.pruning.plan import build_prune_plan, unstructured_prune
from repro_torch.core.rfc.format import (expected_sparsity_categories,
                                         rfc_encode, storage_cost)
from repro_torch.core.sched.expectation import scheduling_report
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step

ROWS: List[Dict] = []
PAPER_CHANNELS = (64, 64, 64, 64, 128, 128, 128, 256, 256, 256)
# Drop schemes of paper Fig. 9 (per-block kept channel fractions, block 1
# unpruned): Drop-1 tracks the base sparsity, Drop-2/3 compress harder.
DROP_SCHEMES = {
    "drop1": [1.0, 0.6, 0.6, 0.55, 0.5, 0.5, 0.45, 0.4, 0.35, 0.3],
    "drop2": [1.0, 0.5, 0.5, 0.45, 0.4, 0.4, 0.35, 0.3, 0.3, 0.25],
    "drop3": [1.0, 0.4, 0.4, 0.35, 0.3, 0.3, 0.3, 0.25, 0.25, 0.2],
}
CAVITIES = ("cav-50-1", "cav-70-1", "cav-75-1")
BALANCE_CAVITIES = ("cav-50-1", "cav-67-1", "cav-70-1", "cav-70-2",
                    "cav-75-1", "cav-75-2")


@dataclasses.dataclass
class Setup:
    """What the model subcommands share: the config and the device."""
    reduced: bool = True
    device: Optional[str] = None
    backends: tuple = ("cuda",)
    steps: int = 120

    @property
    def cfg(self):
        return get_config("agcn-2s", reduced=self.reduced)

    @property
    def dev(self) -> torch.device:
        return resolve_device(self.device)


def emit(name: str, us: float, derived: str = "") -> None:
    ROWS.append({"name": name, "us_per_call": round(us, 1),
                 "derived": derived})
    print(f"{name},{us:.1f},{derived}")


def time_fn(fn: Callable, *args, warmup: int = 2, iters: int = 5) -> float:
    """Median µs of ``fn(*args)``, each call synchronised."""
    dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
    for _ in range(warmup):
        fn(*args)
    synchronize(dev)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        synchronize(dev)
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] * 1e6


def _clips(cfg, dev, batch: int = 16, seed: int = 0) -> torch.Tensor:
    data = make_batches(cfg, DataConfig(global_batch=batch, seq_len=0,
                                        seed=seed))
    return torch.as_tensor(next(data)["x"], device=dev)


# ---------------------------------------------------------------------------
# pruning (Fig. 8/9/10)
# ---------------------------------------------------------------------------

def compression_table() -> List[tuple]:
    """Compression ratio, graph-skip efficiency and parameter reduction of
    each Drop scheme × cavity pattern on the paper's channels.  The counts
    depend on the kept fractions only, so any weights give the same
    table; the spatial weights come from numpy seed 0, as in JAX."""
    rng = np.random.default_rng(0)
    cin, sw = 3, []
    for cout in PAPER_CHANNELS:
        sw.append(rng.standard_normal((3, cin, cout)).astype(np.float32))
        cin = cout
    rows = []
    for scheme, keeps in DROP_SCHEMES.items():
        for cav in CAVITIES:
            s = build_prune_plan(sw, PAPER_CHANNELS, keeps, cav).summary(
                PAPER_CHANNELS, 3)
            rows.append((scheme, cav, s))
            emit(f"pruning/{scheme}/{cav}", 0.0,
                 f"compress={s['compression_ratio']:.2f}x "
                 f"graphskip={s['graph_skip_efficiency'] * 100:.2f}% "
                 f"param_red={s['param_reduction'] * 100:.1f}%")
    return rows


def cavity_balance_table() -> Dict[str, dict]:
    """Balance of each cavity pattern (Fig. 10)."""
    out = {}
    for name in BALANCE_CAVITIES:
        b = out[name] = balance_stats(cavity_pattern(name))
        emit(f"cavity/{name}", 0.0,
             f"keep={b['keep_frac'] * 100:.1f}% pos_keeps="
             f"{b['per_position_min']}-{b['per_position_max']} "
             f"balanced={b['balanced']}")
    return out


def _demo_plan(cfg, params, keep: float, input_skip: int = 2):
    sw = [b["Wk"].detach().cpu().numpy() for b in params["blocks"]]
    fracs = [1.0] + [keep] * (len(cfg.gcn_channels) - 1)
    return build_prune_plan(sw, cfg.gcn_channels, fracs, "cav-70-1",
                            input_skip=input_skip)


def inference_speed(st: Setup) -> Dict[str, float]:
    """Dense against pruned (0.4 of the channels kept from block 1 on,
    cav-70-1, input skip 2) inference on each backend: µs a clip batch
    of 8 random clips."""
    cfg, dev = st.cfg, st.dev
    params = registry.init_params(cfg, seed=0, device=dev)
    x = torch.randn((8, cfg.gcn_frames, cfg.gcn_joints, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    plan = _demo_plan(cfg, params, 0.4)
    out = {}
    with torch.inference_mode():
        for backend in st.backends:
            dense = engine.build_execution_plan(params, cfg, None,
                                                backend=backend)
            pruned = engine.build_execution_plan(params, cfg, plan,
                                                 backend=backend)
            t_d = time_fn(engine.execute, dense, x)
            t_p = time_fn(engine.execute, pruned, x)
            out[backend] = t_d / t_p
            emit(f"pruning/infer_dense/{backend}", t_d, "")
            emit(f"pruning/infer_pruned/{backend}", t_p,
                 f"speedup={t_d / t_p:.2f}x")
    return out


def accuracy_comparison(st: Setup) -> tuple:
    """Fig. 8 proxy: train the model (input skip 1) from one init three
    ways through ``make_train_step`` — dense; with the hybrid plan (half
    the channels kept from block 1 on, cav-70-1) in the forward; with
    unstructured magnitude masks of the matched reduction, fixed from the
    init magnitudes — and compare top-1 on a held-out batch of the
    synthetic clips (relative behaviour, which is what Fig. 8 shows)."""
    cfg = dataclasses.replace(st.cfg, input_skip=1)
    dev = st.dev
    tcfg = TrainConfig(learning_rate=3e-3, total_steps=st.steps,
                       warmup_steps=10)
    test = next(make_batches(cfg, DataConfig(global_batch=16, seq_len=0)))
    tx = torch.as_tensor(test["x"], device=dev)
    ty = torch.as_tensor(test["labels"], device=dev)
    init = registry.init_params(cfg, seed=0, device=dev)
    sw = [b["Wk"].cpu().numpy() for b in init["blocks"]]
    fracs = [1.0] + [0.5] * (len(cfg.gcn_channels) - 1)
    plan = build_prune_plan(sw, cfg.gcn_channels, fracs, "cav-70-1")
    frac = 1 - 1 / plan.summary(cfg.gcn_channels, 3)["compression_ratio"]
    masks = [{k: torch.as_tensor(
        unstructured_prune(v.cpu().numpy(), frac) != 0, device=dev)
        for k, v in blk.items() if k in ("Wk", "tconv_w")}
        for blk in init["blocks"]]

    def project(params):
        return {**params, "blocks": [
            {k: v * masks[i][k] if k in masks[i] else v
             for k, v in blk.items()}
            for i, blk in enumerate(params["blocks"])]}

    def train(plan_=None, masked=False) -> float:
        def loss_fn(p, batch):
            logits = registry.gcn_logits(project(p) if masked else p,
                                         batch["x"], cfg, plan_)
            logz = torch.logsumexp(logits, -1)
            gold = torch.gather(logits, -1,
                                batch["labels"][:, None].long())[:, 0]
            loss = (logz - gold).mean()
            return loss, {"loss": loss}

        step = make_train_step(cfg, tcfg, loss_fn=loss_fn)
        params, opt = init, adamw.init(init)
        it = make_batches(cfg, DataConfig(global_batch=16, seq_len=0, seed=1))
        for _ in range(st.steps):
            b = {k: torch.as_tensor(v, device=dev)
                 for k, v in next(it).items()}
            params, opt, _ = step(params, opt, b)
        with torch.no_grad():
            logits = registry.gcn_logits(
                project(params) if masked else params, tx, cfg, plan_)
        return float((logits.argmax(-1) == ty).to(torch.float32).mean())

    acc = (train(), train(plan_=plan), train(masked=True))
    emit("pruning/accuracy", 0.0,
         f"dense={acc[0]:.3f} hybrid={acc[1]:.3f} unstructured={acc[2]:.3f} "
         f"(prune-aware training, {st.steps} steps, matched "
         f"{frac * 100:.0f}% reduction)")
    return acc


# ---------------------------------------------------------------------------
# RFC storage (Table III, Fig. 11) and dynamic scheduling (Table II)
# ---------------------------------------------------------------------------

def _sparsities(st: Setup) -> List[float]:
    cfg, dev = st.cfg, st.dev
    params = registry.init_params(cfg, seed=0, device=dev)
    return M.feature_sparsity_per_block(params, _clips(cfg, dev), cfg)


def rfc_storage(st: Setup) -> Dict[str, list]:
    """Per-block feature sparsity (reference plan), C3's storage counted on
    the int16 bits the ``cuda`` backend's encode writes between blocks,
    and the dense/CSC/RFC comparison on a synthetic ~65%-sparse tensor."""
    cfg, dev = st.cfg, st.dev
    params = registry.init_params(cfg, seed=0, device=dev)
    x = _clips(cfg, dev)
    sparsities = M.feature_sparsity_per_block(params, x, cfg)
    for b, s in enumerate(sparsities):
        emit(f"rfc/sparsity/block{b}", 0.0, f"sparsity={s * 100:.2f}%")
    plan = engine.build_execution_plan(params, cfg, None, backend="cuda")
    with torch.inference_mode():
        leaves = engine.rfc_boundaries(plan, x)
    costs = []
    for b, (vals, bits) in enumerate(leaves):
        if vals.shape[-1] % 16:      # the words would count the padding
            emit(f"rfc/storage/block{b}", 0.0,
                 f"C={vals.shape[-1]} is not a whole number of banks")
            continue
        c = storage_cost(bits)
        cats = expected_sparsity_categories(bits)
        costs.append((c, cats))
        emit(f"rfc/storage/block{b}", 0.0,
             f"sparsity={c['sparsity'] * 100:.2f}% "
             f"rfc_saves={c['rfc_vs_dense_reduction'] * 100:.2f}% "
             f"csc_saves={c['csc_vs_dense_reduction'] * 100:.2f}% "
             "I/II/III/IV=" + "/".join(f"{v * 100:.1f}%" for v in cats))
    h = torch.randn((2048, 64), generator=torch.Generator().manual_seed(2))
    _, hot = rfc_encode(torch.relu(h - 0.4).to(dev), apply_relu=False)
    cats = expected_sparsity_categories(hot)
    emit("rfc/categories", 0.0,
         "I/II/III/IV=" + "/".join(f"{c * 100:.1f}%" for c in cats))
    c = storage_cost(hot)
    emit("rfc/storage", 0.0,
         f"dense={c['dense_bits'] / 8e3:.1f}kB csc={c['csc_bits'] / 8e3:.1f}kB "
         f"rfc={c['rfc_bits'] / 8e3:.1f}kB "
         f"rfc_saves={c['rfc_vs_dense_reduction'] * 100:.2f}% "
         f"(paper: 35.93%)")
    return {"sparsity": sparsities, "boundaries": costs}


def dyn_sched(st: Setup, sparsities: Optional[List[float]] = None) -> dict:
    """Dyn-Mult-PE sizing per block from its feature sparsity, for the 4-
    and 6-weight queues of cav-70-1's 16-channel sub-filters (Fig. 6)."""
    if sparsities is None:
        sparsities = _sparsities(st)
    total_dsp = total_static = 0
    eff = 0.0
    for b, s in enumerate(sparsities):
        for w in (4, 6):
            rep = scheduling_report(w, s)
            total_dsp += rep["dsps"]
            total_static += w
            eff += rep["efficiency"]
            emit(f"dyn_sched/block{b}/w{w}", 0.0,
                 f"E(D)={rep['expected_valid']:.2f} dsps={rep['dsps']}/{w} "
                 f"eff={rep['efficiency'] * 100:.1f}% "
                 f"delayP={rep['delay_prob'] * 100:.2f}%")
    saving = 1 - total_dsp / total_static
    mean_eff = eff / (2 * len(sparsities))
    emit("dyn_sched/total", 0.0,
         f"dsp_saving={saving * 100:.2f}% (paper: 23.24%) "
         f"mean_eff={mean_eff * 100:.1f}% (paper: 75.38%)")
    return {"dsp_saving": saving, "mean_eff": mean_eff}


# ---------------------------------------------------------------------------
# C_k and backend ablation (Table I)
# ---------------------------------------------------------------------------

def agcn_ablation(st: Setup) -> None:
    """Forward time with and without the windowed C_k (reference plans),
    then dense and pruned+Q8.8 plans on each backend: µs a batch of 8
    random clips."""
    cfg, dev = st.cfg, st.dev
    x = torch.randn((8, cfg.gcn_frames, cfg.gcn_joints, 3),
                    generator=torch.Generator().manual_seed(1)).to(dev)
    cfg_ck = dataclasses.replace(cfg, use_ck=True)
    p_ck = registry.init_params(cfg_ck, seed=0, device=dev)
    p = registry.init_params(cfg, seed=0, device=dev)
    with torch.inference_mode():
        t_with = time_fn(engine.execute, engine.build_execution_plan(
            p_ck, cfg_ck, None), x)
        t_without = time_fn(engine.execute, engine.build_execution_plan(
            p, cfg, None), x)
        emit("ablation/with_ck", t_with, "")
        emit("ablation/without_ck", t_without,
             f"speedup={t_with / t_without:.2f}x")
        prune = _demo_plan(cfg, p, 0.5)
        for backend in st.backends:
            for label, plan_, quant in (("dense", None, False),
                                        ("pruned_q", prune, True)):
                ep = engine.build_execution_plan(p, cfg, plan_, quant=quant,
                                                 backend=backend)
                t = time_fn(engine.execute, ep, x, iters=3)
                emit(f"ablation/backend_{backend}_{label}", t,
                     f"clips_per_s={x.shape[0] / (t * 1e-6):.1f}")


SUBCOMMANDS = {
    "compression": lambda st: compression_table(),
    "cavity": lambda st: cavity_balance_table(),
    "rfc_storage": rfc_storage,
    "dyn_sched": dyn_sched,
    "inference": inference_speed,
    "accuracy": accuracy_comparison,
    "agcn_ablation": agcn_ablation,
}
GROUPS = {
    "pruning_bench": ("compression", "cavity", "inference", "accuracy"),
    "all": tuple(SUBCOMMANDS),
}


def write_rows(path: str) -> None:
    """Merge this run's rows into ``path`` by name."""
    p = pathlib.Path(path)
    old = json.loads(p.read_text()) if p.exists() else []
    mine = {r["name"] for r in ROWS}
    p.write_text(json.dumps([r for r in old if r["name"] not in mine] + ROWS,
                            indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("commands", nargs="+",
                    choices=(*SUBCOMMANDS, *GROUPS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", default="both",
                    choices=("cuda", "reference", "both"))
    ap.add_argument("--steps", type=int, default=120,
                    help="training steps of each accuracy run")
    ap.add_argument("--out", default="BENCH_torch_paper.json")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    st = Setup(reduced=args.reduced, device=args.device, steps=args.steps,
               backends=(("cuda", "reference") if args.backend == "both"
                         else (args.backend,)))
    names = []
    for c in args.commands:
        names += [n for n in GROUPS.get(c, (c,)) if n not in names]
    print("name,us_per_call,derived")
    for n in names:
        SUBCOMMANDS[n](st)
    write_rows(args.out)


if __name__ == "__main__":
    main()
