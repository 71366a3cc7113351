"""The port's benches (``benchmarks/torch_*.py``) and its docs gates
(``tools/torch_check_*.py``) on the CPU at the reduced config: the
analytic accounting, the benches' pruning plan and the CSR sweep's graphs
against the JAX benches', every bench's row names in smoke mode, the
roofline report on synthetic dry-run records, and the harness."""
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as jcommon  # noqa: E402
from benchmarks import throughput as jthroughput  # noqa: E402
from benchmarks import torch_common as common  # noqa: E402
from benchmarks import torch_kernels_bench as kb  # noqa: E402
from benchmarks import torch_roofline_report as rr  # noqa: E402
from benchmarks import torch_run  # noqa: E402
from benchmarks import torch_throughput as tt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.agcn.graph import dense_to_csr as jdense_to_csr  # noqa: E402
from repro.core.agcn.graph import get_topology as jget_topology  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.common.tree import tree_map  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.agcn.model import init_params  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture
def smoke():
    """Smoke mode for the test's duration, with the rows drained, on one
    intra-op thread: the benches' many small ops slow down several-fold
    when the test workers' thread pools contend for the cores."""
    common.drain_rows()
    common.SMOKE = True
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
        common.SMOKE = False
        common.drain_rows()


@pytest.mark.parametrize("kw", [
    *tt.VARIANTS.values(),
    dict(kv=2, V=50, T=64, persons=1),
    dict(use_ck=True, input_skip=3, keep=tt.DROP1[::-1], cav_keep=0.5),
    dict(V=21, T=120, use_ck=False, keep=[0.5] * 10),
], ids=[*tt.VARIANTS, "kv2-v50", "ck-skip3", "v21-keep"])
def test_agcn_gops_equals_jax(kw):
    assert tt.agcn_gops(**kw) == jthroughput.agcn_gops(**kw)


def test_paper_figures_equal_jax_and_rows_name_their_hardware(smoke):
    assert tt.PAPER == jthroughput.PAPER
    gops = tt.analytic_rows()
    assert gops == {k: jthroughput.agcn_gops(**v)
                    for k, v in tt.VARIANTS.items()}
    rows = {r["name"]: r["derived"] for r in common.drain_rows()}
    assert {f"throughput/gop/{v}" for v in tt.VARIANTS} <= set(rows)
    for key in ("2080ti_fps", "v100_fps", "2080ti_woC", "v100_woC",
                "2080ti_skip", "v100_skip"):
        d = rows[f"throughput/paper/{key}"]
        assert "different hardware" in d and "XCKU-115 FPGA" in d
    assert not any("TPU" in n or "TPU" in d for n, d in rows.items())


def test_demo_prune_plan_equals_jax():
    """Both planners on one set of weights: a numpy tree in the JAX
    layout for JAX's, carried across by ``repro_torch.bridge`` for the
    port's (JAX's planner reads its weights through ``np.asarray``)."""
    cfg = get_config("agcn-2s", reduced=True)
    tree = tree_map(lambda t: t.numpy(), init_params(cfg, seed=0,
                                                     device="cpu"))
    want = jcommon.demo_prune_plan(jax_get_config("agcn-2s", reduced=True),
                                   tree)
    got = common.demo_prune_plan(cfg, params_from_numpy(tree, device="cpu"))
    assert (got.input_skip, got.cavity_name) == (want.input_skip,
                                                 want.cavity_name)
    assert any(len(b.kept_in) < b._cin for b in got.blocks)
    for g, w in zip(got.blocks, want.blocks, strict=True):
        assert tuple(g.kept_in) == tuple(w.kept_in)
        assert tuple(g.kept_filters) == tuple(w.kept_filters)
        np.testing.assert_array_equal(g.tap_mask, w.tap_mask)


def _jax_sweep():
    """The JAX bench's CSR-sweep draws, as ``kernels_bench.main`` makes
    them (``Cin = Cout = 16``, ``N, T = 2, 16``, seed 7)."""
    rng = np.random.default_rng(7)
    for tname in ("ntu25", "ntu50"):
        topo = jget_topology(tname)
        V, K = topo.num_joints, topo.num_subsets
        w = rng.standard_normal((K, 16, 16))
        x = rng.standard_normal((2, 16, V, 16))
        sweeps = [(f"d{int(round(topo.density * 100)):02d}", topo.adjacency)]
        for target in (0.25, 0.50):
            mask = rng.random((K, V, V)) < target
            sweeps.append((f"d{int(target * 100):02d}",
                           (rng.standard_normal((K, V, V)) * mask)
                           .astype(np.float32)))
        yield tname, V, w, x, sweeps


def test_csr_sweep_graphs_densities_and_ell_equal_jax():
    got = list(kb.csr_sweep_graphs())
    want = list(_jax_sweep())
    assert [g[:2] for g in got] == [w[:2] for w in want]
    for (_, V, w_t, x_t, sw_t), (_, _, w_j, x_j, sw_j) in zip(got, want):
        np.testing.assert_array_equal(w_t, w_j.astype(np.float32))
        np.testing.assert_array_equal(x_t, x_j.astype(np.float32))
        assert [t for t, _ in sw_t] == [t for t, _ in sw_j]
        for (_, g_t), (_, g_j) in zip(sw_t, sw_j):
            np.testing.assert_array_equal(g_t, g_j)
            dens, csr, (idx, val) = kb.csr_pack(g_t)
            assert dens == float((np.abs(g_j) > 0).mean())
            jcsr = jdense_to_csr(g_j)
            for a, b in zip(csr, jcsr):
                np.testing.assert_array_equal(a, np.asarray(b))
            jidx, jval = jops.pack_csr_ell(*jcsr, -(-V // 8) * 8)
            np.testing.assert_array_equal(idx, np.asarray(jidx))
            np.testing.assert_array_equal(val, np.asarray(jval))
            assert idx.shape[-1] == np.asarray(jidx).shape[-1]   # ell_deg


def test_kernels_bench_emits_its_rows(smoke):
    kb.main(["--reduced", "--device", "cpu", "--backend", "both"])
    rows = common.drain_rows()
    assert [r["name"] for r in rows] == kb.row_names(("reference", "cuda"))
    d = {r["name"]: r["derived"] for r in rows}
    assert "ell_deg=" in d["kernels/sconv_csr/ntu50/d50/csr_cuda"]
    assert "(cpu)" in d["kernels/sconv_csr/ntu25/crossover"]


def test_throughput_table4_rows_counted_and_finite(smoke):
    out = tt.table4(CPU, reduced=True, backends=("reference",))
    rows = common.drain_rows()
    assert [r["name"] for r in rows] == tt.table4_names(("reference",))
    assert [(r["variant"], r["batch"]) for r in out] == [
        (v, b) for v in tt.VARIANTS for b in tt.TABLE4_BATCHES]
    for r in out:
        for k in ("fps_stream", "fps_ensemble", "bound_ms",
                  "counted_flops", "counted_bytes", "model_bytes",
                  "model_bound_ms", "eager_share", "model_share"):
            assert np.isfinite(r[k]) and r[k] > 0, (r, k)
        # the model's minimal bytes lie under the eager step's count
        assert r["model_bytes"] < r["counted_bytes"], r
        assert r["rows"] == r["batch"] * get_config(
            "agcn-2s", reduced=True).gcn_persons
    by = {(r["variant"], r["batch"]): r for r in out}
    # the reduction chain shows in the counted FLOPs too
    assert (by["original", 16]["counted_flops"]
            > by["woC", 16]["counted_flops"]
            > by["woC+skip", 16]["counted_flops"]
            > by["woC+skip+prune", 16]["counted_flops"])


def test_variant_configs():
    cfg = get_config("agcn-2s")
    vc, prune, quant = tt.variant_config(cfg, "original")
    assert (vc.use_ck, vc.input_skip, prune, quant) == (True, 1, None, False)
    vc, prune, quant = tt.variant_config(cfg, "woC+skip")
    assert (vc.use_ck, vc.input_skip, prune) == (False, 2, None)
    vc, prune, quant = tt.variant_config(cfg, "woC+skip+prune")
    assert quant and prune.input_skip == 2 and prune.cavity_name == "cav-70-1"
    assert vc.prune_channel_fracs == tuple(tt.DROP1)


def test_throughput_axes_emit_their_rows(smoke):
    tt.measured_axes(CPU, reduced=True, backends=("reference",))
    names = [r["name"] for r in common.drain_rows()]
    assert names == tt.axis_names(("reference",), smoke=True)
    assert any(n.endswith("smoke-v1-head2/slo") for n in names)


def test_entry_points_default_to_cuda():
    for main in (tt.main, kb.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main(["--reduced"])


def _record(arch, shape, mesh, frac, dominant="memory"):
    return {"cell": f"{arch}__{shape}__{mesh}", "status": "ok",
            "arch": arch, "shape": shape, "mesh": mesh, "chips": 1,
            "memory": {"peak_bytes": 2 ** 30, "fits_hbm": True},
            "roofline": {"dominant": dominant, "t_compute_s": 1e-3,
                         "t_memory_s": 2e-3, "t_collective_s": 0.0,
                         "useful_flop_ratio": 0.5,
                         "roofline_fraction": frac}}


@pytest.fixture
def dryrun_dirs(tmp_path):
    recs, base = tmp_path / "dry", tmp_path / "base"
    recs.mkdir()
    base.mkdir()
    cells = [_record("agcn-2s", "gcn_infer", "h100x1", 0.1),
             _record("agcn-2s", "gcn_infer", "h100x8", 0.2),
             _record("smollm-360m", "decode_32k", "h100x8m4", 0.3),
             {"cell": "smollm-360m__long_500k__h100x1", "status": "skipped",
              "reason": "full attention"},
             {"cell": "xlstm-1.3b__train_4k__h100x8", "status": "error",
              "error": "RuntimeError('boom')"}]
    for c in cells:
        (recs / f"{c['cell']}.json").write_text(json.dumps(c))
    old = _record("agcn-2s", "gcn_infer", "h100x8", 0.1)
    (base / f"{old['cell']}.json").write_text(json.dumps(old))
    return recs, base


def test_roofline_report_tables_skips_and_baseline(tmp_path, dryrun_dirs,
                                                   smoke):
    recs, base = dryrun_dirs
    out = tmp_path / "roof.md"
    rr.main(["--dryrun-dir", str(recs), "--baseline-dir", str(base),
             "--out", str(out)])
    rows = {r["name"]: r["derived"] for r in common.drain_rows()}
    assert rows["roofline/cells_ok"].startswith(
        "h100x1=1 h100x8=1 h100x8m4=1 skipped=1 errors=1")
    assert {"roofline/h100x1/agcn-2s/gcn_infer",
            "roofline/h100x8/agcn-2s/gcn_infer",
            "roofline/h100x8m4/smollm-360m/decode_32k"} <= set(rows)
    text = out.read_text()
    sections = text.split("## ")
    h1, h8, m4 = (next(s for s in sections if s.startswith(m + " "))
                  for m in ("h100x1", "h100x8", "h100x8m4"))
    assert "| 0.1000 |" in h1 and "| 0.2000 |" in h8 and "| 0.3000 |" in m4
    assert "smollm" not in h1 and "smollm" not in h8
    assert "long_500k__h100x1 (full attention)" in text
    assert "train_4k__h100x8 (error: RuntimeError('boom'))" in text
    assert "| agcn-2s__gcn_infer__h100x8 | 0.1000 | 0.2000 | 2.00x |" in text


def test_run_writes_its_bench_file_and_error_rows_exit_1(tmp_path,
                                                         dryrun_dirs,
                                                         monkeypatch):
    recs, _ = dryrun_dirs
    args = ["--only", "roofline_report", "--out-dir", str(tmp_path),
            "--dryrun-dir", str(recs), "--out", str(tmp_path / "r.md")]
    assert torch_run.main(args) == 0
    rows = json.loads((tmp_path / "BENCH_torch_roofline_report.json")
                      .read_text())
    assert rows[0]["name"] == "roofline/cells_ok"
    assert sorted(p.name for p in tmp_path.glob("BENCH_*.json")) == [
        "BENCH_torch_roofline_report.json"]

    def boom(argv):
        raise RuntimeError("boom")

    monkeypatch.setattr(rr, "main", boom)
    assert torch_run.main(args) == 1
    rows = json.loads((tmp_path / "BENCH_torch_roofline_report.json")
                      .read_text())
    assert [r["name"] for r in rows] == ["roofline_report/ERROR"]
    common.drain_rows()


def test_run_paper_module_smoke(tmp_path, smoke):
    assert torch_run.main(["--only", "dyn_sched", "--smoke", "--reduced",
                           "--device", "cpu", "--out-dir",
                           str(tmp_path)]) == 0
    rows = json.loads((tmp_path / "BENCH_torch_dyn_sched.json").read_text())
    assert rows[-1]["name"] == "dyn_sched/total"


@pytest.mark.parametrize("tool,line", [
    ("torch_check_docs", "docstring coverage 300/300 (100.0%)"),
    ("torch_check_api", "api: surface matches docs/torch_api_surface.txt")])
def test_docs_gates_pass(tool, line, capsys):
    ns = runpy.run_path(str(ROOT / "tools" / f"{tool}.py"))
    assert ns["main"]([]) == 0 if tool == "torch_check_api" \
        else ns["main"]() == 0
    assert line in capsys.readouterr().out
