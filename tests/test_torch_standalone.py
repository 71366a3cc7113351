"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor the
JAX package ``repro``, and its entry points default to the GPU without
falling back to the CPU quietly."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

# conftest.py imports jax in this process, so the import check runs in a
# fresh interpreter where jax and repro cannot be imported at all
_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
sys.path.insert(0, sys.argv[1])
import chip_smoke
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(len(names), bad)
"""


def test_imports_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT)],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 21 and bad.strip() == "[]"


# the modules of the topology, CSR and C_k paths run end to end on the CPU
# in an interpreter where jax and repro cannot be imported
_RUN_NEW_PATHS = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import dataclasses
import torch
from repro_torch.configs import get_config
from repro_torch.core.agcn import adaptive, engine, graph, model
from repro_torch.kernels import graph_sconv, ops, window_sim
tp = graph.get_topology("ntu50")
idx, val = map(torch.from_numpy, ops.pack_csr_ell(tp.indptr, tp.indices,
                                                  tp.values, 50))
x = torch.randn(1, 2, 50, 3)
w = torch.randn(3, 3, 4)
assert ops.graph_sconv_csr(x, idx, val, w).shape == (1, 2, 50, 4)
ring = torch.randn(2, 9, 50, 4)
ck = ops.windowed_similarity(ring, ring, valid_joints=25)
torch.testing.assert_close(ck, adaptive.windowed_ck(ring.sum(1),
                                                    ring.sum(1), 25))
assert window_sim.windowed_similarity_plain(ring, ring, 50).shape == (2, 50, 50)
cfg = dataclasses.replace(get_config("agcn-2s", reduced=True), use_ck=True,
                          gcn_joints=21)
p = model.init_params(cfg, seed=0, device="cpu")
plan = engine.build_execution_plan(p, cfg, topology="hand21", pad_joints=25,
                                   backend="cuda")
st = engine.init_stream_state(plan, 1, x_calib=torch.randn(1, 32, 21, 3))
st, logits = engine.step_frame(plan, st, torch.randn(1, 25, 3))
assert logits.shape == (1, cfg.gcn_num_classes)
assert "ck_th" in st.blocks[0] and graph_sconv.graph_sconv_csr_plain
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(bad)
"""


def test_topology_csr_and_ck_paths_run_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN_NEW_PATHS], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the dense LM decode path (both backends, a wrapping SWA ring) runs on the
# CPU in an interpreter where jax and repro cannot be imported
_RUN_LM_PATH = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.launch.serve import generate
for arch in ("smollm-360m", "h2o-danube-1.8b"):
    toks = [generate(arch, batch=2, prompt_len=4, gen=16, backend=b,
                     device="cpu")["tokens"] for b in ("cuda", "reference")]
    assert toks[0].shape == (2, 20) and (toks[0] == toks[1]).all()
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(bad)
"""


def test_lm_decode_path_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN_LM_PATH], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the serving host layer, GcnService and the sessions CLI run on the CPU in
# an interpreter where jax and repro cannot be imported: a golden replay
# cell reproduces its digest, and the CLI replays the smoke trace
_RUN_SERVING = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
import repro_torch.serving as serving
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan
from repro_torch.launch import serve
root, bench = sys.argv[1], sys.argv[2]
cfg = get_config("agcn-2s", reduced=True)
golden = json.load(open(root + "/tests/data/traces/golden_smoke.json"))
trace = serving.Trace.load(root + "/tests/data/traces/smoke.json")
p = model.init_params(cfg, seed=0, device="cpu")
pp = build_prune_plan([b["Wk"].numpy() for b in p["blocks"]],
                      cfg.gcn_channels, [1.0, 0.5, 0.5, 0.5], "cav-70-1",
                      input_skip=2)
plan = engine.build_execution_plan(p, cfg, pp, quant=True, backend="cuda")
bn = engine.collect_bn_stats(plan, torch.randn(2, cfg.gcn_frames, 25, 3))
out = serving.replay(cfg, trace, qos="fifo", capacity_tiers=(2, 4),
                     plans=(plan,), bn_stats=(bn,), record_outcomes=True,
                     device="cpu")
assert (serving.outcome_digest(out["outcomes"])
        == golden["cells"]["fifo/demand"]["outcome_digest"])
serve.main(["sessions", "--arch", "agcn-2s", "--reduced", "--device", "cpu",
            "--backend", "reference", "--trace",
            root + "/tests/data/traces/smoke.json", "--bench", bench])
assert json.load(open(bench))[0]["sessions"] == 14
if not torch.cuda.is_available():
    try:
        serving.GcnService(cfg)
        raise SystemExit("GcnService(device=None) ran without CUDA")
    except RuntimeError as e:
        assert "CUDA is not available" in str(e)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(bad)
"""


def test_serving_and_sessions_cli_run_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN_SERVING, str(ROOT),
                          str(tmp_path / "bench.json")], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the distributed serving tier runs on the CPU in an interpreter where jax
# and repro cannot be imported: a 2-shard service replays a golden cell to
# its digest, a 2-replica router serves a generated load, and the mesh
# asks for cards that are not there
_RUN_DISTRIBUTED = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
import repro_torch.distributed as dist
import repro_torch.serving as serving
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.pruning.plan import build_prune_plan
root = sys.argv[1]
cfg = get_config("agcn-2s", reduced=True)
golden = json.load(open(root + "/tests/data/traces/golden_smoke.json"))
trace = serving.Trace.load(root + "/tests/data/traces/smoke.json")
p = model.init_params(cfg, seed=0, device="cpu")
pp = build_prune_plan([b["Wk"].numpy() for b in p["blocks"]],
                      cfg.gcn_channels, [1.0, 0.5, 0.5, 0.5], "cav-70-1",
                      input_skip=2)
plan = engine.build_execution_plan(p, cfg, pp, quant=True, backend="cuda")
bn = engine.collect_bn_stats(plan, torch.randn(2, cfg.gcn_frames, 25, 3))
svc = serving.GcnService(cfg, plans=(plan,), bn_stats=(bn,),
                         capacity_tiers=(2, 4), record_outcomes=True,
                         mesh=dist.make_batch_mesh(2, device="cpu"),
                         device="cpu")
for r in serving.trace_requests(trace, 25, 3):
    while svc.now < r.arrival:
        if svc.idle():
            svc.advance_clock(r.arrival)
        else:
            svc.tick()
    svc.submit_clip(svc.open_session(priority=r.priority,
                                     arrival=r.arrival), r.clip)
svc.run_until_idle()
assert (serving.outcome_digest(svc.outcomes)
        == golden["cells"]["fifo/demand"]["outcome_digest"])
row = dist.run_routed_sessions(cfg, replicas=2, slots=2, n_sessions=4,
                               lengths=(6,), mean_interarrival=2.0,
                               device="cpu")
assert row["sessions"] == 4 and row["replicas"] == 2
if not torch.cuda.is_available():
    try:
        dist.make_batch_mesh(2)
        raise SystemExit("a 2-card mesh was built without CUDA")
    except RuntimeError as e:
        assert "device_count" in str(e)
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(bad)
"""


def test_distributed_serving_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN_DISTRIBUTED, str(ROOT)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the offline path runs on the CPU in an interpreter where jax and repro
# cannot be imported: one reduced train step, the accounting modules, the
# RFC-checkpointed MLP, a checkpoint round trip, and the table subcommands
# of benchmarks/torch_paper.py
_RUN_TRAIN = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.checkpoint import store
from repro_torch.common import tree
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core.agcn import engine, model
from repro_torch.core.rfc import checkpoint, format
from repro_torch.core.sched import expectation
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.fault import monitor
from repro_torch.launch import train
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step
from benchmarks import torch_paper
cfg = get_config("agcn-2s", reduced=True)
p = registry.init_params(cfg, seed=0, device="cpu")
b = {k: torch.as_tensor(v) for k, v in
     next(make_batches(cfg, DataConfig(4, 0))).items()}
p2, o2, m = make_train_step(cfg, TrainConfig(microbatches=2))(
    p, adamw.init(p), b)
assert torch.isfinite(m["loss"]) and int(o2.step) == 1
assert tree.param_count(p2) == tree.param_count(p)
store.save(sys.argv[2], 1, o2)
back = store.restore(sys.argv[2], 1, adamw.init(p))
assert all(torch.equal(a, c) for a, c in zip(tree.tree_leaves(back),
                                             tree.tree_leaves(o2)))
x = torch.randn(6, 8, requires_grad=True)
checkpoint.mlp_relu2_rfc(x, torch.randn(8, 32), torch.randn(32, 4)).sum(
    ).backward()
assert x.grad is not None
s = model.feature_sparsity_per_block(p, b["x"], cfg)
assert expectation.scheduling_report(6, s[0])["dsps"] >= 1
torch_paper.main(["compression", "cavity", "rfc_storage", "dyn_sched",
                  "--reduced", "--device", "cpu", "--out", sys.argv[3]])
rows = {r["name"] for r in json.load(open(sys.argv[3]))}
assert {"pruning/drop1/cav-70-1", "cavity/cav-70-2", "rfc/storage",
        "dyn_sched/total"} <= rows, rows
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(bad)
"""


def test_train_path_and_paper_benches_run_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN_TRAIN, str(ROOT),
                          str(tmp_path / "ckpt"), str(tmp_path / "b.json")],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the MoE and VLM decoders, LM training, the sharding rules and the elastic
# planner run on the CPU in an interpreter where jax and repro cannot be
# imported, and so does a 2-rank gloo data-parallel step of the MoE config
_RUN_LM_TRAIN = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
import torch
import torch_dist_workers as W
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.distributed import params, sharding
from repro_torch.fault import elastic
from repro_torch.launch.serve import generate
from repro_torch.launch.train import train_loop
from repro_torch.models import registry
from repro_torch.models.layers.moe import moe_ffn
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step
for arch in ("granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
             "llava-next-mistral-7b"):
    cfg = get_config(arch, reduced=True)
    p = registry.init_params(cfg, seed=0, device="cpu")
    b = {k: torch.as_tensor(v) for k, v in next(make_batches(
        cfg, DataConfig(4, 16 + cfg.num_image_tokens))).items()}
    p2, o2, m = make_train_step(cfg, TrainConfig(microbatches=2))(
        p, adamw.init(p), b)
    assert torch.isfinite(m["loss"]) and int(o2.step) == 1
    toks = [generate(arch, batch=2, prompt_len=3, gen=4, backend=be,
                     device="cpu", params=p)["tokens"]
            for be in ("cuda", "reference")]
    assert (toks[0] == toks[1]).all()
    full = get_config(arch)
    specs = params.param_specs(registry.init_params(full, device="meta"),
                               W.FakeMesh({"data": 16, "model": 16}),
                               expert_dim=full.padded_experts or None)
    assert len(specs["layers"]["attn"]["wq"]) == 4
_, losses = train_loop("granite-moe-3b-a800m", TrainConfig(
    total_steps=2, checkpoint_every=0), batch=2, seq=16, device="cpu",
    resume=False)
assert len(losses) == 2
assert elastic.plan_degraded_mesh(8, model=1, old_data=16).data == 8
res = W.smoke(2, 2, sys.argv[2])
assert res["loss_gap"] <= 1e-5 and res["param_gap"] <= 1e-5, res
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(bad)
"""


def test_lm_families_training_and_distribution_run_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN_LM_TRAIN,
                          str(ROOT / "tests"), str(tmp_path)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the SSM, hybrid and audio families and gemma3's local:global stack run
# on the CPU where jax and repro cannot be imported: generate on both
# backends (equal tokens), a train step, a few launch.train steps with the
# serve CLI, and the port's serve example
_RUN_ZOO = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
from repro_torch.common.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batches
from repro_torch.launch import serve, train
from repro_torch.models import registry
from repro_torch.optim import adamw
from repro_torch.train.steps import make_train_step
for arch in ("xlstm-1.3b", "zamba2-7b", "whisper-small", "gemma3-12b"):
    cfg = get_config(arch, reduced=True)
    p = registry.init_params(cfg, seed=0, device="cpu")
    toks = [serve.generate(arch, batch=2, prompt_len=4, gen=8, backend=b,
                           device="cpu", params=p)["tokens"]
            for b in ("cuda", "reference")]
    assert toks[0].shape == (2, 12) and (toks[0] == toks[1]).all(), arch
    b = {k: torch.as_tensor(v) for k, v in next(make_batches(
        cfg, DataConfig(2, 16))).items()}
    p2, _, m = make_train_step(cfg, TrainConfig())(p, adamw.init(p), b)
    assert np.isfinite(float(m["loss"])), arch
train.main(["--arch", "whisper-small", "--reduced", "--steps", "2",
            "--batch", "2", "--seq", "16", "--device", "cpu", "--ckpt-dir",
            sys.argv[1]])
serve.main(["lm", "--arch", "zamba2-7b", "--reduced", "--batch", "2",
            "--prompt-len", "3", "--gen", "3", "--device", "cpu",
            "--backend", "both"])
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(bad)
"""


def test_ssm_hybrid_audio_and_local_global_run_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN_ZOO, str(tmp_path)],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "token agreement: 100.0%" in out.stdout
    assert out.stdout.strip().splitlines()[-1] == "[]"


# the analysis tools (the dry run's cells, the op counter, the roofline,
# the H100 meshes), bf16 caches, the sessions shim and the graph and MLP
# helpers run in an interpreter where jax and repro cannot be imported
_RUN_ANALYSIS = r"""
import sys, warnings
sys.modules["jax"] = None
sys.modules["repro"] = None
import pathlib
import torch
from repro_torch.configs import get_config
from repro_torch.core.agcn import graph
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import dryrun, mesh, op_cost, roofline, sessions
from repro_torch.models import registry
from repro_torch.models.layers import common, mlp
out = pathlib.Path(sys.argv[1])
rec = dryrun.run_cell("agcn-2s", "gcn_infer", True, out, verbose=False)
kv_seq = dryrun.run_cell("xlstm-1.3b", "long_500k", True, out, verbose=False)
print(rec["status"], rec["mesh"], kv_seq["status"])
cfg = get_config("zamba2-7b", reduced=True)
cache = registry.init_cache(cfg, 2, 8, device="cpu", dtype=torch.bfloat16)
print(sorted({str(t.dtype) for t in (cache["groups"]["attn"]["k"],
                                      cache["groups"]["mamba"]["conv"],
                                      cache["groups"]["mamba"]["ssm"])}))
q = torch.randn(1, 1, 2, 16)
k = torch.randn(1, 8, 1, 16).bfloat16()
with op_cost.OpCost() as c:
    fd.flash_decode(q, k, k, 8)
print(c.analyze()["kernels"]["flash_decode"]["calls"],
      roofline.roofline_terms(c.analyze(), 1.0, 1)["dominant"])
with warnings.catch_warnings(record=True) as w:
    warnings.simplefilter("always")
    sessions.run_sessions
print(w[0].category.__name__, graph.static_graph().shape[0],
      mlp.prune_mlp_channels({"wi": torch.ones(4, 8), "wg": torch.ones(4, 8),
                              "wo": torch.ones(8, 4)}, 0.5).numel(),
      common.lecun_init(None, (2, 3), 2).shape[0])
bad = sorted(m for m, mod in sys.modules.items() if mod is not None
             and (m in ("jax", "repro") or m.startswith(("jax.", "repro."))))
print(bad)
"""


def test_analysis_tools_and_bf16_caches_run_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _RUN_ANALYSIS,
                          str(tmp_path)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines() == [
        "ok h100x8 ok", "['torch.bfloat16', 'torch.float32']",
        "1 memory", "DeprecationWarning 3 4 2", "[]"]


# the card's kernel tests are collected where there is no JAX: the module
# imports in an interpreter where jax and repro cannot be imported
_IMPORT_CARD_TESTS = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
sys.path.insert(0, sys.argv[1])
import test_torch_cuda_kernels as m
tests = [n for n in dir(m) if n.startswith("test_")]
bad = sorted(k for k, mod in sys.modules.items() if mod is not None
             and (k in ("jax", "repro") or k.startswith(("jax.", "repro."))))
print(len(tests), bad)
"""


def test_card_kernel_tests_import_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_CARD_TESTS,
                          str(ROOT / "tests")], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 7 and bad.strip() == "[]"


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                        r"from\s+(jax|repro)(\.|\s)(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PKG.rglob("*.py")]
    + [Path("chip_smoke.py"), Path("benchmarks/torch_paper.py"),
       Path("tests/torch_dist_workers.py"),
       Path("examples/torch_train_lm.py"),
       Path("examples/torch_elastic_restart.py"),
       Path("examples/torch_serve_lm.py")]), ids=str)
def test_source_names_no_jax_or_repro_import(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text())


def test_entry_points_default_to_cuda():
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.agcn.model import init_params
    from repro_torch.launch.serve import serve_gcn, serve_gcn_stream
    from repro_torch.common.config import TrainConfig
    from repro_torch.launch.train import train_loop
    from repro_torch.serving import run_sessions

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    cfg = get_config("agcn-2s", reduced=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gcn("agcn-2s", reduced=True, clips=1, batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_gcn_stream("agcn-2s", reduced=True, batch=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": [1.0]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_sessions(cfg, slots=1, n_sessions=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_loop("agcn-2s", TrainConfig(total_steps=1), resume=False)
    import importlib
    sys.path.insert(0, str(ROOT))
    try:
        torch_paper = importlib.import_module("benchmarks.torch_paper")
    finally:
        sys.path.remove(str(ROOT))
    for cmd in ("rfc_storage", "accuracy", "agcn_ablation"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            torch_paper.main([cmd, "--reduced"])
    assert init_params(cfg, device="cpu")["fc_w"].device.type == "cpu"
