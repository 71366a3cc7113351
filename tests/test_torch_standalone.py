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


_FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|"
                        r"from\s+(jax|repro)(\.|\s)(?!_))", re.M)


@pytest.mark.parametrize("path", sorted(
    [p.relative_to(ROOT) for p in PKG.rglob("*.py")]
    + [Path("chip_smoke.py")]), ids=str)
def test_source_names_no_jax_or_repro_import(path):
    assert not _FORBIDDEN.findall((ROOT / path).read_text())


def test_entry_points_default_to_cuda():
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.core.agcn.model import init_params
    from repro_torch.launch.serve import serve_gcn, serve_gcn_stream

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
    assert init_params(cfg, device="cpu")["fc_w"].device.type == "cpu"
