"""The port's examples run on the CPU at reduced size, each in a fresh
interpreter where jax and repro cannot be imported:
``examples/torch_train_lm.py`` (train, checkpoint, resume) for a dense, an
MoE and a VLM config, ``examples/torch_elastic_restart.py`` (4 gloo
ranks, a checkpoint, 2 survivors resharded onto a data = 2 mesh) and
``examples/torch_serve_lm.py`` (the dense, MoE, SSM and hybrid families
served)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_NO_JAX = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
script = sys.argv[1]
sys.argv = sys.argv[1:]
runpy.run_path(script, run_name="__main__")
"""


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-c", _NO_JAX, *args], env=env,
                          capture_output=True, text=True, timeout=timeout,
                          cwd=ROOT)


@pytest.mark.parametrize("arch", ["smollm-360m", "granite-moe-3b-a800m",
                                  "llava-next-mistral-7b"])
def test_torch_train_lm_example(arch, tmp_path):
    out = _run([str(ROOT / "examples" / "torch_train_lm.py"), "--arch", arch,
                "--steps", "6", "--seq", "32", "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "ckpt")], timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "phase 1: loss" in out.stdout
    assert "[resume] from step 6" in out.stdout
    assert "phase 2 (resumed): 1 more steps" in out.stdout


def test_torch_elastic_restart_example():
    out = _run([str(ROOT / "examples" / "torch_elastic_restart.py"),
                "--steps", "2"], timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "4 ranks, data = 4" in out.stdout
    assert "dead ranks [2, 3]: new mesh data=2 model=1" in out.stdout
    assert "2 ranks after the restore" in out.stdout
    assert "(optimizer step 4)" in out.stdout


def test_torch_serve_lm_example():
    out = _run([str(ROOT / "examples" / "torch_serve_lm.py"), "--device",
                "cpu"], timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == [
        "smollm-360m", "qwen3-moe-30b-a3b", "xlstm-1.3b", "zamba2-7b"]
    assert all("32 tokens/seq" in ln for ln in lines)


def test_torch_quickstart_example():
    """The paper's pipeline at the reduced 2s-AGCN: a few train steps, the
    Drop scheme, the cav-70-1 prune plan, quantised inference on the cuda
    backend (its plain versions here) and the RFC storage it writes."""
    out = _run([str(ROOT / "examples" / "torch_quickstart.py"), "--device",
                "cpu", "--steps", "6"], timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "trained: loss" in out.stdout
    assert "per-block sparsity:" in out.stdout
    assert "compression" in out.stdout and "graph-skip" in out.stdout
    assert "pruned+quantised accuracy on batch:" in out.stdout
    assert "RFC storage saving on 3 block boundaries" in out.stdout
