"""Build ``csrc/*.cu`` (with the shared ``csrc/*.cuh`` headers) with nvcc
on first use and load it with ctypes.

Each source compiles to an object in parallel (one nvcc per file, all
started together) and the objects link into one shared library with a
plain C interface, named by a hash of the sources, headers and flags and
kept in ``build/repro_torch/`` at the repository root (git-ignored).  Nothing is
built when the package is imported: the first kernel launch builds.

Also holds the launch counters: each kernel wrapper adds one to its entry
of ``LAUNCHES`` where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

KERNELS = ("graph_sconv", "cavity_tconv", "cavity_tconv_step", "rfc_encode",
           "rfc_decode", "graph_sconv_csr", "windowed_similarity",
           "flash_decode")
LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry points: (argtypes); every one returns a cudaError_t as int
_SIGNATURES = {
    # x, g, w, out, R, V, Cin, Cout, K, tile, rows, wt, xres, stream
    "graph_sconv_f32": (_P, _P, _P, _P, *(_I,) * 9, _P),
    # x, idx (int32), val, w, out, R, V, Cin, Cout, K, D, tile, rows, wt,
    # xres, stream
    "graph_sconv_csr_f32": (*(_P,) * 5, *(_I,) * 10, _P),
    # x, wp, taps, inv_perm (int64), out, scratch, N, T, V, C, L, n_keep,
    # Fg, F, T_out, stride, ksize, pad, tt, nb, stream
    "cavity_tconv_f32": (_P, _P, _P, _P, _P, _P, *(_I,) * 14, _P),
    # ring, head (int32), wp, taps, slot_col (int32), bias, out, S, K, V, C,
    # L, n_keep, Fg, cout, wm, parts, stream
    "cavity_tconv_step_f32": (*(_P,) * 7, *(_I,) * 10, _P),
    # t, res, live, keep, old_vals, old_bits, vals, bits (each but t and
    # the outputs may be null), rows, C, V, slot_rows, stream
    "rfc_encode_f32": (*(_P,) * 8, _L, _I, _I, _L, _P),
    # vals, bits, out, rows, C, stream
    "rfc_decode_f32": (_P, _P, _P, _L, _I, _P),
    # ring_th, ring_ph, e_th, e_ph, t (int32), has_input, in_valid (bool),
    # new_th, new_ph (the seven null in the bare form), out, S, K, V, Ce,
    # valid, rows, threads, stream
    "window_sim_f32": (*(_P,) * 10, *(_I,) * 7, _P),
    # q, k, v, valid (int32), out, B, S, Hkv, G, D, splits, warps, stages,
    # vec, window, stream
    "flash_decode_f32": (*(_P,) * 5, *(_I,) * 10, _P),
    # the same with a bf16 cache, always 16-byte staging (no vec)
    "flash_decode_bf16": (*(_P,) * 5, *(_I,) * 9, _P),
}

_lib: Optional[ctypes.CDLL] = None


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: install the CUDA toolkit or set "
                           "CUDA_HOME to it")
    return found


def build() -> Tuple[Path, str]:
    """Compile and link the kernels if the library for these sources is
    not built yet.  Returns (library path, compiler output)."""
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):      # the sources and headers
        h.update(src.name.encode() + b"\0" + src.read_bytes())
    lib = BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"
    log_path = lib.with_suffix(".log")
    if lib.exists():
        return lib, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    logs = []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(sources, objs)]
        failed = []
        for src, proc in zip(sources, procs):
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, "-shared", *map(str, objs), "-o", str(tmp_lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + "\n".join(logs))
        os.replace(tmp_lib, lib)
    log = "\n".join(logs)
    log_path.write_text(log)
    return lib, log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(kernel: str, fn_name: str, device: torch.device, *args) -> None:
    """Call C entry point ``fn_name`` on ``device``'s current stream, raise
    on a launch error, and count one launch of ``kernel``."""
    fn = getattr(library(), fn_name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} launch failed with cudaError {err}")
    LAUNCHES[kernel] += 1


_SMS: Dict[int, int] = {}


def sm_count(device: torch.device) -> int:
    """The number of SMs of CUDA ``device`` (read once per device)."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def check_cuda_f32(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on the
    first one's CUDA device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def dispatch_device(name: str, x: torch.Tensor) -> str:
    """``"cpu"`` or ``"cuda"`` by the input's device; raise otherwise."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return x.device.type
