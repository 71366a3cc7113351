"""Checkpoints of parameter and optimizer trees: save/restore with a
manifest (leaf names, shapes, dtypes, per-leaf checksums), so restores are
integrity-checked.  Port of ``repro.checkpoint.store``, with the same
on-disk layout and leaf names, so a checkpoint written by either package
restores in the other:

    <dir>/step_<n>/manifest.json + leaf_<i>.npy

one ``.npy`` file per leaf in JAX's leaf order (dict keys sorted), named by
the leaf's path (``blocks/0/Wk``; an ``OptState``'s fields as ``.step``,
``.m/...``, ``.v/...``); the checksum is the first 16 hex digits of the
sha256 of the leaf's raw bytes; bfloat16 leaves are stored as their raw
uint16 view with ``"bfloat16"`` in the manifest.  Writes go to a
temporary directory renamed into place (atomic), and the oldest steps
past ``keep`` are deleted.  ``save_async`` copies the tree to the host on
the caller's thread and writes the files on a worker thread.
"""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.tree import tree_map, tree_paths, tree_unflatten


def _host_array(leaf: Any) -> tuple:
    """(array to store, dtype name, raw bytes) of a tensor or array leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            raw = t.contiguous().view(torch.int16).numpy().view(np.uint16)
            return raw, "bfloat16", raw.tobytes()
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype), arr.tobytes()


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Write ``tree`` as step ``step`` under ``ckpt_dir``; returns the step
    directory."""
    base = pathlib.Path(ckpt_dir)
    tmp = base / f".tmp_step_{step}"
    final = base / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    manifest = {"step": step, "leaves": {}}
    for i, (name, leaf) in enumerate(tree_paths(tree)):
        stored, dtype, raw = _host_array(leaf)
        fname = f"leaf_{i}.npy"
        np.save(tmp / fname, stored)
        manifest["leaves"][name] = {
            "file": fname,
            "shape": list(stored.shape),
            "dtype": dtype,
            "sha256": hashlib.sha256(raw).hexdigest()[:16],
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                                   # atomic publish
    _gc(base, keep)
    return str(final)


def save_async(ckpt_dir: str, step: int, tree, *,
               keep: int = 3) -> threading.Thread:
    """:func:`save` on a worker thread.  The copy to the host happens here,
    on the caller's thread (it waits for the device to finish the step),
    so the caller may change or free the device tensors at once."""
    host_tree = tree_map(
        lambda x: x.detach().to("cpu", copy=True)
        if isinstance(x, torch.Tensor) else np.array(x, copy=True), tree)
    t = threading.Thread(target=save, args=(ckpt_dir, step, host_tree),
                         kwargs={"keep": keep}, daemon=True)
    t.start()
    return t


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The largest step with a manifest under ``ckpt_dir``, or None."""
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [
        int(p.name.split("_")[1]) for p in base.iterdir()
        if p.name.startswith("step_") and (p / "manifest.json").exists()
    ]
    return max(steps) if steps else None


def _load(final: pathlib.Path, name: str, meta: dict, verify: bool
          ) -> torch.Tensor:
    arr = np.load(final / meta["file"])
    if verify:
        h = hashlib.sha256(arr.tobytes()).hexdigest()[:16]
        if h != meta["sha256"]:
            raise IOError(f"checksum mismatch for {name}")
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != meta["dtype"]:
        raise ValueError(f"leaf {name}: stored {arr.dtype}, manifest says "
                         f"{meta['dtype']}")
    return torch.from_numpy(arr)


def restore(ckpt_dir: str, step: int, like, *, verify: bool = True):
    """Step ``step`` of ``ckpt_dir`` in the structure of ``like``, each
    leaf a tensor on the device of ``like``'s leaf (the CPU for an array
    leaf), with the stored values, shape and dtype.  Raises ValueError if
    a leaf of ``like`` is missing and IOError on a checksum mismatch."""
    final = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((final / "manifest.json").read_text())
    paths = tree_paths(like)
    missing = [n for n, _ in paths if n not in manifest["leaves"]]
    if missing:
        raise ValueError(f"checkpoint missing leaves: {missing[:5]}")
    out = []
    for name, leaf in paths:
        t = _load(final, name, manifest["leaves"][name], verify)
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        out.append(t.to(dev))
    return tree_unflatten(like, out)


def _gc(base: pathlib.Path, keep: int):
    steps = sorted(
        int(p.name.split("_")[1]) for p in base.iterdir()
        if p.name.startswith("step_")
    )
    for s in steps[:-keep]:
        shutil.rmtree(base / f"step_{s}", ignore_errors=True)
