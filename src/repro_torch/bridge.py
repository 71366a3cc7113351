"""Parameters across frameworks: the JAX ``init_params`` tree, handed over
as numpy arrays, becomes the port's parameter tree.  ``jax.random`` cannot
be reproduced with torch, so the parity tests move weights this way."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.common.device import DeviceLike, resolve_device


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dicts/lists/tuples of array-likes -> the same nesting (tuples
    become lists) of tensors on ``device`` (default CUDA), values and
    dtypes unchanged."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return torch.as_tensor(np.array(node, copy=True), device=dev)

    return conv(tree)
