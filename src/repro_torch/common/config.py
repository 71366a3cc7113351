"""Model configuration for the port (the gcn fields of
``repro.common.config.ModelConfig``).

Frozen dataclass, so a config can key caches and be shared freely.  Only
the skeleton-GCN family is ported so far; the LM families' fields join
with their slice (ROADMAP.md, Queue 1 item 13).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

# The serve CLI's --batch 0 defaults, resolved in one place
# (ModelConfig.serve_batch).  Keyed "<family>:<mode>", with a fallback.
SERVE_BATCH_DEFAULTS = {
    "gcn:clip": 8,       # batched two-stream clip inference
    "gcn:stream": 4,     # lockstep per-frame streaming
    "default": 4,
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """2s-AGCN architecture plus the paper's hybrid-pruning knobs."""

    name: str
    family: str
    num_layers: int

    # --- gcn (2s-AGCN) ---
    gcn_joints: int = 25
    gcn_frames: int = 300
    gcn_persons: int = 2
    gcn_in_channels: int = 3
    gcn_num_classes: int = 60
    gcn_channels: Tuple[int, ...] = ()     # per-block output channels
    gcn_strides: Tuple[int, ...] = ()
    gcn_kv: int = 3                        # K_v neighbour subsets
    gcn_tkernel: int = 9                   # temporal kernel size
    use_ck: bool = False                   # windowed data-dependent C_k graph

    # --- paper technique knobs ---
    prune_channel_fracs: Tuple[float, ...] = ()  # per-block kept fraction (C1)
    cavity_pattern: str = ""               # e.g. "cav-70-1" (C2)
    input_skip: int = 1                    # keep 1 of every `input_skip` frames
    rfc_bank: int = 16                     # RFC bank width (C3)
    gcn_stream_pool: int = 0               # streaming logit pool: 0 = running
                                           # mean over every emitted frame
                                           # (clip parity); W > 0 = sliding
                                           # window of the last W frames
    gcn_backend: str = "cuda"              # engine backend: cuda | reference

    def serve_batch(self, mode: str = "", requested: int = 0) -> int:
        """The serve CLI's batch size: an explicit ``requested`` wins,
        else the ``SERVE_BATCH_DEFAULTS`` entry for ``family:mode``."""
        if requested:
            return requested
        return SERVE_BATCH_DEFAULTS.get(
            f"{self.family}:{mode}", SERVE_BATCH_DEFAULTS["default"])
