"""Model configuration for the port (the gcn and dense-decoder fields of
``repro.common.config.ModelConfig``).

Frozen dataclass, so a config can key caches and be shared freely.
:class:`TrainConfig` holds the optimizer, schedule, microbatching and
checkpoint settings of ``repro.common.config.TrainConfig``.  The
skeleton-GCN family and the dense decoder LM family are ported; the other
LM families' fields (MoE, SSM, hybrid, audio, VLM) join with their slice
(ROADMAP.md, Queue 1 item 13).  The LM fields default to 0 or off, so a
gcn config leaves them alone.
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m

# The serve CLI's --batch 0 defaults, resolved in one place
# (ModelConfig.serve_batch).  Keyed "<family>:<mode>", with a fallback.
SERVE_BATCH_DEFAULTS = {
    "gcn:clip": 8,       # batched two-stream clip inference
    "gcn:stream": 4,     # lockstep per-frame streaming
    "default": 4,        # LM families (decode batch)
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """2s-AGCN architecture plus the paper's hybrid-pruning knobs, or a
    dense decoder-only transformer (``family="dense"``: GQA, optional
    sliding-window attention)."""

    name: str
    family: str
    num_layers: int

    # --- dense decoder LM ---
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0                      # 0 -> d_model // num_heads
    window_size: int = 0                   # >0 -> sliding-window attention
    local_global_ratio: int = 0            # n local per 1 global (gemma3;
                                           # the port refuses n > 0)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"                      # silu | gelu | relu2
    scan_group: int = 1                    # layers per stacked group

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

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    def serve_batch(self, mode: str = "", requested: int = 0) -> int:
        """The serve CLI's batch size: an explicit ``requested`` wins,
        else the ``SERVE_BATCH_DEFAULTS`` entry for ``family:mode``."""
        if requested:
            return requested
        return SERVE_BATCH_DEFAULTS.get(
            f"{self.family}:{mode}", SERVE_BATCH_DEFAULTS["default"])

    @property
    def padded_vocab(self) -> int:
        """The vocabulary rounded up to a multiple of 256 (embedding rows
        and logits)."""
        return _round_up(self.vocab_size, 256)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training settings, with the JAX package's fields and defaults.  The
    default checkpoint directory is ``repro_ckpt`` in the temporary
    directory (``/tmp/repro_ckpt`` where ``TMPDIR`` is unset, as in JAX)."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1
    seed: int = 0
    checkpoint_every: int = 100
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    dtype: str = "bfloat16"
    grad_compression: str = "none"   # none | bf16: gradients cast to bf16
                                     # before the update (moments stay f32)
