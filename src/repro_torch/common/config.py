"""Model configuration for the port (the gcn, decoder, MoE, VLM, SSM,
hybrid and audio fields of ``repro.common.config.ModelConfig``).

Frozen dataclass, so a config can key caches and be shared freely.
:class:`TrainConfig` holds the optimizer, schedule, microbatching and
checkpoint settings of ``repro.common.config.TrainConfig``;
:class:`ShapeConfig`, ``SHAPES`` and ``GCN_SHAPES`` are its input-shape
cells (an arch × a shape is one cell of ``launch.dryrun``).  Every family
of the reference is ported; the LM fields default to 0 or off (with the
reference's defaults for the SSM and audio widths), so a gcn config
leaves them alone.
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
    language model: ``family="dense"`` (a decoder-only transformer: GQA,
    optional sliding-window or local:global attention), ``"moe"`` (the
    MLP replaced by a top-k mixture of experts), ``"vlm"`` (a text
    backbone that takes projected patch embeddings before the text),
    ``"ssm"`` (xLSTM: mLSTM blocks with a periodic sLSTM block),
    ``"hybrid"`` (Zamba2: a Mamba2 backbone with one shared attention
    block) or ``"audio"`` (Whisper: an encoder-decoder over stub frame
    embeddings)."""

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
    local_global_ratio: int = 0            # n local per 1 global (gemma3)
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    act: str = "silu"                      # silu | gelu | relu2
    scan_group: int = 1                    # layers per stacked group

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM / hybrid ---
    ssm_state: int = 0                     # mamba2 state dim per head
    ssm_conv: int = 4                      # short conv width
    slstm_every: int = 0                   # xlstm: 1 sLSTM per this many blocks
    shared_attn_every: int = 0             # zamba2: shared attn block period
    ssm_expand: int = 2

    # --- encoder-decoder (audio) ---
    encoder_layers: int = 0
    encoder_frames: int = 1500             # whisper stub frontend output length

    # --- vlm ---
    num_image_tokens: int = 0              # patch embeddings per sample (stub)

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
    sharding: str = "2d"                   # parameter policy on a mesh: 2d
                                           # (model + data) | dp_only
                                           # (replicated; batch on every axis)

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
    def padded_experts(self) -> int:
        """Experts rounded up to a multiple of 16, so a 16-way model axis
        divides them (the pads get −1e30 router logits and zero
        weights)."""
        if self.num_experts == 0:
            return 0
        return _round_up(self.num_experts, 16)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count_estimate(self) -> int:
        """Analytic parameter count (for 6·N·D model FLOPs), as the
        reference's (real experts only, the VLM's image projection left
        out; the SSM and hybrid counts approximate their projections)."""
        if self.family == "gcn":
            total = 0
            cin = self.gcn_in_channels
            for cout in self.gcn_channels:
                total += self.gcn_kv * cin * cout          # spatial 1x1
                total += cout * cout * self.gcn_tkernel    # temporal 9x1
                total += self.gcn_kv * self.gcn_joints ** 2
                cin = cout
            return total + cin * self.gcn_num_classes
        d, L = self.d_model, self.num_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.family == "moe":
            ffn = 3 * d * self.moe_d_ff * self.num_experts + d * self.num_experts
        elif self.family == "ssm":
            inner = self.ssm_expand * d
            ffn = 0
            attn = 2 * d * inner + inner * d + inner * d  # mLSTM projections
        elif self.family == "hybrid":
            inner = self.ssm_expand * d
            ffn = d * self.d_ff * 3 // max(1, self.shared_attn_every)
            attn = 2 * d * inner + inner * d
        else:
            ffn = (3 * d * self.d_ff if self.act in ("silu", "gelu")
                   else 2 * d * self.d_ff)
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + 2 * d * self.d_ff)
        return L * (attn + ffn) + self.padded_vocab * d + enc

    def active_param_count_estimate(self) -> int:
        """Parameters a token meets (MoE: its top-k experts only)."""
        if self.family != "moe":
            return self.param_count_estimate()
        d, L = self.d_model, self.num_layers
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        ffn = 3 * d * self.moe_d_ff * self.experts_per_token
        return L * (attn + ffn) + self.padded_vocab * d


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (an arch × a shape makes a dry-run cell)."""

    name: str                # train_4k | prefill_32k | decode_32k | long_500k | gcn_*
    kind: str                # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}

# GCN (paper) shapes: a batch of skeleton clips (N, T, V, C), persons folded
GCN_SHAPES = {
    "gcn_train": ShapeConfig("gcn_train", "train", 300, 512),
    "gcn_infer": ShapeConfig("gcn_infer", "prefill", 300, 2048),
}


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
