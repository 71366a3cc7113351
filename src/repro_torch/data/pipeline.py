"""Deterministic synthetic data, generated from a seed with numpy.

The same generators as ``repro.data.pipeline``, so the batches are
bit-equal: NTU-like skeleton clips (a kinematic-chain oscillation per
class plus noise, giving realistic post-ReLU feature sparsity for the RFC
path) and Markov-chain token batches for the LM family.  Each host
materialises only its slice of the global batch.  ``start`` (a port
addition) begins a stream at a later batch, so a resumed run reads the
batches the uninterrupted one would have.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.common.config import ModelConfig
from repro_torch.core.agcn.graph import (NTU_EDGES, get_topology,
                                         topology_names)


@dataclasses.dataclass
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1


def _host_slice(cfg: DataConfig):
    per = cfg.global_batch // cfg.host_count
    return cfg.host_index * per, per


def lm_batches(mcfg: ModelConfig, dcfg: DataConfig, start: int = 0
               ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless {"tokens", "labels": (B, S) int32} batches of a Markov-chain
    token stream with a few strong modes per token (so a model's loss
    falls).  The dense family's batches; the VLM and audio extras join
    with those families (ROADMAP.md, Queue 1 item 6)."""
    _, per = _host_slice(dcfg)
    vocab = mcfg.vocab_size
    rng = np.random.default_rng(dcfg.seed)
    next_tok = rng.integers(0, vocab, size=(vocab, 4))
    step = start
    while True:
        brng = np.random.default_rng(
            (dcfg.seed, step, dcfg.host_index, 0xD47A))
        s_text = dcfg.seq_len
        toks = np.empty((per, s_text), np.int64)
        toks[:, 0] = brng.integers(0, vocab, size=per)
        choice = brng.integers(0, 4, size=(per, s_text))
        noise = brng.random((per, s_text)) < 0.1
        rand = brng.integers(0, vocab, size=(per, s_text))
        for t in range(1, s_text):
            nxt = next_tok[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(noise[:, t], rand[:, t], nxt)
        yield {"tokens": toks.astype(np.int32), "labels": toks.astype(np.int32)}
        step += 1


def _skeleton_edges(num_joints: int):
    """The kinematic chain of a clip at ``num_joints``: the NTU bone list
    at 25 joints, the registry topology's edges at any other registered
    width, else a plain chain."""
    if num_joints == 25:
        return NTU_EDGES
    for name in topology_names():
        tp = get_topology(name)
        if tp.num_joints == num_joints:
            return tp.edges
    return [(j + 1, j) for j in range(1, num_joints)]


def skeleton_batches(mcfg: ModelConfig, dcfg: DataConfig,
                     num_classes: Optional[int] = None, start: int = 0
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Endless batches {"x": (N*M, T, V, C) float32, "labels": (N*M,)
    int32}, persons folded into the batch axis.  The rest pose follows
    the skeleton of ``mcfg.gcn_joints`` joints (:func:`_skeleton_edges`)."""
    _, per = _host_slice(dcfg)
    ncls = num_classes or mcfg.gcn_num_classes
    V, T, M, C = (mcfg.gcn_joints, mcfg.gcn_frames, mcfg.gcn_persons,
                  mcfg.gcn_in_channels)
    # static rest pose from the bone chain
    rest = np.zeros((V, 3))
    rng = np.random.default_rng(dcfg.seed)
    offsets = rng.standard_normal((V, 3)) * 0.1
    for j, p in _skeleton_edges(V):
        rest[j - 1] = rest[p - 1] + offsets[j - 1]
    step = start
    while True:
        brng = np.random.default_rng((dcfg.seed, step, dcfg.host_index, 0x5CE1))
        labels = brng.integers(0, ncls, size=per)
        t = np.arange(T)[None, :, None, None] / T
        freq = (labels[:, None, None, None] % 7 + 1.0)
        phase = (labels[:, None, None, None] % 5) * 1.3
        amp = brng.random((per, 1, V, C)) * 0.5
        x = rest[None, None, :, :C] + amp * np.sin(
            2 * np.pi * freq * t + phase + np.arange(V)[None, None, :, None])
        x = x + brng.standard_normal((per, T, V, C)) * 0.02
        x = np.repeat(x, M, axis=0).astype(np.float32)      # persons folded
        yield {"x": x, "labels": np.repeat(labels, M).astype(np.int32)}
        step += 1


def make_batches(mcfg: ModelConfig, dcfg: DataConfig, start: int = 0):
    """The family's batch stream: skeleton clips for ``gcn``, token
    batches otherwise."""
    if mcfg.family == "gcn":
        return skeleton_batches(mcfg, dcfg, start=start)
    return lm_batches(mcfg, dcfg, start=start)
