#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (H100, sm_90a) and the CUDA toolkit's nvcc; imports
only torch, numpy and ``repro_torch``.  Phases, in order:

  1. device  — the card's name and power limit (nvidia-smi), torch and
               CUDA versions.  TF32 is switched off for matmul and cuDNN,
               so every comparison below is in full float32.
  2. build   — the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, one
               process per source, in parallel), with ptxas's register and
               spill report.
     card_tests — the JAX-free kernel tests, every case marked ``cuda``:
               ``python3 -m pytest -q --noconftest -p no:cacheprovider -m
               cuda tests/test_torch_cuda_kernels.py`` with PYTHONPATH=src;
               fails unless pytest exits 0 with no case skipped, and
               prints the count that passed.
  3. kernels — one clip ensemble step (full agcn-2s, batch 8) and one
               stream tick at S = 1, 3 and 8 slots (after 200 raw frames,
               past the last block's first full window, so every kept tap
               reads data; a cavity_tconv_step input whose kept-tap frames
               are all zero fails) are run with recording wrappers, so each
               kernel is held against its plain version on exactly the
               inputs its path gives it (graph_sconv, cavity_tconv and
               cavity_tconv_step within atol=rtol=1e-4, RFC bit-equal:
               rfc_encode is the block epilogue relu(t + res) fused with
               the encode, and on a stream tick its step form), plus
               rfc_encode without res on the clip step's t, its step form
               with a mixed keep on the S = 8 tick's inputs and an RFC case
               with C % 16 != 0; likewise a clip step of the
               50-joint two-person skeleton (ntu50, persons not folded) on
               a CSR plan (graph_sconv_csr) and a dense one (graph_sconv at
               V = 50), and a clip step and an S = 8 tick (200 frames in) of
               hand21 and body_hand46 on dense plans (graph_sconv at V = 21
               and 46).  Each kernel, its plain version and a one-call
               PyTorch yardstick where one exists are timed on one clock
               (``cuda_ms``): CUDA events around ten back-to-back calls,
               behind a spin kernel sized to outlast the host's measured
               time to queue them (retried with a longer spin after a host
               hiccup), so the events time device work and no host gap;
               the plain versions that read taps on the host wait for the
               device and are timed with their waits (named on the
               ``clock:`` line with any timing three spins did not hide);
               the two RFC kernels, bound by bytes from HBM, are timed on
               rotating copies of their inputs that together exceed twice
               the L2 (at most 64 copies), with their time on one set of inputs beside it (``ms_l2``;
               a stream tick's 64 copies still fit the L2);
               beside them the bound on this card (the four tensor-core
               kernels take the TF32 rate, with the float32 bound and the
               3-pass split's floor beside it).  The ticks of the later
               streams are held the same way in their phases, on the state
               their own run reached 200 frames in.
  4. main    — ``serve_gcn`` at the full agcn-2s config (batch 8, a few
               batches) on the ``cuda`` and ``reference`` backends: clips/s,
               logit agreement within atol=rtol=1e-3, and the launch
               counts (20 graph_sconv, 20 cavity_tconv, 18 rfc_encode and
               18 rfc_decode per ensemble step).
  5. stream  — ``serve_gcn_stream`` at full agcn-2s (batch 4 clips = 8
               sequences, T = 300, then the 149-frame drain) on both
               backends: frames/s and per-step latency, post-drain stream
               logits against the clip engine's and ``cuda`` against
               ``reference`` (atol=rtol=1e-3, top-1 100%), and the launch
               counts of calibration, stream steps and the clip check.
  6. slab    — ``make_gcn_fused_tick`` on ``cuda`` at full width with 8
               slots and a fixed script: 12 staggered sessions of 64
               frames, a held session, a preemption into the snapshot ring
               with a foreign session in the slot, a same-tick snapshot
               and restore, drains.  Each session's logits at eviction
               against the same session streamed alone (atol=rtol=1e-3),
               the launch counts per tick, the tick time, and one tick
               with its inputs on the card under
               ``torch.cuda.set_sync_debug_mode("error")``.
  7. topology — ntu50 at full width: clip steps (batch 8) of CSR plans
               (csr_eps = 1e-5) on ``cuda`` against dense plans on
               ``reference`` and on ``cuda`` (atol=rtol=1e-3, top-1 100%),
               sequences/s of the three, 20 graph_sconv_csr and no
               graph_sconv launch per ensemble step; a stream of the batch
               (300 frames + the drain) on the CSR plans, post-drain logits
               against the clip engine's.  Its S = 8 tick 200 frames in is
               held on the CSR plan (graph_sconv_csr, D = the skeleton's
               degree), a CSR plan with csr_eps = 0 (D = V) and a dense
               plan (graph_sconv at V = 50).
  8. mixed   — an 8-slot slab at Vmax = 50 of ntu25 sessions (plans padded
               to 50) and ntu50 sessions on CSR plans, slots reused across
               skeletons, stepped as the JAX service steps its skeleton
               groups: one ``make_gcn_slab_step`` per group with its own BN
               statistics, the other slots held.  Each session's eviction
               logits against the same session run alone on a narrow plan
               (atol=rtol=1e-4).
  9. ck      — agcn-2s with the windowed C_k (``use_ck``) on ntu25: a stream
               of 8 sequences (300 frames + the drain) on ``cuda`` and
               ``reference``, post-drain logits against clip-mode C_k
               logits and ``cuda`` against ``reference`` (atol=rtol=1e-3,
               top-1 100%), 20 windowed_similarity launches per ensemble
               step (its step form: the C_k ring writes and the graph in
               one launch); the same stream on plans padded to 50 joints
               against the narrow one at every step (atol=rtol=1e-4).
               Ticks 200 frames in are held at S = 1, 3 and 8 of the
               ``cuda`` stream (every column live) and at S = 8 of the
               padded one (25 live): the step form as the path calls it
               (new rings bit-equal, graph within 1e-4) and the bare form
               on the same calls' new rings, each beside a four-call
               PyTorch composite (``sum``, ``baddbmm``, ``masked_fill``,
               ``softmax``; ``composite_ms``, no library call computes
               this function); a windowed_similarity input with an
               all-zero slot fails.
 10. sessions — ``repro_torch.serving.GcnService`` through its public API
               (``replay``, ``open_session``/``submit``/``close``/``poll``),
               with port weights from seed 0:
               (a) the golden replays on ``cuda`` at the reduced config
               (the golden tests' prune plan: [1.0, 0.5, 0.5, 0.5] kept,
               cav-70-1, input skip 2, Q8.8): ``tests/data/traces/
               smoke.json`` through the three ``fifo`` cells of
               ``golden_smoke.json`` and both cells of
               ``golden_saliency.json``, then, while the first ones took
               under 30 s, the four ``preempt``/``deadline`` cells; each
               must equal its golden cell exactly (outcome digest, ticks,
               sessions, preemptions, restores, deadline misses, sheds,
               saliency counts, tier walk, final capacity, per-priority
               tick percentiles), with graph_sconv, cavity_tconv_step,
               rfc_encode and rfc_decode launched per step as a
               one-stream tick does; (b) full agcn-2s on ``cuda`` and
               ``reference``: a ``TraceGenerator`` trace of 16 sessions
               (mean 48 frames, 16 to 96, 30% high priority, seed 7)
               under ``qos="preempt"``, tiers (4, 8), ``policy="demand"``;
               the two outcome digests equal, every finished session's
               logits within atol=rtol=1e-3, top-1 100%, at least one
               preemption and one migration, and the ``cuda`` launches
               exactly one tick's per step plus one calibration clip pass;
               prints sessions/s, frames/s, tick p50 and mean (host clock
               inside ``tick``), ms a tick over the run, dispatches,
               forced readbacks and launches per tick; (c) a two-skeleton
               service (ntu25 padded to 50, ntu50, 4 slots) fed frame by
               frame with starved (held) ticks, then closed: every
               session done, ``cuda`` against ``reference`` within
               atol=rtol=1e-3.  Prints the phase's time.
 11. distributed — the distributed serving tier at full agcn-2s on
               ``cuda``: (a) the sessions phase's 16-session trace through
               ``GcnService(mesh=make_batch_mesh(4, device=<this card>))``
               (4 logical shards of the (4, 8) tiers) against that phase's
               unsharded run: the outcome log equal, every session's logits
               within atol=rtol=1e-3, one shard step per shard a tick
               (launches per tick four times the unsharded tick's, plus
               one calibration clip pass), tick p50 both ways and
               ``collective_ms_per_tick`` (``collective_cost_ms``: CUDA
               events), and one sharded fused tick (a snapshot on shard 1
               and its restore on shard 2 of one ring row) under
               ``set_sync_debug_mode("error")``; (b) the same against a
               mesh over two cards when more than one is visible (else a
               line says it was not run); (c) a 2-replica
               ``ReplicaRouter``: a 48-frame session moved from replica 0's
               slot to replica 1 at tick 20 within atol=rtol=1e-3 of its
               run alone, the bystander's max difference to its run
               without the move (0 required), the launches of the routed
               run, and the ``run_routed_sessions`` row (2 replicas x 4
               slots, 8 sessions: sessions/s, frames/s, rebalances).
 12. profile — two steps each of the clip, stream, slab, ntu50 CSR clip
               and C_k stream paths under ``torch.profiler``: the device's
               busy share of the wall time and device time by kernel name
               (reported, not checked; the profiler's own cost inflates the
               wall time).
 13. lm      — dense LM decode serving at the full width of smollm-360m
               (32 layers, d_model 960, 15/5 heads, vocab 49 152; random
               weights from seed 0): ``generate`` (batch 4, a 496-token
               prompt fed token by token, then 16 greedy tokens: 511 serve
               steps, a 512-slot float32 cache) on ``cuda`` and
               ``reference``, tokens/s and per-step latency; the
               ``reference`` backend teacher-forced on the ``cuda`` run's
               tokens (per-step logits within atol=rtol=1e-3; a greedy
               token that differs fails unless the reference's top-2
               margin is <= 1e-3); the prompt's logits from the cache-free
               forward against the cached decode (1e-3); 32 flash_decode
               launches per ``cuda`` step and none on ``reference``; one
               decode step under ``set_sync_debug_mode("error")``; one step
               profiled.  flash_decode is held against its plain version
               (atol=rtol=1e-4) on the 32 layers' inputs of an early step
               (valid 17), the first step after the prompt and the last
               step, a long-context case
               (B 8, S 32 768, valid 30 000), h2o-danube's ring shape
               (B 4, L 4 096, 8 kv heads, G 4, D 80) and a small odd case
               (S 48, D 20, valid 1), beside one
               ``F.scaled_dot_product_attention`` call (the yardstick);
               each ``kernel flash_decode`` line names the launch's plan
               (splits, warps, stages), its µs per launch and its share of
               the bound.
 14. train   — the offline path: ``launch.train.train_loop`` on full
               agcn-2s (ntu25, T = 300 with input skip 2, dense graph)
               for 30 steps of 16 clips = 32 sequences (lr 3e-3, warmup
               3, seed 0; checkpoints at steps 10, 20, 30 under
               ``build/chip_smoke_train/``): finite losses, the last 5
               steps' mean below the first 5's, step p50 and mean,
               sequences/s and peak memory beside nvidia-smi's line, and
               no kernel launch (the loss runs the ``reference``
               backend); the step-10 checkpoint restored into fresh trees
               bit-equal to the state the loop held, and resumed (the
               step-11 loss within 1e-4 of the uninterrupted run's); one
               reduced ``make_train_step`` step on the card against the
               CPU from the same params and batch (loss 1e-4, gradients
               1e-4 of each leaf's max |g| plus 1e-6, params 1e-5 where
               the CPU's |g| > 1e-6); ``mlp_relu2_rfc`` at (4096, 1024) x
               (1024, 4096) on the hand-written RFC pair (one encode, one
               decode) against the plain autograd (1e-4 of each tensor's
               max), with its modelled and held bytes; C3's storage and
               Table III categories of the trained model at full width
               from the bits the ``cuda`` clip path writes between blocks
               (``engine.rfc_boundaries``: 10 graph_sconv and
               cavity_tconv, 9 of each RFC kernel) against the
               ``reference`` path's mask (1e-3), the E(D) report per
               block, the Drop-1/2/3 x cav compression table equal to
               ``COMPRESSION_TABLE``; one full-width train step profiled.
 15. dist_train — ``launch.train.train_loop`` on the card: granite-moe
               at full width with the depth cut to 12 layers (batch 4 x
               512, 4 steps; 16 bytes a parameter for weights, gradients
               and two moments), then smollm-360m at full width (batch 8
               x 512 tokens, 6 steps): step p50, tokens/s, peak memory,
               the memory held after each step, finite losses, no kernel
               launch; before the smollm run, the same loop under
               ``torchrun --nproc-per-node 1`` on NCCL with a (1, 1) mesh
               and DTensor parameters (``--mesh 1,1``), its losses within
               1e-5 of the loop without a process group (bit-equality
               reported; every collective is skipped at axis size 1, so
               this holds the DTensor path, not an NCCL collective); one
               smollm train step profiled; the tests' 4-rank gloo run
               on the CPU (``tests/torch_dist_workers.py smoke``, 1e-5);
               a 2-card NCCL run only when two cards are
               visible.  Subprocesses run in a process group of their
               own, killed at their deadline.
 16. moe_vlm — the MoE and VLM decoder families at full width, random
               weights from seed 0, float32 caches: ``generate`` (batch 4,
               prompt fed token by token, then greedy tokens) of
               granite-moe-3b-a800m at full width and depth (prompt 64 +
               16) and of qwen3-moe-30b-a3b at full width with the depth
               cut to 16 of its 48 layers (prompt 32 + 16; 48 float32
               layers are about 122 GB), each on ``cuda`` and
               ``reference`` with the lm phase's checks (launch counts,
               teacher-forced logits 1e-3, greedy flips at a top-2
               margin <= 1e-3, the prompt's cache-free logits at a
               capacity that drops no token against the cached decode,
               1e-3), decode-step p50 and tokens/s, flash_decode held on
               the first decode step's and the last step's inputs (G 3,
               D 64 and G 8, D 128); one granite decode step profiled;
               llava-next-mistral-7b at full width: the prefill of 2 880
               image embeddings + 32 text tokens written to the cache
               against the cache-free forward (1e-3), one ``cuda`` decode
               step after it against the cache-free forward of the longer
               sequence (1e-3; flash_decode held on its inputs, B 1,
               valid 2 913), then a text decode as JAX serves it (batch
               4, prompt 32 + 16, G 4, D 128).

 17. zoo     — the rest of the LM zoo at full width, random weights from
               seed 0, float32 caches; each model's bytes reckoned before
               it is drawn (4 a parameter to serve, 16 to train) and the
               model freed before the next: ``generate`` (prompt 16 fed
               token by token + 16 greedy tokens) of xlstm-1.3b (batch 4,
               ``cuda``: no kernel on its path), zamba2-7b (batch 4,
               ``cuda`` and ``reference``; flash_decode at Hkv 32, G 1,
               D 112, one launch per use of the shared block), whisper-small
               (batch 4, both backends; the memory drawn from the seed
               after the prompt; flash_decode on the self-attention and on
               the cross-attention at valid 1 500), gemma3-12b (batch 1,
               both backends; D 256; its local layers' caches inside the
               window) and internlm2-20b with the depth cut to 32 of its 48
               layers (batch 4, ``cuda``; G 6): decode-step p50 and
               tokens/s, flash_decode launches per step, every step's
               logits against the cache-free forward on the generated
               tokens (1e-3; for xlstm and zamba2 at full depth the float32
               gap is printed, and held instead in float64 and at a cut
               depth, below), flash_decode held on the first decode step's
               and the last step's inputs.  xlstm and zamba2 at full depth
               also: the cache-free forward run twice, bit-equal; the same
               weights in float64, whose teacher-forced ``reference``
               decode is held to the float64 cache-free forward (1e-6: the
               recurrence against the chunked scan in exact arithmetic),
               with each float32 path's distance from the float64 forward
               printed; and at full width cut to 16 layers (where the
               depth-gap tool compares JAX), the float32 ``cuda`` decode
               against the cache-free forward at atol = rtol = 2e-2, JAX's
               own bound for the two families.  Then gemma3's long case: a
               1 100-token prefill in one step and 8 ``cuda`` steps whose
               local layers run flash_decode with the 1 024-token window as
               its lower bound (the last again, on a copy of the cache, under
               set_sync_debug_mode('error')), the logits against the
               cache-free forward (1e-3) and flash_decode held on the
               windowed and the global calls; flash_decode held at
               the zoo's shapes off the runs (``ZOO_FD_CASES``, beside
               masked ``F.scaled_dot_product_attention``); then
               ``train_loop`` for 3 steps of xlstm-1.3b with the depth cut
               to 8 of 48 layers (batch 2 x 128), zamba2-7b cut to 13 of
               81 layers (batch 2 x 256) and whisper-small (batch 2 x
               128): step p50, tokens/s,
               peak memory, finite losses, no kernel launch.
  18. dryrun — ``launch.dryrun.run_cell`` on one static h100x8 cell per
               arch (``DRYRUN_CELLS``, meta tensors, in six spawned
               processes), then ``smollm-360m__decode_32k`` (batch 16, a
               32 768-slot bf16 cache, ``cuda``, position S - 1) and
               ``agcn-2s__gcn_infer`` (256 clips, ``make_prefill_step``)
               built for real at their per-card h100x8 shapes: each step's
               launch count, its ``launch.op_cost`` FLOPs within 1% of the
               static count (the ops that differ named), its time on the
               clock, its device busy time (``torch.profiler``) and the
               measured roofline fraction (static ``ideal_s`` over the
               device busy time) on the H100's constants; then the
               served clip step (pruned ``cuda`` plans, 256 clips) with
               its own count.
  19. benches — the port's benches (``benchmarks/torch_*.py``) on the
               card: the paper's Table IV measured for its four variants
               (original, woC, woC+skip, woC+skip+prune) at full agcn-2s
               on the ``cuda`` backend, b 1 and 16 clips (T 300, 2 persons
               folded): fps through one stream and the ensemble, the
               step's ``launch.op_cost`` FLOPs and bytes, its bound on the
               H100's terms and the share of it reached, one ensemble
               step's launches per kernel checked; then, in smoke mode,
               the kernel bench (``cuda``, full widths), the throughput
               module's measured axes (``cuda``, full agcn-2s; the smoke
               tier cuts their served traffic, not the model) and the
               roofline report over the ``dryrun`` phase's records.  An
               ERROR row, a missing row or a non-finite fps or bound
               fails.
  20. model_parallel — the model axis and the kv_seq decode on 2 ranks of
               this card (``torch.multiprocessing``, gloo carrying CUDA
               tensors: NCCL takes no two ranks on one device).  Each rank
               first runs each collective the port calls (all_reduce,
               all_gather_into_tensor, reduce_scatter_tensor,
               all_to_all_single: sequence parallelism's gathers and
               reduce-scatters among them) on CUDA tensors over gloo and
               fails on a refusal or a wrong value; the compute and every
               kernel stay on the card.  On a (1, 2) mesh, sequence
               parallel between blocks (JAX's default ``seq_shard`` rule;
               the residual's layout printed, a sequence shard required
               of every family but whisper's encoder-decoder):
               granite-moe-3b-a800m and h2o-danube-1.8b at full width cut
               to 4 layers, xlstm-1.3b to one group (7 mLSTM and 1 sLSTM
               block), zamba2-7b to 7 layers (the shared block and 6
               Mamba2 layers) and whisper-small to 4 encoder and 4 decoder
               layers, 3 train steps (batch 2 x 64) against the same
               training in one rank on the card (losses 1e-5, parameters
               1e-4 where the first gradient exceeds 1e-6), then 8 ``cuda``
               decode tokens against one rank (a decoder's first 4 in one
               sequence-parallel prefill step; logits 1e-4, one
               flash_decode an attention a one-token step on each rank, at
               its Hkv / 2 heads).  h2o-danube-1.8b at full width, 4
               layers, batch 2 x 1024: a train step's forward and backward
               sequence-parallel and with ``seq_shard: None``, losses
               within 1e-5, each rank's peak memory over them both ways
               printed, the sequence-parallel one lower.
               Where the SSM or hybrid family misses a bound in float32
               the same check runs in float64 (decode on ``reference``),
               and the float64 gaps decide; flash_decode held to its plain
               version at the ranks' head-sharded shapes (``MP_FD_CASES``);
               agcn-2s (reduced) under
               ``dp_only`` on (1, 2) against (2, 1), equal losses (cuDNN
               deterministic for it); then
               smollm-360m at full width and depth, batch 1, a bf16 cache
               of 131 072 slots from a seeded generator on (2, 1) under
               kv_seq (65 536 a rank), 8 ``cuda`` steps against the
               unsharded decode of the same cache in this process (within
               ``flash_decode.bf16_bound`` of the gap the same decode on
               the float32-widened cache opens), flash_decode_row_max and
               flash_decode_partial once a layer a step on each rank; the
               partial form (bf16 against ``bf16_bound``, float32 1e-5)
               and the row-max pass (1e-5) held to their plain versions at
               the path's shard, timed beside their bound and masked SDPA.
               A 2-card NCCL run only when two cards are visible.
The LM phase (13) also serves smollm-360m on bf16 caches at a 240-token
prompt (``LM_BF16_PROMPT``, a 256-slot cache): ``cuda`` against
``reference`` on bf16 caches (teacher-forced, within ``LM_BF16_SHARE`` of
the gap bf16 opens over the prompt between the reference on bf16 caches
and the float32 forward), the gap to a float32-cache ``cuda`` run of the
same prompt printed, and the bf16 flash_decode held to its plain version on that
run's inputs and at ``FD_BF16_CASES`` within ``flash_decode.bf16_bound``
(half the gap the bf16 rounding of p opens, at most 1e-3 on the served
steps and 3e-4 at the random shapes).

Prints the kernels JSON line, the nvidia-smi line and, last, the result
line.  Any failed phase exits non-zero.  Per-case kernel numbers go to
``build/chip_smoke_cases.json`` (git-ignored).
"""
from __future__ import annotations

import collections
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
sys.path.insert(0, str(SRC))

# The card's rates (launch.mesh, from NVIDIA's H100 SXM data sheet): HBM3,
# float32 outside the tensor cores, and dense TF32 on them.  graph_sconv
# and cavity_tconv run on the tensor cores (TF32, 3-pass split), so their
# bound takes the TF32 rate, with the float32 bound beside it and 3 x
# operations / TF32 rate as the split's own floor; the other kernels use
# float32 FMAs.  Each kernel's (flops, bytes) come from its work function
# in repro_torch.kernels (the one launch.op_cost counts), given this
# run's data where the work depends on it.
from repro_torch.launch.mesh import (HBM_BW as HBM_BYTES_PER_S,  # noqa: E402
                                     PEAK_FLOPS_F32 as F32_FLOP_PER_S,
                                     PEAK_FLOPS_TF32 as TF32_FLOP_PER_S)
TENSOR_CORE_KERNELS = ("graph_sconv", "cavity_tconv", "graph_sconv_csr",
                       "cavity_tconv_step")

KERNEL_INFO = {   # name -> (CUDA source, TPU kernel it replaces)
    "graph_sconv_csr": ("src/repro_torch/csrc/graph_sconv_csr.cu",
                        "src/repro/kernels/graph_sconv.py:110"),
    "windowed_similarity": ("src/repro_torch/csrc/window_sim.cu",
                            "src/repro/kernels/window_sim.py:48"),
    "graph_sconv": ("src/repro_torch/csrc/graph_sconv.cu",
                    "src/repro/kernels/graph_sconv.py:52"),
    "cavity_tconv": ("src/repro_torch/csrc/cavity_tconv.cu",
                     "src/repro/kernels/cavity_tconv.py:99"),
    "cavity_tconv_step": ("src/repro_torch/csrc/cavity_tconv_step.cu",
                          "src/repro/kernels/cavity_tconv.py:67"),
    "rfc_encode": ("src/repro_torch/csrc/rfc_pack.cu",
                   "src/repro/kernels/rfc_pack.py:67"),
    "rfc_decode": ("src/repro_torch/csrc/rfc_pack.cu",
                   "src/repro/kernels/rfc_pack.py:87"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cuh",
                     "src/repro/kernels/flash_decode.py:72"),
    # the same kernel's partial form and its first pass alone, over a
    # kv_seq shard (GSPMD runs the TPU kernel's caller per shard there)
    "flash_decode_partial": ("src/repro_torch/csrc/flash_decode.cuh",
                             "src/repro/kernels/flash_decode.py:72"),
    "flash_decode_row_max": ("src/repro_torch/csrc/flash_decode.cuh",
                             "src/repro/kernels/flash_decode.py:72"),
}
ARCH, BATCH, CLIPS, SEED = "agcn-2s", 8, 32, 0
DEVICE = "cuda"
STREAM_CLIPS = 4                   # 8 sequences of 2 persons
STREAM_SLOTS = (1, 3, 8)           # the stream shapes the kernels are held at
STREAM_WARM = 200                  # raw frames before a held stream tick
SLAB_SLOTS, SESSIONS, SESSION_FRAMES, EVENTS, RING_ROWS = 8, 12, 64, 4, 4
TOPO_CLIPS = 32                    # ntu50 sequences in the topology phase
MIXED_SESSIONS, MIXED_FRAMES, MIXED_EVERY = 10, 48, 4
SESSIONS_N, SESSIONS_TIERS = 16, (4, 8)    # the full-width sessions trace
SESSIONS_GOLDEN_S = 30.0           # golden cells past the first five run
                                   # while the first ones took less
MIXED_SVC_FRAMES = 24              # frames per session of the mixed service
MESH_SHARDS = 4                    # logical shards of the sharded service
ROUTER_FRAMES, ROUTER_MOVE_AT = 48, 20     # the migrated clip, its move tick
VMAX = 50                          # slab width of the mixed and padded runs
DENSE_SKELETONS = (("hand21", 21), ("body_hand46", 46))
CSR_EPS = 1e-5                     # above B_k's 1e-6 init: D = degree
CARD_TESTS = "tests/test_torch_cuda_kernels.py"
SPIN_CYCLES = 2_000_000            # about 1 ms at the H100's boost clock
_CLOCK = {}                        # the spin kernel's cycles per ms
HOST_GAPS = set()                  # timings whose host time could not be
                                   # hidden behind a spin
LM_ARCH, LM_BATCH, LM_PROMPT, LM_GEN = "smollm-360m", 4, 496, 16
LM_BF16_PROMPT = 240               # the bf16-cache runs' prompt (a 256-slot
                                   # cache), shorter to fit the run's time
LM_EARLY = 16                      # an early serve step: valid = 17
LM_BF16_SHARE = 0.75               # bf16 caches: the backends' share of
                                   # bf16's own gap (lm_phase)
# flash_decode cases off the served run: (label, B, S, Hkv, G, D, valid)
FD_CASES = [("long context", 8, 32768, 5, 3, 64, 30000),
            ("danube ring", 4, 4096, 8, 4, 80, 4096),
            ("small odd", 2, 48, 1, 3, 20, 1)]
# flash_decode on a bf16 cache (float32 q), off the served bf16 run:
# (label, B, S, Hkv, G, D, valid, window): smollm's 32 768-slot context,
# gemma3 at D = 256 windowed and global, whisper's cross-attention
FD_BF16_CASES = [("bf16 long context", 8, 32768, 5, 3, 64, 32768, 0),
                 ("bf16 gemma3 local", 1, 1108, 8, 2, 256, 1101, 1024),
                 ("bf16 gemma3 global", 1, 1108, 8, 2, 256, 1101, 0),
                 ("bf16 whisper cross", 4, 1500, 12, 1, 64, 1500, 0)]
# the dryrun phase: one static cell per arch (launch.dryrun.run_cell on
# h100x8), and two cells run on the card at their per-card h100x8 shapes
# (arch, shape, the decode backend)
DRYRUN_CELLS = (("h2o-danube-1.8b", "decode_32k"),
                ("gemma3-12b", "decode_32k"),
                ("internlm2-20b", "decode_32k"),
                ("smollm-360m", "decode_32k"),
                ("whisper-small", "decode_32k"),
                ("llava-next-mistral-7b", "decode_32k"),
                ("qwen3-moe-30b-a3b", "decode_32k"),
                ("granite-moe-3b-a800m", "decode_32k"),
                ("xlstm-1.3b", "decode_32k"),
                ("zamba2-7b", "decode_32k"),
                ("agcn-2s", "gcn_infer"))
DRYRUN_WORKERS = 6
DRYRUN_REAL = (("smollm-360m", "decode_32k", "cuda"),
               ("agcn-2s", "gcn_infer", "reference"))

# the moe_vlm phase: decode at full width (qwen3 cut in depth: 48 float32
# layers are ~122 GB), llava's image prefill, then a text decode
MOE_ARCH, MOE_BATCH, MOE_PROMPT, MOE_GEN = "granite-moe-3b-a800m", 4, 64, 16
QWEN_ARCH, QWEN_LAYERS, QWEN_PROMPT, QWEN_GEN = "qwen3-moe-30b-a3b", 16, 32, 16
VLM_ARCH, VLM_BATCH, VLM_PROMPT, VLM_GEN = "llava-next-mistral-7b", 4, 32, 16
VLM_PREFILL_TEXT = 32              # text tokens after the 2 880 image tokens
# the dist_train phase: (arch, layers or 0 for all, batch, seq, steps)
DIST_TRAIN = (("granite-moe-3b-a800m", 12, 4, 512, 4),
              ("smollm-360m", 0, 8, 512, 6))
DIST_NCCL = "smollm-360m"           # the entry run again under torchrun
DIST_LR = 3e-4
# the model_parallel phase: (arch, layers) at full width on a (1, 2) mesh,
# MP_STEPS train steps of MP_BATCH x MP_SEQ, then MP_DECODE decode steps
# over MP_DECODE_SLOTS; smollm's kv_seq decode at batch 1 over a bf16
# cache of MP_KV_SLOTS slots from 3 * MP_KV_STEPS before its end,
# MP_KV_STEPS steps
MP_TRAIN = (("granite-moe-3b-a800m", 4), ("h2o-danube-1.8b", 4),
            ("xlstm-1.3b", 8), ("zamba2-7b", 7), ("whisper-small", 4))
# the families whose float32 gaps may be checked again in float64
MP_F64_FAMILIES = ("ssm", "hybrid")
MP_BATCH, MP_SEQ, MP_STEPS, MP_DECODE, MP_DECODE_SLOTS = 2, 64, 3, 8, 16
# a decoder's decode starts with a prompt of MP_PROMPT tokens in one step
# (even: sequence-parallel on the (1, 2) mesh), then one token a step
MP_PROMPT = 4
# sequence parallelism against the replicated layout: (arch, layers,
# batch, seq), a train step's forward and backward each way on (1, 2),
# losses within MP_SP_TOL
MP_SP_CASE, MP_SP_TOL = ("h2o-danube-1.8b", 4, 2, 1024), 1e-5
MP_KV_ARCH, MP_KV_SLOTS, MP_KV_STEPS = "smollm-360m", 131072, 8
MP_TIMEOUT = 420                   # the ranks' deadline, seconds
# flash_decode at a (1, 2) rank's head shards of that decode: (label, B,
# S, Hkv / 2, G, D, valid)
MP_FD_CASES = [("mp zamba2 rank", MP_BATCH, MP_DECODE_SLOTS, 16, 1, 112,
                MP_DECODE),
               ("mp whisper self rank", MP_BATCH, MP_DECODE_SLOTS, 6, 1, 64,
                MP_DECODE),
               ("mp whisper cross rank", MP_BATCH, 1500, 6, 1, 64, 1500)]

# the zoo phase: (arch, layers or 0 for all, batch, prompt, gen, backends,
# bound on the cached decode against the cache-free forward, or None:
# printed, and held in float64 and at ZOO_CUT_LAYERS instead); internlm2's
# 48 float32 layers (77 GB) do not fit one card beside the CUDA context
ZOO_SERVE = (("xlstm-1.3b", 0, 4, 16, 16, ("cuda",), None),
             ("zamba2-7b", 0, 4, 16, 16, ("cuda", "reference"), None),
             ("whisper-small", 0, 4, 16, 16, ("cuda", "reference"), 1e-3),
             ("gemma3-12b", 0, 1, 16, 16, ("cuda", "reference"), 1e-3),
             ("internlm2-20b", 32, 4, 16, 16, ("cuda",), 1e-3))
GEMMA_LONG, GEMMA_STEPS = 1100, 8  # gemma3's long prefill, then its steps
# the SSM and hybrid step recurrence against the chunked scan: in float64
# at full depth (F64_BOUND, atol), and in float32 at full width cut to
# ZOO_CUT_LAYERS at JAX's own bound for the two families (atol = rtol,
# tests/test_models_smoke.py); at full depth float32 rounding alone moves
# their logits past 2e-2, so that gap is printed
F64_BOUND = 1e-6
ZOO_CUT_LAYERS, ZOO_CUT_BOUND = 16, 2e-2
# flash_decode at the zoo's shapes off the served runs: (label, B, S, Hkv,
# G, D, valid, window)
ZOO_FD_CASES = [("zoo zamba2 long", 4, 8192, 32, 1, 112, 8000, 0),
                ("zoo whisper cross", 4, 1500, 12, 1, 64, 1500, 0),
                ("zoo gemma3 local 32k", 1, 32768, 8, 2, 256, 30000, 1024),
                ("zoo gemma3 global 32k", 1, 32768, 8, 2, 256, 30000, 0),
                ("zoo internlm2 long", 4, 8192, 8, 6, 128, 8000, 0)]
# (arch, layers or 0, batch, seq, steps): zamba2's 81 layers hold about
# 92 GB of weights, gradients and moments, so its depth is cut (to 13:
# 2.3 s on an H100 against 12.0 s at 25 layers, which makes room for the
# model_parallel phase's sequence-parallel case); xlstm's 48 took 2.5-3.9
# s a step (its sLSTM loop), so it is cut to one group of 8
ZOO_TRAIN = (("xlstm-1.3b", 8, 2, 128, 3), ("zamba2-7b", 13, 2, 256, 3),
             ("whisper-small", 0, 2, 128, 3))

# the train phase: full agcn-2s, 16 clips (32 sequences) a step, 30 steps
TRAIN_CLIPS, TRAIN_STEPS, TRAIN_CKPT_AT = 16, 30, 10
RFC_CKPT_SHAPE = (4096, 1024, 4096)        # x (M, d) · wi (d, f) · wo (f, d)
# Drop-1/2/3 × cavity: (compression ratio, graph-skip efficiency) of
# benchmarks/torch_paper.py:compression_table, numbers the CPU tests hold
# equal to the JAX pruning_bench's (tests/test_torch_accounting.py)
COMPRESSION_TABLE = {
    "drop1/cav-50-1": (3.430477579292745, 0.5792207792207793),
    "drop1/cav-70-1": (4.759635811836115, 0.5792207792207793),
    "drop1/cav-75-1": (5.3428344310697256, 0.5792207792207793),
    "drop2/cav-50-1": (3.897365805168986, 0.6562770562770563),
    "drop2/cav-70-1": (5.469541966984422, 0.6562770562770563),
    "drop2/cav-75-1": (6.172789294148518, 0.6562770562770563),
    "drop3/cav-50-1": (4.418576258452291, 0.7238095238095238),
    "drop3/cav-70-1": (6.274873299546546, 0.7238095238095238),
    "drop3/cav-75-1": (7.116775071849947, 0.7238095238095238),
}


T_START = time.perf_counter()


def phase_done(name: str) -> None:
    print(f"time: {name} phase done {time.perf_counter() - T_START:.1f} s "
          f"after start")


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def spin_cycles_per_ms() -> float:
    """The spin kernel's clock cycles per ms on this card (timed once, the
    second of two spins, after the first has woken the clocks)."""
    import torch
    if "cycles_per_ms" not in _CLOCK:
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            torch.cuda._sleep(SPIN_CYCLES)
            end.record()
            end.synchronize()
            _CLOCK["cycles_per_ms"] = SPIN_CYCLES / start.elapsed_time(end)
    return _CLOCK["cycles_per_ms"]


def cuda_ms(fn, reps: int = 7, inner: int = 10, label: str = "",
            waits: bool = False) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, by CUDA events, after one warm-up call.

    The host's queueing must not enter the device time, so each
    repetition first queues a spin kernel that outlasts the host's time to
    queue the ``inner`` calls: that time is measured once before the
    repetitions and again in each; a repetition whose queueing outlasted
    its spin (a host hiccup) is run again with a spin twice as long as the
    queueing took, up to three tries.  The device then reaches the first
    call only once the last is queued, and the events time its work alone.
    A call that waits for the device itself (``waits``: the plain versions
    that read their taps on the host), or whose launches fill the launch
    queue behind the spin (three tries fail), cannot be hidden so: it runs
    without a spin and is timed with its waits, and ``label`` goes into
    ``HOST_GAPS``."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        for _ in range(1 if waits else 3):
            spin_ms = 0.0 if waits else max(1.0, 2.0 * host_ms + 0.5)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if spin_ms:
                torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
            h0 = time.perf_counter()
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            queued_ms = (time.perf_counter() - h0) * 1e3
            end.synchronize()
            if queued_ms < spin_ms:
                break
            host_ms = queued_ms
        else:
            # the calls wait for the device (or fill the launch queue behind
            # the spin): the remaining repetitions run without one
            waits = True
            if label:
                HOST_GAPS.add(label)
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _clone_tree(a):
    """A copy of ``a`` (tensors, None, and tuples and dicts of them) in
    storage of its own, with each tensor's strides."""
    import torch
    if isinstance(a, torch.Tensor):
        return a.clone()
    if isinstance(a, (tuple, list)):
        return type(a)(_clone_tree(x) for x in a)
    if isinstance(a, dict):
        return {k: _clone_tree(x) for k, x in a.items()}
    return a


def rotating(call, args, in_bytes: float):
    """``call(args)`` on copies of ``args`` in turn, enough that their
    inputs together exceed twice the L2 (at most 64 copies): a call then
    finds none of its inputs left in L2 by the calls before it, as a byte
    bound from HBM assumes.  Returns the function and whether the copies
    do exceed twice the L2 (small inputs stay resident)."""
    import torch
    l2 = getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                 50 << 20)
    n = min(64, max(2, -(-2 * l2 // max(int(in_bytes), 1))))
    copies = [_clone_tree(args) for _ in range(n)]
    k = [0]

    def fn():
        k[0] = (k[0] + 1) % n
        return call(copies[k[0]])
    return fn, n * in_bytes > 2 * l2


def bound_ms(nbytes: float, flops: float, rate: float = F32_FLOP_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), t_bytes, t_ops


def capture(modules, run):
    """Call ``run()`` with each kernel wrapper wrapped by a recorder;
    returns {kernel: [(args, kwargs), ...]} with cloned tensor inputs."""
    import torch
    gs, ct, rp, ws = modules
    targets = [(gs, "graph_sconv_cuda", "graph_sconv"),
               (ct, "cavity_tconv_cuda", "cavity_tconv"),
               (ct, "cavity_tconv_step_ring_cuda", "cavity_tconv_step"),
               (rp, "rfc_encode_cuda", "rfc_encode"),
               (rp, "rfc_decode_cuda", "rfc_decode"),
               (gs, "graph_sconv_csr_cuda", "graph_sconv_csr"),
               (ws, "windowed_similarity_cuda", "windowed_similarity"),
               (ws, "windowed_similarity_step_cuda", "windowed_similarity")]
    captured = {name: [] for _, _, name in targets}
    originals = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def clone(a):
        if isinstance(a, dict):             # the RFC step form's old leaves
            return {k: clone(v) for k, v in a.items()}
        return a.clone() if torch.is_tensor(a) else a

    def recorder(orig, name):
        def rec(*args, **kwargs):
            captured[name].append((tuple(clone(a) for a in args),
                                   dict(kwargs)))
            return orig(*args, **kwargs)
        return rec

    try:
        for (mod, attr, orig), (_, _, name) in zip(originals, targets):
            setattr(mod, attr, recorder(orig, name))
        run()
        torch.cuda.synchronize()
    finally:
        for mod, attr, orig in originals:
            setattr(mod, attr, orig)
    return captured


def _chrono(ring, head):
    """Each slot's window (S, K, V, C) gathered oldest first from its ring
    at ``head``."""
    import torch
    S, K, V, C = ring.shape
    idx = (head.long()[:, None] + torch.arange(K, device=ring.device)) % K
    return torch.gather(ring, 1, idx[:, :, None, None].expand(S, K, V, C))


def _dense_cavity(wp, taps, ks):
    """The masked dense weights (F, C, K) of packed cavity weights, filter
    f = g + L*i in natural order."""
    import torch
    L, n_keep, C, Fg = wp.shape
    w_dense = torch.zeros(L * Fg, C, ks, device=wp.device)
    for g, row in enumerate(taps.tolist()):
        for j, off in enumerate(row):
            w_dense[g::L, :, off] += wp[g, j].T
    return w_dense


def measure_case(name, args, kwargs, modules, served=True):
    """Kernel vs plain on one captured input: error, pass/fail, times and
    the bound on this card.  ``served``: the input comes from a served
    model's step (the cap of a bf16 flash_decode's bound)."""
    import torch
    import torch.nn.functional as F
    gs, ct, rp, ws = modules
    from repro_torch.kernels import flash_decode as fd
    library, as_kernel, composite, extra, tol = None, None, None, {}, None
    exact = len(args) if name.startswith("rfc") else 0   # bit-equal outputs
    if name == "graph_sconv":
        x, g, w = args
        kern = lambda: gs.graph_sconv_cuda(x, g, w)
        plain = lambda: gs.graph_sconv_plain(x, g, w)
        library = lambda: torch.einsum("rvc,kwv,kco->rwo", x, g, w)
        flops, nbytes = gs.graph_sconv_work(*x.shape, w.shape[2], w.shape[0])
    elif name == "cavity_tconv":
        x, wp, taps, inv, nf = args
        ks, stride = kwargs["kernel_size"], kwargs["stride"]
        kern = lambda: ct.cavity_tconv_cuda(x, wp, taps, inv, nf,
                                            kernel_size=ks, stride=stride)
        plain = lambda: ct.cavity_tconv_plain(x, wp, taps, inv, nf,
                                              kernel_size=ks, stride=stride)
        N, T, V, C = x.shape
        # the yardstick: one cuDNN conv of the dense masked weights, in
        # natural filter order, over (N, C, T, V)
        x4 = x.permute(0, 3, 1, 2).contiguous()
        w4 = _dense_cavity(wp, taps, ks)[:nf].unsqueeze(-1)
        library = lambda: F.conv2d(x4, w4, stride=(stride, 1),
                                   padding=(ks // 2, 0))
        as_kernel = lambda: library().permute(0, 2, 3, 1)
        T_out = ct.t_out(T, ks, stride)
        # the (filter, tap) pairs this data needs: kept filters' packed
        # slots with weights
        live = inv[:nf]
        slots = (wp != 0).any(dim=2).permute(0, 2, 1).reshape(-1, wp.shape[1])
        pairs = int(slots[live].sum())
        flops, nbytes = ct.cavity_tconv_work(N, T, V, C, *wp.shape[:2],
                                             wp.shape[3], nf, T_out, pairs)
    elif name == "cavity_tconv_step":
        ring, head, wp, taps, slot_col, bias = args
        kern = lambda: ct.cavity_tconv_step_ring_cuda(*args)
        plain = lambda: ct.cavity_tconv_step_ring_plain(*args)
        S, K, V, C = ring.shape
        L, n_keep, _, Fg = wp.shape
        cout = bias.shape[0]
        # the yardstick: one einsum of the chronological windows (gathered
        # here, outside the timing) with the dense masked weights laid out
        # in output-column order; the bias and the zero columns follow
        xb = _chrono(ring, head).permute(0, 2, 1, 3).reshape(S * V, K, C)
        src = ct.column_sources(slot_col, cout)
        live = src < L * Fg
        filt = torch.where(live, src % Fg * L + src // Fg, 0)
        w_cols = _dense_cavity(wp, taps, K)[filt] * live[:, None, None]
        library = lambda: torch.einsum("bkc,fck->bf", xb, w_cols)
        as_kernel = lambda: torch.where(live, library() + bias, 0.0).reshape(
            S, V, cout)
        # (slot, tap) pairs with weights on live slots
        pairs = int(((wp != 0).any(dim=2)
                     & (slot_col.reshape(L, 1, Fg) >= 0)).sum())
        # the frames some group reads (the union of the kept taps)
        frames = len(set(taps.flatten().tolist()))
        flops, nbytes = ct.cavity_tconv_step_work(S, K, V, C, L, n_keep, Fg,
                                                  cout, pairs, frames)
    elif name == "graph_sconv_csr":
        x, idx, val, w = args
        kern = lambda: gs.graph_sconv_csr_cuda(x, idx, val, w)
        plain = lambda: gs.graph_sconv_csr_plain(x, idx, val, w)
        R, V, Cin = x.shape
        K, _, Cout = w.shape
        # the yardstick: the dense 3-operand einsum on the densified graph
        g = torch.zeros(K, V, V, device=x.device).scatter_add_(
            2, idx.long(), val)
        library = lambda: torch.einsum("rvc,kwv,kco->rwo", x, g, w)
        nnz = int((val != 0).sum())            # the entries this graph has
        flops, nbytes = gs.graph_sconv_csr_work(R, V, Cin, Cout, K,
                                                idx.shape[-1], nnz)
    elif name == "windowed_similarity":
        th, ph, valid = args[0], args[1], args[-1]
        S, K, V, Ce = th.shape
        if len(args) == 8:      # the step form, as the C_k stream calls it
            kern = lambda: ws.windowed_similarity_step_cuda(*args)
            plain = lambda: ws.windowed_similarity_step_plain(*args)
            new_th, new_ph, _ = plain()
            exact = 2                       # the new rings: bit-equal
            has, inv = args[5], args[6]
            n_has, n_e = int(has.sum()), int((has & inv).sum())
            # the ring rows not overwritten, the embeddings written, the
            # flags; the new rings and the graph
            flops, nbytes = ws.windowed_similarity_work(
                S, K, V, Ce, valid, step=True, n_has=n_has, n_e=n_e)
            extra["form"] = "step"
        else:
            kern = lambda: ws.windowed_similarity_cuda(th, ph, valid)
            plain = lambda: ws.windowed_similarity_plain(th, ph, valid)
            new_th, new_ph = th, ph
            flops, nbytes = ws.windowed_similarity_work(S, K, V, Ce, valid)
            extra["form"] = "bare"
        # the yardstick: four PyTorch calls on the (new) rings, stacked
        # here outside the timing (no one call computes this function)
        rings = torch.stack((new_th, new_ph))
        dead = torch.arange(V, device=th.device) >= valid
        buf = torch.empty(S, V, V, device=th.device)

        def composite():
            win = rings.sum(2)
            lg = torch.baddbmm(buf, win[0], win[1].transpose(1, 2), beta=0.0,
                               alpha=1.0 / Ce ** 0.5)
            return torch.softmax(lg.masked_fill(dead, -1e30), dim=-1)
    elif name == "flash_decode":
        q, k, v, valid = args
        window = kwargs.get("window", 0)
        kern = lambda: fd.flash_decode(q, k, v, valid, window=window)
        plain = lambda: fd.flash_decode_plain(q, k, v, valid, window)
        B, Hkv, G, D = q.shape
        S = k.shape[1]
        if k.dtype == torch.float32:
            slots = torch.arange(S, device=k.device)
            live = slots < valid
            if window:
                live &= slots >= valid - window
            live = live.view(1, 1, 1, S)
            qh = q.reshape(B, Hkv * G, 1, D)
            kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
            library = lambda: F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=live, enable_gqa=True).reshape(q.shape)
        else:
            # a bf16 cache with float32 q: no one PyTorch call computes
            # this function; the bound is a share of the gap the bf16
            # rounding of p opens, which a kernel skipping it would read
            gap = fd.bf16_rounding_gap(q, k, v, valid, window)
            tol = fd.bf16_bound(gap, fd.BF16_CAP_SERVED if served
                                else fd.BF16_CAP_RANDOM)
        # the rows the softmax needs (the kernel reads no row past valid,
        # nor below the window's bound)
        n = int(valid.item())
        lo = max(0, n - window) if window else 0
        n = min(n, S) if n >= 1 else S
        n = n - lo if lo < n else S
        flops, nbytes = fd.flash_decode_work(B, S, Hkv, G, D,
                                             k.element_size(), rows=n)
        p = fd.decode_plan(B, S, Hkv, G, D, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
        extra = {"plan": [p.splits, p.warps, p.stages], "window": window,
                 "cache": str(k.dtype).replace("torch.", "")}
        if tol is not None:
            extra.update(bf16_bound=tol, bf16_gap=gap)
    elif name == "rfc_encode":
        t, res, live, keep, old = args
        call = lambda a: rp.rfc_encode_cuda(*a)
        kern = lambda: call(args)
        plain = lambda: rp.rfc_encode_plain(*args)
        C = t.shape[-1]
        rows = t.numel() // C
        # the rows whose t (and res) this run needs: emitting slots' live
        # joints; the other slots read their old leaves instead
        need = torch.ones(rows, dtype=torch.bool, device=t.device)
        n_old = 0
        if keep is not None:
            need &= keep.repeat_interleave(rows // t.shape[0])
            n_old = rows - int(need.sum())
        if live is not None:
            need &= live.repeat(rows // live.numel())
        n_need = int(need.sum())
        flops, nbytes = rp.rfc_encode_work(
            rows, C, res is not None, n_need, n_old,
            sum(m.numel() for m in (live, keep) if m is not None))
        in_bytes = sum(a.numel() * a.element_size() for a in
                       (t, res, live, keep, *(old or {}).values())
                       if a is not None)
    else:
        values, bits = args
        call = lambda a: rp.rfc_decode_cuda(*a)
        kern = lambda: call(args)
        plain = lambda: rp.rfc_decode_plain(values, bits)
        flops, nbytes = rp.rfc_decode_work(values.numel())
        in_bytes = 4 * values.numel() + 2 * bits.numel()

    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a - b).abs().max()) if a.numel() else 0.0
              for a, b in zip(got, want))
    ok = all(torch.equal(a, b) if i < exact else
             torch.allclose(a, b, atol=1e-4, rtol=1e-4) if tol is None else
             float((a - b).abs().max()) <= tol
             for i, (a, b) in enumerate(zip(got, want)))
    if library is not None:
        ref = as_kernel() if as_kernel is not None else library()
        ok = ok and torch.allclose(got[0], ref, atol=1e-4, rtol=1e-4)
    if composite is not None:
        ok = ok and torch.allclose(got[-1], composite(), atol=1e-4,
                                   rtol=1e-4)
    tc = name in TENSOR_CORE_KERNELS
    b_ms, t_bytes, t_ops = bound_ms(nbytes, flops,
                                    TF32_FLOP_PER_S if tc else F32_FLOP_PER_S)
    timed = kern
    if name.startswith("rfc"):
        # bound by bytes from HBM: timed on inputs no earlier call left in
        # L2, with the time on one set of inputs beside it
        extra["ms_l2"] = cuda_ms(kern, label=f"{name} kernel")
        timed, extra["cold"] = rotating(call, args, in_bytes)
    return {
        "shape": [list(a.shape) for a in args if hasattr(a, "shape")],
        "stride": kwargs.get("stride"), "ok": bool(ok), "max_abs_err": err,
        "ms": cuda_ms(timed, label=f"{name} kernel"),
        "plain_ms": cuda_ms(plain, reps=3, inner=3, label=f"{name} plain",
                            waits=name.startswith("cavity")),
        "library_ms": (cuda_ms(library, label=f"{name} library")
                       if library is not None else None),
        # a yardstick of several PyTorch calls, not a library kernel
        "composite_ms": (cuda_ms(composite, label=f"{name} composite")
                         if composite is not None else None),
        "bound_ms": b_ms, "bytes_ms": t_bytes, "ops_ms": t_ops,
        # the float32 CUDA-core bound and, on the tensor cores, the 3-pass
        # split's own floor (three TF32 products per product)
        "bound_f32_ms": bound_ms(nbytes, flops)[0],
        "split_floor_ms": (bound_ms(nbytes, 3 * flops, TF32_FLOP_PER_S)[0]
                           if tc else None),
        **extra,
    }


def summarize(cs):
    """Per-step sums over the cases of one kernel on one path."""
    t_bytes = sum(c["bytes_ms"] for c in cs)
    t_ops = sum(c["ops_ms"] for c in cs)
    out = {
        "max_abs_err": max(c["max_abs_err"] for c in cs),
        "ms": sum(c["ms"] for c in cs),
        "plain_ms": sum(c["plain_ms"] for c in cs),
        "bound_ms": sum(c["bound_ms"] for c in cs),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": (sum(c["library_ms"] for c in cs)
                       if cs[0]["library_ms"] is not None else None),
        "bound_f32_ms": sum(c["bound_f32_ms"] for c in cs),
    }
    if cs[0]["split_floor_ms"] is not None:
        out["split_floor_ms"] = sum(c["split_floor_ms"] for c in cs)
    if cs[0]["composite_ms"] is not None:
        out["composite_ms"] = sum(c["composite_ms"] for c in cs)
        out["form"] = cs[0]["form"]
    if "ms_l2" in cs[0]:
        out["ms_l2"] = sum(c["ms_l2"] for c in cs)
        out["cold"] = all(c["cold"] for c in cs)
    return out


def device_rows(run, steps: int = 2):
    """(wall ms, rows) per call over ``steps`` calls of ``run`` under
    ``torch.profiler``, after one warm-up call: rows of (device ms, count,
    name) per kernel or copy, device-side events only (operator rows
    repeat their kernels); no rows when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", 0) or 0
        if dev_us > 0:
            rows.append((dev_us / 1e3 / steps, e.count / steps, e.key))
    return wall_ms, rows


def profile_steps(label, run, steps: int = 2) -> None:
    """Print the device's busy share and its time by kernel name over
    ``steps`` calls of ``run``, from ``torch.profiler``."""
    wall_ms, rows = device_rows(run, steps)
    if not rows:
        print(f"profile {label}: the profiler recorded no device time "
              f"(not measured)")
        return
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile {label}: {wall_ms:.3f} ms wall per step under the "
          f"profiler, device busy {busy:.3f} ms ({busy / wall_ms * 100:.1f}%), "
          f"{sum(r[1] for r in rows):.0f} kernels and copies per step")
    for ms, count, key in rows[:15]:
        print(f"profile {label}: {ms:8.3f} ms {count:5.0f}x {key[:90]}")


def run_slab_script(tick, plans, slabs, rings, clips, flush, dev):
    """Drive the fused tick through a fixed session script: staggered
    arrivals, a hold, a preemption into the snapshot ring with a foreign
    session admitted into the slot, a swap (snapshot and restore of one
    slot in one tick), restores into freed slots, drains.  Returns
    ({session: logits at eviction}, per-tick wall ms, {event: count},
    slabs, rings)."""
    import numpy as np
    import torch
    from repro_torch.core.agcn.engine import SNAP_SENTINEL
    S, T = SLAB_SLOTS, SESSION_FRAMES
    V, C = clips.shape[2], clips.shape[3]
    arrival = {sid: 6 * sid for sid in range(len(clips))}
    HOLD_SID, HOLD_AT, HOLD_TICKS = 2, 30, 4
    PREEMPT_SID, PREEMPT_AT, SWAP_SID, SWAP_AT = 1, 50, 4, 60
    queue = collections.deque(sorted(arrival, key=arrival.get))
    waiting = collections.deque()      # (sid, ring row, eligible from tick)
    slots = [None] * S
    pos, got, lat = {}, {}, []
    held, preempted = 0, False
    counts = collections.Counter()
    for t in range(5000):
        if not queue and not waiting and all(s is None for s in slots):
            break
        snap, rest = [], []
        reset = np.zeros(S, bool)
        hold = np.zeros(S, bool)
        for s, sid in enumerate(slots):
            if sid == PREEMPT_SID and pos[sid] == PREEMPT_AT and not preempted:
                preempted = True
                snap.append((s, 0))
                waiting.append((sid, 0, t + 1))
                slots[s] = None
            elif (sid == SWAP_SID and pos[sid] == SWAP_AT
                  and waiting and waiting[0][0] == PREEMPT_SID):
                _, row, _ = waiting.popleft()
                snap.append((s, 1))
                rest.append((s, row))
                waiting.append((sid, 1, t + 1))
                slots[s] = PREEMPT_SID
            elif sid == HOLD_SID and pos[sid] == HOLD_AT and held < HOLD_TICKS:
                hold[s] = True
                held += 1
        for s in range(S):
            if slots[s] is not None:
                continue
            if waiting and waiting[0][2] <= t:
                sid, row, _ = waiting.popleft()
                rest.append((s, row))
                slots[s] = sid
            elif queue and arrival[queue[0]] <= t:
                sid = queue.popleft()
                reset[s], slots[s], pos[sid] = True, sid, 0
        frames = np.zeros((S, V, C), np.float32)
        valid = np.zeros(S, bool)
        for s, sid in enumerate(slots):
            if sid is not None and pos[sid] < T:
                frames[s], valid[s] = clips[sid, pos[sid]], True

        def order(events):
            o = np.full((EVENTS, 2), SNAP_SENTINEL, np.int32)
            if events:
                o[:len(events)] = events
            return torch.from_numpy(o).to(dev)

        counts.update(snapshot=len(snap), restore=len(rest),
                      admit=int(reset.sum()), hold=int(hold.sum()))
        inputs = (torch.from_numpy(frames).to(dev),
                  torch.from_numpy(valid).to(dev),
                  torch.from_numpy(reset).to(dev),
                  torch.from_numpy(hold).to(dev), order(snap), order(rest))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        slabs, logits, rings = tick(plans, slabs, *inputs, rings)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        for s, sid in enumerate(slots):
            if sid is None or hold[s]:
                continue
            pos[sid] += 1
            if pos[sid] == T + flush:
                got[sid] = logits[s].cpu().numpy()
                slots[s] = None
    counts["ticks"] = len(lat)
    return got, lat, counts, slabs, rings


def counted(run):
    """``run()`` between a reset and a read of the launch counters:
    returns (its result, {kernel: launches})."""
    from repro_torch.kernels import _build
    _build.reset_launch_counts()
    out = run()
    return out, dict(_build.LAUNCHES)


def first_slots(state, S: int):
    """The stream state of the first ``S`` slots of ``state`` (slots are
    independent, so it equals a state warmed with S slots)."""
    import torch
    from repro_torch.core.agcn import engine
    idx = torch.arange(S, device=state.t_raw.device)
    return dataclasses.replace(state, **engine.snapshot_slots(state, idx))


def clip_run(infer, plans, batches, dev):
    """One warm-up ensemble step, then every batch, timed on the host
    clock up to a synchronise.  Returns (logits numpy, sequences/s,
    ensemble steps run)."""
    import torch
    infer(plans, batches[0])
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    outs = [infer(plans, xb) for xb in batches]
    torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    n = sum(xb.shape[0] for xb in batches)
    return torch.cat(outs).cpu().numpy(), n / dt, len(batches) + 1


def stream_run(step, plans, states, clip, flush, dev):
    """``serve_gcn_stream``'s loop: two discarded warm-up steps (a clip
    frame, a flush frame), then the clip frame by frame and the drain,
    each step timed on the host clock up to a synchronise.  Returns
    (states, per-step logits, per-step ms, the states STREAM_WARM raw
    frames in: steps return new states, so the run's own serve to hold
    the kernels on a tick past the first-logit delay)."""
    import torch
    T = clip.shape[1]
    zeros = torch.zeros_like(clip[:, 0])
    step(plans, states, clip[:, 0], True)
    step(plans, states, zeros, False)
    torch.cuda.synchronize(dev)
    logits, lat = [], []
    for r in range(T + flush):
        if r == STREAM_WARM:
            warm = states
        t0 = time.perf_counter()
        states, out = step(plans, states, clip[:, r] if r < T else zeros,
                           r < T)
        torch.cuda.synchronize(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
        logits.append(out)
    return states, logits, lat, warm


def run_mixed_script(slab_step, groups, slabs, sessions, flush, dev):
    """Drive a Vmax-wide slab shared by skeleton groups: sessions
    (skeleton, arrival tick, clip) take the first free slot at or after
    their arrival, and each tick steps every group that has a live slot
    with one ``slab_step`` over the whole slab (that group's plans and BN
    statistics, the slab's other slots held), as the JAX service's
    ``_step_groups`` does.  Returns ({session: eviction logits}, per-tick
    wall ms, dispatches, {skeleton: admissions into a slot another
    skeleton used before})."""
    import numpy as np
    import torch
    S = SLAB_SLOTS
    queue = collections.deque(range(len(sessions)))
    slots, pos, got, lat = [None] * S, {}, {}, []
    last_topo = [None] * S
    reused = collections.Counter()
    dispatches = 0
    for t in range(10000):
        if not queue and all(s is None for s in slots):
            break
        reset = np.zeros(S, bool)
        for s in range(S):
            if slots[s] is None and queue and sessions[queue[0]][1] <= t:
                sid = queue.popleft()
                topo = sessions[sid][0]
                if last_topo[s] not in (None, topo):
                    reused[topo] += 1
                slots[s], pos[sid], reset[s], last_topo[s] = sid, 0, True, topo
        frames = np.zeros((S, VMAX, 3), np.float32)
        valid = np.zeros(S, bool)
        for s, sid in enumerate(slots):
            if sid is not None and pos[sid] < sessions[sid][2].shape[0]:
                clip = sessions[sid][2][pos[sid]]
                frames[s, : clip.shape[0]] = clip
                valid[s] = True
        inputs = [torch.from_numpy(a).to(dev) for a in (frames, valid, reset)]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        rows = {}
        for topo, (plans, stats) in groups.items():
            m = np.array([sid is not None and sessions[sid][0] == topo
                          for sid in slots])
            if not m.any():
                continue
            mask = torch.from_numpy(m).to(dev)
            slabs, logits = slab_step(plans, slabs, inputs[0],
                                      inputs[1] & mask, inputs[2] & mask,
                                      ~mask, stats=stats)
            dispatches += 1
            rows.update({s: logits[s] for s in np.flatnonzero(m)})
        torch.cuda.synchronize(dev)
        lat.append((time.perf_counter() - t0) * 1e3)
        for s, sid in enumerate(slots):
            if sid is None:
                continue
            pos[sid] += 1
            if pos[sid] == sessions[sid][2].shape[0] + flush:
                got[sid] = rows[s].cpu().numpy()
                slots[s] = None
    return got, lat, dispatches, reused


def record_decode(steps, per_step):
    """Wrap the decode attention's ``flash_decode`` (as the attention
    layer calls it) with a recorder of the calls of serve ``steps`` (call
    i belongs to step i // per_step, the launches of one step): returns
    (restore(), {step: [(args, kwargs), ...]}) with cloned inputs."""
    import torch
    from repro_torch.models.layers import attention
    orig, seen = attention.flash_decode, [0]
    got = {s: [] for s in steps}

    def rec(*args, **kwargs):
        step = seen[0] // per_step
        seen[0] += 1
        if step in got:
            got[step].append((tuple(a.clone() if torch.is_tensor(a) else a
                                    for a in args), dict(kwargs)))
        return orig(*args, **kwargs)

    attention.flash_decode = rec

    def restore():
        attention.flash_decode = orig
    return restore, got


def hold_flash_decode(path, calls, cases, summary, failures, modules,
                      served=True):
    """Hold flash_decode against its plain version on recorded calls
    (``served``: a served model's, else random inputs) and time them; one
    ``kernel flash_decode`` line."""
    cs = [measure_case("flash_decode", a, k, modules, served)
          for a, k in calls]
    cases[f"{path}/flash_decode"] = cs
    bad = [i for i, c in enumerate(cs) if not c["ok"]]
    if bad:
        failures.append(f"{path} flash_decode: kernel disagrees with its "
                        f"plain version on cases {bad}")
    sm = summary[(path, "flash_decode")] = summarize(cs)
    bf16 = ("; bf16 cache, bound " + ", ".join(f"{c['bf16_bound']:.3g}"
                                              for c in cs)
            + " (the float32 rules' gap " + ", ".join(
                f"{c['bf16_gap']:.3g}" for c in cs) + ")"
            if "bf16_bound" in cs[0] else "")
    lib = (f", sdpa {sm['library_ms']:.4f}" if sm["library_ms"] is not None
           else "")
    print(f"kernel flash_decode [{path}]: {'ok' if not bad else 'FAIL'} "
          f"on {len(cs)} inputs {cs[0]['shape']}, valid "
          f"{int(calls[0][0][3].item())}, window "
          f"{sorted({c['window'] for c in cs})}, splits/warps/stages "
          f"{'/'.join(map(str, cs[0]['plan']))}, max_abs_err "
          f"{sm['max_abs_err']:.3g}{bf16}; {sm['ms']:.4f} ms, "
          f"{sm['ms'] / len(cs) * 1e3:.2f} us a launch against "
          f"{sm['bound_ms'] / len(cs) * 1e3:.2f} us at the byte bound, "
          f"{sm['bound_ms'] / sm['ms'] * 100:.1f}% of the bound (plain "
          f"{sm['plain_ms']:.4f}{lib}, bound {sm['bound_ms']:.4f} ms by "
          f"{sm['bound_by']})")


def teacher_forced(label, cfg, params, res, ref, prompt, failures, dev,
                   cache_dtype=None, tol=None):
    """The ``reference`` backend teacher-forced on the ``cuda`` run's
    tokens: per-step logits within atol=rtol=1e-3, and a greedy token the
    reference would not pick only at its top-2 margin <= 1e-3.  While the
    free-running reference picked the tokens it was fed, its own logits
    serve; after a divergence it is run again on the cuda tokens.
    Returns (worst |diff|, the flips, the free-running token agreement,
    the cuda tokens on the device).  ``cache_dtype`` is the caches'
    (default float32); ``tol``, when given, replaces the 1e-3 with a
    bound on max |diff| (rtol 0) and on the flips' margins."""
    import numpy as np
    import torch
    from repro_torch.models import registry
    from repro_torch.train.steps import make_serve_step
    toks = res["tokens"]
    B, n = toks.shape
    steps = n - 1
    agree = float(np.mean(toks[:, prompt:] == ref["tokens"][:, prompt:]))
    tt = torch.from_numpy(toks).to(dev)
    if (ref["tokens"] == toks).all():
        forced = ref["logits"]
    else:
        step = make_serve_step(cfg, "reference")
        cache = registry.init_cache(cfg, B, n, device=dev,
                                    dtype=cache_dtype or torch.float32)
        forced = torch.stack([step(params, cache, {
            "tokens": tt[:, t:t + 1],
            "pos": torch.full((), t, dtype=torch.int32, device=dev)})[2]
            for t in range(steps)])
    worst = float((res["logits"] - forced).abs().max())
    atol, rtol = (1e-3, 1e-3) if tol is None else (tol, 0.0)
    close = torch.isclose(res["logits"], forced, atol=atol, rtol=rtol)
    if not bool(close.all()):
        bad = torch.nonzero(~close.flatten(1).all(1)).flatten().tolist()
        failures.append(f"{label}: logits of steps {bad[:10]} differ from "
                        f"the teacher-forced reference (max {worst:.3g})")
    top2 = forced[prompt - 1:].topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    differ = (forced[prompt - 1:].argmax(-1)
              != tt[:, prompt:].T).cpu().numpy()
    flips = [(prompt - 1 + t, b, float(margin[t, b]))
             for t, b in zip(*np.nonzero(differ))]
    hard = [f for f in flips if f[2] > atol]
    if hard:
        failures.append(f"{label}: greedy tokens differ from the "
                        f"reference's where its top-2 margin exceeds "
                        f"{atol:.3g}: {hard}")
    return worst, flips, agree, tt


def prefill_check(label, cfg, params, res, tt, prompt, failures):
    """The prompt's logits from the cache-free forward (the prefill path)
    against the cached decode's, within atol=rtol=1e-3, and a finite
    prefill loss; returns (max |diff|, loss)."""
    import torch
    from repro_torch.models import decoder
    from repro_torch.train.steps import make_prefill_step
    with torch.inference_mode():
        full, _, _ = decoder.forward(params, tt[:, :prompt], cfg)
        metrics = make_prefill_step(cfg)(params, {
            "tokens": tt[:, :prompt], "labels": tt[:, :prompt]})
    cached = res["logits"][:prompt].transpose(0, 1)
    pre = float((full - cached).abs().max())
    if not torch.allclose(full, cached, atol=1e-3, rtol=1e-3) or not bool(
            torch.isfinite(metrics["loss"])):
        failures.append(f"{label}: cache-free prompt logits differ from the "
                        f"cached decode by {pre:.3g} (prefill loss "
                        f"{float(metrics['loss'])})")
    return pre, float(metrics["loss"])


def lm_phase(dev, failures, cases, summary, check_launches, modules):
    """Phase 13: ``generate`` at full smollm-360m width on both backends,
    the teacher-forced and prefill agreement checks, flash_decode's launch
    count, cases and times, a sync-free step and a profiled step."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import registry
    from repro_torch.train.steps import make_serve_step

    cfg = get_config(LM_ARCH)
    steps = LM_PROMPT + LM_GEN - 1
    first, last = LM_PROMPT, steps - 1       # first step fed a generated token
    early = min(LM_EARLY, first - 1)
    params = registry.init_params(cfg, seed=SEED, device=dev)

    def hold(path, calls):
        hold_flash_decode(path, calls, cases, summary, failures, modules)

    restore, got = record_decode((early, first, last), cfg.num_layers)
    try:
        res, counts = counted(lambda: generate(
            LM_ARCH, reduced=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
            gen=LM_GEN, seed=SEED, backend="cuda", device=dev, params=params,
            keep_logits=True))
    finally:
        restore()
    check_launches("lm", counts, {"flash_decode": cfg.num_layers}, steps)
    launched = counts["flash_decode"]
    ref, counts = counted(lambda: generate(
        LM_ARCH, reduced=False, batch=LM_BATCH, prompt_len=LM_PROMPT,
        gen=LM_GEN, seed=SEED, backend="reference", device=dev,
        params=params, keep_logits=True))
    check_launches("lm reference", counts, {}, steps)
    for name, r in (("cuda", res), ("reference", ref)):
        print(f"lm: backend={name} {r['tokens_per_s']:.2f} tokens/s, serve "
              f"step p50 {r['latency_ms_p50']:.3f} ms mean "
              f"{r['latency_ms_mean']:.3f} ms ({LM_BATCH} sequences x "
              f"{r['steps']} steps, prompt {LM_PROMPT} fed token by token + "
              f"{LM_GEN} generated, full {LM_ARCH}, float32 cache)")
    toks = res["tokens"]
    if toks.shape != (LM_BATCH, LM_PROMPT + LM_GEN) or not np.isfinite(
            res["logits"].cpu().numpy()).all():
        failures.append(f"lm: tokens {toks.shape} or logits not finite")
    worst, flips, agree, tt = teacher_forced("lm", cfg, params, res, ref,
                                             LM_PROMPT, failures, dev)
    del ref["logits"]
    pre, ploss = prefill_check("lm", cfg, params, res, tt, LM_PROMPT,
                               failures)
    print(f"lm: teacher-forced reference vs cuda logits over {steps} steps "
          f"{worst:.3g}; greedy flips {flips} (allowed at top-2 margin <= "
          f"1e-3); generated-token agreement of the free-running backends "
          f"{agree * 100:.1f}%; cache-free prefill vs cached decode over the "
          f"{LM_PROMPT}-token prompt {pre:.3g}, prefill loss "
          f"{ploss:.4f}; flash_decode launches {launched} "
          f"in {steps} cuda steps ({cfg.num_layers} per step expected), "
          f"{sum(counts.values())} kernel launches on reference")

    # kernel cases: the served run's inputs, then shapes off the run
    hold("lm early decode step", got[early])
    hold("lm first decode step", got[first])
    hold("lm last step", got[last])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, B, S, Hkv, G, D, valid in FD_CASES:
        q = torch.randn(B, Hkv, G, D, generator=gen, device=dev)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
                for _ in range(2))
        hold(label, [((q, k, v, torch.full((1,), valid, dtype=torch.int32,
                                           device=dev)), {})])
        del q, k, v

    del res, ref
    bf16_runs(cfg, params, gen, failures, cases, summary, check_launches,
              modules, dev)

    # one decode step past the prompt may not sync with the host
    fstep = make_serve_step(cfg, "cuda")
    cache = registry.init_cache(cfg, LM_BATCH, LM_PROMPT + LM_GEN, device=dev)
    nxt, cache, _ = fstep(params, cache, {
        "tokens": tt[:, :1], "pos": torch.zeros((), dtype=torch.int32,
                                                device=dev)})
    batch = {"tokens": nxt[:, None],
             "pos": torch.ones((), dtype=torch.int32, device=dev)}
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        fstep(params, cache, batch)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("lm: one decode step under set_sync_debug_mode('error'): no "
              "host sync")
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode("default")
        failures.append(f"lm: the decode step syncs with the host: {e}")
    # a decode step near the end of the cache (position 500 of 512 slots),
    # profiled; the cache's positions are set back before each call (one
    # fill kernel)
    p0 = steps - 11
    at = torch.full((), p0, dtype=torch.int32, device=dev)

    def decode_step():
        cache["pos"].fill_(p0)
        fstep(params, cache, {"tokens": batch["tokens"], "pos": at})
    profile_steps("lm decode step", decode_step)


def bf16_runs(cfg, params, gen, failures, cases, summary, check_launches,
              modules, dev):
    """The lm phase on bf16 caches (the reference's default), at a
    ``LM_BF16_PROMPT``-token prompt: the served run on ``cuda``, the
    teacher-forced ``reference`` on bf16 caches, the gap to a float32-cache
    ``cuda`` run of the same prompt printed; flash_decode held on the bf16
    run's inputs and at ``FD_BF16_CASES``.  The two backends round the
    cache and the probabilities to bf16 at the same points, but a float32
    sum in another order flips a bf16 rounding now and then, and 32 layers
    amplify it (0.0335 read where 1e-3 was asked): the backends are held
    to ``LM_BF16_SHARE`` of the gap bf16 itself opens over the prompt
    between the reference on bf16 caches and the float32 forward of the
    same tokens (the rule tests/test_torch_lm.py holds against JAX)."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import decoder

    bf16 = torch.bfloat16
    P = LM_BF16_PROMPT
    steps = P + LM_GEN - 1
    first, last = P, steps - 1

    def hold(path, calls, served=True):
        hold_flash_decode(path, calls, cases, summary, failures, modules,
                          served)

    def serve(backend, dtype):
        return generate(LM_ARCH, reduced=False, batch=LM_BATCH,
                        prompt_len=P, gen=LM_GEN, seed=SEED, backend=backend,
                        device=dev, params=params, keep_logits=True,
                        cache_dtype=dtype)

    restore, got16 = record_decode((first, last), cfg.num_layers)
    try:
        res16, counts = counted(lambda: serve("cuda", bf16))
    finally:
        restore()
    check_launches("lm bf16", counts, {"flash_decode": cfg.num_layers},
                   steps)
    ref16, counts = counted(lambda: serve("reference", bf16))
    check_launches("lm bf16 reference", counts, {}, steps)
    res32 = serve("cuda", torch.float32)
    tt = torch.from_numpy(res16["tokens"]).to(dev)
    with torch.inference_mode():
        full, _, _ = decoder.forward(params, tt[:, :P - 1], cfg)
    own = float((ref16["logits"][:P - 1] - full.transpose(0, 1))
                .abs().max())
    del full
    bound16 = LM_BF16_SHARE * own + 1e-4
    worst16, flips16, agree16, _ = teacher_forced(
        "lm bf16", cfg, params, res16, ref16, P, failures, dev,
        cache_dtype=bf16, tol=bound16)
    del ref16
    f32_gap = float((res16["logits"][:P - 1]
                     - res32["logits"][:P - 1]).abs().max())
    same = float(np.mean(res16["tokens"][:, P:] == res32["tokens"][:, P:]))
    if not bool(torch.isfinite(res16["logits"]).all()):
        failures.append("lm bf16: logits not finite")
    print(f"lm bf16: backend=cuda {res16['tokens_per_s']:.2f} tokens/s, "
          f"step p50 {res16['latency_ms_p50']:.3f} ms (bf16 caches, "
          f"{LM_BATCH} x {res16['steps']} steps, prompt {P}); float32 "
          f"caches at the same prompt {res32['latency_ms_p50']:.3f} ms; "
          f"teacher-forced reference (bf16 caches) vs cuda logits "
          f"{worst16:.3g} (bound {bound16:.3g}: {LM_BF16_SHARE} x the "
          f"reference's bf16 caches against the float32 forward over the "
          f"prompt, {own:.3g}, + 1e-4), greedy flips {flips16}, "
          f"free-running agreement {agree16 * 100:.1f}%; against the "
          f"float32-cache cuda run: prompt logits {f32_gap:.3g}, generated "
          f"tokens equal {same * 100:.1f}%")
    del res16, res32
    hold("lm bf16 first decode step", got16[first])
    hold("lm bf16 last step", got16[last])
    del got16
    for label, B, S, Hkv, G, D, valid, window in FD_BF16_CASES:
        q = torch.randn(B, Hkv, G, D, generator=gen, device=dev)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev).to(bf16)
                for _ in range(2))
        hold(label, [((q, k, v, torch.full((1,), valid, dtype=torch.int32,
                                           device=dev)), {"window": window})],
             served=False)
        del q, k, v


def _max_rel(got, want) -> float:
    """max |got − want| over max |want| (0 when want is all zero)."""
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / scale if scale else 0.0


def train_phase(dev, failures, cases, check_launches):
    """Phase 14: the offline path — ``launch.train.train_loop`` at full
    agcn-2s width, a checkpoint restored bit-equal and resumed, one train
    step on the card against the CPU, the RFC-checkpointed MLP on the
    hand-written RFC pair, and C3's storage, the E(D) report and the
    compression table at full width."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.bridge import params_from_numpy
    from repro_torch.checkpoint import store
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.tree import tree_leaves, tree_map, tree_paths
    from repro_torch.configs import get_config
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import feature_sparsity_per_block
    from repro_torch.core.rfc import checkpoint as rck
    from repro_torch.core.rfc.format import (expected_sparsity_categories,
                                             storage_cost)
    from repro_torch.data.pipeline import DataConfig, make_batches
    from repro_torch.launch.train import train_loop
    from repro_torch.models import registry
    from repro_torch.optim import adamw
    from repro_torch.train.steps import (loss_and_grads, make_loss_fn,
                                         make_train_step)
    sys.path.insert(0, str(ROOT))
    from benchmarks import torch_paper

    t_phase = time.perf_counter()
    smi = smi_line()
    cfg = get_config(ARCH)
    base = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(base, ignore_errors=True)
    host = lambda t: t.detach().cpu().clone()
    record = cases["train"] = {"device": smi}

    # ---- (a) full-width training through train_loop ----------------------
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=3,
                       total_steps=TRAIN_STEPS, seed=SEED,
                       checkpoint_every=TRAIN_CKPT_AT,
                       checkpoint_dir=str(base / "run"))
    step_ms, at_ckpt = [], {}

    def on_step(step, params, opt, metrics, ms):
        step_ms.append(ms)
        if step + 1 == TRAIN_CKPT_AT:      # the state the checkpoint holds
            at_ckpt["params"] = tree_map(host, params)
            at_ckpt["opt"] = tree_map(host, opt)

    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)  # earlier phases' tensors
    (params, losses), counts = counted(lambda: train_loop(
        ARCH, tcfg, reduced=False, batch=TRAIN_CLIPS, device=dev,
        resume=False, log_every=10, on_step=on_step))
    check_launches("train", counts, {}, TRAIN_STEPS)   # reference backend
    peak = torch.cuda.max_memory_allocated(dev) - before
    seqs = TRAIN_CLIPS * cfg.gcn_persons
    p50 = statistics.median(step_ms)
    mean = statistics.fmean(step_ms[1:])
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    record.update(step_ms=step_ms, losses=losses, peak_bytes=peak,
                  held_before_bytes=before)
    print(f"train: full {ARCH} ({len(cfg.gcn_channels)} blocks, T = "
          f"{cfg.gcn_frames}, input skip {cfg.input_skip}, dense graph), "
          f"{TRAIN_CLIPS} clips = {seqs} sequences a step, {TRAIN_STEPS} "
          f"steps of train_loop: step p50 {p50:.3f} ms, mean of steps 2-"
          f"{TRAIN_STEPS} {mean:.3f} ms (first {step_ms[0]:.3f} ms; host "
          f"clock from the batch to the loss read, synchronised), "
          f"{seqs / (p50 / 1e3):.2f} sequences/s at p50, peak memory "
          f"{peak / 2**30:.3f} GiB (max_memory_allocated less the "
          f"{before / 2**30:.3f} GiB held before the run); {smi}")
    print(f"train: loss first {losses[0]:.4f}, last {losses[-1]:.4f}; mean "
          f"of the first 5 {first5:.4f}, of the last 5 {last5:.4f}")
    if not np.isfinite(losses).all():
        failures.append(f"train: a loss is not finite: {losses}")
    if not last5 < first5:
        failures.append(f"train: the last 5 steps' mean loss {last5:.4f} is "
                        f"not below the first 5's {first5:.4f}")

    # ---- (b) restore bit-equal, resume ---------------------------------
    fresh = registry.init_params(cfg, seed=SEED + 1, device=dev)
    got_p = store.restore(tcfg.checkpoint_dir, TRAIN_CKPT_AT, fresh)
    got_o = store.restore(str(base / "run" / "opt"), TRAIN_CKPT_AT,
                          adamw.init(fresh))
    bad = [n for (n, a), b in zip(
        tree_paths(got_p) + tree_paths(got_o),
        tree_leaves(at_ckpt["params"]) + tree_leaves(at_ckpt["opt"]))
        if a.device.type != dev.type or not torch.equal(a.cpu(), b)]
    print(f"train: step {TRAIN_CKPT_AT} restored into fresh trees: "
          f"{len(tree_leaves(got_p))} param and "
          f"{len(tree_leaves(got_o))} optimizer leaves, "
          f"{'bit-equal' if not bad else f'{len(bad)} differ'}")
    if bad:
        failures.append(f"train: restored leaves differ from the state "
                        f"saved at step {TRAIN_CKPT_AT}: {bad[:5]}")
    resume = base / "resume"
    for sub in ("", "opt"):
        shutil.copytree(base / "run" / sub / f"step_{TRAIN_CKPT_AT}",
                        resume / sub / f"step_{TRAIN_CKPT_AT}")
    _, again = train_loop(ARCH, dataclasses.replace(
        tcfg, total_steps=TRAIN_CKPT_AT + 1, checkpoint_every=0,
        checkpoint_dir=str(resume)), reduced=False, batch=TRAIN_CLIPS,
        device=dev, resume=True, log_every=10)
    diff = abs(again[0] - losses[TRAIN_CKPT_AT]) if len(again) == 1 else 1e9
    print(f"train: resumed at step {TRAIN_CKPT_AT}: step "
          f"{TRAIN_CKPT_AT + 1} loss {again[0]:.6f} against "
          f"{losses[TRAIN_CKPT_AT]:.6f} uninterrupted (|diff| {diff:.3g}, "
          f"bound 1e-4; cuDNN's weight gradients use atomics, so later "
          f"steps are not bit-equal)")
    if diff > 1e-4:
        failures.append(f"train: the resumed step's loss is {diff:.3g} from "
                        f"the uninterrupted run's")

    # ---- (c) one train step on the card against the CPU ------------------
    rcfg = get_config(ARCH, reduced=True)
    p_cpu = registry.init_params(rcfg, seed=SEED, device="cpu")
    p_dev = params_from_numpy(tree_map(lambda t: t.numpy(), p_cpu),
                              device=dev)
    raw = next(make_batches(rcfg, DataConfig(global_batch=8, seq_len=0,
                                             seed=SEED)))
    b_cpu = {k: torch.as_tensor(v) for k, v in raw.items()}
    b_dev = {k: v.to(dev) for k, v in b_cpu.items()}
    loss_fn = make_loss_fn(rcfg)
    lc, _, gc = loss_and_grads(loss_fn, p_cpu, b_cpu)
    ld, _, gd = loss_and_grads(loss_fn, p_dev, b_dev)
    # gradients within 1e-4 x the leaf's max |g|, plus 1e-6: the temporal
    # conv's bias feeds a BatchNorm that removes it, so its exact gradient
    # is 0 and both devices compute rounding noise of ~1e-7
    g_bad = [n for (n, a), b in zip(tree_paths(gd), tree_leaves(gc))
             if float((a.cpu() - b).abs().max())
             > 1e-4 * float(b.abs().max()) + 1e-6]
    g_worst = max(_max_rel(a.cpu(), b) for a, b in zip(
        tree_leaves(gd), tree_leaves(gc)) if float(b.abs().max()) > 1e-5)
    rt = TrainConfig(learning_rate=3e-3, warmup_steps=3, total_steps=30)
    pc, _, mc = make_train_step(rcfg, rt)(p_cpu, adamw.init(p_cpu), b_cpu)
    pd, _, md = make_train_step(rcfg, rt)(p_dev, adamw.init(p_dev), b_dev)
    # AdamW's first update is g/(|g| + 1e-8): near that eps a rounding
    # difference moves a parameter by up to lr, so the params are held
    # where the CPU's |g| > 1e-6
    p_diff = max(float((a.cpu() - b).abs()[g.abs() > 1e-6].amax())
                 for a, b, g in zip(tree_leaves(pd), tree_leaves(pc),
                                    tree_leaves(gc)) if (g.abs() > 1e-6).any())
    l_diff = max(abs(float(ld) - float(lc)),
                 abs(float(md["loss"]) - float(mc["loss"])))
    print(f"train: one make_train_step step at the reduced config from the "
          f"same params and batch, card against CPU: loss |diff| "
          f"{l_diff:.3g} (bound 1e-4), gradients at worst {g_worst:.3g} of "
          f"the leaf's max |g| (bound 1e-4, plus 1e-6 absolute; "
          f"{len(g_bad)} leaves over), params after the step {p_diff:.3g} "
          f"where |g| > 1e-6 (bound 1e-5)")
    if l_diff > 1e-4 or g_bad or p_diff > 1e-5:
        failures.append(f"train: card against CPU: loss {l_diff:.3g}, "
                        f"gradient leaves over {g_bad[:5]}, params "
                        f"{p_diff:.3g}")

    # ---- (d) the RFC-checkpointed MLP on the hand-written RFC pair --------
    M, D, Fh = RFC_CKPT_SHAPE
    gen = torch.Generator().manual_seed(SEED)
    x = torch.randn((M, D), generator=gen)
    wi = torch.randn((D, Fh), generator=gen) / D ** 0.5
    wo = torch.randn((Fh, D), generator=gen) / Fh ** 0.5
    gy = torch.randn((M, D), generator=gen)
    x, wi, wo, gy = (t.to(dev) for t in (x, wi, wo, gy))
    a = [t.clone().requires_grad_(True) for t in (x, wi, wo)]
    b = [t.clone().requires_grad_(True) for t in (x, wi, wo)]

    def rfc_pass():
        y = rck.mlp_relu2_rfc(*a)
        y.backward(gy)
        return y

    y, counts = counted(rfc_pass)
    check_launches("train rfc checkpoint", counts,
                   {"rfc_encode": 1, "rfc_decode": 1}, 1)
    yb = torch.relu(b[0] @ b[1]).square() @ b[2]
    yb.backward(gy)
    errs = [_max_rel(p.detach(), q.detach()) for p, q in
            ((y, yb), (a[0].grad, b[0].grad), (a[1].grad, b[1].grad),
             (a[2].grad, b[2].grad))]
    with torch.no_grad():
        h = torch.relu(x @ wi).square()
    dense_b, rfc_b = rck.checkpoint_bytes(h)
    held = rck.held_bytes(h)
    print(f"train: mlp_relu2_rfc at ({M}, {D}) x ({D}, {Fh}) x ({Fh}, {D}), "
          f"float32, TF32 off, against the plain autograd of "
          f"relu(x·wi)²·wo: output {errs[0]:.3g}, dx {errs[1]:.3g}, dwi "
          f"{errs[2]:.3g}, dwo {errs[3]:.3g} of each tensor's max |value| "
          f"(bound 1e-4); h {float((h == 0).float().mean()) * 100:.2f}% "
          f"zeros; modelled bytes dense {dense_b} rfc {rfc_b} "
          f"({(1 - rfc_b / dense_b) * 100:.2f}% less), held by the graph "
          f"{held} (values + bits, {held / dense_b:.4f}x dense)")
    record["rfc_checkpoint"] = {"errs": errs, "dense": dense_b, "rfc": rfc_b,
                                "held": held}
    if max(errs) > 1e-4:
        failures.append(f"train: mlp_relu2_rfc disagrees with the plain "
                        f"autograd: {errs}")

    # ---- (e) accounting at full width on the trained params ---------------
    xa = torch.as_tensor(next(make_batches(cfg, DataConfig(
        global_batch=BATCH, seq_len=0, seed=SEED)))["x"], device=dev)
    spars = feature_sparsity_per_block(params, xa, cfg)
    ref_plan = engine.build_execution_plan(params, cfg, None,
                                           backend="reference")
    cuda_plan = engine.build_execution_plan(params, cfg, None,
                                            backend="cuda")
    with torch.inference_mode():
        outs = engine.block_outputs(ref_plan, xa)
        leaves, counts = counted(lambda: engine.rfc_boundaries(cuda_plan,
                                                               xa))
    nb = len(cfg.gcn_channels)
    check_launches("train accounting", counts, {
        "graph_sconv": nb, "cavity_tconv": nb, "rfc_encode": nb - 1,
        "rfc_decode": nb - 1}, 1)
    acc_worst = 0.0
    rows = []
    for blk, ((vals, bits), hout) in enumerate(zip(leaves, outs)):
        hot = (hout > 0).reshape(*hout.shape[:-1], -1, 16)
        cm, cb = storage_cost(hot), storage_cost(bits)
        qm = expected_sparsity_categories(hot)
        qb = expected_sparsity_categories(bits)
        d = max([abs(cm[k] - cb[k]) for k in (
            "sparsity", "rfc_vs_dense_reduction", "csc_vs_dense_reduction")]
            + [abs(u - v) for u, v in zip(qm, qb)]
            + [abs(cm["sparsity"] - spars[blk])])
        acc_worst = max(acc_worst, d)
        rows.append({"block": blk, "mask": cm, "bits": cb,
                     "categories_bits": qb})
        print(f"train: block {blk} (C = {vals.shape[-1]}) sparsity "
              f"{spars[blk] * 100:.3f}% (reference probe), from the card's "
              f"bits {cb['sparsity'] * 100:.3f}%; RFC saves "
              f"{cb['rfc_vs_dense_reduction'] * 100:.3f}% [mask "
              f"{cm['rfc_vs_dense_reduction'] * 100:.3f}%], CSC "
              f"{cb['csc_vs_dense_reduction'] * 100:.3f}%; I/II/III/IV "
              + "/".join(f"{v * 100:.2f}%" for v in qb))
    record["accounting"] = {"sparsity": spars, "boundaries": rows}
    print(f"train: storage and categories from the card's bits against the "
          f"reference path's mask: worst |diff| {acc_worst:.3g} (bound 1e-3;"
          f" a ReLU zero can flip by rounding); last block (not encoded) "
          f"sparsity {spars[-1] * 100:.3f}%")
    if acc_worst > 1e-3:
        failures.append(f"train: storage from the card's bits is "
                        f"{acc_worst:.3g} from the reference mask's")
    sched = torch_paper.dyn_sched(torch_paper.Setup(reduced=False), spars)
    record["dyn_sched"] = sched
    table = {f"{s}/{c}": (d["compression_ratio"], d["graph_skip_efficiency"])
             for s, c, d in torch_paper.compression_table()}
    print(f"train: Drop-1/2/3 x cav compression table "
          f"{'equals' if table == COMPRESSION_TABLE else 'DIFFERS from'} the "
          f"CPU's ({len(table)} cells)")
    if table != COMPRESSION_TABLE:
        failures.append(f"train: compression table differs: {table}")

    # ---- one full-width train step under the profiler --------------------
    step_fn = make_train_step(cfg, tcfg)
    tb = {k: torch.as_tensor(v, device=dev) for k, v in next(make_batches(
        cfg, DataConfig(global_batch=TRAIN_CLIPS, seq_len=0,
                        seed=SEED))).items()}
    opt = adamw.init(params)
    profile_steps("train step", lambda: step_fn(params, opt, tb))
    print(f"train: phase took {time.perf_counter() - t_phase:.1f} s")


def decode_run(label, arch, cfg, B, P, G, dev, failures, cases, summary,
               check_launches, modules, params=None):
    """``generate`` of ``cfg`` at batch B, a P-token prompt fed token by
    token and G greedy tokens on ``cuda`` and ``reference``: the launch
    counts, the teacher-forced and prefill checks, flash_decode held on
    the first decode step's and the last step's inputs, and the decode
    step's p50 and tokens/s.  MoE prompts are held against the cache-free
    forward at a capacity that drops no token (a one-token decode step
    never drops: its capacity is at least 1 and its k choices differ).
    ``params`` default to ``registry.init_params`` of ``cfg`` from SEED.
    Returns the params."""
    import numpy as np
    import torch
    from repro_torch.launch.serve import generate
    from repro_torch.models import registry
    t0 = time.perf_counter()
    if params is None:
        params = registry.init_params(cfg, seed=SEED, device=dev)
    steps = P + G - 1
    first, last = P, steps - 1
    run = dict(reduced=False, batch=B, prompt_len=P, gen=G, seed=SEED,
               device=dev, params=params, keep_logits=True, cfg=cfg)
    restore, got = record_decode((first, last), cfg.num_layers)
    try:
        res, counts = counted(lambda: generate(arch, backend="cuda", **run))
    finally:
        restore()
    check_launches(label, counts, {"flash_decode": cfg.num_layers}, steps)
    launched = counts["flash_decode"]
    ref, counts = counted(lambda: generate(arch, backend="reference", **run))
    check_launches(f"{label} reference", counts, {}, steps)
    for name, r in (("cuda", res), ("reference", ref)):
        print(f"{label}: backend={name} {r['tokens_per_s']:.2f} tokens/s, "
              f"decode step p50 {r['latency_ms_p50']:.3f} ms mean "
              f"{r['latency_ms_mean']:.3f} ms ({B} sequences x {r['steps']} "
              f"steps, prompt {P} fed token by token + {G} generated, "
              f"float32 cache)")
    if res["tokens"].shape != (B, P + G) or not bool(
            torch.isfinite(res["logits"]).all()):
        failures.append(f"{label}: tokens {res['tokens'].shape} or logits "
                        f"not finite")
    worst, flips, agree, tt = teacher_forced(label, cfg, params, res, ref, P,
                                             failures, dev)
    del ref
    pcfg = cfg
    if cfg.family == "moe":
        pcfg = dataclasses.replace(cfg, moe_capacity_factor=(
            cfg.padded_experts / cfg.experts_per_token))
    pre, ploss = prefill_check(label, pcfg, params, res, tt, P, failures)
    print(f"{label}: teacher-forced reference vs cuda logits over {steps} "
          f"steps {worst:.3g} (bound 1e-3); greedy flips {flips}; "
          f"free-running token agreement {agree * 100:.1f}%; cache-free "
          f"prefill{' (no-drop capacity)' if pcfg is not cfg else ''} vs "
          f"cached decode over the prompt {pre:.3g}, prefill loss "
          f"{ploss:.4f}; flash_decode launches {launched} in {steps} steps "
          f"({cfg.num_layers} per step expected); "
          f"{time.perf_counter() - t0:.1f} s")
    hold_flash_decode(f"{label} first decode step", got[first], cases,
                      summary, failures, modules)
    hold_flash_decode(f"{label} last step", got[last], cases, summary,
                      failures, modules)
    del res, got
    return params


def moe_vlm_phase(dev, failures, cases, summary, check_launches, modules):
    """Phase 16: the MoE and VLM decoder families at full width.
    granite-moe-3b-a800m at full width and depth and qwen3-moe-30b-a3b at
    full width cut to QWEN_LAYERS layers, each through ``decode_run``;
    llava-next-mistral-7b at full width: the prefill forward with 2 880
    image embeddings before the text, cached against the cache-free
    forward (1e-3), one ``cuda`` decode step after it against the
    cache-free forward of the longer sequence (1e-3) with flash_decode
    held on its inputs, then a text decode as JAX serves it
    (``decode_run``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import decoder, registry
    from repro_torch.train.steps import make_serve_step

    t_phase = time.perf_counter()
    smi = smi_line()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = get_config(MOE_ARCH)
    params = decode_run("moe granite", MOE_ARCH, cfg, MOE_BATCH, MOE_PROMPT,
                        MOE_GEN, dev, failures, cases, summary,
                        check_launches, modules)
    n = sum(p.numel() for p in _leaves(params))
    print(f"moe granite: full {MOE_ARCH} ({cfg.num_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.num_experts} experts padded to "
          f"{cfg.padded_experts}, top {cfg.experts_per_token}, expert d_ff "
          f"{cfg.moe_d_ff}): {n / 1e9:.3f} B float32 parameters; {smi}")
    # one decode step near the end of the cache, profiled
    step = make_serve_step(cfg, "cuda")
    cache = registry.init_cache(cfg, MOE_BATCH, MOE_PROMPT + MOE_GEN,
                                device=dev)
    p0 = MOE_PROMPT + MOE_GEN - 8
    at = torch.full((), p0, dtype=torch.int32, device=dev)
    tok = torch.zeros((MOE_BATCH, 1), dtype=torch.int32, device=dev)

    def moe_step():
        cache["pos"].fill_(p0)
        step(params, cache, {"tokens": tok, "pos": at})
    profile_steps("moe decode step", moe_step)
    del params, cache
    torch.cuda.empty_cache()

    full = get_config(QWEN_ARCH)
    cut = dataclasses.replace(full, num_layers=QWEN_LAYERS)
    params = decode_run("moe qwen3", QWEN_ARCH, cut, MOE_BATCH, QWEN_PROMPT,
                        QWEN_GEN, dev, failures, cases, summary,
                        check_launches, modules)
    n = sum(p.numel() for p in _leaves(params))
    print(f"moe qwen3: {QWEN_ARCH} at full width (d_model {cut.d_model}, "
          f"{cut.num_heads}/{cut.num_kv_heads} heads of {cut.head_dim}, "
          f"{cut.num_experts} experts, top {cut.experts_per_token}, expert "
          f"d_ff {cut.moe_d_ff}), depth cut to {QWEN_LAYERS} of "
          f"{full.num_layers} layers: {n / 1e9:.3f} B float32 parameters")
    del params
    torch.cuda.empty_cache()

    cfg = get_config(VLM_ARCH)
    params = registry.init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    img = torch.randn((1, cfg.num_image_tokens, cfg.d_model), generator=gen,
                      device=dev)
    text = torch.randint(0, cfg.vocab_size, (1, VLM_PREFILL_TEXT),
                         generator=gen, device=dev, dtype=torch.int32)
    S = cfg.num_image_tokens + VLM_PREFILL_TEXT
    t0 = time.perf_counter()
    with torch.inference_mode():
        free, _, _ = decoder.forward(params, text, cfg, image_embeds=img)
        cache = registry.init_cache(cfg, 1, S + 1, device=dev)
        (cached, cache, _), counts = counted(lambda: decoder.forward(
            params, text, cfg, image_embeds=img, caches=cache,
            positions=torch.arange(S, device=dev), backend="cuda"))
        check_launches("vlm prefill", counts, {}, 1)   # plain attention
        pre = float((free - cached).abs().max())
        nxt = free[:, -1].argmax(-1).to(torch.int32)[:, None]
        del cached
        restore, got = record_decode((0,), cfg.num_layers)
        try:
            (logits, _), counts = counted(lambda: registry.serve_fn(
                params, {"tokens": nxt, "pos": torch.full(
                    (), S, dtype=torch.int32, device=dev)}, cache, cfg,
                "cuda"))
        finally:
            restore()
        check_launches("vlm image decode step", counts,
                       {"flash_decode": cfg.num_layers}, 1)
        longer, _, _ = decoder.forward(params, torch.cat([text, nxt], 1),
                                       cfg, image_embeds=img)
        step_d = float((logits[:, -1] - longer[:, -1]).abs().max())
    torch.cuda.synchronize()
    print(f"vlm: full {VLM_ARCH} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {sum(p.numel() for p in _leaves(params)) / 1e9:.3f}"
          f" B float32 parameters): prefill of {cfg.num_image_tokens} image "
          f"embeddings + {VLM_PREFILL_TEXT} text tokens written to the cache "
          f"against the cache-free forward {pre:.3g} (bound 1e-3); one cuda "
          f"decode step at valid {S + 1} against the cache-free forward of "
          f"the longer sequence {step_d:.3g} (bound 1e-3); "
          f"{time.perf_counter() - t0:.1f} s")
    if not pre <= 1e-3 or not step_d <= 1e-3 or not bool(
            torch.isfinite(free).all()):
        failures.append(f"vlm: image prefill {pre:.3g} or decode step "
                        f"{step_d:.3g} off the cache-free forward")
    hold_flash_decode("vlm image decode step", got[0], cases, summary,
                      failures, modules)
    del free, longer, cache, logits, got
    decode_run("vlm llava", VLM_ARCH, cfg, VLM_BATCH, VLM_PROMPT, VLM_GEN,
               dev, failures, cases, summary, check_launches, modules,
               params=params)
    del params
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated(dev)
    cases["moe_vlm"] = {"device": smi, "peak_bytes": peak}
    print(f"moe_vlm: peak memory {peak / 2**30:.3f} GiB; phase took "
          f"{time.perf_counter() - t_phase:.1f} s")


def _flash_decode_per_step(cfg) -> int:
    """flash_decode launches a one-token ``cuda`` step of ``cfg`` makes:
    one per attention layer (a decoder's layers; the hybrid's uses of its
    shared block; the audio decoder's self- and cross-attention; none in
    the SSM family)."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import structure
        return structure(cfg)[0]
    if cfg.family == "audio":
        return 2 * cfg.num_layers
    return cfg.num_layers


def _cache_free_logits(cfg, params, toks, memory):
    """The cache-free forward's logits of ``toks`` (B, S): the decode's
    teacher-forced reference (the audio decoder attends to ``memory``, as
    the served steps did)."""
    from repro_torch.models import decoder, encdec, hybrid, ssm_model
    if cfg.family == "audio":
        return encdec.decode(params, toks, memory, cfg)[0]
    mod = {"ssm": ssm_model, "hybrid": hybrid}.get(cfg.family, decoder)
    return mod.forward(params, toks, cfg)[0]


def _to_float64_(tree):
    """Every floating leaf of ``tree`` (nested dicts and lists) turned to
    float64 in place, leaf by leaf, so the float32 copy of one leaf at a
    time is all that is held twice."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, leaf in list(items):
        if isinstance(leaf, (dict, list)):
            _to_float64_(leaf)
        elif leaf is not None and leaf.is_floating_point():
            tree[key] = leaf.double()


def _exact_check(label, cfg, params, toks, free, cached, failures, cases,
                 dev):
    """The SSM and hybrid families at full depth, where float32 rounding
    alone moves the cached decode further from the cache-free forward than
    a fixed bound allows: the float32 cache-free forward of ``toks[:, :-1]``
    run again and held bit-equal to ``free`` (the path is deterministic at
    a fixed seed); then ``params`` turned to float64 in place and the
    float64 teacher-forced ``reference`` decode of ``toks`` held to the
    float64 cache-free forward within F64_BOUND (the step recurrence
    against the chunked scan in exact arithmetic), each float32 path's
    distance from the float64 forward printed.  Returns the note printed
    beside the float32 gap."""
    import math
    import torch
    with torch.inference_mode():
        again = _cache_free_logits(cfg, params, toks[:, :-1], None)
    same = bool(torch.equal(again, free))
    del again
    if not same:
        failures.append(f"{label}: two float32 cache-free forwards on the "
                        f"same weights and tokens differ")
    _to_float64_(params)
    with torch.inference_mode():
        free64 = _cache_free_logits(cfg, params, toks[:, :-1], None)
        dec64 = _forced(cfg, params, toks, None, "reference", dev,
                        torch.float64).transpose(0, 1)
    gap64 = float((dec64 - free64).abs().max())
    off_free = float((free.double() - free64).abs().max())
    off_dec = float((cached.double() - free64).abs().max())
    cases.setdefault("zoo", {})[f"{label} float64"] = {
        "rerun_bit_equal": same, "gap64": gap64,
        "float32_forward_off": off_free, "float32_decode_off": off_dec}
    if not math.isfinite(gap64) or gap64 > F64_BOUND:
        failures.append(f"{label}: float64 cached decode off the float64 "
                        f"cache-free forward by {gap64:.3g} (bound "
                        f"{F64_BOUND})")
    del free64, dec64
    return (f"; float32 forward rerun bit-equal: {same}; in float64 the "
            f"cached decode vs the cache-free forward {gap64:.3g} (bound "
            f"{F64_BOUND}), and the float32 forward / cached decode off the "
            f"float64 forward by {off_free:.3g} / {off_dec:.3g}")


def zoo_depth_cut(arch, dev, failures, cases):
    """``arch`` (xlstm-1.3b or zamba2-7b) at full width cut to
    ZOO_CUT_LAYERS, random weights and tokens (batch 4, 32) from SEED:
    every step of the float32 teacher-forced ``cuda`` decode against the
    cache-free forward at atol = rtol = ZOO_CUT_BOUND."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=ZOO_CUT_LAYERS)
    t0 = time.perf_counter()
    params = registry.init_params(cfg, seed=SEED, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                         device=dev, dtype=torch.int32)
    with torch.inference_mode():
        free = _cache_free_logits(cfg, params, toks[:, :-1], None)
        cached = _forced(cfg, params, toks, None, "cuda", dev).transpose(0, 1)
    gap = float((cached - free).abs().max())
    if not bool(torch.isfinite(cached).all()) or not torch.allclose(
            cached, free, atol=ZOO_CUT_BOUND, rtol=ZOO_CUT_BOUND):
        failures.append(f"zoo {arch} cut: cached decode logits off the "
                        f"cache-free forward by {gap:.3g} (atol = rtol = "
                        f"{ZOO_CUT_BOUND})")
    print(f"zoo {arch} cut: {ZOO_CUT_LAYERS} of {full.num_layers} layers, "
          f"d_model {cfg.d_model}, 4 x 31 teacher-forced cuda steps; cached "
          f"decode vs the cache-free forward {gap:.3g} (atol = rtol = "
          f"{ZOO_CUT_BOUND}); {time.perf_counter() - t0:.1f} s")
    cases.setdefault("zoo", {})[f"{arch} cut"] = {
        "layers": ZOO_CUT_LAYERS, "gap": gap}
    del params, free, cached


def _reckon(label, cfg, per_param, failures, dev):
    """Print the bytes ``cfg``'s float32 parameters need at ``per_param``
    bytes each (4: serving; 16: training's weights, gradients and two
    moments) beside the card's free memory; returns the parameter count,
    or None (a failure) when they do not fit."""
    import torch
    from repro_torch.common.tree import param_count
    from repro_torch.models import registry
    n = param_count(registry.init_params(cfg, device="meta"))
    free, total = torch.cuda.mem_get_info(dev)
    need = per_param * n
    print(f"{label}: {n / 1e9:.3f} B float32 parameters, {per_param} bytes "
          f"each = {need / 2**30:.3f} GiB before activations; "
          f"{free / 2**30:.3f} of {total / 2**30:.3f} GiB free")
    if need > free:
        failures.append(f"{label}: {need / 2**30:.3f} GiB do not fit in "
                        f"{free / 2**30:.3f} GiB free")
        return None
    return n


def zoo_serve(arch, layers, B, P, G, backends, bound, dev, failures, cases,
              summary, check_launches, modules):
    """``generate`` of ``arch`` at full width (depth cut to ``layers``
    when given) on each of ``backends``: decode-step p50 and tokens/s, the
    launch counts, every step's logits against the cache-free forward
    within atol=rtol=``bound`` (the gap printed; with ``bound`` None the
    gap is printed and ``_exact_check`` holds the path), the backends' logits
    and tokens against each other, flash_decode held on the first decode
    step's and the last step's inputs.  Returns (params, cfg)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate, prompt_and_memory
    from repro_torch.models import registry
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers) if layers else full
    label = f"zoo {arch}"
    if _reckon(label, cfg, 4, failures, dev) is None:
        return None, cfg
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    params = registry.init_params(cfg, seed=SEED, device=dev)
    steps = P + G - 1
    first, last = P, steps - 1
    per = _flash_decode_per_step(cfg)
    run = dict(reduced=False, batch=B, prompt_len=P, gen=G, seed=SEED,
               device=dev, params=params, keep_logits=True, cfg=cfg)
    res = {}
    got = {}
    for backend in backends:
        restore, rec = (record_decode((first, last), per)
                        if backend == "cuda" and per else (lambda: None, {}))
        try:
            res[backend], counts = counted(lambda: generate(
                arch, backend=backend, **run))
        finally:
            restore()
        got.update(rec)
        check_launches(f"{label} {backend}", counts,
                       {"flash_decode": per} if backend == "cuda" else {},
                       steps)
        r = res[backend]
        print(f"{label}: backend={backend} {r['tokens_per_s']:.2f} tokens/s, "
              f"decode step p50 {r['latency_ms_p50']:.3f} ms mean "
              f"{r['latency_ms_mean']:.3f} ms ({B} sequences x "
              f"{r['steps']} steps, prompt {P} fed token by token + {G} "
              f"generated, float32 cache), flash_decode launches "
              f"{counts['flash_decode']} "
              f"({per if backend == 'cuda' else 0} per step expected)")
    out = res[backends[0]]
    toks = torch.from_numpy(out["tokens"]).to(dev)
    _, memory = prompt_and_memory(cfg, B, P, SEED)
    if memory is not None:
        memory = torch.from_numpy(memory).to(dev)
    with torch.inference_mode():
        free = _cache_free_logits(cfg, params, toks[:, :-1], memory)
    gaps = {}
    for backend, r in res.items():
        if backend != backends[0]:      # teacher-forced on the same tokens
            if not (r["tokens"] == out["tokens"]).all():
                with torch.inference_mode():
                    r = {"logits": _forced(cfg, params, toks, memory,
                                           backend, dev)}
        cached = r["logits"].transpose(0, 1)
        gaps[backend] = float((cached - free).abs().max())
        if not bool(torch.isfinite(cached).all()) or (
                bound is not None and not torch.allclose(
                    cached, free, atol=bound, rtol=bound)):
            failures.append(f"{label} {backend}: cached decode logits off "
                            f"the cache-free forward by {gaps[backend]:.3g} "
                            f"(bound {bound})")
    note = (f"bound {bound:.3g}" if bound is not None else
            "float32, printed" + _exact_check(
                label, cfg, params, toks, free,
                res[backends[0]]["logits"].transpose(0, 1), failures, cases,
                dev))
    agree = ""
    if len(res) > 1:
        b0, b1 = backends
        same = float((res[b0]["tokens"] == res[b1]["tokens"]).mean())
        agree = f"; token agreement {b0}/{b1} {same * 100:.1f}%"
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{label}: {cfg.num_layers} of {full.num_layers} layers, d_model "
          f"{cfg.d_model}; cached decode vs the cache-free forward over "
          f"{steps} steps: "
          f"{', '.join(f'{b} {g:.3g}' for b, g in gaps.items())} "
          f"({note}){agree}; peak {peak / 2**30:.3f} GiB; "
          f"{time.perf_counter() - t0:.1f} s")
    cases.setdefault("zoo", {})[arch] = {
        "layers": cfg.num_layers, "gap": gaps, "bound": bound,
        "peak_bytes": peak,
        **{f"{b}_tokens_per_s": r["tokens_per_s"] for b, r in res.items()},
        **{f"{b}_step_ms_p50": r["latency_ms_p50"] for b, r in res.items()}}
    for step, name in ((first, "first decode step"), (last, "last step")):
        if got.get(step):
            hold_flash_decode(f"{label} {name}", got[step], cases, summary,
                              failures, modules)
    del res, free, got
    return params, cfg


def _forced(cfg, params, toks, memory, backend, dev, dtype=None):
    """Per-step logits (steps, B, V) of ``backend``'s serve step fed
    ``toks`` (B, n) token by token (the cache in ``dtype``: float32, or
    float64 for the SSM and hybrid families)."""
    import torch
    from repro_torch.models import registry
    from repro_torch.train.steps import make_serve_step
    B, n = toks.shape
    step = make_serve_step(cfg, backend)
    cache = registry.init_cache(cfg, B, n, device=dev,
                                dtype=dtype or torch.float32)
    extra = {} if memory is None else {"memory": memory}
    return torch.stack([step(params, cache, {
        "tokens": toks[:, t:t + 1],
        "pos": torch.full((), t, dtype=torch.int32, device=dev),
        **extra})[2] for t in range(n - 1)])


def gemma_long(params, cfg, dev, failures, cases, summary, check_launches,
               modules):
    """gemma3's long case: a GEMMA_LONG-token prompt prefilled in one
    multi-token step (plain attention, the local layers' window as a
    mask), then GEMMA_STEPS one-token ``cuda`` steps whose local layers
    run flash_decode with the window as its lower bound (the cache is
    longer than the window); the prefill's last logits and each step's
    against the cache-free forward of the whole sequence (1e-3), and
    flash_decode held on the first step's inputs."""
    import torch
    from repro_torch.models import decoder, registry
    from repro_torch.train.steps import make_serve_step
    t0 = time.perf_counter()
    n = GEMMA_LONG + GEMMA_STEPS
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                         device=dev, dtype=torch.int32)
    cache = registry.init_cache(cfg, 1, n, device=dev)
    with torch.inference_mode():
        (pre, cache), counts = counted(lambda: registry.serve_fn(
            params, {"tokens": toks[:, :GEMMA_LONG], "pos": torch.zeros(
                (), dtype=torch.int32, device=dev)}, cache, cfg, "cuda"))
    check_launches("zoo gemma3 long prefill", counts, {}, 1)
    step = make_serve_step(cfg, "cuda")
    restore, got = record_decode((0,), cfg.num_layers)
    logits = [pre[:, -1]]
    try:
        def run():
            for t in range(GEMMA_STEPS):
                pos = GEMMA_LONG + t
                logits.append(step(params, cache, {
                    "tokens": toks[:, pos:pos + 1],
                    "pos": torch.full((), pos, dtype=torch.int32,
                                      device=dev)})[2])
        _, counts = counted(run)
    finally:
        restore()
    check_launches("zoo gemma3 long decode", counts,
                   {"flash_decode": cfg.num_layers}, GEMMA_STEPS)
    # the last windowed step again, on a copy of the cache set back one
    # slot, may not sync with the host (the window's lower bound is read
    # from valid on the card)
    spare = {k: t.clone() for k, t in cache.items()}
    spare["pos"].sub_(1)
    pos = torch.full((), n - 1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        step(params, spare, {"tokens": toks[:, n - 1:], "pos": pos})
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("zoo gemma3 long: one windowed decode step under "
              "set_sync_debug_mode('error'): no host sync")
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode("default")
        failures.append(f"zoo gemma3 long: the windowed decode step syncs "
                        f"with the host: {e}")
    del spare
    with torch.inference_mode():
        free, _, _ = decoder.forward(params, toks, cfg)
    want = free[:, GEMMA_LONG - 1:]
    cached = torch.stack(logits, 1)
    gap = float((cached - want).abs().max())
    windows = sorted({c[1].get("window", 0) for c in got[0]})
    print(f"zoo gemma3 long: prefill {GEMMA_LONG} tokens in one step, then "
          f"{GEMMA_STEPS} cuda steps at valid {GEMMA_LONG + 1} to {n} "
          f"(local layers' window {cfg.window_size}: flash_decode windows "
          f"{windows}); logits against the cache-free forward {gap:.3g} "
          f"(bound 1e-3); {time.perf_counter() - t0:.1f} s")
    cases.setdefault("zoo", {})["gemma3 long"] = {"gap": gap}
    if not bool(torch.isfinite(cached).all()) or not torch.allclose(
            cached, want, atol=1e-3, rtol=1e-3) or windows != [
            0, cfg.window_size]:
        failures.append(f"zoo gemma3 long: logits off the cache-free forward "
                        f"by {gap:.3g} or windows {windows}")
    hold_flash_decode("zoo gemma3 long local", [
        c for c in got[0] if c[1].get("window")], cases, summary, failures,
        modules)
    hold_flash_decode("zoo gemma3 long global", [
        c for c in got[0] if not c[1].get("window")], cases, summary,
        failures, modules)
    del free, cache, pre, got, logits


def zoo_train(arch, layers, B, S, steps, dev, failures, cases,
              check_launches):
    """``train_loop`` of ``arch`` at full width (depth cut to ``layers``
    when given) for ``steps`` steps of B x S tokens: step p50, tokens/s,
    peak memory, finite losses, no kernel launch."""
    import gc
    import numpy as np
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers) if layers else full
    label = f"zoo train {arch}"
    if _reckon(label, cfg, 16, failures, dev) is None:
        return
    tcfg = TrainConfig(learning_rate=DIST_LR, total_steps=steps,
                       warmup_steps=1, checkpoint_every=0,
                       checkpoint_dir=str(ROOT / "build" / "chip_smoke_zoo"))
    step_ms = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        (params, losses), counts = counted(lambda: train_loop(
            arch, tcfg, reduced=False, batch=B, seq=S, device=dev,
            resume=False, log_every=steps, cfg=cfg,
            on_step=lambda *a: step_ms.append(a[-1])))
    except torch.OutOfMemoryError as e:
        failures.append(f"{label}: out of memory: {str(e)[:160]}")
        print(f"zoo: {failures[-1]}")
        return
    check_launches(label, counts, {}, steps)
    peak = torch.cuda.max_memory_allocated(dev)
    p50 = statistics.median(step_ms[1:] or step_ms)
    cut = (f", depth cut to {cfg.num_layers} of {full.num_layers} layers"
           if layers else "")
    print(f"{label}: full width{cut}, batch {B} x {S} tokens, {steps} "
          f"steps: losses {[round(x, 4) for x in losses]}, step p50 "
          f"{p50:.3f} ms (first {step_ms[0]:.1f} ms), "
          f"{B * S / (p50 / 1e3):.1f} tokens/s, peak {peak / 2**30:.3f} GiB; "
          f"{time.perf_counter() - t0:.1f} s")
    cases.setdefault("zoo", {})[f"train {arch}"] = {
        "layers": cfg.num_layers, "losses": losses, "step_ms": step_ms,
        "peak_bytes": peak}
    if not np.isfinite(losses).all():
        failures.append(f"{label}: losses {losses} not finite")
    del params


def zoo_phase(dev, failures, cases, summary, check_launches, modules):
    """Phase 17: the SSM, hybrid and audio families and the dense archs
    gemma3 (local:global) and internlm2 at full width, random weights
    from SEED: ``zoo_serve`` for each ZOO_SERVE entry (gemma3 followed by
    its long case, ``gemma_long``; an entry without a bound, xlstm and
    zamba2, by ``zoo_depth_cut``), flash_decode held at the zoo's new
    shapes off the served runs (ZOO_FD_CASES), then ``zoo_train`` for each
    ZOO_TRAIN entry.  Each model is reckoned before it is drawn (4 bytes a
    parameter to serve, 16 to train) and freed before the next."""
    import gc
    import torch
    t_phase = time.perf_counter()
    smi = smi_line()
    for arch, layers, B, P, G, backends, bound in ZOO_SERVE:
        params, cfg = zoo_serve(arch, layers, B, P, G, backends, bound, dev,
                                failures, cases, summary, check_launches,
                                modules)
        if params is not None and cfg.local_global_ratio:
            gemma_long(params, cfg, dev, failures, cases, summary,
                       check_launches, modules)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        if bound is None:
            zoo_depth_cut(arch, dev, failures, cases)
            gc.collect()
            torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, B, S, Hkv, G, D, valid, window in ZOO_FD_CASES:
        q = torch.randn(B, Hkv, G, D, generator=gen, device=dev)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
                for _ in range(2))
        hold_flash_decode(label, [((q, k, v, torch.full(
            (1,), valid, dtype=torch.int32, device=dev)),
            {"window": window})], cases, summary, failures, modules)
        del q, k, v
    torch.cuda.empty_cache()
    for arch, layers, B, S, steps in ZOO_TRAIN:
        zoo_train(arch, layers, B, S, steps, dev, failures, cases,
                  check_launches)
        gc.collect()
        torch.cuda.empty_cache()
    cases.setdefault("zoo", {})["device"] = smi
    print(f"zoo: {smi}; phase took {time.perf_counter() - t_phase:.1f} s")


HOST_NOTE = " (host time included: the queueing outlasted the spin)"


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.3f} ms"


def step_device_ms(run, label, failures):
    """One step's time on the clock (``cuda_ms``, which may hold host time:
    ``label`` then goes into ``HOST_GAPS``) and its device busy time from
    ``torch.profiler`` (the sum of its kernels and copies, the device time
    a roofline share reads), or None when the profiler saw no device time
    and the clock held host time, a failure; and where the device time
    came from."""
    ms = cuda_ms(run, reps=3, inner=3, label=label)
    _, rows = device_rows(run, steps=3)
    if rows:
        return ms, sum(r[0] for r in rows), "torch.profiler"
    if label not in HOST_GAPS:
        return ms, ms, "the clock"
    failures.append(f"{label}: no device time (the profiler saw none and "
                    f"the clock held host time)")
    return ms, None, "not measured"


def dryrun_phase(dev, failures, check_launches):
    """Phase 18: ``launch.dryrun.run_cell`` on one static h100x8 cell per
    arch (meta tensors, no card), then two cells built for real at their
    per-card h100x8 shapes: ``smollm-360m__decode_32k`` (batch 16, a
    32 768-slot bf16 cache, the ``cuda`` backend, position S − 1) and
    ``agcn-2s__gcn_infer`` (256 clips, the step the dry run counts:
    ``make_prefill_step``, ``reference``).  Each real step is counted by
    ``launch.op_cost`` and its FLOPs held to the static count within 1%
    (naming the ops that differ): on smollm the static count runs
    ``reference`` and the card ``cuda``, so this holds flash_decode's work
    function to the dots it replaces.  Prints each real step's time on
    the clock (``cuda_ms``) and its device busy time (``torch.profiler``),
    the static ``ideal_s`` and the measured fraction ideal / device busy,
    on the H100's constants (``launch.mesh``); then the
    served clip step (``make_gcn_infer_step`` on ``cuda``, the pruned
    plans) at the same 256 clips with its own counter reading, printed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import bone_stream, init_params
    from repro_torch.core.pruning.plan import plan_from_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_F32,
                                         make_production_mesh)
    from repro_torch.launch.op_cost import OpCost
    from repro_torch.train.steps import make_gcn_infer_step
    t0 = time.perf_counter()
    out = ROOT / "build" / "chip_smoke_dryrun"
    out.mkdir(parents=True, exist_ok=True)
    # the static cells are host work alone: six spawned processes share
    # them (spawned, as this process holds the card; the pool is closed
    # before the card runs)
    import concurrent.futures
    import multiprocessing
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=DRYRUN_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        recs = list(pool.map(dr.run_cell, *zip(*(
            (arch, shape, True, out, False)
            for arch, shape in DRYRUN_CELLS))))
    static = {}
    for (arch, shape), rec in zip(DRYRUN_CELLS, recs):
        static[(arch, shape)] = rec
        if rec["status"] != "ok":
            failures.append(f"dryrun: {rec['cell']} {rec['status']}: "
                            f"{rec.get('reason')}")
            continue
        r, m = rec["roofline"], rec["memory"]
        print(f"dryrun: {rec['cell']} static ({rec['count_s']:.1f} s): "
              f"flops {r['hlo_flops']:.4g}, bytes {r['hlo_bytes']:.4g}, "
              f"collective {r['collective_bytes']:.4g}; compute "
              f"{r['t_compute_s'] * 1e3:.3f} ms, memory "
              f"{r['t_memory_s'] * 1e3:.3f} ms, collective "
              f"{r['t_collective_s'] * 1e3:.3f} ms, dominant {r['dominant']}; "
              f"ideal {r['ideal_s'] * 1e3:.3f} ms, roofline fraction "
              f"{r['roofline_fraction']:.3f}; peak "
              f"{m['peak_bytes'] / 2 ** 30:.2f} GiB (fits 80 GiB: "
              f"{m['fits_hbm']})")
    print(f"dryrun: {len(DRYRUN_CELLS)} static cells in "
          f"{time.perf_counter() - t0:.1f} s")
    mesh = make_production_mesh(multi=True)
    for arch, shape, backend in DRYRUN_REAL:
        cfg = get_config(arch)
        rec = static[(arch, shape)]
        cell = dr.build_cell(cfg, shape, mesh, device=str(dev),
                             backend=backend, seed=SEED)
        positions = (dr.cache_positions(cell.args[1])
                     if cell.kind == "decode" else [])
        last = cell.args[2]["pos"] if positions else None

        def run():
            for p in positions:          # back to S − 1 before each step
                p.fill_(last)
            return cell.step(*cell.args)

        run()
        torch.cuda.synchronize()
        expect = ({"flash_decode": cfg.num_layers}
                  if backend == "cuda" and cell.kind == "decode" else {})
        _, counts = counted(run)
        check_launches(f"dryrun {arch}", counts, expect, 1)
        with OpCost() as c:
            run()
        real = c.analyze()
        torch.cuda.synchronize()
        want = rec["cost_analysis"]["flops"]
        gap = abs(real["flops"] - want) / want
        ops = sorted(set(real["flops_by_op"]) | set(rec["flops_by_op"]))
        differ = {o: (real["flops_by_op"].get(o, 0.0),
                      rec["flops_by_op"].get(o, 0.0)) for o in ops
                  if real["flops_by_op"].get(o, 0.0)
                  != rec["flops_by_op"].get(o, 0.0)}
        if gap > 0.01:
            failures.append(f"dryrun {rec['cell']}: the card's counted flops "
                            f"{real['flops']:.6g} differ from the static "
                            f"{want:.6g} by {gap * 100:.3f}%; ops (card, "
                            f"static): {differ}")
        ms, busy, how = step_device_ms(run, f"dryrun {arch}", failures)
        ideal = rec["roofline"]["ideal_s"]
        frac = (f"{ideal / (busy / 1e3):.4f}" if busy is not None
                else "not measured")
        print(f"dryrun: {rec['cell']} on the card ({backend}, the per-card "
              f"step of {mesh.shape['data']}-way data): device busy "
              f"{_ms(busy)} a step ({how}), {ms:.3f} ms on the "
              f"clock{HOST_NOTE if f'dryrun {arch}' in HOST_GAPS else ''}; "
              f"ideal {ideal * 1e3:.3f} ms (H100: {HBM_BW:.3g} B/s, "
              f"{PEAK_FLOPS_F32:.3g} FLOP/s float32), measured roofline "
              f"fraction {frac} (ideal / device busy); counted flops "
              f"{real['flops']:.6g} vs static {want:.6g} "
              f"({gap * 100:.4f}%), bytes {real['bytes']:.4g} vs static "
              f"{rec['cost_analysis']['bytes']:.4g}, kernels "
              f"{real['kernels']}; ops whose flops differ (card, static): "
              f"{differ}")
        del cell, positions, last
        torch.cuda.empty_cache()
    # the served clip step at the same 256 clips: pruned cuda plans
    cfg = get_config("agcn-2s")
    gen = torch.Generator().manual_seed(SEED)
    params = [init_params(cfg, gen, device=dev) for _ in range(2)]
    prune = plan_from_config(cfg)
    plans = tuple(engine.build_execution_plan(
        p, cfg, prune, quant=True, backend="cuda") for p in params)
    rows = dr.GCN_SHAPES["gcn_infer"].global_batch * cfg.gcn_persons \
        // mesh.shape["data"]
    x = torch.randn(rows, cfg.gcn_frames, cfg.gcn_joints,
                    cfg.gcn_in_channels, device=dev)
    infer = make_gcn_infer_step(cfg)
    with OpCost() as c:
        infer(plans, x)
    served = c.analyze()
    ms, busy, how = step_device_ms(lambda: infer(plans, x),
                                   "dryrun served clip", failures)
    print(f"dryrun: served clip step (make_gcn_infer_step, cuda, pruned, "
          f"{rows // cfg.gcn_persons} clips): device busy {_ms(busy)} "
          f"({how}), {ms:.3f} ms on the clock"
          f"{HOST_NOTE if 'dryrun served clip' in HOST_GAPS else ''}; "
          f"counted flops "
          f"{served['flops']:.4g}, bytes {served['bytes']:.4g}, ops "
          f"{served['ops']}, kernels {served['kernels']} (a different "
          f"program from the dry run's prefill: printed, not compared)")
    del plans, params, x
    torch.cuda.empty_cache()
    print(f"dryrun: phase {time.perf_counter() - t0:.1f} s")


def benches_phase(dev, failures):
    """Phase 19: the port's benches on the card (``benchmarks/torch_*``):
    the Table IV rows (``torch_throughput.table4``, full agcn-2s, ``cuda``,
    b 1 and 16) with one ensemble step's launches checked per variant, then
    ``torch_kernels_bench``, ``torch_throughput``'s measured axes (full
    agcn-2s) and ``torch_roofline_report`` (over the ``dryrun`` phase's
    records) in smoke mode.  Every expected row must come, none
    may be an ERROR row, and every Table IV fps and bound must be
    finite."""
    import math

    from benchmarks import torch_common as common
    from benchmarks import torch_kernels_bench as kb
    from benchmarks import torch_roofline_report as rr
    from benchmarks import torch_throughput as tt
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    nb = len(get_config(ARCH).gcn_channels)
    per_clip = {"graph_sconv": 2 * nb, "cavity_tconv": 2 * nb,
                "rfc_encode": 2 * (nb - 1), "rfc_decode": 2 * (nb - 1)}
    launches = {}

    def count(label, step):
        _, launches[label] = counted(step)

    common.drain_rows()
    table = tt.table4(dev, backends=("cuda",), iters=3, counted=count)
    t_table = time.perf_counter() - t0
    for r in table:
        label = f"{r['backend']}/{r['variant']}/b{r['batch']}"
        want = dict(per_clip, graph_sconv=0 if r["variant"] == "original"
                    else per_clip["graph_sconv"])
        got = {k: v for k, v in launches[label].items() if v}
        if got != {k: v for k, v in want.items() if v}:
            failures.append(f"benches table4 {label}: launches {got}, "
                            f"expected {want} (C_k blocks run no graph_sconv)")
        nums = (r["fps_stream"], r["fps_ensemble"], r["bound_ms"],
                r["model_bound_ms"])
        if not all(math.isfinite(v) and v > 0 for v in nums):
            failures.append(f"benches table4 {label}: fps or bound not "
                            f"finite and positive: {nums}")
        gop = ("n/a" if r["analytic_gop"] is None
               else f"{r['analytic_gop']:.3f}")
        print(f"benches: table4 {label}: fps {r['fps_stream']:.2f} one "
              f"stream, {r['fps_ensemble']:.2f} ensemble "
              f"({r['ms_ensemble']:.3f} ms a step of {r['rows']} rows); "
              f"counted {r['counted_flops']:.4g} FLOP, "
              f"{r['counted_bytes']:.4g} B, {r['ops']} ops; counted "
              f"eager-traffic bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, share {r['eager_share']:.4f}; model bound "
              f"{r['model_bound_ms']:.4f} ms by {r['model_bound_by']} "
              f"({r['model_bytes']:.4g} B), share {r['model_share']:.4f}; "
              f"analytic {gop} GOP a clip stream; launches {got}")
    smoke, common.SMOKE = common.SMOKE, True
    try:
        kb.main(["--backend", "cuda", "--device", str(dev)])
        t_kb = time.perf_counter()
        tt.measured_axes(dev, backends=("cuda",))
        t_ax = time.perf_counter()
        build = ROOT / "build"
        rr.main(["--dryrun-dir", str(build / "chip_smoke_dryrun"),
                 "--baseline-dir", str(build / "chip_smoke_dryrun_baseline"),
                 "--out", str(build / "chip_smoke_roofline.md")])
    finally:
        common.SMOKE = smoke
    rows = common.drain_rows()
    names = [r["name"] for r in rows]
    want = (tt.table4_names() + kb.row_names(("cuda",))
            + tt.axis_names(("cuda",), smoke=True)
            + ["roofline/cells_ok", "roofline/report"])
    missing = sorted(set(want) - set(names))
    errors = [n for n in names if n.endswith("/ERROR")]
    if missing or errors:
        failures.append(f"benches: missing rows {missing}, ERROR rows "
                        f"{errors}")
    cells = [n for n in names if n.startswith("roofline/h100x8/")]
    if len(cells) != len(DRYRUN_CELLS):
        failures.append(f"benches: the roofline report read {len(cells)} "
                        f"h100x8 cells of the dryrun phase's "
                        f"{len(DRYRUN_CELLS)}")
    print(f"benches: {len(rows)} rows, {len(missing)} missing, "
          f"{len(errors)} ERROR; table4 {t_table:.1f} s, kernel bench "
          f"{t_kb - t0 - t_table:.1f} s, measured axes {t_ax - t_kb:.1f} s, "
          f"roofline report {time.perf_counter() - t_ax:.1f} s")
    print(f"benches: phase {time.perf_counter() - t0:.1f} s")


def _leaves(tree):
    from repro_torch.common.tree import tree_leaves
    return tree_leaves(tree)


def run_group(cmd, timeout, env=None):
    """``cmd`` in a process group of its own, its output captured; the
    whole group is killed at ``timeout`` seconds.  Returns (exit code,
    stdout, stderr); 124 on a timeout."""
    import os
    import signal
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
        return proc.returncode, out, err
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        return 124, out, err


def start_group(cmd, out_dir, name, env=None):
    """Start ``cmd`` in a process group of its own beside this process's
    work, its output written to ``out_dir/name.{out,err}``; collect it
    with :func:`wait_group`."""
    out = open(out_dir / f"{name}.out", "w")
    err = open(out_dir / f"{name}.err", "w")
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out, stderr=err,
                            text=True, start_new_session=True)
    return proc, out, err


def wait_group(group, timeout):
    """Wait for a :func:`start_group` command at most ``timeout`` seconds
    more, killing its whole group then (or when this process is leaving
    it); returns (exit code, stdout, stderr), 124 on a timeout."""
    import os
    import signal
    proc, out, err = group
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        rc = 124
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
        out.close()
        err.close()
    return rc, Path(out.name).read_text(), Path(err.name).read_text()


def dist_train_phase(dev, failures, cases, check_launches):
    """Phase 15: LM training and data parallelism.  ``train_loop`` in
    this process for each DIST_TRAIN entry (granite-moe at full width
    with the depth cut to fit beside its optimizer state, 16 bytes a
    parameter; smollm-360m at full width and depth): step p50, tokens/s,
    peak memory and the memory held after each step, finite losses and
    no kernel launch (LM training runs the plain attention).  Before the
    DIST_NCCL entry the same loop runs under ``torchrun
    --nproc-per-node 1`` on NCCL with a (1, 1) mesh and DTensor
    parameters, in a process of its own; its losses must be within 1e-5
    of the loop without a process group (bit-equality is reported).  At
    axis size 1 the step skips every collective, so this run holds the
    DTensor path on the card; no NCCL collective runs with one card.  One
    smollm train step profiled; the 4-rank gloo run of the tests
    (``tests/torch_dist_workers.py smoke``: reduced smollm at data = 4
    against one process, 1e-5), on the host's cores beside the card runs
    from the phase's start; a 2-card NCCL run only when two cards are
    visible."""
    import os
    import shutil
    import torch

    t_phase = time.perf_counter()
    smi = smi_line()
    base = ROOT / "build" / "chip_smoke_dist"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    record = cases["dist_train"] = {"device": smi}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    # the 4-rank gloo run of the tests, on this machine's CPU, beside the
    # card runs below
    t_gloo = time.perf_counter()
    gloo = start_group([sys.executable, str(ROOT / "tests" /
                                            "torch_dist_workers.py"),
                        "smoke", "--ranks", "4", "--steps", "3"],
                       base, "gloo_4", env=env)
    try:
        _dist_train_card(dev, failures, record, check_launches, base, env,
                         smi)
    finally:
        rc, out, err = wait_group(gloo, timeout=max(
            1.0, 400 - (time.perf_counter() - t_gloo)))
    try:
        smoke = json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        smoke = None
    if rc != 0 or smoke is None:
        print(out[-3000:], err[-3000:], sep="\n")
        failures.append(f"dist_train: the 4-rank gloo run exited {rc}")
    else:
        record["gloo_4"] = smoke
        print(f"dist_train: reduced smollm-360m on 4 gloo ranks (CPU, "
              f"data = 4, beside the card runs) against one process: loss "
              f"gap {smoke['loss_gap']:.3g}, parameter gap "
              f"{smoke['param_gap']:.3g} (bound 1e-5); done "
              f"{time.perf_counter() - t_gloo:.1f} s after its start")
        if smoke["loss_gap"] > 1e-5 or smoke["param_gap"] > 1e-5:
            failures.append(f"dist_train: 4 gloo ranks part from one "
                            f"process: {smoke}")

    if torch.cuda.device_count() >= 2:
        arch, _, B, S, steps = next(e for e in DIST_TRAIN
                                    if e[0] == DIST_NCCL)
        rc, out, err = run_group(_torchrun_cmd(
            base, 2, arch, B, S, steps, base / "nccl_2x1.json"), timeout=600,
            env=env)
        print(f"dist_train: 2 cards on NCCL, mesh (2, 1): exit {rc}; "
              f"{out.strip().splitlines()[-1:] or ''}")
        if rc != 0:
            failures.append(f"dist_train: the 2-card NCCL run exited {rc}")
    else:
        print(f"dist_train: a 2-card NCCL run was not run "
              f"({torch.cuda.device_count()} card visible)")
    print(f"dist_train: phase took {time.perf_counter() - t_phase:.1f} s")


def _torchrun_cmd(base, cards, arch, B, S, steps, out_json):
    """``launch.train`` of ``arch`` on ``cards`` NCCL ranks, a (cards, 1)
    mesh."""
    return [sys.executable, "-m", "torch.distributed.run",
            "--standalone", "--nproc-per-node", str(cards), "-m",
            "repro_torch.launch.train", "--arch", arch, "--steps",
            str(steps), "--batch", str(B), "--seq", str(S), "--lr",
            str(DIST_LR), "--mesh", f"{cards},1", "--ckpt-dir",
            str(base / f"ckpt_{cards}x1"), "--out", str(out_json)]


def _dist_train_card(dev, failures, record, check_launches, base, env, smi):
    """The card runs of :func:`dist_train_phase`: each DIST_TRAIN entry's
    ``train_loop``, the (1, 1)-mesh torchrun before the DIST_NCCL entry
    and its train step profiled."""
    import gc
    import numpy as np
    import torch
    from repro_torch.common.config import TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batches
    from repro_torch.launch.train import train_loop
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    def torchrun_1x1(arch, B, S, steps):
        """The loop under torchrun on NCCL: one rank, a (1, 1) mesh, in a
        process of its own; returns its JSON (None on a failure)."""
        gc.collect()
        torch.cuda.empty_cache()
        print(f"dist_train: this process holds "
              f"{torch.cuda.memory_allocated(dev) / 2**30:.3f} GiB allocated, "
              f"{torch.cuda.memory_reserved(dev) / 2**30:.3f} GiB reserved "
              f"before the torchrun child")
        out_json = base / "nccl_1x1.json"
        t0 = time.perf_counter()
        rc, out, err = run_group(_torchrun_cmd(base, 1, arch, B, S, steps,
                                               out_json),
                                 timeout=600, env=env)
        nccl = None
        if rc != 0 or not out_json.exists():
            print(out[-3000:], err[-3000:], sep="\n")
            failures.append(f"dist_train: torchrun (1, 1) on NCCL exited "
                            f"{rc}")
        else:
            nccl = record["nccl_1x1"] = json.loads(out_json.read_text())
            print(f"dist_train: {arch} under torchrun --nproc-per-node 1 on "
                  f"NCCL, mesh (1, 1), DTensor parameters: losses "
                  f"{[round(x, 6) for x in nccl['losses']]}, step p50 "
                  f"{statistics.median(nccl['step_ms'][1:]):.3f} ms, peak "
                  f"{nccl['peak_bytes'] / 2**30:.3f} GiB; "
                  f"{time.perf_counter() - t0:.1f} s with the process start")
        return nccl

    nccl = None
    for arch, layers, B, S, steps in DIST_TRAIN:
        if arch == DIST_NCCL:
            nccl = torchrun_1x1(arch, B, S, steps)
        full = get_config(arch)
        cfg = dataclasses.replace(full, num_layers=layers) if layers else full
        # the CLI's TrainConfig for these flags (lr, steps, warmup, seed 0)
        tcfg = TrainConfig(learning_rate=DIST_LR, total_steps=steps,
                           warmup_steps=max(1, steps // 10),
                           checkpoint_every=0,
                           checkpoint_dir=str(base / "none"))
        step_ms, held = [], []

        def on_step(*a):
            step_ms.append(a[-1])
            held.append(torch.cuda.memory_allocated(dev) / 2**30)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
        try:
            (params, losses), counts = counted(lambda: train_loop(
                arch, tcfg, reduced=False, batch=B, seq=S, device=dev,
                resume=False, log_every=steps, cfg=cfg, on_step=on_step))
        except torch.OutOfMemoryError as e:
            failures.append(f"dist_train {arch}: out of memory with "
                            f"{before / 2**30:.3f} GiB held before, GiB "
                            f"allocated after each step {held}: "
                            f"{str(e)[:160]}")
            print(f"dist_train: {failures[-1]}")
            continue
        check_launches(f"dist_train {arch}", counts, {}, steps)
        peak = torch.cuda.max_memory_allocated(dev) - before
        n = sum(p.numel() for p in _leaves(params))
        p50 = statistics.median(step_ms[1:])
        record[arch] = {"losses": losses, "step_ms": step_ms,
                        "peak_bytes": peak, "params": n, "layers":
                        cfg.num_layers}
        cut = (f", depth cut to {cfg.num_layers} of {full.num_layers} "
               f"layers" if layers else "")
        print(f"dist_train: {arch} at full width{cut} ({n / 1e9:.3f} B "
              f"float32 parameters, AdamW), batch {B} x seq {S}, {steps} "
              f"steps of train_loop: step p50 {p50:.3f} ms over steps 2-"
              f"{steps} (first {step_ms[0]:.3f} ms; host clock from the "
              f"batch to the loss read), {B * S / (p50 / 1e3):.1f} tokens/s "
              f"at p50, peak memory {peak / 2**30:.3f} GiB "
              f"(max_memory_allocated less the {before / 2**30:.3f} GiB held "
              f"before; GiB allocated after each step "
              f"{[round(x, 3) for x in held]}); losses "
              f"{[round(x, 4) for x in losses]}; {smi}")
        if not np.isfinite(losses).all():
            failures.append(f"dist_train {arch}: a loss is not finite: "
                            f"{losses}")
        if arch == DIST_NCCL:
            if nccl is not None:
                gap = max(abs(a - b) for a, b in zip(nccl["losses"], losses))
                same = nccl["losses"] == losses
                print(f"dist_train: the (1, 1)-mesh torchrun losses against "
                      f"the loop without a process group: max |diff| "
                      f"{gap:.3g} ({'bit-equal' if same else 'not bit-equal'}"
                      f"; bound 1e-5)")
                if len(nccl["losses"]) != steps or gap > 1e-5:
                    failures.append(f"dist_train: the (1, 1)-mesh run's "
                                    f"losses are {gap:.3g} from the loop "
                                    f"without a process group")
            b = {k: torch.as_tensor(v, device=dev) for k, v in next(
                make_batches(cfg, DataConfig(B, S, seed=SEED))).items()}
            step_fn = make_train_step(cfg, tcfg)
            opt = adamw.init(params)
            profile_steps(f"train step {arch}", lambda: step_fn(
                params, opt, b), steps=1)
            del b, opt, step_fn
        del params
        gc.collect()
        torch.cuda.empty_cache()
        print(f"dist_train: {torch.cuda.memory_allocated(dev) / 2**30:.3f} "
              f"GiB allocated after the {arch} run")


# ---------------------------------------------------------------------------
# phase 19: the model axis and the kv_seq decode, 2 ranks on the card
# ---------------------------------------------------------------------------

# the collectives the port's layers, steps and optimizer call through
# torch.distributed, checked on CUDA tensors over gloo on each rank
MP_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                  "reduce_scatter_tensor", "all_to_all_single")


def _mp_check_collectives(dev) -> None:
    """Run each collective of ``MP_COLLECTIVES`` on small CUDA tensors over
    this rank's gloo group and raise (failing the rank, and so the phase)
    where gloo refuses one or returns a wrong value: the port's layers
    hand gloo CUDA tensors, and nothing here stages them through the
    host."""
    import torch
    import torch.distributed as dist
    n = dist.get_world_size()
    ones = torch.ones(2 * n, device=dev)
    cases = {   # name: (call, its output, the value every element must hold)
        "all_reduce": (lambda out: dist.all_reduce(out), ones.clone(),
                       float(n)),
        "all_gather_into_tensor": (
            lambda out: dist.all_gather_into_tensor(out, ones[:2]),
            torch.zeros(2 * n, device=dev), 1.0),
        "reduce_scatter_tensor": (
            lambda out: dist.reduce_scatter_tensor(out, ones),
            torch.zeros(2, device=dev), float(n)),
        "all_to_all_single": (
            lambda out: dist.all_to_all_single(out, ones.clone()),
            torch.zeros(2 * n, device=dev), 1.0)}
    for name in MP_COLLECTIVES:
        call, out, value = cases[name]
        call(out)
        torch.cuda.synchronize(dev)
        if not bool((out == value).all()):
            raise RuntimeError(f"gloo's {name} on CUDA tensors gave "
                               f"{out.tolist()}, not all {value}")


def _mp_cut(p, placements, mesh):
    """This rank's shard of a whole tensor under DTensor ``placements``."""
    for i, pl in enumerate(placements):
        if pl.is_shard() and mesh.size(i) > 1:
            k = p.shape[pl.dim] // mesh.size(i)
            p = p.narrow(pl.dim, mesh.get_local_rank(i) * k, k)
    return p.contiguous()


def _mp_residuals():
    """A recorder of the residual's shapes between blocks on this rank
    (``tests/torch_dist_workers.Residuals``, the repo's JAX-free rank
    helpers): a sequence shard where sequence parallelism ran."""
    if str(ROOT / "tests") not in sys.path:
        sys.path.insert(0, str(ROOT / "tests"))
    from torch_dist_workers import Residuals
    return Residuals()


def _mp_cfg(arch, layers):
    """``arch`` at full width cut to ``layers`` (the encoder too, for the
    audio family), or whole for 0."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    if not layers:
        return full
    extra = {"encoder_layers": layers} if full.family == "audio" else {}
    return dataclasses.replace(full, num_layers=layers, **extra)


def _mp_params(cfg, dev, dtype=None):
    """Parameters of seed SEED on ``dev``, float64 with ``dtype``."""
    from repro_torch.models import registry
    params = registry.init_params(cfg, seed=SEED, device=dev)
    if dtype == "float64":
        _to_float64_(params)
    return params


def _mp_train(cfg, mesh, batches, policy, lr, dtype=None, stats=None):
    """``make_train_step`` on ``mesh`` for ``len(batches)`` steps from
    parameters of seed SEED (float64 with ``dtype``), laid out by
    ``param_shardings`` (each rank cuts its shard:
    ``DTensor.from_local``, no collective), under ``rules_for`` of the
    policy (``seq_shard`` on ``model``): (losses, the final parameters'
    local shards by path, the shardings).  With
    ``stats`` (a dict) the first step's residual shapes between blocks go
    to its "residual"."""
    from torch.distributed.tensor import DTensor
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.tree import tree_map, tree_paths
    from repro_torch.distributed.params import param_shardings
    from repro_torch.distributed.sharding import (batch_rank, batch_ranks,
                                                  rules_for)
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step, shard_batch
    dev = next(iter(batches[0].values())).device
    full = _mp_params(cfg, dev, dtype)
    sh = param_shardings(full, mesh, expert_dim=cfg.padded_experts or None,
                         policy=policy)
    rows = next(iter(batches[0].values())).shape[0]
    rules = rules_for(policy, rows, mesh)
    params = tree_map(lambda p, s: DTensor.from_local(
        _mp_cut(p, s.placements, mesh), mesh, s.placements, run_check=False),
        full, sh)
    del full
    tcfg = TrainConfig(learning_rate=lr, total_steps=len(batches),
                       warmup_steps=1)
    step = make_train_step(cfg, tcfg, grad_shardings=sh, rules=rules)
    opt, losses = adamw.init(params), []
    for i, b in enumerate(batches):
        local = shard_batch(b, batch_rank(mesh, rules),
                            batch_ranks(mesh, rules))
        with _mp_residuals() as res:
            params, opt, m = step(params, opt, local)
        losses.append(float(m["loss"]))
        if stats is not None and i == 0:
            stats["residual"] = res.layout()
    return losses, {n: p.to_local() for n, p in tree_paths(params)}, sh


def _mp_sp_step(cfg, mesh, batch, rules):
    """One train step's forward and backward on ``mesh`` under ``rules``,
    from parameters of seed SEED cut to this rank's model shards: its loss,
    the residual's shapes between blocks, this process's peak allocated
    memory over the forward and backward ("peak_gib"; the parameters
    included, AdamW's update, which the layout does not touch, left out)
    and their seconds."""
    import gc
    import torch
    from repro_torch.distributed import params as dparams
    from repro_torch.distributed.sharding import (axis_rules, batch_rank,
                                                  batch_ranks)
    from repro_torch.train.steps import (loss_and_grads, make_loss_fn,
                                         shard_batch)
    dev = next(iter(batch.values())).device
    layout = dparams.model_layout(cfg, mesh)
    local = dparams.local_shards(_mp_params(cfg, dev), layout.specs, mesh)
    b = shard_batch(batch, batch_rank(mesh, rules), batch_ranks(mesh, rules))
    loss_fn = make_loss_fn(cfg)
    gc.collect()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with axis_rules(mesh, rules, layout.plan), _mp_residuals() as res:
        loss, _, grads = loss_and_grads(lambda p, bt: loss_fn(
            dparams.prepare(p, layout), bt), local, b)
    torch.cuda.synchronize(dev)
    out = {"loss": float(loss), "residual": res.layout(),
           "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
           "s": time.perf_counter() - t0}
    del local, grads
    return out


def _mp_one_rank(cfg, batches, lr, dtype=None):
    """The same training in this rank alone (no mesh): (losses, final
    parameters, where the first step's gradients exceed 1e-6), by
    path."""
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.tree import tree_paths
    from repro_torch.optim import adamw
    from repro_torch.train.steps import (loss_and_grads, make_loss_fn,
                                         make_train_step)
    dev = next(iter(batches[0].values())).device
    params = _mp_params(cfg, dev, dtype)
    g1 = {n: g.abs() > 1e-6 for n, g in tree_paths(loss_and_grads(
        make_loss_fn(cfg), params, batches[0])[2])}
    tcfg = TrainConfig(learning_rate=lr, total_steps=len(batches),
                       warmup_steps=1)
    step = make_train_step(cfg, tcfg)
    opt, losses = adamw.init(params), []
    for b in batches:
        params, opt, m = step(params, opt, b)
        losses.append(float(m["loss"]))
    return losses, dict(tree_paths(params)), g1


def _mp_decode(cfg, params, toks, slots, backend, mesh=None, rules=None,
               dtype=None, fill=None, memory=None, prompt=1, stats=None):
    """Teacher-forced serve steps of ``toks`` (B, T) from position ``pos0``
    of ``fill`` (a function filling a fresh cache; else an empty cache at
    position 0), on ``mesh`` when given, the audio family over
    ``memory``: the first ``prompt`` tokens in one step (a decoder's
    prefill), then one a step.  Returns (the last position's logits of
    each step (T − prompt + 1, B, vocab) on the host, launch counts of the
    steps); with ``stats`` (a dict) also "prefill_residual" (the first
    step's residual shapes between blocks) and "steps" (the one-token
    steps)."""
    import contextlib
    import torch
    from repro_torch.distributed import params as dparams
    from repro_torch.kernels import _build
    from repro_torch.models import registry
    from repro_torch.train.steps import make_serve_step
    dev = toks.device
    ctx = (dparams.mesh_context(cfg, mesh, rules) if mesh is not None
           else contextlib.nullcontext())
    with ctx:
        cache = registry.init_cache(cfg, toks.shape[0], slots, device=dev,
                                    dtype=dtype or torch.float32)
    pos0 = fill(cache) if fill is not None else 0
    step = make_serve_step(cfg, backend, mesh, rules)
    extra = {} if memory is None else {"memory": memory}
    out = []
    _build.reset_launch_counts()
    t = 0
    while t < toks.shape[1]:
        n = prompt if t == 0 else 1
        with _mp_residuals() as res:
            _, cache, last = step(params, cache, {
                "tokens": toks[:, t:t + n],
                "pos": torch.tensor(pos0 + t, dtype=torch.int32, device=dev),
                **extra})
        if stats is not None and t == 0:
            stats["prefill_residual"] = res.layout()
        out.append(last.double() if dtype == torch.float64
                   else last.float())
        t += n
    torch.cuda.synchronize(dev)
    counts = dict(_build.LAUNCHES)
    if stats is not None:
        stats["steps"] = toks.shape[1] - (prompt if prompt > 1 else 0)
    return torch.stack(out).cpu(), counts


def mp_kv_fill(cfg, lo, n, dev, slots, pos):
    """A function that fills a decode cache with slots [lo, lo + n) of
    the seeded full cache of ``slots`` slots (bf16 values, widened where
    the cache is float32: per layer and leaf a generator on ``dev``
    seeded from SEED, the layer and the leaf) and sets its positions to
    ``pos``; it returns ``pos``."""
    import torch

    def fill(cache):
        ng, g = cache["k"].shape[:2]
        for li in range(ng * g):
            for j, name in enumerate(("k", "v")):
                gen = torch.Generator(device=dev).manual_seed(
                    SEED * 100_000 + 2 * li + j)
                whole = torch.randn(
                    (cache[name].shape[2], slots, cfg.num_kv_heads,
                     cfg.head_dim), generator=gen, device=dev).to(
                    torch.bfloat16)
                cache[name][li // g, li % g].copy_(whole[:, lo:lo + n])
        cache["pos"].fill_(pos)
        return pos
    return fill


def _mp_within(a) -> bool:
    """Are one arch's gaps from one rank within the phase's bounds (losses
    1e-5, parameters 1e-4, logits 1e-4, finite logits)?"""
    return (a["loss_gap"] <= 1e-5 and a["param_gap"] <= 1e-4
            and a["logit_gap"] <= 1e-4 and a["logits_finite"])


def _mp_check(cfg, mesh, batches, toks, memory, backend, dtype):
    """One arch on ``mesh`` against this rank alone: ``MP_STEPS`` train
    steps (losses, and the parameters' local shards wherever the one-rank
    first gradient exceeds 1e-6), then teacher-forced decode steps of
    ``toks`` on ``backend`` (a decoder's first ``MP_PROMPT`` tokens in
    one prefill step); float64 parameters, batches, caches and memory
    with ``dtype``.  Returns the gaps, the residual's shapes between
    blocks in the first train step and the prefill, and the decode's
    launch counts on the mesh."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import params as dparams
    from repro_torch.distributed.sharding import rules_for
    if dtype == "float64":
        batches = [{k: v.double() if v.is_floating_point() else v
                    for k, v in b.items()} for b in batches]
        memory = memory.double() if memory is not None else None
    t0 = time.perf_counter()
    train = {}
    losses, mine, sh = _mp_train(cfg, mesh, batches, cfg.sharding, DIST_LR,
                                 dtype, stats=train)
    t_mesh = time.perf_counter() - t0
    # the one-rank reference: in float64 one rank at a time (two whole
    # float64 models in training do not fit one card beside each other)
    serial = dtype == "float64"
    t0 = time.perf_counter()
    for turn in range(dist.get_world_size() if serial else 1):
        if not serial or turn == dist.get_rank():
            ref_losses, ref, g1 = _mp_one_rank(cfg, batches, DIST_LR, dtype)
            gaps = []
            for (n, p), s in zip(mine.items(), _leaves(sh)):
                big = _mp_cut(g1[n], s.placements, mesh)
                if bool(big.any()):
                    want = _mp_cut(ref[n], s.placements, mesh)
                    gaps.append(float((p - want).abs()[big].max()))
            del ref, g1
            gc.collect()
            torch.cuda.empty_cache()
        if serial:
            dist.barrier()
    t_ref = time.perf_counter() - t0
    del mine
    t0 = time.perf_counter()
    layout = dparams.model_layout(cfg, mesh)
    full = _mp_params(cfg, toks.device, dtype)
    local = dparams.local_shards(full, layout.specs, mesh)
    rules = rules_for(layout.policy, MP_BATCH, mesh)
    cache_dtype = torch.float64 if dtype == "float64" else None
    prompt = MP_PROMPT if cfg.family in ("dense", "moe", "vlm") else 1
    dec = {}
    logits, counts = _mp_decode(cfg, local, toks, MP_DECODE_SLOTS, backend,
                                mesh, rules, cache_dtype, memory=memory,
                                prompt=prompt, stats=dec)
    want, _ = _mp_decode(cfg, full, toks, MP_DECODE_SLOTS, backend,
                         dtype=cache_dtype, memory=memory, prompt=prompt)
    del full, local
    gc.collect()
    torch.cuda.empty_cache()
    t_dec = time.perf_counter() - t0
    return {"dtype": dtype or "float32", "backend": backend,
            "plan": layout.plan._asdict(), "losses": losses,
            "one_rank_losses": ref_losses,
            "loss_gap": max(abs(x - y) for x, y in zip(losses, ref_losses)),
            "param_gap": max(gaps), "train_s": t_mesh, "one_rank_s": t_ref,
            "decode_s": t_dec, "residual": train["residual"],
            "prompt": prompt, "prefill_residual": dec["prefill_residual"],
            "decode_steps": dec["steps"],
            "logit_gap": float((logits - want).abs().max()),
            "logits_finite": bool(torch.isfinite(logits).all()),
            "decode_counts": counts}


def _mp_rank(rank, world, init, out_dir, spec):
    """One rank of the model_parallel phase on the card (``spec``: the
    process group's backend, the kv_seq cache's slots and position):
    every case on this rank, its numbers to ``out_dir/rank<r>.json`` (the
    traceback there on a failure, and the process then fails)."""
    import gc
    import traceback
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batches
    from repro_torch.distributed.sharding import make_mesh, rules_for
    from repro_torch.models import registry
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", rank if spec["backend"] == "nccl" else 0)
    torch.cuda.set_device(dev)
    dist.init_process_group(spec["backend"], init_method=f"file://{init}",
                            rank=rank, world_size=world)
    rec, out = {"rank": rank}, Path(out_dir)
    try:
        if spec["backend"] == "gloo":
            _mp_check_collectives(dev)

        def to_dev(b):
            return {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
        tok_gen = np.random.default_rng(SEED)
        for arch, layers in MP_TRAIN:
            cfg = _mp_cfg(arch, layers)
            data = make_batches(cfg, DataConfig(MP_BATCH, MP_SEQ, seed=SEED))
            batches = [to_dev(next(data)) for _ in range(MP_STEPS)]
            toks = torch.as_tensor(tok_gen.integers(
                0, cfg.vocab_size, (MP_BATCH, MP_DECODE)), device=dev)
            memory = None
            if cfg.family == "audio":
                memory = torch.randn(
                    (MP_BATCH, cfg.encoder_frames, cfg.d_model),
                    generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
            mesh = make_mesh((1, world), dev)
            a = _mp_check(cfg, mesh, batches, toks, memory, "cuda", None)
            a["layers"] = cfg.num_layers
            rec[arch] = a
            if cfg.family in MP_F64_FAMILIES and not _mp_within(a):
                a["float64"] = _mp_check(cfg, mesh, batches, toks, memory,
                                         "reference", "float64")
        # sequence parallelism against the replicated layout at a longer
        # sequence: a train step's forward and backward each way, this
        # process's peak memory over them
        arch, layers, B, S = MP_SP_CASE
        cfg = _mp_cfg(arch, layers)
        batch = to_dev(next(make_batches(cfg, DataConfig(B, S, seed=SEED))))
        mesh = make_mesh((1, world), dev)
        t0 = time.perf_counter()
        rec["sp_case"] = {}
        for tag, rule in (("sp", "model"), ("none", None)):
            rules = dict(rules_for(cfg.sharding, B, mesh), seq_shard=rule)
            rec["sp_case"][tag] = _mp_sp_step(cfg, mesh, batch, rules)
            gc.collect()
            torch.cuda.empty_cache()
        rec["sp_case"]["s"] = time.perf_counter() - t0
        # agcn-2s under dp_only: the model axis carries batch.  cuDNN's
        # convolution gradients sum with atomics unless deterministic, and
        # the two meshes' losses are held equal
        gcn = get_config("agcn-2s", reduced=True)
        data = make_batches(gcn, DataConfig(8, 0, seed=SEED))
        batches = [to_dev(next(data)) for _ in range(MP_STEPS)]
        torch.backends.cudnn.deterministic = True
        rec["gcn"] = {str(shape): _mp_train(
            gcn, make_mesh(shape, dev), batches, "dp_only", DIST_LR)[0]
            for shape in ((1, world), (world, 1))}
        torch.backends.cudnn.deterministic = False
        # the kv_seq decode: batch 1 over (world, 1), the cache's slots split
        cfg = get_config(MP_KV_ARCH)
        mesh = make_mesh((world, 1), dev)
        rules = rules_for(cfg.sharding, 1, mesh)
        params = registry.init_params(cfg, seed=SEED, device=dev)
        n = spec["slots"] // world
        toks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
            0, cfg.vocab_size, (1, MP_KV_STEPS)), device=dev)
        logits, counts = _mp_decode(
            cfg, params, toks, spec["slots"], "cuda", mesh, rules, torch.bfloat16,
            mp_kv_fill(cfg, rank * n, n, dev, spec["slots"], spec["pos"]))
        torch.save(logits, out / f"kv_logits_rank{rank}.pt")
        rec["kv_seq"] = {"rules": {"kv_seq": rules["kv_seq"],
                                   "batch": rules["batch"]},
                         "slots_a_rank": n, "decode_counts": counts}
    except BaseException:
        rec["error"] = traceback.format_exc()
        raise
    finally:
        (out / f"rank{rank}.json").write_text(json.dumps(rec))
        if dist.is_initialized():
            dist.destroy_process_group()


def _mp_spawn(spec, out_dir, timeout):
    """Start ``spec["ranks"]`` processes of :func:`_mp_rank` (a ``file://``
    rendezvous under ``out_dir``); returns a function that waits for them
    (killing them past ``timeout`` seconds) and returns their exit codes."""
    import torch.multiprocessing as mp
    init = Path(out_dir) / f"rdzv_{time.monotonic_ns()}"
    ctx = mp.start_processes(_mp_rank, args=(
        spec["ranks"], str(init), str(out_dir), spec), nprocs=spec["ranks"],
        join=False, start_method="spawn")
    deadline = time.monotonic() + timeout

    def wait():
        while not all(p.exitcode is not None for p in ctx.processes):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    if p.is_alive():
                        p.kill()
                break
            time.sleep(0.2)
        for p in ctx.processes:
            p.join(5)
        return [p.exitcode for p in ctx.processes]
    return wait


def _mp_kernel_case(name, q, k, v, valid, offset, row_max, served):
    """The partial form (``name`` "flash_decode_partial") or the row-max
    pass ("flash_decode_row_max") against its plain version on one input,
    timed beside the bound (the rows this shard holds live) and, for the
    partial form, masked ``F.scaled_dot_product_attention`` on the same
    shard (float32 k and v: SDPA takes one dtype)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_decode as fd
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    n = int(valid.item())
    rows = max(0, min(n - offset, S))
    itemsize = k.element_size()
    if name == "flash_decode_row_max":
        kern = lambda: fd.flash_decode_row_max(q, k, valid, offset=offset)
        plain = lambda: fd.flash_decode_row_max_ref(q, k, valid, 0, offset)
        flops, nbytes = fd.flash_decode_row_max_work(B, S, Hkv, G, D,
                                                     itemsize, rows)
        library, tol = None, 1e-5
    else:
        kern = lambda: fd.flash_decode_partial(q, k, v, valid, offset=offset,
                                               row_max=row_max)
        plain = lambda: fd.flash_decode_partial_ref(q, k, v, valid, 0,
                                                    offset, row_max)
        flops, nbytes = fd.flash_decode_partial_work(B, S, Hkv, G, D,
                                                     itemsize, rows)
        slots = offset + torch.arange(S, device=k.device)
        live = (slots < n).view(1, 1, 1, S)
        qh = q.reshape(B, Hkv * G, 1, D)
        kh = k.float().permute(0, 2, 1, 3)
        vh = v.float().permute(0, 2, 1, 3)
        library = lambda: F.scaled_dot_product_attention(
            qh, kh, vh, attn_mask=live, enable_gqa=True)
        tol = 1e-5
        if k.dtype == torch.bfloat16:
            f32 = fd.flash_decode_partial_ref(q, k.float(), v.float(), valid,
                                              0, offset)[0]
            gap = float((plain()[0] - f32).abs().max())
            tol = fd.bf16_bound(gap, fd.BF16_CAP_SERVED if served
                                else fd.BF16_CAP_RANDOM)
    got, want = kern(), plain()
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    b_ms, t_bytes, t_ops = bound_ms(nbytes, flops)
    return {"shape": [list(q.shape), list(k.shape)], "offset": offset,
            "valid": n, "rows": rows,
            "cache": str(k.dtype).replace("torch.", ""),
            "ok": err <= tol, "max_abs_err": err, "tol": tol,
            "ms": cuda_ms(kern, label=f"{name} kernel"),
            "plain_ms": cuda_ms(plain, reps=3, inner=3,
                                label=f"{name} plain"),
            "library_ms": (cuda_ms(library, label=f"{name} library")
                           if library is not None else None),
            "composite_ms": None, "bound_ms": b_ms, "bytes_ms": t_bytes,
            "ops_ms": t_ops, "bound_f32_ms": b_ms, "split_floor_ms": None}


def _mp_layout(shapes, seq) -> str:
    """Whether sequence parallelism ran, read off the residual's shapes
    between blocks on a rank (``seq`` tokens a sequence)."""
    if not shapes:
        return "sequence parallelism off (no sequence-sharded residual)"
    lens = sorted({sh[1] for sh in shapes})
    if lens == [seq]:
        return f"sequence parallelism off (residual {shapes[0]} whole)"
    return (f"sequence parallelism on (residual {shapes[0]} a rank, "
            f"shard length {lens[0]} of {seq})")


def _mp_gaps(a) -> str:
    """One arch's gaps from one rank, each beside its bound, and the
    seconds of the one-rank training and of the two decodes."""
    return (f"against one rank ({a['one_rank_s']:.1f} s) |diff| "
            f"{a['loss_gap']:.3g} (bound 1e-5), "
            f"parameters {a['param_gap']:.3g} (bound 1e-4 where the first "
            f"gradient exceeds 1e-6); {MP_DECODE} {a['backend']} decode "
            f"steps' logits {a['logit_gap']:.3g} (bound 1e-4; "
            f"{a['decode_s']:.1f} s)")


def model_parallel_phase(dev, failures, cases, summary, check_launches,
                         modules):
    """Phase 19: the model axis and the kv_seq decode on 2 ranks of this
    card, gloo carrying CUDA tensors (NCCL takes no two ranks on one
    device).  Each rank first checks that gloo takes the collectives the
    port calls on CUDA tensors (:func:`_mp_check_collectives`; a refusal
    fails the phase); the compute and every kernel stay on the card.  On
    a (1, 2) mesh: granite-moe, h2o-danube, xlstm, zamba2 and whisper at
    full width, depth cut (MP_TRAIN), 3 train steps against the same
    training in one rank on the card (losses 1e-5; the parameters' local
    shards 1e-4 wherever the one-rank first gradient exceeds 1e-6), the
    residual between blocks a sequence shard of every family but
    whisper's, then 8 teacher-forced ``cuda`` decode tokens against one
    rank (a decoder's first MP_PROMPT in one prefill step, sequence
    parallel; logits 1e-4; one flash_decode an attention a one-token step
    on each rank, Hkv / 2 heads); MP_SP_CASE (danube at 2 x 1024) a train
    step's forward and backward sequence-parallel and replicated, losses
    within MP_SP_TOL, the sequence-parallel peak memory over them lower
    on each rank;
    the SSM and hybrid families again in float64 where float32 misses a
    bound (``reference`` decode), the float64 gaps then deciding;
    flash_decode held at the ranks' head shards (MP_FD_CASES);
    agcn-2s (reduced) under ``dp_only`` on (1, 2) against (2, 1) (the same
    losses, cuDNN deterministic: its convolution gradients otherwise sum
    with atomics); smollm-360m at full width and depth at batch 1 over a bf16
    cache of MP_KV_SLOTS slots on (2, 1) under kv_seq (each rank its
    half, from a seeded generator, 24 slots before its end): 8 ``cuda``
    steps against this process's unsharded decode of the same cache
    (logits within ``flash_decode.bf16_bound`` of the gap the same decode
    on the cache widened to float32 opens; flash_decode_row_max and
    flash_decode_partial once a layer a step on each rank).  Then the
    partial form and the row-max pass held to their plain versions at the
    path's shard (and the partial form on float32, 1e-5), timed beside
    their bound and masked SDPA.  With 2 cards visible the ranks run again
    on NCCL, one card each."""
    import gc
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.models import registry
    t_phase = time.perf_counter()
    smi = smi_line()
    base = ROOT / "build" / "chip_smoke_mp"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    slots = MP_KV_SLOTS
    spec = {"backend": "gloo", "slots": slots,
            "pos": slots - 3 * MP_KV_STEPS, "ranks": 2}
    wait = _mp_spawn(spec, base, timeout=MP_TIMEOUT)

    # meanwhile: the unsharded kv_seq reference on this card, on the bf16
    # cache and on the same values widened to float32
    cfg = get_config(MP_KV_ARCH)
    params = registry.init_params(cfg, seed=SEED, device=dev)
    toks = torch.as_tensor(np.random.default_rng(SEED + 1).integers(
        0, cfg.vocab_size, (1, MP_KV_STEPS)), device=dev)
    fill = mp_kv_fill(cfg, 0, slots, dev, slots, spec["pos"])
    want, _ = _mp_decode(cfg, params, toks, spec["slots"], "cuda",
                         dtype=torch.bfloat16, fill=fill)
    gc.collect()
    wide, _ = _mp_decode(cfg, params, toks, spec["slots"], "cuda",
                         dtype=torch.float32, fill=fill)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    codes = wait()
    t_ranks = time.perf_counter() - t_phase
    recs = []
    for r in range(spec["ranks"]):
        path = base / f"rank{r}.json"
        recs.append(json.loads(path.read_text()) if path.exists() else
                    {"error": "no record"})
    record = cases["model_parallel"] = {"device": smi, "exit": codes,
                                        "ranks": recs}
    if any(c != 0 for c in codes) or any("error" in r for r in recs):
        for r in recs:
            if "error" in r:
                print(r["error"][-3000:])
        failures.append(f"model_parallel: the ranks exited {codes}")
        return
    print(f"model_parallel: 2 ranks on one card over gloo, which took "
          f"{', '.join(MP_COLLECTIVES)} on CUDA tensors; "
          f"{t_ranks:.1f} s for the ranks")
    for arch, layers in MP_TRAIN:
        arch_cfg = _mp_cfg(arch, layers)
        for r, rec in enumerate(recs):
            a = rec[arch]
            line = _mp_gaps(a)
            f64 = a.get("float64")
            if f64 is not None:
                line += (f"; missed in float32, so again in float64 "
                         f"({f64['backend']} decode): {_mp_gaps(f64)}")
            pre = ""
            if a["prompt"] > 1:
                pre = (f"; the decode's {a['prompt']}-token prefill: "
                       f"{_mp_layout(a['prefill_residual'], a['prompt'])}")
            print(f"model_parallel: {arch} at full width, {a['layers']} "
                  f"layers, mesh (1, 2) rank {r}, plan {a['plan']}: "
                  f"{MP_STEPS} train steps (batch {MP_BATCH} x "
                  f"{MP_SEQ}, {a['train_s']:.1f} s; "
                  f"{_mp_layout(a['residual'], MP_SEQ)}) losses "
                  f"{[round(x, 6) for x in a['losses']]}, {line}{pre}; "
                  f"launches "
                  f"{ {k: v for k, v in a['decode_counts'].items() if v} }")
            # every family but the encoder-decoder (whose JAX original
            # constrains its residual whole) holds it as a sequence shard
            shard = [MP_BATCH, MP_SEQ // 2, arch_cfg.d_model]
            expect = [shard] if arch_cfg.family != "audio" else []
            if a["residual"] != expect:
                failures.append(f"model_parallel {arch} rank {r}: residual "
                                f"{a['residual']} between blocks, expected "
                                f"{expect}")
            held = f64 if f64 is not None else a
            if not _mp_within(held):
                failures.append(f"model_parallel {arch} rank {r} "
                                f"({held['dtype']}): losses "
                                f"{held['loss_gap']:.3g}, parameters "
                                f"{held['param_gap']:.3g}, logits "
                                f"{held['logit_gap']:.3g} from one rank")
            check_launches(f"mp {arch} rank {r}", a["decode_counts"],
                           {"flash_decode": _flash_decode_per_step(
                               arch_cfg)}, a["decode_steps"])
    # sequence parallelism against the replicated layout, MP_SP_CASE
    arch, layers, B, S = MP_SP_CASE
    shard = [[B, S // 2, _mp_cfg(arch, layers).d_model]]
    sp = [rec["sp_case"] for rec in recs]
    record["sp_case"] = sp
    for r, c in enumerate(sp):
        gap = abs(c["sp"]["loss"] - c["none"]["loss"])
        lower = c["sp"]["peak_gib"] < c["none"]["peak_gib"]
        print(f"model_parallel: {arch} at full width, {layers} layers, "
              f"batch {B} x {S}, a train step's forward and backward on "
              f"(1, 2) rank {r} (peak allocated over them, the parameters "
              f"included): "
              f"{_mp_layout(c['sp']['residual'], S)}, loss "
              f"{c['sp']['loss']:.6f}, peak {c['sp']['peak_gib']:.3f} GiB, "
              f"step {c['sp']['s']:.2f} s; seq_shard None: "
              f"{_mp_layout(c['none']['residual'], S)}, loss "
              f"{c['none']['loss']:.6f}, peak {c['none']['peak_gib']:.3f} "
              f"GiB, step {c['none']['s']:.2f} s; losses {gap:.3g} apart "
              f"(bound {MP_SP_TOL:g}); the case took {c['s']:.1f} s; {smi}")
        if gap > MP_SP_TOL or not lower or c["sp"]["residual"] != shard:
            failures.append(f"model_parallel sequence parallelism rank {r}: "
                            f"losses {gap:.3g} apart, peaks "
                            f"{c['sp']['peak_gib']:.3f} (sp) and "
                            f"{c['none']['peak_gib']:.3f} GiB, residual "
                            f"{c['sp']['residual']}")
    # flash_decode at the ranks' head shards (random inputs)
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    for label, B, S, Hkv, G, D, valid in MP_FD_CASES:
        q = torch.randn(B, Hkv, G, D, generator=gen, device=dev)
        k, v = (torch.randn(B, S, Hkv, D, generator=gen, device=dev)
                for _ in range(2))
        hold_flash_decode(label, [((q, k, v, torch.full(
            (1,), valid, dtype=torch.int32, device=dev)), {})], cases,
            summary, failures, modules, served=False)
        del q, k, v
    g = [rec["gcn"] for rec in recs]
    same = all(x == g[0] for x in g) and \
        g[0]["(1, 2)"] == g[0]["(2, 1)"]
    print(f"model_parallel: agcn-2s (reduced) under dp_only, losses on "
          f"(1, 2) {g[0]['(1, 2)']} and on (2, 1) {g[0]['(2, 1)']}: "
          f"{'equal' if same else 'NOT equal'}")
    if not same:
        failures.append(f"model_parallel: agcn-2s on (1, 2) against (2, 1): "
                        f"{g}")
    got = [torch.load(base / f"kv_logits_rank{r}.pt")
           for r in range(spec["ranks"])]
    gap = float((want - wide).abs().max())
    bound = fd.bf16_bound(gap, fd.BF16_CAP_SERVED)
    err = max(float((x - want).abs().max()) for x in got)
    kv = recs[0]["kv_seq"]
    record["kv_seq"] = {"err": err, "bound": bound, "bf16_gap": gap}
    print(f"model_parallel: {MP_KV_ARCH} at full width and depth, batch 1, "
          f"a bf16 cache of {spec['slots']} slots on (2, 1) under "
          f"{kv['rules']} ({kv['slots_a_rank']} slots a rank), {MP_KV_STEPS} "
          f"cuda steps from position {spec['pos']}: logits {err:.3g} from the "
          f"unsharded decode of the same cache (bound {bound:.3g}: "
          f"bf16_bound of the {gap:.3g} the float32-widened cache opens); "
          f"ranks equal: {all(torch.equal(x, got[0]) for x in got)}")
    if err > bound or not all(torch.isfinite(x).all() for x in got):
        failures.append(f"model_parallel kv_seq: logits {err:.3g} from the "
                        f"unsharded decode (bound {bound:.3g})")
    per = {"flash_decode_partial": cfg.num_layers,
           "flash_decode_row_max": cfg.num_layers}
    for r, rec in enumerate(recs):
        check_launches(f"mp kv_seq rank {r}",
                       rec["kv_seq"]["decode_counts"], per, MP_KV_STEPS)
    # the two new forms at the path's shard: rank 1's layer-0 slots, the
    # rows' maxima over both halves (what the path passes)
    n = spec["slots"] // 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    q = torch.randn((1, cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads,
                     cfg.head_dim), generator=gen, device=dev)
    whole = {}
    for j, name in enumerate(("k", "v")):
        g_ = torch.Generator(device=dev).manual_seed(SEED * 100_000 + j)
        whole[name] = torch.randn((1, spec["slots"], cfg.num_kv_heads,
                                   cfg.head_dim), generator=g_,
                                  device=dev).to(torch.bfloat16)
    valid = torch.tensor([spec["pos"] + MP_KV_STEPS], dtype=torch.int32,
                         device=dev)
    halves = [{k: t[:, r * n:(r + 1) * n].contiguous()
               for k, t in whole.items()} for r in range(2)]
    del whole
    row_max = torch.maximum(*(fd.flash_decode_row_max(
        q, h["k"], valid, offset=r * n) for r, h in enumerate(halves)))
    k1, v1 = halves[1]["k"], halves[1]["v"]
    cs = {"flash_decode_partial": [
        ("mp kv_seq shard", _mp_kernel_case(
            "flash_decode_partial", q, k1, v1, valid, n, row_max, False)),
        ("mp kv_seq shard float32", _mp_kernel_case(
            "flash_decode_partial", q, k1.float(), v1.float(), valid, n,
            None, False))],
        "flash_decode_row_max": [("mp kv_seq shard", _mp_kernel_case(
            "flash_decode_row_max", q, k1, None, valid, n, None, False))]}
    for name, named in cs.items():
        for label, c in named:
            summary[(label, name)] = summarize([c])
            cases.setdefault(name, {})[label] = c
            lib = ("none" if c["library_ms"] is None
                   else f"{c['library_ms']:.4f} ms")
            print(f"kernel {name} [{label}]: shape {c['shape']} ({c['cache']}"
                  f", offset {c['offset']}, valid {c['valid']}, {c['rows']} "
                  f"live rows) max_abs_err {c['max_abs_err']:.3g} (bound "
                  f"{c['tol']:.3g}), {c['ms'] * 1e3:.2f} us a launch, plain "
                  f"{c['plain_ms']:.4f} ms, masked SDPA {lib}, bound "
                  f"{c['bound_ms'] * 1e3:.2f} us (bytes; kernel at "
                  f"{c['bound_ms'] / c['ms'] * 100:.1f}%); {smi}")
            if not c["ok"]:
                failures.append(f"{name} [{label}]: {c['max_abs_err']:.3g} "
                                f"from its plain version (bound "
                                f"{c['tol']:.3g})")
    if torch.cuda.device_count() >= 2:
        spec2 = dict(spec, backend="nccl")
        base2 = base / "nccl"
        base2.mkdir()
        codes = _mp_spawn(spec2, base2, timeout=MP_TIMEOUT)()
        print(f"model_parallel: 2 cards on NCCL: exit codes {codes}")
        if any(codes):
            failures.append(f"model_parallel: the 2-card NCCL ranks exited "
                            f"{codes}")
    else:
        print(f"model_parallel: a 2-card NCCL run was not run "
              f"({torch.cuda.device_count()} card visible)")
    print(f"model_parallel: phase took {time.perf_counter() - t_phase:.1f} s")


def golden_mismatch(out, want) -> list:
    """The counters of a replay row that differ from a golden cell (the
    ones the golden tests check), as 'name got/want' strings."""
    from repro_torch.serving import outcome_digest
    pairs = [("outcome_digest", outcome_digest(out["outcomes"]),
              want["outcome_digest"]),
             ("migrations", out["resize_events"], want["migrations"])]
    pairs += [(k, out[k], want[k]) for k in (
        "ticks", "sessions", "preemptions", "restores", "deadline_missed",
        "capacity_final", "sessions_rejected", "sessions_degraded",
        "shed_windows", "frames_scored", "frames_skipped") if k in want]
    for p, d in want["per_priority"].items():
        got = out["latency_ms_by_priority"].get(p, {})
        pairs += [(f"priority {p} {k}", got.get(k), v) for k, v in d.items()]
    return [f"{k} {g}/{w}" for k, g, w in pairs if g != w]


def sessions_phase(dev, failures, check_launches, per_clip, per_tick):
    """Phase 10: ``GcnService`` through the public API — the golden trace
    replays on ``cuda`` at the reduced config, a generated trace at full
    width on ``cuda`` against ``reference``, and a two-skeleton service on
    both backends."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import init_params
    from repro_torch.core.pruning.plan import build_prune_plan
    from repro_torch.serving import (GcnService, SloConfig, Trace,
                                     TrafficConfig, generate_trace,
                                     outcome_digest, replay)

    t_phase = time.perf_counter()
    traces = ROOT / "tests" / "data" / "traces"
    golden = json.loads((traces / "golden_smoke.json").read_text())
    sal = json.loads((traces / "golden_saliency.json").read_text())
    smoke = Trace.load(str(traces / "smoke.json"))
    if smoke.digest() != golden["trace_digest"]:
        failures.append("sessions: smoke.json does not have the golden "
                        "trace digest")

    # ---- (a) the golden replays on cuda, with the port's own weights ------
    rcfg = get_config(ARCH, reduced=True)
    rp = init_params(rcfg, seed=SEED, device=dev)
    pp = build_prune_plan([b["Wk"].cpu().numpy() for b in rp["blocks"]],
                          rcfg.gcn_channels, [1.0, 0.5, 0.5, 0.5],
                          "cav-70-1", input_skip=2)
    rplan = engine.build_execution_plan(rp, rcfg, pp, quant=True,
                                        backend="cuda")
    xr = torch.randn((2, rcfg.gcn_frames, rcfg.gcn_joints,
                      rcfg.gcn_in_channels),
                     generator=torch.Generator().manual_seed(SEED + 1))
    rbn = engine.collect_bn_stats(rplan, xr.to(dev))
    nb = len(rcfg.gcn_channels)          # one stream: no ensemble
    per_tick_r = dict.fromkeys(per_tick, 0)
    per_tick_r.update(graph_sconv=nb, cavity_tconv_step=nb,
                      rfc_encode=nb - 1, rfc_decode=nb - 1)
    cells = [(golden, "fifo/demand"), (golden, "fifo/slo"),
             (golden, "fifo/slo-degrade"), (sal, "fifo/demand"),
             (sal, "preempt/demand"), (golden, "preempt/demand"),
             (golden, "preempt/slo"), (golden, "deadline/demand"),
             (golden, "deadline/slo")]
    t0 = time.perf_counter()
    total, steps = collections.Counter(), 0
    done = []
    for i, (src, cell) in enumerate(cells):
        if i >= 5 and time.perf_counter() - t0 > SESSIONS_GOLDEN_S:
            break                        # the optional cells past the budget
        qos, policy = cell.split("/")
        pol = "slo" if policy.startswith("slo") else "demand"
        slo = (SloConfig(**{**golden["slo"], "shed_mode": "degrade"
                            if policy == "slo-degrade" else "reject"})
               if pol == "slo" else None)
        gated = src is sal
        out, counts = counted(lambda: replay(
            rcfg, smoke, backend="cuda", qos=qos, policy=pol,
            capacity_tiers=tuple(src["tiers"]), slo_config=slo,
            plans=(rplan,), bn_stats=(rbn,), record_outcomes=True,
            saliency_thresh=src["saliency_thresh"] if gated else 0.0,
            device=dev))
        total.update(counts)
        # the warm-up steps the plain step and the fused tick once per tier
        want_n = out["device_dispatches"] + 2 * len(src["tiers"])
        steps += want_n
        bad = golden_mismatch(out, src["cells"][cell])
        label = f"{cell}{' saliency' if gated else ''}"
        for name, n in per_tick_r.items():
            if counts[name] != n * want_n:
                bad.append(f"{name} launches {counts[name]}/{n * want_n}")
        if bad:
            failures.append(f"sessions golden {label}: {bad}")
        done.append(label)
        print(f"sessions: golden {label} on cuda (reduced {ARCH}, port "
              f"weights): {'ok' if not bad else 'FAIL'}, digest "
              f"{outcome_digest(out['outcomes'])[:12]}, {out['ticks']} "
              f"ticks, {out['sessions']} sessions, preemptions "
              f"{out['preemptions']}, capacity {out['capacity_final']}, "
              f"{out['readbacks']} readbacks")
    check_launches("sessions golden", dict(total), per_tick_r, steps)
    print(f"sessions: {len(done)} golden cells of {len(cells)} in "
          f"{time.perf_counter() - t0:.1f} s; launches {dict(total)} in "
          f"{steps} steps (warm-up included)")

    # ---- (b) full width: a generated trace, cuda against reference --------
    cfg = get_config(ARCH)
    trace = generate_trace(TrafficConfig(
        n_sessions=SESSIONS_N, mean_frames=48, min_frames=16, max_frames=96,
        high_priority_ratio=0.3, seed=7), name="chip-sessions")
    rows = {}
    for backend in ("cuda", "reference"):
        t0 = time.perf_counter()
        out, counts = counted(lambda: replay(
            cfg, trace, backend=backend, qos="preempt", policy="demand",
            capacity_tiers=SESSIONS_TIERS, record_outcomes=True, seed=SEED,
            device=dev))
        wall = time.perf_counter() - t0
        rows[backend] = out
        # construction calibrates both streams (one clip pass each) and
        # warms the plain step and the fused tick once per tier
        warm = 2 * len(SESSIONS_TIERS)
        if backend == "cuda":
            per_tick_got = check_launches(
                "sessions", counts, per_tick, out["device_dispatches"] + warm,
                base=per_clip)
        t = out["ticks"]
        print(f"sessions: backend={backend} full {ARCH}, {SESSIONS_N} "
              f"sessions (trace {trace.digest()}), preempt, tiers "
              f"{SESSIONS_TIERS}: {out['sessions'] / out['wall_s']:.3f} "
              f"sessions/s, {out['frames_per_s']:.2f} frames/s, {t} ticks, "
              f"tick p50 {out['tick_ms_p50']:.3f} ms mean "
              f"{out['tick_ms_mean']:.3f} ms (host clock inside tick, no "
              f"synchronise), {out['wall_s'] / t * 1e3:.3f} ms a tick over "
              f"the run (host {out['wall_host_s'] / t * 1e3:.3f}, of it "
              f"issuing the upload and steps "
              f"{out['wall_dispatch_s'] / t * 1e3:.3f} and the scheduler "
              f"{(out['wall_host_s'] - out['wall_dispatch_s']) / t * 1e3:.3f}"
              f"; forced readback waits "
              f"{out['wall_device_s'] / t * 1e3:.3f}); "
              f"{out['device_dispatches']} device_dispatches, "
              f"{out['readbacks']} forced readbacks, preemptions "
              f"{out['preemptions']}, migrations {out['resize_events']}, "
              f"occupancy {out['occupancy'] * 100:.1f}%; {wall:.1f} s with "
              f"construction")
    print(f"sessions: launches per tick by name (cuda) "
          f"{ {k: v for k, v in per_tick_got.items() if v} }")
    c, r = rows["cuda"], rows["reference"]
    dc, dr = outcome_digest(c["outcomes"]), outcome_digest(r["outcomes"])
    lc = {x.sid: x.logits for x in c["records"]}
    lr = {x.sid: x.logits for x in r["records"]}
    diff = max((float(np.abs(lc[k] - lr[k]).max()) for k in lc if k in lr),
               default=float("inf"))
    top1 = float(np.mean([lc[k].argmax() == lr[k].argmax() for k in lc
                          if k in lr])) if lc else 0.0
    bad = []
    if dc != dr:
        bad.append(f"outcome digests differ ({dc[:12]} vs {dr[:12]})")
    if sorted(lc) != sorted(lr) or len(lc) != SESSIONS_N:
        bad.append(f"finished {sorted(lc)} vs {sorted(lr)}")
    if not all(np.isfinite(v).all() and np.allclose(v, lr[k], atol=1e-3,
                                                    rtol=1e-3)
               for k, v in lc.items() if k in lr) or top1 != 1.0:
        bad.append(f"logits differ by {diff:.3g}, top-1 {top1}")
    if not c["preemptions"] or not c["resize_events"]:
        bad.append("the trace made no preemption or no migration")
    if bad:
        failures.append(f"sessions full width: {bad}")
    print(f"sessions: full width cuda vs reference: digests "
          f"{'equal' if dc == dr else 'DIFFER'} ({dc[:12]}), {len(lc)} "
          f"finished sessions, max |logit difference| {diff:.3g}, top-1 "
          f"agreement {top1 * 100:.1f}%")
    full_width = (trace, c)

    # ---- (c) two skeletons in one service, cuda against reference ---------
    rng = np.random.default_rng(SEED + 2)
    script = [(topo, rng.standard_normal((MIXED_SVC_FRAMES, v, 3)).astype(
        np.float32)) for topo, v in (("ntu25", 25), ("ntu50", 50),
                                     ("ntu50", 50), ("ntu25", 25))]
    got = {}
    for backend in ("cuda", "reference"):
        t0 = time.perf_counter()

        def drive():
            svc = GcnService(cfg, backend=backend,
                             topologies=("ntu25", "ntu50"),
                             capacity_tiers=(len(script),), seed=SEED,
                             device=dev)
            hs = [svc.open_session(topology=t) for t, _ in script]
            fed = [0] * len(hs)
            t = 0
            while min(fed) < MIXED_SVC_FRAMES:
                # frames arrive 0, 1 or 2 at a time: a session whose buffer
                # runs dry is held
                for k, (h, (_, clip)) in enumerate(zip(hs, script)):
                    for _ in range((1, 0, 2, 1)[(t + k) % 4]):
                        if fed[k] < MIXED_SVC_FRAMES:
                            svc.submit(h, clip[fed[k]])
                            fed[k] += 1
                svc.tick()
                t += 1
            for h in hs:
                svc.close(h)
            svc.run_until_idle()
            return svc, [svc.poll(h) for h in hs]

        (svc, sts), counts = counted(drive)
        if backend == "cuda":
            # calibration: one clip pass per skeleton; warm-up: the primary
            # step, the other group's step and the fused tick
            check_launches("sessions mixed", counts, per_tick,
                           svc.device_dispatches + 3,
                           base={k: 2 * v for k, v in per_clip.items()})
        if any(s.state != "done" for s in sts):
            failures.append(f"sessions mixed {backend}: states "
                            f"{[s.state for s in sts]}")
        got[backend] = [s.logits for s in sts]
        m = svc.metrics(keep_records=0)
        print(f"sessions: mixed ntu25+ntu50 backend={backend}: "
              f"{len(sts)} sessions in {m['ticks']} ticks, "
              f"{m['device_dispatches']} dispatches, tick p50 "
              f"{m['tick_ms_p50']:.3f} ms, {time.perf_counter() - t0:.1f} s "
              f"with construction")
    d = max(float(np.abs(a - b).max())
            for a, b in zip(got["cuda"], got["reference"]))
    if not all(np.allclose(a, b, atol=1e-3, rtol=1e-3)
               for a, b in zip(got["cuda"], got["reference"])):
        failures.append(f"sessions mixed: cuda vs reference logits differ "
                        f"by {d:.3g}")
    print(f"sessions: mixed cuda vs reference, every session {d:.3g}")
    print(f"sessions: phase time {time.perf_counter() - t_phase:.1f} s")
    return full_width


def serve_trace(svc, trace):
    """``serving.replay``'s loop over a service built by the caller (replay
    builds its own, with no mesh); returns ``svc.metrics()``."""
    from collections import deque
    from repro_torch.serving import trace_requests
    reqs = deque(sorted(trace_requests(trace, svc.cfg.gcn_joints,
                                       svc.cfg.gcn_in_channels),
                        key=lambda r: (r.arrival, r.sid)))
    while reqs or not svc.idle():
        while reqs and reqs[0].arrival <= svc.now:
            r = reqs.popleft()
            svc.submit_clip(svc.open_session(
                priority=r.priority, deadline=r.deadline,
                arrival=r.arrival), r.clip)
        if svc.idle():
            svc.advance_clock(reqs[0].arrival)
        else:
            svc.tick()
    return svc.metrics()


def distributed_phase(dev, failures, check_launches, per_clip, per_tick,
                      full_width):
    """Phase 11: the distributed serving tier at full width on ``cuda`` —
    the sessions phase's trace through a 4-shard ``GcnService(mesh=...)``
    on this card against its unsharded run, a mesh over distinct cards
    when more than one is visible, and a 2-replica ``ReplicaRouter``."""
    import numpy as np
    import torch
    from repro_torch.common.device import canonical_device
    from repro_torch.common.tree import tree_leaves
    from repro_torch.configs import get_config
    from repro_torch.distributed import (ReplicaRouter, collective_cost_ms,
                                         make_batch_mesh, run_routed_sessions)
    from repro_torch.serving import GcnService, outcome_digest
    from repro_torch.serving.scheduler import (max_events_for,
                                               pad_event_orders)

    t_phase = time.perf_counter()
    cfg = get_config(ARCH)
    trace, base = full_width
    want_digest = outcome_digest(base["outcomes"])
    want = {r.sid: r.logits for r in base["records"]}

    def sharded(mesh, label):
        """The trace through a service split over ``mesh``, checked
        against the unsharded run; returns (service, row)."""
        t0 = time.perf_counter()
        svc = GcnService(cfg, backend="cuda", qos="preempt",
                         capacity_tiers=SESSIONS_TIERS, record_outcomes=True,
                         seed=SEED, mesh=mesh, device=mesh.devices[0])
        m = serve_trace(svc, trace)
        got = {r.sid: r.logits for r in m["records"]}
        d = max((float(np.abs(got[k] - want[k]).max()) for k in got
                 if k in want), default=float("inf"))
        bad = []
        if outcome_digest(svc.outcomes) != want_digest:
            bad.append("outcome log differs from the unsharded run's")
        if sorted(got) != sorted(want) or not all(
                np.isfinite(v).all() and np.allclose(v, want[k], atol=1e-3,
                                                     rtol=1e-3)
                for k, v in got.items()):
            bad.append(f"logits differ by {d:.3g}")
        if bad:
            failures.append(f"distributed {label}: {bad}")
        print(f"distributed: {label}: {m['sessions']} sessions, digest "
              f"{'equal' if not bad else 'DIFFERS'} "
              f"({outcome_digest(svc.outcomes)[:12]}), max |logit "
              f"difference| to the unsharded run {d:.3g}, "
              f"{time.perf_counter() - t0:.1f} s with construction")
        return svc, m

    # ---- (a) 4 logical shards on this card ---------------------------------
    n = MESH_SHARDS
    mesh = make_batch_mesh(n, device=canonical_device(dev))
    (svc, m), counts = counted(lambda: sharded(mesh, f"{n} shards on one "
                                                     f"card"))
    run = sum(m["tier_ticks"].values())
    warm = 2 * len(SESSIONS_TIERS)
    if m["device_dispatches"] != n * run:
        failures.append(f"distributed: {m['device_dispatches']} shard steps "
                        f"in {run} ticks, expected {n * run}")
    got_tick = check_launches("distributed", counts,
                              {k: n * v for k, v in per_tick.items()},
                              run + warm, base=per_clip)
    coll = collective_cost_ms(svc)
    t = m["ticks"]
    for label, r in (("unsharded", base), (f"{n} shards", m)):
        print(f"distributed: {label}: tick p50 {r['tick_ms_p50']:.3f} ms "
              f"mean {r['tick_ms_mean']:.3f} ms, "
              f"{r['sessions'] / r['wall_s']:.3f} sessions/s, "
              f"{r['frames_per_s']:.2f} frames/s, "
              f"{r['device_dispatches']} dispatches")
    print(f"distributed: {n} shards: collective_ms_per_tick {coll:.3f} "
          f"(CUDA events: {n} shard steps minus one whole-slab step; one "
          f"card, so the cost of splitting, no interconnect); "
          f"{m['wall_dispatch_s'] / t * 1e3:.3f} ms a tick issuing the "
          f"uploads and steps; launches per tick "
          f"{ {k: v for k, v in got_tick.items() if v} }")
    # one sharded fused tick, its inputs on the card: a snapshot on shard 1
    # and a restore on shard 2 of one ring row (every slot held, so the
    # restored row stays as it came), no host sync
    w = svc.capacity // n
    E = max_events_for(svc.capacity)
    V, C = svc.vmax, cfg.gcn_in_channels
    up = svc._upload_shards([[
        np.zeros((w, V, C), np.float32), np.zeros((w,), bool),
        np.zeros((w,), bool), np.ones((w,), bool),
        pad_event_orders([(0, 0)] if j == 1 else [], E),
        pad_event_orders([(0, 0)] if j == 2 else [], E)] for j in range(n)])
    ins = [(f, v, r, h, []) for f, v, r, h, _, _ in up]
    snap = [so if j == 1 else None for j, (*_, so, _) in enumerate(up)]
    rest = [ro if j == 2 else None for j, (*_, ro) in enumerate(up)]
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        slabs, _, _ = svc._fused_tick(svc.slabs, ins, snap, rest, svc._rings)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        src = tree_leaves(svc._engine.snapshot_slots(svc.slabs[1][0], 0))
        moved = all(torch.equal(a, b) for a, b in zip(tree_leaves(
            svc._engine.snapshot_slots(slabs[2][0], 0)), src))
        print(f"distributed: one sharded fused tick under "
              f"set_sync_debug_mode('error'): no host sync; shard 1's row "
              f"0 (live leaves: {sum(bool(x.any()) for x in src)} of "
              f"{len(src)}) moved to shard 2's row 0: {moved}")
        if not moved:
            failures.append("distributed: a snapshot on shard 1 and its "
                            "restore on shard 2 in one tick did not move "
                            "the row")
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode("default")
        failures.append(f"distributed: the sharded fused tick syncs with "
                        f"the host: {e}")

    # ---- (b) a mesh over distinct cards -----------------------------------
    cards = torch.cuda.device_count()
    if cards >= 2:
        sharded(make_batch_mesh(2), "2 cards")
    else:
        print(f"distributed: a mesh over distinct cards needs 2 visible, "
              f"{cards} visible: not run")

    # ---- (c) two replicas behind the router -------------------------------
    rng = np.random.default_rng(SEED + 3)
    clip_a, clip_b = rng.standard_normal(
        (2, ROUTER_FRAMES, cfg.gcn_joints, cfg.gcn_in_channels)).astype(
        np.float32)
    first = None

    def routed(migrate):
        nonlocal first
        kw = ({} if first is None else
              dict(plans=first.plans, bn_stats=first.bn_stats))
        router = ReplicaRouter.build(cfg, replicas=2, backend="cuda",
                                     capacity_tiers=(2,), seed=SEED,
                                     device=dev, **kw)
        first = first or router.services[0]
        ha = router.open_session(replica=0)
        router.submit_clip(ha, clip_a)
        hb = router.open_session(replica=0)
        router.submit_clip(hb, clip_b)
        for _ in range(ROUTER_MOVE_AT):
            router.tick()
        if migrate:
            router.migrate_session(ha, 1)
        router.run_until_idle()
        return (router, router.replica_of(ha), router.poll(ha).logits,
                router.poll(hb).logits)

    (router, moved_to, got_a, by), counts = counted(lambda: routed(True))
    check_launches("routed", counts, per_tick,
                   sum(sum(s.tier_ticks.values()) + 2
                       for s in router.services), base=per_clip)
    by0 = routed(False)[3]
    alone = GcnService(cfg, backend="cuda", plans=first.plans,
                       bn_stats=first.bn_stats, capacity_tiers=(1,),
                       device=dev)
    h = alone.open_session()
    alone.submit_clip(h, clip_a)
    alone.run_until_idle()
    want_a = alone.poll(h).logits
    da = float(np.abs(got_a - want_a).max())
    db = float(np.abs(by - by0).max())
    if (not np.allclose(got_a, want_a, atol=1e-3, rtol=1e-3) or db != 0.0
            or moved_to != 1):
        failures.append(f"distributed router: migrated session (now on "
                        f"replica {moved_to}) {da:.3g} from its run alone, "
                        f"bystander {db:.3g} from its run without the "
                        f"migration")
    print(f"distributed: router, 2 replicas, full {ARCH} on cuda: a session "
          f"moved from replica 0's slot to replica 1 at tick "
          f"{ROUTER_MOVE_AT} of its {ROUTER_FRAMES} frames ends "
          f"{da:.3g} from its run alone; the bystander's max |difference| "
          f"to its run without the move {db:.3g}; rebalances "
          f"{router.rebalances}")
    t0 = time.perf_counter()
    row = run_routed_sessions(cfg, replicas=2, slots=4, n_sessions=8,
                              lengths=(ROUTER_FRAMES, 2 * ROUTER_FRAMES),
                              qos="preempt", seed=SEED, rebalance_every=8,
                              device=dev)
    if row["sessions"] != 8:
        failures.append(f"distributed: run_routed_sessions finished "
                        f"{row['sessions']} of 8 sessions")
    print(f"distributed: run_routed_sessions, 2 replicas x 4 slots, 8 "
          f"sessions: {row['sessions'] / row['wall_s']:.3f} sessions/s, "
          f"{row['frames_per_s']:.2f} frames/s, {row['ticks']} ticks, "
          f"rebalances {row['rebalances']}, preemptions "
          f"{row['preemptions']}, {time.perf_counter() - t0:.1f} s")
    print(f"distributed: phase time {time.perf_counter() - t_phase:.1f} s")


def card_tests(failures) -> None:
    """The card_tests phase: the JAX-free kernel tests, every case marked
    ``cuda``, in a pytest process of their own; fails unless every selected
    case passes and none skips."""
    import os
    import re
    env = dict(os.environ, PYTHONPATH=str(SRC))
    cmd = [sys.executable, "-m", "pytest", "-q", "--noconftest", "-p",
           "no:cacheprovider", "-m", "cuda", CARD_TESTS]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    tail = out.stdout.strip().splitlines()[-1:] or [""]
    counts = {k: int(n) for n, k in re.findall(
        r"(\d+) (passed|failed|skipped|errors?|deselected)", tail[0])}
    print(f"card_tests: {counts.get('passed', 0)} passed")
    print(f"card_tests: {tail[0]} ({' '.join(cmd[1:])}, exit {out.returncode})")
    if out.returncode != 0 or counts.get("skipped") or not counts.get(
            "passed"):
        print(out.stdout[-6000:], out.stderr[-3000:], sep="\n")
        failures.append(f"card_tests: exit {out.returncode}, {tail[0]}")


def main() -> int:
    import os
    # segments that grow and shrink, so what a phase frees goes back to the
    # card (the dist_train phase's torchrun child needs it)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 2
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != SRC:
        fail(f"repro_torch imported from {repro_torch.__file__}, not {SRC}")
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core.agcn import engine
    from repro_torch.core.agcn.model import (bone_stream, bone_stream_parents,
                                             init_params)
    from repro_torch.core.pruning.plan import plan_from_config
    from repro_torch.data.pipeline import DataConfig, skeleton_batches
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import cavity_tconv as ct
    from repro_torch.kernels import graph_sconv as gs
    from repro_torch.kernels import rfc_pack as rp
    from repro_torch.kernels import window_sim as ws
    from repro_torch.launch.serve import serve_gcn, serve_gcn_stream
    from repro_torch.train.steps import (make_gcn_fused_tick,
                                         make_gcn_infer_step,
                                         make_gcn_slab_step,
                                         make_gcn_stream_step)
    modules = (gs, ct, rp, ws)

    # ---- 1. device ---------------------------------------------------------
    smi = smi_line()
    dev = torch.device(DEVICE)
    print(f"device: {smi}")
    print(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} "
          f"visible")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("device: TF32 off for matmul and cuDNN (full float32 comparisons)")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib, log = _build.build()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"build: {line.strip()}")

    phase_done("build")

    failures, cases, summary = [], {}, {}
    card_tests(failures)
    phase_done("card_tests")

    # ---- 3. kernels against their plain versions ---------------------------
    cfg = get_config(ARCH)
    nblocks = len(cfg.gcn_channels)
    gen = torch.Generator().manual_seed(SEED)
    params = [init_params(cfg, gen, device=dev) for _ in ("joint", "bone")]
    prune_plan = plan_from_config(cfg)

    def plans_for(params_, cfg_, backend="cuda", **kw):
        return tuple(engine.build_execution_plan(
            p, cfg_, prune_plan, quant=True, backend=backend, **kw)
            for p in params_)

    plans = plans_for(params, cfg)
    dcfg = DataConfig(global_batch=BATCH, seq_len=cfg.gcn_frames, seed=SEED)
    x0 = torch.from_numpy(next(skeleton_batches(cfg, dcfg))["x"]).to(dev)
    infer = make_gcn_infer_step(cfg)
    stream_step = make_gcn_stream_step(cfg)
    # launches per ensemble step of each path (10 blocks, 9 transfers, 2
    # streams); calibration runs one clip pass per stream
    per_clip = {"graph_sconv": 2 * nblocks, "cavity_tconv": 2 * nblocks,
                "cavity_tconv_step": 0, "rfc_encode": 2 * (nblocks - 1),
                "rfc_decode": 2 * (nblocks - 1), "graph_sconv_csr": 0,
                "windowed_similarity": 0}
    per_tick = dict(per_clip, cavity_tconv=0, cavity_tconv_step=2 * nblocks)
    # CSR plans run graph_sconv_csr where dense ones run graph_sconv; C_k
    # plans run the spatial product as an einsum (no graph_sconv) and, on a
    # stream tick, windowed_similarity
    per_csr_clip = dict(per_clip, graph_sconv=0, graph_sconv_csr=2 * nblocks)
    per_csr_tick = dict(per_tick, graph_sconv=0, graph_sconv_csr=2 * nblocks)
    per_ck_clip = dict(per_clip, graph_sconv=0)
    per_ck_tick = dict(per_tick, graph_sconv=0,
                       windowed_similarity=2 * nblocks)

    def hold_cases(path, captured, expect, measure=None):
        """Check the calls per kernel of one step against ``expect`` and
        hold the kernels named in ``measure`` (default: all it calls)
        against their plain versions on the captured inputs."""
        for name, n in expect.items():
            if len(captured[name]) != n:
                failures.append(f"{path} {name}: one step made "
                                f"{len(captured[name])} calls, expected {n}")
            if not n or (measure is not None and name not in measure):
                continue
            if name == "cavity_tconv_step":
                # a window whose kept-tap frames are all zero cannot tell a
                # right kernel from a wrongly indexed one
                empty = [i for i, (a, _) in enumerate(captured[name])
                         if any(not _chrono(a[0], a[1])[:, k].any()
                                for k in set(a[3].flatten().tolist()))]
                if empty:
                    failures.append(f"{path} {name}: calls {empty} read a "
                                    f"kept-tap frame that is all zero")
            if name == "windowed_similarity":
                # all-zero rings give uniform rows whatever the kernel does
                empty = [i for i, (a, _) in enumerate(captured[name])
                         if not all(r[s].any() for r in a[:2]
                                    for s in range(r.shape[0]))]
                if empty:
                    failures.append(f"{path} {name}: calls {empty} hold a "
                                    f"slot whose rings are all zero")
            hold(path, name, captured[name])
            if name == "windowed_similarity":
                # the bare form on the same calls' new rings
                hold(f"{path} bare", name, [
                    ((*ws.windowed_similarity_step_plain(*a)[:2], a[-1]), {})
                    for a, _ in captured[name]])
        return captured

    def hold(path, name, calls):
        """Hold one kernel against its plain version on ``calls`` (a list
        of (args, kwargs)), time both and record the per-step sums."""
        t_hold = time.perf_counter()
        cs = [measure_case(name, a, k, modules) for a, k in calls]
        t_hold = time.perf_counter() - t_hold
        cases[f"{path}/{name}"] = cs
        bad = [i for i, c in enumerate(cs) if not c["ok"]]
        if bad:
            failures.append(f"{path} {name}: kernel disagrees with its "
                            f"plain version on cases {bad}")
        s = summary[(path, name)] = summarize(cs)
        tc = (f", float32 bound {s['bound_f32_ms']:.4f}, 3-pass floor "
              f"{s['split_floor_ms']:.4f}" if "split_floor_ms" in s else "")
        if "ms_l2" in s:
            where = ("rotating copies past the L2" if s["cold"]
                     else "copies that fit the L2")
            tc += f"; timed on {where}, {s['ms_l2']:.4f} on one set of inputs"
        if "composite_ms" in s:
            tc += (f"; {s['form']} form, composite of 4 PyTorch calls "
                   f"{s['composite_ms']:.4f}")
        print(f"kernel {name} [{path}]: {'ok' if not bad else 'FAIL'} on "
              f"{len(cs)} inputs (held and timed in {t_hold:.1f} s), "
              f"max_abs_err {s['max_abs_err']:.3g}; per "
              f"ensemble step {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
              f"library {s['library_ms']}, bound {s['bound_ms']:.4f} ms by "
              f"{s['bound_by']}{tc})")

    clip_calls = hold_cases("clip", capture(modules, lambda: infer(plans, x0)),
                            per_clip)
    # stream ticks at S slots, STREAM_WARM raw frames into the clip (past
    # the first-logit delay and the last block's first full window, so
    # every kept tap reads data), on the frozen statistics of this batch;
    # the later streams' ticks are held on their own runs' states
    delay = engine.stream_first_logit_delay(plans[0])
    if STREAM_WARM < delay:
        fail(f"{STREAM_WARM} warm-up frames do not reach the last block "
             f"(first-logit delay {delay})")
    bn = [engine.collect_bn_stats(p, xx)
          for p, xx in zip(plans, (x0, bone_stream(x0)))]
    # one state warmed at the largest S; the smaller ticks take its first
    # S slots (slots are independent)
    S8 = STREAM_SLOTS[-1]
    warm8 = tuple(engine.init_stream_state(p, S8, bn_stats=b)
                  for p, b in zip(plans, bn))
    for r in range(STREAM_WARM):
        warm8, _ = stream_step(plans, warm8, x0[:S8, r])
    for S in STREAM_SLOTS:
        states = tuple(first_slots(s_, S) for s_ in warm8)
        tick_calls = hold_cases(f"stream S={S}", capture(
            modules, lambda: stream_step(plans, states, x0[:S, STREAM_WARM])),
            per_tick)
    # the RFC entry points the paths above do not take: encode without res
    # (on the clip step's t) and the step form with a mixed keep (the S = 8
    # tick's inputs, every other slot keeping its old leaves, which the
    # lockstep tick never does)
    hold("clip no res", "rfc_encode", [
        ((a[0], None, None, None, None), {})
        for a, _ in clip_calls["rfc_encode"]])
    mixed = torch.arange(S8, device=dev) % 2 == 0
    hold(f"stream S={S8} mixed keep", "rfc_encode", [
        ((a[0], a[1], a[2], mixed, a[4]), {})
        for a, _ in tick_calls["rfc_encode"]])

    # ntu50: the two-person NTU scene as one 50-joint skeleton (persons
    # not folded into the batch), same weights as ntu25 but B_k's width
    cfg50 = dataclasses.replace(cfg, gcn_joints=VMAX, gcn_persons=1)
    gen50 = torch.Generator().manual_seed(SEED)
    params50 = [init_params(cfg50, gen50, device=dev) for _ in range(2)]
    csr50 = plans_for(params50, cfg50, topology="ntu50", sconv="csr",
                      csr_eps=CSR_EPS)
    csr50_dv = plans_for(params50, cfg50, topology="ntu50", sconv="csr",
                         csr_eps=0.0)
    dense50 = plans_for(params50, cfg50, topology="ntu50", sconv="dense")
    clips50 = skeleton_batches(cfg50, DataConfig(
        global_batch=BATCH, seq_len=cfg.gcn_frames, seed=SEED))
    x50 = torch.from_numpy(next(clips50)["x"]).to(dev)

    def bone50(x):
        return bone_stream_parents(x, csr50[1].arrays["parents"])

    hold_cases("ntu50 csr clip", capture(modules, lambda: infer(csr50, x50)),
               per_csr_clip, {"graph_sconv_csr"})
    hold_cases("ntu50 dense clip", capture(
        modules, lambda: infer(dense50, x50)), per_clip, {"graph_sconv"})
    bn50 = [engine.collect_bn_stats(p, xx)
            for p, xx in zip(csr50, (x50, bone50(x50)))]

    # hand21 and body_hand46 on dense plans (sconv="auto" keeps their
    # graphs dense at csr_eps = 0): graph_sconv's 6 rows x 21 and 2 rows x
    # 46 joints a 128-pair tile, on one clip step and one S = 8 tick
    # STREAM_WARM frames in
    for topo, vt in DENSE_SKELETONS:
        cfg_t = dataclasses.replace(cfg, gcn_joints=vt, gcn_persons=1)
        gen_t = torch.Generator().manual_seed(SEED)
        params_t = [init_params(cfg_t, gen_t, device=dev) for _ in range(2)]
        plans_t = plans_for(params_t, cfg_t, topology=topo, sconv="dense")
        xt = torch.from_numpy(next(skeleton_batches(cfg_t, DataConfig(
            global_batch=BATCH, seq_len=cfg.gcn_frames, seed=SEED)))["x"]
            ).to(dev)
        hold_cases(f"{topo} dense clip", capture(
            modules, lambda: infer(plans_t, xt)), per_clip, {"graph_sconv"})
        bone_t = bone_stream_parents(xt, plans_t[1].arrays["parents"])
        st = tuple(engine.init_stream_state(p, S8, bn_stats=engine.
                                            collect_bn_stats(p, xx))
                   for p, xx in zip(plans_t, (xt, bone_t)))
        for r in range(STREAM_WARM):
            st, _ = stream_step(plans_t, st, xt[:S8, r])
        hold_cases(f"{topo} dense stream S={S8}", capture(
            modules, lambda: stream_step(plans_t, st, xt[:S8, STREAM_WARM])),
            per_tick, {"graph_sconv"})
        del params_t, plans_t, st

    # RFC off the main path: a width that is not a whole number of banks
    xr = torch.randn(2400 * 25, 38, generator=gen).to(dev)
    vals, bits = ops.rfc_encode(xr)
    pv, pb = rp.rfc_encode_plain(torch.nn.functional.pad(xr, (0, 10)))
    rt = ops.rfc_decode(vals, bits)
    torch.cuda.synchronize()
    rfc_pad_ok = (torch.equal(vals, pv[:, :38]) and torch.equal(bits, pb)
                  and torch.equal(rt, torch.relu(xr)))
    print(f"kernel rfc C=38 (padded to 48): {'ok' if rfc_pad_ok else 'FAIL'}")
    if not rfc_pad_ok:
        failures.append("rfc: C % 16 != 0 case is not bit-equal")

    phase_done("kernels")
    launches, per_step = {}, {}

    def check_launches(path, counts, expect, steps, base=None):
        """Check ``counts`` against ``expect`` per step over ``steps``
        steps plus ``base`` launches outside them (a service's
        calibration); returns the launches per step."""
        base = base or {}
        launches[path] = counts
        per_step[path] = {k: (v - base.get(k, 0)) / steps
                          for k, v in counts.items()}
        for name in counts:          # kernels missing from expect: none
            n = expect.get(name, 0) * steps + base.get(name, 0)
            if counts[name] != n:
                failures.append(f"{path} {name}: {counts[name]} launches in "
                                f"{steps} steps, expected {n}")
        return per_step[path]

    # ---- 4. the main path: clip serving ------------------------------------
    res, counts = counted(lambda: serve_gcn(
        ARCH, reduced=False, batch=BATCH, clips=CLIPS, seed=SEED,
        backends=("cuda", "reference"), device=dev))
    steps = res["cuda"]["steps"]
    check_launches("clip", counts, per_clip, steps)
    lc, lr = res["cuda"]["logits"], res["reference"]["logits"]
    rows = CLIPS * cfg.gcn_persons             # persons fold into the batch
    if lc.shape != (rows, cfg.gcn_num_classes) or not np.isfinite(lc).all():
        failures.append(f"cuda logits: shape {lc.shape} or not finite")
    diff = float(np.abs(lc - lr).max())
    if not np.allclose(lc, lr, atol=1e-3, rtol=1e-3):
        failures.append(f"cuda vs reference logits differ by {diff:.3g}")
    agree = float(np.mean(res["cuda"]["top1"] == res["reference"]["top1"]))
    for name in ("cuda", "reference"):
        print(f"main: backend={name} {res[name]['clips_per_s']:.2f} clips/s "
              f"counted as skeleton sequences, as serve does ({CLIPS} clips x "
              f"{cfg.gcn_persons} persons, batch {BATCH}, full {ARCH}, "
              f"2-stream)")
    print(f"main: max |logit difference| {diff:.3g}, top-1 agreement "
          f"{agree * 100:.1f}%, launches {launches['clip']} in {steps} steps")

    phase_done("main")

    # ---- 5. streaming --------------------------------------------------------
    sres, counts = counted(lambda: serve_gcn_stream(
        ARCH, reduced=False, batch=STREAM_CLIPS, seed=SEED,
        backends=("cuda", "reference"), device=dev))
    sc, sr = sres["cuda"], sres["reference"]
    launches["stream phase"] = counts
    nseq = STREAM_CLIPS * cfg.gcn_persons
    if sc["flush"] != 149 or sc["steps"] != cfg.gcn_frames + 149 + 2:
        failures.append(f"stream: {sc['steps']} steps with {sc['flush']} "
                        f"flush frames, expected 451 with 149")
    parts = sc["launches"]
    for name in per_clip:
        want = {"calibration": per_clip[name], "clip": per_clip[name],
                "stream": per_tick[name] * sc["steps"]}
        for phase, n in want.items():
            if parts[phase][name] != n:
                failures.append(f"stream {phase} {name}: "
                                f"{parts[phase][name]} launches, expected {n}")
        if counts[name] != sum(want.values()):
            failures.append(f"stream {name}: {counts[name]} launches in the "
                            f"phase, expected {sum(want.values())}")
    per_step["stream"] = {k: v / sc["steps"] for k, v in
                          parts["stream"].items()}
    for name, r in sres.items():
        if (r["logits"].shape != (nseq, cfg.gcn_num_classes)
                or not np.isfinite(r["logits"]).all()):
            failures.append(f"stream {name}: logits {r['logits'].shape} or "
                            f"not finite")
        d = float(np.abs(r["logits"] - r["clip_logits"]).max())
        if (not np.allclose(r["logits"], r["clip_logits"], atol=1e-3,
                            rtol=1e-3) or r["clip_agreement"] != 1.0):
            failures.append(f"stream {name}: post-drain logits differ from "
                            f"clip logits by {d:.3g}, top-1 agreement "
                            f"{r['clip_agreement']}")
        print(f"stream: backend={name} {r['frames_per_s']:.2f} frames/s "
              f"({nseq} sequences x {sc['steps'] - 2} steps), latency per "
              f"step p50 {r['latency_ms_p50']:.3f} ms mean "
              f"{r['latency_ms_mean']:.3f} ms; post-drain vs clip logits "
              f"{d:.3g}, top-1 agreement {r['clip_agreement'] * 100:.1f}%")
    d = float(np.abs(sc["logits"] - sr["logits"]).max())
    if not np.allclose(sc["logits"], sr["logits"], atol=1e-3, rtol=1e-3):
        failures.append(f"stream: cuda vs reference last-step logits differ "
                        f"by {d:.3g}")
    print(f"stream: cuda vs reference last step {d:.3g}; drain "
          f"{sc['flush']} frames, first-logit delay "
          f"{engine.stream_first_logit_delay(plans[0])} raw frames; "
          f"launches {parts}")

    phase_done("stream")

    # ---- 6. the session slab: the fused serving tick -------------------------
    tick = make_gcn_fused_tick(cfg)
    rng = np.random.default_rng(SEED)
    clips = (x0[0, :SESSION_FRAMES].cpu().numpy()[None] + rng.standard_normal(
        (SESSIONS, SESSION_FRAMES, 25, 3)).astype(np.float32) * 0.05)
    slabs = tuple(engine.init_session_slab(p, SLAB_SLOTS, bn_stats=b)
                  for p, b in zip(plans, bn))
    rings = tuple(engine.init_snapshot_ring(s, RING_ROWS) for s in slabs)
    flush = engine.stream_flush_frames(plans[0], SESSION_FRAMES)
    (got, lat, events, slabs, rings), counts = counted(
        lambda: run_slab_script(tick, plans, slabs, rings, clips, flush, dev))
    ticks = events["ticks"]
    check_launches("slab", counts, per_tick, ticks)
    if (events["snapshot"], events["restore"], events["hold"],
            events["admit"]) != (2, 2, 4, SESSIONS):
        failures.append(f"slab: the script ran events {dict(events)}, "
                        f"expected 2 snapshots, 2 restores, 4 holds and "
                        f"{SESSIONS} admissions")
    # every session alone: one lockstep batch from tick 0 (slots are
    # independent), the same frames and drain
    alone = tuple(engine.init_stream_state(p, SESSIONS, bn_stats=b)
                  for p, b in zip(plans, bn))
    xc = torch.from_numpy(clips).to(dev)
    zeros = torch.zeros_like(xc[:, 0])
    for r in range(SESSION_FRAMES + flush):
        alone, want = stream_step(plans, alone, xc[:, r] if r < SESSION_FRAMES
                                  else zeros, r < SESSION_FRAMES)
    want = want.cpu().numpy()
    if sorted(got) != list(range(SESSIONS)):
        failures.append(f"slab: sessions {sorted(got)} finished, expected "
                        f"all {SESSIONS}")
    slab_diff = max((float(np.abs(got[i] - want[i]).max()) for i in got),
                    default=float("inf"))
    bad = [i for i in got if not np.allclose(got[i], want[i], atol=1e-3,
                                             rtol=1e-3)]
    if bad:
        failures.append(f"slab: sessions {bad} differ from their runs alone "
                        f"(max {slab_diff:.3g})")
    print(f"slab: {len(got)} sessions in {ticks} ticks at {SLAB_SLOTS} slots "
          f"(full {ARCH}, 2-stream, cuda): tick p50 "
          f"{statistics.median(lat):.3f} ms mean {statistics.mean(lat):.3f} "
          f"ms; events {dict(events)}; eviction logits vs each session "
          f"alone {slab_diff:.3g}; launches {launches['slab']}")
    # one tick with its inputs already on the card may not sync with the host
    S = SLAB_SLOTS
    sentinel = torch.full((EVENTS, 2), int(engine.SNAP_SENTINEL),
                          dtype=torch.int32, device=dev)
    snap_o = sentinel.clone()
    snap_o[0] = torch.tensor([0, 2], dtype=torch.int32)
    rest_o = sentinel.clone()
    rest_o[0] = torch.tensor([1, 2], dtype=torch.int32)
    inputs = (xc[:S, 0].contiguous(), torch.ones(S, dtype=torch.bool,
                                                 device=dev),
              torch.zeros(S, dtype=torch.bool, device=dev),
              torch.zeros(S, dtype=torch.bool, device=dev), snap_o, rest_o)
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        tick(plans, slabs, *inputs, rings)
        torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        print("slab: one fused tick under set_sync_debug_mode('error'): no "
              "host sync")
    except RuntimeError as e:
        torch.cuda.set_sync_debug_mode("default")
        failures.append(f"slab: the fused tick syncs with the host: {e}")

    phase_done("slab")

    # ---- 7. topology: ntu50 clips and a stream on CSR plans --------------------
    ref50 = plans_for(params50, cfg50, backend="reference", topology="ntu50",
                      sconv="dense")
    batches50 = [x50] + [torch.from_numpy(next(clips50)["x"]).to(dev)
                         for _ in range(TOPO_CLIPS // BATCH - 1)]
    (l_csr, rate_csr, steps50), counts = counted(
        lambda: clip_run(infer, csr50, batches50, dev))
    check_launches("topology", counts, per_csr_clip, steps50)
    (l_dense, rate_dense, _), counts = counted(
        lambda: clip_run(infer, dense50, batches50, dev))
    check_launches("topology dense", counts, per_clip, steps50)
    l_ref, rate_ref, _ = clip_run(infer, ref50, batches50, dev)
    if l_csr.shape != (TOPO_CLIPS, cfg.gcn_num_classes) or not np.isfinite(
            l_csr).all():
        failures.append(f"topology: logits {l_csr.shape} or not finite")
    for label, other in (("reference dense", l_ref), ("cuda dense", l_dense)):
        d = float(np.abs(l_csr - other).max())
        top1 = float(np.mean(l_csr.argmax(-1) == other.argmax(-1)))
        if not np.allclose(l_csr, other, atol=1e-3, rtol=1e-3) or top1 != 1.0:
            failures.append(f"topology: cuda csr vs {label} logits differ by "
                            f"{d:.3g}, top-1 agreement {top1}")
        print(f"topology: ntu50 cuda csr vs {label}: max |logit difference| "
              f"{d:.3g}, top-1 agreement {top1 * 100:.1f}%")
    print(f"topology: ntu50 clips (batch {BATCH}, {TOPO_CLIPS} sequences, "
          f"full {ARCH}, 2-stream): cuda csr {rate_csr:.2f}, cuda dense "
          f"{rate_dense:.2f}, reference dense {rate_ref:.2f} sequences/s")
    states = tuple(engine.init_stream_state(p, x50.shape[0], bn_stats=b)
                   for p, b in zip(csr50, bn50))
    flush50 = engine.stream_flush_frames(csr50[0], cfg.gcn_frames)
    (_, s_logits, s_lat, warm50), counts = counted(lambda: stream_run(
        stream_step, csr50, states, x50, flush50, dev))
    check_launches("topology stream", counts, per_csr_tick,
                   cfg.gcn_frames + flush50 + 2)
    # the kernels on one tick STREAM_WARM frames into that stream, on CSR
    # plans (and at csr_eps = 0, every ELL row full) and a dense plan
    f50 = x50[:, STREAM_WARM]
    degree = {}
    for path, plans_ in (("ntu50 csr stream S=8", csr50),
                         ("ntu50 csr eps=0 stream S=8", csr50_dv)):
        got = hold_cases(path, capture(modules, lambda: stream_step(
            plans_, warm50, f50)), per_csr_tick, {"graph_sconv_csr"})
        degree[path] = sorted({a[1].shape[-1]
                               for a, _ in got["graph_sconv_csr"]})
    if degree["ntu50 csr eps=0 stream S=8"] != [VMAX] or max(
            degree["ntu50 csr stream S=8"]) >= VMAX:
        failures.append(f"graph_sconv_csr: ELL widths D {degree}, expected "
                        f"D = {VMAX} at csr_eps = 0 and D < {VMAX} above")
    hold_cases("ntu50 dense stream S=8", capture(
        modules, lambda: stream_step(dense50, warm50, f50)), per_tick,
        {"graph_sconv"})
    print(f"kernel graph_sconv_csr: ELL widths D per block {degree}")
    clip_l = infer(csr50, x50).cpu().numpy()
    last = s_logits[-1].cpu().numpy()
    d = float(np.abs(last - clip_l).max())
    top1 = float(np.mean(last.argmax(-1) == clip_l.argmax(-1)))
    if not np.allclose(last, clip_l, atol=1e-3, rtol=1e-3) or top1 != 1.0:
        failures.append(f"topology stream: post-drain logits differ from clip "
                        f"logits by {d:.3g}, top-1 agreement {top1}")
    print(f"topology: ntu50 csr stream ({x50.shape[0]} sequences, "
          f"{cfg.gcn_frames} + {flush50} steps): step p50 "
          f"{statistics.median(s_lat):.3f} ms mean "
          f"{statistics.mean(s_lat):.3f} ms; post-drain vs clip {d:.3g}, "
          f"top-1 agreement {top1 * 100:.1f}%; launches "
          f"{launches['topology']} in {steps50} clip steps")

    phase_done("topology")

    # ---- 8. one slab, two skeletons ---------------------------------------------
    csr25 = plans_for(params, cfg, sconv="csr", csr_eps=CSR_EPS)
    csr25p = plans_for(params, cfg, sconv="csr", csr_eps=CSR_EPS,
                       pad_joints=VMAX)
    bn25 = [engine.collect_bn_stats(p, xx)
            for p, xx in zip(csr25, (x0, bone_stream(x0)))]
    rng = np.random.default_rng(SEED + 1)
    sessions = []
    for i in range(MIXED_SESSIONS):
        # the sessions past the first SLAB_SLOTS take the slots that free
        # first, which the other skeleton held
        first = (i % 2 == 0) != (i >= SLAB_SLOTS)
        topo, src = ("ntu25", x0) if first else ("ntu50", x50)
        clip = src[i % src.shape[0], :MIXED_FRAMES].cpu().numpy()
        sessions.append((topo, i * MIXED_EVERY, clip + rng.standard_normal(
            clip.shape).astype(np.float32) * 0.05))
    # stem statistics of the 25-joint group are padded to VMAX by the step
    groups = {"ntu25": (csr25p, tuple(bn25)), "ntu50": (csr50, tuple(bn50))}
    mslabs = tuple(engine.init_session_slab(p, SLAB_SLOTS, bn_stats=b)
                   for p, b in zip(csr25p, bn25))
    mflush = engine.stream_flush_frames(csr25[0], MIXED_FRAMES)
    (got, lat, dispatches, reused), counts = counted(lambda: run_mixed_script(
        make_gcn_slab_step(cfg), groups, mslabs, sessions, mflush, dev))
    check_launches("mixed", counts, per_csr_tick, dispatches)
    if sorted(got) != list(range(MIXED_SESSIONS)) or len(reused) < 2:
        failures.append(f"mixed: sessions {sorted(got)} finished, slot reuse "
                        f"across skeletons {dict(reused)}; expected all "
                        f"{MIXED_SESSIONS} and reuse by both skeletons")
    mixed_diff = 0.0
    for topo, narrow, stats in (("ntu25", csr25, bn25),
                                ("ntu50", csr50, bn50)):
        ids = [i for i, s_ in enumerate(sessions) if s_[0] == topo]
        xs = torch.from_numpy(np.stack([sessions[i][2] for i in ids])).to(dev)
        alone = tuple(engine.init_stream_state(p, len(ids), bn_stats=b)
                      for p, b in zip(narrow, stats))
        zeros = torch.zeros_like(xs[:, 0])
        for r in range(MIXED_FRAMES + mflush):
            alone, want = stream_step(narrow, alone, xs[:, r]
                                      if r < MIXED_FRAMES else zeros,
                                      r < MIXED_FRAMES)
        want = want.cpu().numpy()
        for j, i in enumerate(ids):
            if i not in got:
                continue
            mixed_diff = max(mixed_diff, float(np.abs(got[i] - want[j]).max()))
            if not np.allclose(got[i], want[j], atol=1e-4, rtol=1e-4):
                failures.append(f"mixed: session {i} ({topo}) differs from "
                                f"its run alone on a narrow plan")
    print(f"mixed: {len(got)} sessions (ntu25 padded to {VMAX}, ntu50) in "
          f"{len(lat)} ticks at {SLAB_SLOTS} slots, {dispatches} group "
          f"dispatches, slots reused across skeletons {dict(reused)}: tick "
          f"p50 {statistics.median(lat):.3f} ms mean "
          f"{statistics.mean(lat):.3f} ms; eviction logits vs each session "
          f"alone on a narrow plan {mixed_diff:.3g}; launches "
          f"{launches['mixed']}")

    phase_done("mixed")

    # ---- 9. adaptive streaming: the windowed C_k ----------------------------------
    # a use_ck plan, every column live, and the same plan padded to VMAX
    # joints (25 live)
    cfg_ck = dataclasses.replace(cfg, use_ck=True)
    gen_ck = torch.Generator().manual_seed(SEED)
    params_ck = [init_params(cfg_ck, gen_ck, device=dev) for _ in range(2)]
    ck_plans = plans_for(params_ck, cfg_ck)
    ck_pad = plans_for(params_ck, cfg_ck, pad_joints=VMAX)
    xs = x0[:S8]
    ck_ref = plans_for(params_ck, cfg_ck, backend="reference")
    flush_ck = engine.stream_flush_frames(ck_plans[0], cfg.gcn_frames)
    ck_steps = cfg.gcn_frames + flush_ck + 2
    ck = {}
    for backend, plans_ in (("cuda", ck_plans), ("reference", ck_ref)):
        states, counts = counted(lambda: tuple(
            engine.init_stream_state(p, S8, x_calib=xx)
            for p, xx in zip(plans_, (xs, bone_stream(xs)))))
        if backend == "cuda":
            check_launches("ck calibration", counts, per_ck_clip, 1)
        (_, logits, lat, warm), counts = counted(lambda: stream_run(
            stream_step, plans_, states, xs, flush_ck, dev))
        if backend == "cuda":
            check_launches("ck stream", counts, per_ck_tick, ck_steps)
            # the kernel on ticks STREAM_WARM frames into this stream, at
            # its first S slots
            warm_ck = warm
            for S in STREAM_SLOTS:
                st = tuple(first_slots(s_, S) for s_ in warm_ck)
                hold_cases(f"ck stream S={S}", capture(
                    modules, lambda: stream_step(
                        ck_plans, st, xs[:S, STREAM_WARM])), per_ck_tick,
                    {"windowed_similarity"})
        clip_l = infer(plans_, xs).cpu().numpy()
        last = logits[-1].cpu().numpy()
        d = float(np.abs(last - clip_l).max())
        top1 = float(np.mean(last.argmax(-1) == clip_l.argmax(-1)))
        if (last.shape != (S8, cfg.gcn_num_classes) or not np.isfinite(
                last).all() or not np.allclose(last, clip_l, atol=1e-3,
                                               rtol=1e-3) or top1 != 1.0):
            failures.append(f"ck {backend}: post-drain logits differ from "
                            f"clip-mode C_k logits by {d:.3g}, top-1 "
                            f"agreement {top1}")
        ck[backend] = (states, logits, last)
        print(f"ck: backend={backend} {S8 * len(lat) / sum(lat) * 1e3:.2f} "
              f"frames/s ({S8} sequences x {len(lat)} steps, full {ARCH} "
              f"with C_k, 2-stream), step p50 {statistics.median(lat):.3f} ms "
              f"mean {statistics.mean(lat):.3f} ms; post-drain vs clip "
              f"{d:.3g}, top-1 agreement {top1 * 100:.1f}%")
    d = float(np.abs(ck["cuda"][2] - ck["reference"][2]).max())
    top1 = float(np.mean(ck["cuda"][2].argmax(-1)
                         == ck["reference"][2].argmax(-1)))
    if not np.allclose(ck["cuda"][2], ck["reference"][2], atol=1e-3,
                       rtol=1e-3) or top1 != 1.0:
        failures.append(f"ck: cuda vs reference last-step logits differ by "
                        f"{d:.3g}, top-1 agreement {top1}")
    pad_states = tuple(engine.init_stream_state(p, S8, bn_stats=s_.bn_stats)
                       for p, s_ in zip(ck_pad, ck["cuda"][0]))
    xsp = F.pad(xs, (0, 0, 0, VMAX - xs.shape[2]))
    _, pad_logits, _, warm_pad = stream_run(stream_step, ck_pad, pad_states,
                                            xsp, flush_ck, dev)
    got = hold_cases(f"ck padded stream S={S8}", capture(
        modules, lambda: stream_step(ck_pad, warm_pad, xsp[:, STREAM_WARM])),
        per_ck_tick, {"windowed_similarity"})
    if {a[-1] for a, _ in got["windowed_similarity"]} != {x0.shape[2]}:
        failures.append("windowed_similarity: the padded plan's calls do "
                        "not mask the columns past its 25 joints")
    pad_diff = max(float((a - b).abs().max())
                   for a, b in zip(pad_logits, ck["cuda"][1]))
    if not all(torch.allclose(a, b, atol=1e-4, rtol=1e-4)
               for a, b in zip(pad_logits, ck["cuda"][1])):
        failures.append(f"ck: the plan padded to {VMAX} joints differs from "
                        f"the narrow one by {pad_diff:.3g}")
    print(f"ck: cuda vs reference last step {d:.3g}, top-1 agreement "
          f"{top1 * 100:.1f}%; padded to {VMAX} joints vs narrow, every step "
          f"{pad_diff:.3g}; launches per stream step "
          f"{per_step['ck stream']}")

    phase_done("ck")

    # ---- 10. sessions: GcnService ---------------------------------------------
    full_width = sessions_phase(dev, failures, check_launches, per_clip,
                                per_tick)
    phase_done("sessions")

    # ---- 11. distributed: the sharded slab and the replica router --------------
    distributed_phase(dev, failures, check_launches, per_clip, per_tick,
                      full_width)
    phase_done("distributed")

    # ---- 12. profile ----------------------------------------------------------
    profile_steps("clip", lambda: infer(plans, x0))
    profile_steps(f"stream S={S8}", lambda: stream_step(
        plans, warm8, x0[:S8, STREAM_WARM]))
    profile_steps(f"slab tick S={SLAB_SLOTS}",
                  lambda: tick(plans, slabs, *inputs, rings))
    profile_steps("clip ntu50 csr", lambda: infer(csr50, x50))
    profile_steps(f"ck stream S={S8}", lambda: stream_step(
        ck_plans, warm_ck, xs[:, STREAM_WARM]))

    phase_done("profile")

    # ---- 13. LM decode serving: smollm-360m at full width ---------------------
    lm_phase(dev, failures, cases, summary, check_launches, modules)
    phase_done("lm")

    # ---- 14. the offline path: training, checkpoints, accounting --------------
    train_phase(dev, failures, cases, check_launches)
    phase_done("train")

    # ---- 15. LM training and data parallelism ---------------------------------
    dist_train_phase(dev, failures, cases, check_launches)
    phase_done("dist_train")

    # ---- 16. the MoE and VLM decoder families at full width -------------------
    moe_vlm_phase(dev, failures, cases, summary, check_launches, modules)
    phase_done("moe_vlm")

    # ---- 17. the SSM, hybrid and audio families, gemma3 and internlm2 ------
    zoo_phase(dev, failures, cases, summary, check_launches, modules)
    phase_done("zoo")

    # ---- 18. the dry run: static cells and two measured on the card ----------
    dryrun_phase(dev, failures, check_launches)
    phase_done("dryrun")

    # ---- 19. the port's benches: Table IV measured, the smoke benches -------
    benches_phase(dev, failures)
    phase_done("benches")

    # ---- 20. the model axis and the kv_seq decode, 2 ranks on the card -------
    model_parallel_phase(dev, failures, cases, summary, check_launches,
                         modules)
    phase_done("model_parallel")

    print(f"clock: spin {spin_cycles_per_ms():.0f} cycles/ms; timings with "
          f"host time included (the plain versions that read taps on the "
          f"host, and any whose queueing outlasted three spins): "
          f"{sorted(HOST_GAPS) or 'none'}")
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_cases.json").write_text(json.dumps(
        {"device": smi, "cases": cases}, indent=1))

    if failures:
        for f in failures:
            print(f"chip_smoke: FAIL: {f}", file=sys.stderr)
        return 1
    main_case = {"cavity_tconv_step": f"stream S={S8}",
                 "graph_sconv_csr": "ntu50 csr clip",
                 "windowed_similarity": f"ck stream S={S8}",
                 "flash_decode": "lm last step",
                 "flash_decode_partial": "mp kv_seq shard",
                 "flash_decode_row_max": "mp kv_seq shard"}
    more_cases = {
        "graph_sconv": [f"stream S={S8}", "ntu50 dense clip",
                        f"ntu50 dense stream S={S8}",
                        *(f"{t} dense {p}" for t, _ in DENSE_SKELETONS
                          for p in ("clip", f"stream S={S8}"))],
        "rfc_encode": [f"stream S={S8}", "clip no res",
                       f"stream S={S8} mixed keep"],
        "rfc_decode": [f"stream S={S8}"],
        "graph_sconv_csr": [f"ntu50 csr stream S={S8}",
                            f"ntu50 csr eps=0 stream S={S8}"],
        "windowed_similarity": [
            *(f"ck stream S={S}{f}" for S in STREAM_SLOTS
              for f in ("", " bare") if (S, f) != (S8, "")),
            f"ck padded stream S={S8}", f"ck padded stream S={S8} bare"],
        "flash_decode": ["lm early decode step", "lm first decode step",
                         *(c[0] for c in FD_CASES),
                         "lm bf16 first decode step", "lm bf16 last step",
                         *(c[0] for c in FD_BF16_CASES),
                         *(f"{m} {w}" for m in ("moe granite", "moe qwen3",
                                                "vlm llava")
                           for w in ("first decode step", "last step")),
                         "vlm image decode step",
                         *(f"zoo {z[0]} {w}" for z in ZOO_SERVE if z[0]
                           != "xlstm-1.3b"
                           for w in ("first decode step", "last step")),
                         "zoo gemma3 long local", "zoo gemma3 long global",
                         *(c[0] for c in ZOO_FD_CASES),
                         *(c[0] for c in MP_FD_CASES)],
        "flash_decode_partial": ["mp kv_seq shard float32"]}
    kernels = []
    for name in _build.KERNELS:
        path = main_case.get(name, "clip")
        entry = {
            "name": name, "route": "cuda", "source": KERNEL_INFO[name][0],
            "replaces": KERNEL_INFO[name][1],
            "launches": sum(c[name] for c in launches.values()),
            "launches_by_path": {p: c[name] for p, c in launches.items()},
            "launches_per_step": {p: c[name] for p, c in per_step.items()
                                  if c[name]},
            "path": path, **summary[(path, name)],
        }
        for p in more_cases.get(name, ()):
            entry[p] = summary[(p, name)]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
