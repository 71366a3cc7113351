// GQA decode attention for Hopper (sm_90a): one query token per
// (batch b, kv head h, group member g) against a KV cache,
//     out[b,h,g,:] = sum_{lo<=s<valid} softmax_s(q[b,h,g,:].k[b,s,h,:] /
//                    sqrt(D)) * v[b,s,h,:]
// with cache slots s >= valid given -1e30 before the max (as the TPU kernel
// does; valid <= 0 masks every slot, so the result is the mean of V over
// all S), float32 statistics and accumulators, and a final division by
// max(l, 1e-20).  lo is 0, or with a sliding window (window > 0, a
// runtime argument) max(0, valid - window): the query at position
// valid - 1 sees the last `window` slots, as the TPU model's
// flash_attention masks qi - kj >= window (gemma3's local layers, whose
// cache is longer than the window).  A window that leaves no slot masks
// every slot, as valid <= 0 does.  D runs to 256: up to 128 the narrow
// instantiations (NC <= 4, up to 4 query rows a block), above it the wide
// ones (NC 5 to 8, up to 2 query rows, so a lane's registers for the
// queries and accumulators stay those of the narrow path).
//
// The cache is float32 or bfloat16 (kBf16; q and out stay float32).  A
// bf16 cache follows the TPU model's rules for a bf16 cache
// (src/repro/models/layers/attention.py:101-103): the scores are float32,
// the stabilised s - m is rounded to bf16 before exp and the probability
// rounded to bf16 after it, l sums those in float32 and the PV product
// accumulates the bf16 p times the bf16 v in float32.  So its softmax runs
// in natural units (expf, q prescaled by 1 / sqrt(D) alone), where the
// float32 path runs on exp2, and in two passes: a first walks the K rows
// alone for each query row's max score over [lo, n) (reduced over the
// lane groups, the warps and the cluster through distributed shared
// memory), then the second rounds every probability against that max, as
// the plain version does (one softmax over the row), with no rescale.
// The first pass reads K again: 1.5x the bytes of one pass.  Its rows are staged by 16-byte cp.async of 8
// bf16 values (D % 8 == 0 and a 16-byte aligned cache) into the float32
// path's ring rows (a bf16 row fills the first half of one), and each
// lane widens its 4-value chunks to float32 in registers.
//
// Replaces src/repro/kernels/flash_decode.py:flash_decode_pallas (the TPU
// kernel that streams 512-row KV blocks through VMEM with the running
// max, sum and accumulator in scratch, one sequential grid step per block).
//
// What bounds it on the H100: bytes.  Each launch reads the K and V rows
// the softmax needs once (2 * B * n * Hkv * D values of 4 bytes, or 2 for
// a bf16 cache; n = valid clamped to [1, S], S when valid <= 0) and does
// about 4 * G flops per value read; at G = 3 to 4 that is far below the
// card's float32 rate per byte, so its floor is the cache read at 3.35
// TB/s.  At the served shape (smollm-360m,
// batch 4: 5.2 MB a launch) that floor is 1.6 us, under the launch latency:
// there the design aims to have every byte requested in the first round
// trip.
//
// Design (flash-decoding): the grid is (splits, Hkv * ceil(G / GQ), B),
// GQ = G's query rows a block takes (G itself up to 4, else G's chunks
// evened out; 4 under 4-byte staging); the `splits` blocks of one (b, h,
// query chunk) form a thread-block cluster along x and split the first n
// rows between them, in spans of ceil(n / splits) rows rounded up to 16,
// so every split shares the work at every decode position (n comes from
// `valid`, read on the card: a decode step never syncs with the host).  A
// split with no rows reads nothing and holds an empty partial (m = -inf,
// l = 0).
//   1. Each warp is its own pipeline, with no block barrier in the loop:
//      it takes the span's 16-row tiles w, w + W, w + 2W, ... through its
//      own shared-memory ring of `stages` slots (the tile being read and
//      stages - 1 in flight), staged by 16-byte cp.async.cg when D % 4 == 0
//      and the cache is 16-byte aligned (4-byte cp.async otherwise, with
//      the row's pad columns zeroed once: the template parameter kVec,
//      which the wrapper picks), rows padded by 4 floats; it waits for its
//      oldest tile and a __syncwarp.
//   2. The warp's four groups of 8 lanes each take 4 rows of the tile
//      (rows grp, grp + 4, ...); a lane holds the block's GQ query rows'
//      float4 chunks lane % 8 + 8j of D in registers (prescaled by
//      log2(e) / sqrt(D), so the softmax runs on exp2) and its share of
//      the accumulators.  A row's dot products are the lanes' float4
//      products added over the group by three xor shuffles; a group's
//      running max is updated once per tile (one rescale for 4 rows).
//      Each 8-lane phase of a float4 shared-memory load reads 128
//      contiguous bytes of one row, so loads meet no bank conflict.
//   3. Merge, always in one fixed order, so the result is bit-identical
//      from run to run: the four groups by xor shuffles (8, then 16), the
//      warps in index order through shared memory; each block pushes its
//      partial of every (g, float4 chunk) item, with its m and l, into the
//      shared memory of the cluster's block that owns the item (remote
//      stores), then one cluster barrier, and each block merges its items
//      over the cluster's blocks in rank order and stores them.  The
//      barrier's arrival is split: arrive at the start, wait before the
//      first remote store (every block has started by then).
// At the served shape latency rules: the launch, the dependent read of
// `valid`, one round trip for the tiles and the merge.  A launch there
// takes about 8 us at valid 511 and 7 us at valid 17 (chip_smoke.py,
// PERF.md), against 1.6 us at the byte bound.  The block sizes come from
// kernels/flash_decode.py:decode_plan (splits, warps, stages), fitted to
// tools/torch_kernel_plans.py's sweep.
//
// The partial form (a non-null `lse`): the cache is one kv_seq shard, slots
// [offset, offset + S) of a longer cache, and `valid` and the window stay
// the whole cache's (read on the card): the shard's live rows are
// [clamp(valid - window - offset, 0, S), clamp(valid - offset, 0, S)) (the
// lower bound 0 without a window).  Each query row's log-sum-exp of its
// scaled scores over those rows, in natural units, goes to lse[b, h, g]
// (float32, (B, Hkv, G)) beside its output; a shard with no live row reads
// nothing and gives out = 0 and lse = -inf (no masked slot, no NaN).  The
// cluster merge already holds each row's max m and sum l: lse is
// m + log(l) (m in log2 units on the float32 path, so (m + log2 l) ln 2),
// one more store.  On a bf16 cache a shard would round its probabilities
// against its own max, where one rank rounds them against the row's max
// over the whole cache; so there the caller takes two launches: the
// max-only form (a null `out`: pass A alone, each row's max over the
// shard's live rows to lse, -inf where none), the maxima's max over the
// ranks, then the partial form with that max given (`row_max`: pass A is
// skipped and every probability rounds against it, so the ranks' partials
// merge into what one rank computes, up to float32 sum order).  Replaces
// the part of the TPU kernel's callers that GSPMD runs per sequence shard
// under JAX's kv_seq rule (the merge is the caller's:
// kernels/ref.py:flash_decode_merge).
//
// This header holds the kernel template and its dispatch; flash_decode.cu
// instantiates the float32 cache (flash_decode_f32) and
// flash_decode_bf16.cu the bf16 one (flash_decode_bf16), so the two
// compile in parallel.
#pragma once
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "tf32_mma.cuh"   // cp.async, the shared-memory opt-in

namespace cg = cooperative_groups;
using tc::cp_async16;
using tc::cp_async4;
using tc::cp_async_commit;
using tc::kMaxDevices;
using tc::kMaxSmem;

namespace {

constexpr int kRows = 16;            // rows of a warp's tile
constexpr int kGroupRows = 4;        // rows of a tile per 8-lane group
constexpr int kMaxGQ = 4;            // query rows per block
constexpr int kWideGQ = 2;           // query rows per block at D > 128
constexpr int kNarrowNC = 4;         // float4 chunks per lane at D <= 128
constexpr int kMaxD = 256;
constexpr int kMaxSplits = 16;       // above 8: a non-portable cluster size
constexpr int kMaxWarps = 8;
constexpr int kMaxStages = 6;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int row_ld(int d4) { return 4 * d4 + 4; }

// floats of the cluster's gather buffer (each block's m and l of its GQ
// query rows, then its float4 chunks of the (g, chunk) items this block
// owns), which leads the shared memory, and of one warp's ring
__host__ __device__ constexpr int own_items(int gq, int d4, int P) {
  return (gq * d4 + P - 1) / P;
}
__host__ __device__ constexpr int gather_floats(int gq, int d4, int P) {
  return up4(2 * P * gq) + 4 * P * own_items(gq, d4, P);
}
__host__ __device__ constexpr int ring_floats(int d4, int stages) {
  return stages * 2 * kRows * row_ld(d4);
}

// query rows per block: G itself up to `cap`, else G's chunks evened out
int query_rows(int G, int cap) {
  const int chunks = (G + cap - 1) / cap;
  return (G + chunks - 1) / chunks;
}

size_t smem_bytes(int D, int gq, int splits, int warps, int stages) {
  const int d4 = (D + 3) / 4;
  return sizeof(float) * ((size_t)gather_floats(gq, d4, splits) +
                          (size_t)warps * ring_floats(d4, stages));
}

// wait until at most `n` of this thread's newest cp.async groups are
// pending (the PTX takes the count as an immediate)
__device__ __forceinline__ void cp_async_wait_newest(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
  }
}

// the two halves of a cluster barrier: the arrival at the start costs
// nothing, and the wait before the first remote store finds every block
// of the cluster started (distributed shared memory needs that)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, fmaf(a.x, b.x, s))));
}

__device__ __forceinline__ float4 axpby(float4 x, float a, float4 y,
                                        float b) {
  return make_float4(x.x * a + y.x * b, x.y * a + y.y * b,
                     x.z * a + y.z * b, x.w * a + y.w * b);
}

// 2^(m - ref) (e^(m - ref) in natural units) with ref = max of the
// partials being merged; an empty partial (m = -inf) weighs 0, also when
// every partial is empty
template <bool kNat>
__device__ __forceinline__ float weight(float m, float ref) {
  const float d = m - (ref == -INFINITY ? 0.f : ref);
  return kNat ? expf(d) : exp2f(d);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// a bf16 cache's probability: s - ref rounded to bf16, exp, rounded again
// (the TPU model's p = exp((s - m).astype(bf16)) in bf16)
__device__ __forceinline__ float prob_bf16(float s, float ref) {
  return round_bf16(expf(round_bf16(s - (ref == -INFINITY ? 0.f : ref))));
}

// four values of a ring row as float32: a float4, or 4 bf16 (8 bytes)
// widened exactly
template <bool kBf16>
__device__ __forceinline__ float4 load4(const float* row, int c) {
  if constexpr (kBf16) {
    const uint2 u = *reinterpret_cast<const uint2*>(row + 2 * c);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  } else {
    return *reinterpret_cast<const float4*>(row + 4 * c);
  }
}

// NC: float4 chunks of D per lane, ceil(ceil(D / 4) / 8); GQ: query rows
// per block (query_rows); T: the cache's element type (float, or
// __nv_bfloat16, which needs kVec)
template <typename T, bool kVec, int NC, int GQ>
__global__ void __launch_bounds__(32 * kMaxWarps)
flash_decode_kernel(const float* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v,
                    const int* __restrict__ valid_ptr, float* __restrict__ out,
                    float* __restrict__ lse_out,
                    const float* __restrict__ row_max, int S, int Hkv, int G,
                    int D, int stages, float qscale, int window, int offset) {
  constexpr bool kBf16 = !std::is_same<T, float>::value;
  static_assert(!kBf16 || kVec, "a bf16 cache takes 16-byte staging");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  cluster_arrive_relaxed();
  const int P = (int)cluster.num_blocks(), part = (int)cluster.block_rank();
  const int W = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / 8, l8 = lane % 8;
  const int d4 = (D + 3) / 4, ld = row_ld(d4);
  const int gz = (G + GQ - 1) / GQ;
  const int h = blockIdx.y / gz, g0 = blockIdx.y % gz * GQ;
  const int gn = min(GQ, G - g0), b = blockIdx.z;
  const int items = GQ * d4, own = own_items(GQ, d4, P);

  float* gm = smem;                             // [P][GQ] maxima
  float* gl = gm + P * GQ;                      // [P][GQ] sums
  float* ga = smem + up4(2 * P * GQ);           // [P][own] float4 chunks
  float* rings = smem + gather_floats(GQ, d4, P);
  float* ring = rings + warp * ring_floats(d4, stages);
  const size_t row_stride = (size_t)Hkv * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
  const T* kb = k + base;
  const T* vb = v + base;
  const size_t lq = ((size_t)b * Hkv + h) * G + g0;   // row g0's index
  const size_t qo = lq * D;

  const int valid = *valid_ptr;
  // the query rows' chunks, prescaled; zero past D and past G
  float4 qr[GQ][NC];
#pragma unroll
  for (int g = 0; g < GQ; ++g)
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      float e[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * (l8 + 8 * j) + i;
        e[i] = (g < gn && d < D) ? q[qo + (size_t)g * D + d] * qscale : 0.f;
      }
      qr[g][j] = make_float4(e[0], e[1], e[2], e[3]);
    }
  const int per = 4 * d4 - D;   // 4-byte staging leaves pad columns: zero
  if (!kVec)
    for (int i = lane; i < stages * 2 * kRows * per; i += 32)
      ring[(i / per) * ld + D + i % per] = 0.f;

  // the live rows [lo, n): n from valid, lo 0 or the window's lower bound
  // (read on the card)
  int n, lo = 0;
  bool masked = false;
  if (lse_out != nullptr) {   // the partial form: this shard's share
    n = min(max(valid - offset, 0), S);
    if (window > 0) lo = min(max(valid - window - offset, 0), S);
    if (lo >= n) n = lo = 0;  // no live slot here: every split reads nothing
  } else {
    n = (valid >= 1 && valid < S) ? valid : S;
    masked = valid <= 0;
    if (window > 0) {
      lo = max(0, valid - window);
      if (lo >= n) {   // no live slot: mask all, as valid <= 0 does
        lo = 0;
        masked = true;
      }
    }
  }
  const int cnt = n - lo;
  const int span = ((cnt + P - 1) / P + kRows - 1) / kRows * kRows;
  const int r0 = lo + min(cnt, part * span), r1 = min(n, r0 + span);
  const int tiles = (r1 - r0 + kRows - 1) / kRows;
  const int mine = warp < tiles ? (tiles - warp + W - 1) / W : 0;
  // a lane's first (row, column) of a tile's copies and its step
  const int unit = kBf16 ? D / 8 : kVec ? d4 : D;
  const int lr = lane / unit, lc = lane % unit;
  const int sr = 32 / unit, sc = 32 % unit;

  // queue the copies of this warp's t-th tile into ring slot `slot` (its
  // K rows alone when not with_v: a bf16 cache's first pass)
  auto stage = [&](int t, int slot, bool with_v) {
    float* ks = ring + slot * 2 * kRows * ld;
    float* vs = ks + kRows * ld;
    const int s0 = r0 + (warp + t * W) * kRows;
    const int rows = min(kRows, r1 - s0);
    for (int r = lr, c = lc; r < rows;) {
      const size_t o = (size_t)(s0 + r) * row_stride;
      if constexpr (kBf16) {   // 8 values, into the row's first half
        cp_async16(ks + r * ld + 4 * c,
                   reinterpret_cast<const float*>(kb + o + 8 * c), 16);
        if (with_v)
          cp_async16(vs + r * ld + 4 * c,
                     reinterpret_cast<const float*>(vb + o + 8 * c), 16);
      } else if constexpr (kVec) {
        cp_async16(ks + r * ld + 4 * c, kb + o + 4 * c, 16);
        cp_async16(vs + r * ld + 4 * c, vb + o + 4 * c, 16);
      } else {
        cp_async4(ks + r * ld + c, kb + o + c, true);
        cp_async4(vs + r * ld + c, vb + o + c, true);
      }
      r += sr;
      c += sc;
      if (c >= unit) {
        c -= unit;
        ++r;
      }
    }
  };

  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // the scores of this lane group's rows of a staged tile: s[g][i] for row
  // 4i + grp, -inf past the tile's `rows`
  auto scores = [&](const float* ks, int rows, float (&s)[GQ][kGroupRows]) {
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      const int r = kGroupRows * i + grp;
      float4 kc[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = l8 + 8 * j;
        kc[j] = c < d4 ? load4<kBf16>(ks + r * ld, c) : zero4;
      }
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < NC; ++j) dot = dot4(qr[g][j], kc[j], dot);
#pragma unroll
        for (int off = 4; off > 0; off /= 2)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[g][i] = r < rows ? (masked ? kMasked : dot) : -INFINITY;
      }
    }
  };

  float m[GQ], l[GQ];
#pragma unroll
  for (int g = 0; g < GQ; ++g) m[g] = -INFINITY;
  if constexpr (kBf16) {
    if (row_max != nullptr) {   // the rows' maxima over every shard, given
#pragma unroll
      for (int g = 0; g < GQ; ++g)
        m[g] = g < gn ? row_max[lq + g] : -INFINITY;
    } else {
      // pass A (a bf16 cache): each query row's max score over the cluster's
      // rows [lo, n), so every probability is rounded against the row's max,
      // as the plain version rounds it.  The warps walk their K tiles alone,
      // then the maxima meet over the lane groups, the warps and the cluster
      // (each block pushes its own into every block's gather slot).
      for (int t = 0; t < stages - 1; ++t) {
        if (t < mine) stage(t, t, false);
        cp_async_commit();
      }
      for (int t = 0, slot = 0, next = stages - 1; t < mine; ++t) {
        if (t + stages - 1 < mine) stage(t + stages - 1, next, false);
        cp_async_commit();
        cp_async_wait_newest(stages - 1);
        __syncwarp();
        float s[GQ][kGroupRows];
        scores(ring + slot * 2 * kRows * ld,
               min(kRows, r1 - (r0 + (warp + t * W) * kRows)), s);
        slot = slot + 1 == stages ? 0 : slot + 1;
        next = next + 1 == stages ? 0 : next + 1;
#pragma unroll
        for (int g = 0; g < GQ; ++g)
#pragma unroll
          for (int i = 0; i < kGroupRows; ++i) m[g] = fmaxf(m[g], s[g][i]);
        __syncwarp();
      }
      tc::cp_async_wait_all();
#pragma unroll
      for (int off = 8; off < 32; off *= 2)
#pragma unroll
        for (int g = 0; g < GQ; ++g)
          m[g] = fmaxf(m[g], __shfl_xor_sync(0xffffffffu, m[g], off));
      __syncwarp();
#pragma unroll
      for (int g = 0; g < GQ; ++g)           // the warp's maxima, its ring head
        if (lane == g) ring[g] = m[g];
      __syncthreads();
      if (tid < GQ) {
        float bm = -INFINITY;
        for (int w = 0; w < W; ++w)
          bm = fmaxf(bm, rings[w * ring_floats(d4, stages) + tid]);
        cluster_wait();                        // every block has started
        for (int p = 0; p < P; ++p)
          cluster.map_shared_rank(gm, p)[part * GQ + tid] = bm;
      } else {
        cluster_wait();
      }
      cluster.sync();                          // every block's maxima landed
#pragma unroll
      for (int g = 0; g < GQ; ++g) {
        m[g] = -INFINITY;
        for (int p = 0; p < P; ++p) m[g] = fmaxf(m[g], gm[p * GQ + g]);
      }
      if (out == nullptr) {   // the max-only form: the rows' maxima, done (no
                              // block touches another's memory after the sync)
        if (part == 0 && tid < gn) {
          float mx = -INFINITY;
          for (int p = 0; p < P; ++p) mx = fmaxf(mx, gm[p * GQ + tid]);
          lse_out[lq + tid] = mx;
        }
        return;
      }
      // done with the gather buffer until the merge: its writers wait here
      cluster_arrive();
      __syncthreads();                         // the rings are free again
    }
  }

  for (int t = 0; t < stages - 1; ++t) {
    if (t < mine) stage(t, t, true);
    cp_async_commit();
  }
  float4 acc[GQ][NC];
#pragma unroll
  for (int g = 0; g < GQ; ++g) {
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[g][j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = 0, slot = 0, next = stages - 1; t < mine; ++t) {
    if (t + stages - 1 < mine) stage(t + stages - 1, next, true);
    cp_async_commit();
    cp_async_wait_newest(stages - 1);   // tile t has landed
    __syncwarp();
    const float* ks = ring + slot * 2 * kRows * ld;
    const float* vs = ks + kRows * ld;
    const int rows = min(kRows, r1 - (r0 + (warp + t * W) * kRows));
    slot = slot + 1 == stages ? 0 : slot + 1;
    next = next + 1 == stages ? 0 : next + 1;

    float s[GQ][kGroupRows];
    scores(ks, rows, s);
    // online softmax: one rescale per group and tile (a bf16 cache: the
    // row's max from pass A throughout, no rescale)
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      float mt = s[g][0];
#pragma unroll
      for (int i = 1; i < kGroupRows; ++i) mt = fmaxf(mt, s[g][i]);
      const float mn = kBf16 ? m[g] : fmaxf(m[g], mt);
      const float corr = weight<kBf16>(m[g], mn);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kGroupRows; ++i) {
        // now the probability
        s[g][i] = kBf16 ? prob_bf16(s[g][i], mn) : weight<false>(s[g][i], mn);
        sum += s[g][i];
      }
      l[g] = l[g] * corr + sum;
      m[g] = mn;
#pragma unroll
      for (int j = 0; j < NC; ++j)
        acc[g][j] = make_float4(acc[g][j].x * corr, acc[g][j].y * corr,
                                acc[g][j].z * corr, acc[g][j].w * corr);
    }
#pragma unroll
    for (int i = 0; i < kGroupRows; ++i) {
      const int r = kGroupRows * i + grp;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = l8 + 8 * j;
        // a row past the tile's end holds stale or unset words: read as 0
        const float4 vc =
            (c < d4 && r < rows) ? load4<kBf16>(vs + r * ld, c) : zero4;
#pragma unroll
        for (int g = 0; g < GQ; ++g) {
          const float p = s[g][i];
          acc[g][j].x = fmaf(p, vc.x, acc[g][j].x);
          acc[g][j].y = fmaf(p, vc.y, acc[g][j].y);
          acc[g][j].z = fmaf(p, vc.z, acc[g][j].z);
          acc[g][j].w = fmaf(p, vc.w, acc[g][j].w);
        }
      }
    }
    __syncwarp();   // the ring slot is read: a later stage may refill it
  }
  tc::cp_async_wait_all();

  // 3a. the warp's four lane groups, by xor shuffles
#pragma unroll
  for (int off = 8; off < 32; off *= 2)
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = weight<kBf16>(m[g], mn), c = weight<kBf16>(mo, mn);
      l[g] = l[g] * a + lo * c;
      m[g] = mn;
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float4 o;
        o.x = __shfl_xor_sync(0xffffffffu, acc[g][j].x, off);
        o.y = __shfl_xor_sync(0xffffffffu, acc[g][j].y, off);
        o.z = __shfl_xor_sync(0xffffffffu, acc[g][j].z, off);
        o.w = __shfl_xor_sync(0xffffffffu, acc[g][j].w, off);
        acc[g][j] = axpby(acc[g][j], a, o, c);
      }
    }
  // the warp's partial into the head of its ring (every copy has landed
  // and every lane is past its reads)
  __syncwarp();
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GQ; ++g) {
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = l8 + 8 * j;
        if (c < d4)
          *reinterpret_cast<float4*>(ring + g * 4 * d4 + 4 * c) = acc[g][j];
      }
      if (l8 == 0) {
        ring[GQ * 4 * d4 + g] = m[g];
        ring[GQ * 4 * d4 + GQ + g] = l[g];
      }
    }
  }
  __syncthreads();

  // 3b. the warps in index order, pushed to the block of the cluster that
  // owns each (g, chunk) item: its chunk at [part][slot], the block's m
  // and l of row g at [part][g] (the item threads of one g write the
  // same two values)
  const int rf = ring_floats(d4, stages);
  cluster_wait();
  for (int it = tid; it < items; it += blockDim.x) {
    const int g = it / d4, c = it % d4;
    float mx = -INFINITY;
    for (int w = 0; w < W; ++w)
      mx = fmaxf(mx, rings[w * rf + GQ * 4 * d4 + g]);
    float4 a = zero4;
    float ls = 0.f;
    for (int w = 0; w < W; ++w) {
      const float* wp = rings + w * rf;
      const float wt = weight<kBf16>(wp[GQ * 4 * d4 + g], mx);
      a = axpby(a, 1.f,
                *reinterpret_cast<const float4*>(wp + g * 4 * d4 + 4 * c), wt);
      ls += wp[GQ * 4 * d4 + GQ + g] * wt;
    }
    const int r = it / own;
    float* rm = cluster.map_shared_rank(gm, r);
    *reinterpret_cast<float4*>(cluster.map_shared_rank(ga, r) +
                               4 * (part * own + it % own)) = a;
    rm[part * GQ + g] = mx;
    rm[P * GQ + part * GQ + g] = ls;
  }
  cluster.sync();   // every block's pushes have landed

  // 3c. this block's items: the cluster's partials in rank order
  for (int sl = tid; sl < own; sl += blockDim.x) {
    const int it = part * own + sl;
    const int g = it / d4, c = it % d4;
    if (it >= items || g >= gn) continue;
    float mx = -INFINITY;
    for (int p = 0; p < P; ++p) mx = fmaxf(mx, gm[p * GQ + g]);
    float4 a = zero4;
    float ls = 0.f;
    for (int p = 0; p < P; ++p) {
      const float wt = weight<kBf16>(gm[p * GQ + g], mx);
      a = axpby(a, 1.f,
                *reinterpret_cast<const float4*>(ga + 4 * (p * own + sl)), wt);
      ls += gl[p * GQ + g] * wt;
    }
    const float den = fmaxf(ls, 1e-20f);
    const float e[4] = {a.x / den, a.y / den, a.z / den, a.w / den};
    float* o = out + qo + (size_t)g * D;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (4 * c + i < D) o[4 * c + i] = e[i];
    if (lse_out != nullptr && c == 0)   // one item a row stores its lse
      lse_out[lq + g] = ls > 0.f ? (kBf16 ? mx + logf(ls)
                                              : (mx + log2f(ls)) * kLn2)
                                     : -INFINITY;
  }
}

template <typename T, bool kVec, int NC, int GQ>
cudaError_t launch(dim3 grid, int warps, size_t smem, cudaStream_t stream,
                   const float* q, const T* k, const T* v,
                   const int* valid, float* out, float* lse,
                   const float* row_max, int S, int Hkv, int G, int D,
                   int stages, int window, int offset) {
  static int limit[kMaxDevices];
  static bool ready[kMaxDevices];
  auto kern = flash_decode_kernel<T, kVec, NC, GQ>;
  cudaError_t err = tc::allow_smem((const void*)kern, smem, limit);
  if (err != cudaSuccess) return err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices || !ready[dev]) {
    // clusters above 8 blocks; all of the SM's memory as shared memory,
    // since the copies bypass L1
    err = cudaFuncSetAttribute(
        (const void*)kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          (const void*)kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < kMaxDevices) ready[dev] = true;
  }
  // log2(e) / sqrt(D) for the exp2 softmax; 1 / sqrt(D) in natural units
  const float qscale =
      (std::is_same<T, float>::value ? kLog2e : 1.f) / sqrtf((float)D);
  if (grid.x == 1) {   // one split: an implicit cluster of one block
    kern<<<grid, 32 * warps, smem, stream>>>(q, k, v, valid, out, lse,
                                             row_max, S, Hkv, G, D, stages,
                                             qscale, window, offset);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * warps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = grid.x;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, q, k, v, valid, out, lse, row_max, S,
                           Hkv, G, D, stages, qscale, window, offset);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instantiation of this query-row count: 1 to 4 rows a block on the
// narrow path, 1 or 2 on the wide one; 4-byte staging takes the cap alone
template <typename T, bool kVec, int NC>
cudaError_t launch_gq(int gq, dim3 grid, int warps, size_t smem,
                      cudaStream_t stream, const float* q, const T* k,
                      const T* v, const int* valid, float* out, float* lse,
                      const float* row_max, int S, int Hkv, int G, int D,
                      int stages, int window, int offset) {
#define FD_GQ(N)                                                           \
  return launch<T, kVec, NC, N>(grid, warps, smem, stream, q, k, v,       \
                                valid, out, lse, row_max, S, Hkv, G, D,   \
                                stages, window, offset)
  if constexpr (!kVec) {
    FD_GQ((NC > kNarrowNC ? kWideGQ : kMaxGQ));
  } else if constexpr (NC > kNarrowNC) {
    if (gq == 1) FD_GQ(1);
    FD_GQ(2);
  } else {
    switch (gq) {
      case 1: FD_GQ(1);
      case 2: FD_GQ(2);
      case 3: FD_GQ(3);
      default: FD_GQ(4);
    }
  }
#undef FD_GQ
}

template <typename T>
cudaError_t dispatch(bool vec, int nc, int gq, dim3 grid, int warps,
                     size_t smem, cudaStream_t s, const float* q,
                     const T* k, const T* v, const int* valid,
                     float* out, float* lse, const float* row_max, int S,
                     int Hkv, int G, int D, int stages, int window,
                     int offset) {
#define FD_NC(V, NC)                                                       \
  return launch_gq<T, V, NC>(gq, grid, warps, smem, s, q, k, v, valid,    \
                             out, lse, row_max, S, Hkv, G, D, stages,     \
                             window, offset)
#define FD_ALL(V)                                                          \
  switch (nc) {                                                            \
    case 1: FD_NC(V, 1);                                                   \
    case 2: FD_NC(V, 2);                                                   \
    case 3: FD_NC(V, 3);                                                   \
    case 4: FD_NC(V, 4);                                                   \
    case 5: FD_NC(V, 5);                                                   \
    case 6: FD_NC(V, 6);                                                   \
    case 7: FD_NC(V, 7);                                                   \
    default: FD_NC(V, 8);                                                  \
  }
  if (vec) FD_ALL(true);
  if constexpr (std::is_same<T, float>::value) FD_ALL(false);
  return cudaErrorInvalidValue;   // a bf16 cache takes 16-byte staging
#undef FD_ALL
#undef FD_NC
}

// the checks and the launch of one call; T is the cache's element type; a
// non-null lse makes it the partial form, and on a bf16 cache a null out
// the max-only form, a non-null row_max the partial form against it
template <typename T>
int entry(const void* q, const void* k, const void* v, const void* valid,
          void* out, void* lse, const void* row_max, int B, int S, int Hkv,
          int G, int D, int splits, int warps, int stages, int vec,
          int window, int offset, void* stream) {
  constexpr int kAlign = std::is_same<T, float>::value ? 4 : 8;
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || D <= 0 || D > kMaxD ||
      splits < 1 || splits > kMaxSplits ||
      (warps != 1 && warps != 2 && warps != 4 && warps != 8) || stages < 2 ||
      stages > kMaxStages || window < 0 || offset < 0)
    return (int)cudaErrorInvalidValue;
  // a null out or a given row_max: the partial form on a bf16 cache only
  if ((out == nullptr || row_max != nullptr) &&
      (lse == nullptr || std::is_same<T, float>::value ||
       (out == nullptr && row_max != nullptr)))
    return (int)cudaErrorInvalidValue;
  if (!std::is_same<T, float>::value && !vec)
    return (int)cudaErrorInvalidValue;
  if (vec && (D % kAlign != 0 || reinterpret_cast<size_t>(k) % 16 != 0 ||
              reinterpret_cast<size_t>(v) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  const int nc = ((D + 3) / 4 + 7) / 8;
  // 4-byte staging (odd D) takes the cap of query rows a block, guarded
  // past G
  const int cap = nc > kNarrowNC ? kWideGQ : kMaxGQ;
  const int gq = vec ? query_rows(G, cap) : cap;
  const long long gy = (long long)Hkv * ((G + gq - 1) / gq);
  if (gy > 65535 || B > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, gq, splits, warps, stages);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const dim3 grid(splits, (unsigned)gy, B);
  const cudaStream_t s = (cudaStream_t)stream;
  return (int)dispatch<T>(vec, nc, gq, grid, warps, smem, s,
                          (const float*)q, (const T*)k, (const T*)v,
                          (const int*)valid, (float*)out, (float*)lse,
                          (const float*)row_max, S, Hkv, G, D, stages, window,
                          offset);
}

}  // namespace
