// Cavity-pruned temporal convolution, streaming form, for Hopper (sm_90a),
// read from the stream state's ring in place and stored in the block's
// output layout:
//     out[s, v, col(g*Fg + i)] = bias[col] + sum_j sum_c
//         ring[s, (head[s] + taps[g, j]) mod K, v, c] * wp[g, j, c, i]
// ring (S, K, V, C) is a block's tconv-input ring, head (S,) each slot's
// oldest frame ((t + 1) mod K for its clock t), so slots at different
// phases share one launch.  col = slot_col[g*Fg + i] sends packed slot
// g*Fg + i to its column of the (S, V, cout) output, or nowhere (-1: a
// padding slot or a pruned filter); the columns no slot reaches (the
// pruned filters) are written as exactly 0.0.
//
// Replaces src/repro/kernels/cavity_tconv.py:cavity_tconv_step_pallas,
// composed with what the engine did around it: the chronological gather
// of the ring, the (N*V, K, C) transpose copy, the filter permutation, the
// bias add and the kept-filter scatter.  Filter group g (of L = 8) sums
// only its n_keep kept taps, so the frames of the pruned taps are never
// read: the paper's C2 skip.
//
// What bounds it on the H100: latency.  At the streaming shapes (B = S*V
// rows with S = 1..8 slots, C <= 256, n_keep = 3, Fg <= 32) one launch
// moves about 1 MB (the packed weights, then the kept-tap frames; about
// 0.4 us at 3.35 TB/s) and does under 0.1 GFLOP.  The floor is the launch
// latency plus two dependent round trips to memory (each slot's head,
// then its frames): the design issues the weights, the store map and the
// bias before the head is read, then every frame row at once, and waits
// once (measured: about 7 us a launch at the smallest shapes,
// tools/torch_kernel_plans.py).
//
// Design: a block owns 16*WM rows x one group's Fg slots (padded to a
// multiple of 8) and a contiguous share of the contraction, whose steps
// are (kept tap, 8 channels); the `parts` blocks that share a tile form a
// thread-block cluster along z, so S = 1, 3 and 8 reach 128 blocks or
// more.  Each block stages, with cp.async (16-byte copies where C and
// Fg are multiples of 4, 4-byte ones otherwise), the frame rows of its
// steps straight from the ring and the matching rows of the packed
// weights, then its 4 warps each take a tile of 16 rows (WM of them) and
// a share of the steps (4 / WM ways) on TF32 mma.sync.m16n8k8 with the
// 3-pass split done in registers as the fragments load (each value is
// used once per block, so nothing is split in shared memory), three MMAs
// to a fresh fragment added in float32 (tf32_mma.cuh); a float32 FMA
// variant of the same tile, timed beside it, was slower at every stream
// shape (PERF.md).  The warps' partial tiles
// are added in shared memory in a fixed order, then across the cluster
// through distributed shared memory, each block adding, in rank order,
// its share of the tile's elements, and storing them with the bias at
// their columns.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace cg = cooperative_groups;
using namespace tc;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxKeep = 16;
constexpr int kMaxNT = 8;                 // Fg <= 64

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }

// shared memory (in 4-byte words) of a block of 16*wm rows, qw contraction
// columns and nb slots: the frame rows, the weight rows, the warps'
// partial tiles, the (row, kept tap) frame indices, the store map of all
// `slots` packed slots, the bias and the column marks; mirrored by
// kernels/cavity_tconv.py:_step_smem_bytes
__host__ __device__ inline int step_smem_words(int wm, int qw, int nb,
                                               int n_keep, int slots,
                                               int cout) {
  const int bm = 16 * wm;
  return bm * ld_a(qw) + qw * ld_b(nb) + (kWarps / wm) * bm * nb +
         up4(bm * n_keep) + up4(slots) + up4(cout) + cout;
}

__device__ __forceinline__ void split_u(float a, uint32_t& hi, uint32_t& lo) {
  float h, l;
  split(a, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}

template <int WM>
__global__ void __launch_bounds__(kThreads)
step_kernel(const float* __restrict__ ring, const int* __restrict__ head,
            const float* __restrict__ wp, const int* __restrict__ taps,
            const int* __restrict__ slot_col, const float* __restrict__ bias,
            float* __restrict__ out, int S, int K, int V, int C, int L,
            int n_keep, int Fg, int cout, int vec_x, int vec_w) {
  constexpr int BM = 16 * WM, WK = kWarps / WM;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int parts = (int)cluster.num_blocks();
  const int part = (int)cluster.block_rank();

  const int B = S * V, b0 = blockIdx.x * BM, g = blockIdx.y;
  const int NB = up8(Fg), NT = NB / 8;
  const int spt = (C + 7) / 8;                 // 8-channel steps per tap
  const int NS = n_keep * spt;
  const int s0 = part * NS / parts, ns = (part + 1) * NS / parts - s0;
  const int qwm = (NS + parts - 1) / parts * 8;
  const int lda = ld_a(qwm), ldw = ld_b(NB);
  float* As = smem;                            // [row][step * 8 + e]
  float* Ws = As + BM * lda;                   // [step * 8 + e][slot]
  float* red = Ws + qwm * ldw;                 // [warp share][row][slot]
  int* rowf = reinterpret_cast<int*>(red + WK * BM * NB);
  int* scol = rowf + up4(BM * n_keep);         // slot_col, every slot
  float* bs = reinterpret_cast<float*>(scol + up4(L * Fg));   // bias
  int* mark = reinterpret_cast<int*>(bs + up4(cout));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;

  // first the loads that need no index, in flight while the ring's
  // indices are read: the weight rows of the block's steps (zero past C
  // and Fg), the store map and the bias
  if (vec_w) {
    const int nq = NB / 4;
    for (int i = tid; i < ns * 8 * nq; i += kThreads) {
      const int n = i % nq * 4, row = i / nq, q = s0 + row / 8;
      const int c = q % spt * 8 + row % 8;
      const bool ok = c < C && n < Fg;
      cp_async16(Ws + row * ldw + n,
                 ok ? wp + ((size_t)(g * n_keep + q / spt) * C + c) * Fg + n
                    : wp,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < ns * 8 * NB; i += kThreads) {
      const int n = i % NB, row = i / NB, q = s0 + row / 8;
      const int c = q % spt * 8 + row % 8;
      const bool ok = c < C && n < Fg;
      cp_async4(Ws + row * ldw + n,
                ok ? wp + ((size_t)(g * n_keep + q / spt) * C + c) * Fg + n
                   : wp,
                ok);
    }
  }
  for (int i = tid; i < L * Fg; i += kThreads)
    cp_async4(reinterpret_cast<float*>(scol) + i,
              reinterpret_cast<const float*>(slot_col) + i, true);
  for (int i = tid; i < cout; i += kThreads) cp_async4(bs + i, bias + i, true);
  cp_async_commit();

  // the ring row (s, frame, v) each (row, kept tap) reads, or -1
  for (int i = tid; i < BM * n_keep; i += kThreads) {
    const int r = i / n_keep, j = i % n_keep, b = b0 + r;
    int f = -1;
    if (b < B) {
      const int s = b / V, v = b % V, off = taps[g * n_keep + j];
      if (off >= 0 && off < K) {
        int k = (head[s] + off) % K;
        if (k < 0) k += K;
        f = (s * K + k) * V + v;
      }
    }
    rowf[i] = f;
  }
  __syncthreads();

  // then the block's frame rows (zero past B and C), and one wait
  if (vec_x) {
    for (int i = tid; i < BM * ns * 2; i += kThreads) {
      const int h = i & 1, t = (i >> 1) % ns, r = (i >> 1) / ns;
      const int q = s0 + t, c = q % spt * 8 + 4 * h;
      const int f = rowf[r * n_keep + q / spt];
      const bool ok = f >= 0 && c < C;
      cp_async16(As + r * lda + t * 8 + 4 * h,
                 ok ? ring + (size_t)f * C + c : ring, ok ? 16 : 0);
    }
  } else {
    for (int i = tid; i < BM * ns * 8; i += kThreads) {
      const int e = i & 7, t = (i >> 3) % ns, r = (i >> 3) / ns;
      const int q = s0 + t, c = q % spt * 8 + e;
      const int f = rowf[r * n_keep + q / spt];
      const bool ok = f >= 0 && c < C;
      cp_async4(As + r * lda + t * 8 + e,
                ok ? ring + (size_t)f * C + c : ring, ok);
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // warp (wm, wk): rows wm*16.., every slot, steps wk, wk + WK, ...
  const int wm = warp % WM, wk = warp / WM;
  float* mine = red + wk * BM * NB;
  float acc[kMaxNT][4];
#pragma unroll
  for (int b = 0; b < kMaxNT; ++b)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[b][e] = 0.f;
  for (int t = wk; t < ns; t += WK) {
    uint32_t ah[4], al[4];
    const float* a = As + (wm * 16 + gq) * lda + t * 8 + tq;
    split_u(a[0], ah[0], al[0]);
    split_u(a[8 * lda], ah[1], al[1]);
    split_u(a[4], ah[2], al[2]);
    split_u(a[8 * lda + 4], ah[3], al[3]);
#pragma unroll
    for (int b = 0; b < kMaxNT; ++b) {
      if (b >= NT) break;
      uint32_t bh[2], bl[2];
      const float* w = Ws + (t * 8 + tq) * ldw + b * 8 + gq;
      split_u(w[0], bh[0], bl[0]);
      split_u(w[4 * ldw], bh[1], bl[1]);
      mma3_add(acc[b], ah, al, bh, bl);
    }
  }
#pragma unroll
  for (int b = 0; b < kMaxNT; ++b) {
    if (b >= NT) break;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* d = mine + (wm * 16 + gq + 8 * h) * NB + b * 8 + 2 * tq;
      d[0] = acc[b][2 * h];
      d[1] = acc[b][2 * h + 1];
    }
  }
  __syncthreads();
  if (WK > 1)                      // the warps' shares, in order
    for (int e = tid; e < BM * NB; e += kThreads) {
      float s = red[e];
      for (int w = 1; w < WK; ++w) s += red[w * BM * NB + e];
      red[e] = s;
    }
  cluster.sync();                  // every block's tile is complete

  // this block's share of the tile's elements: the cluster's partial
  // tiles added in rank order, stored with the bias at their columns
  const int E = BM * NB, e0 = part * E / parts, e1 = (part + 1) * E / parts;
  for (int e = e0 + tid; e < e1; e += kThreads) {
    const int r = e / NB, i = e % NB, b = b0 + r;
    if (b >= B || i >= Fg) continue;
    const int col = scol[g * Fg + i];
    if (col < 0 || col >= cout) continue;
    float s = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float* tile = cluster.map_shared_rank(red, p);
      s = p == 0 ? tile[e] : s + tile[e];
    }
    out[(size_t)b * cout + col] = s + bs[col];
  }
  // the columns no slot reaches (pruned filters) get exact zeros, from the
  // first group's first part
  if (g == 0 && part == 0) {
    for (int o = tid; o < cout; o += kThreads) mark[o] = 0;
    __syncthreads();
    for (int i = tid; i < L * Fg; i += kThreads) {
      const int col = scol[i];
      if (col >= 0 && col < cout) mark[col] = 1;
    }
    __syncthreads();
    for (int i = tid; i < BM * cout; i += kThreads) {
      const int r = i / cout, o = i % cout;
      if (b0 + r < B && !mark[o]) out[(size_t)(b0 + r) * cout + o] = 0.f;
    }
  }
  cluster.sync();                  // keep this tile alive for the cluster
}

template <int WM>
cudaError_t launch(dim3 grid, int parts, size_t smem, cudaStream_t stream,
                   const float* ring, const int* head, const float* wp,
                   const int* taps, const int* slot_col, const float* bias,
                   float* out, int S, int K, int V, int C, int L, int n_keep,
                   int Fg, int cout, int vec_x, int vec_w) {
  static int limit[kMaxDevices];
  auto kern = step_kernel<WM>;
  cudaError_t err = allow_smem((const void*)kern, smem, limit);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = parts;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, ring, head, wp, taps, slot_col, bias,
                           out, S, K, V, C, L, n_keep, Fg, cout, vec_x,
                           vec_w);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// wm: 16-row tiles per block (1, 2 or 4); parts: blocks of a cluster that
// share one tile's contraction (1, 2, 4 or 8); kernels/cavity_tconv.py:
// step_plan picks them.
extern "C" int cavity_tconv_step_f32(const void* ring, const void* head,
                                     const void* wp, const void* taps,
                                     const void* slot_col, const void* bias,
                                     void* out, int S, int K, int V, int C,
                                     int L, int n_keep, int Fg, int cout,
                                     int wm, int parts, void* stream) {
  if (S <= 0 || K <= 0 || V <= 0 || C <= 0 || L <= 0 || L > 65535 ||
      n_keep <= 0 || n_keep > kMaxKeep || Fg <= 0 || Fg > 8 * kMaxNT ||
      cout <= 0 || (wm != 1 && wm != 2 && wm != 4) ||
      (parts != 1 && parts != 2 && parts != 4 && parts != 8) ||
      parts > n_keep * ((C + 7) / 8))
    return (int)cudaErrorInvalidValue;
  const int NS = n_keep * ((C + 7) / 8);
  const int qwm = (NS + parts - 1) / parts * 8;
  const size_t smem =
      sizeof(float) *
      (size_t)step_smem_words(wm, qwm, up8(Fg), n_keep, L * Fg, cout);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long B = (long long)S * V;
  const long long gx = (B + 16 * wm - 1) / (16 * wm);
  if (gx > 0x7fffffffLL || (long long)S * K * V > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int vec_x = (C % 4 == 0 && reinterpret_cast<size_t>(ring) % 16 == 0);
  const int vec_w = (Fg % 4 == 0 && reinterpret_cast<size_t>(wp) % 16 == 0);
  const dim3 grid((unsigned)gx, L, parts);
  const cudaStream_t s = (cudaStream_t)stream;
  const float *rf = (const float*)ring, *wf = (const float*)wp;
  const float* bf = (const float*)bias;
  const int *hi = (const int*)head, *ti = (const int*)taps;
  const int* ci = (const int*)slot_col;
  float* of = (float*)out;
#define STEP_LAUNCH(WM)                                                     \
  return (int)launch<WM>(grid, parts, smem, s, rf, hi, wf, ti, ci, bf, of, S, \
                         K, V, C, L, n_keep, Fg, cout, vec_x, vec_w)
  if (wm == 1) STEP_LAUNCH(1);
  if (wm == 2) STEP_LAUNCH(2);
  STEP_LAUNCH(4);
#undef STEP_LAUNCH
}
