// GQA decode attention for Hopper (sm_90a): one query token per
// (batch b, kv head h, group member g) against a KV cache,
//     out[b,h,g,:] = sum_{s<valid} softmax_s(q[b,h,g,:].k[b,s,h,:] / sqrt(D))
//                    * v[b,s,h,:]
// with cache slots s >= valid given -1e30 before the max (as the TPU kernel
// does), float32 statistics and accumulators, and a final division by
// max(l, 1e-20).
//
// Replaces src/repro/kernels/flash_decode.py:flash_decode_pallas (the TPU
// kernel that streams 512-row KV blocks through VMEM with the running
// max, sum and accumulator in scratch, one sequential grid step per block).
//
// What bounds it on the H100: bytes.  Each launch reads the K and V rows
// the softmax needs once (2 * B * valid * Hkv * D floats) and does about
// 4 * G flops per float read; at G = 3 to 4 that is far below the card's
// float32 rate per byte, so its floor is the cache read at 3.35 TB/s.
//
// Design (right and simple first): one block of 256 threads per (b, h).
// It loads the group's G query rows into shared memory once and walks the
// first n = valid cache rows (all S when valid <= 0, where every row is
// masked and weighs the same, as in the TPU kernel; rows past valid >= 1
// get probability exactly 0 and are not read) in tiles of 64 rows, two
// tiles in flight:
//   1. stage: every thread issues cp.async copies of some elements of the
//      next K and V tile into the other shared-memory buffer (rows spread
//      over the warps, lanes over D, so any D <= 128 and neighbouring
//      addresses), with an odd row stride D + 1; rows past the cache's
//      end are zero-filled.  Then it waits for the current tile only, so
//      the next tile's loads overlap this tile's arithmetic;
//   2. scores: each thread computes q_g . k_r for some (g, r) pairs, scaled,
//      -1e30 past valid and -inf past the tile's rows; the odd stride puts
//      a warp's 32 rows on 32 banks;
//   3. softmax: one warp per query row g updates the running max m_g,
//      rescales the running sum l_g and turns the tile's scores into
//      probabilities (warp shuffles for the max and the sum);
//   4. accumulate: each thread owns some (g, d) outputs in shared memory,
//      rescales them by exp(m_old - m_new) and adds the tile's p . v.
// The loop bound comes from `valid`, read from device memory, so a decode
// step never reads its position back to the host.  Split-S across blocks
// (flash-decoding), TMA staging and bf16 caches are later work: with
// B * Hkv blocks (20 at smollm-360m's batch 4) most SMs idle.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;
constexpr int kMaxD = 128;
constexpr int kSmemMax = 227 * 1024;
constexpr float kMasked = -1e30f;

size_t smem_bytes(int G, int D) {
  return sizeof(float) * ((size_t)4 * kTile * (D + 1) + (size_t)2 * G * D +
                          (size_t)G * kTile + 3 * (size_t)G);
}

// 4-byte asynchronous global -> shared copy; zero-fills when !live
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Queue the copies of rows [s0, s0 + rows) of K and V (row stride
// `row_stride` floats from `k`/`v`) into the (kTile, ld) buffers; rows
// from `rows` on are zero.
__device__ __forceinline__ void stage_tile(float* ks, float* vs,
                                           const float* k, const float* v,
                                           size_t row_stride, int s0,
                                           int rows, int D, int ld, int warp,
                                           int lane) {
  for (int r = warp; r < kTile; r += kWarps) {
    const bool live = r < rows;
    const size_t o = live ? (size_t)(s0 + r) * row_stride : 0;
    for (int d = lane; d < D; d += 32) {
      cp_async4(ks + r * ld + d, k + o + d, live);
      cp_async4(vs + r * ld + d, v + o + d, live);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const int* __restrict__ valid_ptr, float* __restrict__ out,
                    int S, int Hkv, int G, int D, float scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* kbuf = smem;                  // 2 x (kTile, ld)
  float* vbuf = kbuf + 2 * kTile * ld; // 2 x (kTile, ld)
  float* qs = vbuf + 2 * kTile * ld;   // (G, D)
  float* acc = qs + G * D;             // (G, D)
  float* sc = acc + G * D;             // (G, kTile) scores, then p
  float* m_run = sc + G * kTile;       // (G)
  float* l_run = m_run + G;            // (G)
  float* corr = l_run + G;             // (G)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row_stride = (size_t)Hkv * D;
  const size_t base = (size_t)b * S * row_stride + (size_t)h * D;
  const float* kb = k + base;
  const float* vb = v + base;
  const size_t qo = ((size_t)b * Hkv + h) * G * D;

  for (int i = tid; i < G * D; i += kThreads) {
    qs[i] = q[qo + i];
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_run[g] = kMasked;
    l_run[g] = 0.f;
  }
  const int valid = *valid_ptr;
  const int n = (valid >= 1 && valid < S) ? valid : S;
  stage_tile(kbuf, vbuf, kb, vb, row_stride, 0, min(kTile, n), D, ld, warp,
             lane);

  for (int t = 0, s0 = 0; s0 < n; ++t, s0 += kTile) {
    const int rows = min(kTile, n - s0);
    float* ks = kbuf + (t & 1) * kTile * ld;
    float* vs = vbuf + (t & 1) * kTile * ld;
    // 1. queue the next tile into the other buffer (freed by the barrier
    //    that ended the previous iteration), then wait for this one
    if (s0 + kTile < n) {
      stage_tile(kbuf + ((t + 1) & 1) * kTile * ld,
                 vbuf + ((t + 1) & 1) * kTile * ld, kb, vb, row_stride,
                 s0 + kTile, min(kTile, n - s0 - kTile), D, ld, warp, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // 2. scores
    for (int i = tid; i < G * kTile; i += kThreads) {
      const int g = i / kTile, r = i % kTile;
      float s = -INFINITY;
      if (r < rows) {
        const float* kr = ks + r * ld;
        const float* qg = qs + g * D;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qg[d], kr[d], dot);
        s = (s0 + r < valid) ? dot * scale : kMasked;
      }
      sc[i] = s;
    }
    __syncthreads();
    // 3. online softmax, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* row = sc + g * kTile;
      float mt = -INFINITY;
      for (int r = lane; r < kTile; r += 32) mt = fmaxf(mt, row[r]);
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_old = m_run[g];
      const float m_new = fmaxf(m_old, mt);
      float sum = 0.f;
      for (int r = lane; r < kTile; r += 32) {
        const float p = expf(row[r] - m_new);
        row[r] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[g] = c;
        l_run[g] = l_run[g] * c + sum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    // 4. rescale and accumulate p . v
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* p = sc + g * kTile;
      float a = 0.f;
      for (int r = 0; r < rows; ++r) a = fmaf(p[r], vs[r * ld + d], a);
      acc[i] = acc[i] * corr[g] + a;
    }
    __syncthreads();
  }

  for (int i = tid; i < G * D; i += kThreads)
    out[qo + i] = acc[i] / fmaxf(l_run[i / D], 1e-20f);
}

}  // namespace

extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* valid, void* out, int B, int S,
                                int Hkv, int G, int D, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || D <= 0 || D > kMaxD)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(G, D);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Hkv, B);
  flash_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const int*)valid,
      (float*)out, S, Hkv, G, D, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}
