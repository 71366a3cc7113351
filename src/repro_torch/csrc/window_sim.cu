// Windowed similarity graph of adaptive streaming for Hopper (sm_90a), per
// slab slot s:
//     Th = sum_k ring_th[s, k],  Ph = sum_k ring_ph[s, k]        (V, Ce)
//     L[v, w] = Th[v] . Ph[w] / sqrt(Ce), or -1e30 where w >= valid
//     out[s, v, :] = softmax(L[v, :])
//
// Replaces src/repro/kernels/window_sim.py:windowed_similarity_pallas (the
// TPU kernel that keeps the window sums and the logits in VMEM, one grid
// step per slot).
//
// What bounds it on the H100: neither bytes nor operations.  A stream tick
// reads 2*S*K*V*Ce floats and writes S*V*V (S = 8, K = 9, V = 25, Ce <= 64:
// under 1 MB, a fraction of a microsecond at 3.35 TB/s) and does about
// 2*S*V*V*Ce operations; one launch is far below a microsecond of either,
// so its time is its latency: one block per slot, the ring read once, three
// dependent phases separated by barriers.
//
// Design: one block of 256 threads per slot, everything in shared memory.
//   1. window sums: each thread sums the K ring rows of some (joint,
//      channel) entries of both rings, reading neighbouring addresses, in
//      ring order k = 0..K-1 (the plain version's order);
//   2. logits: each thread computes dot products of Th[v] with Ph[w] for
//      some (v, w); Th and Ph are stored with an odd row stride (Ce + 1) so
//      the 32 threads of a warp, on 32 different w, hit 32 banks;
//   3. row softmax: one warp per row, each lane over columns lane,
//      lane + 32, ...; the row's max and sum are reduced with shuffles.
// The masked columns get -1e30 before the max, as in the TPU kernel, so
// rows past `valid` (a padded plan's padded output joints) still get a
// softmax over the live columns.  expf and a true division keep the result
// within rounding of the plain version.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 227 * 1024;

__global__ void __launch_bounds__(kThreads)
window_sim_kernel(const float* __restrict__ ring_th,
                  const float* __restrict__ ring_ph, float* __restrict__ out,
                  int K, int V, int Ce, int valid) {
  extern __shared__ float smem[];
  const int ld = Ce + 1;
  float* th = smem;                              // (V, ld)
  float* ph = th + V * ld;                       // (V, ld)
  float* lg = ph + V * ld;                       // (V, V)
  const int tid = threadIdx.x;
  const size_t plane = (size_t)V * Ce;
  const float* rt = ring_th + (size_t)blockIdx.x * K * plane;
  const float* rp = ring_ph + (size_t)blockIdx.x * K * plane;

  for (int i = tid; i < V * Ce; i += kThreads) {
    float a = rt[i], b = rp[i];
    for (int k = 1; k < K; ++k) {
      a += rt[k * plane + i];
      b += rp[k * plane + i];
    }
    const int v = i / Ce, e = i % Ce;
    th[v * ld + e] = a;
    ph[v * ld + e] = b;
  }
  __syncthreads();

  const float scale = sqrtf((float)Ce);
  for (int i = tid; i < V * V; i += kThreads) {
    const int v = i / V, w = i % V;
    const float* tv = th + v * ld;
    const float* pw = ph + w * ld;
    float dot = 0.f;
    for (int e = 0; e < Ce; ++e) dot = fmaf(tv[e], pw[e], dot);
    lg[i] = (w < valid) ? dot / scale : -1e30f;
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  float* og = out + (size_t)blockIdx.x * V * V;
  for (int v = warp; v < V; v += kWarps) {
    float* row = lg + v * V;
    float m = -INFINITY;
    for (int w = lane; w < V; w += 32) m = fmaxf(m, row[w]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
    for (int w = lane; w < V; w += 32) {
      const float e = expf(row[w] - m);
      row[w] = e;
      sum += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    for (int w = lane; w < V; w += 32) og[v * V + w] = row[w] / sum;
  }
}

}  // namespace

extern "C" int window_sim_f32(const void* ring_th, const void* ring_ph,
                              void* out, int S, int K, int V, int Ce,
                              int valid, void* stream) {
  if (S <= 0 || K <= 0 || V <= 0 || Ce <= 0 || valid < 1 || valid > V)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)2 * V * (Ce + 1) +
                                       (size_t)V * V);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      window_sim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_sim_kernel<<<S, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)ring_th, (const float*)ring_ph, (float*)out, K, V, Ce,
      valid);
  return (int)cudaGetLastError();
}
