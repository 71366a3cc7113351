// Cavity-pruned temporal convolution, clip form, for Hopper (sm_90a):
//     out[b, t, g, f] = sum_j sum_c x[b, t*stride + taps[g, j], c]
//                                   * wp[g, j, c, f]
//
// Replaces src/repro/kernels/cavity_tconv.py:cavity_tconv_pallas.  Filter
// group g (of L = 8) holds the filters that share one kept-tap set, so each
// output sums only the group's n_keep taps instead of K = 9: the paper's
// C2 FLOP skip.
//
// What bounds it on the H100: float32 operations.  Each output needs
// n_keep*C FMAs against one read of x and one write of the output, so at
// the clip path's shapes (C = 64..256, n_keep = 3) the work,
// 2*B*T_out*C*(kept taps), takes longer at the 67 TFLOP/s CUDA-core rate
// than the bytes take at 3.35 TB/s.
//
// Design: one block per (row b = (n, joint), tile of 32 output steps).
// The block stages the x window its outputs read, (31*stride + K) x C, in
// shared memory (rows padded to C+1 floats so different tap rows fall in
// different banks).  Each work item is a register tile of 4 output steps x
// 4 filters of one group: per kept tap and input channel it loads 4 values
// of x and 4 packed weights and does 16 FMAs; neighbouring lanes take
// neighbouring step chunks of the same filters, so a warp's weight loads
// hit few cache lines.  Plain float32 FMAs, no tensor cores yet.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kTTile = 32;                        // output steps per block
constexpr int kTM = 4;                            // output steps per item
constexpr int kTF = 4;                            // filters per item

__global__ void __launch_bounds__(kThreads)
cavity_tconv_kernel(const float* __restrict__ x, const float* __restrict__ wp,
                    const int* __restrict__ taps, float* __restrict__ out,
                    int T_pad, int C, int L, int n_keep, int Fg, int T_out,
                    int stride, int ksize) {
  extern __shared__ float xs[];
  const int ldx = C + 1;
  const int b = blockIdx.x;
  const int t0 = blockIdx.y * kTTile;
  const int nt = min(kTTile, T_out - t0);
  const int row0 = t0 * stride;
  const int nrows = min((nt - 1) * stride + ksize, T_pad - row0);

  const float* xb = x + ((size_t)b * T_pad + row0) * C;
  for (int i = threadIdx.x; i < nrows * C; i += kThreads)
    xs[(i / C) * ldx + i % C] = xb[i];
  __syncthreads();

  const int nfc = (Fg + kTF - 1) / kTF;           // filter chunks per group
  const int ntc = (nt + kTM - 1) / kTM;           // step chunks in the tile
  float* ob = out + ((size_t)b * T_out + t0) * L * Fg;
  // lanes vary fastest over the step chunk, so the lanes of a warp share a
  // few (group, filter chunk) pairs and their packed-weight loads coalesce
  for (int item = threadIdx.x; item < ntc * L * nfc; item += kThreads) {
    const int ts = item % ntc * kTM;
    const int f0 = (item / ntc) % nfc * kTF;
    const int g = item / (ntc * nfc);
    float acc[kTM][kTF];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int q = 0; q < kTF; ++q) acc[i][q] = 0.f;
    for (int j = 0; j < n_keep; ++j) {
      const int off = taps[g * n_keep + j];
      if (off < 0 || off >= ksize) continue;      // taps outside [0, ksize)
      const float* wr = wp + (size_t)(g * n_keep + j) * C * Fg + f0;
      const float* xr = xs + (ts * stride + off) * ldx;
      for (int c = 0; c < C; ++c) {
        float wv[kTF], xv[kTM];
#pragma unroll
        for (int q = 0; q < kTF; ++q)
          wv[q] = (f0 + q < Fg) ? __ldg(wr + (size_t)c * Fg + q) : 0.f;
#pragma unroll
        for (int i = 0; i < kTM; ++i)
          xv[i] = (ts + i < nt) ? xr[i * stride * ldx + c] : 0.f;
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int q = 0; q < kTF; ++q) acc[i][q] = fmaf(xv[i], wv[q], acc[i][q]);
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (ts + i >= nt) continue;
#pragma unroll
      for (int q = 0; q < kTF; ++q)
        if (f0 + q < Fg) ob[((size_t)(ts + i) * L + g) * Fg + f0 + q] = acc[i][q];
    }
  }
}

}  // namespace

extern "C" int cavity_tconv_f32(const void* x, const void* wp,
                                const void* taps, void* out, int B, int T_pad,
                                int C, int L, int n_keep, int Fg, int T_out,
                                int stride, int ksize, void* stream) {
  if (B <= 0 || C <= 0 || L <= 0 || n_keep <= 0 || Fg <= 0 || T_out <= 0 ||
      stride <= 0 || ksize <= 0 || (T_out - 1) * stride + ksize > T_pad ||
      (T_out + kTTile - 1) / kTTile > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)((kTTile - 1) * stride + ksize) * (C + 1) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cavity_tconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, (T_out + kTTile - 1) / kTTile);
  cavity_tconv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)wp, (const int*)taps, (float*)out, T_pad,
      C, L, n_keep, Fg, T_out, stride, ksize);
  return (int)cudaGetLastError();
}
