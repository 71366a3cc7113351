// The tile shape and the second stage shared by the two spatial-conv
// kernels (graph_sconv.cu, dense graph; graph_sconv_csr.cu, ELL graph).
//
// A block owns a tile of rows and 64 output channels.  Its first stage,
// which differs between the kernels, leaves y = G_k . x for the block's
// (row, joint) pairs in shared memory, channel-major with an odd row stride
// (y[c * ldy + r * V + w]).  The second stage here accumulates y . W_k in
// registers: each thread owns 8 (row, joint) pairs x 4 output channels and,
// per input channel, loads one float4 of W_k and 8 values of y, 9 loads per
// 32 FMAs.
#pragma once

#include <cuda_runtime.h>

namespace sconv {

constexpr int kThreads = 256;
constexpr int kCoTile = 64;                    // output channels per block
constexpr int kTN = 4;                         // output channels per thread
constexpr int kLanesN = kCoTile / kTN;         // 16 threads across channels
constexpr int kLanesM = kThreads / kLanesN;    // 16 threads across (row, joint)
constexpr int kTM = 8;                         // (row, joint) pairs per thread
constexpr int kMaxM = kLanesM * kTM;           // 128 (row, joint) pairs / block
constexpr int kSmemBudget = 200 * 1024;        // dynamic shared memory cap

// odd stride of y's channel rows: writes and reads of neighbouring channels
// fall in different banks
__host__ __device__ inline int y_stride(int m) { return m | 1; }

// acc[i][j] += sum_c y[c][tm + i * kLanesM] * W_k[c][o0 + j]; wk points at
// W_k[0][o0].  vec: W's rows are 16-byte aligned and Cout % 4 == 0.
__device__ __forceinline__ void accumulate_yw(
    float (&acc)[kTM][kTN], const float* ys, int ldy,
    const float* __restrict__ wk, int Cin, int Cout, int o0, int tm, int M,
    int vec) {
  for (int c = 0; c < Cin; ++c) {
    float wv[kTN];
    if (vec) {
      const float4 q = __ldg(reinterpret_cast<const float4*>(wk + (size_t)c * Cout));
      wv[0] = q.x; wv[1] = q.y; wv[2] = q.z; wv[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        wv[j] = (o0 + j < Cout) ? __ldg(wk + (size_t)c * Cout + j) : 0.f;
    }
    const float* yc = ys + c * ldy + tm;
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      if (tm + i * kLanesM < M) {
        const float yv = yc[i * kLanesM];
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(yv, wv[j], acc[i][j]);
      }
    }
  }
}

// out[(row0 . V + pair), o0 + j] = acc[i][j] for the thread's valid pairs
__device__ __forceinline__ void store_tile(
    const float (&acc)[kTM][kTN], float* __restrict__ out, size_t pair0,
    int Cout, int o0, int tm, int M, int vec) {
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int rw = tm + i * kLanesM;
    if (rw >= M) continue;
    float* og = out + (pair0 + rw) * Cout + o0;
    if (vec) {
      *reinterpret_cast<float4*>(og) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        if (o0 + j < Cout) og[j] = acc[i][j];
    }
  }
}

}  // namespace sconv
