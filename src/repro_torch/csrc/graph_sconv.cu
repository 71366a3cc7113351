// Fused graph + 1x1 spatial conv for Hopper (sm_90a):
//     out[r, w, o] = sum_k sum_c (sum_v G[k, w, v] * x[r, v, c]) * W[k, c, o]
//
// Replaces src/repro/kernels/graph_sconv.py:graph_sconv_pallas (the TPU
// kernel that keeps the G.x intermediate in VMEM).
//
// What bounds it on the H100: float32 operations.  Its work,
// 2*R*K*(V*V*Cin + V*Cin*Cout), takes longer at the card's 67 TFLOP/s
// CUDA-core rate than its bytes, x read once and out written once, take at
// 3.35 TB/s, in every block of the clip path but the first (block 0 of
// agcn-2s has Cin = 3 and is bound by the 2400*25*64*4 B = 15.4 MB it
// writes).
//
// Design: one block per (tile of rows, tile of 64 output channels).  The
// block stages its rows of x and all K graphs in shared memory; for each k
// it forms y = G_k . x for its rows in shared memory (the intermediate
// never goes to device memory, as on the TPU) and accumulates y . W_k in
// registers.  Both products are register-tiled so that each shared-memory
// load feeds several FMAs, the limit of a CUDA-core kernel:
//   y:   each work item computes a 5-joint x 4-channel tile of one row's
//        G_k . x_r, 9 loads per 20 FMAs;
//   out: the register-tiled y . W_k of sconv_tile.cuh, 9 loads per 32 FMAs.
// y is stored channel-major with an odd row stride, so neither its writes
// nor its reads conflict on shared-memory banks.  V = 25 is not padded;
// loops are bounded by V.  No tensor cores yet: the sums are plain float32
// FMAs, so results match the float32 einsums to rounding.
#include <cuda_runtime.h>

#include "sconv_tile.cuh"

using namespace sconv;

namespace {

constexpr int kTW = 5;                         // y tile: joints
constexpr int kTC = 4;                         // y tile: channels

__global__ void __launch_bounds__(kThreads)
graph_sconv_kernel(const float* __restrict__ x, const float* __restrict__ g,
                   const float* __restrict__ w, float* __restrict__ out,
                   int R, int V, int Cin, int Cout, int K, int rows_per_block,
                   int vec) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, R - r0);
  const int M = nrows * V;                       // (row, joint) pairs here
  const int ldy = y_stride(rows_per_block * V);
  float* xs = smem;                              // (rows, V, Cin)
  float* ys = xs + rows_per_block * V * Cin;     // (Cin, ldy): y[c][r*V + w]
  float* gs = ys + Cin * ldy;                    // (K, V, V)

  const int tid = threadIdx.x;
  const float* xg = x + (size_t)r0 * V * Cin;
  for (int i = tid; i < M * Cin; i += kThreads) xs[i] = xg[i];
  for (int i = tid; i < K * V * V; i += kThreads) gs[i] = g[i];

  const int tn = tid % kLanesN;
  const int tm = tid / kLanesN;
  const int o0 = blockIdx.y * kCoTile + tn * kTN;
  const int nwc = (V + kTW - 1) / kTW;           // joint chunks
  const int ncc = (Cin + kTC - 1) / kTC;         // channel chunks (strided)

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    __syncthreads();               // staging done / previous y consumed
    const float* gk = gs + k * V * V;
    // y = G_k . x_r: item = (row, joint chunk, channel chunk); a chunk's
    // channels are cc, cc + ncc, ... so neighbouring items read
    // neighbouring channels of xs
    for (int item = tid; item < nrows * nwc * ncc; item += kThreads) {
      const int cc = item % ncc;
      const int w0 = (item / ncc) % nwc * kTW;
      const int r = item / (ncc * nwc);
      const float* xr = xs + r * V * Cin;
      float s[kTW][kTC];
#pragma unroll
      for (int a = 0; a < kTW; ++a)
#pragma unroll
        for (int b = 0; b < kTC; ++b) s[a][b] = 0.f;
      for (int v = 0; v < V; ++v) {
        float gv[kTW], xv[kTC];
#pragma unroll
        for (int a = 0; a < kTW; ++a)
          gv[a] = (w0 + a < V) ? gk[(w0 + a) * V + v] : 0.f;
#pragma unroll
        for (int b = 0; b < kTC; ++b) {
          const int c = cc + b * ncc;
          xv[b] = (c < Cin) ? xr[v * Cin + c] : 0.f;
        }
#pragma unroll
        for (int a = 0; a < kTW; ++a)
#pragma unroll
          for (int b = 0; b < kTC; ++b) s[a][b] = fmaf(gv[a], xv[b], s[a][b]);
      }
#pragma unroll
      for (int a = 0; a < kTW; ++a)
#pragma unroll
        for (int b = 0; b < kTC; ++b) {
          const int c = cc + b * ncc;
          if (w0 + a < V && c < Cin) ys[c * ldy + r * V + w0 + a] = s[a][b];
        }
    }
    __syncthreads();
    // out += y . W_k over the thread's 8 x 4 tile
    if (o0 < Cout)
      accumulate_yw(acc, ys, ldy, w + (size_t)k * Cin * Cout + o0, Cin, Cout,
                    o0, tm, M, vec);
  }
  if (o0 < Cout) store_tile(acc, out, (size_t)r0 * V, Cout, o0, tm, M, vec);
}

size_t smem_bytes(int rows, int V, int Cin, int K) {
  return sizeof(float) * ((size_t)rows * V * Cin +
                          (size_t)Cin * y_stride(rows * V) + (size_t)K * V * V);
}

}  // namespace

extern "C" int graph_sconv_f32(const void* x, const void* g, const void* w,
                               void* out, int R, int V, int Cin, int Cout,
                               int K, void* stream) {
  if (R <= 0 || V <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || V > kMaxM)
    return (int)cudaErrorInvalidValue;
  int rows = kMaxM / V;
  if (rows > R) rows = R;
  while (rows > 1 && smem_bytes(rows, V, Cin, K) > (size_t)kSmemBudget) --rows;
  const size_t smem = smem_bytes(rows, V, Cin, K);
  if (smem > (size_t)kSmemBudget) return (int)cudaErrorInvalidValue;
  // float4 loads of W and stores of out need every row 16-byte aligned
  const int vec = (Cout % kTN == 0 &&
                   reinterpret_cast<size_t>(w) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0) ? 1 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      graph_sconv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + rows - 1) / rows, (Cout + kCoTile - 1) / kCoTile);
  graph_sconv_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)g, (const float*)w, (float*)out, R, V,
      Cin, Cout, K, rows, vec);
  return (int)cudaGetLastError();
}
