// Sparse graph + 1x1 spatial conv for Hopper (sm_90a), over an ELL graph:
//     out[r, w, o] = sum_k sum_c (sum_d val[k, w, d] * x[r, idx[k, w, d], c])
//                                * W[k, c, o]
// Each output joint w has D neighbour slots per subset k (D = the largest
// row degree of the CSR graph); slots past a row's degree hold index 0 and
// value 0, and add nothing.
//
// Replaces src/repro/kernels/graph_sconv.py:graph_sconv_csr_pallas (the
// TPU kernel that runs D gather-accumulate sweeps per subset in VMEM, then
// the 1x1 product).
//
// What bounds it on the H100: float32 operations.  Its work is
// 2*R*K*V*(D*Cin + Cin*Cout): the graph term shrinks from the dense
// kernel's V*V*Cin to V*D*Cin, the 1x1 product does not, so at the model's
// shapes (Cout >= 64) the 1x1 product dominates and the sparse kernel can
// gain at most the graph term's share over the dense one (about 44% of the
// dense work at V = 50, Cout = 64 with D small; none at D = V).
//
// Design: graph_sconv.cu's, with the graph staged as its ELL arrays.  One
// block per (tile of rows, tile of 64 output channels) stages its rows of x
// and the K*V*D indices and values in shared memory; for each k it forms
// y = G_k . x in shared memory with D gather sweeps per (row, joint) and
// accumulates y . W_k in registers with sconv_tile.cuh's register tiling.
//   y: each work item owns one (row, joint) and 8 channels, strided by the
//      chunk count so neighbouring items read neighbouring channels of x;
//      per neighbour slot it reads the slot's index and value (the same
//      address for the items of one joint: a broadcast) and 8 values of x,
//      10 loads per 8 FMAs.  The graph term is the small one, so this stage
//      is kept simple.
// Plain float32 FMAs in a fixed order (slot by slot, then channel by
// channel), so the result matches the plain version to rounding.
#include <cuda_runtime.h>

#include "sconv_tile.cuh"

using namespace sconv;

namespace {

constexpr int kTC = 8;                         // y item: channels

__global__ void __launch_bounds__(kThreads)
graph_sconv_csr_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                       const float* __restrict__ val,
                       const float* __restrict__ w, float* __restrict__ out,
                       int R, int V, int Cin, int Cout, int K, int D,
                       int rows_per_block, int vec) {
  extern __shared__ float smem[];
  const int r0 = blockIdx.x * rows_per_block;
  const int nrows = min(rows_per_block, R - r0);
  const int M = nrows * V;                       // (row, joint) pairs here
  const int ldy = y_stride(rows_per_block * V);
  const int KVD = K * V * D;
  float* xs = smem;                              // (rows, V, Cin)
  float* ys = xs + rows_per_block * V * Cin;     // (Cin, ldy): y[c][r*V + w]
  float* vs = ys + Cin * ldy;                    // (K, V, D) values
  int* is = reinterpret_cast<int*>(vs + KVD);    // (K, V, D) indices

  const int tid = threadIdx.x;
  const float* xg = x + (size_t)r0 * V * Cin;
  for (int i = tid; i < M * Cin; i += kThreads) xs[i] = xg[i];
  for (int i = tid; i < KVD; i += kThreads) {
    vs[i] = val[i];
    is[i] = idx[i];
  }

  const int tn = tid % kLanesN;
  const int tm = tid / kLanesN;
  const int o0 = blockIdx.y * kCoTile + tn * kTN;
  const int ncc = (Cin + kTC - 1) / kTC;         // channel chunks (strided)

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < K; ++k) {
    __syncthreads();               // staging done / previous y consumed
    const int* ik = is + k * V * D;
    const float* vk = vs + k * V * D;
    // y = G_k . x_r: item = (row, joint, channel chunk)
    for (int item = tid; item < M * ncc; item += kThreads) {
      const int cc = item % ncc;
      const int wj = (item / ncc) % V;
      const int r = item / (ncc * V);
      const float* xr = xs + r * V * Cin;
      float s[kTC];
#pragma unroll
      for (int b = 0; b < kTC; ++b) s[b] = 0.f;
      for (int d = 0; d < D; ++d) {
        const int j = ik[wj * D + d];
        const float a = vk[wj * D + d];
        if ((unsigned)j >= (unsigned)V) continue;   // never in a packed graph
        const float* xj = xr + j * Cin;
#pragma unroll
        for (int b = 0; b < kTC; ++b) {
          const int c = cc + b * ncc;
          if (c < Cin) s[b] = fmaf(a, xj[c], s[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < kTC; ++b) {
        const int c = cc + b * ncc;
        if (c < Cin) ys[c * ldy + r * V + wj] = s[b];
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

size_t smem_bytes(int rows, int V, int Cin, int K, int D) {
  return sizeof(float) * ((size_t)rows * V * Cin +
                          (size_t)Cin * y_stride(rows * V)) +
         (sizeof(float) + sizeof(int)) * (size_t)K * V * D;
}

}  // namespace

extern "C" int graph_sconv_csr_f32(const void* x, const void* idx,
                                   const void* val, const void* w, void* out,
                                   int R, int V, int Cin, int Cout, int K,
                                   int D, void* stream) {
  if (R <= 0 || V <= 0 || Cin <= 0 || Cout <= 0 || K <= 0 || D <= 0 ||
      V > kMaxM)
    return (int)cudaErrorInvalidValue;
  int rows = kMaxM / V;
  if (rows > R) rows = R;
  while (rows > 1 && smem_bytes(rows, V, Cin, K, D) > (size_t)kSmemBudget)
    --rows;
  const size_t smem = smem_bytes(rows, V, Cin, K, D);
  if (smem > (size_t)kSmemBudget) return (int)cudaErrorInvalidValue;
  // float4 loads of W and stores of out need every row 16-byte aligned
  const int vec = (Cout % kTN == 0 &&
                   reinterpret_cast<size_t>(w) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0) ? 1 : 0;
  cudaError_t err = cudaFuncSetAttribute(
      graph_sconv_csr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((R + rows - 1) / rows, (Cout + kCoTile - 1) / kCoTile);
  graph_sconv_csr_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)idx, (const float*)val, (const float*)w,
      (float*)out, R, V, Cin, Cout, K, D, rows, vec);
  return (int)cudaGetLastError();
}
