// Fused graph + 1x1 spatial conv for Hopper (sm_90a), on the tensor cores:
//     out[r, w, o] = sum_k sum_c (sum_v G[k, w, v] * x[r, v, c]) * W[k, c, o]
//
// Replaces src/repro/kernels/graph_sconv.py:graph_sconv_pallas (the TPU
// kernel that keeps the G.x intermediate in VMEM).
//
// What bounds it on the H100.  Its work, 2*R*K*(V*V*Cin + V*Cin*Cout),
// outlasts its bytes (x read once, out written once at 3.35 TB/s) at the
// 67 TFLOP/s float32 rate, but at the 495 TFLOP/s TF32 tensor-core rate the
// bytes are the bound over a clip step.  The 3-pass split (tf32_mma.cuh)
// triples the tensor-core work, so this design's own floor,
// 3 * operations / 495 TFLOP/s, lies above the byte time; the split is
// what keeps the result within 1e-4 of float32 (one TF32 pass misses it by
// 10x).  Measured, latency holds it back: the three barriers of each
// contraction chunk, the graph stage's short MMA chains, and mma.sync's
// own ceiling (about 310 of the 495 TFLOP/s, tools/mma_tf32_bench.cu).
//
// Design: sconv_mma.cuh's kernel with the dense graph stage: both
// products are TF32 mma.sync.m16n8k8 GEMMs with 3-pass split operands;
// the intermediate y = G_k . x stays in shared memory, as on the TPU.  The
// tile comes from kernels/graph_sconv.py:sconv_plan (the previous design,
// register-tiled float32 FMAs on CUDA cores with one block per 64 output
// channels, formed y ceil(Cout/64) times and lost to the plain two-einsum
// version on every path).
#include <cuda_runtime.h>

#include "sconv_mma.cuh"

// tile: index into kTiles; rows x wt: the (row, joint) pairs of a block,
// whole rows (wt = V) or 16-joint slices of one row (rows = 1); xres: the
// block keeps all of its x rows' channels in shared memory (else KC per
// chunk)
extern "C" int graph_sconv_f32(const void* x, const void* g, const void* w,
                               void* out, int R, int V, int Cin, int Cout,
                               int K, int tile, int rows, int wt, int xres,
                               void* stream) {
  return sconv_mma::sconv_launch<false>(
      (const float*)x, (const float*)g, nullptr, nullptr, (const float*)w,
      (float*)out, R, V, Cin, Cout, K, 0, tile, rows, wt, xres,
      (cudaStream_t)stream);
}
