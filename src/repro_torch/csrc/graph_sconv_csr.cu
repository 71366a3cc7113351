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
// What bounds it on the H100.  Its work is 2*R*K*V*(D*Cin + Cin*Cout):
// the graph term shrinks from the dense kernel's V*V*Cin to V*D*Cin, the
// 1x1 product does not, so at the model's shapes (Cout >= 64) the 1x1
// product is most of the work.  On the 495 TFLOP/s TF32 tensor cores the
// bytes (x read once, out written once at 3.35 TB/s) are the bound over a
// clip step; the 3-pass split triples the tensor-core work, so the
// design's own floor is 3 * operations / 495 TFLOP/s; the gather, on the
// 67 TFLOP/s CUDA cores, adds its 2*R*K*V*D*Cin.
//
// Design: sconv_mma.cuh's kernel with the ELL graph stage.  The 1x1 stage
// is the dense kernel's TF32 mma.sync stage (3-pass, each chain of three
// MMAs flushed into float32); the gather stays on the CUDA cores in
// float32, slot by slot, and writes y straight into the A-operand hi/lo
// planes; a block stages only the idx/val rows of its own joints.  The
// tile comes from kernels/graph_sconv.py:csr_plan, the dense planner's
// rule with the ELL rows counted in shared memory: on clips one block
// owns every output channel, so y is formed once per row tile; at stream
// shapes (R <= 8) tiles go down to 16 joints x 8 channels so the grid
// reaches min(132, output tiles) blocks.
#include <cuda_runtime.h>

#include "sconv_mma.cuh"

// tile, rows, wt, xres: as graph_sconv_f32 (kernels/graph_sconv.py:
// csr_plan); idx (K, V, D) int32 with every index in [0, V)
extern "C" int graph_sconv_csr_f32(const void* x, const void* idx,
                                   const void* val, const void* w, void* out,
                                   int R, int V, int Cin, int Cout, int K,
                                   int D, int tile, int rows, int wt, int xres,
                                   void* stream) {
  return sconv_mma::sconv_launch<true>(
      (const float*)x, nullptr, (const int*)idx, (const float*)val,
      (const float*)w, (float*)out, R, V, Cin, Cout, K, D, tile, rows, wt,
      xres, (cudaStream_t)stream);
}
