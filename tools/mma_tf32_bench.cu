// Latency and throughput of mma.sync.m16n8k8 with TF32 operands, the
// tensor-core instruction of csrc/graph_sconv.cu and csrc/cavity_tconv.cu.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o mma_tf32_bench \
//         tools/mma_tf32_bench.cu && ./mma_tf32_bench
//
// Each warp runs `chains` independent MMA chains for `iters` steps.  One
// warp with one chain gives the latency (cycles per step, clock64); enough
// warps and chains give the throughput (TFLOP/s over the whole grid, CUDA
// events).
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int CHAINS>
__global__ void bench(float* out, long long* cycles, int iters) {
  uint32_t a[4] = {threadIdx.x, 2u, 3u, 4u}, b[2] = {5u, threadIdx.x};
  float d[CHAINS][4] = {};
  const long long t0 = clock64();
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) mma(d[c], a, b);
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c) s += d[c][0] + d[c][1] + d[c][2] + d[c][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;   // keeps the chains live
  if (threadIdx.x == 0 && blockIdx.x == 0) *cycles = t1 - t0;
}

template <int CHAINS>
void run(int blocks, int threads, int iters) {
  float* out;
  long long* cycles;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  cudaMalloc(&cycles, sizeof(long long));
  bench<CHAINS><<<blocks, threads>>>(out, cycles, iters);   // warm-up
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  bench<CHAINS><<<blocks, threads>>>(out, cycles, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  long long c = 0;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaMemcpy(&c, cycles, sizeof(c), cudaMemcpyDeviceToHost);
  const double mmas = (double)blocks * (threads / 32) * iters * CHAINS;
  printf("chains %d, blocks %d x %d threads: %.1f cycles per chain step, "
         "%.1f TFLOP/s\n", CHAINS, blocks, threads, (double)c / iters,
         mmas * 2 * 16 * 8 * 8 / (ms * 1e-3) / 1e12);
  cudaFree(out);
  cudaFree(cycles);
}

int main() {
  run<1>(1, 32, 4096);        // latency
  run<4>(1, 32, 4096);
  run<4>(132, 128, 4096);     // throughput
  run<8>(132, 256, 4096);
  run<8>(132, 512, 4096);
  return 0;
}
