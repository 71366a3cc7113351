// Tensor-core helpers shared by the spatial convs (sconv_mma.cuh, dense
// and ELL) and the temporal convs (cavity_tconv.cu, cavity_tconv_step.cu):
// the 3-pass TF32 split, the m16n8k8 TF32 MMA, cp.async and the one-time
// shared-memory opt-in.
//
// Why three passes.  A TF32 operand keeps 10 of float32's 23 mantissa bits,
// so one TF32 product of model-scale operands is off by about 1e-3 against
// the float32 result, more than the 1e-4 to which the port holds every
// kernel against its plain version.  Each float32 operand a is split once,
// when it is staged in shared memory, into hi = tf32(a) and
// lo = tf32(a - hi); then a.b ~ a_hi.b_hi + a_hi.b_lo + a_lo.b_hi, the
// dropped a_lo.b_lo term being about 2^-22 of the product, and the sums are
// float32.  tests/test_torch_tensorcore.py emulates this on the CPU.
//
// Fragment layouts of mma.m16n8k8 with TF32 operands (PTX ISA), with
// gq = lane / 4 and tq = lane % 4:
//   A (16 x 8, row-major): a0 = A[gq][tq], a1 = A[gq+8][tq],
//                          a2 = A[gq][tq+4], a3 = A[gq+8][tq+4]
//   B (8 x 8, [k][n]):     b0 = B[tq][gq], b1 = B[tq+4][gq]
//   C (16 x 8):            c0 = C[gq][2tq], c1 = C[gq][2tq+1],
//                          c2 = C[gq+8][2tq], c3 = C[gq+8][2tq+1]
// Split operands live in two planes of one layout (hi, then lo).  An
// A-operand plane has a row stride of 4 mod 8 floats and a B-operand plane
// one of 8 or 24 mod 32, so the 32 lanes of a fragment load hit 32
// different banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

constexpr int kMaxSmem = 227 * 1024;     // a block's dynamic shared memory
constexpr int kMaxDevices = 64;

__host__ __device__ constexpr int up8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int up16(int n) { return (n + 15) / 16 * 16; }

// row stride (floats) of a B-operand plane n >= 1 columns wide: >= n, a
// multiple of 4 (16-byte rows for cp.async) and 8 or 24 mod 32
__host__ __device__ constexpr int ld_b(int n) {
  return up8(n) + (up8(n) % 16 == 0 ? 8 : 0);
}

// row stride of an A-operand plane k >= 1 columns wide: >= k, 4 mod 8
__host__ __device__ constexpr int ld_a(int k) { return up8(k) + 4; }

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

// a -> (hi, lo), both TF32 values held in float32
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  hi = __uint_as_float(to_tf32(a));
  lo = __uint_as_float(to_tf32(a - hi));
}

// split every element of a rows x COLS tile of plane hi (row stride ld) in
// place, writing the low parts to the same place in plane lo
template <int COLS>
__device__ __forceinline__ void split_tile(float* hi, float* lo, int rows,
                                           int ld, int tid, int nthreads) {
#pragma unroll 4
  for (int i = tid; i < rows * COLS; i += nthreads) {
    const int at = (i / COLS) * ld + i % COLS;
    float h, l;
    split(hi[at], h, l);
    hi[at] = h;
    lo[at] = l;
  }
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in three passes, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// acc += a.b: the three passes into a fresh fragment, then added to acc in
// float32.  The tensor cores' own accumulation truncates, so a fragment
// that took a long contraction's MMAs would drift by as many ulps of the
// result as it took MMAs; this keeps each fragment to three.
__device__ __forceinline__ void mma3_add(float (&acc)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4],
                                         const uint32_t (&bh)[2],
                                         const uint32_t (&bl)[2]) {
  float p[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(p, ah, al, bh, bl);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += p[e];
}

// call f(row, col, r, v) for this thread's cells of a rows x cols tile
// walked by nthreads threads in row-major order, with (r, v) = divmod(row,
// V), kept without a division per cell
template <typename F>
__device__ __forceinline__ void walk(int rows, int cols, int V, int tid,
                                     int nthreads, F&& f) {
  const int dr = nthreads / cols, dc = nthreads - dr * cols;
  int row = tid / cols, col = tid - row * cols;
  int r = row / V, v = row - r * V;
  while (row < rows) {
    f(row, col, r, v);
    int d = dr;
    col += dc;
    if (col >= cols) {
      col -= cols;
      ++d;
    }
    row += d;
    for (v += d; v >= V; v -= V) ++r;
  }
}

__device__ __forceinline__ uint32_t lds(const float* p) {
  return __float_as_uint(*p);
}

// A fragment of the 16 x 8 tile at row m0, column k0 of a plane
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const float* p,
                                       int ld, int m0, int k0, int gq,
                                       int tq) {
  const float* r = p + (m0 + gq) * ld + k0 + tq;
  a[0] = lds(r);
  a[1] = lds(r + 8 * ld);
  a[2] = lds(r + 4);
  a[3] = lds(r + 8 * ld + 4);
}

// B fragment of the 8 x 8 tile at row k0, column n0 of a [k][n] plane
__device__ __forceinline__ void load_b(uint32_t (&b)[2], const float* p,
                                       int ld, int k0, int n0, int gq,
                                       int tq) {
  const float* r = p + (k0 + tq) * ld + n0 + gq;
  b[0] = lds(r);
  b[1] = lds(r + 4 * ld);
}

// 4-byte and 16-byte asynchronous copies to shared memory; the bytes past
// src_bytes are zero-filled (src_bytes = 0 writes zeros, src unread)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Let func take `bytes` of dynamic shared memory on the current device.
// cudaFuncSetAttribute runs only when bytes exceed what an earlier call set
// there (limit[] holds that, per device), not on every launch.
inline cudaError_t allow_smem(const void* func, size_t bytes,
                              int (&limit)[kMaxDevices]) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && (size_t)limit[dev] >= bytes)
    return cudaSuccess;
  err = cudaFuncSetAttribute(func, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess && dev >= 0 && dev < kMaxDevices)
    limit[dev] = (int)bytes;
  return err;
}

}  // namespace tc
