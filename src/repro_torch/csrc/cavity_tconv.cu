// Cavity-pruned temporal convolution, clip form, for Hopper (sm_90a), on
// the tensor cores, reading the (N, T, V, C) activation in place:
//     out[n, t, v, f] = sum_j sum_c x[n, t*stride + taps[g, j] - pad, v, c]
//                                   * wp[g, j, c, i]      (f <-> slot (g, i))
// with x zero outside [0, T) ("same" padding), f the natural filter whose
// packed slot g*Fg + i is inv_perm[f], and f < F.
//
// Replaces src/repro/kernels/cavity_tconv.py:cavity_tconv_pallas.  Filter
// group g (of L = 8) holds the filters that share one kept-tap set, so each
// output sums only the group's n_keep taps instead of K = 9: the paper's
// C2 FLOP skip.
//
// What bounds it on the H100.  Each output needs n_keep*C multiply-adds
// against one read of x and one write of the output.  At the clip path's
// shapes (C = 64..256, n_keep = 3) that work outlasts the bytes at the 67
// TFLOP/s float32 rate, but not at the 495 TFLOP/s TF32 tensor-core rate,
// where the bytes at 3.35 TB/s are the bound.  The 3-pass split
// (tf32_mma.cuh) triples the tensor-core work, so this design's own floor,
// 3 * operations / 495 TFLOP/s, lies above the byte time: operations
// again.  Measured, latency holds it back: the tap loop's short MMA
// chains and per-visit fragment loads, and the chunk barriers.
//
// Design: an implicit GEMM per kept tap on TF32 mma.sync.m16n8k8 with
// 3-pass split operands.  M is a tile of 128 output (row b = (n, v), step
// t) pairs: nb rows x tt steps, chosen by the wrapper
// (kernels/cavity_tconv.py:tconv_plan) to waste the fewest pairs; N is 8
// groups x 8 filters of each (Fg is padded to 8 per group, in shared memory
// only, so a 16 x 8 MMA tile never straddles two groups' tap sets); the
// contraction is C, in chunks of 8 channels.  A pre-pass on the same
// stream splits the packed weights once per call and lays each block
// column's (group, kept tap) slices out chunk by chunk.  Per chunk,
// cp.async stages each row's x window ((tt-1)*stride + K steps, walked at
// stride V*C over t, zero-filled outside [0, T): the padding is a bound
// check, not a copy) and the chunk's split weights, double-buffered; the
// landed x is split in place into hi/lo planes.  Then, for each tap d that
// a group of the block keeps, a warp loads the A fragments of its 32 pairs
// shifted by d once and feeds them to every group that keeps d: under
// cav-70-1 each tap is kept by about 2.7 of the 8 groups, so the fragments
// are loaded once instead of per group.  The weights keep the
// (L, n_keep, C, Fg) packing the plain version and the streaming kernel
// take, rather than a repack by tap: a per-(group, tap) bit mask of the
// kept slots, built from `taps` in shared memory, picks each group's slice
// for tap d.  Each (tap, group) visit's MMAs go to a fresh fragment that is
// added to the float32 accumulators after it, since the tensor cores'
// accumulation truncates and would otherwise drift with C.  The store
// scatters each accumulator to its natural filter through inv_perm,
// inverted in shared memory, so the output is (N, T_out, V, F) in natural
// order.
// The previous design (float32 FMAs, 8 loads per 16 FMAs, weights read
// through __ldg per FMA) took (N*V, T_pad, C) rows: the engine transposed
// the activation, padded it, gathered the filters back by inv_perm and
// permuted the output, four whole-activation copies per block.
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

using namespace tc;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 2;                        // 16-pair MMA tiles per warp
constexpr int kWM = kMT * 16;                 // (row, step) pairs per warp
constexpr int kBM = kWarps * kWM;             // 128 (row, step) pairs
constexpr int kGB = 8;                        // groups per block
constexpr int kKC = 8;                        // channels per chunk
constexpr int kLdX = ld_a(kKC);               // 12: x planes, A operand
constexpr int kLdB = ld_b(8);                 // 8: weight planes, B operand

// shared memory in bytes; mirrored by kernels/cavity_tconv.py:_smem_bytes
inline size_t smem_bytes(int nb, int tt, int stride, int ksize, int n_keep) {
  const size_t xplane = (size_t)nb * ((tt - 1) * stride + ksize) * kLdX;
  const size_t bplane = (size_t)kGB * n_keep * kKC * kLdB;
  return 4 * (4 * xplane + 4 * bplane) + 4 * (kGB * ksize + kGB * 8 + 1);
}

// The pre-pass: every block column's (group, tap) weight slices, chunk by
// chunk, as the hi and lo planes a block stages with plain 16-byte copies:
// wsplit[yb][chunk][plane][g_local * n_keep + j][c_local][i_local], zero
// past L, C or Fg.  Weights are split once per call, not once per block.
__global__ void pack_split_weights(const float* __restrict__ wp,
                                   float* __restrict__ wsplit, int L,
                                   int n_keep, int C, int Fg, int nchunks,
                                   int nit, long long n) {
  const int bsz = kGB * n_keep * kKC * 8;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    const int q = (int)(e % bsz);
    const long long yc = e / bsz;                 // yb * nchunks + chunk
    const int chunk = (int)(yc % nchunks), yb = (int)(yc / nchunks);
    const int gj = q / (kKC * 8), cc = q / 8 % kKC, ii = q % 8;
    const int g = yb / nit * kGB + gj / n_keep, j = gj % n_keep;
    const int c = chunk * kKC + cc, i = yb % nit * 8 + ii;
    const float a = (g < L && c < C && i < Fg)
        ? wp[(((size_t)g * n_keep + j) * C + c) * Fg + i] : 0.f;
    split(a, wsplit[2 * yc * bsz + q], wsplit[(2 * yc + 1) * bsz + q]);
  }
}

// at least two blocks an SM (a cap of 128 registers for four spills)
__global__ void __launch_bounds__(kThreads, 2)
cavity_tconv_kernel(const float* __restrict__ x,
                    const float* __restrict__ wsplit,
                    const int* __restrict__ taps,
                    const long long* __restrict__ inv, float* __restrict__ out,
                    int N, int T, int V, int C, int L, int n_keep, int Fg,
                    int F, int T_out, int stride, int ksize, int pad, int tt,
                    int nb, int vec) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int B = N * V;
  const int ntt = (T_out + tt - 1) / tt;
  const int b0 = blockIdx.x / ntt * nb, t0 = blockIdx.x % ntt * tt;
  const int nbl = min(nb, B - b0), ntl = min(tt, T_out - t0);
  const int nit = (Fg + 7) / 8;
  const int g0 = blockIdx.y / nit * kGB, i0 = blockIdx.y % nit * 8;
  const int wrows = (tt - 1) * stride + ksize;          // window per row
  const int nchunks = (C + kKC - 1) / kKC;
  const int xplane = nb * wrows * kLdX;
  const int bplane = kGB * n_keep * kKC * kLdB;
  float* xs = smem;                                     // [buffer][hi, lo]
  float* bs = xs + 4 * xplane;                          // [buffer][hi, lo]
  int* jmask = reinterpret_cast<int*>(bs + 4 * bplane); // [group][tap]
  int* dest = jmask + kGB * ksize;                      // [group][filter]
  int* used = dest + kGB * 8;

  // jmask[gl][d]: bit j set when taps[g0 + gl][j] == d; used: bit d set
  // when a group of the block keeps tap d; dest[gl][ii]: the natural
  // filter of slot (g0 + gl, i0 + ii), or -1
  for (int i = tid; i < kGB * ksize; i += kThreads) jmask[i] = 0;
  for (int i = tid; i < kGB * 8; i += kThreads) dest[i] = -1;
  if (tid == 0) *used = 0;
  __syncthreads();
  for (int i = tid; i < kGB * n_keep; i += kThreads) {
    const int gl = i / n_keep, j = i % n_keep;
    if (g0 + gl >= L) continue;
    const int d = taps[(g0 + gl) * n_keep + j];
    if (d < 0 || d >= ksize) continue;        // taps outside the kernel
    atomicOr(&jmask[gl * ksize + d], 1 << j);
    atomicOr(used, 1 << d);
  }
  for (int f = tid; f < F; f += kThreads) {
    const long long s = inv[f];
    const int g = (int)(s / Fg), i = (int)(s % Fg);
    if (g >= g0 && g < g0 + kGB && i >= i0 && i < i0 + 8)
      dest[(g - g0) * 8 + i - i0] = f;
  }

  // stage chunk `chunk` (channels c0..c0+8) into buffer chunk & 1
  auto issue = [&](int chunk) {
    const int c0 = chunk * kKC;
    float* xb = xs + (chunk & 1) * 2 * xplane;
    // (row, window step) = (bl, rr) of window row bl * wrows + rr
    if (vec) {                  // C % 4 == 0, x 16-byte aligned
      walk(nb * wrows, 2, wrows, tid, kThreads, [&](int row, int half, int bl,
                                                    int rr) {
        const int tin = t0 * stride - pad + rr, c = c0 + 4 * half, b = b0 + bl;
        const bool ok = bl < nbl && tin >= 0 && tin < T && c < C;
        cp_async16(xb + row * kLdX + 4 * half,
                   ok ? x + (((size_t)(b / V) * T + tin) * V + b % V) * C + c
                      : x, ok ? 16 : 0);
      });
    } else {
      walk(nb * wrows, kKC, wrows, tid, kThreads, [&](int row, int cc, int bl,
                                                      int rr) {
        const int tin = t0 * stride - pad + rr, c = c0 + cc, b = b0 + bl;
        const bool ok = bl < nbl && tin >= 0 && tin < T && c < C;
        cp_async4(xb + row * kLdX + cc,
                  ok ? x + (((size_t)(b / V) * T + tin) * V + b % V) * C + c
                     : x, ok);
      });
    }
    // this block column's chunk of split weights: hi and lo planes, one
    // contiguous run in wsplit and in shared memory
    float* bb = bs + (chunk & 1) * 2 * bplane;
    const float* src = wsplit + ((size_t)blockIdx.y * nchunks + chunk) * 2 * bplane;
    for (int i = tid; i < bplane / 2; i += kThreads)
      cp_async16(bb + 4 * i, src + 4 * i, 16);
    cp_async_commit();
  };

  // smem offset of the window row of each fragment row, before the tap
  // shift; rows past the tile read row 0 and are not stored
  int roff[kMT][2];
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp * kWM + a * 16 + gq + 8 * h, bl = m / tt, tl = m % tt;
      roff[a][h] = (bl < nbl && tl < ntl) ? (bl * wrows + tl * stride) * kLdX
                                          : 0;
    }
  const bool live = warp * kWM < nbl * tt;
  float acc[kMT][kGB][4];
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int gl = 0; gl < kGB; ++gl)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][gl][e] = 0.f;

  issue(0);
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    float* xh = xs + (chunk & 1) * 2 * xplane;
    float* bh = bs + (chunk & 1) * 2 * bplane;
    cp_async_wait_all();
    __syncthreads();           // chunk landed; the other buffer is free
    if (chunk + 1 < nchunks) issue(chunk + 1);
    split_tile<kKC>(xh, xh + xplane, nb * wrows, kLdX, tid, kThreads);
    __syncthreads();
    if (!live) continue;
    const int um = *used;
    for (int d = 0; d < ksize; ++d) {
      if (!(um >> d & 1)) continue;
      // this tap's A fragments, shared by every group that keeps it
      uint32_t ah[kMT][4], al[kMT][4];
#pragma unroll
      for (int a = 0; a < kMT; ++a) {
        const float* p0 = xh + roff[a][0] + d * kLdX + tq;
        const float* p1 = xh + roff[a][1] + d * kLdX + tq;
        ah[a][0] = lds(p0);
        ah[a][1] = lds(p1);
        ah[a][2] = lds(p0 + 4);
        ah[a][3] = lds(p1 + 4);
        al[a][0] = lds(p0 + xplane);
        al[a][1] = lds(p1 + xplane);
        al[a][2] = lds(p0 + xplane + 4);
        al[a][3] = lds(p1 + xplane + 4);
      }
#pragma unroll
      for (int gl = 0; gl < kGB; ++gl) {
        for (int jm = jmask[gl * ksize + d]; jm; jm &= jm - 1) {
          const float* bp = bh + (gl * n_keep + __ffs(jm) - 1) * kKC * kLdB;
          uint32_t b_h[2], b_l[2];
          load_b(b_h, bp, kLdB, 0, 0, gq, tq);
          load_b(b_l, bp + bplane, kLdB, 0, 0, gq, tq);
          // each (tap, group) visit's 3 passes go to fresh fragments,
          // added to acc in float32: the tensor cores' accumulation
          // truncates, so a fragment that took every visit's MMAs (3 x
          // kept taps x C/8) would drift by that many ulps of the output
#pragma unroll
          for (int a = 0; a < kMT; ++a)
            mma3_add(acc[a][gl], ah[a], al[a], b_h, b_l);
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int a = 0; a < kMT; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp * kWM + a * 16 + gq + 8 * h, bl = m / tt, tl = m % tt;
      if (bl >= nbl || tl >= ntl) continue;
      const int b = b0 + bl;
      float* orow = out + (((size_t)(b / V) * T_out + t0 + tl) * V + b % V) * F;
#pragma unroll
      for (int gl = 0; gl < kGB; ++gl)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = dest[gl * 8 + 2 * tq + e];
          if (f >= 0) orow[f] = acc[a][gl][2 * h + e];
        }
    }
}

int smem_limit[kMaxDevices];

}  // namespace

// tt x nb: output steps x rows (n, v) of a block's 128-pair tile.
// scratch: 2 * ceil(L/8) * ceil(Fg/8) * ceil(C/8) * 8 * n_keep * 64 floats,
// 16-byte aligned, for the split weights the pre-pass lays out
// (kernels/cavity_tconv.py allocates it).
extern "C" int cavity_tconv_f32(const void* x, const void* wp,
                                const void* taps, const void* inv_perm,
                                void* out, void* scratch, int N, int T, int V,
                                int C, int L, int n_keep, int Fg, int F,
                                int T_out, int stride, int ksize, int pad,
                                int tt, int nb, void* stream) {
  if (N <= 0 || T <= 0 || V <= 0 || C <= 0 || L <= 0 || n_keep <= 0 ||
      n_keep > 31 || Fg <= 0 || F <= 0 || F > L * Fg || T_out <= 0 ||
      stride <= 0 || ksize <= 0 || ksize > 31 || pad < 0 || tt <= 0 ||
      nb <= 0 || (long long)nb * tt > kBM ||
      reinterpret_cast<size_t>(scratch) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(nb, tt, stride, ksize, n_keep);
  const long long gx = (long long)((N * V + nb - 1) / nb) * ((T_out + tt - 1) / tt);
  const int nit = (Fg + 7) / 8, nchunks = (C + kKC - 1) / kKC;
  const long long gy = (long long)((L + kGB - 1) / kGB) * nit;
  if (smem > (size_t)kMaxSmem || gx > 0x7fffffffLL || gy > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const long long nsplit = gy * nchunks * kGB * n_keep * kKC * 8;
  const long long split_blocks = (nsplit + 255) / 256;
  pack_split_weights<<<(unsigned)(split_blocks < 4096 ? split_blocks : 4096),
                       256, 0, s>>>(
      (const float*)wp, (float*)scratch, L, n_keep, C, Fg, nchunks, nit,
      nsplit);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess)
    err = allow_smem((const void*)cavity_tconv_kernel, smem, smem_limit);
  if (err != cudaSuccess) return (int)err;
  const int vec = (C % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0);
  cavity_tconv_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, smem, s>>>(
      (const float*)x, (const float*)scratch, (const int*)taps,
      (const long long*)inv_perm, (float*)out, N, T, V, C, L, n_keep, Fg, F,
      T_out, stride, ksize, pad, tt, nb, vec);
  return (int)cudaGetLastError();
}
