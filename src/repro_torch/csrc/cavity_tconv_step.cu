// Cavity-pruned temporal convolution, streaming form, for Hopper (sm_90a):
//     out[b, g, f] = sum_j sum_c x[b, taps[g, j], c] * wp[g, j, c, f]
//
// Replaces src/repro/kernels/cavity_tconv.py:cavity_tconv_step_pallas.  Each
// row b (one joint of one stream slot) holds a chronological K-frame window
// (oldest first); the kernel emits the one output step that window
// completes.  Filter group g (of L = 8) sums only its n_keep kept taps, so
// the frames of the pruned taps are never read: the paper's C2 skip.
//
// What bounds it on the H100: at the streaming shapes (B = S*25 rows with
// S = 1..8 slots, C <= 256, n_keep = 3, Fg = 4..32 filters a group) one
// launch moves under 3 MB and does under 0.1 GFLOP, about a microsecond
// of either at 3.35 TB/s and 67 TFLOP/s.  So little work leaves each block
// latency-bound: what matters is how many memory round trips lie on a
// thread's path and how many warps are in flight to hide them.
//
// Design: one block per (tile of kRows rows, filter group).  Per tile of
// channels the block stages the kept-tap frames of its rows in shared
// memory, channel-major ([tap][channel][row], rows padded to a multiple of
// 4, bank-free stores), and the group's packed weights of those channels,
// with kUnroll loads in flight per thread, so the staging costs a few
// memory round trips rather than one per channel.  An output item is 4
// rows x 1 filter: per kept tap and channel one float4 of x (a broadcast
// among the lanes that share its rows), one weight (lanes on neighbouring
// filters) and 4 FMAs, all from shared memory.
// A group has only 4*Fg items, so the block's 256 threads split each
// item's channel sum into ksplit interleaved parts and add the parts
// through shared memory at the end.  Plain float32 FMAs, no tensor cores.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;                         // rows per block
constexpr int kRM = 4;                            // rows per item
constexpr int kLdx = kRows + 4;                   // padded row stride of x
constexpr int kUnroll = 8;                        // staging loads in flight
constexpr int kMaxKeep = 16;

__global__ void __launch_bounds__(kThreads)
cavity_tconv_step_kernel(const float* __restrict__ x,
                         const float* __restrict__ wp,
                         const int* __restrict__ taps, float* __restrict__ out,
                         int B, int K, int C, int L, int n_keep, int Fg,
                         int ctile) {
  extern __shared__ float4 smem4[];               // 16-byte aligned
  float* xs = reinterpret_cast<float*>(smem4);    // [n_keep][ctile][kLdx]
  float* ws = xs + (size_t)n_keep * ctile * kLdx;  // [n_keep][ctile][Fg]
  float* red = ws + (size_t)n_keep * ctile * Fg;   // [ksplit][items][kRM]
  __shared__ int s_taps[kMaxKeep];
  const int b0 = blockIdx.x * kRows;
  const int g = blockIdx.y;
  const int nr = min(kRows, B - b0);
  if (threadIdx.x < n_keep) s_taps[threadIdx.x] = taps[g * n_keep + threadIdx.x];

  // item = (row group rg, filter f); part kp of ksplit takes channels
  // kp, kp + ksplit, ... of every kept tap
  const int items = (kRows / kRM) * Fg;
  const int ksplit = kThreads / items;
  const int item = threadIdx.x % items;
  const int kp = threadIdx.x / items;
  const int f = item % Fg;
  const int rg = item / Fg;
  const bool active = kp < ksplit && rg * kRM < nr;
  float acc[kRM] = {0.f, 0.f, 0.f, 0.f};
  __syncthreads();

  for (int c0 = 0; c0 < C; c0 += ctile) {
    const int ct = min(ctile, C - c0);
    // stage x: element i = (j * nw + cw) * kRows + r, so the 16 lanes of
    // a half-warp read one float4 of 16 rows and the two halves read the
    // two halves of a 32-byte sector (full sectors), and their shared
    // stores fall in 32 different banks; rows past B and taps outside
    // [0, K) stage as zeros
    const int nw = ct / 4;                        // float4s per frame row
    const int total = n_keep * nw * kRows;
    for (int base = threadIdx.x; base < total; base += kThreads * kUnroll) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        const int r = i % kRows;
        const int cw = (i / kRows) % nw;
        const int off = s_taps[min(i / (kRows * nw), n_keep - 1)];
        if (i < total && r < nr && off >= 0 && off < K) {
          v[u] = *reinterpret_cast<const float4*>(
              x + ((size_t)(b0 + r) * K + off) * C + c0 + cw * 4);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < total) {
          const int r = i % kRows;
          const int cw = (i / kRows) % nw;
          const int j = i / (kRows * nw);
          float* dst = xs + (j * ctile + cw * 4) * kLdx + r;
          dst[0] = v[u].x;
          dst[kLdx] = v[u].y;
          dst[2 * kLdx] = v[u].z;
          dst[3 * kLdx] = v[u].w;
        }
      }
    }
    // stage the group's packed weights of these channels: per kept tap
    // one contiguous run of ct * Fg floats
    const int wtotal = n_keep * ct * Fg;
    for (int base = threadIdx.x; base < wtotal; base += kThreads * kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        const int j = min(i / (ct * Fg), n_keep - 1);
        v[u] = i < wtotal ? __ldg(wp + ((size_t)(g * n_keep + j) * C + c0) * Fg
                                  + (i - j * ct * Fg))
                          : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = base + u * kThreads;
        if (i < wtotal) {
          const int j = i / (ct * Fg);
          ws[j * ctile * Fg + (i - j * ct * Fg)] = v[u];
        }
      }
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < n_keep; ++j) {
        const float* wr = ws + j * ctile * Fg + f;
        const float* xr = xs + j * ctile * kLdx + rg * kRM;
#pragma unroll 4
        for (int c = kp; c < ct; c += ksplit) {
          const float w = wr[c * Fg];
          const float4 xv = *reinterpret_cast<const float4*>(xr + c * kLdx);
          acc[0] = fmaf(xv.x, w, acc[0]);
          acc[1] = fmaf(xv.y, w, acc[1]);
          acc[2] = fmaf(xv.z, w, acc[2]);
          acc[3] = fmaf(xv.w, w, acc[3]);
        }
      }
    }
    __syncthreads();
  }

  // add the ksplit parts of each item in a fixed order
  if (kp < ksplit) {
#pragma unroll
    for (int q = 0; q < kRM; ++q) red[(kp * items + item) * kRM + q] = acc[q];
  }
  __syncthreads();
  if (kp != 0 || rg * kRM >= nr) return;
  for (int q = 0; q < kRM; ++q) {
    const int r = rg * kRM + q;
    if (r >= nr) break;
    float s = 0.f;
    for (int p = 0; p < ksplit; ++p) s += red[(p * items + item) * kRM + q];
    out[((size_t)(b0 + r) * L + g) * Fg + f] = s;
  }
}

int launch(const float* x, const float* wp, const int* taps, float* out,
           int B, int K, int C, int L, int n_keep, int Fg, cudaStream_t stream) {
  // channels per stage: all of C, halved (keeping a multiple of 4) while
  // the staged frames and weights need more than 96 KB
  const int items = (kRows / kRM) * Fg;
  const int ksplit = kThreads / items;
  int ctile = C;
  auto smem_of = [&](int ct) {
    return ((size_t)n_keep * ct * (kLdx + Fg) + (size_t)ksplit * items * kRM)
           * sizeof(float);
  };
  while (ctile > 8 && smem_of(ctile) > 96 * 1024)
    ctile = ((ctile + 1) / 2 + 3) / 4 * 4;
  const size_t smem = smem_of(ctile);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        cavity_tconv_step_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((B + kRows - 1) / kRows, L);
  cavity_tconv_step_kernel<<<grid, kThreads, smem, stream>>>(
      x, wp, taps, out, B, K, C, L, n_keep, Fg, ctile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int cavity_tconv_step_f32(const void* x, const void* wp,
                                     const void* taps, void* out, int B, int K,
                                     int C, int L, int n_keep, int Fg,
                                     void* stream) {
  // the float4 staging needs 16-byte aligned rows: C a multiple of 4 and
  // an aligned base (ops.cavity_tconv_step pads C and copies a misaligned x)
  if (B <= 0 || K <= 0 || C <= 0 || C % 4 != 0 ||
      reinterpret_cast<size_t>(x) % 16 != 0 || L <= 0 || L > 65535 ||
      n_keep <= 0 || n_keep > kMaxKeep || Fg <= 0 ||
      (kRows / kRM) * Fg > kThreads)
    return (int)cudaErrorInvalidValue;
  return launch((const float*)x, (const float*)wp, (const int*)taps,
                (float*)out, B, K, C, L, n_keep, Fg, (cudaStream_t)stream);
}
