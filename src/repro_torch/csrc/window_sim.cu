// Windowed similarity graph of adaptive streaming for Hopper (sm_90a), per
// slab slot s:
//     Th = sum_k ring_th[s, k],  Ph = sum_k ring_ph[s, k]        (V, Ce)
//     L[v, w] = Th[v] . Ph[w] / sqrt(Ce), or -1e30 where w >= valid
//     out[s, v, :] = softmax(L[v, :])
// and its step form, which first writes this frame's embeddings into the
// rings, out of place (the stream state keeps its old leaves):
//     new_ring[s] = ring[s] with row t[s] % K set to e[s] (zeros where
//     in_valid[s] is false) where has_input[s], else ring[s] copied,
// and sums the new rings.
//
// Replaces src/repro/kernels/window_sim.py:windowed_similarity_pallas (the
// TPU kernel that keeps the window sums and the logits in VMEM, one grid
// step per slot); the step form also takes the ring writes that
// core/agcn/engine.py:step_frame did with four elementwise launches.
//
// What bounds it on the H100: neither bytes nor operations.  A C_k stream
// tick reads 2*S*K*V*Ce floats (and the step form writes as many) and
// writes S*V*V (S = 8, K = 9, V = 25, Ce <= 64: under 2 MB, about half a
// microsecond at 3.35 TB/s) and does about 2*S*V*V*Ce operations, so a
// launch's time is its latency: the launch itself, the trips to memory and
// the barriers.
//
// Design, for latency:
//   - grid (chunks, S): a block owns `rows` joints of one slot (the planner
//     kernels/window_sim.py:sim_plan spreads a slot over several SMs).  It
//     sums all V rows of Phi, only its own rows of Theta, and in the step
//     form writes both new rings' rows of its own joints.
//   - all window loads in flight: a thread's entries (one row of 4
//     channels, a 16-byte access, where Ce % 4 == 0) are loaded for every
//     k, and in the step form the embedding too, before the first add:
//     one trip to memory, not one per entry.  K is a template parameter
//     for the path's K = 9 (a generic K walks the ring entry by entry).
//     The sums run in ring order k = 0..K-1, the plain version's order, so
//     they are bit-equal to it; the written row is the new one.
//   - one barrier: the sums go to shared memory (Theta in 16-byte rows, Phi
//     with an odd row stride Ce + 1, so 32 lanes on 32 columns hit 32
//     banks); then a warp owns a row v and a lane its columns w, w + 32,
//     ...: the dot, the mask, the row's max and sum by shuffles, expf and a
//     true division all in registers, and a coalesced store.  No V x V
//     buffer, no second barrier.  The masked columns get -1e30 before the
//     max, as in the TPU kernel, so rows past `valid` (a padded plan's
//     padded output joints) still get a softmax over the live columns.
//   - the dot is one FMA chain in channel order, not split into partial
//     sums: with it the graph keeps the rounding of this kernel's first
//     version bit for bit.  A C_k stream parts a slab-padded plan from its
//     narrow twin through rounding alone (other operations differ by an ulp
//     at the two widths, and the stream amplifies it); over a full agcn-2s
//     stream on the H100 that parting stayed at 6.8e-5 of the logits with
//     this order, and reached 1.7e-4 with a four-way split dot and with a
//     double-precision one.
//   - shared memory is at most 33 KB at V <= 128, Ce <= 64; the opt-in
//     above 48 KB runs once per device (tc::allow_smem), not per launch.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kRound = 2;       // entries a thread loads at once (K = 9)
constexpr int kMaxCols = 4;     // columns a lane owns: V <= 128
constexpr int kMaxV = 32 * kMaxCols;

struct SimArgs {
  const float* ring_th;
  const float* ring_ph;
  const float* e_th;            // step form only, as the four below
  const float* e_ph;
  const int* t;
  const unsigned char* has_input;
  const unsigned char* in_valid;
  float* new_th;
  float* new_ph;
  float* out;
  int K, V, Ce, valid, rows;
};

template <int VEC> struct Vec;
template <> struct Vec<4> { using T = float4; };
template <> struct Vec<1> { using T = float; };

__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vzero(float4& a) {
  a = make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void vzero(float& a) { a = 0.f; }

// Entry i of a block's walk: Phi rows 0..V-1 first, then Theta rows
// v0..v0+nrows-1, each W vectors of VEC channels.
struct Entry {
  bool th;
  int v, c;
};

__device__ __forceinline__ Entry entry(int i, int n_ph, int W, int v0) {
  Entry en;
  en.th = i >= n_ph;
  const int j = en.th ? i - n_ph : i;
  en.v = j / W;
  en.c = j - en.v * W;
  if (en.th) en.v += v0;
  return en;
}

// An entry's ring rows go to the new ring (step form) when it is one of
// the block's own joints: every Theta entry, Phi entries in [v0, v0 + nrows).
__device__ __forceinline__ float* new_ring(const SimArgs& a, const Entry& en,
                                           int v0, int nrows) {
  if (en.th) return a.new_th;
  return en.v >= v0 && en.v < v0 + nrows ? a.new_ph : nullptr;
}

// An entry's window sum to shared memory: Theta rows 16-byte aligned, Phi
// rows at the odd stride Ce + 1.
template <int VEC>
__device__ __forceinline__ void store_sum(const Entry& en,
                                          const typename Vec<VEC>::T& sum,
                                          int Ce, int v0, float* sth,
                                          float* sph) {
  if (en.th) {
    *reinterpret_cast<typename Vec<VEC>::T*>(sth + (en.v - v0) * Ce +
                                             en.c * VEC) = sum;
  } else {
    const float* f = reinterpret_cast<const float*>(&sum);
#pragma unroll
    for (int j = 0; j < VEC; ++j) sph[en.v * (Ce + 1) + en.c * VEC + j] = f[j];
  }
}

template <int KT, int VEC, bool kStep>
__global__ void __launch_bounds__(kMaxThreads)
window_sim_kernel(const SimArgs a) {
  using T = typename Vec<VEC>::T;
  extern __shared__ __align__(16) float smem[];
  const int K = KT > 0 ? KT : a.K;
  const int V = a.V, Ce = a.Ce, W = Ce / VEC;
  const int s = blockIdx.y;
  const int v0 = blockIdx.x * a.rows;
  const int nrows = min(a.rows, V - v0);
  float* sth = smem;                             // (rows, Ce)
  float* sph = smem + a.rows * Ce;               // (V, Ce + 1)
  const size_t plane = (size_t)V * Ce;
  const size_t slot = (size_t)s * K * plane;
  const size_t eslot = (size_t)s * plane;
  const int n_ph = V * W;
  const int n = n_ph + nrows * W;

  // the step form's flags, loaded beside the ring; the ring row they name
  // (r < 0: none) is first used once every ring load is in flight
  int tk = 0;
  bool has = false, live = false;
  if (kStep) {
    tk = a.t[s];
    has = a.has_input[s] != 0;
    live = a.in_valid[s] != 0;
  }
  auto ring_row = [&]() {
    const int m = tk % K;
    return has ? (m < 0 ? m + K : m) : -1;
  };

  if constexpr (KT > 0) {
    for (int base = 0; base < n; base += kRound * blockDim.x) {
      T x[kRound][KT];
      T ev[kRound];
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int i = base + q * blockDim.x + threadIdx.x;
        if (i < n) {
          const Entry en = entry(i, n_ph, W, v0);
          const size_t off = (size_t)en.v * Ce + (size_t)en.c * VEC;
          const T* src = reinterpret_cast<const T*>(
              (en.th ? a.ring_th : a.ring_ph) + slot + off);
#pragma unroll
          for (int k = 0; k < KT; ++k) x[q][k] = __ldg(src + k * plane / VEC);
          if (kStep)
            ev[q] = __ldg(reinterpret_cast<const T*>(
                (en.th ? a.e_th : a.e_ph) + eslot + off));
        }
      }
#pragma unroll
      for (int q = 0; q < kRound; ++q) {
        const int i = base + q * blockDim.x + threadIdx.x;
        if (i < n) {
          if (kStep) {
            const int r = ring_row();
            T z;
            vzero(z);
#pragma unroll
            for (int k = 0; k < KT; ++k)
              if (k == r) x[q][k] = live ? ev[q] : z;
          }
          const Entry en = entry(i, n_ph, W, v0);
          T sum = x[q][0];
#pragma unroll
          for (int k = 1; k < KT; ++k) vadd(sum, x[q][k]);   // ring order
          store_sum<VEC>(en, sum, Ce, v0, sth, sph);
          float* dst = kStep ? new_ring(a, en, v0, nrows) : nullptr;
          if (dst) {
            const size_t off = slot + (size_t)en.v * Ce + (size_t)en.c * VEC;
#pragma unroll
            for (int k = 0; k < KT; ++k)
              *reinterpret_cast<T*>(dst + off + k * plane) = x[q][k];
          }
        }
      }
    }
  } else {
    // a generic K: each entry's rows in turn
    const int r = kStep ? ring_row() : -1;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const Entry en = entry(i, n_ph, W, v0);
      const size_t off = (size_t)en.v * Ce + (size_t)en.c * VEC;
      const T* src = reinterpret_cast<const T*>(
          (en.th ? a.ring_th : a.ring_ph) + slot + off);
      float* dst = kStep ? new_ring(a, en, v0, nrows) : nullptr;
      T sum;
      vzero(sum);
      for (int k = 0; k < K; ++k) {
        T val = __ldg(src + k * plane / VEC);
        if (kStep && k == r) {
          if (live)
            val = __ldg(reinterpret_cast<const T*>(
                (en.th ? a.e_th : a.e_ph) + eslot + off));
          else
            vzero(val);
        }
        if (k == 0)
          sum = val;
        else
          vadd(sum, val);
        if (dst) *reinterpret_cast<T*>(dst + slot + off + k * plane) = val;
      }
      store_sum<VEC>(en, sum, Ce, v0, sth, sph);
    }
  }
  __syncthreads();

  // a warp a row, a lane its columns; everything in registers
  const float scale = sqrtf((float)Ce);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int lr = warp; lr < nrows; lr += nwarps) {
    const float* th = sth + lr * Ce;
    float lg[kMaxCols];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int w = lane + 32 * j;
      lg[j] = -INFINITY;                         // no column: out of the max
      if (w >= V) continue;
      if (w >= a.valid) {
        lg[j] = -1e30f;
        continue;
      }
      // one FMA chain in channel order (see the header)
      const float* ph = sph + w * (Ce + 1);
      float dot = 0.f;
      if constexpr (VEC == 4) {
        for (int e = 0; e < Ce; e += 4) {
          const float4 tv = *reinterpret_cast<const float4*>(th + e);
          dot = fmaf(tv.x, ph[e], dot);
          dot = fmaf(tv.y, ph[e + 1], dot);
          dot = fmaf(tv.z, ph[e + 2], dot);
          dot = fmaf(tv.w, ph[e + 3], dot);
        }
      } else {
        for (int e = 0; e < Ce; ++e) dot = fmaf(th[e], ph[e], dot);
      }
      lg[j] = dot / scale;
    }
    float m = lg[0];
#pragma unroll
    for (int j = 1; j < kMaxCols; ++j) m = fmaxf(m, lg[j]);
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      lg[j] = lane + 32 * j < V ? expf(lg[j] - m) : 0.f;
      sum += lg[j];
    }
#pragma unroll
    for (int o = 16; o > 0; o /= 2)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    float* og = a.out + ((size_t)s * V + v0 + lr) * V;
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j)
      if (lane + 32 * j < V) og[lane + 32 * j] = lg[j] / sum;
  }
}

template <int KT, int VEC, bool kStep>
cudaError_t launch(const SimArgs& a, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream) {
  static int limit[tc::kMaxDevices];
  auto kern = window_sim_kernel<KT, VEC, kStep>;
  cudaError_t err = tc::allow_smem((const void*)kern, smem, limit);
  if (err != cudaSuccess) return err;
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KT, int VEC>
cudaError_t launch_form(const SimArgs& a, bool step, dim3 grid, int threads,
                        size_t smem, cudaStream_t stream) {
  return step ? launch<KT, VEC, true>(a, grid, threads, smem, stream)
              : launch<KT, VEC, false>(a, grid, threads, smem, stream);
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

}  // namespace

// Both forms: the step form when e_th is not null (then e_ph, t (int32),
// has_input, in_valid (bool), new_th and new_ph must not be null either).
// The launch: grid (ceil(V / rows), S) of `threads` threads, from
// kernels/window_sim.py:sim_plan.
extern "C" int window_sim_f32(const void* ring_th, const void* ring_ph,
                              const void* e_th, const void* e_ph,
                              const void* t, const void* has_input,
                              const void* in_valid, void* new_th,
                              void* new_ph, void* out, int S, int K, int V,
                              int Ce, int valid, int rows, int threads,
                              void* stream) {
  const bool step = e_th != nullptr;
  if (S <= 0 || S > 65535 || K <= 0 || V <= 0 || V > kMaxV ||
      Ce <= 0 || valid < 1 || valid > V || rows < 1 || rows > V ||
      threads < 32 || threads > kMaxThreads || threads % 32)
    return (int)cudaErrorInvalidValue;
  if (step && !(e_ph && t && has_input && in_valid && new_th && new_ph))
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)rows * Ce +
                                       (size_t)V * (Ce + 1));
  if (smem > (size_t)tc::kMaxSmem) return (int)cudaErrorInvalidValue;
  SimArgs a{(const float*)ring_th, (const float*)ring_ph,
            (const float*)e_th, (const float*)e_ph, (const int*)t,
            (const unsigned char*)has_input,
            (const unsigned char*)in_valid, (float*)new_th, (float*)new_ph,
            (float*)out, K, V, Ce, valid, rows};
  const bool vec = Ce % 4 == 0 && aligned16(ring_th) && aligned16(ring_ph) &&
                   (!step || (aligned16(e_th) && aligned16(e_ph) &&
                              aligned16(new_th) && aligned16(new_ph)));
  const dim3 grid((V + rows - 1) / rows, S);
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (K == 9)
    err = vec ? launch_form<9, 4>(a, step, grid, threads, smem, st)
              : launch_form<9, 1>(a, step, grid, threads, smem, st);
  else
    err = vec ? launch_form<0, 4>(a, step, grid, threads, smem, st)
              : launch_form<0, 1>(a, step, grid, threads, smem, st);
  return (int)err;
}
