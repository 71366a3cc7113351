// Two ways to move a 16-channel RFC bank through 4 lanes of 4 channels,
// timed on one card: the shared-memory stage of the shipped kernels
// (src/repro_torch/csrc/rfc_pack.cu, included here and launched through
// its C entry points), and a gather by warp shuffles (each output slot j
// fetches the (j+1)-th hot channel of its bank from the lane that holds
// it, 4 shuffles a slot), which this file holds.
//
//     nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o rfc_lanes_bench \
//         tools/rfc_lanes_bench.cu && ./rfc_lanes_bench
//
// Encode computes fmaxf(t + res, 0), its bank words and the front-packed
// values; decode scatters them back.  Three variants: the shipped kernels
// through their C entry points (as the port calls them), the same kernels
// launched directly, and the shuffle gather.  Each is checked bit for bit
// against a host loop, then timed with CUDA events over 200 launches on
// the same buffers after a warm-up, behind a spin kernel that outlasts the
// host's time to queue them (so the events time device work only), at
// agcn-2s's clip shape (16 sequences x 150 frames x 25 joints at C = 64,
// and x 38 frames at C = 256) and its 8-slot stream tick (200 rows), in
// three rounds.  Prints microseconds a launch and the bytes the format
// moves a second.
#include "../src/repro_torch/csrc/rfc_pack.cu"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// position of the n-th (from 0) set bit of a 16-bit word: a 4-step search
__device__ __forceinline__ int nth_set(unsigned w, int n) {
  int pos = 0;
#pragma unroll
  for (int step = 8; step; step >>= 1) {
    const int c = __popc(w & ((1u << step) - 1u));
    if (n >= c) { n -= c; w >>= step; pos += step; }
  }
  return pos;
}

// the value of bank channel src, fetched from the lane (within the warp)
// and component that hold it
__device__ __forceinline__ float fetch(const float4& v, int src) {
  const int lane = ((threadIdx.x & 31) & ~3) + (src >> 2);
  const float a = __shfl_sync(kFull, v.x, lane), b = __shfl_sync(kFull, v.y, lane);
  const float c = __shfl_sync(kFull, v.z, lane), d = __shfl_sync(kFull, v.w, lane);
  const int k = src & 3;
  return k == 0 ? a : k == 1 ? b : k == 2 ? c : d;
}

__global__ void __launch_bounds__(kThreads)
encode_shfl(const float* __restrict__ t, const float* __restrict__ res,
            float* __restrict__ vals, unsigned short* __restrict__ bits,
            unsigned quads) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  const size_t e = 4 * (size_t)i;
  const int q = threadIdx.x & 3;
  const bool in = i < quads;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (in) {
    v = *reinterpret_cast<const float4*>(t + e);
    const float4 b = *reinterpret_cast<const float4*>(res + e);
    v.x = fmaxf(v.x + b.x, 0.f); v.y = fmaxf(v.y + b.y, 0.f);
    v.z = fmaxf(v.z + b.z, 0.f); v.w = fmaxf(v.w + b.w, 0.f);
  }
  unsigned word = ((v.x > 0.f) | (v.y > 0.f) << 1 | (v.z > 0.f) << 2 |
                   (v.w > 0.f) << 3) << (4 * q);
  word |= __shfl_xor_sync(kFull, word, 1);
  word |= __shfl_xor_sync(kFull, word, 2);
  const int n_hot = __popc(word);
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * q + k;
    const float s = fetch(v, j < n_hot ? nth_set(word, j) : 0);
    o[k] = j < n_hot ? s : 0.f;
  }
  if (!in) return;
  *reinterpret_cast<float4*>(vals + e) = make_float4(o[0], o[1], o[2], o[3]);
  if (q == 0) bits[i >> 2] = (unsigned short)word;
}

__global__ void __launch_bounds__(kThreads)
decode_shfl(const float* __restrict__ vals,
            const unsigned short* __restrict__ bits, float* __restrict__ out,
            unsigned quads) {
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  const size_t e = 4 * (size_t)i;
  const int q = threadIdx.x & 3;
  const bool in = i < quads;
  const float4 v = in ? *reinterpret_cast<const float4*>(vals + e)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned word = in ? bits[i >> 2] : 0u;
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * q + k;
    const float s = fetch(v, __popc(word & ((1u << j) - 1u)) & 15);
    o[k] = ((word >> j) & 1u) ? s : 0.f;
  }
  if (in)
    *reinterpret_cast<float4*>(out + e) = make_float4(o[0], o[1], o[2], o[3]);
}

// holds the device for `cycles` clock cycles
__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

long long g_spin_cycles = 0;   // 5 ms of the SM clock

#define CHECK(x)                                                         \
  do {                                                                   \
    cudaError_t e = (cudaError_t)(x);                                    \
    if (e != cudaSuccess) {                                              \
      std::fprintf(stderr, "%s: %s\n", #x, cudaGetErrorString(e));       \
      std::exit(1);                                                      \
    }                                                                    \
  } while (0)

template <typename F>
float time_us(F launch, int reps) {
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  launch();
  spin<<<1, 1>>>(g_spin_cycles);
  CHECK(cudaEventRecord(a));
  for (int r = 0; r < reps; ++r) launch();
  CHECK(cudaEventRecord(b));
  CHECK(cudaEventSynchronize(b));
  float ms;
  CHECK(cudaEventElapsedTime(&ms, a, b));
  CHECK(cudaGetLastError());
  return ms * 1e3f / reps;
}

bool run(const char* label, long long rows, int C) {
  const long long n = rows * C, quads = n / 4;
  const unsigned grid = (unsigned)((quads + kThreads - 1) / kThreads);
  std::vector<float> t(n), res(n);
  unsigned s = 12345u;
  for (long long k = 0; k < n; ++k) {   // about half the sums positive
    s = s * 1664525u + 1013904223u;
    t[k] = ((s >> 8) & 0xFFFF) / 32768.f - 1.f;
    s = s * 1664525u + 1013904223u;
    res[k] = ((s >> 8) & 0xFFFF) / 65536.f - 0.5f;
  }
  // the host's answer
  std::vector<float> want_v(n, 0.f), want_o(n, 0.f);
  std::vector<unsigned short> want_b(n / 16);
  for (long long bk = 0; bk < n / 16; ++bk) {
    unsigned w = 0;
    int slot = 0;
    for (int j = 0; j < 16; ++j) {
      const float x = std::fmax(t[bk * 16 + j] + res[bk * 16 + j], 0.f);
      if (x > 0.f) {
        w |= 1u << j;
        want_v[bk * 16 + slot++] = x;
        want_o[bk * 16 + j] = x;
      }
    }
    want_b[bk] = (unsigned short)w;
  }
  float *dt, *dr, *dv, *dout;
  unsigned short* db;
  CHECK(cudaMalloc(&dt, n * 4));
  CHECK(cudaMalloc(&dr, n * 4));
  CHECK(cudaMalloc(&dv, n * 4));
  CHECK(cudaMalloc(&dout, n * 4));
  CHECK(cudaMalloc(&db, n / 8));
  CHECK(cudaMemcpy(dt, t.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(dr, res.data(), n * 4, cudaMemcpyHostToDevice));
  bool ok = true;
  std::vector<float> got_v(n), got_o(n);
  std::vector<unsigned short> got_b(n / 16);
  const double enc_bytes = n * (12.0 + 2.0 / 16), dec_bytes = n * (8.0 + 2.0 / 16);
  const char* names[3] = {"stage", "stage-k", "shuffle"};
  for (int var = 0; var < 3; ++var) {
    auto enc = [&] {
      if (var == 2)
        encode_shfl<<<grid, kThreads>>>(dt, dr, dv, db, (unsigned)quads);
      else if (var == 1)
        rfc_encode_kernel<<<grid, kThreads>>>(
            dt, dr, nullptr, nullptr, nullptr, nullptr, dv, db,
            (unsigned)quads, (unsigned)(C / 4), 1u, (unsigned)rows);
      else
        CHECK(rfc_encode_f32(dt, dr, nullptr, nullptr, nullptr, nullptr, dv,
                             db, rows, C, 1, rows, nullptr));
    };
    auto dec = [&] {
      if (var == 2)
        decode_shfl<<<grid, kThreads>>>(dv, db, dout, (unsigned)quads);
      else if (var == 1)
        rfc_decode_kernel<<<grid, kThreads>>>(dv, db, dout, (unsigned)quads);
      else
        CHECK(rfc_decode_f32(dv, db, dout, rows, C, nullptr));
    };
    CHECK(cudaMemset(dv, 0xFF, n * 4));
    CHECK(cudaMemset(dout, 0xFF, n * 4));
    enc();
    dec();
    CHECK(cudaDeviceSynchronize());
    CHECK(cudaMemcpy(got_v.data(), dv, n * 4, cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(got_b.data(), db, n / 8, cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(got_o.data(), dout, n * 4, cudaMemcpyDeviceToHost));
    const bool same = !std::memcmp(got_v.data(), want_v.data(), n * 4) &&
                      !std::memcmp(got_b.data(), want_b.data(), n / 8) &&
                      !std::memcmp(got_o.data(), want_o.data(), n * 4);
    ok = ok && same;
    const float te = time_us(enc, 200), td = time_us(dec, 200);
    std::printf("%-26s %-7s encode %8.2f us (%7.1f GB/s)  decode %8.2f us "
                "(%7.1f GB/s)  %s\n", label, names[var], te,
                enc_bytes / te / 1e3, td, dec_bytes / td / 1e3,
                same ? "bit-equal" : "MISMATCH");
  }
  CHECK(cudaFree(dt));
  CHECK(cudaFree(dr));
  CHECK(cudaFree(dv));
  CHECK(cudaFree(dout));
  CHECK(cudaFree(db));
  return ok;
}

}  // namespace

int main() {
  cudaDeviceProp p;
  CHECK(cudaGetDeviceProperties(&p, 0));
  std::printf("device: %s\n", p.name);
  int khz;
  CHECK(cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0));
  g_spin_cycles = 5LL * khz;
  bool ok = true;
  for (int round = 0; round < 3; ++round) {
    std::printf("round %d\n", round + 1);
    ok = run("clip rows 60000, C 64", 16LL * 150 * 25, 64) && ok;
    ok = run("clip rows 15200, C 256", 16LL * 38 * 25, 256) && ok;
    ok = run("stream S=8 rows 200, C 64", 200, 64) && ok;
    ok = run("stream S=8 rows 200, C 256", 200, 256) && ok;
  }
  return ok ? 0 : 1;
}
