// RFC encode / decode for Hopper (sm_90a): the paper's runtime sparse
// feature format between blocks, one 16-channel bank per half warp.
//
// Replaces src/repro/kernels/rfc_pack.py:rfc_encode_pallas and
// src/repro/kernels/rfc_pack.py:rfc_decode_pallas, which build a one-hot
// 16x16 permutation from a cumulative sum and contract with it on the MXU.
//
// What bounds them on the H100: bytes.  Encode reads x and writes values
// and hot (12 bytes per element), decode reads values and hot and writes
// out; each does a few integer operations per element.
//
// Design: one thread per element of the flat (rows, C) array, C % 16 == 0,
// so every aligned 16-lane half of a warp is one bank.  __ballot_sync
// gives the warp's hot bits; a lane's slot inside its bank is the popcount
// of the hot bits below it in its half.  Encode: hot lanes write their
// value to bank_base + slot, lanes at or past the bank's hot count write
// the zero tail, every lane writes its hot flag.  Decode: a hot lane reads
// bank_base + slot.  Pure data movement, so both are bit-exact.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned half_bits(unsigned ballot, int lane) {
  return (ballot >> (lane & 16)) & 0xFFFFu;
}

__global__ void __launch_bounds__(kThreads)
rfc_encode_kernel(const float* __restrict__ x, float* __restrict__ values,
                  float* __restrict__ hot, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int sub = lane & 15;
  const bool in = i < n;
  const float v = in ? fmaxf(x[i], 0.f) : 0.f;      // fused ReLU
  const bool h = v > 0.f;
  const unsigned bits = half_bits(__ballot_sync(0xFFFFFFFFu, h), lane);
  if (!in) return;
  const long long base = i - sub;
  if (h) values[base + __popc(bits & ((1u << sub) - 1u))] = v;
  if (sub >= __popc(bits)) values[i] = 0.f;
  hot[i] = h ? 1.f : 0.f;
}

__global__ void __launch_bounds__(kThreads)
rfc_decode_kernel(const float* __restrict__ values,
                  const float* __restrict__ hot, float* __restrict__ out,
                  long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int sub = lane & 15;
  const bool in = i < n;
  const bool h = in && hot[i] > 0.f;
  const unsigned bits = half_bits(__ballot_sync(0xFFFFFFFFu, h), lane);
  if (!in) return;
  out[i] = h ? values[i - sub + __popc(bits & ((1u << sub) - 1u))] : 0.f;
}

}  // namespace

extern "C" int rfc_encode_f32(const void* x, void* values, void* hot,
                              long long n, void* stream) {
  if (n <= 0 || n % 16) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  rfc_encode_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)values, (float*)hot, n);
  return (int)cudaGetLastError();
}

extern "C" int rfc_decode_f32(const void* values, const void* hot, void* out,
                              long long n, void* stream) {
  if (n <= 0 || n % 16) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  rfc_decode_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)values, (const float*)hot, (float*)out, n);
  return (int)cudaGetLastError();
}
