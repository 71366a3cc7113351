// RFC encode / decode for Hopper (sm_90a): the paper's runtime sparse
// feature format between blocks, with the block's epilogue fused into
// encode.
//
// Replaces src/repro/kernels/rfc_pack.py:rfc_encode_pallas and
// src/repro/kernels/rfc_pack.py:rfc_decode_pallas, which build a one-hot
// 16x16 permutation from a cumulative sum and contract with it on the MXU.
//
// The format: values (rows, C) float32, each 16-channel bank's hot values
// at its front in channel order and zeros behind, and bits (rows, C/16)
// int16, bit j of a bank's word set where its channel j is hot.  The TPU
// kernels keep a float mask beside the values; packed, the mask costs 2
// bytes a bank instead of 64.
//
// What bounds them on the H100: bytes.  Encode reads t and res and writes
// values and bits (12.125 bytes an element); decode reads values and bits
// and writes the dense activation (8.125).  Each does a few integer
// operations an element.
//
// Design: a thread owns 4 consecutive channels of one row, moved with one
// 16-byte access, so a bank is 4 neighbouring lanes (C % 16 == 0 keeps
// every bank inside an aligned group of 4).
//   encode: each lane takes fmaxf(t + res, 0) (rows outside `live` are 0)
//     and its 4 hot bits; two xor shuffles OR them into the bank's word.
//     Each hot channel j goes to slot popc(word & ((1 << j) - 1)) of the
//     bank's 16 floats in the warp's shared-memory stage, each lane zeroes
//     its own slots at or past popc(word); after __syncwarp a lane reads
//     its 4 slots back as one float4 and stores them.  The bank's first
//     lane stores the word.
//   decode: each lane stages its 4 values; after __syncwarp, channel j of
//     the bank reads slot popc(word & ((1 << j) - 1)) if bit j is set, else
//     0, and the lane stores its 4 channels as one float4.
// A gather by warp shuffles instead of the stage (4 shuffles for each
// output channel) was no faster (tools/rfc_lanes_bench.cu times it against
// this file's kernels).
//   The step form: a slot whose byte in `keep` is 0 copies its old values
//   and bits instead.  Every load is issued before the first is used (a
//   tick's launch waits one round trip, not three), so this form reads t,
//   res and the old leaves of every row.
// Index math is 32-bit (a 64-bit division is a long software sequence,
// which a launch of a few blocks at a stream tick waits on in full), so a
// call takes fewer than 2^31 quads.
// Pure data movement after the add and the max, so both are bit-exact
// against their plain versions.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ float comp(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__global__ void __launch_bounds__(kThreads)
rfc_encode_kernel(const float* __restrict__ t, const float* __restrict__ res,
                  const bool* __restrict__ live,
                  const bool* __restrict__ keep,
                  const float* __restrict__ old_vals,
                  const unsigned short* __restrict__ old_bits,
                  float* __restrict__ vals, unsigned short* __restrict__ bits,
                  unsigned quads, unsigned cq, unsigned V, unsigned slot_rows) {
  __shared__ float4 stage[kThreads];
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  const size_t e = 4 * (size_t)i;                // first element
  const int q = threadIdx.x & 3;                 // quad inside its bank
  const bool in = i < quads;
  const unsigned r = in && (live || keep) ? i / cq : 0;
  // every load is in flight before any is used: a stream tick launches a
  // few blocks, whose time is the round trips they wait on one after the
  // other (the step form reads t, res and the old leaves of every row)
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 v = zero, b = zero, old = zero;
  unsigned old_word = 0;
  bool emit = true, on = true;
  if (in) {
    v = *reinterpret_cast<const float4*>(t + e);
    if (res != nullptr) b = *reinterpret_cast<const float4*>(res + e);
    if (live != nullptr) on = live[r % V];
    if (keep != nullptr) {
      emit = keep[r / slot_rows];
      old = *reinterpret_cast<const float4*>(old_vals + e);
      old_word = old_bits[i >> 2];
    }
  }
  if (on) {
    v.x = fmaxf(v.x + b.x, 0.f); v.y = fmaxf(v.y + b.y, 0.f);
    v.z = fmaxf(v.z + b.z, 0.f); v.w = fmaxf(v.w + b.w, 0.f);
  } else {
    v = zero;
  }
  unsigned word = ((v.x > 0.f) | (v.y > 0.f) << 1 | (v.z > 0.f) << 2 |
                   (v.w > 0.f) << 3) << (4 * q);
  word |= __shfl_xor_sync(kFull, word, 1);
  word |= __shfl_xor_sync(kFull, word, 2);
  const int n_hot = __popc(word);
  float* bank = reinterpret_cast<float*>(stage + (threadIdx.x & ~3));
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * q + k;
    if ((word >> j) & 1u) bank[__popc(word & ((1u << j) - 1u))] = comp(v, k);
    if (j >= n_hot) bank[j] = 0.f;
  }
  __syncwarp();
  if (!in) return;
  const float4 out = emit ? stage[threadIdx.x] : old;
  if (!emit) word = old_word;
  *reinterpret_cast<float4*>(vals + e) = out;
  if (q == 0) bits[i >> 2] = (unsigned short)word;
}

__global__ void __launch_bounds__(kThreads)
rfc_decode_kernel(const float* __restrict__ vals,
                  const unsigned short* __restrict__ bits,
                  float* __restrict__ out, unsigned quads) {
  __shared__ float4 stage[kThreads];
  const unsigned i = blockIdx.x * kThreads + threadIdx.x;
  const size_t e = 4 * (size_t)i;
  const int q = threadIdx.x & 3;
  const bool in = i < quads;
  stage[threadIdx.x] = in ? *reinterpret_cast<const float4*>(vals + e)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned word = in ? bits[i >> 2] : 0u;
  __syncwarp();
  if (!in) return;
  const float* bank = reinterpret_cast<const float*>(stage + (threadIdx.x & ~3));
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * q + k;
    o[k] = ((word >> j) & 1u) ? bank[__popc(word & ((1u << j) - 1u))] : 0.f;
  }
  *reinterpret_cast<float4*>(out + e) = make_float4(o[0], o[1], o[2], o[3]);
}

int grid_for(long long quads, unsigned* blocks) {
  if (quads <= 0 || quads > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  *blocks = (unsigned)((quads + kThreads - 1) / kThreads);
  return 0;
}

}  // namespace

// t, res (or null), live (V bytes, or null), keep (rows / slot_rows
// bytes, or null), old_vals and old_bits (with keep), vals, bits; rows of
// C channels; V joints (row r is joint r % V, slot r / slot_rows).  All
// of t, res, the old leaves and the outputs are contiguous.
extern "C" int rfc_encode_f32(const void* t, const void* res, const void* live,
                              const void* keep, const void* old_vals,
                              const void* old_bits, void* vals, void* bits,
                              long long rows, int C, int V,
                              long long slot_rows, void* stream) {
  if (rows <= 0 || C <= 0 || C % 16 || V <= 0 || slot_rows <= 0 ||
      (keep && (!old_vals || !old_bits)))
    return (int)cudaErrorInvalidValue;
  const long long quads = rows * (C / 4);
  unsigned blocks;
  if (int err = grid_for(quads, &blocks)) return err;
  rfc_encode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)t, (const float*)res, (const bool*)live,
      (const bool*)keep, (const float*)old_vals,
      (const unsigned short*)old_bits, (float*)vals, (unsigned short*)bits,
      (unsigned)quads, (unsigned)(C / 4), (unsigned)V, (unsigned)slot_rows);
  return (int)cudaGetLastError();
}

// vals, bits, out; rows of C channels.
extern "C" int rfc_decode_f32(const void* vals, const void* bits, void* out,
                              long long rows, int C, void* stream) {
  if (rows <= 0 || C <= 0 || C % 16) return (int)cudaErrorInvalidValue;
  const long long quads = rows * (C / 4);
  unsigned blocks;
  if (int err = grid_for(quads, &blocks)) return err;
  rfc_decode_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)vals, (const unsigned short*)bits, (float*)out, quads);
  return (int)cudaGetLastError();
}
