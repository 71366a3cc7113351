// GQA decode attention over a bfloat16 KV cache (float32 q and out): the
// C entry point of the kernel in flash_decode.cuh (which documents it and
// its bf16 rounding rules).  Compiled apart from the float32 entry so the
// two build in parallel.
#include "flash_decode.cuh"

// the arguments of flash_decode_f32, with 16-byte staging always (D % 8
// == 0 and 16-byte aligned k and v: 8 bf16 values a copy)
extern "C" int flash_decode_bf16(const void* q, const void* k,
                                 const void* v, const void* valid, void* out,
                                 int B, int S, int Hkv, int G, int D,
                                 int splits, int warps, int stages,
                                 int window, void* stream) {
  return entry<__nv_bfloat16>(q, k, v, valid, out, B, S, Hkv, G, D, splits,
                              warps, stages, 1, window, stream);
}
