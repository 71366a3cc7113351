// GQA decode attention over a bfloat16 KV cache (float32 q and out): the
// C entry point of the kernel in flash_decode.cuh (which documents it and
// its bf16 rounding rules).  Compiled apart from the float32 entry so the
// two build in parallel.
#include "flash_decode.cuh"

// the arguments of flash_decode_f32, with 16-byte staging always (D % 8
// == 0 and 16-byte aligned k and v: 8 bf16 values a copy); with lse, a
// null out is the max-only form (the rows' maxima over the shard to lse)
// and a non-null row_max (B, Hkv, G) the rows' maxima to round against
extern "C" int flash_decode_bf16(const void* q, const void* k,
                                 const void* v, const void* valid, void* out,
                                 void* lse, const void* row_max, int B,
                                 int S, int Hkv, int G, int D, int splits,
                                 int warps, int stages, int window,
                                 int offset, void* stream) {
  return entry<__nv_bfloat16>(q, k, v, valid, out, lse, row_max, B, S, Hkv,
                              G, D, splits, warps, stages, 1, window, offset,
                              stream);
}
