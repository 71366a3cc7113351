// GQA decode attention over a float32 KV cache: the C entry point of the
// kernel in flash_decode.cuh (which documents it).
#include "flash_decode.cuh"

// splits: blocks of a cluster that share one (b, h)'s rows (1 to 16);
// warps per block (1, 2, 4 or 8); stages: ring slots per warp (2 to 6,
// so stages - 1 tiles of 16 rows in flight); vec: 16-byte staging, which
// needs D % 4 == 0 and 16-byte aligned k and v; window: 0, or a sliding
// window's length; lse: null, or the partial form's (B, Hkv, G)
// log-sum-exps, offset then being the shard's first slot of the cache;
// row_max: null (its bf16 form takes the rows' maxima there).
// kernels/flash_decode.py:decode_plan picks splits, warps and stages.
extern "C" int flash_decode_f32(const void* q, const void* k, const void* v,
                                const void* valid, void* out, void* lse,
                                const void* row_max, int B, int S, int Hkv,
                                int G, int D, int splits, int warps,
                                int stages, int vec, int window, int offset,
                                void* stream) {
  return entry<float>(q, k, v, valid, out, lse, row_max, B, S, Hkv, G, D,
                      splits, warps, stages, vec, window, offset, stream);
}
