// The fused graph + 1x1 spatial conv for Hopper (sm_90a), on the tensor
// cores, shared by the dense kernel (graph_sconv.cu) and the ELL one
// (graph_sconv_csr.cu) as one template whose graph stage is a
// compile-time policy (kEll):
//     out[r, w, o] = sum_k sum_c y_k[r, w, c] * W[k, c, o],
//     dense: y_k[r, w, c] = sum_v G[k, w, v] * x[r, v, c]
//     ELL:   y_k[r, w, c] = sum_d val[k, w, d] * x[r, idx[k, w, d], c]
//
// A block owns a tile of (row, joint) pairs and BN output channels:
// `rows` whole rows of V joints (or one row's joints w0..w0+wt, wt a
// multiple of 16, when the block tile is narrower than V) and output
// channels o0..o0+BN.  It walks the concatenated (k, c) contraction in
// chunks of KC input channels of one k:
//   - cp.async stages the block's x rows, with every channel once
//     (`xres`) or KC channels per chunk (when keeping them all would cost
//     the second block on an SM); the W_k tile (KC x BN), double-buffered
//     and issued a chunk ahead; and on the chunk that starts a k, the
//     graph rows of the block's joints: G_k's (dense) or the ELL's D
//     indices and values (the block's joints only, not all of K*V*D).
//     cp.async zero-fills wherever a tile overhangs R, V, Cin or Cout:
//     padding exists only in shared memory;
//   - each landed W tile (and, dense, x and G) is split once, in place,
//     into hi/lo planes (tf32_mma.cuh: the 3-pass TF32 split);
//   - graph stage, dense: one TF32 GEMM per row, Y[w, c] = G_k[w, :] .
//     X[:, c], M = the block's joints padded to 16, contraction V padded
//     to 8, N = the chunk's channels; ELL: float32 FMAs on the CUDA cores
//     in a fixed order (slot by slot), each (pair, 4 channels) item reading
//     x as it landed.  Either way the float32 y is split as it lands in
//     the y planes;
//   - 1x1 stage: acc[(r, w), o] += Y[(r, w), c] . W_k[c, o], each warp a
//     (16*MT) x (8*NT) tile of the block's (WM*16*MT) x (WN*8*NT) output,
//     one GEMM over the concatenated contraction accumulated in registers;
//     each 8-channel step's three MMAs go to a fresh fragment added in
//     float32, since the tensor cores' own accumulation truncates.
// The tile is chosen by the Python wrapper (kernels/graph_sconv.py,
// sconv_plan and csr_plan): at clip shapes one block owns all of Cout <=
// 256, so y is formed once per row tile; at stream shapes (R = 1..8 rows)
// it takes tiles as small as 16 joints x 8 channels so the grid reaches
// 132 blocks wherever the output has that many 16 x 8 tiles, recomputing
// the cheap y per block, with 64 channels a chunk and warps past the
// output tile's that share the staging, the splits and the graph stage.
#pragma once

#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace sconv_mma {

using namespace tc;

__host__ __device__ constexpr int up4(int n) { return (n + 3) / 4 * 4; }


// shared memory (in 4-byte words) of a block tile BM x BN over `rows`
// rows of wt joints and chunks of KC input channels, x resident (every
// channel) or one chunk at a time; D = 0 for the dense graph, else the ELL
// width; mirrored by kernels/graph_sconv.py:_smem_bytes
__host__ __device__ inline int smem_floats(int BM, int BN, int KC, int rows,
                                           int wt, int V, int Cin, int xres,
                                           int D) {
  const int xcols = ld_b(xres ? Cin : KC);
  const int graph = D == 0
      ? 2 * (rows * V + up8(V) - V) * xcols  // x: hi, lo (+ G's overhang)
            + 2 * up16(wt) * ld_a(V)         // G_k rows of the block's joints
      : rows * V * xcols                     // x as it is (float32 gather)
            + 2 * up4(wt * D);               // idx and val of those joints
  return graph + 2 * BM * ld_a(KC)           // y chunk: hi, lo
         + 4 * KC * ld_b(BN);                // W_k chunk: 2 buffers x hi, lo
}

// blocks of up to 256 threads keep to 128 registers so two fit an SM
template <int WM, int WN, int MT, int NT, int KC, int W, bool kEll>
__global__ void __launch_bounds__(W * 32, W <= 8 ? 2 : 1)
sconv_kernel(const float* __restrict__ x, const float* __restrict__ g,
             const int* __restrict__ idx, const float* __restrict__ val,
             const float* __restrict__ w, float* __restrict__ out, int R,
             int V, int Cin, int Cout, int K, int D, int rows, int wt,
             int vec, int xvec, int xres) {
  constexpr int kThreads = W * 32;       // warps past WM * WN only stage
  constexpr int BM = WM * MT * 16, BN = WN * NT * 8;
  constexpr int kLdW = ld_b(BN), kLdY = ld_a(KC);
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int vp = up8(V), ldg = ld_a(V), wt16 = up16(wt);
  const int njt = (V + wt - 1) / wt;               // joint tiles per row
  const int r0 = blockIdx.x / njt * rows, w0 = blockIdx.x % njt * wt;
  const int nrows = min(rows, R - r0), nj = min(wt, V - w0);
  const int npairs = (nrows - 1) * wt + nj;        // pair m = r * wt + joint
  const int o0 = blockIdx.y * BN;

  // x rows (r, v) sit at r * V + v, with every input channel (xres) or the
  // chunk's KC; the dense graph product reads vp rows from r * V, the ones
  // past V (the next row's, or zeros at the end) against G's zero columns
  const int xrows = kEll ? rows * V : rows * V + vp - V;
  const int xcols = xres ? up8(Cin) : KC;
  const int ldx = ld_b(xcols);
  const int xplane = xrows * ldx, gplane = wt16 * ldg, eplane = up4(wt * D);
  const int yplane = BM * kLdY, wplane = KC * kLdW;
  float* xs = smem;                       // dense: hi, lo; ELL: float32
  float* gs = xs + (kEll ? 1 : 2) * xplane;  // dense: G_k hi, lo
  float* es = gs;                         // ELL: the joints' values, indices
  int* eis = reinterpret_cast<int*>(es + eplane);
  float* ys = gs + (kEll ? 2 * eplane : 2 * gplane);   // hi, lo
  float* ws = ys + 2 * yplane;                     // [buffer][hi, lo]

  // pairs no chunk writes stay zero
  for (int i = tid; i < 2 * yplane; i += kThreads) ys[i] = 0.f;

  const int nc = (Cin + KC - 1) / KC, nchunks = K * nc;

  // W_k[c0..c0+KC, o0..o0+BN) of chunk j into the hi plane of buffer j & 1
  auto issue_w = [&](int j) {
    const int k = j / nc, c0 = j % nc * KC;
    float* wb = ws + (j & 1) * 2 * wplane;
    const float* wk = w + (size_t)k * Cin * Cout;
    if (vec) {                     // Cout % 4 == 0, W and out aligned
      for (int i = tid; i < KC * BN / 4; i += kThreads) {
        const int n = i % (BN / 4) * 4, c = i / (BN / 4);
        const bool ok = c0 + c < Cin && o0 + n < Cout;
        cp_async16(wb + c * kLdW + n,
                   ok ? wk + (size_t)(c0 + c) * Cout + o0 + n : w, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < KC * BN; i += kThreads) {
        const int n = i % BN, c = i / BN;
        const bool ok = c0 + c < Cin && o0 + n < Cout;
        cp_async4(wb + c * kLdW + n,
                  ok ? wk + (size_t)(c0 + c) * Cout + o0 + n : w, ok);
      }
    }
    cp_async_commit();
  };
  // x rows of the block, channels c0..c0+xcols (zero past R and Cin), into
  // the hi plane: every channel once (xres) or chunk j's KC per chunk
  auto issue_x = [&](int j) {
    const int c0 = xres ? 0 : j % nc * KC;
    if (xvec) {                    // Cin % 4 == 0, x 16-byte aligned
      walk(xrows, xcols / 4, V, tid, kThreads, [&](int row, int c, int r,
                                                   int v) {
        const bool ok = r < nrows && c0 + 4 * c < Cin;
        cp_async16(xs + row * ldx + 4 * c,
                   ok ? x + ((size_t)(r0 + r) * V + v) * Cin + c0 + 4 * c : x,
                   ok ? 16 : 0);
      });
    } else {
      walk(xrows, xcols, V, tid, kThreads, [&](int row, int c, int r, int v) {
        const bool ok = r < nrows && c0 + c < Cin;
        cp_async4(xs + row * ldx + c,
                  ok ? x + ((size_t)(r0 + r) * V + v) * Cin + c0 + c : x, ok);
      });
    }
  };
  // G_k's rows for the block's joints, or their ELL rows (index 0 and
  // value 0 past V), for chunk j that starts k
  auto issue_g = [&](int j) {
    if constexpr (kEll) {
      const size_t e0 = ((size_t)(j / nc) * V + w0) * D;
      const float* ik = reinterpret_cast<const float*>(idx) + e0;
      for (int i = tid; i < wt * D; i += kThreads) {
        const bool ok = w0 + i / D < V;
        cp_async4(es + i, ok ? val + e0 + i : val, ok);
        cp_async4(reinterpret_cast<float*>(eis) + i, ok ? ik + i : val, ok);
      }
    } else {
      const float* gk = g + (size_t)(j / nc) * V * V;
      walk(wt16, vp, wt16, tid, kThreads, [&](int jw, int v, int, int) {
        const bool ok = w0 + jw < V && v < V;
        cp_async4(gs + jw * ldg + v, ok ? gk + (size_t)(w0 + jw) * V + v : g,
                  ok);
      });
    }
  };

  const int wm = warp / WN, wn = warp % WN;
  const int m_base = wm * MT * 16, n_base = wn * NT * 8;
  const bool live = wm < WM && m_base < npairs && o0 + n_base < Cout;
  float acc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][b][e] = 0.f;

  issue_x(0);
  issue_g(0);
  cp_async_commit();
  issue_w(0);
  for (int j = 0; j < nchunks; ++j) {
    const int c0 = j % nc * KC;
    const int ksteps = (min(KC, Cin - c0) + 7) / 8;    // 8-channel steps
    float* wb = ws + (j & 1) * 2 * wplane;
    cp_async_wait_all();
    __syncthreads();               // chunk j landed; chunk j-1 consumed
    if (j + 1 < nchunks) issue_w(j + 1);   // its buffer was chunk j-1's
    if (!kEll && (j == 0 || !xres))   // x: once, or the chunk's
      walk(xrows, xcols, xrows, tid, kThreads, [&](int row, int c, int, int) {
        split(xs[row * ldx + c], xs[row * ldx + c], xs[xplane + row * ldx + c]);
      });
    split_tile<BN>(wb, wb + wplane, KC, kLdW, tid, kThreads);
    if (!kEll && c0 == 0)
      walk(wt16, vp, wt16, tid, kThreads, [&](int jw, int v, int, int) {
        split(gs[jw * ldg + v], gs[jw * ldg + v], gs[gplane + jw * ldg + v]);
      });
    __syncthreads();

    if constexpr (kEll) {
      // ELL graph stage on the CUDA cores, float32, slot by slot: item =
      // (pair, 4 channels), neighbouring threads on neighbouring channels,
      // one float4 of x per slot; y lands split into its hi, lo planes
      const int nq = ksteps * 2;
      for (int i = tid; i < rows * wt * nq; i += kThreads) {
        const int c = i % nq * 4, m = i / nq, r = m / wt, jw = m - r * wt;
        if (r >= nrows || jw >= nj) continue;
        const float* xr = xs + r * V * ldx + (xres ? c0 : 0) + c;
        const float* vj = es + jw * D;
        const int* ij = eis + jw * D;
        float s[4] = {0.f, 0.f, 0.f, 0.f};
        for (int d = 0; d < D; ++d) {
          const int jj = ij[d];
          if ((unsigned)jj >= (unsigned)V) continue;
          const float a = vj[d];
          const float4 xv = *reinterpret_cast<const float4*>(xr + jj * ldx);
          s[0] = fmaf(a, xv.x, s[0]);
          s[1] = fmaf(a, xv.y, s[1]);
          s[2] = fmaf(a, xv.z, s[2]);
          s[3] = fmaf(a, xv.w, s[3]);
        }
        const int at = m * kLdY + c;
#pragma unroll
        for (int e = 0; e < 4; ++e) split(s[e], ys[at + e], ys[yplane + at + e]);
      }
    }
    // dense graph stage: task = (row, 16-joint tile, pair of 8-channel
    // tiles); the G fragments of a step feed both tiles, whose three passes
    // go to separate accumulators: six independent MMA chains
    const int jtiles = wt16 / 16, npt = (ksteps + 1) / 2;
    const int ntask = kEll ? 0 : rows * jtiles * npt;
    for (int task = warp; task < ntask; task += kThreads / 32) {
      const int np = task % npt, mt = task / npt % jtiles;
      const int r = task / (npt * jtiles);
      if (r >= nrows) continue;
      const bool two = 2 * np + 1 < ksteps;
      float d[2][3][4] = {};
      const float* xr = xs + r * V * ldx + (xres ? c0 : 0) + np * 16;
#pragma unroll 2
      for (int ks = 0; ks < vp; ks += 8) {
        uint32_t ah[4], al[4];
        load_a(ah, gs, ldg, mt * 16, ks, gq, tq);
        load_a(al, gs + gplane, ldg, mt * 16, ks, gq, tq);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t == 1 && !two) break;
          uint32_t bh[2], bl[2];
          load_b(bh, xr, ldx, ks, 8 * t, gq, tq);
          load_b(bl, xr + xplane, ldx, ks, 8 * t, gq, tq);
          mma_tf32(d[t][0], al, bh);
          mma_tf32(d[t][1], ah, bl);
          mma_tf32(d[t][2], ah, bh);
        }
      }
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (t == 1 && !two) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int jw = mt * 16 + gq + 8 * h;
          if (jw >= nj) continue;
          const int at = (r * wt + jw) * kLdY + np * 16 + 8 * t + 2 * tq;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split((d[t][0][2 * h + e] + d[t][1][2 * h + e]) + d[t][2][2 * h + e],
                  ys[at + e], ys[yplane + at + e]);
        }
      }
    }
    __syncthreads();               // y complete; x (chunked) and G free
    if (j + 1 < nchunks) {
      if (!xres) issue_x(j + 1);
      if ((j + 1) % nc == 0) issue_g(j + 1);
      cp_async_commit();
    }

    // 1x1 stage: acc += Y . W_k over the chunk's channels, one 8-channel
    // step at a time: the warp's A fragments are loaded once per step, and
    // each output fragment takes the step's 3 MMAs in a fresh fragment,
    // added to acc in float32: the tensor cores' accumulation truncates,
    // and a fragment that took all K * Cin/8 * 3 MMAs would drift by that
    // many ulps of the output.
    if (live) {
      for (int ks = 0; ks < ksteps * 8; ks += 8) {
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int a = 0; a < MT; ++a) {
          load_a(ah[a], ys, kLdY, m_base + a * 16, ks, gq, tq);
          load_a(al[a], ys + yplane, kLdY, m_base + a * 16, ks, gq, tq);
        }
#pragma unroll
        for (int b = 0; b < NT; ++b) {
          uint32_t bh[2], bl[2];
          load_b(bh, wb, kLdW, ks, n_base + b * 8, gq, tq);
          load_b(bl, wb + wplane, kLdW, ks, n_base + b * 8, gq, tq);
#pragma unroll
          for (int a = 0; a < MT; ++a) mma3_add(acc[a][b], ah[a], al[a], bh, bl);
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m_base + a * 16 + gq + 8 * h;
      const int r = m / wt, jw = m % wt;
      if (m >= npairs || jw >= nj) continue;
      float* orow = out + ((size_t)(r0 + r) * V + w0 + jw) * Cout;
#pragma unroll
      for (int b = 0; b < NT; ++b) {
        const int o = o0 + n_base + b * 8 + 2 * tq;
        if (vec && o < Cout) {     // o even, Cout % 4 == 0: 8-byte aligned
          *reinterpret_cast<float2*>(orow + o) =
              make_float2(acc[a][b][2 * h], acc[a][b][2 * h + 1]);
        } else {
          if (o < Cout) orow[o] = acc[a][b][2 * h];
          if (o + 1 < Cout) orow[o + 1] = acc[a][b][2 * h + 1];
        }
      }
    }
}

// The block tiles, (WM, WN, MT, NT, KC, W); kernels/graph_sconv.py:
// SCONV_TILES lists them in the same order.  The stream tiles take 64
// input channels a chunk (fewer chunk rounds, each a few barriers and a
// copy's latency) and 4 warps, the ones past the output tile's sharing the
// staging, the splits and the graph product.  The last (16 pairs x 32
// channels) only the ELL planner takes: at stream shapes it forms each
// joint tile's y for half as many channel tiles as 16 x 16 does.
struct Tile {
  int wm, wn, mt, nt, kc, w;
};
constexpr Tile kTiles[] = {{4, 4, 2, 8, 16, 16}, {4, 2, 2, 8, 16, 8},
                           {4, 2, 2, 4, 16, 8},  {2, 1, 2, 8, 32, 4},
                           {1, 2, 2, 2, 64, 4},  {1, 1, 1, 2, 64, 4},
                           {1, 1, 1, 1, 64, 4},  {1, 1, 1, 4, 64, 4}};
constexpr int kNumTiles = sizeof(kTiles) / sizeof(kTiles[0]);

template <int WM, int WN, int MT, int NT, int KC, int W, bool kEll>
cudaError_t launch_tile(dim3 grid, size_t smem, cudaStream_t stream,
                        const float* x, const float* g, const int* idx,
                        const float* val, const float* w, float* out, int R,
                        int V, int Cin, int Cout, int K, int D, int rows,
                        int wt, int vec, int xvec, int xres) {
  static int limit[kMaxDevices];
  auto kern = sconv_kernel<WM, WN, MT, NT, KC, W, kEll>;
  cudaError_t err = allow_smem((const void*)kern, smem, limit);
  if (err != cudaSuccess) return err;
  kern<<<grid, W * 32, smem, stream>>>(x, g, idx, val, w, out, R, V, Cin,
                                       Cout, K, D, rows, wt, vec, xvec, xres);
  return cudaGetLastError();
}

// One launch of block tile `tile` (an index into kTiles) over rows x wt
// (row, joint) pairs a block, whole rows (wt = V) or 16-joint slices of
// one row (rows = 1); xres: the block keeps all of its x rows' channels in
// shared memory (else KC per chunk).  g (dense) or idx/val (ELL, D > 0).
template <bool kEll>
int sconv_launch(const float* x, const float* g, const int* idx,
                 const float* val, const float* w, float* out, int R, int V,
                 int Cin, int Cout, int K, int D, int tile, int rows, int wt,
                 int xres, cudaStream_t stream) {
  if (R <= 0 || V <= 0 || V > 128 || Cin <= 0 || Cout <= 0 || K <= 0 ||
      (kEll ? D <= 0 : D != 0) || tile < 0 || tile >= kNumTiles ||
      rows <= 0 || wt <= 0 || wt > V ||
      (wt < V && (wt % 16 != 0 || rows != 1)))
    return (int)cudaErrorInvalidValue;
  const Tile t = kTiles[tile];
  const int BM = t.wm * t.mt * 16, BN = t.wn * t.nt * 8;
  if (rows * wt > BM) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * smem_floats(BM, BN, t.kc, rows, wt, V, Cin, xres, D);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  const long long gx = (long long)((R + rows - 1) / rows) * ((V + wt - 1) / wt);
  const int gy = (Cout + BN - 1) / BN;
  if (gx > 0x7fffffffLL || gy > 65535) return (int)cudaErrorInvalidValue;
  // 16-byte copies of W rows and 8-byte stores of output pairs
  const int vec = (Cout % 4 == 0 && reinterpret_cast<size_t>(w) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0);
  const int xvec = (Cin % 4 == 0 && reinterpret_cast<size_t>(x) % 16 == 0);
  const dim3 grid((unsigned)gx, gy);
#define SCONV_LAUNCH(i, WM, WN, MT, NT, KC, W)                                \
  case i:                                                                     \
    return (int)launch_tile<WM, WN, MT, NT, KC, W, kEll>(                     \
        grid, smem, stream, x, g, idx, val, w, out, R, V, Cin, Cout, K, D,    \
        rows, wt, vec, xvec, xres);
  switch (tile) {
    SCONV_LAUNCH(0, 4, 4, 2, 8, 16, 16)
    SCONV_LAUNCH(1, 4, 2, 2, 8, 16, 8)
    SCONV_LAUNCH(2, 4, 2, 2, 4, 16, 8)
    SCONV_LAUNCH(3, 2, 1, 2, 8, 32, 4)
    SCONV_LAUNCH(4, 1, 2, 2, 2, 64, 4)
    SCONV_LAUNCH(5, 1, 1, 1, 2, 64, 4)
    SCONV_LAUNCH(6, 1, 1, 1, 1, 64, 4)
    SCONV_LAUNCH(7, 1, 1, 1, 4, 64, 4)
  }
#undef SCONV_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace sconv_mma
