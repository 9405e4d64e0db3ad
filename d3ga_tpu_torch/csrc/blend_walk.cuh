// The per-tile front-to-back walk of the blend kernels' designs before,
// kept as their baselines: K2's and K3's (blend_ct.cu, blend_ct_bwd.cu, a
// planar image over the whole tile grid) and K5's and K7's forwards and
// backwards (blend_rec.cu: a shard's run of tiles, tile-major, and the
// padded image); the kernels themselves walk with blend_walk_fwd.cuh and
// blend_walk_bwd.cuh, which compute what these walks compute. A kernel
// calls one walk per block: it places its tile (origin sx, sy), finds
// its records (tidx, cnt) and reads or writes its own layout; the walks
// hold the semantics, those of the JAX package's _blend_fwd_ct /
// _blend_bwd_ct / _coeffs_transpose_ct (pallas_blend_ct.py) and _blend_fwd
// / _blend_bwd / _coeffs_transpose (pallas_blend_rec.py), which agree:
//
//   per record, tile-local offsets x = X - sx, y = Y - sy, the falloff
//   polynomial power = c0 + c1 dx + c2 dy + c3 dx^2 + c4 dy^2 + c5 dx dy at
//   integer pixel offsets (dx, dy) (no +0.5), and
//   alpha = min(0.99, exp(power + log(max(opacity, 1e-12)))), used only
//   where power <= 0 and alpha >= 1/255; front to back, the walk stops at
//   the record where T * (1 - alpha) < 1e-4 (that record is not blended).
//   T is a running product; the TPU kernels' exp(cumsum(log1p(-a)))
//   differs from it only at rounding level.
//
// Backward, per pixel p and accepted record k (only those have a
// cotangent):
//   dw_k     = sum_c g_c(p) col_k,c
//   dlg_k    = sum_{j>k} dw_j w_j + g_Tbg(p) T_bg(p)
//   dalpha_k = dw_k T_before_k - dlg_k / (1 - alpha_k)
//   dpower2  = dalpha_k raw  where raw < 0.99, else 0
// then per record 6 + C sums over the tile's 256 pixels: the falloff
// coefficients' cotangents sum_p basis_p dpower2, turned into d(x, y, a,
// b, c) by the coefficients' transpose, with d(opacity) = dcoeffs[0] /
// max(op, 1e-12) where op > 0, and the colours' sum_p g_c w.
//
// Design: one block of 256 threads per tile, one thread per pixel; the
// tile's records are staged through idx into shared memory in chunks
// (their 7 falloff coefficients and C colours), each thread converting
// one, then walked by every thread from shared memory (broadcast reads).
// A block-wide vote after each chunk ends the tile once every pixel has
// stopped. The backward walks twice front to back: the first sums
// ds = dw * w over the accepted records (and finds T_bg), the second
// subtracts each ds from that total as it goes, for the suffix over the
// records behind. This avoids the back-to-front walk of the CUDA
// reference, whose division by (1 - alpha) <= 0.01 amplifies rounding up
// to 100x; the cost is the cancellation of total - prefix, an absolute
// error of ~1e-7 of the pixel's total. Per record, the 6 + C values are
// summed over each warp with shuffles (skipped when no lane of the warp
// accepted it) and over the 8 warps in shared memory, in a fixed order:
// deterministic, no atomics; each slot belongs to exactly one tile.

#pragma once

#include <cuda_runtime.h>

#define TILE 16
#define NPIX (TILE * TILE)
#define NWARP (NPIX / 32)
#define FWD_CHUNK NPIX
#define BWD_CHUNK 64
#define FULL_MASK 0xffffffffu

#define ALPHA_SKIP (1.0f / 255.0f)
#define ALPHA_MAX 0.99f
#define T_EPS 1e-4f
#define OP_EPS 1e-12f

// Stage the record with id gid into shared column `p`: rows c0,
// c0 + log(opacity), c1 .. c5 of the tile-local falloff polynomial, then
// the C colours.
template <int C, int CHUNK>
__device__ __forceinline__ void stage(const float* __restrict__ rec, int n_ext, int CR, int gid,
                                      float sx, float sy, int p, float (*s_c)[CHUNK],
                                      float (*s_col)[CHUNK]) {
  const int g = min(max(gid, 0), n_ext - 1);
  const float* r = rec + (long long)g * CR;
  const float x = r[0] - sx;
  const float y = r[1] - sy;
  const float A = r[2], B = r[3], Cc = r[4];
  const float logop = logf(fmaxf(r[5], OP_EPS));
  const float c0 = -0.5f * (A * x * x + Cc * y * y) - B * x * y;
  s_c[0][p] = c0;
  s_c[1][p] = c0 + logop;
  s_c[2][p] = A * x + B * y;
  s_c[3][p] = Cc * y + B * x;
  s_c[4][p] = -0.5f * A;
  s_c[5][p] = -0.5f * Cc;
  s_c[6][p] = -B;
#pragma unroll
  for (int c = 0; c < C; ++c) s_col[c][p] = r[6 + c];
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Forward walk of one tile by the calling block (thread p = pixel
// dy * 16 + dx): its colour in acc, its T_bg returned. tidx holds the
// tile's K record ids, cnt (clamped to [0, K]) of them live.
template <int C>
__device__ __forceinline__ float blend_walk_fwd(const float* __restrict__ rec, int n_ext, int CR,
                                                const int* __restrict__ tidx, int cnt, float sx,
                                                float sy, float (&acc)[C]) {
  __shared__ float s_c[7][FWD_CHUNK];
  __shared__ float s_col[C][FWD_CHUNK];
  const int p = threadIdx.x;
  const float fx = (float)(p % TILE), fy = (float)(p / TILE);
  const float fxx = fx * fx, fyy = fy * fy, fxy = fx * fy;

  float T = 1.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  bool done = false;

  for (int base = 0; base < cnt; base += FWD_CHUNK) {
    const int n = min(FWD_CHUNK, cnt - base);
    __syncthreads();  // the previous chunk has been read by every thread
    if (p < n) stage<C, FWD_CHUNK>(rec, n_ext, CR, tidx[base + p], sx, sy, p, s_c, s_col);
    __syncthreads();
    if (!done) {
      for (int k = 0; k < n; ++k) {
        const float q = s_c[2][k] * fx + s_c[3][k] * fy + s_c[4][k] * fxx +
                        s_c[5][k] * fyy + s_c[6][k] * fxy;
        if (!(s_c[0][k] + q <= 0.0f)) continue;
        const float e = expf(s_c[1][k] + q);
        if (!(e >= ALPHA_SKIP)) continue;  // min(0.99, e) >= 1/255 iff e >= 1/255
        const float alpha = fminf(ALPHA_MAX, e);
        const float test_T = T * (1.0f - alpha);
        if (test_T < T_EPS) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * s_col[c][k];
        T = test_T;
      }
    }
    if (__syncthreads_and(done)) break;
  }
  return T;
}

// Backward of one tile by the calling block: pixel p's image cotangent
// gc (colours) and g_tbg (T_bg) in, the tile's K slot rows of record
// cotangents out (tdrec [K, CR]; zeros past the walk and in dead slots).
// STAGE < 4 cuts the walk for K3's stage split (blend_ct_bwd.cu), as
// blend_walk_bwd.cuh's walk is cut: 0 staging and stores, 1 + walk 1,
// 2 + walk 2's per-pixel arithmetic, 3 + the per-record sums; each cut
// writes what it computed (folded into the rows) so that none is dead.
template <int C, int STAGE = 4>
__device__ __forceinline__ void blend_walk_bwd(const float* __restrict__ rec, int n_ext, int CR,
                                               const int* __restrict__ tidx, int K, int cnt,
                                               float sx, float sy, const float (&gc)[C],
                                               float g_tbg, float* __restrict__ tdrec) {
  __shared__ float s_c[7][BWD_CHUNK];
  __shared__ float s_col[C][BWD_CHUNK];
  // per-warp partial sums of each record's 6 + C cotangent values
  __shared__ float s_part[NWARP][6 + C][BWD_CHUNK];
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float fx = (float)(p % TILE), fy = (float)(p / TILE);
  const float fxx = fx * fx, fyy = fy * fy, fxy = fx * fy;
  float fold = 0.0f;  // the stage cuts' sink for what they compute

  // -- walk 1: T_bg and the total of ds = dw * w over accepted records --
  float T = 1.0f, S = 0.0f;
  bool done = false;
  for (int base = 0; base < cnt; base += BWD_CHUNK) {
    const int n = min(BWD_CHUNK, cnt - base);
    __syncthreads();
    if (p < n) stage<C, BWD_CHUNK>(rec, n_ext, CR, tidx[base + p], sx, sy, p, s_c, s_col);
    __syncthreads();
    if constexpr (STAGE == 0) {
      if (p < n) fold += s_c[1][p];
    } else if (!done) {
      for (int k = 0; k < n; ++k) {
        const float q = s_c[2][k] * fx + s_c[3][k] * fy + s_c[4][k] * fxx +
                        s_c[5][k] * fyy + s_c[6][k] * fxy;
        if (!(s_c[0][k] + q <= 0.0f)) continue;
        const float e = expf(s_c[1][k] + q);
        if (!(e >= ALPHA_SKIP)) continue;
        const float alpha = fminf(ALPHA_MAX, e);
        const float test_T = T * (1.0f - alpha);
        if (test_T < T_EPS) {
          done = true;
          break;
        }
        float dw = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) dw += gc[c] * s_col[c][k];
        S += dw * (alpha * T);
        T = test_T;
      }
    }
    if (__syncthreads_and(done)) break;
  }
  if constexpr (STAGE == 1) fold += T + S;
  const float gt_bg = g_tbg * T;  // dlg of every accepted record includes it

  // -- walk 2: the cotangents; R = the ds of the accepted records behind --
  float R = S;
  T = 1.0f;
  done = false;
  int written = 0;
  for (int base = 0; base < cnt; base += BWD_CHUNK) {
    const int n = min(BWD_CHUNK, cnt - base);
    __syncthreads();
    if (p < n) stage<C, BWD_CHUNK>(rec, n_ext, CR, tidx[base + p], sx, sy, p, s_c, s_col);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      if constexpr (STAGE < 2) continue;
      float v[6 + C];
#pragma unroll
      for (int i = 0; i < 6 + C; ++i) v[i] = 0.0f;
      bool hit = false;
      if (!done) {
        const float q = s_c[2][k] * fx + s_c[3][k] * fy + s_c[4][k] * fxx +
                        s_c[5][k] * fyy + s_c[6][k] * fxy;
        if (s_c[0][k] + q <= 0.0f) {
          const float e = expf(s_c[1][k] + q);
          if (e >= ALPHA_SKIP) {
            const float alpha = fminf(ALPHA_MAX, e);
            const float test_T = T * (1.0f - alpha);
            if (test_T < T_EPS) {
              done = true;
            } else {
              const float w = alpha * T;
              float dw = 0.0f;
#pragma unroll
              for (int c = 0; c < C; ++c) dw += gc[c] * s_col[c][k];
              R -= dw * w;
              const float dlg = R + gt_bg;
              const float dalpha = dw * T - dlg / (1.0f - alpha);
              const float dp = (e < ALPHA_MAX) ? dalpha * e : 0.0f;
              if constexpr (STAGE == 2) fold += dp + w;
              v[0] = dp;
              v[1] = dp * fx;
              v[2] = dp * fy;
              v[3] = dp * fxx;
              v[4] = dp * fyy;
              v[5] = dp * fxy;
#pragma unroll
              for (int c = 0; c < C; ++c) v[6 + c] = gc[c] * w;
              hit = true;
              T = test_T;
            }
          }
        }
      }
      if constexpr (STAGE < 3) continue;
      if (__any_sync(FULL_MASK, hit)) {
#pragma unroll
        for (int i = 0; i < 6 + C; ++i) v[i] = warp_sum(v[i]);
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < 6 + C; ++i) s_part[warp][i][k] = v[i];
      }
    }
    __syncthreads();
    if (p < n) {
      float d[6 + C];
#pragma unroll
      for (int i = 0; i < 6 + C; ++i) {
        float a = 0.0f;
        if constexpr (STAGE >= 3) {
#pragma unroll
          for (int w = 0; w < NWARP; ++w) a += s_part[w][i][p];
        }
        d[i] = a;
      }
      const int gidx = min(max(tidx[base + p], 0), n_ext - 1);
      const float* r = rec + (long long)gidx * CR;
      const float x = r[0] - sx;
      const float y = r[1] - sy;
      const float A = r[2], B = r[3], Cc = r[4], op = r[5];
      float* o = tdrec + (long long)(base + p) * CR;
      if constexpr (STAGE == 4) {
        o[0] = -d[0] * (A * x + B * y) + d[1] * A + d[2] * B;
        o[1] = -d[0] * (Cc * y + B * x) + d[1] * B + d[2] * Cc;
        o[2] = -0.5f * d[0] * x * x + d[1] * x - 0.5f * d[3];
        o[3] = -d[0] * x * y + d[1] * y + d[2] * x - d[5];
        o[4] = -0.5f * d[0] * y * y + d[2] * y - 0.5f * d[4];
        o[5] = op > 0.0f ? d[0] / fmaxf(op, OP_EPS) : 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) o[6 + c] = d[6 + c];
      } else {
        const float geo[6] = {x, y, A, B, Cc, op};
#pragma unroll
        for (int i = 0; i < 6; ++i) o[i] = geo[i] + fold + d[i];
#pragma unroll
        for (int c = 0; c < C; ++c) o[6 + c] = (STAGE == 3 ? d[6 + c] : s_col[c][p]) + fold;
      }
      for (int c = 6 + C; c < CR; ++c) o[c] = 0.0f;
    }
    written = base + n;
    if (__syncthreads_and(done)) break;
  }
  for (long long e = (long long)written * CR + p; e < (long long)K * CR; e += NPIX) tdrec[e] = 0.0f;
}

// The colour counts the kernels are instantiated for: CALL(c) for c in
// 1..8, else the enclosing C entry point returns -1.
#define D3GA_SWITCH_C(C, CALL) \
  switch (C) {                 \
    case 1: CALL(1); break;    \
    case 2: CALL(2); break;    \
    case 3: CALL(3); break;    \
    case 4: CALL(4); break;    \
    case 5: CALL(5); break;    \
    case 6: CALL(6); break;    \
    case 7: CALL(7); break;    \
    case 8: CALL(8); break;    \
    default: return -1;        \
  }
