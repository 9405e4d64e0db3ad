// K3: recompute-forward VJP of the record-gather blend (K2): image
// cotangent -> per-slot record cotangents.
//
// Replaces the TPU kernel d3ga_tpu/raster/pallas_blend_ct.py::_run_backward_ct
// (_backward_body_ct, _blend_bwd_ct, _coeffs_transpose_ct). Like K2 it
// gathers each tile's records through idx, so the [T, CR, K] record
// tensor of the TPU path is never read; it writes drec [T, K, CR], one
// row per slot, for the id sort and the per-Gaussian combine (K4).
//
// Semantics (those of _blend_bwd_ct), per tile, pixel p and live slot k,
// with K2's rules: integer pixel offsets from the tile origin,
// alpha = min(0.99, raw), raw = exp(power + log(max(opacity, 1e-12))),
// used only where power <= 0 and alpha >= 1/255, and the record accepted
// while T * (1 - alpha) >= 1e-4. Only accepted records have a cotangent:
//   dw_k     = sum_c g_c(p) col_k,c
//   dlg_k    = sum_{j>k} dw_j w_j + g_Tbg(p) T_bg(p)
//   dalpha_k = dw_k T_before_k - dlg_k / (1 - alpha_k)
//   dpower2  = dalpha_k raw  where raw < 0.99, else 0
// and per record 12 sums over the tile's 256 pixels: the 6 falloff
// coefficient cotangents sum_p basis_p dpower2 and the C colour
// cotangents sum_p g_c w. _coeffs_transpose_ct turns the first into
// d(x, y, a, b, c); d(opacity) = dcoeffs[0] / max(op, 1e-12) where op > 0.
//
// Bound on Hopper: operations. Each visited (pixel, record) pair is
// walked twice (the forward recompute, then the cotangents): about 60
// FP32 operations and 2 exp at the serving width's ~27 M pairs, against
// 19 MB of cotangent read and 33 MB of drec written (dense, zeros in
// dead slots).
//
// Design: one block of 256 threads per tile, one thread per pixel; the
// tile's records are staged through idx into shared memory in chunks of
// 64, as in K2. The suffix sum over the records behind k comes from two
// front-to-back walks: the first sums ds = dw w over the accepted records
// (and finds T_bg), the second subtracts each ds from that total as it
// goes. This avoids the back-to-front walk of the CUDA reference, whose
// division by (1 - alpha) <= 0.01 amplifies rounding up to 100x; the cost
// is the cancellation of total - prefix, an absolute error of ~1e-7 of the
// pixel's total. Per record, the 12 values are summed over each warp with
// shuffles (skipped when no lane of the warp accepted it) and over the 8
// warps in shared memory, in a fixed order: deterministic, no atomics;
// each slot belongs to exactly one tile. Slots past the walk (dead slots,
// or records behind every terminated pixel) are written as zeros.

#include <cuda_runtime.h>

#define TILE 16
#define NPIX (TILE * TILE)
#define NWARP (NPIX / 32)
#define CHUNK 64
#define FULL_MASK 0xffffffffu

#define ALPHA_SKIP (1.0f / 255.0f)
#define ALPHA_MAX 0.99f
#define T_EPS 1e-4f
#define OP_EPS 1e-12f

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL_MASK, v, o);
  return v;
}

// Stage record `slot` of the tile into shared column `p` (K2's coefficients).
template <int C>
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

template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_ct_bwd_kernel(const float* __restrict__ rec, int n_ext, int CR,
                           const int* __restrict__ idx, int K,
                           const int* __restrict__ counts, int ntx, int nty,
                           const float* __restrict__ g, float* __restrict__ drec) {
  // s_c rows: c0, c0 + log(opacity), c1, c2, c3, c4, c5
  __shared__ float s_c[7][CHUNK];
  __shared__ float s_col[C][CHUNK];
  // per-warp partial sums of each record's 6 + C cotangent values
  __shared__ float s_part[NWARP][6 + C][CHUNK];

  const int t = blockIdx.x;
  const int tx = t % ntx;
  const int ty = t / ntx;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int dx = p % TILE;
  const int dy = p / TILE;
  const float sx = (float)(tx * TILE);
  const float sy = (float)(ty * TILE);
  const float fx = (float)dx, fy = (float)dy;
  const float fxx = fx * fx, fyy = fy * fy, fxy = fx * fy;

  const long long wp = (long long)ntx * TILE;
  const long long plane = (long long)nty * TILE * wp;
  const long long pix = (long long)(ty * TILE + dy) * wp + tx * TILE + dx;
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = g[c * plane + pix];
  const float g_tbg = g[C * plane + pix];

  const int cnt = min(max(counts[t], 0), K);
  const int* tidx = idx + (long long)t * K;
  float* tdrec = drec + (long long)t * K * CR;

  // -- walk 1: T_bg and the total of ds = dw * w over accepted records --
  float T = 1.0f, S = 0.0f;
  bool done = false;
  for (int base = 0; base < cnt; base += CHUNK) {
    const int n = min(CHUNK, cnt - base);
    __syncthreads();
    if (p < n) stage<C>(rec, n_ext, CR, tidx[base + p], sx, sy, p, s_c, s_col);
    __syncthreads();
    if (!done) {
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
  const float gt_bg = g_tbg * T;  // dlg of every accepted record includes it

  // -- walk 2: the cotangents; R = the ds of the accepted records behind --
  float R = S;
  T = 1.0f;
  done = false;
  int written = 0;
  for (int base = 0; base < cnt; base += CHUNK) {
    const int n = min(CHUNK, cnt - base);
    __syncthreads();
    if (p < n) stage<C>(rec, n_ext, CR, tidx[base + p], sx, sy, p, s_c, s_col);
    __syncthreads();
    for (int k = 0; k < n; ++k) {
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
#pragma unroll
        for (int w = 0; w < NWARP; ++w) a += s_part[w][i][p];
        d[i] = a;
      }
      const int gidx = min(max(tidx[base + p], 0), n_ext - 1);
      const float* r = rec + (long long)gidx * CR;
      const float x = r[0] - sx;
      const float y = r[1] - sy;
      const float A = r[2], B = r[3], Cc = r[4], op = r[5];
      float* o = tdrec + (long long)(base + p) * CR;
      o[0] = -d[0] * (A * x + B * y) + d[1] * A + d[2] * B;
      o[1] = -d[0] * (Cc * y + B * x) + d[1] * B + d[2] * Cc;
      o[2] = -0.5f * d[0] * x * x + d[1] * x - 0.5f * d[3];
      o[3] = -d[0] * x * y + d[1] * y + d[2] * x - d[5];
      o[4] = -0.5f * d[0] * y * y + d[2] * y - 0.5f * d[4];
      o[5] = op > 0.0f ? d[0] / fmaxf(op, OP_EPS) : 0.0f;
#pragma unroll
      for (int c = 0; c < C; ++c) o[6 + c] = d[6 + c];
      for (int c = 6 + C; c < CR; ++c) o[c] = 0.0f;
    }
    written = base + n;
    if (__syncthreads_and(done)) break;
  }
  for (long long e = (long long)written * CR + p; e < (long long)K * CR; e += NPIX) tdrec[e] = 0.0f;
}

template <int C>
static void launch(const float* rec, int n_ext, int CR, const int* idx, int K, const int* counts,
                   int ntx, int nty, const float* g, float* drec, cudaStream_t s) {
  blend_gather_ct_bwd_kernel<C><<<ntx * nty, NPIX, 0, s>>>(rec, n_ext, CR, idx, K, counts, ntx,
                                                           nty, g, drec);
}

// Returns the cudaError_t of the launch, or -1 for an unsupported C.
extern "C" int d3ga_blend_gather_ct_bwd(const void* rec, int n_ext, int CR, const void* idx, int K,
                                        const void* counts, int ntx, int nty, int C,
                                        const void* g, void* drec, void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  const float* gg = (const float*)g;
  float* o = (float*)drec;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  switch (C) {
    case 1: launch<1>(r, n_ext, CR, i, K, c, ntx, nty, gg, o, s); break;
    case 2: launch<2>(r, n_ext, CR, i, K, c, ntx, nty, gg, o, s); break;
    case 3: launch<3>(r, n_ext, CR, i, K, c, ntx, nty, gg, o, s); break;
    case 4: launch<4>(r, n_ext, CR, i, K, c, ntx, nty, gg, o, s); break;
    case 5: launch<5>(r, n_ext, CR, i, K, c, ntx, nty, gg, o, s); break;
    case 6: launch<6>(r, n_ext, CR, i, K, c, ntx, nty, gg, o, s); break;
    case 7: launch<7>(r, n_ext, CR, i, K, c, ntx, nty, gg, o, s); break;
    case 8: launch<8>(r, n_ext, CR, i, K, c, ntx, nty, gg, o, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
