// The per-tile front-to-back walk over quadratic-falloff coefficient rows,
// one thread a pixel: the designs before of K8 (blend_coeffs.cu, the rows
// precomputed [T, K, 8]) and K9 (fused.cu, the rows made from each tile's
// compacted candidate records). coeff_walk_fwd is walked by both forwards'
// `_v1`s (blend_coeffs_v1_kernel, fused_kernel_v1, whose STAGE cuts are
// probe P3), coeff_walk_bwd by both backwards' (blend_coeffs_bwd_v1_kernel,
// fused_bwd_kernel_v1). K8's and K9's forwards walk with
// coeff_walk_fwd.cuh, bit for bit what coeff_walk_fwd computes, and their
// backwards with coeff_walk_bwd.cuh. The semantics are those
// of the JAX package's
// pallas_blend.py::_forward_body / _backward_body, which
// attic/pallas_fused.py and attic/pallas_fused2.py repeat after their
// compaction:
//
//   per slot k, six coefficients c0..c5 in tile-local pixels, an opacity
//   and C colours; at the integer pixel offsets (dx, dy) (no +0.5)
//   power = c0 + c1 dx + c2 dy + c3 dx^2 + c4 dy^2 + c5 dx dy,
//   raw = opacity * exp(power), alpha = min(0.99, raw), used only where
//   power <= 0 and alpha >= 1/255; front to back, the walk stops at the
//   slot where T * (1 - alpha) < 1e-4 (that slot is not blended).
//   T is a running product; the TPU kernels' exp(log1p(-alpha) @ U)
//   (the prefix sum as a product with the triangular ones matrix)
//   differs from it only at rounding level. A slot of opacity 0 is inert.
//
// This is the polynomial form, not blend_walk.cuh's: there the opacity
// enters as exp(power + log(opacity)) and the coefficients are made from
// (x, y, conic) inside the walk, so images agree with K2's to rounding,
// not to the bit.
//
// Backward, per pixel p and accepted slot k (only those have a
// cotangent):
//   dw_k     = sum_c g_c(p) col_k,c
//   dlg_k    = sum_{j>k} dw_j w_j + g_Tbg(p) T_bg(p)
//   dalpha_k = dw_k T_before_k - dlg_k / (1 - alpha_k)
//   where raw < 0.99: dpower = dalpha_k raw, dopacity = dalpha_k exp(power)
// then per slot 7 + C sums over the tile's 256 pixels: the coefficients'
// sum_p basis_p dpower, the opacity's, and the colours' sum_p g_c w.
//
// Design, as blend_walk.cuh's: one block of 256 threads per tile, one
// thread per pixel; the tile's slots are staged into shared memory in
// chunks by a caller-supplied functor (one thread per slot), then walked
// by every thread from shared memory (broadcast reads); a block-wide vote
// after each chunk ends the tile once every pixel has stopped. The
// backward walks twice front to back (the first finds T_bg and the total
// of ds = dw w, the second subtracts each ds from it for the suffix), and
// sums each slot's 7 + C values over each warp with shuffles and over the
// 8 warps in shared memory, in a fixed order: deterministic, no atomics.
// A caller-supplied functor receives each slot's sums.

#pragma once

#include <cuda_runtime.h>

#define CW_TILE 16
#define CW_NPIX (CW_TILE * CW_TILE)
#define CW_NWARP (CW_NPIX / 32)
#define CW_FWD_CHUNK CW_NPIX
#define CW_BWD_CHUNK 64
#define CW_FULL_MASK 0xffffffffu

#define CW_ALPHA_SKIP (1.0f / 255.0f)
#define CW_ALPHA_MAX 0.99f
#define CW_T_EPS 1e-4f

// One staged chunk: per slot the six falloff coefficients, the opacity
// and the C colours.
template <int C, int CH>
struct CoeffChunk {
  float c[6][CH];
  float op[CH];
  float col[C][CH];
};

__device__ __forceinline__ float cw_warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(CW_FULL_MASK, v, o);
  return v;
}

// The falloff polynomial of staged slot k at this thread's pixel.
template <int C, int CH>
__device__ __forceinline__ float cw_power(const CoeffChunk<C, CH>& s, int k, float fx, float fy,
                                          float fxx, float fyy, float fxy) {
  return s.c[0][k] + s.c[1][k] * fx + s.c[2][k] * fy + s.c[3][k] * fxx + s.c[4][k] * fyy +
         s.c[5][k] * fxy;
}

// Forward walk of one tile by the calling block (thread p = pixel
// dy * 16 + dx) over its n slots: the pixel's colour in acc, its T_bg
// returned. stage(k, j, chunk) is called by thread j to put slot k into
// column j of the chunk.
template <int C, class Stage>
__device__ __forceinline__ float coeff_walk_fwd(int n, Stage stage, float (&acc)[C]) {
  __shared__ CoeffChunk<C, CW_FWD_CHUNK> s;
  const int p = threadIdx.x;
  const float fx = (float)(p % CW_TILE), fy = (float)(p / CW_TILE);
  const float fxx = fx * fx, fyy = fy * fy, fxy = fx * fy;

  float T = 1.0f;
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0.0f;
  bool done = false;
  for (int base = 0; base < n; base += CW_FWD_CHUNK) {
    const int m = min(CW_FWD_CHUNK, n - base);
    __syncthreads();  // the previous chunk has been read by every thread
    if (p < m) stage(base + p, p, s);
    __syncthreads();
    if (!done) {
      for (int k = 0; k < m; ++k) {
        const float power = cw_power(s, k, fx, fy, fxx, fyy, fxy);
        if (!(power <= 0.0f)) continue;
        const float raw = s.op[k] * expf(power);
        if (!(raw >= CW_ALPHA_SKIP)) continue;  // min(0.99, raw) >= 1/255 iff raw >= 1/255
        const float alpha = fminf(CW_ALPHA_MAX, raw);
        const float test_T = T * (1.0f - alpha);
        if (test_T < CW_T_EPS) {
          done = true;
          break;
        }
        const float w = alpha * T;
#pragma unroll
        for (int c = 0; c < C; ++c) acc[c] += w * s.col[c][k];
        T = test_T;
      }
    }
    if (__syncthreads_and(done)) break;
  }
  return T;
}

// Backward walk of one tile by the calling block over its n slots: pixel
// p's cotangent gc (colours) and g_tbg (T_bg) in; emit(k, d) is called
// once for every slot k < n by one thread, with d[7 + C] = (the six
// coefficients' cotangents, the opacity's, the C colours'); zeros for the
// slots past the walk.
template <int C, class Stage, class Emit>
__device__ __forceinline__ void coeff_walk_bwd(int n, Stage stage, const float (&gc)[C],
                                               float g_tbg, Emit emit) {
  constexpr int NV = 7 + C;
  __shared__ CoeffChunk<C, CW_BWD_CHUNK> s;
  __shared__ float s_part[CW_NWARP][NV][CW_BWD_CHUNK];
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const float fx = (float)(p % CW_TILE), fy = (float)(p / CW_TILE);
  const float fxx = fx * fx, fyy = fy * fy, fxy = fx * fy;

  // -- walk 1: T_bg and the total of ds = dw * w over accepted slots --
  float T = 1.0f, S = 0.0f;
  bool done = false;
  for (int base = 0; base < n; base += CW_BWD_CHUNK) {
    const int m = min(CW_BWD_CHUNK, n - base);
    __syncthreads();
    if (p < m) stage(base + p, p, s);
    __syncthreads();
    if (!done) {
      for (int k = 0; k < m; ++k) {
        const float power = cw_power(s, k, fx, fy, fxx, fyy, fxy);
        if (!(power <= 0.0f)) continue;
        const float raw = s.op[k] * expf(power);
        if (!(raw >= CW_ALPHA_SKIP)) continue;
        const float alpha = fminf(CW_ALPHA_MAX, raw);
        const float test_T = T * (1.0f - alpha);
        if (test_T < CW_T_EPS) {
          done = true;
          break;
        }
        float dw = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) dw += gc[c] * s.col[c][k];
        S += dw * (alpha * T);
        T = test_T;
      }
    }
    if (__syncthreads_and(done)) break;
  }
  const float gt_bg = g_tbg * T;  // dlg of every accepted slot includes it

  // -- walk 2: the cotangents; R = the ds of the accepted slots behind --
  float R = S;
  T = 1.0f;
  done = false;
  int written = 0;
  for (int base = 0; base < n; base += CW_BWD_CHUNK) {
    const int m = min(CW_BWD_CHUNK, n - base);
    __syncthreads();
    if (p < m) stage(base + p, p, s);
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      float v[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) v[i] = 0.0f;
      bool hit = false;
      if (!done) {
        const float power = cw_power(s, k, fx, fy, fxx, fyy, fxy);
        if (power <= 0.0f) {
          const float e = expf(power);
          const float raw = s.op[k] * e;
          if (raw >= CW_ALPHA_SKIP) {
            const float alpha = fminf(CW_ALPHA_MAX, raw);
            const float test_T = T * (1.0f - alpha);
            if (test_T < CW_T_EPS) {
              done = true;
            } else {
              const float w = alpha * T;
              float dw = 0.0f;
#pragma unroll
              for (int c = 0; c < C; ++c) dw += gc[c] * s.col[c][k];
              R -= dw * w;
              const float dlg = R + gt_bg;
              const float dalpha = dw * T - dlg / (1.0f - alpha);
              if (raw < CW_ALPHA_MAX) {
                const float dp = dalpha * raw;
                v[0] = dp;
                v[1] = dp * fx;
                v[2] = dp * fy;
                v[3] = dp * fxx;
                v[4] = dp * fyy;
                v[5] = dp * fxy;
                v[6] = dalpha * e;
              }
#pragma unroll
              for (int c = 0; c < C; ++c) v[7 + c] = gc[c] * w;
              hit = true;
              T = test_T;
            }
          }
        }
      }
      if (__any_sync(CW_FULL_MASK, hit)) {
#pragma unroll
        for (int i = 0; i < NV; ++i) v[i] = cw_warp_sum(v[i]);
      }
      if (lane == 0) {
#pragma unroll
        for (int i = 0; i < NV; ++i) s_part[warp][i][k] = v[i];
      }
    }
    __syncthreads();
    if (p < m) {
      float d[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float a = 0.0f;
#pragma unroll
        for (int w = 0; w < CW_NWARP; ++w) a += s_part[w][i][p];
        d[i] = a;
      }
      emit(base + p, d);
    }
    written = base + m;
    if (__syncthreads_and(done)) break;
  }
  float z[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) z[i] = 0.0f;
  for (int k = written + p; k < n; k += CW_NPIX) emit(k, z);
}

// The colour counts the kernels are instantiated for: CALL(c) for c in
// 1..10, else the enclosing C entry point returns -1.
#define CW_SWITCH_C(C, CALL) \
  switch (C) {               \
    case 1: CALL(1); break;  \
    case 2: CALL(2); break;  \
    case 3: CALL(3); break;  \
    case 4: CALL(4); break;  \
    case 5: CALL(5); break;  \
    case 6: CALL(6); break;  \
    case 7: CALL(7); break;  \
    case 8: CALL(8); break;  \
    case 9: CALL(9); break;  \
    case 10: CALL(10); break; \
    default: return -1;      \
  }
