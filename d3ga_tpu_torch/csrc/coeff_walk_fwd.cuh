// The forward walk of K9 (fused.cu::fused_fwd_kernel) and K8
// (blend_coeffs.cu::blend_coeffs_kernel): the front-to-back alpha blend of
// one 16x16 tile over quadratic-falloff coefficient rows, two pixels a
// thread, in batches of slots. It computes what coeff_walk.cuh::
// coeff_walk_fwd computes, bit for bit: per pixel the same slots are taken
// in the same order with the same arithmetic (power = c0 + c1 dx + c2 dy +
// c3 dx^2 + c4 dy^2 + c5 dx dy, raw = opacity * expf(power), taken only
// where power <= 0 and raw >= 1/255, alpha = min(0.99, raw), the walk
// stops before the slot where T * (1 - alpha) < 1e-4, acc += alpha T col,
// T *= 1 - alpha). Only the work that cannot change a pixel's state is
// left out or done early. This is K9's rule, not K2's exp(power + log
// opacity): blend_walk_fwd.cuh's walk is the model, not the callee.
//
// Replaces (with fused.cu and blend_coeffs.cu) the TPU kernels
// d3ga_tpu/raster/attic/pallas_fused.py::_run_forward,
// attic/pallas_fused2.py::_run_forward (K9) and
// d3ga_tpu/raster/pallas_blend.py::_run_forward (K8).
//
// Design, and why. coeff_walk_fwd (one thread a pixel, 8 warps a tile)
// runs every slot at every pixel as one dependent chain: 8 + C scalar
// broadcast loads, the polynomial, the exp, the tests, the T update,
// behind branches the compiler cannot schedule across; and each thread
// stores its pixel's C + 1 floats at a (C + 1) x 4-byte stride. K2's
// redesign (blend_walk_fwd.cuh) took the same design from 0.100 to 0.059
// ms, and its stores through shared memory (fw_store_rows) took about
// 0.014 ms off K5's and K7's forwards (NVIDIA H100 80GB HBM3, 700 W,
// chip_smoke.py). Here, as there:
// - Two pixels a thread (cb_pixel, K9's backward's map): 128 threads, four
//   warps, one tile a block; warp w's pixels j lie in the 2-row band
//   P w + j, and the two pixels' chains interleave.
// - The band cull. The caller's staging marks the 2-row bands where a slot
//   can be taken (its row's float CB_BAND); a warp skips a slot neither
//   of its bands can take. No pixel of the warp would take it, so T, the
//   colours and the stop are what the walk without the cull gives (each
//   kernel is built with the cull behind a runtime flag; chip_smoke.py
//   holds the two builds bit for bit). K9's staging is its backward's
//   (coeff_walk_bwd.cuh::cb_stage: the ellipse's rows); K8's bound from
//   its coefficients alone is blend_coeffs.cu's.
// - Slot lists and batches. A slot's polynomial, exp and tests do not
//   depend on the slots before it; only T does. After staging a chunk,
//   each warp ballots the chunk's band words and lists the slots it takes,
//   in order, in shared memory (warp-uniform), and walks the list R slots
//   at a time: first the R ids (one 16-byte load for four), the R rows
//   (broadcast 16-byte loads) and the R x P polynomials, exps, raws and
//   alphas, then the slots' tests and T updates in slot order, which is
//   all that stays on the chain: T * (1 - alpha), the compare, the
//   selects. The batch is one basic block (the chain selects, it does not
//   branch; a batch past the list's end walks nothing for its tail), so
//   the compiler can run its loads and exps ahead of the chain: a
//   branching version let nvcc sink each exp behind the slot before
//   (blend_walk_fwd.cuh says what that cost K2). Exps computed past a
//   pixel's stop are discarded; a warp leaves the chunk once all its
//   pixels have stopped, and a block vote after each chunk ends the tile.
//   R = 8: chip_smoke.py times R = 1, 2, 4 and 8 in turns.
// - The polynomial is pinned to coeff_walk_fwd's roundings (cf_power):
//   nvcc contracts that walk's plain sum into the chain fma(c5, dx dy,
//   fma(c4, dy^2, fma(c3, dx^2, fma(c2, dy, fma(c1, dx, c0))))) (dx^2,
//   dy^2, dx dy are exact). coeff_walk_bwd.cuh::cb_power pins another
//   order (K9's backward is held to its design before by tolerance, not
//   by bits), so it is not reused here. The colour sum is pinned to the
//   fma(w, col, acc) that acc += w * col contracts to.
// - Stores: the tile's [256][C + 1] block (pixel p = dy * 16 + dx, its C
//   colours then T_bg adjacent; 11 x 256 floats at C 10, more than the
//   staged rows hold, hence the union) is built pixel-major in shared
//   memory after the walk and written as 16 rows of 16 (C + 1) floats in
//   16-byte stores (cf_store: K8's and K9's outputs are both tile-
//   contiguous, so the rows are one run; fw_store_rows' pattern).
//
// Stage cuts (STAGE, default 2: the whole walk), each writing what it
// computed so that no stage is dead code:
//   0  the caller's selection, the staging and the stores (each thread's
//      staged c0 folded into its T_bg)
//   1  + the lists, the batches' row loads, polynomials and exps over
//      every listed slot (their sum folded in; no T chain, so no pixel
//      stops)
//   2  + the T chain: the walk itself

#pragma once

#include "coeff_walk_bwd.cuh"

#define CF_CHUNK 128  // slots a chunk: one staged row a thread at CB_P = 2
#define CF_R 8        // slots a batch (chip_smoke.py times 1, 2, 4 and 8)
#define CF_MAX_CR 11  // C + 1 at the largest C built (CW_SWITCH_C: 10)

// A chunk's staged rows (CB_ROW floats: c0..c5, the opacity, C colours,
// the band word in CB_BAND) and, after the walk, the tile's output block
// over them; each warp's list of the chunk's slots it takes, in order.
template <int P>
struct CfShared {
  union {
    __align__(16) float rec[CF_CHUNK][CB_ROW];
    __align__(16) float out[CW_NPIX * CF_MAX_CR];
  };
  __align__(16) int list[cb_warps<P>][CF_CHUNK];
};

// The falloff power at the thread's P pixels in coeff_walk_fwd's
// roundings (the header's chain), and its exp.
template <int P>
__device__ __forceinline__ void cf_power(const float (&rc)[7], float fx, const float (&fy)[P],
                                         float (&pw)[P], float (&e)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float a = __fmaf_rn(rc[3], fx * fx, __fmaf_rn(rc[2], fy[j], __fmaf_rn(rc[1], fx, rc[0])));
    pw[j] = __fmaf_rn(rc[5], fx * fy[j], __fmaf_rn(rc[4], fy[j] * fy[j], a));
    e[j] = expf(pw[j]);
  }
}

// cf_power as coeff_walk_bwd_px's power policy: K8's backward takes the
// pairs its forward takes.
struct CfPower {
  template <int P>
  __device__ __forceinline__ static void eval(const float (&rc)[7], float fx, const float (&fy)[P],
                                              float (&pw)[P], float (&e)[P]) {
    cf_power<P>(rc, fx, fy, pw, e);
  }
};

// Forward of one tile's n slots by the calling block of cb_threads<P>
// threads: thread t's pixels cb_pixel<P>(t, j) get their colours acc[j]
// and T_bg T[j]. stage.template rows<false>(base, m, r, s) is called by
// one thread for each r < m to write slot base + r's row (and its band
// word) into s.rec[r]: the staging functors serve this walk and
// coeff_walk_bwd.cuh's.
template <int C, int P, int R, int STAGE = 2, class Stage>
__device__ __forceinline__ void coeff_walk_fwd_px(int n, const Stage& stage, CfShared<P>& s,
                                                  float (&acc)[P][C], float (&T)[P]) {
  static_assert(7 + C <= CB_BAND && C + 1 <= CF_MAX_CR, "C above 10");
  static_assert(CF_CHUNK % 32 == 0 && CF_CHUNK % R == 0, "whole batches a chunk");
  constexpr int NR4 = (7 + C + 3) / 4;  // 16-byte loads a row
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float fx = (float)(t % CW_TILE);
  float fy[P];
  bool done[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    fy[j] = (float)(cb_pixel<P>(t, j) / CW_TILE);
    T[j] = 1.0f;
    done[j] = false;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0f;
  }
  float fold = 0.0f;  // the stage cuts' sink for what they compute
  int* list = s.list[warp];

  for (int base = 0; base < n; base += CF_CHUNK) {
    const int m = min(CF_CHUNK, n - base);
    __syncthreads();  // the previous chunk has been read
    for (int r = t; r < m; r += cb_threads<P>) stage.template rows<false>(base, m, r, s);
    __syncthreads();
    if constexpr (STAGE == 0) {
      if (t < m) fold += s.rec[t][0];
      continue;
    }
    // the chunk's slots some band of this warp can take, listed in order:
    // nt of them (warp-uniform)
    int nt = 0;
#pragma unroll
    for (int i = 0; i < CF_CHUNK / 32; ++i) {
      const int k = 32 * i + lane;
      const bool take =
          k < m && ((__float_as_uint(s.rec[k][CB_BAND]) >> (warp * P)) & ((1u << P) - 1u)) != 0u;
      const unsigned b = __ballot_sync(CW_FULL_MASK, take);
      if (take) list[nt + __popc(b & ((1u << lane) - 1u))] = k;
      nt += __popc(b);
    }
    __syncwarp();
    for (int i0 = 0; i0 < nt; i0 += R) {
      if constexpr (STAGE >= 2) {
        if (__all_sync(CW_FULL_MASK, cb_all(done))) break;
      }
      // the batch: R listed slots (those at i0 + r >= nt are not walked;
      // their entries are older ones, read in range)
      int k[R];
      if constexpr (R % 4 == 0) {
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          const int4 v = *reinterpret_cast<const int4*>(list + i0 + r);
          k[r] = v.x;
          k[r + 1] = v.y;
          k[r + 2] = v.z;
          k[r + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) k[r] = list[i0 + r];
      }
      float col[R][C], pw[R][P], e[R][P], alpha[R][P];
      bool live[R][P];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* row = s.rec[k[r] & (CF_CHUNK - 1)];
        float v[4 * NR4];
#pragma unroll
        for (int i = 0; i < NR4; ++i) {
          const float4 q = reinterpret_cast<const float4*>(row)[i];
          v[4 * i] = q.x;
          v[4 * i + 1] = q.y;
          v[4 * i + 2] = q.z;
          v[4 * i + 3] = q.w;
        }
        float rc[7];
#pragma unroll
        for (int i = 0; i < 7; ++i) rc[i] = v[i];
#pragma unroll
        for (int c = 0; c < C; ++c) col[r][c] = v[7 + c];
        cf_power<P>(rc, fx, fy, pw[r], e[r]);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float raw = rc[6] * e[r][j];
          alpha[r][j] = fminf(CW_ALPHA_MAX, raw);
          live[r][j] = i0 + r < nt && pw[r][j] <= 0.0f && raw >= CW_ALPHA_SKIP;
        }
      }
      if constexpr (STAGE == 1) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < P; ++j) fold += i0 + r < nt ? e[r][j] + col[r][0] : 0.0f;
        continue;
      }
      // the chain, in slot order: selects, no branch, so that the batch's
      // loads, polynomials and exps can all run ahead of it
#pragma unroll
      for (int r = 0; r < (STAGE >= 2 ? R : 0); ++r) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float test_T = T[j] * (1.0f - alpha[r][j]);
          const bool use = live[r][j] && !done[j];
          const bool stop = use && test_T < CW_T_EPS;
          const bool take = use && !stop;
          const float w = alpha[r][j] * T[j];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float a = __fmaf_rn(w, col[r][c], acc[j][c]);
            acc[j][c] = take ? a : acc[j][c];
          }
          T[j] = take ? test_T : T[j];
          done[j] = done[j] || stop;
        }
      }
    }
    if (__syncthreads_and(cb_all(done))) break;
  }
  if constexpr (STAGE < 2) T[0] += fold;
}

// The tile's [256][C+1] block (pixel p = dy * 16 + dx, its C colours then
// T_bg adjacent) from thread t's pixels' acc and T, staged pixel-major
// through s (free once the walk is done) and written to out, the tile's
// contiguous block, as 16-byte stores: its 16 rows of 16 (C + 1) floats
// are one run. out must be 16-byte aligned. The staged writes run at a
// stride of C + 1 floats: free of bank conflicts at odd C + 1 (C 6 among
// them), 2- to 8-way at even C + 1.
template <int C, int P>
__device__ __forceinline__ void cf_store(CfShared<P>& s, const float (&acc)[P][C],
                                         const float (&T)[P], float* __restrict__ out) {
  float* so = s.out;
  const int t = threadIdx.x;
  __syncthreads();  // every warp's walk has read its last row
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float* sp = so + cb_pixel<P>(t, j) * (C + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) sp[c] = acc[j][c];
    sp[C] = T[j];
  }
  __syncthreads();
  for (int e = t; e < CW_NPIX * (C + 1) / 4; e += cb_threads<P>)
    reinterpret_cast<float4*>(out)[e] = reinterpret_cast<const float4*>(so)[e];
}
