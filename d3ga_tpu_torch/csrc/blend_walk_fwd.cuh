// K2's blend forward walk (blend_ct.cu; K5's and K7's forwards in
// blend_rec.cu walk with it too): the front-to-back alpha blend of one
// 16x16 tile, two pixels a thread, in batches of records. It computes
// what blend_walk.cuh::blend_walk_fwd computes, bit for bit: per pixel
// the same records are taken in the same order with the same arithmetic
// (the falloff polynomial, power <= 0, e = exp(c0 + log op + q) >= 1/255,
// alpha = min(0.99, e), the walk stops before the record where
// T * (1 - alpha) < 1e-4, acc += alpha T col, T *= 1 - alpha). Only the
// work that cannot change a pixel's state is left out or done early.
//
// Replaces (with blend_ct.cu) the TPU kernel
// d3ga_tpu/raster/pallas_blend_ct.py::_run_forward_ct (_forward_body_ct,
// _blend_fwd_ct, _coeffs_ct), with the record gather of
// pallas_segsum.py::blend_gather_segsum_ct's primal folded in.
//
// Design, and why. blend_walk_fwd (one thread a pixel, 8 warps a tile)
// runs every record as one dependent chain: 7 scalar broadcast loads (6
// more where a lane takes it), the polynomial, the exp, the tests, then
// the T update, behind a branch the compiler cannot schedule across; at
// the champion scene 394 of 2,688 tiles are full (256 records), ~3 an SM
// on average (up to 8 on one), so few warps are there to hide it.
// Here:
// - Two pixels a thread (BW_P, bw_pixel): 128 threads, four warps, one
//   tile a block; the pixels' chains interleave.
// - The band cull of K3's walk (bw_stage marks the 2-row bands a record
//   can reach; bw_bands): a warp skips a record neither of its bands can
//   take. No pixel of the warp would take it, so T, the sums and the stop
//   are what the walk without the cull gives.
// - Record batches. A record's polynomial, exp and tests do not depend on
//   the records before it; only T does. After staging a chunk, each warp
//   ballots the chunk's band words and lists the records it takes, in
//   order, in shared memory (warp-uniform), and walks the list R records
//   at a time: first the R ids (one 16-byte load for four), the R rows
//   (four broadcast 16-byte loads each) and the R x P polynomials and
//   exps, then the records' tests and T updates in record order, which is
//   all that stays on the chain: T * (1 - alpha), the compare, the
//   selects. The batch is one basic block (the chain selects, it does not
//   branch; a batch past the list's end walks nothing for its tail), so
//   the compiler can run its loads and exps ahead of the chain. A first
//   version branched past a batch's missing records, so nvcc sank each
//   record's exp behind the record before, and walked a 64-bit mask of
//   the records (~20 instructions a record to find the next): 0.087 ms at
//   the champion selection on an NVIDIA H100 80GB HBM3 (700 W) where this
//   takes 0.060 and the design before 0.100. Exps computed past a
//   pixel's stop are discarded; a warp leaves the chunk once all its
//   pixels have stopped, and a block vote after each chunk ends the tile.
//   R = 8: chip_smoke.py times R = 1, 2, 4 and 8 in turns.
// - Stores: the tile's C + 1 planes are built in shared memory (over the
//   staged rows, after the walk) and written as coalesced 16-byte stores,
//   the empty tiles' zeros and T_bg = 1 among them (fw_store). K5 and K7
//   write each pixel's C + 1 values adjacent; they stage the tile
//   pixel-major and write its 16 rows of 16 (C + 1) floats the same way
//   (fw_store_rows), where one thread a pixel storing its own values
//   spans (C + 1) x 128 bytes a warp store for 128 bytes written.
//
// Stage cuts (STAGE, default 2: the whole walk), each writing what it
// computed so that no stage is dead code:
//   0  staging and the stores (each thread's staged c0 + log op folded
//      into its T_bg)
//   1  + the lists, the batches' row loads, polynomials and exps over
//      every listed record (their sum folded in; no T chain, so no pixel
//      stops)
//   2  + the T chain: the walk itself

#pragma once

#include "blend_walk_bwd.cuh"

#define FW_CHUNK 128  // records a chunk: one staged row a thread at BW_P = 2
#define FW_R 8        // records a batch (chip_smoke.py times 1, 2, 4 and 8)

// A chunk's staged rows (bw_stage; after the walk, the tile's output
// planes [(C+1)][256], C + 1 <= 10) and each warp's list of the chunk's
// records it takes, in order.
template <int P>
struct FwShared {
  __align__(16) float rec[FW_CHUNK][BW_ROW];
  __align__(16) int list[bw_warps<P>][FW_CHUNK];
};

// The falloff polynomial's part past c0 and its exp at the thread's P
// pixels for staged record rc, in blend_walk_fwd's roundings: nvcc
// contracts that walk's c2 fx + c3 fy + ... to fma(c2, fx, c3 fy) first
// (bw_q, K3's, pins fma(c3, fy, c2 fx), which differs in the last bit),
// then adds c4 fx^2, c5 fy^2, c6 fx fy by FMAs (fx^2, fy^2, fx fy are
// exact), and takes expf(c0 + log op + q).
template <int P>
__device__ __forceinline__ void fw_power(const float (&rc)[7], float fx, const float (&fy)[P],
                                         float (&q)[P], float (&e)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float t = __fmaf_rn(rc[4], fx * fx, __fmaf_rn(rc[2], fx, __fmul_rn(rc[3], fy[j])));
    q[j] = __fmaf_rn(rc[6], fx * fy[j], __fmaf_rn(rc[5], fy[j] * fy[j], t));
    e[j] = expf(__fadd_rn(rc[1], q[j]));
  }
}

// Forward of one tile by the calling block of bw_threads<P> threads:
// thread t's pixels bw_pixel<P>(t, j) get their colours acc[j] and T_bg
// T[j]. tidx holds the tile's record ids, cnt (clamped to [0, K]) of them
// live; vec: rec is 16-byte aligned and CR % 4 == 0.
template <int C, int P, int R, int STAGE = 2>
__device__ __forceinline__ void blend_walk_fwd_px(const float* __restrict__ rec, int n_ext, int CR,
                                                  bool vec, const int* __restrict__ tidx, int cnt,
                                                  float sx, float sy, FwShared<P>& s,
                                                  float (&acc)[P][C], float (&T)[P]) {
  static_assert(7 + C <= BW_ROW, "C above 8");
  static_assert(FW_CHUNK % 32 == 0 && FW_CHUNK % R == 0, "whole batches a chunk");
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float fx = (float)(t % TILE);
  float fy[P];
  bool done[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    fy[j] = (float)(bw_pixel<P>(t, j) / TILE);
    T[j] = 1.0f;
    done[j] = false;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[j][c] = 0.0f;
  }
  float fold = 0.0f;  // the stage cuts' sink for what they compute
  int* list = s.list[warp];

  for (int base = 0; base < cnt; base += FW_CHUNK) {
    const int n = min(FW_CHUNK, cnt - base);
    __syncthreads();  // the previous chunk has been read
    for (int r = t; r < n; r += bw_threads<P>)
      bw_stage<C, P, false>(rec, n_ext, CR, vec, true, tidx, base, n, sx, sy, s, r);
    __syncthreads();
    if constexpr (STAGE == 0) {
      if (t < n) fold += s.rec[t][1];
      continue;
    }
    // the chunk's records some band of this warp can take, listed in
    // order: nt of them (warp-uniform)
    int nt = 0;
#pragma unroll
    for (int i = 0; i < FW_CHUNK / 32; ++i) {
      const int k = 32 * i + lane;
      const bool take = k < n && bw_bands<P>(s.rec[k], warp) != 0u;
      const unsigned b = __ballot_sync(FULL_MASK, take);
      if (take) list[nt + __popc(b & ((1u << lane) - 1u))] = k;
      nt += __popc(b);
    }
    __syncwarp();
    for (int i0 = 0; i0 < nt; i0 += R) {
      if constexpr (STAGE >= 2) {
        if (__all_sync(FULL_MASK, bw_all(done))) break;
      }
      // the batch: R listed records (those at i0 + r >= nt are not
      // walked; their slots hold older entries, read in range)
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
      float rc[R][7], col[R][C], q[R][P], e[R][P];
#pragma unroll
      for (int r = 0; r < R; ++r) bw_row<C>(s.rec[k[r] & (FW_CHUNK - 1)], rc[r], col[r]);
#pragma unroll
      for (int r = 0; r < R; ++r) fw_power<P>(rc[r], fx, fy, q[r], e[r]);
      if constexpr (STAGE == 1) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < P; ++j) fold += i0 + r < nt ? e[r][j] + col[r][0] : 0.0f;
        continue;
      }
      // the chain, in record order: selects, no branch, so that the
      // batch's loads, polynomials and exps can all run ahead of it
#pragma unroll
      for (int r = 0; r < (STAGE >= 2 ? R : 0); ++r) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float alpha = fminf(ALPHA_MAX, e[r][j]);
          const float test_T = T[j] * (1.0f - alpha);
          const bool use = i0 + r < nt && !done[j] && rc[r][0] + q[r][j] <= 0.0f &&
                           e[r][j] >= ALPHA_SKIP;
          const bool stop = use && test_T < T_EPS;
          const bool take = use && !stop;
          const float w = alpha * T[j];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            const float a = acc[j][c] + w * col[r][c];
            acc[j][c] = take ? a : acc[j][c];
          }
          T[j] = take ? test_T : T[j];
          done[j] = done[j] || stop;
        }
      }
    }
    if (__syncthreads_and(bw_all(done))) break;
  }
  if constexpr (STAGE < 2) T[0] += fold;
}

// The tile's planes of the planar image out [(C+1), nty*16, ntx*16] (T_bg
// last) from thread t's pixels' acc and T, staged through s (free once
// the walk is done) and written as 16-byte stores: 64 a plane, four a
// tile row. out must be 16-byte aligned (the rows of a tile are, ntx * 16
// floats apart).
template <int C, int P>
__device__ __forceinline__ void fw_store(FwShared<P>& s, const float (&acc)[P][C],
                                         const float (&T)[P], float* __restrict__ out, int ntx,
                                         int nty, int tx, int ty) {
  static_assert((C + 1) * NPIX <= FW_CHUNK * BW_ROW, "the planes fit over the staged rows");
  float* so = &s.rec[0][0];
  const int t = threadIdx.x;
  __syncthreads();  // every warp's walk has read its last row
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = bw_pixel<P>(t, j);
#pragma unroll
    for (int c = 0; c < C; ++c) so[c * NPIX + p] = acc[j][c];
    so[C * NPIX + p] = T[j];
  }
  __syncthreads();
  const long long wp = (long long)ntx * TILE;
  const long long plane = (long long)nty * TILE * wp;
  float* o = out + (long long)ty * TILE * wp + tx * TILE;
  for (int e = t; e < (C + 1) * NPIX / 4; e += bw_threads<P>) {
    const int c = e / (NPIX / 4), f = e % (NPIX / 4);  // plane; row f / 4, quad f % 4
    reinterpret_cast<float4*>(o + c * plane + (f / 4) * wp)[f % 4] =
        reinterpret_cast<const float4*>(so)[e];
  }
}

// The tile's [256][C+1] block (pixel p = dy * 16 + dx, its C colours then
// T_bg adjacent) from thread t's pixels' acc and T, staged pixel-major
// through s (free once the walk is done) and written as 16-byte stores:
// tile row dy, 16 (C + 1) contiguous floats, goes to out + dy * pitch
// (K5's tile-major block: pitch 16 (C + 1), the whole block contiguous;
// K7's image: pitch ntx * 16 * (C + 1)). out must be 16-byte aligned;
// every row start then is (pitch is a multiple of 16 floats). The staged
// writes run at a stride of C + 1 floats: free of bank conflicts at odd
// C + 1 (C 6 among them), 2- to 8-way at even C + 1.
template <int C, int P>
__device__ __forceinline__ void fw_store_rows(FwShared<P>& s, const float (&acc)[P][C],
                                              const float (&T)[P], float* __restrict__ out,
                                              long long pitch) {
  static_assert((C + 1) * NPIX <= FW_CHUNK * BW_ROW, "the block fits over the staged rows");
  constexpr int ROW4 = TILE * (C + 1) / 4;  // 16-byte vectors a tile row
  float* so = &s.rec[0][0];
  const int t = threadIdx.x;
  __syncthreads();  // every warp's walk has read its last row
#pragma unroll
  for (int j = 0; j < P; ++j) {
    float* sp = so + bw_pixel<P>(t, j) * (C + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) sp[c] = acc[j][c];
    sp[C] = T[j];
  }
  __syncthreads();
  for (int e = t; e < TILE * ROW4; e += bw_threads<P>)
    reinterpret_cast<float4*>(out + (e / ROW4) * pitch)[e % ROW4] =
        reinterpret_cast<const float4*>(so)[e];
}
