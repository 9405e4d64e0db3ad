// K9: fused per-tile selection + compaction + alpha blend over 8x8-tile
// blocks of candidates, forward and backward.
//
// Replaces the TPU kernels d3ga_tpu/raster/attic/pallas_fused.py::
// _run_forward / _run_backward (v1: banded one-hot matmul compaction) and
// attic/pallas_fused2.py::_run_forward / _run_backward (v2: butterfly
// lane-roll compaction). Both compute one function and differ only in how
// a TPU moves lanes, so one forward and one backward kernel serve both;
// the wrappers hand either layout over as records-major vals [NB, kb, 16]
// (the layout the fused raster builds): candidate j of block b is the 16
// floats at (b * kb + j) * 16, channels (x, y in block-local pixels,
// conic A, B, C, opacity, C colours, padding). rects [NB, kb] int32 pack
// each candidate's block-local tile rect (xmin | xmax << 8 | ymin << 16 |
// ymax << 24; 0 never overlaps).
//
// Per tile (tx, ty) of block b: the candidates whose rect holds the tile,
// in lane (depth-rank) order, the first K of them compacted; the tile's
// count is the uncapped number. Each compacted record becomes the six
// falloff coefficients in tile-local pixels (x - 16 tx, y - 16 ty; the
// JAX kernels' _coeffs_from_rec), then the polynomial walk. Output
// tiles [NB, 64, 256, C+1] (T_bg last), counts [NB, 64]. The backward
// returns d(vals) [NB, kb, 16]; the padding channels and the candidates no
// tile selected get 0.
//
// Bound on Hopper. Operations: a (pixel, slot) pair the walk uses (power
// <= 0 and raw >= 1/255) costs one exp and 15 + 2C FP32 operations
// forward, 35 + 4C and an exp and a division backward; a visited pair it
// does not use only the polynomial, its test and an exp (chip_smoke.py
// counts both kinds from its run's data). The selection reads each
// block's kb rects once per tile (64 x 16 KB at kb 4096, from L2). Bytes
// at the full-width scene (48 blocks, kb 4096, C 6): the 6 + C used
// channels of the selected candidates (at most 9.4 MB) and 0.8 MB rects
// in, 22 MB tiles out; the backward adds the cotangent of the tiles that
// hold a slot (up to 22 MB) in and 12.6 MB of d(vals) out. At frame 0 of
// chip_smoke.py's scene (19.33 M pairs visited, 3.21 M used, 447 tiles
// holding a slot) the backward's bound is 0.0055 ms (operations; bytes
// 0.0054), the forward's 0.0073 (bytes).
//
// Design. The TPU grid is one program per block (48 at full width); here
// one CUDA block per tile (3,072).
//   Forward (fused_fwd_kernel, 128 threads): the block scans its 8x8
//   block's kb rects 256 at a time, two consecutive rects a thread in one
//   8-byte load (select_tile_pairs: 16 rounds at kb 4,096, each with two
//   barriers, where one rect a thread at 128 threads would take 32); two
//   warp ballots and the per-warp popcounts give each overlapping
//   candidate its position in lane order, and the first K lane ids go to
//   shared memory (K ints). Then coeff_walk_fwd.cuh's walk (K2's design on
//   K9's rule: two pixels a thread, a 2-row band cull, per-warp slot lists
//   in batches of 8; that header says why), which stages its chunks
//   through those ids straight from vals with the backward's staging
//   (coeff_walk_bwd.cuh::cb_stage: the tile-local coefficients and the
//   ellipse's bands): the [K, 16] compacted record block of the TPU
//   kernels is never written. The tile's [256, C+1] block is built in
//   shared memory and written as 16-byte stores (cf_store). Its image is
//   the design before's to the bit. The design before (256 threads, one a
//   pixel, coeff_walk.cuh's coeff_walk_fwd, each thread storing its
//   pixel's C + 1 floats at a (C + 1) x 4-byte stride) stays as
//   fused_kernel_v1, launched by d3ga_fused_v1 (chip_smoke.py only) and,
//   cut, by d3ga_fused_stage (P3). d3ga_fused_fwd_stage launches the new
//   kernel with its band cull off (the reference for the cull's bits) at
//   every C and, at FB_STAGE_C only, cut at a stage (coeff_walk_fwd.cuh's
//   STAGE: 0 selection + staging + stores, 1 + lists, polynomials and
//   exps, 2 the kernel) or with 1, 2 or 4 slots a batch.
//   Backward, kernel 1 (per tile, fused_bwd_kernel): the same selection,
//   then coeff_walk_bwd.cuh's walk (two pixels a thread, 128 threads a
//   tile; a warp skips the slots its 2-row bands cannot take; per-slot
//   sums by a warp reduce-scatter; that header says why): per slot the
//   cotangents of (x, y, A, B, C, opacity, colours), the coefficients'
//   transpose applied in the tile's own coordinates, built in shared
//   memory and written [NB * 64, K, 6 + C] as one contiguous run of
//   16-byte stores a chunk, with the slots' lane ids and the tile's
//   live-slot count (scratch the wrapper allocates).
//   Backward, kernel 2 (per block and lane): the 64 tiles of a block share
//   its candidate lanes. One thread per (block, lane) visits the tiles its
//   rect covers in tile order, finds its slot by binary search in each
//   tile's ascending lane list, and sums the slot rows: deterministic, no
//   atomics, the TPU kernels' order (tile 0 to 63).
//
// The backward's design before (one thread a pixel, coeff_walk.cuh's
// coeff_walk_bwd: 8 warps a tile, every slot evaluated at every pixel, 7 +
// C butterflies a slot a warp, each slot's row stored by one thread) stays
// as fused_bwd_kernel_v1, launched by d3ga_fused_bwd_v1 only.
// d3ga_fused_bwd_stage launches the new kernel with its band cull off (the
// reference for the cull's bits) at every C, and, at C = FB_STAGE_C (the
// champion's 6) only, the kernel cut at a stage (the walk's STAGE
// parameter: 0 selection + staging, 1 + walk 1, 2 + walk 2's per-pixel
// arithmetic, 3 + the per-slot sums; 4 is the kernel) or its walk at 1 or
// 4 pixels a thread. No path of the port calls them: chip_smoke.py checks
// the cull and times the designs and the stages in turns.
//
// Stage cuts (probe P3, the counterpart of the TPU bisect
// tools/fused_bisect.py): fused_kernel_v1's STAGE parameter stops the
// design before early, so each cut runs its code up to its point. STAGE
// 0 writes 1.0 to every output; 1 runs the selection and writes the tile's
// count to every pixel and channel; 2 also sums channels [0, C] of the
// first min(count, K) selected candidates (threads stride the slots, then
// warp shuffles and the 8 warps' partials in order) and writes that sum
// plus the count; 3 is the whole design before, K9's tiles to the bit.
// Only STAGE 3 writes counts.

#include <cstdint>

#include "coeff_walk.cuh"
#include "coeff_walk_bwd.cuh"
#include "coeff_walk_fwd.cuh"

#define FB_BLOCK 8
#define FB_TB (FB_BLOCK * FB_BLOCK)
#define FB_NCH 16
#define FB_STAGE_C 6  // the C the stage cuts and the pixel and batch variants are built for

// Candidate j of a block's records.
__device__ __forceinline__ const float* cand(const float* vb, int j) {
  return vb + (long long)j * FB_NCH;
}

// Whether packed rect r (xmin | xmax << 8 | ymin << 16 | ymax << 24)
// holds tile (tx, ty); rect 0 holds none.
__device__ __forceinline__ bool fb_holds(int r, int tx, int ty) {
  return tx >= (r & 0xFF) && tx < ((r >> 8) & 0xFF) && ty >= ((r >> 16) & 0xFF) &&
         ty < ((r >> 24) & 0xFF);
}

// The first K candidates (lane order) whose rect holds tile (tx, ty) into
// s_sel, by a block of THREADS threads (s_warp: THREADS / 32 ints);
// returns how many hold it (uncapped). Ends synchronized.
template <int THREADS = CW_NPIX>
__device__ __forceinline__ int select_tile(const int* __restrict__ rects_b, int kb, int tx, int ty,
                                           int K, int* s_sel, int* s_warp) {
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  int running = 0;
  for (int base = 0; base < kb; base += THREADS) {
    const int j = base + p;
    bool m = false;
    if (j < kb) m = fb_holds(rects_b[j], tx, ty);
    const unsigned ballot = __ballot_sync(CW_FULL_MASK, m);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int pos = running + before + __popc(ballot & ((1u << lane) - 1u));
    if (m && pos < K) s_sel[pos] = j;
    running += total;
    __syncthreads();  // s_warp is rewritten by the next round
  }
  return running;
}

// select_tile's result (the same positions in lane order) by a block of
// THREADS threads testing two consecutive rects a round: kb / (2 THREADS)
// rounds, where select_tile<128> takes twice as many, each with its two
// barriers. A thread's pair is one 8-byte load with vec (rects_b 8-byte
// aligned, kb even), else two; lane l's two candidates come before lane
// l + 1's. Ends synchronized.
template <int THREADS>
__device__ __forceinline__ int select_tile_pairs(const int* __restrict__ rects_b, int kb, int tx,
                                                 int ty, int K, bool vec, int* s_sel,
                                                 int* s_warp) {
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const unsigned below = (1u << lane) - 1u;
  int running = 0;
  for (int base = 0; base < kb; base += 2 * THREADS) {
    const int j = base + 2 * p;
    int r0 = 0, r1 = 0;
    if (vec && j + 1 < kb) {
      const int2 v = *reinterpret_cast<const int2*>(rects_b + j);
      r0 = v.x;
      r1 = v.y;
    } else {
      if (j < kb) r0 = rects_b[j];
      if (j + 1 < kb) r1 = rects_b[j + 1];
    }
    const bool m0 = fb_holds(r0, tx, ty);
    const bool m1 = fb_holds(r1, tx, ty);
    const unsigned b0 = __ballot_sync(CW_FULL_MASK, m0);
    const unsigned b1 = __ballot_sync(CW_FULL_MASK, m1);
    if (lane == 0) s_warp[warp] = __popc(b0) + __popc(b1);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int pos = running + before + __popc(b0 & below) + __popc(b1 & below);
    if (m0 && pos < K) s_sel[pos] = j;
    if (m1 && pos + m0 < K) s_sel[pos + m0] = j + 1;
    running += total;
    __syncthreads();  // s_warp is rewritten by the next round
  }
  return running;
}

// Stages compacted slot k (candidate s_sel[k]) as tile-local coefficients.
template <int C>
struct CandRows {
  const float* vb;
  const int* s_sel;
  float sx, sy;
  template <class Chunk>
  __device__ __forceinline__ void operator()(int k, int j, Chunk& s) const {
    const float* r = cand(vb, s_sel[k]);
    const float x = r[0] - sx;
    const float y = r[1] - sy;
    const float A = r[2], B = r[3], Cc = r[4];
    s.c[0][j] = -0.5f * (A * x * x + Cc * y * y) - B * x * y;
    s.c[1][j] = A * x + B * y;
    s.c[2][j] = Cc * y + B * x;
    s.c[3][j] = -0.5f * A;
    s.c[4][j] = -0.5f * Cc;
    s.c[5][j] = -B;
    s.op[j] = r[5];
#pragma unroll
    for (int c = 0; c < C; ++c) s.col[c][j] = r[6 + c];
  }
};

// The forward's design before: one thread a pixel, coeff_walk_fwd, each
// thread storing its pixel's C + 1 floats; STAGE cuts it for P3.
template <int C, int STAGE = 3>
__global__ void __launch_bounds__(CW_NPIX)
fused_kernel_v1(const float* __restrict__ vals, const int* __restrict__ rects, int kb, int K,
                float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ int s_sel[];  // K lane ids
  __shared__ int s_warp[CW_NWARP];
  const int bt = blockIdx.x;
  const int b = bt / FB_TB, t = bt % FB_TB;
  const int tx = t % FB_BLOCK, ty = t / FB_BLOCK;
  const int p = threadIdx.x;
  float* o = out + ((long long)bt * CW_NPIX + p) * (C + 1);
  if constexpr (STAGE == 0) {
#pragma unroll
    for (int c = 0; c <= C; ++c) o[c] = 1.0f;
    return;
  }
  const int cnt = select_tile(rects + (long long)b * kb, kb, tx, ty, K, s_sel, s_warp);
  if constexpr (STAGE == 1) {
#pragma unroll
    for (int c = 0; c <= C; ++c) o[c] = (float)cnt;
    return;
  }
  const float* vb = vals + (long long)b * kb * FB_NCH;
  if constexpr (STAGE == 2) {
    __shared__ float s_red[CW_NWARP][C + 1];
    float part[C + 1];
#pragma unroll
    for (int c = 0; c <= C; ++c) part[c] = 0.0f;
    for (int k = p; k < min(cnt, K); k += CW_NPIX) {
      const float* r = cand(vb, s_sel[k]);
#pragma unroll
      for (int c = 0; c <= C; ++c) part[c] += r[c];
    }
#pragma unroll
    for (int c = 0; c <= C; ++c) {
      const float v = cw_warp_sum(part[c]);
      if ((p & 31) == 0) s_red[p >> 5][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c <= C; ++c) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < CW_NWARP; ++w) sum += s_red[w][c];
      o[c] = sum + (float)cnt;
    }
    return;
  }
  if (p == 0) counts[bt] = cnt;
  const CandRows<C> rows{vb, s_sel, (float)(tx * CW_TILE), (float)(ty * CW_TILE)};
  float acc[C];
  const float T = coeff_walk_fwd<C>(min(cnt, K), rows, acc);
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = acc[c];
  o[C] = T;
}

// Stages slot base + r of the walk: candidate s_sel[base + r], by K9's
// backward's staging (tile-local coefficients and the ellipse's bands;
// with GEO, the backward's walk 2, its geometry too).
template <int C, int P>
struct CandStage {
  const float* vb;
  const int* s_sel;
  float sx, sy;
  bool vec, cull;
  template <bool GEO, class Sh>
  __device__ __forceinline__ void rows(int base, int m, int r, Sh& s) const {
    cb_stage<C, P, GEO>(vb, vec, cull, s_sel, base, m, sx, sy, s, r);
  }
};

// The forward: select_tile_pairs, then coeff_walk_fwd_px at P pixels a
// thread and R slots a batch (coeff_walk_fwd.cuh), the tile's block
// written by cf_store. vec: vals 16-byte aligned; rvec: rects 8-byte
// aligned and kb even; cull: the band cull on. Dynamic shared memory: K
// lane ids. Counts are written at every STAGE.
template <int C, int P = CB_P, int R = CF_R, int STAGE = 2>
__global__ void __launch_bounds__(cb_threads<P>)
fused_fwd_kernel(const float* __restrict__ vals, const int* __restrict__ rects, int kb, int K,
                 int vec, int rvec, int cull, float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ int s_sel[];  // K lane ids
  __shared__ int s_warp[cb_warps<P>];
  __shared__ CfShared<P> s;
  const int bt = blockIdx.x;
  const int b = bt / FB_TB, t = bt % FB_TB;
  const int tx = t % FB_BLOCK, ty = t / FB_BLOCK;
  const int cnt = select_tile_pairs<cb_threads<P>>(rects + (long long)b * kb, kb, tx, ty, K,
                                                   rvec != 0, s_sel, s_warp);
  if (threadIdx.x == 0) counts[bt] = cnt;
  const CandStage<C, P> stage{vals + (long long)b * kb * FB_NCH, s_sel, (float)(tx * CW_TILE),
                              (float)(ty * CW_TILE), vec != 0, cull != 0};
  float acc[P][C], T[P];
  coeff_walk_fwd_px<C, P, R, STAGE>(min(cnt, K), stage, s, acc, T);
  cf_store<C, P>(s, acc, T, out + (long long)bt * CW_NPIX * (C + 1));
}

// The backward's design before: one thread a pixel, coeff_walk_bwd.
template <int C>
__global__ void __launch_bounds__(CW_NPIX)
fused_bwd_kernel_v1(const float* __restrict__ vals, const int* __restrict__ rects,
                    const float* __restrict__ g, int kb, int K, float* __restrict__ drec,
                    int* __restrict__ sel, int* __restrict__ live) {
  extern __shared__ int s_sel[];
  __shared__ int s_warp[CW_NWARP];
  const int bt = blockIdx.x;
  const int b = bt / FB_TB, t = bt % FB_TB;
  const int tx = t % FB_BLOCK, ty = t / FB_BLOCK;
  const int p = threadIdx.x;
  const int n = min(select_tile(rects + (long long)b * kb, kb, tx, ty, K, s_sel, s_warp), K);
  if (p == 0) live[bt] = n;
  for (int k = p; k < n; k += CW_NPIX) sel[(long long)bt * K + k] = s_sel[k];
  const float sx = (float)(tx * CW_TILE), sy = (float)(ty * CW_TILE);
  const float* vb = vals + (long long)b * kb * FB_NCH;
  const CandRows<C> rows{vb, s_sel, sx, sy};
  const float* gp = g + ((long long)bt * CW_NPIX + p) * (C + 1);
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = gp[c];
  float* tdrec = drec + (long long)bt * K * (6 + C);
  const int* ids = s_sel;
  coeff_walk_bwd<C>(n, rows, gc, gp[C], [&](int k, const float* d) {
    // the transpose of the coefficients (_coeffs_transpose)
    const float* r = cand(vb, ids[k]);
    const float x = r[0] - sx;
    const float y = r[1] - sy;
    const float A = r[2], B = r[3], Cc = r[4];
    float* o = tdrec + (long long)k * (6 + C);
    o[0] = -d[0] * (A * x + B * y) + d[1] * A + d[2] * B;
    o[1] = -d[0] * (Cc * y + B * x) + d[1] * B + d[2] * Cc;
    o[2] = -0.5f * d[0] * x * x + d[1] * x - 0.5f * d[3];
    o[3] = -d[0] * x * y + d[1] * y + d[2] * x - d[5];
    o[4] = -0.5f * d[0] * y * y + d[2] * y - 0.5f * d[4];
    o[5] = d[6];
#pragma unroll
    for (int c = 0; c < C; ++c) o[6 + c] = d[7 + c];
  });
}

// The backward's epilogue (coeff_walk_bwd_px's Epi): the transpose of the
// coefficients (_coeffs_transpose) into the chunk's [m, 6 + C] rows of
// (x, y, A, B, C, opacity, colours) cotangents in shared memory out, then
// stored to the tile's rows tdrec [n, 6 + C] as one contiguous run (16-byte
// stores with vec); a stage cut's value to the tile's first floats.
template <int C, int P>
struct CandGradRows {
  static constexpr int CR = 6 + C;
  float* tdrec;
  float* out;
  bool vec;
  __device__ __forceinline__ void row(int t, const float (&d)[7 + C],
                                      const CbShared<C, P>& s) const {
    const float x = s.geo[0][t], y = s.geo[1][t];
    const float A = s.geo[2][t], B = s.geo[3][t], Cc = s.geo[4][t];
    float* o = out + t * CR;
    o[0] = -d[0] * (A * x + B * y) + d[1] * A + d[2] * B;
    o[1] = -d[0] * (Cc * y + B * x) + d[1] * B + d[2] * Cc;
    o[2] = -0.5f * d[0] * x * x + d[1] * x - 0.5f * d[3];
    o[3] = -d[0] * x * y + d[1] * y + d[2] * x - d[5];
    o[4] = -0.5f * d[0] * y * y + d[2] * y - 0.5f * d[4];
    o[5] = d[6];
#pragma unroll
    for (int c = 0; c < C; ++c) o[6 + c] = d[7 + c];
  }
  __device__ __forceinline__ void store(int base, int m, int t) const {
    cb_store<cb_threads<P>>(tdrec + (long long)base * CR, out, m * CR, vec, t);
  }
  __device__ __forceinline__ void zeros(int from, int n, int t) const {
    cb_store<cb_threads<P>>(tdrec + (long long)from * CR, nullptr, (n - from) * CR, vec, t);
  }
  __device__ __forceinline__ void fold(int t, int n, float v) const {
    if (t < n * CR) tdrec[t] = v;
  }
};

// The backward, kernel 1: the selection, then coeff_walk_bwd_px at P
// pixels a thread (the header's design) with K9's staging, cb_power and
// the transpose epilogue. vec: vals and drec 16-byte aligned and K (6 + C)
// % 4 == 0; cull: the band cull on. Dynamic shared memory: CB_CHUNK * (6 +
// C) floats of rows, then K lane ids.
template <int C, int P = CB_P, int STAGE = 4>
__global__ void __launch_bounds__(cb_threads<P>)
fused_bwd_kernel(const float* __restrict__ vals, const int* __restrict__ rects,
                 const float* __restrict__ g, int kb, int K, int vec, int cull,
                 float* __restrict__ drec, int* __restrict__ sel, int* __restrict__ live) {
  extern __shared__ __align__(16) float fb_dyn[];
  float* out = fb_dyn;
  int* s_sel = reinterpret_cast<int*>(fb_dyn + CB_CHUNK * (6 + C));
  __shared__ int s_warp[cb_warps<P>];
  const int bt = blockIdx.x;
  const int b = bt / FB_TB, t = bt % FB_TB;
  const int tx = t % FB_BLOCK, ty = t / FB_BLOCK;
  const int p = threadIdx.x;
  const int n = min(select_tile<cb_threads<P>>(rects + (long long)b * kb, kb, tx, ty, K, s_sel,
                                               s_warp), K);
  if (p == 0) live[bt] = n;
  for (int k = p; k < n; k += cb_threads<P>) sel[(long long)bt * K + k] = s_sel[k];
  float gc[P][C], g_tbg[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float* gp = g + ((long long)bt * CW_NPIX + cb_pixel<P>(p, j)) * (C + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) gc[j][c] = gp[c];
    g_tbg[j] = gp[C];
  }
  const CandStage<C, P> stage{vals + (long long)b * kb * FB_NCH, s_sel, (float)(tx * CW_TILE),
                              (float)(ty * CW_TILE), vec != 0, cull != 0};
  const CandGradRows<C, P> epi{drec + (long long)bt * K * (6 + C), out, vec != 0};
  coeff_walk_bwd_px<C, P, STAGE, CbPower>(n, stage, gc, g_tbg, epi);
}

template <int C>
__global__ void __launch_bounds__(CW_NPIX)
fused_route_kernel(const int* __restrict__ rects, int kb, int K,
                   const float* __restrict__ drec, const int* __restrict__ sel,
                   const int* __restrict__ live, float* __restrict__ dvals) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * CW_NPIX + threadIdx.x;
  if (j >= kb) return;
  const int r = rects[(long long)b * kb + j];
  const int xmin = r & 0xFF, xmax = min((r >> 8) & 0xFF, FB_BLOCK);
  const int ymin = (r >> 16) & 0xFF, ymax = min((r >> 24) & 0xFF, FB_BLOCK);
  float acc[6 + C];
#pragma unroll
  for (int i = 0; i < 6 + C; ++i) acc[i] = 0.0f;
  for (int ty = ymin; ty < ymax; ++ty) {
    for (int tx = xmin; tx < xmax; ++tx) {
      const long long bt = (long long)b * FB_TB + ty * FB_BLOCK + tx;
      const int* st = sel + bt * K;
      int lo = 0, hi = live[bt];
      const int n = hi;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (st[mid] < j) lo = mid + 1; else hi = mid;
      }
      if (lo < n && st[lo] == j) {
        const float* d = drec + (bt * K + lo) * (6 + C);
#pragma unroll
        for (int i = 0; i < 6 + C; ++i) acc[i] += d[i];
      }
    }
  }
  float* o = dvals + ((long long)b * kb + j) * FB_NCH;
#pragma unroll
  for (int i = 0; i < 6 + C; ++i) o[i] = acc[i];
  for (int i = 6 + C; i < FB_NCH; ++i) o[i] = 0.0f;
}

template <int C, int R, int STAGE>
static int launch_fwd(const float* v, const int* r, int NB, int kb, int K, int cull, float* o,
                      int* c, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(o) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const int vec = (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  const int rvec = kb % 2 == 0 && (reinterpret_cast<uintptr_t>(r) & 7) == 0;
  fused_fwd_kernel<C, CB_P, R, STAGE><<<NB * FB_TB, cb_threads<CB_P>, (size_t)K * sizeof(int), s>>>(
      v, r, kb, K, vec, rvec, cull, o, c);
  return (int)cudaGetLastError();
}

// design 1: the kernel; 2: the kernel with the band cull off (stage 2, at
// every C); at FB_STAGE_C only, design 1 cut at stages 0-1 and designs
// 3-5, the walk at 1, 2 and 4 slots a batch (stage 2).
template <int C>
static int launch_fwd_stage(const float* v, const int* r, int NB, int kb, int K, float* o, int* c,
                            int design, int stage, cudaStream_t s) {
  if (stage == 2 && (design == 1 || design == 2))
    return launch_fwd<C, CF_R, 2>(v, r, NB, kb, K, design == 1, o, c, s);
  if constexpr (C == FB_STAGE_C) {
    if (design == 1 && stage == 0) return launch_fwd<C, CF_R, 0>(v, r, NB, kb, K, 1, o, c, s);
    if (design == 1 && stage == 1) return launch_fwd<C, CF_R, 1>(v, r, NB, kb, K, 1, o, c, s);
    if (stage == 2 && design == 3) return launch_fwd<C, 1, 2>(v, r, NB, kb, K, 1, o, c, s);
    if (stage == 2 && design == 4) return launch_fwd<C, 2, 2>(v, r, NB, kb, K, 1, o, c, s);
    if (stage == 2 && design == 5) return launch_fwd<C, 4, 2>(v, r, NB, kb, K, 1, o, c, s);
  }
  return -1;
}

#define FB_FWD_ARGS                                                                       \
  const float* v = (const float*)vals;                                                    \
  const int* r = (const int*)rects;                                                       \
  float* o = (float*)out;                                                                 \
  int* c = (int*)counts;                                                                  \
  cudaStream_t s = (cudaStream_t)cuda_stream

// Each returns the cudaError_t of its launches, or -1 for an unsupported C
// (or design, or stage).
extern "C" int d3ga_fused(const void* vals, const void* rects, int NB, int kb, int K, int C,
                          void* out, void* counts, void* cuda_stream) {
  FB_FWD_ARGS;
#define FWD(CC) return launch_fwd<CC, CF_R, 2>(v, r, NB, kb, K, 1, o, c, s)
  CW_SWITCH_C(C, FWD)
#undef FWD
  return -1;
}

// The forward's design before (fused_kernel_v1, whole).
extern "C" int d3ga_fused_v1(const void* vals, const void* rects, int NB, int kb, int K, int C,
                             void* out, void* counts, void* cuda_stream) {
  FB_FWD_ARGS;
  const size_t smem = (size_t)K * sizeof(int);
#define FWD(CC) fused_kernel_v1<CC><<<NB * FB_TB, CW_NPIX, smem, s>>>(v, r, kb, K, o, c)
  CW_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

// The forward's design before cut at `stage` (0-3, P3's cuts, see the
// header); counts is written by stage 3 only.
extern "C" int d3ga_fused_stage(const void* vals, const void* rects, int NB, int kb, int K, int C,
                                int stage, void* out, void* counts, void* cuda_stream) {
  FB_FWD_ARGS;
  const size_t smem = (size_t)K * sizeof(int);
#define STAGED(CC, SS) fused_kernel_v1<CC, SS><<<NB * FB_TB, CW_NPIX, smem, s>>>(v, r, kb, K, o, c)
#define CUT(CC)                          \
  switch (stage) {                       \
    case 0: STAGED(CC, 0); break;        \
    case 1: STAGED(CC, 1); break;        \
    case 2: STAGED(CC, 2); break;        \
    case 3: STAGED(CC, 3); break;        \
    default: return -1;                  \
  }
  CW_SWITCH_C(C, CUT)
#undef CUT
#undef STAGED
  return (int)cudaGetLastError();
}

// One (design, stage) of launch_fwd_stage; -1 where it is not built.
extern "C" int d3ga_fused_fwd_stage(const void* vals, const void* rects, int NB, int kb, int K,
                                    int C, void* out, void* counts, int design, int stage,
                                    void* cuda_stream) {
  FB_FWD_ARGS;
#define FWD(CC) return launch_fwd_stage<CC>(v, r, NB, kb, K, o, c, design, stage, s)
  CW_SWITCH_C(C, FWD)
#undef FWD
  return -1;
}

// The backward's scratch and the route kernel after kernel 1.
struct BwdArgs {
  const float* v;
  const int* r;
  const float* g;
  int NB, kb, K;
  float* dr;
  int* se;
  int* li;
  float* dv;
  cudaStream_t s;
};

template <int C>
static int route(const BwdArgs& a) {
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.kb + CW_NPIX - 1) / CW_NPIX, a.NB);
  fused_route_kernel<C><<<grid, CW_NPIX, 0, a.s>>>(a.r, a.kb, a.K, a.dr, a.se, a.li, a.dv);
  return (int)cudaGetLastError();
}

template <int C, int P, int STAGE>
static int launch_bwd(const BwdArgs& a, int cull) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.v) | reinterpret_cast<uintptr_t>(a.dr);
  const int vec = (a.K * (6 + C)) % 4 == 0 && (ptrs & 15) == 0;
  const size_t smem = sizeof(float) * CB_CHUNK * (6 + C) + sizeof(int) * a.K;
  if (sizeof(CbShared<C, P>) + sizeof(int) * cb_warps<P> + smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(fused_bwd_kernel<C, P, STAGE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_bwd_kernel<C, P, STAGE><<<a.NB * FB_TB, cb_threads<P>, smem, a.s>>>(
      a.v, a.r, a.g, a.kb, a.K, vec, cull, a.dr, a.se, a.li);
  return route<C>(a);
}

template <int C>
static int launch_bwd_v1(const BwdArgs& a) {
  fused_bwd_kernel_v1<C><<<a.NB * FB_TB, CW_NPIX, (size_t)a.K * sizeof(int), a.s>>>(
      a.v, a.r, a.g, a.kb, a.K, a.dr, a.se, a.li);
  return route<C>(a);
}

// design 1: the kernel; 2: the kernel with the band cull off (stage 4, at
// every C); at FB_STAGE_C only, design 1 cut at stages 0-3 and designs 3
// and 4, the walk at 1 and 4 pixels a thread (stage 4).
template <int C>
static int launch_bwd_stage(const BwdArgs& a, int design, int stage) {
  if (stage == 4 && (design == 1 || design == 2)) return launch_bwd<C, CB_P, 4>(a, design == 1);
  if constexpr (C == FB_STAGE_C) {
    if (stage == 4 && design == 3) return launch_bwd<C, 1, 4>(a, 1);
    if (stage == 4 && design == 4) return launch_bwd<C, 4, 4>(a, 1);
    if (design == 1) {
      switch (stage) {
        case 0: return launch_bwd<C, CB_P, 0>(a, 1);
        case 1: return launch_bwd<C, CB_P, 1>(a, 1);
        case 2: return launch_bwd<C, CB_P, 2>(a, 1);
        case 3: return launch_bwd<C, CB_P, 3>(a, 1);
        default: break;
      }
    }
  }
  return -1;
}

#define FB_BWD_ARGS                                                                          \
  BwdArgs a{(const float*)vals, (const int*)rects, (const float*)g, NB, kb, K, (float*)drec, \
            (int*)sel, (int*)live, (float*)dvals, (cudaStream_t)cuda_stream}

// The backward (kernel 1, then the route kernel) into dvals, with drec,
// sel and live the wrapper's scratch.
extern "C" int d3ga_fused_bwd(const void* vals, const void* rects, const void* g, int NB, int kb,
                              int K, int C, void* drec, void* sel, void* live, void* dvals,
                              void* cuda_stream) {
  FB_BWD_ARGS;
#define BWD(CC) return launch_bwd<CC, CB_P, 4>(a, 1)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}

// The backward's design before (fused_bwd_kernel_v1, then the route).
extern "C" int d3ga_fused_bwd_v1(const void* vals, const void* rects, const void* g, int NB,
                                 int kb, int K, int C, void* drec, void* sel, void* live,
                                 void* dvals, void* cuda_stream) {
  FB_BWD_ARGS;
#define BWD(CC) return launch_bwd_v1<CC>(a)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}

// One (design, stage) of launch_bwd_stage, then the route; -1 where it is
// not built.
extern "C" int d3ga_fused_bwd_stage(const void* vals, const void* rects, const void* g, int NB,
                                    int kb, int K, int C, void* drec, void* sel, void* live,
                                    void* dvals, int design, int stage, void* cuda_stream) {
  FB_BWD_ARGS;
#define BWD(CC) return launch_bwd_stage<CC>(a, design, stage)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}
