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
//   cut, by d3ga_fused_stage (P3's baseline); d3ga_fused_p3 cuts the new
//   kernel at P3's stages (below). d3ga_fused_fwd_stage launches the new
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
//   Backward, kernel 2 (the route, per block and lane, fused_route_kernel):
//   the 64 tiles of a block share its candidate lanes. A group of FR_G
//   threads a lane covers its rect's tiles, G at a time, each finding the
//   lane's slot by binary search in its tile's ascending lane list, side by
//   side; the group then adds the found rows in tile order (ty, then tx),
//   each of four threads one 16-byte quad of the row, and writes the
//   d(vals) row as four 16-byte stores: deterministic, no atomics, the TPU
//   kernels' order (tile 0 to 63), and per channel the same chain of adds
//   as the design before (one thread a lane visiting the tiles one after
//   another, scalar loads and stores), which stays as
//   fused_route_kernel_v1 and gives the same bits. d3ga_fused_route
//   launches either alone on kernel 1's scratch (d3ga_fused_bwd_tiles
//   launches kernel 1 alone), and at FB_STAGE_C the route at 2, 4, 8, 16
//   and 32 threads a lane: chip_smoke.py holds their bits and times them in
//   turns. At frame 0 of its scene (48 blocks x 4,096 lanes, 40,872 of
//   them with a rect, of 1 to 16 tiles; K 256, C 6) on an NVIDIA H100 80GB
//   HBM3 at 700 W: 4 threads a lane 0.0105 ms, 2, 8, 16 and 32 threads
//   0.0146, 0.0135, 0.0274 and 0.0609, the design before 0.0446; hence
//   FR_G = 4 (a warp's round count is its largest rect's, so larger groups
//   idle on small rects). Bytes: the live slots' rows and lane ids, the
//   rects and the live counts in, d(vals) out: 17.5 MB at frame 0, 12.6
//   MB of it d(vals), a bound of 0.0052 ms (chip_smoke.py counts them).
//
// The backward's design before (one thread a pixel, coeff_walk.cuh's
// coeff_walk_bwd: 8 warps a tile, every slot evaluated at every pixel, 7 +
// C butterflies a slot a warp, each slot's row stored by one thread) stays
// as fused_bwd_kernel_v1, launched, with the route's design before, by
// d3ga_fused_bwd_v1 only.
// d3ga_fused_bwd_stage launches the new kernel with its band cull off (the
// reference for the cull's bits) at every C, and, at C = FB_STAGE_C (the
// champion's 6) only, the kernel cut at a stage (the walk's STAGE
// parameter: 0 selection + staging, 1 + walk 1, 2 + walk 2's per-pixel
// arithmetic, 3 + the per-slot sums; 4 is the kernel) or its walk at 1 or
// 4 pixels a thread. No path of the port calls them: chip_smoke.py checks
// the cull and times the designs and the stages in turns.
//
// Stage cuts (probe P3, the counterpart of the TPU bisect
// tools/fused_bisect.py): fused_fwd_kernel's CUT parameter stops the
// forward early, so each cut runs the kernel's own code up to its point
// and writes its value through cf_store's 16-byte row stores (d3ga_fused_p3).
// CUT 0 writes 1.0 to every output; 1 runs select_tile_pairs and writes
// the tile's count to every pixel and channel; 2 also stages the first
// min(count, K) selected candidates' records (CF_CHUNK a chunk) and sums
// their channels [0, C] in a fixed order (each warp's rows by shuffles,
// the warps' partials in order, the chunks in order), writing that sum
// plus the count; 3 is the kernel, d3ga_fused's tiles to the bit. The
// design before's cuts (fused_kernel_v1's STAGE, d3ga_fused_stage: the
// same four meanings on the one-thread-a-pixel design, each thread
// storing its pixel) stay as P3's baseline. Cuts 1-3 write counts; the
// design before's only at 3.

#include <cstdint>

#include "coeff_walk.cuh"
#include "coeff_walk_bwd.cuh"
#include "coeff_walk_fwd.cuh"

#define FB_BLOCK 8
#define FB_TB (FB_BLOCK * FB_BLOCK)
#define FB_NCH 16
#define FB_STAGE_C 6  // the C the stage cuts and the pixel and batch variants are built for
#define FR_THREADS 128  // the route's threads a block
#define FR_G 4          // the route's threads a lane (chip_smoke.py times 2, 4, 8, 16 and 32)
#define FR_BATCH 8      // tiles a batch of the route's ordered adds (loads first)

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

// P3's stage 2 (the header's cuts): the first n selected candidates'
// records staged through s (CF_CHUNK a chunk, one a thread, 16-byte loads
// with vec) and their channels [0, C] summed in a fixed order: each
// warp's 32 rows by cw_warp_sum, the warps' partials in warp order, the
// chunks in order. Every thread gets the tile's sums.
template <int C, int P>
__device__ __forceinline__ void p3_channel_sums(const float* __restrict__ vb, bool vec,
                                                const int* s_sel, int n, CfShared<P>& s,
                                                float (&sum)[C + 1]) {
  __shared__ float s_red[cb_warps<P>][C + 1];
  const int t = threadIdx.x;
#pragma unroll
  for (int c = 0; c <= C; ++c) sum[c] = 0.0f;
  for (int base = 0; base < n; base += CF_CHUNK) {
    const int m = min(CF_CHUNK, n - base);
    __syncthreads();  // the previous chunk's rows and partials have been read
    for (int r = t; r < m; r += cb_threads<P>) {
      const float* rec = cand(vb, s_sel[base + r]);
      float4* row = reinterpret_cast<float4*>(s.rec[r]);
#pragma unroll
      for (int i = 0; i < FB_NCH / 4; ++i)
        row[i] = vec ? reinterpret_cast<const float4*>(rec)[i]
                     : make_float4(rec[4 * i], rec[4 * i + 1], rec[4 * i + 2], rec[4 * i + 3]);
    }
    __syncthreads();
    for (int r0 = 0; r0 < CF_CHUNK; r0 += cb_threads<P>) {
      const int r = r0 + t;
#pragma unroll
      for (int c = 0; c <= C; ++c) {
        const float v = cw_warp_sum(r < m ? s.rec[r][c] : 0.0f);
        if ((t & 31) == 0) s_red[t >> 5][c] = v;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c <= C; ++c) {
        float chunk = 0.0f;
#pragma unroll
        for (int w = 0; w < cb_warps<P>; ++w) chunk += s_red[w][c];
        sum[c] += chunk;
      }
      __syncthreads();  // s_red is rewritten next
    }
  }
}

// The forward: select_tile_pairs, then coeff_walk_fwd_px at P pixels a
// thread and R slots a batch (coeff_walk_fwd.cuh), the tile's block
// written by cf_store. vec: vals 16-byte aligned; rvec: rects 8-byte
// aligned and kb even; cull: the band cull on. Dynamic shared memory: K
// lane ids. Counts are written at every STAGE. CUT < 3 stops it at P3's
// stage CUT (the header's cuts), every cut writing its value through
// cf_store; counts are written by cuts 1 and 2 too.
template <int C, int P = CB_P, int R = CF_R, int STAGE = 2, int CUT = 3>
__global__ void __launch_bounds__(cb_threads<P>)
fused_fwd_kernel(const float* __restrict__ vals, const int* __restrict__ rects, int kb, int K,
                 int vec, int rvec, int cull, float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ int s_sel[];  // K lane ids
  __shared__ int s_warp[cb_warps<P>];
  __shared__ CfShared<P> s;
  const int bt = blockIdx.x;
  const int b = bt / FB_TB, t = bt % FB_TB;
  const int tx = t % FB_BLOCK, ty = t / FB_BLOCK;
  float* o = out + (long long)bt * CW_NPIX * (C + 1);
  float acc[P][C], T[P];
  if constexpr (CUT < 3) {
    float v[C + 1];
#pragma unroll
    for (int c = 0; c <= C; ++c) v[c] = 1.0f;
    if constexpr (CUT > 0) {
      const int cnt = select_tile_pairs<cb_threads<P>>(rects + (long long)b * kb, kb, tx, ty, K,
                                                       rvec != 0, s_sel, s_warp);
      if (threadIdx.x == 0) counts[bt] = cnt;
#pragma unroll
      for (int c = 0; c <= C; ++c) v[c] = (float)cnt;
      if constexpr (CUT == 2) {
        float sum[C + 1];
        p3_channel_sums<C, P>(vals + (long long)b * kb * FB_NCH, vec != 0, s_sel, min(cnt, K),
                              s, sum);
#pragma unroll
        for (int c = 0; c <= C; ++c) v[c] = sum[c] + (float)cnt;
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
#pragma unroll
      for (int c = 0; c < C; ++c) acc[j][c] = v[c];
      T[j] = v[C];
    }
  } else {
    const int cnt = select_tile_pairs<cb_threads<P>>(rects + (long long)b * kb, kb, tx, ty, K,
                                                     rvec != 0, s_sel, s_warp);
    if (threadIdx.x == 0) counts[bt] = cnt;
    const CandStage<C, P> stage{vals + (long long)b * kb * FB_NCH, s_sel, (float)(tx * CW_TILE),
                                (float)(ty * CW_TILE), vec != 0, cull != 0};
    coeff_walk_fwd_px<C, P, R, STAGE>(min(cnt, K), stage, s, acc, T);
  }
  cf_store<C, P>(s, acc, T, o);
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

// The route's design before: one thread a (block, lane), visiting its
// rect's tiles one after another, a binary search in each, scalar loads
// and stores. Launched by the backward's design before (d3ga_fused_bwd_v1)
// and by d3ga_fused_route (design 0) only.
template <int C>
__global__ void __launch_bounds__(CW_NPIX)
fused_route_kernel_v1(const int* __restrict__ rects, int kb, int K,
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

// Quad q (floats 4q .. 4q + 3) of slot row `row` of drec [.., 6 + C]: one
// 16-byte load with vec (rows 16-byte aligned: (6 + C) % 4 == 0 and drec
// aligned), else scalar loads; 0 past the row's 6 + C floats.
template <int C>
__device__ __forceinline__ float4 fr_quad(const float* __restrict__ drec, int row, int q,
                                          bool vec) {
  constexpr int CR = 6 + C;
  const float* p = drec + (long long)row * CR + 4 * q;
  if constexpr (CR % 4 == 0) {
    if (vec) return __ldg(reinterpret_cast<const float4*>(p));
  }
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = 4 * q + i < CR ? __ldg(p + i) : 0.0f;
  return make_float4(v[0], v[1], v[2], v[3]);
}

// The route: each (block b, lane j) gets d(vals)[b, j] = the sum of its
// slots' rows over the tiles of its rect, in the design before's order
// (ty, then tx), so every channel is the same chain of float32 adds and
// d(vals) keeps its bits. G threads a lane (a group, FR_THREADS / G lanes
// a block). Round by round, thread g of the group takes tile i = G round
// + g of the rect (ty-then-tx order) and finds j's slot there by binary
// search in the tile's ascending lane list, so the group's searches run
// side by side. The group then walks the round's G tiles in order: each
// tile's slot index comes by shuffle, and quad q of the row (floats 4q ..
// 4q + 3) is loaded and added by thread q % G where j is there (batches
// of FR_BATCH tiles, loads first, then the adds in order). The round count
// is the warp's largest, so the shuffles run converged. The quads' owners
// write the row as four 16-byte stores (dvals 16-byte aligned).
template <int C, int G>
__global__ void __launch_bounds__(FR_THREADS)
fused_route_kernel(const int* __restrict__ rects, int kb, int K, const float* __restrict__ drec,
                   const int* __restrict__ sel, const int* __restrict__ live, int vec,
                   float* __restrict__ dvals) {
  static_assert(G >= 2 && G <= 32 && (G & (G - 1)) == 0, "G: 2, 4, 8, 16 or 32 threads a lane");
  constexpr int NQ = (6 + C + 3) / 4;  // quads of a row that hold channels
  constexpr int QT = G >= 4 ? 1 : 4 / G;  // quads a thread: g, g + G, ...
  constexpr int NB_ = G < FR_BATCH ? G : FR_BATCH;
  const int b = blockIdx.y;
  const int g = threadIdx.x % G;
  const int j = blockIdx.x * (FR_THREADS / G) + threadIdx.x / G;
  int xmin = 0, ymin = 0, w = 1, area = 0;
  if (j < kb) {
    const int r = __ldg(rects + (long long)b * kb + j);
    xmin = r & 0xFF;
    ymin = (r >> 16) & 0xFF;
    const int xmax = min((r >> 8) & 0xFF, FB_BLOCK), ymax = min((r >> 24) & 0xFF, FB_BLOCK);
    if (xmax > xmin && ymax > ymin) {
      w = xmax - xmin;
      area = w * (ymax - ymin);
    }
  }
  float4 acc[QT];
#pragma unroll
  for (int k = 0; k < QT; ++k) acc[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int rounds = (int)__reduce_max_sync(CW_FULL_MASK, (unsigned)((area + G - 1) / G));
  for (int rd = 0; rd < rounds; ++rd) {
    const int i = rd * G + g;
    int row = -1;  // bt * K + j's slot in tile i's list, where j is there
    if (i < area) {
      const int bt = b * FB_TB + (ymin + i / w) * FB_BLOCK + xmin + i % w;
      const int* st = sel + (long long)bt * K;
      const int n = __ldg(live + bt);
      int lo = 0, hi = min(n, j + 1);  // a list of distinct lanes: j's slot is at most j
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(st + mid) < j) lo = mid + 1; else hi = mid;
      }
      if (lo < n && __ldg(st + lo) == j) row = bt * K + lo;
    }
#pragma unroll
    for (int u0 = 0; u0 < G; u0 += NB_) {
      int rr[NB_];
      float4 v[NB_][QT];
#pragma unroll
      for (int u = 0; u < NB_; ++u) {
        rr[u] = __shfl_sync(CW_FULL_MASK, row, u0 + u, G);
#pragma unroll
        for (int k = 0; k < QT; ++k) {
          const int q = g + G * k;
          v[u][k] = rr[u] >= 0 && q < NQ ? fr_quad<C>(drec, rr[u], q, vec != 0)
                                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int u = 0; u < NB_; ++u) {
        if (rr[u] >= 0) {
#pragma unroll
          for (int k = 0; k < QT; ++k) {
            acc[k].x += v[u][k].x;
            acc[k].y += v[u][k].y;
            acc[k].z += v[u][k].z;
            acc[k].w += v[u][k].w;
          }
        }
      }
    }
  }
  float4* o = reinterpret_cast<float4*>(dvals + ((long long)b * kb + j) * FB_NCH);
#pragma unroll
  for (int k = 0; k < QT; ++k)
    if (j < kb && g + G * k < FB_NCH / 4) o[g + G * k] = acc[k];
}

template <int C, int R, int STAGE, int CUT = 3>
static int launch_fwd(const float* v, const int* r, int NB, int kb, int K, int cull, float* o,
                      int* c, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(o) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const int vec = (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  const int rvec = kb % 2 == 0 && (reinterpret_cast<uintptr_t>(r) & 7) == 0;
  fused_fwd_kernel<C, CB_P, R, STAGE, CUT>
      <<<NB * FB_TB, cb_threads<CB_P>, (size_t)K * sizeof(int), s>>>(v, r, kb, K, vec, rvec, cull,
                                                                     o, c);
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

// The forward cut at P3's `stage` (0-3, the header's cuts; 3 is d3ga_fused
// itself); counts is written by stages 1-3.
extern "C" int d3ga_fused_p3(const void* vals, const void* rects, int NB, int kb, int K, int C,
                             int stage, void* out, void* counts, void* cuda_stream) {
  FB_FWD_ARGS;
#define CUT(CC)                                                            \
  switch (stage) {                                                         \
    case 0: return launch_fwd<CC, CF_R, 2, 0>(v, r, NB, kb, K, 1, o, c, s); \
    case 1: return launch_fwd<CC, CF_R, 2, 1>(v, r, NB, kb, K, 1, o, c, s); \
    case 2: return launch_fwd<CC, CF_R, 2, 2>(v, r, NB, kb, K, 1, o, c, s); \
    case 3: return launch_fwd<CC, CF_R, 2>(v, r, NB, kb, K, 1, o, c, s);    \
    default: return -1;                                                    \
  }
  CW_SWITCH_C(C, CUT)
#undef CUT
  return -1;
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

// The route (G threads a lane; dvals must be 16-byte aligned), or its
// design before.
template <int C, int G>
static int launch_route(const BwdArgs& a) {
  if ((reinterpret_cast<uintptr_t>(a.dv) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const int vec = (reinterpret_cast<uintptr_t>(a.dr) & 15) == 0;
  constexpr int lanes = FR_THREADS / G;
  const dim3 grid((a.kb + lanes - 1) / lanes, a.NB);
  fused_route_kernel<C, G><<<grid, FR_THREADS, 0, a.s>>>(a.r, a.kb, a.K, a.dr, a.se, a.li, vec,
                                                         a.dv);
  return (int)cudaGetLastError();
}

template <int C>
static int launch_route_v1(const BwdArgs& a) {
  const dim3 grid((a.kb + CW_NPIX - 1) / CW_NPIX, a.NB);
  fused_route_kernel_v1<C><<<grid, CW_NPIX, 0, a.s>>>(a.r, a.kb, a.K, a.dr, a.se, a.li, a.dv);
  return (int)cudaGetLastError();
}

// design 0: the route's design before; 1: the route (FR_G threads a lane),
// at every C; at FB_STAGE_C only, 2-6: 2, 4, 8, 16 and 32 threads a lane.
template <int C>
static int launch_route_design(const BwdArgs& a, int design) {
  if (design == 0) return launch_route_v1<C>(a);
  if (design == 1) return launch_route<C, FR_G>(a);
  if constexpr (C == FB_STAGE_C) {
    switch (design) {
      case 2: return launch_route<C, 2>(a);
      case 3: return launch_route<C, 4>(a);
      case 4: return launch_route<C, 8>(a);
      case 5: return launch_route<C, 16>(a);
      case 6: return launch_route<C, 32>(a);
      default: break;
    }
  }
  return -1;
}

// Kernel 1 (per tile) into the scratch drec, sel, live.
template <int C, int P, int STAGE>
static int launch_bwd_tiles(const BwdArgs& a, int cull) {
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
  return (int)cudaGetLastError();
}

// Kernel 1, then the route.
template <int C, int P, int STAGE>
static int launch_bwd(const BwdArgs& a, int cull) {
  const int e = launch_bwd_tiles<C, P, STAGE>(a, cull);
  return e != 0 ? e : launch_route<C, FR_G>(a);
}

// The backward's design before: its kernel 1, then the route's.
template <int C>
static int launch_bwd_v1(const BwdArgs& a) {
  fused_bwd_kernel_v1<C><<<a.NB * FB_TB, CW_NPIX, (size_t)a.K * sizeof(int), a.s>>>(
      a.v, a.r, a.g, a.kb, a.K, a.dr, a.se, a.li);
  const cudaError_t e = cudaGetLastError();
  return e != cudaSuccess ? (int)e : launch_route_v1<C>(a);
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

// Kernel 1 alone (the backward's per-tile kernel) into the scratch drec,
// sel and live; dvals is not written.
extern "C" int d3ga_fused_bwd_tiles(const void* vals, const void* rects, const void* g, int NB,
                                    int kb, int K, int C, void* drec, void* sel, void* live,
                                    void* dvals, void* cuda_stream) {
  FB_BWD_ARGS;
#define BWD(CC) return launch_bwd_tiles<CC, CB_P, 4>(a, 1)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}

// The route alone (launch_route_design's `design`) from kernel 1's drec,
// sel and live into dvals.
extern "C" int d3ga_fused_route(const void* rects, int NB, int kb, int K, int C,
                                const void* drec, const void* sel, const void* live,
                                void* dvals, int design, void* cuda_stream) {
  BwdArgs a{nullptr, (const int*)rects, nullptr, NB, kb, K, (float*)drec, (int*)sel,
            (int*)live, (float*)dvals, (cudaStream_t)cuda_stream};
#define RT(CC) return launch_route_design<CC>(a, design)
  CW_SWITCH_C(C, RT)
#undef RT
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
