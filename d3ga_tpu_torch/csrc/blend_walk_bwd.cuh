// K3's blend backward walk (blend_ct_bwd.cu; K5's and K7's backwards in
// blend_rec.cu walk with it too): the recompute-forward VJP of one 16x16
// tile, two pixels a thread. It computes what
// blend_walk.cuh::blend_walk_bwd computes, pixel for pixel: the same
// falloff polynomial, thresholds (power <= 0, alpha >= 1/255, the walk
// stops before the record where T * (1 - alpha) < 1e-4, dp only where
// raw < 0.99), the same walk 1 (T_bg and S, the total of dw * w over the
// accepted records) and the same suffix R = S - prefix in walk 2 (that
// header says why two front-to-back walks). Only the order of the
// per-record sums over the tile's 256 pixels differs.
//
// Replaces (with blend_ct_bwd.cu) the TPU kernel
// d3ga_tpu/raster/pallas_blend_ct.py::_run_backward_ct (_blend_bwd_ct,
// _coeffs_transpose_ct).
//
// Bound on Hopper: operations. Per (pixel, record) pair the forward walks
// visit, about 60 FP32 operations and 3 special-function results (an exp
// in each walk, one division): at the champion step's selection (27.04 M
// pairs on 2,688 tiles, 109,497 live slots) 0.0242 ms at 67 TFLOP/s;
// the bytes it must move (records, ids, the cotangent image, drec) are
// about 54.7 MB, 0.0163 ms at 3.35 TB/s.
//
// Design, and why. blend_walk_bwd (one thread a pixel, 8 warps a tile)
// spends most of its time in the MIO pipe that shuffles, shared loads and
// shared stores share: per (warp, record) 12 five-step butterflies (60
// shuffles), 13 scalar broadcast loads in each walk and 12 one-lane
// stores. Here:
// - Two pixels a thread (BW_P): a tile is 128 threads, four warps, one
//   tile a block (tiles hold 0-256 records: a block of several would wait
//   for its longest). Warp w takes the rows 4w..4w+3 (bw_pixel). Four
//   pixels a thread would cut the MIO work further, but at the champion
//   scene only 477 of 2,688 tiles hold records, 394 of them the full 256:
//   about three an SM, so two warps a tile leave too few warps to hide
//   each record's dependent chain, and one pixel a thread gives up the
//   pixels' interleaved chains. chip_smoke.py times this walk at 1, 2
//   and 4 pixels a thread in turns (the stage entry point's designs 3
//   and 4, built at C 6 only): on an NVIDIA H100 80GB HBM3 at 700 W,
//   0.301, 0.214 and 0.283 ms at the champion selection; the baseline
//   0.347.
// - Band culling. Staging marks the 2-row bands of the tile where the
//   record's alpha can reach 1/255 (bw_stage: a conservative bound from
//   its conic and opacity). A warp skips a record none of its two bands
//   can take: no pixel of it would take the record, so the walk gives the
//   bits it gives without the cull. chip_smoke.py holds that, bit for
//   bit, against the same walk with the cull off (the stage entry point's
//   design 2), on the edge inputs (faint records whose ellipse edge lies
//   on each band boundary among them) and at full width. At the champion
//   selection most (record, band) pairs hold no pixel that takes the
//   record (chip_smoke's blend_work). Culling each pixel's band apart
//   measured slower (it breaks the pixels' straight-line code), and so did
//   branching on each pixel's acceptance in walk 1 (it selects instead).
// - A staged record is a 16-byte-aligned row of 20 floats (c0, c0 +
//   log(opacity), c2..c6, C colours, the band mask in float 15): a warp
//   reads the band word, then, where it can take the record, the row in
//   four broadcast 16-byte loads, which serve its 64 pixels.
// - Per record each thread first adds its own pixels' 6 + C contributions
//   in pixel order, then the warp sums them by a reduce-scatter: the 6 + C
//   values sit in 16 slots in bit-reversed order, and four halving steps
//   (lane bits 16, 8, 4, 2) each exchange only the slot pairs that hold a
//   value, then one xor-1 step: 13 shuffles at C 6 where 12 butterflies
//   take 60, and each lane pair ends with one value's sum, so one
//   predicated store writes the warp's partials. A record no lane of the
//   warp accepted costs no shuffle and no store (a per-warp hit mask
//   tells the epilogue). The epilogue adds the four warps' partials in
//   warp order: deterministic, no atomics, each slot owned by one tile.
// - Staging: each walk gathers a chunk's rows once, one row a thread, in
//   16-byte loads where CR % 4 == 0 and the pointers are aligned (scalar
//   loads otherwise). Walk 2 also keeps the geometry (x, y, A, B, C,
//   opacity) in shared memory, so the epilogue reads no row again.
// - Stores: a chunk's [n, CR] cotangent rows are built in shared memory
//   (dynamic, BW_CHUNK x CR floats) and written as coalesced 16-byte
//   stores (scalar where CR % 4 != 0), as is the zero tail of the tile's
//   slots past the walk.
//
// Stage cuts: the STAGE template parameter (default 4, the full walk)
// stops the work early, each cut writing what it computed so that no
// stage is dead code (blend_walk.cuh's blend_walk_bwd has the same cuts):
//   0  both walks' staging and the drec stores: rows of the staged
//      geometry and colours, plus each thread's sum of its own staged
//      column in walk 1
//   1  + walk 1's arithmetic (its T_bg and S folded into the rows)
//   2  + walk 2's per-pixel arithmetic (dp and w of each accepted pair
//      folded), without the per-record sums
//   3  + the per-record sums (the raw 6 + C sums, plus the geometry)
//   4  + the epilogue (the coefficients' transpose): K3 itself
// Stages 0-1 do no walk-2 arithmetic, so no pixel stops and they stage
// every chunk of both walks; the full walk stops a tile's walks once
// every pixel has stopped (rare at the champion scene: 27.04 M of 28.03
// M possible pairs are visited).

#pragma once

#include "blend_walk.cuh"

#define BW_P 2                      // K3's pixels a thread (P below): 128 threads, 4 warps a tile
#define BW_CHUNK 64                 // records a chunk (a 64-bit hit mask a warp)
#define BW_ROW 20                   // floats a staged row (16-byte multiple, conflict-free stores)
#define BW_SLOTS 16                 // reduce-scatter slots (6 + C <= 14)
#define BW_LOG255 5.54126354f       // log(255): alpha >= 1/255 iff power + log op >= -log(255)
#define BW_R2_SLACK 1e-3f           // the band bound's margin in Q (below), past its 1%

// The walk at P pixels a thread (1, 2 or 4): NPIX / P threads a tile,
// NPIX / P / 32 warps.
template <int P>
constexpr int bw_threads = NPIX / P;
template <int P>
constexpr int bw_warps = NPIX / P / 32;

// Tile pixel (dy * 16 + dx) of thread t's pixel j: warp w takes the 2P
// rows from 2Pw, lane l the column l % 16 and the rows 2Pw + l / 16 + 2j,
// so warp w's pixels j form the 2-row band P w + j.
template <int P>
__host__ __device__ constexpr int bw_pixel(int t, int j) {
  return ((t / 32) * (32 * P / TILE) + (t % 32) / TILE + j * (32 / TILE)) * TILE + t % TILE;
}

// Slot of value i in the reduce-scatter: its 4-bit reversal.
__host__ __device__ constexpr int bw_rev4(int i) {
  return ((i & 1) << 3) | ((i & 2) << 1) | ((i & 4) >> 1) | ((i & 8) >> 3);
}

// Bit s set: slot s of a vector folded to length len holds one of the nv
// values (slot s then sums original slots s, s + len, ...).
__host__ __device__ constexpr unsigned bw_live(int nv, int len) {
  unsigned m = 0;
  for (int v = 0; v < nv; ++v) m |= 1u << (bw_rev4(v) % len);
  return m;
}

// One halving step of the reduce-scatter: a lane with the lane bit LEN
// set keeps the upper half of its LEN slots and receives its partner's,
// the other the lower half; slot pairs that hold no value are skipped.
template <int NV, int LEN>
__device__ __forceinline__ void bw_fold(float (&a)[BW_SLOTS], bool upper) {
  constexpr int H = LEN / 2;
  constexpr unsigned live = bw_live(NV, LEN);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    if (((live >> i) | (live >> (i + H))) & 1u) {
      const float send = upper ? a[i] : a[i + H];
      const float keep = upper ? a[i + H] : a[i];
      a[i] = keep + __shfl_xor_sync(FULL_MASK, send, LEN);
    }
  }
}

// The warp's sums of NV values held in slots bw_rev4(v) of each lane:
// returns, at lane u, the sum of value bw_rev4((u >> 1) & 15) (the same
// at lanes 2m and 2m + 1; no value where that index is >= NV).
template <int NV>
__device__ __forceinline__ float bw_reduce_scatter(float (&a)[BW_SLOTS], int lane) {
  bw_fold<NV, 16>(a, lane & 16);
  bw_fold<NV, 8>(a, lane & 8);
  bw_fold<NV, 4>(a, lane & 4);
  bw_fold<NV, 2>(a, lane & 2);
  return a[0] + __shfl_xor_sync(FULL_MASK, a[0], 1);
}

template <int P>
__device__ __forceinline__ bool bw_all(const bool (&done)[P]) {
  bool a = true;
#pragma unroll
  for (int j = 0; j < P; ++j) a = a && done[j];
  return a;
}

template <int C, int P>
struct BwShared {
  __align__(16) float rec[BW_CHUNK][BW_ROW];                 // staged records
  float geo[6][BW_CHUNK];                                    // x, y, A, B, C, opacity (walk 2)
  __align__(16) float part[bw_warps<P>][BW_CHUNK][BW_ROW];   // each warp's per-record sums
  unsigned long long hit[bw_warps<P>];                       // records some lane accepted
};

// Stage the chunk's record t (thread t < n): the row of tidx[base + t],
// as 7 coefficients and C colours (blend_walk.cuh::stage's arithmetic),
// into s.rec[t] and, with GEO, its geometry into s.geo; without cull,
// every band is marked. S is BwShared<C, P> here, K2's FwShared in
// blend_walk_fwd.cuh (rows only).
template <int C, int P, bool GEO, class S>
__device__ __forceinline__ void bw_stage(const float* __restrict__ rec, int n_ext, int CR, bool vec,
                                         bool cull, const int* __restrict__ tidx, int base, int n,
                                         float sx, float sy, S& s, int t) {
  if (t >= n) return;
  const int gid = min(max(tidx[base + t], 0), n_ext - 1);
  const float* r = rec + (long long)gid * CR;
  constexpr int NV4 = (6 + C + 3) / 4;
  float v[4 * NV4];
  if (vec) {
#pragma unroll
    for (int i = 0; i < NV4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(r)[i];
      v[4 * i] = q.x;
      v[4 * i + 1] = q.y;
      v[4 * i + 2] = q.z;
      v[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 6 + C; ++i) v[i] = r[i];
  }
  const float x = v[0] - sx;
  const float y = v[1] - sy;
  const float A = v[2], B = v[3], Cc = v[4];
  const float logop = logf(fmaxf(v[5], OP_EPS));
  const float c0 = -0.5f * (A * x * x + Cc * y * y) - B * x * y;
  // The 2-row bands of the tile (rows 2b, 2b + 1) where some pixel can
  // take the record: power + log(op) >= -log(255) needs Q = A dx^2 +
  // 2 B dx dy + C dy^2 <= r2 = 2 (log(op) + log(255)), an ellipse whose
  // rows span |dy| <= sqrt(r2 A / det). Widened for the walk's roundings:
  // r2 by 1% (the power's terms, up to ~1e3 times Q where det >= 1e-3 A C,
  // round at ~1e-7 of their size) and by BW_R2_SLACK (log(op), exp and
  // the 1/255 test round at ~1e-6 in Q, which moves the edge by
  // sqrt(1e-6 A / det): 0.2 px at sigma 200 px), then by a quarter pixel
  // (the power's rounding near a narrow record's centre). Every band
  // where the conic is not clearly positive definite or a value is not
  // finite.
  unsigned bands = 0xFFu;
  const float r2 = 2.0f * (logop + BW_LOG255);
  const float det = A * Cc - B * B;
  if (cull && A > 0.0f && Cc > 0.0f && det > 1e-3f * A * Cc) {
    const float ext = sqrtf((fmaxf(r2, 0.0f) * 1.01f + BW_R2_SLACK) * A / det) + 0.25f;
    if (ext < 1e30f && y - ext < 1e30f && y + ext > -1e30f) {
      bands = 0;
#pragma unroll
      for (int b = 0; b < NPIX / TILE / 2; ++b)
        if (2.0f * b + 1.0f >= y - ext && 2.0f * b <= y + ext) bands |= 1u << b;
    }
  }
  float o[BW_ROW] = {};
  o[15] = __uint_as_float(bands);
  o[0] = c0;
  o[1] = c0 + logop;
  o[2] = A * x + B * y;
  o[3] = Cc * y + B * x;
  o[4] = -0.5f * A;
  o[5] = -0.5f * Cc;
  o[6] = -B;
#pragma unroll
  for (int c = 0; c < C; ++c) o[7 + c] = v[6 + c];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<float4*>(s.rec[t])[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2],
                                                         o[4 * i + 3]);
  if constexpr (GEO) {
    s.geo[0][t] = x;
    s.geo[1][t] = y;
    s.geo[2][t] = A;
    s.geo[3][t] = B;
    s.geo[4][t] = Cc;
    s.geo[5][t] = v[5];
  }
}

// The bands of warp `warp` that can take the staged row (bit j: pixel
// j's band, P warp + j).
template <int P>
__device__ __forceinline__ unsigned bw_bands(const float* row, int warp) {
  return (__float_as_uint(row[15]) >> (warp * P)) & ((1u << P) - 1u);
}

// A staged row's coefficients rc[0..6] (c0, c0 + log op, c2..c6) and
// colours col[0..C-1], in broadcast 16-byte loads.
template <int C>
__device__ __forceinline__ void bw_row(const float* row, float (&rc)[7], float (&col)[C]) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(row)[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) rc[i] = v[i];
#pragma unroll
  for (int c = 0; c < C; ++c) col[c] = v[7 + c];
}

// Staged record k for warp `warp`: returns whether some band of the warp
// can take it (bw_bands), and where one can, its row (bw_row).
template <int C, int P>
__device__ __forceinline__ unsigned bw_record(const BwShared<C, P>& s, int k, int warp,
                                              float (&rc)[7], float (&col)[C]) {
  const unsigned jm = bw_bands<P>(s.rec[k], warp);
  if (!jm) return 0;  // the rest is not read
  bw_row<C>(s.rec[k], rc, col);
  return jm;
}

// The falloff polynomial's part past c0 at pixel (fx, fy): c2 fx + c3 fy
// + c4 fx^2 + c5 fy^2 + c6 fx fy, its roundings fixed by the intrinsics
// (fx^2, fy^2, fx fy are exact).
__device__ __forceinline__ float bw_q(const float (&rc)[7], float fx, float fy) {
  const float t = __fmaf_rn(rc[4], fx * fx, __fmaf_rn(rc[3], fy, __fmul_rn(rc[2], fx)));
  return __fmaf_rn(rc[6], fx * fy, __fmaf_rn(rc[5], fy * fy, t));
}

// q (bw_q) and exp(c0 + log op + q) at the thread's P pixels for staged
// record rc, in straight-line code, so that the pixels' chains interleave.
template <int P>
__device__ __forceinline__ void bw_power(const float (&rc)[7], float fx, const float (&fy)[P],
                                         float (&q)[P], float (&e)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    q[j] = bw_q(rc, fx, fy[j]);
    e[j] = expf(__fadd_rn(rc[1], q[j]));
  }
}

// n floats from shared src to global dst (16-byte vectors with vec),
// by the block's THREADS threads; zeros where src is null.
template <int THREADS>
__device__ __forceinline__ void bw_store(float* __restrict__ dst, const float* src, long long n,
                                         bool vec, int t) {
  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long e = t; e < n / 4; e += THREADS) d4[e] = src ? s4[e] : z;
  } else {
    for (long long e = t; e < n; e += THREADS) dst[e] = src ? src[e] : 0.0f;
  }
}

// Backward of one tile by the calling block of bw_threads<P> threads:
// thread t's pixels' image cotangents gc[j] (colours) and g_tbg[j] (T_bg)
// in, the tile's K slot rows of record cotangents out (tdrec [K, CR];
// zeros past the walk and in dead slots). vec: rec and tdrec are 16-byte
// aligned and CR % 4 == 0; cull: the warps skip the records their bands
// cannot take (bw_stage; the same bits either way). Needs BW_CHUNK * CR
// floats of dynamic shared memory.
template <int C, int P = BW_P, int STAGE = 4>
__device__ __forceinline__ void blend_walk_bwd_px(const float* __restrict__ rec, int n_ext, int CR,
                                                  bool vec, bool cull,
                                                  const int* __restrict__ tidx, int K,
                                                  int cnt, float sx, float sy,
                                                  const float (&gc)[P][C], const float (&g_tbg)[P],
                                                  float* __restrict__ tdrec) {
  constexpr int NV = 6 + C;
  static_assert(NV <= BW_SLOTS && 7 + C <= BW_ROW, "C above 8");
  static_assert(P == 1 || P == 2 || P == 4, "1, 2 or 4 pixels a thread");
  __shared__ BwShared<C, P> s;
  extern __shared__ __align__(16) float bw_out[];  // a chunk's [n, CR] rows
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float fx = (float)(t % TILE);
  float fy[P];
#pragma unroll
  for (int j = 0; j < P; ++j) fy[j] = (float)(bw_pixel<P>(t, j) / TILE);
  float fold = 0.0f;  // the stage cuts' sink for what they compute

  // -- walk 1: T_bg and the total of ds = dw * w over accepted records --
  float T[P], S[P];
  bool done[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    T[j] = 1.0f;
    S[j] = 0.0f;
    done[j] = false;
  }
  for (int base = 0; base < cnt; base += BW_CHUNK) {
    const int n = min(BW_CHUNK, cnt - base);
    __syncthreads();  // the previous chunk has been read
    bw_stage<C, P, false>(rec, n_ext, CR, vec, cull, tidx, base, n, sx, sy, s, t);
    __syncthreads();
    if constexpr (STAGE == 0) {
      if (t < n) fold += s.rec[t][1];
    } else {
      for (int k = 0; k < n; ++k) {
        if (bw_all(done)) break;
        float rc[7], col[C], q[P], e[P];
        if (!bw_record<C, P>(s, k, warp, rc, col)) continue;  // no pixel of the warp can take it
        bw_power(rc, fx, fy, q, e);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float alpha = fminf(ALPHA_MAX, e[j]);
          const float test_T = T[j] * (1.0f - alpha);
          const bool use = !done[j] && rc[0] + q[j] <= 0.0f && e[j] >= ALPHA_SKIP;
          const bool stop = use && test_T < T_EPS;
          const bool acc = use && !stop;
          float dw = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) dw += gc[j][c] * col[c];
          const float S1 = S[j] + dw * (alpha * T[j]);
          S[j] = acc ? S1 : S[j];
          T[j] = acc ? test_T : T[j];
          done[j] = done[j] || stop;
        }
      }
    }
    if (__syncthreads_and(bw_all(done))) break;
  }
  if constexpr (STAGE == 1) {
#pragma unroll
    for (int j = 0; j < P; ++j) fold += T[j] + S[j];
  }

  // -- walk 2: the cotangents; R = the ds of the accepted records behind --
  float R[P], gt_bg[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    gt_bg[j] = g_tbg[j] * T[j];  // dlg of every accepted record includes it
    R[j] = S[j];
    T[j] = 1.0f;
    done[j] = false;
  }
  int written = 0;
  for (int base = 0; base < cnt; base += BW_CHUNK) {
    const int n = min(BW_CHUNK, cnt - base);
    __syncthreads();  // the previous chunk's rows have been read and stored
    bw_stage<C, P, true>(rec, n_ext, CR, vec, cull, tidx, base, n, sx, sy, s, t);
    __syncthreads();
    unsigned long long hits = 0;  // warp-uniform: records some lane of this warp accepted
    if constexpr (STAGE >= 2) {
      for (int k = 0; k < n; ++k) {
        if (__all_sync(FULL_MASK, bw_all(done))) break;
        float rc[7], col[C], q[P], e[P];
        if (!bw_record<C, P>(s, k, warp, rc, col)) continue;  // warp-uniform: none can take it
        bw_power(rc, fx, fy, q, e);
        float a[BW_SLOTS];
#pragma unroll
        for (int i = 0; i < BW_SLOTS; ++i) a[i] = 0.0f;
        bool hit = false;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float alpha = fminf(ALPHA_MAX, e[j]);
          const float test_T = T[j] * (1.0f - alpha);
          const bool use = !done[j] && rc[0] + q[j] <= 0.0f && e[j] >= ALPHA_SKIP;
          const bool stop = use && test_T < T_EPS;
          const bool acc = use && !stop;
          done[j] = done[j] || stop;
          if (!acc) continue;
          const float w = alpha * T[j];
          float dw = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) dw += gc[j][c] * col[c];
          R[j] -= dw * w;
          const float dlg = R[j] + gt_bg[j];
          const float dalpha = dw * T[j] - dlg / (1.0f - alpha);
          const float dp = (e[j] < ALPHA_MAX) ? dalpha * e[j] : 0.0f;
          if constexpr (STAGE == 2) {
            fold += dp + w;
          } else {
            a[bw_rev4(0)] += dp;
            a[bw_rev4(1)] += __fmul_rn(dp, fx);
            a[bw_rev4(2)] += __fmul_rn(dp, fy[j]);
            a[bw_rev4(3)] += __fmul_rn(dp, fx * fx);
            a[bw_rev4(4)] += __fmul_rn(dp, fy[j] * fy[j]);
            a[bw_rev4(5)] += __fmul_rn(dp, fx * fy[j]);
#pragma unroll
            for (int c = 0; c < C; ++c) a[bw_rev4(6 + c)] += __fmul_rn(gc[j][c], w);
          }
          hit = true;
          T[j] = test_T;
        }
        if constexpr (STAGE >= 3) {
          if (__any_sync(FULL_MASK, hit)) {
            const float sum = bw_reduce_scatter<NV>(a, lane);
            const int v = bw_rev4((lane >> 1) & 15);
            if (v < NV && !(lane & 1)) s.part[warp][k][v] = sum;
            hits |= 1ull << k;
          }
        }
      }
    }
    if constexpr (STAGE >= 3) {
      if (lane == 0) s.hit[warp] = hits;
    }
    __syncthreads();
    if (t < n) {
      float d[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) d[i] = 0.0f;
      if constexpr (STAGE >= 3) {
#pragma unroll
        for (int w = 0; w < bw_warps<P>; ++w) {
          if ((s.hit[w] >> t) & 1ull) {
            float pv[4 * ((NV + 3) / 4)];
#pragma unroll
            for (int i = 0; i < (NV + 3) / 4; ++i) {
              const float4 q = reinterpret_cast<const float4*>(s.part[w][t])[i];
              pv[4 * i] = q.x;
              pv[4 * i + 1] = q.y;
              pv[4 * i + 2] = q.z;
              pv[4 * i + 3] = q.w;
            }
#pragma unroll
            for (int i = 0; i < NV; ++i) d[i] += pv[i];
          }
        }
      }
      const float x = s.geo[0][t], y = s.geo[1][t];
      const float A = s.geo[2][t], B = s.geo[3][t], Cc = s.geo[4][t], op = s.geo[5][t];
      float* o = bw_out + t * CR;
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
        for (int c = 0; c < C; ++c) o[6 + c] = (STAGE == 3 ? d[6 + c] : s.rec[t][7 + c]) + fold;
      }
      for (int c = NV; c < CR; ++c) o[c] = 0.0f;
    }
    __syncthreads();
    bw_store<bw_threads<P>>(tdrec + (long long)base * CR, bw_out, (long long)n * CR, vec, t);
    written = base + n;
    if (__syncthreads_and(bw_all(done))) break;
  }
  bw_store<bw_threads<P>>(tdrec + (long long)written * CR, nullptr, (long long)(K - written) * CR,
                          vec, t);
}
