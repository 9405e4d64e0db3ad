// The backward walk of K9 (fused.cu::fused_bwd_kernel) and K8
// (blend_coeffs.cu::blend_coeffs_bwd_kernel): the recompute-forward VJP of
// one 16x16 tile over its slots' quadratic-falloff rows, several pixels a
// thread. It computes what coeff_walk.cuh::coeff_walk_bwd computes, pixel
// for pixel: the falloff polynomial in tile-local pixels, alpha = min(0.99,
// raw) with raw = opacity * exp(power), used only where power <= 0 and raw
// >= 1/255, the walk stopping before the slot where T * (1 - alpha) <
// 1e-4, dpower = dalpha raw and dopacity = dalpha exp(power) only where raw
// < 0.99, the same walk 1 (T_bg and S, the total of dw * w over the
// accepted slots) and the same suffix R = S - prefix in walk 2. Only the
// order of the per-slot sums over the tile's 256 pixels, and the
// polynomial's roundings (the power policy's), differ.
//
// K9's and K8's rule is not K2's and K3's (blend_walk_bwd.cuh: exp(power +
// log opacity), the opacity's cotangent from the constant coefficient's),
// so this is a copy of K3's structure on K9's arithmetic, not a call into
// that header; it shares its constants only (coeff_walk.cuh).
//
// coeff_walk_bwd_px takes three policies (its comment gives their calls):
// - staging: K9's cb_stage (the candidate records made tile-local
//   coefficients, the ellipse's bands below; in walk 2 the geometry too);
//   K8's blend_coeffs.cu::CoeffStage (the [K, 8] coefficient rows, the
//   bands of k8_bands), the forwards' staging;
// - power: K9's cb_power; K8's coeff_walk_fwd.cuh::cf_power, its
//   forward's and its `_v1`'s roundings, so that its backward recomputes
//   the pairs its forward took (cb_power's order would part from them at
//   alpha = 1/255);
// - epilogue: K9's transpose of the coefficients into [n, 6 + C] record
//   rows (fused.cu::CandGradRows); K8's three outputs written directly
//   (blend_coeffs.cu::CoeffGradRows). Each builds a chunk's rows in shared
//   memory and writes each output as one contiguous run of 16-byte stores
//   (cb_store; scalar where a tile's rows are not 16-byte aligned), as it
//   does the zeros of the slots past the walk.
// K9's staging, power and epilogue are the expressions they were before
// the walk took policies, so its bits did not move (blend_digests.py).
//
// Design, as K3's (blend_walk_bwd.cuh says why), where coeff_walk_bwd
// (one thread a pixel, 8 warps a tile, every slot evaluated at every
// pixel, 7 + C five-step butterflies a slot a warp, each slot's row
// written by one thread in scalar stores) spends its time:
// - P pixels a thread (CB_P; K9's stage entry point builds 1 and 4 too,
//   for timing): a tile is CW_NPIX / P threads, warp w on the rows of the
//   2-row bands P w .. P w + P - 1 (cb_pixel). chip_smoke.py times K9's
//   backward (this kernel and the route kernel) at 1, 2 and 4 pixels a
//   thread in turns: on an NVIDIA H100 80GB HBM3 at 700 W, at frame 0 of
//   its scene, 0.288, 0.286 and 0.351 ms (the design before 0.436). At 1
//   the 8 warps a tile make up for ptxas' spills (80 registers); at 4 two
//   warps a tile leave too few warps: 447 tiles hold a slot, 187 of them
//   K, about 1.4 full tiles an SM.
// - Band culling. Staging marks the 2-row bands of the tile where the
//   slot's raw can reach 1/255; a warp skips a slot none of its bands can
//   take, which gives the bits the walk gives without the cull (held bit
//   for bit against the same kernel with the cull off). After staging,
//   one block vote (the barrier staging needs anyway) skips a chunk no
//   warp can take a slot of: K8's opacity-0 padding, whose bands are none.
// - A staged slot is a 16-byte-aligned row of CB_ROW floats (c0..c5, the
//   opacity, C colours, the band mask in the last float); a warp reads the
//   band word, then, where it can take the slot, the row in broadcast
//   16-byte loads. CB_ROW = 20 floats is an odd number of 16-byte words,
//   so the staging's 16-byte stores and the epilogue's 16-byte reads of
//   the warps' partials, one row a thread, meet no bank conflict (a
//   quarter warp's 8 rows start 5 words apart: 8 distinct 4-bank groups).
// - Per slot each thread adds its own pixels' 7 + C contributions, then
//   the warp sums them by a reduce-scatter: the values sit in S = 16 slots
//   (32 where 7 + C > 16) in bit-reversed order, each halving step
//   exchanges only the slot pairs that hold a value, so 7 + C = 13 values
//   at C 6 take 7 + 4 + 2 + 1 + 1 = 15 shuffles where the butterflies take
//   65. A slot no lane of the warp accepted costs no shuffle. The warps'
//   partials are added in warp order: deterministic, no atomics.
// - Walk 2 keeps what the epilogue needs in shared memory (K9: each
//   staged slot's tile-local geometry), so the epilogue reads no row again.
//
// The cull's bound. raw = opacity * exp(power) >= 1/255 needs power >=
// -log(255 opacity), i.e. Q = A dx^2 + 2 B dx dy + C dy^2 <= r2 =
// 2 (log(opacity) + log(255)) at the pixel's offset (dx, dy) from the
// centre, an ellipse whose rows span |dy| <= sqrt(r2 A / det). What the
// walk rounds, moved into Q:
// - the product raw = opacity * expf(power): expf is within 2 ulp, the
//   product within 1/2, so raw is within 3 * 2^-23 (3.6e-7) of opacity *
//   exp(power) relatively, which moves the power's edge by 3.6e-7 and Q's
//   by 7.2e-7; the 1/255 constant's rounding adds 1.2e-7 in Q;
// - the bound's own r2 (logf within 1 ulp of |log opacity| <= 28):
//   at most 4e-6 in Q;
// - the power's roundings: its terms, up to ~1e3 times Q where det >= 1e-3
//   A C, round at ~1e-7 of their size, and near a narrow slot's centre a
//   pixel moves by up to a quarter pixel.
// So r2 is widened by 1% and by CB_R2_SLACK = 1e-3 (over 200 times the
// first two items), and the extent by a quarter pixel: K3's margins, which
// cover K9's rounding. Every band where the conic is not clearly positive
// definite or a value is not finite. (K8's bound from its coefficients
// alone is blend_coeffs.cu's.)
//
// Stage cuts: the STAGE template parameter (default 4, the whole walk)
// stops the work early; each cut folds what it computed into one value a
// thread, given to the epilogue's fold (the tile's first output floats),
// so that no stage is dead code:
//   0  selection (K9's, the caller's) and both walks' staging
//   1  + walk 1's arithmetic
//   2  + walk 2's per-pixel arithmetic, without the per-slot sums
//   3  + the per-slot sums (reduce-scatter, the warps' partials)
//   4  + the epilogue and the rows' stores: the backward itself
// Stages 0-1 do no walk-2 arithmetic, so no pixel stops and they stage
// every chunk of both walks.

#pragma once

#include "coeff_walk.cuh"

#define CB_P 2                 // the backward's pixels a thread: 128 threads, 4 warps a tile
#define CB_CHUNK 64            // slots a chunk (a 64-bit hit mask a warp)
#define CB_ROW 20              // floats a staged row (16-byte multiple)
#define CB_BAND 19             // the row's float that holds the band mask
#define CB_LOG255 5.54126354f  // log(255)
#define CB_R2_SLACK 1e-3f      // the band bound's margin in Q, past its 1%
#define CB_OP_EPS 1e-12f       // the bound's floor under log(opacity)

template <int P>
constexpr int cb_threads = CW_NPIX / P;
template <int P>
constexpr int cb_warps = CW_NPIX / P / 32;

// Tile pixel (dy * 16 + dx) of thread t's pixel j: warp w takes the 2P
// rows from 2Pw, lane l the column l % 16 and the rows 2Pw + l / 16 + 2j,
// so warp w's pixels j form the 2-row band P w + j.
template <int P>
__host__ __device__ constexpr int cb_pixel(int t, int j) {
  return ((t / 32) * (32 * P / CW_TILE) + (t % 32) / CW_TILE + j * (32 / CW_TILE)) * CW_TILE +
         t % CW_TILE;
}

// The reduce-scatter's slot count for NV values.
template <int NV>
constexpr int cb_slots = NV <= 16 ? 16 : 32;

// Slot of value i among S slots: its bit reversal (4 bits at S 16, 5 at 32).
template <int S>
__host__ __device__ constexpr int cb_rev(int i) {
  int r = 0;
  for (int b = 0; b < (S == 16 ? 4 : 5); ++b) r |= ((i >> b) & 1) << ((S == 16 ? 3 : 4) - b);
  return r;
}

// Bit s set: slot s of a vector folded to length len holds one of the nv
// values (slot s then sums original slots s, s + len, ...).
template <int S>
__host__ __device__ constexpr unsigned long long cb_live(int nv, int len) {
  unsigned long long m = 0;
  for (int v = 0; v < nv; ++v) m |= 1ull << (cb_rev<S>(v) % len);
  return m;
}

// One halving step of the reduce-scatter, from length LEN: a lane with the
// step's lane bit (LEN * 16 / S) set keeps the upper half of its LEN slots
// and receives its partner's, the other the lower half; slot pairs that
// hold no value are skipped.
template <int NV, int S, int LEN>
__device__ __forceinline__ void cb_fold(float (&a)[S], int lane) {
  constexpr int H = LEN / 2;
  constexpr unsigned long long live = cb_live<S>(NV, LEN);
  const bool upper = lane & (LEN * 16 / S);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    if (((live >> i) | (live >> (i + H))) & 1ull) {
      const float send = upper ? a[i] : a[i + H];
      const float keep = upper ? a[i + H] : a[i];
      a[i] = keep + __shfl_xor_sync(CW_FULL_MASK, send, LEN * 16 / S);
    }
  }
}

// The warp's sums of NV values held in slots cb_rev<S>(v) of each lane:
// returns at lane u the sum of value cb_value<S>(u) (S 16: the same at
// lanes 2m and 2m + 1; no value where that index is >= NV).
template <int NV, int S>
__device__ __forceinline__ float cb_reduce_scatter(float (&a)[S], int lane) {
  if constexpr (S == 32) cb_fold<NV, S, 32>(a, lane);
  cb_fold<NV, S, 16>(a, lane);
  cb_fold<NV, S, 8>(a, lane);
  cb_fold<NV, S, 4>(a, lane);
  cb_fold<NV, S, 2>(a, lane);
  if constexpr (S == 16) return a[0] + __shfl_xor_sync(CW_FULL_MASK, a[0], 1);
  return a[0];
}

template <int S>
__device__ __forceinline__ int cb_value(int lane) {
  return S == 16 ? cb_rev<16>((lane >> 1) & 15) : cb_rev<32>(lane);
}

template <int P>
__device__ __forceinline__ bool cb_all(const bool (&done)[P]) {
  bool a = true;
#pragma unroll
  for (int j = 0; j < P; ++j) a = a && done[j];
  return a;
}

template <int C, int P>
struct CbShared {
  __align__(16) float rec[CB_CHUNK][CB_ROW];                // staged slots
  float geo[5][CB_CHUNK];                                   // tile-local x, y and A, B, C (walk 2)
  __align__(16) float part[cb_warps<P>][CB_CHUNK][CB_ROW];  // each warp's per-slot sums
  unsigned long long hit[cb_warps<P>];                      // slots some lane accepted
};

// K9's staging: the chunk's slot t (thread t < n), candidate s_sel[base + t] of
// the block's records vb (16 floats each) as its six tile-local falloff
// coefficients (the JAX kernels' _coeffs_from_rec), its opacity and C
// colours, and the bands it can reach (all without cull), into s.rec[t];
// with GEO, its geometry into s.geo. Sh is the caller's shared layout:
// CbShared here, coeff_walk_fwd.cuh's CfShared for K9's forward (rows
// only, no GEO).
template <int C, int P, bool GEO, class Sh>
__device__ __forceinline__ void cb_stage(const float* __restrict__ vb, bool vec, bool cull,
                                         const int* s_sel, int base, int n, float sx, float sy,
                                         Sh& s, int t) {
  if (t >= n) return;
  const float* r = vb + (long long)s_sel[base + t] * 16;
  float v[16];
  if (vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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
  const float A = v[2], B = v[3], Cc = v[4], op = v[5];
  // the bands (rows 2b, 2b + 1) where some pixel can take the slot: the
  // header's bound
  unsigned bands = 0xFFu;
  const float r2 = 2.0f * (logf(fmaxf(op, CB_OP_EPS)) + CB_LOG255);
  const float det = A * Cc - B * B;
  if (cull && A > 0.0f && Cc > 0.0f && det > 1e-3f * A * Cc) {
    const float ext = sqrtf((fmaxf(r2, 0.0f) * 1.01f + CB_R2_SLACK) * A / det) + 0.25f;
    if (ext < 1e30f && y - ext < 1e30f && y + ext > -1e30f) {
      bands = 0;
#pragma unroll
      for (int b = 0; b < CW_NPIX / CW_TILE / 2; ++b)
        if (2.0f * b + 1.0f >= y - ext && 2.0f * b <= y + ext) bands |= 1u << b;
    }
  }
  float o[CB_ROW] = {};
  o[0] = -0.5f * (A * x * x + Cc * y * y) - B * x * y;
  o[1] = A * x + B * y;
  o[2] = Cc * y + B * x;
  o[3] = -0.5f * A;
  o[4] = -0.5f * Cc;
  o[5] = -B;
  o[6] = op;
#pragma unroll
  for (int c = 0; c < C; ++c) o[7 + c] = v[6 + c];
  o[CB_BAND] = __uint_as_float(bands);
#pragma unroll
  for (int i = 0; i < CB_ROW / 4; ++i)
    reinterpret_cast<float4*>(s.rec[t])[i] = make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2],
                                                         o[4 * i + 3]);
  if constexpr (GEO) {
    s.geo[0][t] = x;
    s.geo[1][t] = y;
    s.geo[2][t] = A;
    s.geo[3][t] = B;
    s.geo[4][t] = Cc;
  }
}

// Staged slot k for warp `warp`: the bands of the warp that can take it
// (bit j: pixel j's band, P warp + j), and where one can, its six
// coefficients, opacity and colours, in broadcast 16-byte loads.
template <int C, int P>
__device__ __forceinline__ unsigned cb_slot(const CbShared<C, P>& s, int k, int warp,
                                            float (&rc)[7], float (&col)[C]) {
  const unsigned jm = (__float_as_uint(s.rec[k][CB_BAND]) >> (warp * P)) & ((1u << P) - 1u);
  if (!jm) return 0;  // the rest is not read
  constexpr int NR4 = (7 + C + 3) / 4;
  float v[4 * NR4];
#pragma unroll
  for (int i = 0; i < NR4; ++i) {
    const float4 q = reinterpret_cast<const float4*>(s.rec[k])[i];
    v[4 * i] = q.x;
    v[4 * i + 1] = q.y;
    v[4 * i + 2] = q.z;
    v[4 * i + 3] = q.w;
  }
#pragma unroll
  for (int i = 0; i < 7; ++i) rc[i] = v[i];
#pragma unroll
  for (int c = 0; c < C; ++c) col[c] = v[7 + c];
  return jm;
}

// The falloff power c0 + c1 fx + c2 fy + c3 fx^2 + c4 fy^2 + c5 fx fy at
// pixel (fx, fy), its roundings fixed by the intrinsics (fx^2, fy^2, fx fy
// are exact), and exp(power), at the thread's P pixels in straight-line
// code, so that the pixels' chains interleave.
template <int P>
__device__ __forceinline__ void cb_power(const float (&rc)[7], float fx, const float (&fy)[P],
                                         float (&pw)[P], float (&e)[P]) {
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float t = __fmaf_rn(rc[3], fx * fx, __fmaf_rn(rc[2], fy[j], __fmul_rn(rc[1], fx)));
    pw[j] = __fadd_rn(rc[0], __fmaf_rn(rc[5], fx * fy[j], __fmaf_rn(rc[4], fy[j] * fy[j], t)));
    e[j] = expf(pw[j]);
  }
}

// n floats from shared src to global dst by the block's THREADS threads:
// 16-byte vectors with vec (dst and src 16-byte aligned), the remainder
// of n % 4 scalar; zeros where src is null.
template <int THREADS>
__device__ __forceinline__ void cb_store(float* __restrict__ dst, const float* src, int n,
                                         bool vec, int t) {
  int e0 = 0;
  if (vec) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    const float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e = t; e < n / 4; e += THREADS) d4[e] = src ? s4[e] : z;
    e0 = n / 4 * 4;
  }
  for (int e = e0 + t; e < n; e += THREADS) dst[e] = src ? src[e] : 0.0f;
}

// The power policy of K9's backward: cb_power's roundings.
struct CbPower {
  template <int P>
  __device__ __forceinline__ static void eval(const float (&rc)[7], float fx, const float (&fy)[P],
                                              float (&pw)[P], float (&e)[P]) {
    cb_power<P>(rc, fx, fy, pw, e);
  }
};

// The backward of one tile by the calling block of cb_threads<P> threads
// over its n slots: thread t's pixels' cotangents gc[j] (colours) and
// g_tbg[j] (T_bg) in; each slot's 7 + C sums (the six coefficients', the
// opacity's, the C colours') out through the epilogue. The three
// policies:
// - stage.template rows<GEO>(base, m, r, s), called by thread r for each
//   r < m: slot base + r's row into s.rec[r] (c0..c5, the opacity, C
//   colours, the band word in CB_BAND; every band without cull) and, with
//   GEO (walk 2), what the epilogue reads of it into s.geo;
// - Power::template eval<P>(rc, fx, fy, pw, e): the falloff power at the
//   thread's P pixels, and its exp;
// - epi.row(r, d, s): thread r < m puts slot base + r's sums d into the
//   chunk's output rows (in shared memory); epi.store(base, m, t), after a
//   barrier, writes them out; epi.zeros(from, n, t) writes the zeros of
//   the slots [from, n) past the walk; epi.fold(t, n, v) takes a stage
//   cut's value.
// After staging, one block vote skips a chunk whose slots no warp's bands
// can take (no slot of it would be walked): the same bits.
template <int C, int P, int STAGE, class Power, class Stage, class Epi>
__device__ __forceinline__ void coeff_walk_bwd_px(int n, const Stage& stage,
                                                  const float (&gc)[P][C],
                                                  const float (&g_tbg)[P], const Epi& epi) {
  constexpr int NV = 7 + C;  // per slot: the six coefficients', the opacity's, the colours'
  constexpr int S = cb_slots<NV>;
  static_assert(7 + C < CB_BAND && NV <= CB_ROW, "C above 10");
  static_assert(P == 1 || P == 2 || P == 4, "1, 2 or 4 pixels a thread");
  __shared__ CbShared<C, P> s;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float fx = (float)(t % CW_TILE);
  float fy[P];
#pragma unroll
  for (int j = 0; j < P; ++j) fy[j] = (float)(cb_pixel<P>(t, j) / CW_TILE);
  float fold = 0.0f;  // the stage cuts' sink for what they compute

  // -- walk 1: T_bg and the total of ds = dw * w over accepted slots --
  float T[P], Sd[P];
  bool done[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    T[j] = 1.0f;
    Sd[j] = 0.0f;
    done[j] = false;
  }
  for (int base = 0; base < n; base += CB_CHUNK) {
    const int m = min(CB_CHUNK, n - base);
    __syncthreads();  // the previous chunk has been read
    if (t < m) stage.template rows<false>(base, m, t, s);
    // some warp's bands can take a slot of the chunk
    const bool any = __syncthreads_or(t < m && __float_as_uint(s.rec[t][CB_BAND]) != 0u);
    if constexpr (STAGE == 0) {
      if (t < m) fold += s.rec[t][0] + s.rec[t][6];
    } else if (any) {
      for (int k = 0; k < m; ++k) {
        if (cb_all(done)) break;
        float rc[7], col[C], pw[P], e[P];
        if (!cb_slot<C, P>(s, k, warp, rc, col)) continue;  // no pixel of the warp can take it
        Power::template eval<P>(rc, fx, fy, pw, e);
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float raw = rc[6] * e[j];
          const float alpha = fminf(CW_ALPHA_MAX, raw);
          const float test_T = T[j] * (1.0f - alpha);
          const bool use = !done[j] && pw[j] <= 0.0f && raw >= CW_ALPHA_SKIP;
          const bool stop = use && test_T < CW_T_EPS;
          const bool acc = use && !stop;
          float dw = 0.0f;
#pragma unroll
          for (int c = 0; c < C; ++c) dw += gc[j][c] * col[c];
          const float S1 = Sd[j] + dw * (alpha * T[j]);
          Sd[j] = acc ? S1 : Sd[j];
          T[j] = acc ? test_T : T[j];
          done[j] = done[j] || stop;
        }
      }
    }
    if (__syncthreads_and(cb_all(done))) break;
  }
  if constexpr (STAGE == 1) {
#pragma unroll
    for (int j = 0; j < P; ++j) fold += T[j] + Sd[j];
  }

  // -- walk 2: the cotangents; R = the ds of the accepted slots behind --
  float R[P], gt_bg[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    gt_bg[j] = g_tbg[j] * T[j];  // dlg of every accepted slot includes it
    R[j] = Sd[j];
    T[j] = 1.0f;
    done[j] = false;
  }
  int written = 0;
  for (int base = 0; base < n; base += CB_CHUNK) {
    const int m = min(CB_CHUNK, n - base);
    __syncthreads();  // the previous chunk's rows have been read and stored
    if (t < m) stage.template rows<true>(base, m, t, s);
    const bool any = __syncthreads_or(t < m && __float_as_uint(s.rec[t][CB_BAND]) != 0u);
    unsigned long long hits = 0;  // warp-uniform: slots some lane of this warp accepted
    if constexpr (STAGE >= 2) {
      for (int k = 0; any && k < m; ++k) {
        if (__all_sync(CW_FULL_MASK, cb_all(done))) break;
        float rc[7], col[C], pw[P], e[P];
        if (!cb_slot<C, P>(s, k, warp, rc, col)) continue;  // warp-uniform: none can take it
        Power::template eval<P>(rc, fx, fy, pw, e);
        float a[S];
#pragma unroll
        for (int i = 0; i < S; ++i) a[i] = 0.0f;
        bool hit = false;
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float raw = rc[6] * e[j];
          const float alpha = fminf(CW_ALPHA_MAX, raw);
          const float test_T = T[j] * (1.0f - alpha);
          const bool use = !done[j] && pw[j] <= 0.0f && raw >= CW_ALPHA_SKIP;
          const bool stop = use && test_T < CW_T_EPS;
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
          const bool live = raw < CW_ALPHA_MAX;
          const float dp = live ? dalpha * raw : 0.0f;
          const float dop = live ? dalpha * e[j] : 0.0f;
          if constexpr (STAGE == 2) {
            fold += dp + dop + w;
          } else {
            a[cb_rev<S>(0)] += dp;
            a[cb_rev<S>(1)] += __fmul_rn(dp, fx);
            a[cb_rev<S>(2)] += __fmul_rn(dp, fy[j]);
            a[cb_rev<S>(3)] += __fmul_rn(dp, fx * fx);
            a[cb_rev<S>(4)] += __fmul_rn(dp, fy[j] * fy[j]);
            a[cb_rev<S>(5)] += __fmul_rn(dp, fx * fy[j]);
            a[cb_rev<S>(6)] += dop;
#pragma unroll
            for (int c = 0; c < C; ++c) a[cb_rev<S>(7 + c)] += __fmul_rn(gc[j][c], w);
          }
          hit = true;
          T[j] = test_T;
        }
        if constexpr (STAGE >= 3) {
          if (__any_sync(CW_FULL_MASK, hit)) {
            const float sum = cb_reduce_scatter<NV, S>(a, lane);
            const int v = cb_value<S>(lane);
            if (v < NV && (S == 32 || !(lane & 1))) s.part[warp][k][v] = sum;
            hits |= 1ull << k;
          }
        }
      }
    }
    if constexpr (STAGE >= 3) {
      if (lane == 0) s.hit[warp] = hits;
    }
    __syncthreads();
    if constexpr (STAGE >= 3) {
      if (t < m) {
        float d[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) d[i] = 0.0f;
#pragma unroll
        for (int w = 0; w < cb_warps<P>; ++w) {
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
        if constexpr (STAGE == 3) {
#pragma unroll
          for (int i = 0; i < NV; ++i) fold += d[i];
        } else {
          epi.row(t, d, s);
        }
      }
    }
    if constexpr (STAGE == 4) {
      __syncthreads();
      epi.store(base, m, t);
    }
    written = base + m;
    if (__syncthreads_and(cb_all(done))) break;
  }
  if constexpr (STAGE == 4) {
    epi.zeros(written, n, t);
  } else {
    epi.fold(t, n, fold);
  }
}
