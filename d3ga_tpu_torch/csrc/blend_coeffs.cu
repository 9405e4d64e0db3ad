// K8: per-tile front-to-back alpha blend over precomputed quadratic
// falloff coefficients, forward and backward.
//
// Replaces the TPU kernels d3ga_tpu/raster/pallas_blend.py::_run_forward
// (_forward_body) and ::_run_backward (_backward_body) behind
// blend_tiles_pallas. Inputs are per-tile gathered slots: coeffs [T, K, 8]
// (six used, two padding), colors [T, K, C], opacs [T, 1, K]; the forward
// writes [T, 256, C+1] (pixel p = dy * 16 + dx, T_bg last), the backward
// d(coeffs) [T, K, 8] (the padding's cotangent 0), d(colors) [T, K, C]
// and d(opacs) [T, 1, K] from the cotangent of that output. The TPU
// kernel's bf16 hi/lo split matmuls are a TPU precision workaround; this
// kernel computes in float32. The semantics are coeff_walk.cuh's.
//
// Bound on Hopper: operations where tiles are full. Each visited
// (pixel, slot) pair costs one exp and 15 + 2C FP32 operations forward,
// 35 + 4C backward (21 and 47 at C 3, as chip_smoke.py counts them); at
// the stage bench's shapes (T 2688, K 256, C 3) the inputs are 8.3 MB and
// the output 11 MB.
//
// Design. Forward (blend_coeffs_kernel): one block of 128 threads per
// tile, coeff_walk_fwd.cuh's walk (K2's design on K9's rule: two pixels a
// thread, a 2-row band cull, per-warp slot lists in batches of 8; that
// header says why), each chunk's rows staged from the tile's [K, 8]
// coefficients (two 16-byte loads), opacities and colours, the tile's
// block written as 16-byte stores; its image is the design before's to the
// bit. The design before (256 threads, one a pixel, coeff_walk.cuh's
// coeff_walk_fwd, each thread storing its pixel) stays as
// blend_coeffs_v1_kernel, launched by d3ga_blend_coeffs_v1 (chip_smoke.py
// only); d3ga_blend_coeffs_stage launches the kernel with its band cull
// off at every C and, at K8_STAGE_C only, cut at coeff_walk_fwd.cuh's
// stages or with 1, 2 or 4 slots a batch. Backward
// (blend_coeffs_bwd_kernel): one block of 128 threads per tile,
// coeff_walk_bwd.cuh's walk (K9's backward's: two pixels a thread, the
// band cull, per-slot sums by a warp reduce-scatter; that header says why)
// with this file's staging (CoeffStage, the forward's: K8 has no slot
// count, and its opacity-0 padding has no band, so a chunk of it is
// skipped by one block vote), the forward's power (cf_power: the
// backward takes the pairs the forward took) and a direct-row epilogue
// (CoeffGradRows). Every tile owns its K slots, so each chunk's rows of
// d(coeffs) (columns 6-7 zero), d(opacs) and d(colors) are built in
// shared memory and written straight to the outputs as 16-byte stores: no
// atomics, no second pass. The design before (256 threads, one a pixel,
// coeff_walk.cuh's coeff_walk_bwd, each slot's row stored by one thread)
// stays as blend_coeffs_bwd_v1_kernel, launched by
// d3ga_blend_coeffs_bwd_v1 (chip_smoke.py only); d3ga_blend_coeffs_bwd_stage
// launches the kernel with its band cull off at every C and, at
// K8_STAGE_C only, cut at coeff_walk_bwd.cuh's stages.
//
// The band cull's bound (k8_bands). No centre or conic is given, so the
// bands come from the polynomial. On row dy, power is a quadratic in dx
// whose largest value over real dx, where c3 < 0, is
//   top(dy) = c0 + c2 dy + c4 dy^2 + (c1 + c5 dy)^2 / (-4 c3),
// at least the power of every pixel of the row. A pixel takes the slot
// only where raw = opacity * expf(power) >= 1/255, i.e. power >= -L with
// L = log(255 opacity). A band (rows 2b, 2b + 1) is kept where
// top + L + margin >= 0 on either row. What rounds, moved into power:
// - the walk's power: five fmas, each within 2^-24 of a partial sum no
//   larger than S = |c0| + 15 |c1| + dy |c2| + 225 |c3| + dy^2 |c4| +
//   15 dy |c5|: within 5 * 2^-24 S of the exact polynomial;
// - the bound's own top: c1 + c5 dy within 2^-23 u of its exact value (u =
//   |c1| + dy |c5|), so the square term within about 2^-21 u^2 / (4 |c3|),
//   the other terms within 2^-22 S;
// - raw: expf within 2 ulp and the product within 1/2, 3.6e-7 relative,
//   3.6e-7 in power; the 1/255 constant 6e-8; logf within 1 ulp of |L|,
//   the final sum within 2^-23 (|top| + |L|).
// So the margin is 1e-5 (over 160 x 2^-24) times S + u^2 / (4 |c3|) + |L|,
// plus 1e-3 in power (over 1000 times the fixed terms). Opacity <= 0
// means no band (raw is never positive); a value that is not finite, or
// c3 >= 0 (the row's power is not bounded above over dx), means every
// band; a test that comes out NaN keeps the band. chip_smoke.py holds the
// culled kernel bit for bit against the same kernel with the cull off;
// tests/test_torch_coeff_walk_fwd.py holds the bound's float32 emulation
// against the plain forward's taken pairs.

#include <cstdint>

#include "coeff_walk.cuh"
#include "coeff_walk_fwd.cuh"

#define K8_REL_SLACK 1e-5f  // the band bound's margin: relative to the row's terms
#define K8_ABS_SLACK 1e-3f  // and absolute, in power
#define K8_STAGE_C 6        // the C the stage cuts and the batch variants are built for

template <int C>
struct CoeffRows {
  const float* coeffs;  // the tile's [K, 8]
  const float* colors;  // [K, C]
  const float* opacs;   // [K]
  template <class Chunk>
  __device__ __forceinline__ void operator()(int k, int j, Chunk& s) const {
    const float* c = coeffs + (long long)k * 8;
#pragma unroll
    for (int i = 0; i < 6; ++i) s.c[i][j] = c[i];
    s.op[j] = opacs[k];
#pragma unroll
    for (int i = 0; i < C; ++i) s.col[i][j] = colors[(long long)k * C + i];
  }
};

// The 2-row bands (bit b: rows 2b, 2b + 1) where a slot of coefficients
// c and opacity op can be taken (the header's bound): none at op <= 0,
// every band where a value is not finite or c3 >= 0.
__device__ __forceinline__ unsigned k8_bands(const float (&c)[6], float op) {
  if (op <= 0.0f) return 0u;
  bool finite = isfinite(op);
#pragma unroll
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(c[i]);
  if (!finite || !(c[3] < 0.0f)) return 0xFFu;
  const float lop = logf(op) + CB_LOG255;  // taken needs power >= -lop
  const float inv = 1.0f / (-4.0f * c[3]);
  unsigned bands = 0u;
#pragma unroll
  for (int y = 0; y < CW_TILE; ++y) {
    const float fy = (float)y;
    const float q = c[1] + c[5] * fy;
    const float u = fabsf(c[1]) + fabsf(c[5]) * fy;
    const float top = c[0] + c[2] * fy + c[4] * fy * fy + q * q * inv;
    const float mag = fabsf(c[0]) + 15.0f * fabsf(c[1]) + fabsf(c[2]) * fy +
                      225.0f * fabsf(c[3]) + fabsf(c[4]) * fy * fy + 15.0f * fabsf(c[5]) * fy +
                      u * u * inv + fabsf(lop);
    // not "reaches": a NaN from overflowing terms keeps the band
    if (!(top + lop + K8_REL_SLACK * mag + K8_ABS_SLACK < 0.0f)) bands |= 1u << (y >> 1);
  }
  return bands;
}

// Stages slot base + r of the tile: its six coefficients (two 16-byte
// loads with vec), opacity and C colours, and its bands (every band
// without cull), as one CB_ROW row; the forward's (CfShared) and the
// backward's (CbShared: no geometry, GEO is not read).
template <int C, int P>
struct CoeffStage {
  const float* coeffs;  // the tile's [K, 8]
  const float* colors;  // [K, C]
  const float* opacs;   // [K]
  bool vec, cull;
  template <bool GEO, class Sh>
  __device__ __forceinline__ void rows(int base, int m, int r, Sh& s) const {
    const long long k = base + r;
    float c[6];
    if (vec) {
      const float4 a = reinterpret_cast<const float4*>(coeffs + k * 8)[0];
      const float4 b = reinterpret_cast<const float4*>(coeffs + k * 8)[1];
      c[0] = a.x;
      c[1] = a.y;
      c[2] = a.z;
      c[3] = a.w;
      c[4] = b.x;
      c[5] = b.y;
    } else {
#pragma unroll
      for (int i = 0; i < 6; ++i) c[i] = coeffs[k * 8 + i];
    }
    const float op = opacs[k];
    float o[CB_ROW] = {};
#pragma unroll
    for (int i = 0; i < 6; ++i) o[i] = c[i];
    o[6] = op;
#pragma unroll
    for (int i = 0; i < C; ++i) o[7 + i] = colors[k * C + i];
    o[CB_BAND] = __uint_as_float(cull ? k8_bands(c, op) : 0xFFu);
#pragma unroll
    for (int i = 0; i < CB_ROW / 4; ++i)
      reinterpret_cast<float4*>(s.rec[r])[i] =
          make_float4(o[4 * i], o[4 * i + 1], o[4 * i + 2], o[4 * i + 3]);
  }
};

// The forward: coeff_walk_fwd_px at P pixels a thread and R slots a batch,
// the tile's block written by cf_store. vec: coeffs 16-byte aligned; cull:
// the band cull on.
template <int C, int P = CB_P, int R = CF_R, int STAGE = 2>
__global__ void __launch_bounds__(cb_threads<P>)
blend_coeffs_kernel(const float* __restrict__ coeffs, const float* __restrict__ colors,
                    const float* __restrict__ opacs, int K, int vec, int cull,
                    float* __restrict__ out) {
  __shared__ CfShared<P> s;
  const long long t = blockIdx.x;
  const CoeffStage<C, P> stage{coeffs + t * K * 8, colors + t * K * C, opacs + t * K, vec != 0,
                               cull != 0};
  float acc[P][C], T[P];
  coeff_walk_fwd_px<C, P, R, STAGE>(K, stage, s, acc, T);
  cf_store<C, P>(s, acc, T, out + t * CW_NPIX * (C + 1));
}

// The forward's design before: one thread a pixel, coeff_walk_fwd.
template <int C>
__global__ void __launch_bounds__(CW_NPIX)
blend_coeffs_v1_kernel(const float* __restrict__ coeffs, const float* __restrict__ colors,
                    const float* __restrict__ opacs, int K, float* __restrict__ out) {
  const long long t = blockIdx.x;
  const int p = threadIdx.x;
  const CoeffRows<C> rows{coeffs + t * K * 8, colors + t * K * C, opacs + t * K};
  float acc[C];
  const float T = coeff_walk_fwd<C>(K, rows, acc);
  float* o = out + (t * CW_NPIX + p) * (C + 1);
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = acc[c];
  o[C] = T;
}

// The backward's epilogue (coeff_walk_bwd_px's Epi): each chunk's three
// outputs built in shared memory out (CB_CHUNK * (9 + C) floats: the [m, 8]
// coefficient rows, columns 6-7 zero, then the [m] opacities, then the
// [m, C] colours) and each written to the tile's rows as one contiguous
// run (16-byte stores with vec); a stage cut's value to the tile's first
// coefficient floats.
template <int C, int P>
struct CoeffGradRows {
  float* dcoeffs;  // the tile's [K, 8]
  float* dcolors;  // [K, C]
  float* dopacs;   // [K]
  float* out;
  bool vec;
  template <class Sh>
  __device__ __forceinline__ void row(int r, const float (&d)[7 + C], const Sh&) const {
    float4* o = reinterpret_cast<float4*>(out + r * 8);
    o[0] = make_float4(d[0], d[1], d[2], d[3]);
    o[1] = make_float4(d[4], d[5], 0.0f, 0.0f);
    out[8 * CB_CHUNK + r] = d[6];
#pragma unroll
    for (int c = 0; c < C; ++c) out[9 * CB_CHUNK + r * C + c] = d[7 + c];
  }
  __device__ __forceinline__ void store(int base, int m, int t) const {
    cb_store<cb_threads<P>>(dcoeffs + (long long)base * 8, out, m * 8, vec, t);
    cb_store<cb_threads<P>>(dopacs + base, out + 8 * CB_CHUNK, m, vec, t);
    cb_store<cb_threads<P>>(dcolors + (long long)base * C, out + 9 * CB_CHUNK, m * C, vec, t);
  }
  __device__ __forceinline__ void zeros(int from, int n, int t) const {
    cb_store<cb_threads<P>>(dcoeffs + (long long)from * 8, nullptr, (n - from) * 8, vec, t);
    cb_store<cb_threads<P>>(dopacs + from, nullptr, n - from, vec, t);
    cb_store<cb_threads<P>>(dcolors + (long long)from * C, nullptr, (n - from) * C, vec, t);
  }
  __device__ __forceinline__ void fold(int t, int n, float v) const {
    if (t < n * 8) dcoeffs[t] = v;
  }
};

// The backward: coeff_walk_bwd_px at CB_P pixels a thread with K8's
// staging (CoeffStage), cf_power and the direct-row epilogue
// (CoeffGradRows). vec: coeffs 16-byte aligned; ovec: the three outputs
// 16-byte aligned and K % 4 == 0; cull: the band cull on.
template <int C, int STAGE = 4>
__global__ void __launch_bounds__(cb_threads<CB_P>)
blend_coeffs_bwd_kernel(const float* __restrict__ coeffs, const float* __restrict__ colors,
                        const float* __restrict__ opacs, const float* __restrict__ g, int K,
                        int vec, int ovec, int cull, float* __restrict__ dcoeffs,
                        float* __restrict__ dcolors, float* __restrict__ dopacs) {
  constexpr int P = CB_P;
  __shared__ __align__(16) float out[CB_CHUNK * (9 + C)];
  const long long t = blockIdx.x;
  const int p = threadIdx.x;
  float gc[P][C], g_tbg[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const float* gp = g + (t * CW_NPIX + cb_pixel<P>(p, j)) * (C + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) gc[j][c] = gp[c];
    g_tbg[j] = gp[C];
  }
  const CoeffStage<C, P> stage{coeffs + t * K * 8, colors + t * K * C, opacs + t * K, vec != 0,
                               cull != 0};
  const CoeffGradRows<C, P> epi{dcoeffs + t * K * 8, dcolors + t * K * C, dopacs + t * K, out,
                                ovec != 0};
  coeff_walk_bwd_px<C, P, STAGE, CfPower>(K, stage, gc, g_tbg, epi);
}

// The backward's design before: one thread a pixel, coeff_walk_bwd.
template <int C>
__global__ void __launch_bounds__(CW_NPIX)
blend_coeffs_bwd_v1_kernel(const float* __restrict__ coeffs, const float* __restrict__ colors,
                           const float* __restrict__ opacs, const float* __restrict__ g, int K,
                           float* __restrict__ dcoeffs, float* __restrict__ dcolors,
                           float* __restrict__ dopacs) {
  const long long t = blockIdx.x;
  const int p = threadIdx.x;
  const CoeffRows<C> rows{coeffs + t * K * 8, colors + t * K * C, opacs + t * K};
  const float* gp = g + (t * CW_NPIX + p) * (C + 1);
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = gp[c];
  float* dco = dcoeffs + t * K * 8;
  float* dcol = dcolors + t * K * C;
  float* dop = dopacs + t * K;
  coeff_walk_bwd<C>(K, rows, gc, gp[C], [&](int k, const float* d) {
#pragma unroll
    for (int i = 0; i < 6; ++i) dco[(long long)k * 8 + i] = d[i];
    dco[(long long)k * 8 + 6] = 0.0f;
    dco[(long long)k * 8 + 7] = 0.0f;
    dop[k] = d[6];
#pragma unroll
    for (int c = 0; c < C; ++c) dcol[(long long)k * C + c] = d[7 + c];
  });
}

template <int C, int R, int STAGE>
static int launch_fwd(const float* co, const float* col, const float* op, int T, int K, int cull,
                      float* o, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(o) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const int vec = (reinterpret_cast<uintptr_t>(co) & 15) == 0;
  blend_coeffs_kernel<C, CB_P, R, STAGE><<<T, cb_threads<CB_P>, 0, s>>>(co, col, op, K, vec, cull,
                                                                       o);
  return (int)cudaGetLastError();
}

// design 1: the kernel; 2: the kernel with the band cull off (stage 2, at
// every C); at K8_STAGE_C only, design 1 cut at stages 0-1 and designs
// 3-5, the walk at 1, 2 and 4 slots a batch (stage 2).
template <int C>
static int launch_fwd_stage(const float* co, const float* col, const float* op, int T, int K,
                            float* o, int design, int stage, cudaStream_t s) {
  if (stage == 2 && (design == 1 || design == 2))
    return launch_fwd<C, CF_R, 2>(co, col, op, T, K, design == 1, o, s);
  if constexpr (C == K8_STAGE_C) {
    if (design == 1 && stage == 0) return launch_fwd<C, CF_R, 0>(co, col, op, T, K, 1, o, s);
    if (design == 1 && stage == 1) return launch_fwd<C, CF_R, 1>(co, col, op, T, K, 1, o, s);
    if (stage == 2 && design == 3) return launch_fwd<C, 1, 2>(co, col, op, T, K, 1, o, s);
    if (stage == 2 && design == 4) return launch_fwd<C, 2, 2>(co, col, op, T, K, 1, o, s);
    if (stage == 2 && design == 5) return launch_fwd<C, 4, 2>(co, col, op, T, K, 1, o, s);
  }
  return -1;
}

#define K8_ARGS                            \
  const float* co = (const float*)coeffs;  \
  const float* col = (const float*)colors; \
  const float* op = (const float*)opacs;   \
  cudaStream_t s = (cudaStream_t)cuda_stream

// Each returns the cudaError_t of the launch, or -1 for an unsupported C
// (or design, or stage).
extern "C" int d3ga_blend_coeffs(const void* coeffs, const void* colors, const void* opacs, int T,
                                 int K, int C, void* out, void* cuda_stream) {
  K8_ARGS;
#define FWD(CC) return launch_fwd<CC, CF_R, 2>(co, col, op, T, K, 1, (float*)out, s)
  CW_SWITCH_C(C, FWD)
#undef FWD
  return -1;
}

// The forward's design before (blend_coeffs_v1_kernel).
extern "C" int d3ga_blend_coeffs_v1(const void* coeffs, const void* colors, const void* opacs,
                                    int T, int K, int C, void* out, void* cuda_stream) {
  K8_ARGS;
  float* o = (float*)out;
#define FWD(CC) blend_coeffs_v1_kernel<CC><<<T, CW_NPIX, 0, s>>>(co, col, op, K, o)
  CW_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

// One (design, stage) of launch_fwd_stage; -1 where it is not built.
extern "C" int d3ga_blend_coeffs_stage(const void* coeffs, const void* colors, const void* opacs,
                                       int T, int K, int C, void* out, int design, int stage,
                                       void* cuda_stream) {
  K8_ARGS;
#define FWD(CC) return launch_fwd_stage<CC>(co, col, op, T, K, (float*)out, design, stage, s)
  CW_SWITCH_C(C, FWD)
#undef FWD
  return -1;
}

template <int C, int STAGE>
static int launch_bwd(const float* co, const float* col, const float* op, const float* g, int T,
                      int K, int cull, float* dco, float* dcol, float* dop, cudaStream_t s) {
  const int vec = (reinterpret_cast<uintptr_t>(co) & 15) == 0;
  const uintptr_t outs = reinterpret_cast<uintptr_t>(dco) | reinterpret_cast<uintptr_t>(dcol) |
                         reinterpret_cast<uintptr_t>(dop);
  const int ovec = K % 4 == 0 && (outs & 15) == 0;
  blend_coeffs_bwd_kernel<C, STAGE><<<T, cb_threads<CB_P>, 0, s>>>(co, col, op, g, K, vec, ovec,
                                                                  cull, dco, dcol, dop);
  return (int)cudaGetLastError();
}

// design 1: the kernel; 2: the kernel with the band cull off (stage 4, at
// every C); at K8_STAGE_C only, design 1 cut at coeff_walk_bwd.cuh's
// stages 0-3.
template <int C>
static int launch_bwd_stage(const float* co, const float* col, const float* op, const float* g,
                            int T, int K, float* dco, float* dcol, float* dop, int design,
                            int stage, cudaStream_t s) {
  if (stage == 4 && (design == 1 || design == 2))
    return launch_bwd<C, 4>(co, col, op, g, T, K, design == 1, dco, dcol, dop, s);
  if constexpr (C == K8_STAGE_C) {
    if (design == 1) {
      switch (stage) {
        case 0: return launch_bwd<C, 0>(co, col, op, g, T, K, 1, dco, dcol, dop, s);
        case 1: return launch_bwd<C, 1>(co, col, op, g, T, K, 1, dco, dcol, dop, s);
        case 2: return launch_bwd<C, 2>(co, col, op, g, T, K, 1, dco, dcol, dop, s);
        case 3: return launch_bwd<C, 3>(co, col, op, g, T, K, 1, dco, dcol, dop, s);
        default: break;
      }
    }
  }
  return -1;
}

#define K8_BWD_ARGS                  \
  K8_ARGS;                           \
  const float* gg = (const float*)g; \
  float* dco = (float*)dcoeffs;      \
  float* dcol = (float*)dcolors;     \
  float* dop = (float*)dopacs

extern "C" int d3ga_blend_coeffs_bwd(const void* coeffs, const void* colors, const void* opacs,
                                     const void* g, int T, int K, int C, void* dcoeffs,
                                     void* dcolors, void* dopacs, void* cuda_stream) {
  K8_BWD_ARGS;
#define BWD(CC) return launch_bwd<CC, 4>(co, col, op, gg, T, K, 1, dco, dcol, dop, s)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}

// The backward's design before (blend_coeffs_bwd_v1_kernel).
extern "C" int d3ga_blend_coeffs_bwd_v1(const void* coeffs, const void* colors, const void* opacs,
                                        const void* g, int T, int K, int C, void* dcoeffs,
                                        void* dcolors, void* dopacs, void* cuda_stream) {
  K8_BWD_ARGS;
#define BWD(CC) \
  blend_coeffs_bwd_v1_kernel<CC><<<T, CW_NPIX, 0, s>>>(co, col, op, gg, K, dco, dcol, dop)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return (int)cudaGetLastError();
}

// One (design, stage) of launch_bwd_stage; -1 where it is not built.
extern "C" int d3ga_blend_coeffs_bwd_stage(const void* coeffs, const void* colors,
                                           const void* opacs, const void* g, int T, int K, int C,
                                           void* dcoeffs, void* dcolors, void* dopacs, int design,
                                           int stage, void* cuda_stream) {
  K8_BWD_ARGS;
#define BWD(CC) \
  return launch_bwd_stage<CC>(co, col, op, gg, T, K, dco, dcol, dop, design, stage, s)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}
