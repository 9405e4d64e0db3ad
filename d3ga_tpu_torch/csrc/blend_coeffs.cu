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
// kernel computes in float32. The walk and its semantics are
// coeff_walk.cuh's.
//
// Bound on Hopper: operations where tiles are full. Each visited
// (pixel, slot) pair costs one exp and 15 + 2C FP32 operations forward,
// 35 + 4C backward (21 and 47 at C 3, as chip_smoke.py counts them); at
// the stage bench's shapes (T 2688, K 256, C 3) the inputs are 8.3 MB and
// the output 11 MB.
//
// Design: one block of 256 threads per tile, one thread per pixel
// (coeff_walk.cuh). Every tile owns its K slots, so the backward writes
// its rows of d(coeffs, colors, opacs) directly: no atomics, no second
// pass.

#include "coeff_walk.cuh"

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

template <int C>
__global__ void __launch_bounds__(CW_NPIX)
blend_coeffs_kernel(const float* __restrict__ coeffs, const float* __restrict__ colors,
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

template <int C>
__global__ void __launch_bounds__(CW_NPIX)
blend_coeffs_bwd_kernel(const float* __restrict__ coeffs, const float* __restrict__ colors,
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

// Each returns the cudaError_t of the launch, or -1 for an unsupported C.
extern "C" int d3ga_blend_coeffs(const void* coeffs, const void* colors, const void* opacs, int T,
                                 int K, int C, void* out, void* cuda_stream) {
  const float* co = (const float*)coeffs;
  const float* col = (const float*)colors;
  const float* op = (const float*)opacs;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define FWD(CC) blend_coeffs_kernel<CC><<<T, CW_NPIX, 0, s>>>(co, col, op, K, o)
  CW_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_coeffs_bwd(const void* coeffs, const void* colors, const void* opacs,
                                     const void* g, int T, int K, int C, void* dcoeffs,
                                     void* dcolors, void* dopacs, void* cuda_stream) {
  const float* co = (const float*)coeffs;
  const float* col = (const float*)colors;
  const float* op = (const float*)opacs;
  const float* gg = (const float*)g;
  float* dco = (float*)dcoeffs;
  float* dcol = (float*)dcolors;
  float* dop = (float*)dopacs;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define BWD(CC) \
  blend_coeffs_bwd_kernel<CC><<<T, CW_NPIX, 0, s>>>(co, col, op, gg, K, dco, dcol, dop)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return (int)cudaGetLastError();
}
