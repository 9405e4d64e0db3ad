// K3: recompute-forward VJP of the record-gather blend (K2): image
// cotangent -> per-slot record cotangents.
//
// Replaces the TPU kernel d3ga_tpu/raster/pallas_blend_ct.py::_run_backward_ct
// (_backward_body_ct, _blend_bwd_ct, _coeffs_transpose_ct). Like K2 it
// gathers each tile's records through idx, so the [T, CR, K] record
// tensor of the TPU path is never read; it writes drec [T, K, CR], one
// row per slot (zero in dead slots and past the tile's walk), for the id
// sort and the per-Gaussian combine (K4). The cotangent is the planar
// image's [(C+1), nty*16, ntx*16].
//
// Bound on Hopper: bytes. The bytes it must move, about 54.7 MB at the
// champion step (the live records and ids, 19 MB of cotangent, 33 MB of
// drec, dense), take 0.0163 ms. Each visited (pixel, record) pair is
// walked twice: a pair that is used (power <= 0, alpha >= 1/255) costs
// about 60 FP32 operations and 3 special-function results (an exp each
// walk, one division), one that is not only the polynomial and the tests,
// about 20 and 2 (an exp each walk). At the champion selection 4.17 M of
// the 27.04 M visited pairs are used: about 0.011 ms of FP32 work and
// 0.014 ms of SFU work. chip_smoke.py counts both from its run's data.
//
// Design: blend_walk_bwd.cuh's walk, two pixels a thread, one 16x16 tile
// a block of 128 threads; a warp skips the records its rows cannot take;
// per-record sums by a warp reduce-scatter and the four warps' partials
// in shared memory, in a fixed order (no atomics: two launches give the
// same bits); staged 16-byte row gathers and coalesced 16-byte stores.
// That header says why.
//
// The design before (blend_walk.cuh::blend_walk_bwd: one thread a pixel,
// 256 threads a tile, per-record warp butterflies) stays as the baseline
// entry point d3ga_blend_gather_ct_bwd_v1. d3ga_blend_gather_ct_bwd_stage
// launches one design whole (stage 4) at any C: 0 the baseline, 1 K3, 2
// K3 with the band cull off (the reference for the cull's bits); and,
// built at C = K3_STAGE_C (the champion's 6) only, so that the library
// holds 26 kernels and not a hundred, designs 0 and 1 cut at a stage (the
// walks' STAGE parameter: 0 staging and stores, 1 + walk 1, 2 + walk 2's
// per-pixel arithmetic, 3 + the per-record sums) and K3's walk at 1
// (design 3) or 4 (design 4) pixels a thread. No path of the port calls
// them: chip_smoke.py checks the cull and times the designs and their
// stages in turns.

#include <cstdint>

#include "blend_walk_bwd.cuh"

#define K3_STAGE_C 6  // the C the stage cuts and pixel variants are built for

// Thread t's pixels of tile (tx, ty) in the planar cotangent: their C
// colour cotangents and their T_bg cotangent.
template <int C, int P>
__device__ __forceinline__ void load_g(const float* __restrict__ g, int ntx, int nty, int tx,
                                       int ty, int t, float (&gc)[P][C], float (&g_tbg)[P]) {
  const long long wp = (long long)ntx * TILE;
  const long long plane = (long long)nty * TILE * wp;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = bw_pixel<P>(t, j);  // tile pixel dy * 16 + dx
    const long long pix = (long long)(ty * TILE + p / TILE) * wp + tx * TILE + p % TILE;
#pragma unroll
    for (int c = 0; c < C; ++c) gc[j][c] = g[c * plane + pix];
    g_tbg[j] = g[C * plane + pix];
  }
}

template <int C, int P = BW_P, int STAGE = 4>
__global__ void __launch_bounds__(bw_threads<P>)
blend_gather_ct_bwd_kernel(const float* __restrict__ rec, int n_ext, int CR, int vec, int cull,
                           const int* __restrict__ idx, int K, const int* __restrict__ counts,
                           int ntx, int nty, const float* __restrict__ g,
                           float* __restrict__ drec) {
  const int t = blockIdx.x;
  const int tx = t % ntx;
  const int ty = t / ntx;
  float gc[P][C], g_tbg[P];
  load_g<C, P>(g, ntx, nty, tx, ty, threadIdx.x, gc, g_tbg);
  blend_walk_bwd_px<C, P, STAGE>(rec, n_ext, CR, vec != 0, cull != 0, idx + (long long)t * K, K,
                                 min(max(counts[t], 0), K), (float)(tx * TILE),
                                 (float)(ty * TILE), gc, g_tbg, drec + (long long)t * K * CR);
}

// The baseline: the design before, one thread a pixel (blend_walk_bwd).
template <int C, int STAGE = 4>
__global__ void __launch_bounds__(NPIX)
blend_gather_ct_bwd_v1_kernel(const float* __restrict__ rec, int n_ext, int CR,
                              const int* __restrict__ idx, int K,
                              const int* __restrict__ counts, int ntx, int nty,
                              const float* __restrict__ g, float* __restrict__ drec) {
  const int t = blockIdx.x;
  const int tx = t % ntx;
  const int ty = t / ntx;
  const int p = threadIdx.x;
  const long long wp = (long long)ntx * TILE;
  const long long plane = (long long)nty * TILE * wp;
  const long long pix = (long long)(ty * TILE + p / TILE) * wp + tx * TILE + p % TILE;
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = g[c * plane + pix];
  blend_walk_bwd<C, STAGE>(rec, n_ext, CR, idx + (long long)t * K, K, min(max(counts[t], 0), K),
                           (float)(tx * TILE), (float)(ty * TILE), gc, g[C * plane + pix],
                           drec + (long long)t * K * CR);
}

template <int C, int P, int STAGE>
static int launch(int cull, const float* r, int n_ext, int CR, const int* i, int K, const int* c,
                  int ntx, int nty, const float* gg, float* o, cudaStream_t s) {
  const int vec = CR % 4 == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(o) & 15) == 0;
  const size_t smem = sizeof(float) * BW_CHUNK * CR;
  if (sizeof(BwShared<C, P>) + smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(blend_gather_ct_bwd_kernel<C, P, STAGE>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  blend_gather_ct_bwd_kernel<C, P, STAGE><<<ntx * nty, bw_threads<P>, smem, s>>>(
      r, n_ext, CR, vec, cull, i, K, c, ntx, nty, gg, o);
  return (int)cudaGetLastError();
}

template <int C, int STAGE>
static int launch_v1(const float* r, int n_ext, int CR, const int* i, int K, const int* c,
                     int ntx, int nty, const float* gg, float* o, cudaStream_t s) {
  blend_gather_ct_bwd_v1_kernel<C, STAGE><<<ntx * nty, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, ntx,
                                                                      nty, gg, o);
  return (int)cudaGetLastError();
}

#define K3_ARGS                                                                              \
  (const float*)rec, n_ext, CR, (const int*)idx, K, (const int*)counts, ntx, nty,            \
      (const float*)g, (float*)drec, (cudaStream_t)cuda_stream

// Each returns the cudaError_t of the launch, or -1 for an unsupported C
// (or design / stage).
extern "C" int d3ga_blend_gather_ct_bwd(const void* rec, int n_ext, int CR, const void* idx, int K,
                                        const void* counts, int ntx, int nty, int C,
                                        const void* g, void* drec, void* cuda_stream) {
#define BWD(CC) return launch<CC, BW_P, 4>(1, K3_ARGS)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}

extern "C" int d3ga_blend_gather_ct_bwd_v1(const void* rec, int n_ext, int CR, const void* idx,
                                           int K, const void* counts, int ntx, int nty, int C,
                                           const void* g, void* drec, void* cuda_stream) {
#define BWD(CC) return launch_v1<CC, 4>(K3_ARGS)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}

// design 0: the baseline; 1: K3; 2: K3 without the band cull; 3, 4: K3's
// walk at 1 or 4 pixels a thread. Stage 4 of designs 0-2 at every C (the
// kernels above); the rest at K3_STAGE_C only.
template <int C>
static int launch_stage(int design, int stage, const float* r, int n_ext, int CR, const int* i,
                        int K, const int* c, int ntx, int nty, const float* gg, float* o,
                        cudaStream_t s) {
#define ARGS r, n_ext, CR, i, K, c, ntx, nty, gg, o, s
  if (stage == 4) {
    if (design == 0) return launch_v1<C, 4>(ARGS);
    if (design == 1 || design == 2) return launch<C, BW_P, 4>(design == 1, ARGS);
  }
  if constexpr (C == K3_STAGE_C) {
    if (stage == 4 && design == 3) return launch<C, 1, 4>(1, ARGS);
    if (stage == 4 && design == 4) return launch<C, 4, 4>(1, ARGS);
#define STG(S)                                                      \
  if (stage == S && design == 0) return launch_v1<C, S>(ARGS);      \
  if (stage == S && design == 1) return launch<C, BW_P, S>(1, ARGS);
    STG(0)
    STG(1)
    STG(2)
    STG(3)
#undef STG
  }
#undef ARGS
  return -1;
}

extern "C" int d3ga_blend_gather_ct_bwd_stage(const void* rec, int n_ext, int CR, const void* idx,
                                              int K, const void* counts, int ntx, int nty, int C,
                                              const void* g, void* drec, int design, int stage,
                                              void* cuda_stream) {
#define BWD(CC) return launch_stage<CC>(design, stage, K3_ARGS)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}
