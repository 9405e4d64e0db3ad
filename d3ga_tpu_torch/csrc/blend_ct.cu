// K2: record gather fused into the front-to-back alpha blend, forward.
//
// Replaces the TPU kernel d3ga_tpu/raster/pallas_blend_ct.py::_run_forward_ct
// (_forward_body_ct, _blend_fwd_ct, _coeffs_ct) together with the record
// gather around it in pallas_segsum.py::blend_gather_segsum_ct's primal:
// the [T, CR, K] record tensor that the TPU path materializes (33 MB a
// frame at serving width) is never written; each block gathers its own
// tile's records through idx. Output is planar [(C+1), nty*16, ntx*16]
// with T_bg in the last plane.
//
// Bound on Hopper: operations and bytes alike. A visited (pixel, record)
// pair that is used (power <= 0, alpha >= 1/255) costs one exp and about
// 25 FP32 operations, one that is not only the polynomial, its test and
// the exp, about 10: at the champion selection's 4.17 M used of 27.04 M
// visited pairs, 0.00647 ms of exps (0.0050 of FP32 work). It must read
// the live records and ids and write the image, 21.6 MB (19.3 MB of
// image, 15.8 MB of it the empty tiles' zeros and ones): 0.00646 ms at
// 3.35 TB/s. chip_smoke.py counts both from its run's data.
//
// Design: blend_walk_fwd.cuh's walk, two pixels a thread, one 16x16 tile
// a block of 128 threads; a warp skips the records its rows cannot take
// and walks the rest in batches of FW_R records, their polynomials and
// exps computed ahead of the transmittance chain; the planes go out in
// coalesced 16-byte stores. That header says why. Its image equals the
// design before's to the bit.
//
// The design before (blend_walk.cuh::blend_walk_fwd: one thread a pixel,
// 256 threads a tile) stays as the baseline entry point
// d3ga_blend_gather_ct_v1, the bit reference (K5's and K7's forward
// baselines walk with it too). d3ga_blend_gather_ct_stage launches, at
// K2_STAGE_C (the champion's 6) only, so that the library holds 23
// kernels and not a hundred: the kernel cut at a stage (the walk's STAGE
// parameter: 0 staging and stores, 1 + the batches' polynomials and
// exps), its walk at 1, 2 or 4 records a batch, and a diagnostic build of
// either design that writes each block's SM and its clock64 at start and
// end. No path of the port calls them: chip_smoke.py times the designs
// and their stages in turns and reads the SMs' load.

#include <cstdint>

#include "blend_walk_fwd.cuh"

#define K2_STAGE_C 6  // the C the stage cuts and the other designs are built for

// Block b's SM and its clock64 at start (t0) and end, into diag[3b ..
// 3b + 2], once every thread of the block is done.
__device__ __forceinline__ void write_diag(long long* __restrict__ diag, long long t0) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned smid;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(smid));
    long long* d = diag + 3LL * blockIdx.x;
    d[0] = smid;
    d[1] = t0;
    d[2] = clock64();
  }
}

template <int C, int R = FW_R, int STAGE = 2, bool DIAG = false>
__global__ void __launch_bounds__(bw_threads<BW_P>)
blend_gather_ct_kernel(const float* __restrict__ rec, int n_ext, int CR, int vec,
                       const int* __restrict__ idx, int K, const int* __restrict__ counts,
                       int ntx, int nty, float* __restrict__ out, long long* __restrict__ diag) {
  const long long t0 = DIAG ? clock64() : 0;
  __shared__ FwShared<BW_P> s;
  const int t = blockIdx.x;
  const int tx = t % ntx;
  const int ty = t / ntx;
  float acc[BW_P][C], T[BW_P];
  blend_walk_fwd_px<C, BW_P, R, STAGE>(rec, n_ext, CR, vec != 0, idx + (long long)t * K,
                                       min(max(counts[t], 0), K), (float)(tx * TILE),
                                       (float)(ty * TILE), s, acc, T);
  fw_store<C, BW_P>(s, acc, T, out, ntx, nty, tx, ty);
  if constexpr (DIAG) write_diag(diag, t0);
}

// The baseline: the design before, one thread a pixel (blend_walk_fwd).
template <int C, bool DIAG = false>
__global__ void __launch_bounds__(NPIX)
blend_gather_ct_v1_kernel(const float* __restrict__ rec, int n_ext, int CR,
                          const int* __restrict__ idx, int K, const int* __restrict__ counts,
                          int ntx, int nty, float* __restrict__ out, long long* __restrict__ diag) {
  const long long t0 = DIAG ? clock64() : 0;
  const int t = blockIdx.x;
  const int tx = t % ntx;
  const int ty = t / ntx;
  const int p = threadIdx.x;
  float acc[C];
  const float T = blend_walk_fwd<C>(rec, n_ext, CR, idx + (long long)t * K,
                                    min(max(counts[t], 0), K), (float)(tx * TILE),
                                    (float)(ty * TILE), acc);
  const long long wp = (long long)ntx * TILE;
  const long long plane = (long long)nty * TILE * wp;
  const long long pix = (long long)(ty * TILE + p / TILE) * wp + tx * TILE + p % TILE;
#pragma unroll
  for (int c = 0; c < C; ++c) out[c * plane + pix] = acc[c];
  out[C * plane + pix] = T;
  if constexpr (DIAG) write_diag(diag, t0);
}

template <int C, int R, int STAGE, bool DIAG>
static int launch(const float* r, int n_ext, int CR, const int* i, int K, const int* c, int ntx,
                  int nty, float* o, long long* d, cudaStream_t s) {
  if ((reinterpret_cast<uintptr_t>(o) & 15) != 0) return (int)cudaErrorMisalignedAddress;
  const int vec = CR % 4 == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0;
  blend_gather_ct_kernel<C, R, STAGE, DIAG><<<ntx * nty, bw_threads<BW_P>, 0, s>>>(
      r, n_ext, CR, vec, i, K, c, ntx, nty, o, d);
  return (int)cudaGetLastError();
}

template <int C, bool DIAG>
static int launch_v1(const float* r, int n_ext, int CR, const int* i, int K, const int* c,
                     int ntx, int nty, float* o, long long* d, cudaStream_t s) {
  blend_gather_ct_v1_kernel<C, DIAG><<<ntx * nty, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, ntx, nty,
                                                                 o, d);
  return (int)cudaGetLastError();
}

#define K2_ARGS                                                                              \
  (const float*)rec, n_ext, CR, (const int*)idx, K, (const int*)counts, ntx, nty, (float*)out

// Each returns the cudaError_t of the launch, or -1 for an unsupported C
// (or design / stage).
extern "C" int d3ga_blend_gather_ct(const void* rec, int n_ext, int CR, const void* idx, int K,
                                    const void* counts, int ntx, int nty, int C, void* out,
                                    void* cuda_stream) {
#define FWD(CC) return launch<CC, FW_R, 2, false>(K2_ARGS, nullptr, (cudaStream_t)cuda_stream)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return -1;
}

extern "C" int d3ga_blend_gather_ct_v1(const void* rec, int n_ext, int CR, const void* idx, int K,
                                       const void* counts, int ntx, int nty, int C, void* out,
                                       void* cuda_stream) {
#define FWD(CC) return launch_v1<CC, false>(K2_ARGS, nullptr, (cudaStream_t)cuda_stream)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return -1;
}

// At C = K2_STAGE_C only. design 0: the baseline; 1: the kernel (stage 0
// staging and stores, 1 + the batches' polynomials and exps, 2 whole);
// 2, 3, 4: its walk at 1, 2 or 4 records a batch; 5, 6: the baseline and
// the kernel writing diag [T, 3] (SM, clock64 at start and end); designs
// other than 1 at stage 2 only.
extern "C" int d3ga_blend_gather_ct_stage(const void* rec, int n_ext, int CR, const void* idx,
                                          int K, const void* counts, int ntx, int nty, int C,
                                          void* out, int design, int stage, void* diag,
                                          void* cuda_stream) {
  if (C != K2_STAGE_C) return -1;
  constexpr int CC = K2_STAGE_C;
  long long* d = (long long*)diag;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  if (design == 1 && stage == 0) return launch<CC, FW_R, 0, false>(K2_ARGS, d, s);
  if (design == 1 && stage == 1) return launch<CC, FW_R, 1, false>(K2_ARGS, d, s);
  if (stage != 2) return -1;
  switch (design) {
    case 0: return launch_v1<CC, false>(K2_ARGS, d, s);
    case 1: return launch<CC, FW_R, 2, false>(K2_ARGS, d, s);
    case 2: return launch<CC, 1, 2, false>(K2_ARGS, d, s);
    case 3: return launch<CC, 2, 2, false>(K2_ARGS, d, s);
    case 4: return launch<CC, 4, 2, false>(K2_ARGS, d, s);
    case 5: return launch_v1<CC, true>(K2_ARGS, d, s);
    case 6: return launch<CC, FW_R, 2, true>(K2_ARGS, d, s);
    default: return -1;
  }
}
