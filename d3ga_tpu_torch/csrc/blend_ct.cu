// K2: record gather fused into the front-to-back alpha blend, forward.
//
// Replaces the TPU kernel d3ga_tpu/raster/pallas_blend_ct.py::_run_forward_ct
// (_forward_body_ct, _blend_fwd_ct, _coeffs_ct) together with the record
// gather around it in pallas_segsum.py::blend_gather_segsum_ct's primal:
// the [T, CR, K] record tensor that the TPU path materializes (33 MB a
// frame at serving width) is never written; each block gathers its own
// tile's records through idx. The walk and its semantics are
// blend_walk.cuh's. Output is planar [(C+1), nty*16, ntx*16] with T_bg in
// the last plane.
//
// Bound on Hopper: operations. Each (pixel, record) pair visited costs
// one exp and about 25 FP32 operations; at serving width that is
// 256 * n_contrib pairs at most (fewer after early termination), against
// 19 MB of output and ~9 MB of inputs.
//
// Design: one block of 256 threads per 16x16 tile over the row-major grid,
// one thread per pixel (blend_walk.cuh). An empty tile writes zeros and
// T_bg = 1.

#include "blend_walk.cuh"

template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_ct_kernel(const float* __restrict__ rec, int n_ext, int CR,
                       const int* __restrict__ idx, int K,
                       const int* __restrict__ counts, int ntx, int nty,
                       float* __restrict__ out) {
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
}

// Returns the cudaError_t of the launch, or -1 for an unsupported C.
extern "C" int d3ga_blend_gather_ct(const void* rec, int n_ext, int CR, const void* idx, int K,
                                    const void* counts, int ntx, int nty, int C, void* out,
                                    void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define FWD(CC) \
  blend_gather_ct_kernel<CC><<<ntx * nty, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, ntx, nty, o)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}
