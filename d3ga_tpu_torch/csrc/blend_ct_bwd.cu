// K3: recompute-forward VJP of the record-gather blend (K2): image
// cotangent -> per-slot record cotangents.
//
// Replaces the TPU kernel d3ga_tpu/raster/pallas_blend_ct.py::_run_backward_ct
// (_backward_body_ct, _blend_bwd_ct, _coeffs_transpose_ct). Like K2 it
// gathers each tile's records through idx, so the [T, CR, K] record
// tensor of the TPU path is never read; it writes drec [T, K, CR], one
// row per slot, for the id sort and the per-Gaussian combine (K4). The
// walks and their semantics are blend_walk.cuh's; the cotangent is the
// planar image's [(C+1), nty*16, ntx*16].
//
// Bound on Hopper: operations. Each visited (pixel, record) pair is
// walked twice (the forward recompute, then the cotangents): about 60
// FP32 operations and 2 exp at the serving width's ~27 M pairs, against
// 19 MB of cotangent read and 33 MB of drec written (dense, zeros in
// dead slots).
//
// Design: one block of 256 threads per tile, one thread per pixel, two
// front-to-back walks and per-record sums without atomics
// (blend_walk.cuh).

#include "blend_walk.cuh"

template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_ct_bwd_kernel(const float* __restrict__ rec, int n_ext, int CR,
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
  blend_walk_bwd<C>(rec, n_ext, CR, idx + (long long)t * K, K, min(max(counts[t], 0), K),
                    (float)(tx * TILE), (float)(ty * TILE), gc, g[C * plane + pix],
                    drec + (long long)t * K * CR);
}

// Returns the cudaError_t of the launch, or -1 for an unsupported C.
extern "C" int d3ga_blend_gather_ct_bwd(const void* rec, int n_ext, int CR, const void* idx, int K,
                                        const void* counts, int ntx, int nty, int C,
                                        const void* g, void* drec, void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  const float* gg = (const float*)g;
  float* o = (float*)drec;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define BWD(CC) \
  blend_gather_ct_bwd_kernel<CC><<<ntx * nty, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, ntx, nty, gg, o)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return (int)cudaGetLastError();
}
