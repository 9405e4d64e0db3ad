// K5 and K7: record gather fused into the front-to-back alpha blend, in
// the record layouts, forward and backward.
//
// K5 (the sharded rasterizer's blend over a flat run of tiles) replaces
// the TPU kernels d3ga_tpu/raster/pallas_blend_rec.py::_run_forward and
// ::_run_backward (_forward_body / _blend_fwd, _backward_body /
// _blend_bwd, _coeffs_from_rec, _coeffs_transpose), reached through
// pallas_segsum.py::blend_gather_segsum_rec on the sharded path. K7 (the
// image-layout blend over the whole grid, rasterize_tiled(use_pallas=True)
// under D3GA_BLEND_LAYOUT=rec) replaces ::_run_forward_img and
// ::_run_backward_img (_forward_body_img / _backward_body_img) behind
// blend_image_rec. The TPU path gathers a [T, K, CR] record tensor first;
// here each block gathers its own tile's records through idx. The walks
// and their semantics are blend_walk.cuh's, shared with K2/K3; what
// differs is where a block's tile sits and what it reads and writes:
//   - K5: block t blends grid tile off + t of a row-major grid ntx tiles
//     wide (origin ((off + t) % ntx, (off + t) / ntx) * 16, _tile_origin),
//     so a shard blends its own contiguous slice of tiles; out and the
//     cotangent g are tile-major [T, 256, C+1] (pixel p = dy * 16 + dx,
//     T_bg last);
//   - K7: block t blends grid tile t; out and g are the padded image
//     [nty * 16, ntx * 16, C+1] (the C+1 values of a pixel adjacent, T_bg
//     last), so pixel p of tile t is image row (t / ntx) * 16 + p / 16,
//     column (t % ntx) * 16 + p % 16. The walk and its order are K2's, so
//     K7's image equals K2's planar image to the last bit.
// Slots past counts[t] hold the zero sentinel record in the TPU kernels'
// contract (opacity 0: alpha ~ 1e-12, never blended), so the walk stops
// at counts[t]; the TPU kernels' count-adaptive half width, tiles per
// program and image tile groups are tiling choices with no counterpart
// here.
//
// Bound on Hopper: operations, as for K2/K3. Forward ~25 FP32 operations
// and one exp per visited (pixel, record) pair; backward two walks, ~60
// operations and 2 exp per pair. Bytes: the gathered live records, idx,
// the output or cotangent (T * 256 * (C+1) floats) and, backward, drec
// [T, K, CR] (dense, zeros in dead slots).

#include "blend_walk.cuh"

template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_rec_kernel(const float* __restrict__ rec, int n_ext, int CR,
                        const int* __restrict__ idx, int K, const int* __restrict__ counts,
                        int off, int ntx, float* __restrict__ out) {
  const int t = blockIdx.x;
  const int tg = off + t;
  float acc[C];
  const float T = blend_walk_fwd<C>(rec, n_ext, CR, idx + (long long)t * K,
                                    min(max(counts[t], 0), K), (float)((tg % ntx) * TILE),
                                    (float)((tg / ntx) * TILE), acc);
  float* o = out + ((long long)t * NPIX + threadIdx.x) * (C + 1);
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = acc[c];
  o[C] = T;
}

template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_rec_bwd_kernel(const float* __restrict__ rec, int n_ext, int CR,
                            const int* __restrict__ idx, int K,
                            const int* __restrict__ counts, int off, int ntx,
                            const float* __restrict__ g, float* __restrict__ drec) {
  const int t = blockIdx.x;
  const int tg = off + t;
  const float* gp = g + ((long long)t * NPIX + threadIdx.x) * (C + 1);
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = gp[c];
  blend_walk_bwd<C>(rec, n_ext, CR, idx + (long long)t * K, K, min(max(counts[t], 0), K),
                    (float)((tg % ntx) * TILE), (float)((tg / ntx) * TILE), gc, gp[C],
                    drec + (long long)t * K * CR);
}

template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_img_kernel(const float* __restrict__ rec, int n_ext, int CR,
                        const int* __restrict__ idx, int K, const int* __restrict__ counts,
                        int ntx, float* __restrict__ out) {
  const int t = blockIdx.x;
  const int tx = t % ntx, ty = t / ntx;
  float acc[C];
  const float T = blend_walk_fwd<C>(rec, n_ext, CR, idx + (long long)t * K,
                                    min(max(counts[t], 0), K), (float)(tx * TILE),
                                    (float)(ty * TILE), acc);
  const long long row = (long long)ty * TILE + threadIdx.x / TILE;
  const long long col = (long long)tx * TILE + threadIdx.x % TILE;
  float* o = out + (row * ntx * TILE + col) * (C + 1);
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = acc[c];
  o[C] = T;
}

template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_img_bwd_kernel(const float* __restrict__ rec, int n_ext, int CR,
                            const int* __restrict__ idx, int K,
                            const int* __restrict__ counts, int ntx,
                            const float* __restrict__ g, float* __restrict__ drec) {
  const int t = blockIdx.x;
  const int tx = t % ntx, ty = t / ntx;
  const long long row = (long long)ty * TILE + threadIdx.x / TILE;
  const long long col = (long long)tx * TILE + threadIdx.x % TILE;
  const float* gp = g + (row * ntx * TILE + col) * (C + 1);
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = gp[c];
  blend_walk_bwd<C>(rec, n_ext, CR, idx + (long long)t * K, K, min(max(counts[t], 0), K),
                    (float)(tx * TILE), (float)(ty * TILE), gc, gp[C],
                    drec + (long long)t * K * CR);
}

// Each returns the cudaError_t of the launch, or -1 for an unsupported C.
extern "C" int d3ga_blend_gather_rec(const void* rec, int n_ext, int CR, const void* idx, int T,
                                     int K, const void* counts, int tile_offset, int ntx, int C,
                                     void* out, void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define FWD(CC) \
  blend_gather_rec_kernel<CC><<<T, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, tile_offset, ntx, o)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_gather_rec_bwd(const void* rec, int n_ext, int CR, const void* idx,
                                         int T, int K, const void* counts, int tile_offset,
                                         int ntx, int C, const void* g, void* drec,
                                         void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  const float* gg = (const float*)g;
  float* o = (float*)drec;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define BWD(CC) \
  blend_gather_rec_bwd_kernel<CC><<<T, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, tile_offset, ntx, gg, o)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_gather_img(const void* rec, int n_ext, int CR, const void* idx, int T,
                                     int K, const void* counts, int ntx, int C, void* out,
                                     void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  float* o = (float*)out;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define FWD(CC) blend_gather_img_kernel<CC><<<T, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, ntx, o)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_gather_img_bwd(const void* rec, int n_ext, int CR, const void* idx,
                                         int T, int K, const void* counts, int ntx, int C,
                                         const void* g, void* drec, void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  const float* gg = (const float*)g;
  float* o = (float*)drec;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define BWD(CC) \
  blend_gather_img_bwd_kernel<CC><<<T, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, ntx, gg, o)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return (int)cudaGetLastError();
}
