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
// here each block gathers its own tile's records through idx. The
// forwards walk with blend_walk_fwd.cuh::blend_walk_fwd_px, K2's walk:
// two pixels a thread, 128 threads a tile, the band cull, per-warp lists
// of the records each warp takes walked in batches of FW_R; the
// backwards with blend_walk_bwd.cuh::blend_walk_bwd_px, K3's walk: the
// same two pixels a thread and cull, per-record sums by a warp
// reduce-scatter, staged rows and 16-byte drec stores (those headers say
// why). The semantics are K2/K3's; what differs is where a block's tile
// sits and what it reads and writes:
//   - K5: block t blends grid tile off + t of a row-major grid ntx tiles
//     wide (origin ((off + t) % ntx, (off + t) / ntx) * 16, _tile_origin),
//     so a shard blends its own contiguous slice of tiles; out and the
//     cotangent g are tile-major [T, 256, C+1] (pixel p = dy * 16 + dx,
//     T_bg last);
//   - K7: block t blends grid tile t; out and g are the padded image
//     [nty * 16, ntx * 16, C+1] (the C+1 values of a pixel adjacent, T_bg
//     last), so pixel p of tile t is image row (t / ntx) * 16 + p / 16,
//     column (t % ntx) * 16 + p % 16.
// Slots past counts[t] hold the zero sentinel record in the TPU kernels'
// contract (opacity 0: alpha ~ 1e-12, never blended), so the walk stops
// at counts[t]; the TPU kernels' count-adaptive half width, tiles per
// program and image tile groups are tiling choices with no counterpart
// here.
//
// Bound on Hopper, as for K2/K3: forward ~25 FP32 operations and one exp
// per used (pixel, record) pair, the polynomial, its test and the exp
// per unused one; backward two walks, ~60 operations and 3
// special-function results per used pair (chip_smoke.py's blend_bound
// counts used and unused pairs apart). Bytes: the gathered live records,
// idx, the output or cotangent (T * 256 * (C+1) floats) and, backward,
// drec [T, K, CR] (dense, zeros in dead slots). At the champion
// selection the forward's exps bound it (0.00647 ms, its bytes 0.00646),
// the backward's bytes (0.0163 ms).
//
// The forwards: the walk is K2's to the last bit (given the same records,
// ids, counts and tile origin, K5's and K7's values equal K2's image of
// the same tiles); only the stores differ. After the walk each block
// stages its tile's [256, C+1] values pixel-major over the walk's shared
// rows and writes the tile's 16 rows of 16 (C + 1) contiguous floats as
// 16-byte stores (fw_store_rows), 28 a row at C 6: one thread a pixel
// storing its own 7 floats at a 28-byte stride spans 896 bytes a warp
// store to write 128. The launch is K2's: 128 threads, the walk's static
// shared memory, the vec flag, a misaligned output refused.
//
// The backwards: the walk is K3's to the last bit (given the same
// records, ids, counts and cotangent values, K5's and K7's drec equal
// K3's rows of the same tiles); only the cotangent load differs. Each
// thread loads its own two pixels' C + 1 values (bw_pixel's rows) once,
// before the walk: 28 bytes a pixel at C 6, 7 KB a tile against the 12
// KB of drec rows the tile stores at CR 12; at the champion selection the
// backward takes what K3 takes, so staging the load gains nothing.
//
// The designs before (one thread a pixel, 256 threads a tile,
// blend_walk.cuh::blend_walk_fwd / blend_walk_bwd, each thread storing or
// loading its own pixel's values) stay as the baseline entry points
// d3ga_blend_gather_rec_v1, d3ga_blend_gather_img_v1,
// d3ga_blend_gather_rec_bwd_v1 and d3ga_blend_gather_img_bwd_v1, which no
// path of the port calls: chip_smoke.py holds the kernels to them and
// times them in turns.

#include <cstdint>

#include "blend_walk_fwd.cuh"

// K5's forward: block t blends grid tile off + t into the tile-major
// block out[t] ([256, C+1], contiguous).
template <int C>
__global__ void __launch_bounds__(bw_threads<BW_P>)
blend_gather_rec_kernel(const float* __restrict__ rec, int n_ext, int CR, int vec,
                        const int* __restrict__ idx, int K, const int* __restrict__ counts,
                        int off, int ntx, float* __restrict__ out) {
  __shared__ FwShared<BW_P> s;
  const int t = blockIdx.x;
  const int tg = off + t;
  float acc[BW_P][C], T[BW_P];
  blend_walk_fwd_px<C, BW_P, FW_R>(rec, n_ext, CR, vec != 0, idx + (long long)t * K,
                                   min(max(counts[t], 0), K), (float)((tg % ntx) * TILE),
                                   (float)((tg / ntx) * TILE), s, acc, T);
  fw_store_rows<C, BW_P>(s, acc, T, out + (long long)t * NPIX * (C + 1), TILE * (C + 1));
}

// K5's forward before (the baseline): one thread a pixel.
template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_rec_v1_kernel(const float* __restrict__ rec, int n_ext, int CR,
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

// K5's backward before (the baseline): one thread a pixel.
template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_rec_bwd_v1_kernel(const float* __restrict__ rec, int n_ext, int CR,
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

// K7's forward: block t blends grid tile t into the padded image out,
// its 16 rows ntx * 16 * (C + 1) floats apart.
template <int C>
__global__ void __launch_bounds__(bw_threads<BW_P>)
blend_gather_img_kernel(const float* __restrict__ rec, int n_ext, int CR, int vec,
                        const int* __restrict__ idx, int K, const int* __restrict__ counts,
                        int ntx, float* __restrict__ out) {
  __shared__ FwShared<BW_P> s;
  const int t = blockIdx.x;
  const int tx = t % ntx, ty = t / ntx;
  float acc[BW_P][C], T[BW_P];
  blend_walk_fwd_px<C, BW_P, FW_R>(rec, n_ext, CR, vec != 0, idx + (long long)t * K,
                                   min(max(counts[t], 0), K), (float)(tx * TILE),
                                   (float)(ty * TILE), s, acc, T);
  const long long pitch = (long long)ntx * TILE * (C + 1);
  fw_store_rows<C, BW_P>(s, acc, T, out + ty * TILE * pitch + (long long)tx * TILE * (C + 1),
                         pitch);
}

// K7's forward before (the baseline): one thread a pixel.
template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_img_v1_kernel(const float* __restrict__ rec, int n_ext, int CR,
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

// K7's backward before (the baseline): one thread a pixel.
template <int C>
__global__ void __launch_bounds__(NPIX)
blend_gather_img_bwd_v1_kernel(const float* __restrict__ rec, int n_ext, int CR,
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

// K5's backward: block t walks grid tile off + t, its cotangent the
// tile-major block g[t] ([256, C+1], pixel p at row p).
template <int C>
__global__ void __launch_bounds__(bw_threads<BW_P>)
blend_gather_rec_bwd_kernel(const float* __restrict__ rec, int n_ext, int CR, int vec,
                            const int* __restrict__ idx, int K,
                            const int* __restrict__ counts, int off, int ntx,
                            const float* __restrict__ g, float* __restrict__ drec) {
  const int t = blockIdx.x;
  const int tg = off + t;
  const float* gt = g + (long long)t * NPIX * (C + 1);
  float gc[BW_P][C], g_tbg[BW_P];
#pragma unroll
  for (int j = 0; j < BW_P; ++j) {
    const float* gp = gt + bw_pixel<BW_P>(threadIdx.x, j) * (C + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) gc[j][c] = gp[c];
    g_tbg[j] = gp[C];
  }
  blend_walk_bwd_px<C, BW_P>(rec, n_ext, CR, vec != 0, true, idx + (long long)t * K, K,
                             min(max(counts[t], 0), K), (float)((tg % ntx) * TILE),
                             (float)((tg / ntx) * TILE), gc, g_tbg,
                             drec + (long long)t * K * CR);
}

// K7's backward: block t walks grid tile t, its cotangent the padded
// image g [nty * 16, ntx * 16, C+1].
template <int C>
__global__ void __launch_bounds__(bw_threads<BW_P>)
blend_gather_img_bwd_kernel(const float* __restrict__ rec, int n_ext, int CR, int vec,
                            const int* __restrict__ idx, int K,
                            const int* __restrict__ counts, int ntx,
                            const float* __restrict__ g, float* __restrict__ drec) {
  const int t = blockIdx.x;
  const int tx = t % ntx, ty = t / ntx;
  float gc[BW_P][C], g_tbg[BW_P];
#pragma unroll
  for (int j = 0; j < BW_P; ++j) {
    const int p = bw_pixel<BW_P>(threadIdx.x, j);
    const long long row = (long long)ty * TILE + p / TILE;
    const long long col = (long long)tx * TILE + p % TILE;
    const float* gp = g + (row * ntx * TILE + col) * (C + 1);
#pragma unroll
    for (int c = 0; c < C; ++c) gc[j][c] = gp[c];
    g_tbg[j] = gp[C];
  }
  blend_walk_bwd_px<C, BW_P>(rec, n_ext, CR, vec != 0, true, idx + (long long)t * K, K,
                             min(max(counts[t], 0), K), (float)(tx * TILE), (float)(ty * TILE),
                             gc, g_tbg, drec + (long long)t * K * CR);
}

// The backwards' launch, as blend_ct_bwd.cu's: 16-byte row loads and
// stores where CR % 4 == 0 and rec and drec are aligned (vec), and the
// walk's BW_CHUNK x CR floats of dynamic shared memory, allowed past
// 48 KB where the walk's static shared memory and it need more.
template <int C, class Kern>
static int walk_launch_setup(Kern kern, int CR, const float* r, const float* o, int* vec,
                             size_t* smem) {
  *vec = CR % 4 == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0 &&
         (reinterpret_cast<uintptr_t>(o) & 15) == 0;
  *smem = sizeof(float) * BW_CHUNK * CR;
  if (sizeof(BwShared<C, BW_P>) + *smem > 48 * 1024)
    return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)*smem);
  return 0;
}

template <int C>
static int launch_rec_bwd(const float* r, int n_ext, int CR, const int* i, int T, int K,
                          const int* c, int off, int ntx, const float* gg, float* o,
                          cudaStream_t s) {
  int vec;
  size_t smem;
  const int e = walk_launch_setup<C>(blend_gather_rec_bwd_kernel<C>, CR, r, o, &vec, &smem);
  if (e != 0) return e;
  blend_gather_rec_bwd_kernel<C><<<T, bw_threads<BW_P>, smem, s>>>(r, n_ext, CR, vec, i, K, c,
                                                                   off, ntx, gg, o);
  return (int)cudaGetLastError();
}

template <int C>
static int launch_img_bwd(const float* r, int n_ext, int CR, const int* i, int T, int K,
                          const int* c, int ntx, const float* gg, float* o, cudaStream_t s) {
  int vec;
  size_t smem;
  const int e = walk_launch_setup<C>(blend_gather_img_bwd_kernel<C>, CR, r, o, &vec, &smem);
  if (e != 0) return e;
  blend_gather_img_bwd_kernel<C><<<T, bw_threads<BW_P>, smem, s>>>(r, n_ext, CR, vec, i, K, c,
                                                                   ntx, gg, o);
  return (int)cudaGetLastError();
}

// The forwards' vec flag, as K2's launch computes it (16-byte row loads
// where CR % 4 == 0 and rec is aligned); -1 where out is not 16-byte
// aligned (the kernels' rows go out as 16-byte stores).
static int fwd_vec(const float* r, int CR, const float* o) {
  if ((reinterpret_cast<uintptr_t>(o) & 15) != 0) return -1;
  return CR % 4 == 0 && (reinterpret_cast<uintptr_t>(r) & 15) == 0;
}

#define REC_ARGS                                                                         \
  const float* r = (const float*)rec;                                                    \
  const int* i = (const int*)idx;                                                        \
  const int* c = (const int*)counts;                                                     \
  float* o = (float*)out;                                                                \
  cudaStream_t s = (cudaStream_t)cuda_stream

// Each returns the cudaError_t of the launch, or -1 for an unsupported C.
extern "C" int d3ga_blend_gather_rec(const void* rec, int n_ext, int CR, const void* idx, int T,
                                     int K, const void* counts, int tile_offset, int ntx, int C,
                                     void* out, void* cuda_stream) {
  REC_ARGS;
  const int vec = fwd_vec(r, CR, o);
  if (vec < 0) return (int)cudaErrorMisalignedAddress;
#define FWD(CC)                                                                        \
  blend_gather_rec_kernel<CC><<<T, bw_threads<BW_P>, 0, s>>>(r, n_ext, CR, vec, i, K, c, \
                                                              tile_offset, ntx, o)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_gather_rec_v1(const void* rec, int n_ext, int CR, const void* idx,
                                        int T, int K, const void* counts, int tile_offset,
                                        int ntx, int C, void* out, void* cuda_stream) {
  REC_ARGS;
#define FWD(CC) \
  blend_gather_rec_v1_kernel<CC><<<T, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, tile_offset, ntx, o)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_gather_rec_bwd(const void* rec, int n_ext, int CR, const void* idx,
                                         int T, int K, const void* counts, int tile_offset,
                                         int ntx, int C, const void* g, void* drec,
                                         void* cuda_stream) {
#define BWD(CC)                                                                        \
  return launch_rec_bwd<CC>((const float*)rec, n_ext, CR, (const int*)idx, T, K,       \
                            (const int*)counts, tile_offset, ntx, (const float*)g,     \
                            (float*)drec, (cudaStream_t)cuda_stream)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}

extern "C" int d3ga_blend_gather_rec_bwd_v1(const void* rec, int n_ext, int CR, const void* idx,
                                            int T, int K, const void* counts, int tile_offset,
                                            int ntx, int C, const void* g, void* drec,
                                            void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  const float* gg = (const float*)g;
  float* o = (float*)drec;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define BWD(CC)                                                                              \
  blend_gather_rec_bwd_v1_kernel<CC><<<T, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, tile_offset, \
                                                         ntx, gg, o)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_gather_img(const void* rec, int n_ext, int CR, const void* idx, int T,
                                     int K, const void* counts, int ntx, int C, void* out,
                                     void* cuda_stream) {
  REC_ARGS;
  const int vec = fwd_vec(r, CR, o);
  if (vec < 0) return (int)cudaErrorMisalignedAddress;
#define FWD(CC)                                                                        \
  blend_gather_img_kernel<CC><<<T, bw_threads<BW_P>, 0, s>>>(r, n_ext, CR, vec, i, K, c, \
                                                              ntx, o)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_gather_img_v1(const void* rec, int n_ext, int CR, const void* idx,
                                        int T, int K, const void* counts, int ntx, int C,
                                        void* out, void* cuda_stream) {
  REC_ARGS;
#define FWD(CC) blend_gather_img_v1_kernel<CC><<<T, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, ntx, o)
  D3GA_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

extern "C" int d3ga_blend_gather_img_bwd(const void* rec, int n_ext, int CR, const void* idx,
                                         int T, int K, const void* counts, int ntx, int C,
                                         const void* g, void* drec, void* cuda_stream) {
#define BWD(CC)                                                                        \
  return launch_img_bwd<CC>((const float*)rec, n_ext, CR, (const int*)idx, T, K,       \
                            (const int*)counts, ntx, (const float*)g, (float*)drec,    \
                            (cudaStream_t)cuda_stream)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return -1;
}

extern "C" int d3ga_blend_gather_img_bwd_v1(const void* rec, int n_ext, int CR, const void* idx,
                                            int T, int K, const void* counts, int ntx, int C,
                                            const void* g, void* drec, void* cuda_stream) {
  const float* r = (const float*)rec;
  const int* i = (const int*)idx;
  const int* c = (const int*)counts;
  const float* gg = (const float*)g;
  float* o = (float*)drec;
  cudaStream_t s = (cudaStream_t)cuda_stream;
#define BWD(CC) \
  blend_gather_img_bwd_v1_kernel<CC><<<T, NPIX, 0, s>>>(r, n_ext, CR, i, K, c, ntx, gg, o)
  D3GA_SWITCH_C(C, BWD)
#undef BWD
  return (int)cudaGetLastError();
}
