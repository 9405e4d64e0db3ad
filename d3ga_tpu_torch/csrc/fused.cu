// K9: fused per-tile selection + compaction + alpha blend over 8x8-tile
// blocks of candidates, forward and backward.
//
// Replaces the TPU kernels d3ga_tpu/raster/attic/pallas_fused.py::
// _run_forward / _run_backward (v1: banded one-hot matmul compaction) and
// attic/pallas_fused2.py::_run_forward / _run_backward (v2: butterfly
// lane-roll compaction). Both compute one function and differ only in how
// a TPU moves lanes, so one forward and one backward kernel serve both;
// the wrappers hand either layout over as records-major vals [NB, kb, 16]
// (the layout the fused raster builds): candidate j of block b is the 16
// floats at (b * kb + j) * 16, channels (x, y in block-local pixels,
// conic A, B, C, opacity, C colours, padding). rects [NB, kb] int32 pack
// each candidate's block-local tile rect (xmin | xmax << 8 | ymin << 16 |
// ymax << 24; 0 never overlaps).
//
// Per tile (tx, ty) of block b: the candidates whose rect holds the tile,
// in lane (depth-rank) order, the first K of them compacted; the tile's
// count is the uncapped number. Each compacted record becomes the six
// falloff coefficients in tile-local pixels (x - 16 tx, y - 16 ty; the
// JAX kernels' _coeffs_from_rec), then coeff_walk.cuh's walk. Output
// tiles [NB, 64, 256, C+1] (T_bg last), counts [NB, 64]. The backward
// returns d(vals) [NB, kb, 16]; the padding channels and the candidates no
// tile selected get 0.
//
// Bound on Hopper: operations where tiles are full (the walk's pairs: one
// exp and 15 + 2C FP32 operations forward, 35 + 4C backward, as
// chip_smoke.py counts them); the selection reads each block's kb rects
// once per tile (64 x 16 KB at kb 4096, from L2). Bytes at the full-width
// scene (48 blocks, kb 4096, C 6): the 6 + C used channels of the selected
// candidates (at most 9.4 MB) and 0.8 MB rects in, 22 MB tiles out; the
// backward adds up to 22 MB of cotangent in and 12.6 MB of d(vals) out.
//
// Design. The TPU grid is one program per block (48 at full width); here
// one CUDA block of 256 threads per tile (3,072), one thread per pixel.
//   Forward: the block scans its 8x8 block's kb rects 256 at a time; a
//   warp ballot and the per-warp popcounts give each overlapping
//   candidate its position, and the first K lane ids go to shared memory
//   (K ints). The walk stages its chunks through those ids straight from
//   vals: the [K, 16] compacted record block of the TPU kernels is never
//   written.
//   Backward, kernel 1 (per tile): the same selection, the two walks, and
//   per slot the cotangents of (x, y, A, B, C, opacity, colours), the
//   coefficients' transpose applied in the tile's own coordinates; it
//   writes them [NB * 64, K, 6 + C] with the slot's lane id and the
//   tile's live-slot count (scratch the wrapper allocates).
//   Backward, kernel 2 (per block and lane): the 64 tiles of a block share
//   its candidate lanes. One thread per (block, lane) visits the tiles its
//   rect covers in tile order, finds its slot by binary search in each
//   tile's ascending lane list, and sums the slot rows: deterministic, no
//   atomics, the TPU kernels' order (tile 0 to 63).
//
// Stage cuts (probe P3, the counterpart of the TPU bisect
// tools/fused_bisect.py): fused_kernel's STAGE parameter stops the forward
// early, so each cut runs K9's own code up to its point. STAGE 0 writes
// 1.0 to every output; 1 runs the selection and writes the tile's count to
// every pixel and channel; 2 also sums channels [0, C] of the first
// min(count, K) selected candidates (threads stride the slots, then warp
// shuffles and the 8 warps' partials in order) and writes that sum plus
// the count; 3 is K9. Only STAGE 3 writes counts.

#include "coeff_walk.cuh"

#define FB_BLOCK 8
#define FB_TB (FB_BLOCK * FB_BLOCK)
#define FB_NCH 16

// Candidate j of a block's records.
__device__ __forceinline__ const float* cand(const float* vb, int j) {
  return vb + (long long)j * FB_NCH;
}

// The first K candidates (lane order) whose rect holds tile (tx, ty) into
// s_sel; returns how many hold it (uncapped). Ends synchronized.
__device__ __forceinline__ int select_tile(const int* __restrict__ rects_b, int kb, int tx, int ty,
                                           int K, int* s_sel, int* s_warp) {
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  int running = 0;
  for (int base = 0; base < kb; base += CW_NPIX) {
    const int j = base + p;
    bool m = false;
    if (j < kb) {
      const int r = rects_b[j];
      m = tx >= (r & 0xFF) && tx < ((r >> 8) & 0xFF) && ty >= ((r >> 16) & 0xFF) &&
          ty < ((r >> 24) & 0xFF);
    }
    const unsigned ballot = __ballot_sync(CW_FULL_MASK, m);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < CW_NWARP; ++w) {
      const int c = s_warp[w];
      before += w < warp ? c : 0;
      total += c;
    }
    const int pos = running + before + __popc(ballot & ((1u << lane) - 1u));
    if (m && pos < K) s_sel[pos] = j;
    running += total;
    __syncthreads();  // s_warp is rewritten by the next round
  }
  return running;
}

// Stages compacted slot k (candidate s_sel[k]) as tile-local coefficients.
template <int C>
struct CandRows {
  const float* vb;
  const int* s_sel;
  float sx, sy;
  template <class Chunk>
  __device__ __forceinline__ void operator()(int k, int j, Chunk& s) const {
    const float* r = cand(vb, s_sel[k]);
    const float x = r[0] - sx;
    const float y = r[1] - sy;
    const float A = r[2], B = r[3], Cc = r[4];
    s.c[0][j] = -0.5f * (A * x * x + Cc * y * y) - B * x * y;
    s.c[1][j] = A * x + B * y;
    s.c[2][j] = Cc * y + B * x;
    s.c[3][j] = -0.5f * A;
    s.c[4][j] = -0.5f * Cc;
    s.c[5][j] = -B;
    s.op[j] = r[5];
#pragma unroll
    for (int c = 0; c < C; ++c) s.col[c][j] = r[6 + c];
  }
};

template <int C, int STAGE = 3>
__global__ void __launch_bounds__(CW_NPIX)
fused_kernel(const float* __restrict__ vals, const int* __restrict__ rects, int kb, int K,
             float* __restrict__ out, int* __restrict__ counts) {
  extern __shared__ int s_sel[];  // K lane ids
  __shared__ int s_warp[CW_NWARP];
  const int bt = blockIdx.x;
  const int b = bt / FB_TB, t = bt % FB_TB;
  const int tx = t % FB_BLOCK, ty = t / FB_BLOCK;
  const int p = threadIdx.x;
  float* o = out + ((long long)bt * CW_NPIX + p) * (C + 1);
  if constexpr (STAGE == 0) {
#pragma unroll
    for (int c = 0; c <= C; ++c) o[c] = 1.0f;
    return;
  }
  const int cnt = select_tile(rects + (long long)b * kb, kb, tx, ty, K, s_sel, s_warp);
  if constexpr (STAGE == 1) {
#pragma unroll
    for (int c = 0; c <= C; ++c) o[c] = (float)cnt;
    return;
  }
  const float* vb = vals + (long long)b * kb * FB_NCH;
  if constexpr (STAGE == 2) {
    __shared__ float s_red[CW_NWARP][C + 1];
    float part[C + 1];
#pragma unroll
    for (int c = 0; c <= C; ++c) part[c] = 0.0f;
    for (int k = p; k < min(cnt, K); k += CW_NPIX) {
      const float* r = cand(vb, s_sel[k]);
#pragma unroll
      for (int c = 0; c <= C; ++c) part[c] += r[c];
    }
#pragma unroll
    for (int c = 0; c <= C; ++c) {
      const float v = cw_warp_sum(part[c]);
      if ((p & 31) == 0) s_red[p >> 5][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c <= C; ++c) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < CW_NWARP; ++w) sum += s_red[w][c];
      o[c] = sum + (float)cnt;
    }
    return;
  }
  if (p == 0) counts[bt] = cnt;
  const CandRows<C> rows{vb, s_sel, (float)(tx * CW_TILE), (float)(ty * CW_TILE)};
  float acc[C];
  const float T = coeff_walk_fwd<C>(min(cnt, K), rows, acc);
#pragma unroll
  for (int c = 0; c < C; ++c) o[c] = acc[c];
  o[C] = T;
}

template <int C>
__global__ void __launch_bounds__(CW_NPIX)
fused_bwd_kernel(const float* __restrict__ vals, const int* __restrict__ rects,
                 const float* __restrict__ g, int kb, int K, float* __restrict__ drec, int* __restrict__ sel, int* __restrict__ live) {
  extern __shared__ int s_sel[];
  __shared__ int s_warp[CW_NWARP];
  const int bt = blockIdx.x;
  const int b = bt / FB_TB, t = bt % FB_TB;
  const int tx = t % FB_BLOCK, ty = t / FB_BLOCK;
  const int p = threadIdx.x;
  const int n = min(select_tile(rects + (long long)b * kb, kb, tx, ty, K, s_sel, s_warp), K);
  if (p == 0) live[bt] = n;
  for (int k = p; k < n; k += CW_NPIX) sel[(long long)bt * K + k] = s_sel[k];
  const float sx = (float)(tx * CW_TILE), sy = (float)(ty * CW_TILE);
  const float* vb = vals + (long long)b * kb * FB_NCH;
  const CandRows<C> rows{vb, s_sel, sx, sy};
  const float* gp = g + ((long long)bt * CW_NPIX + p) * (C + 1);
  float gc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) gc[c] = gp[c];
  float* tdrec = drec + (long long)bt * K * (6 + C);
  const int* ids = s_sel;
  coeff_walk_bwd<C>(n, rows, gc, gp[C], [&](int k, const float* d) {
    // the transpose of the coefficients (_coeffs_transpose)
    const float* r = cand(vb, ids[k]);
    const float x = r[0] - sx;
    const float y = r[1] - sy;
    const float A = r[2], B = r[3], Cc = r[4];
    float* o = tdrec + (long long)k * (6 + C);
    o[0] = -d[0] * (A * x + B * y) + d[1] * A + d[2] * B;
    o[1] = -d[0] * (Cc * y + B * x) + d[1] * B + d[2] * Cc;
    o[2] = -0.5f * d[0] * x * x + d[1] * x - 0.5f * d[3];
    o[3] = -d[0] * x * y + d[1] * y + d[2] * x - d[5];
    o[4] = -0.5f * d[0] * y * y + d[2] * y - 0.5f * d[4];
    o[5] = d[6];
#pragma unroll
    for (int c = 0; c < C; ++c) o[6 + c] = d[7 + c];
  });
}

template <int C>
__global__ void __launch_bounds__(CW_NPIX)
fused_route_kernel(const int* __restrict__ rects, int kb, int K,
                   const float* __restrict__ drec, const int* __restrict__ sel,
                   const int* __restrict__ live, float* __restrict__ dvals) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * CW_NPIX + threadIdx.x;
  if (j >= kb) return;
  const int r = rects[(long long)b * kb + j];
  const int xmin = r & 0xFF, xmax = min((r >> 8) & 0xFF, FB_BLOCK);
  const int ymin = (r >> 16) & 0xFF, ymax = min((r >> 24) & 0xFF, FB_BLOCK);
  float acc[6 + C];
#pragma unroll
  for (int i = 0; i < 6 + C; ++i) acc[i] = 0.0f;
  for (int ty = ymin; ty < ymax; ++ty) {
    for (int tx = xmin; tx < xmax; ++tx) {
      const long long bt = (long long)b * FB_TB + ty * FB_BLOCK + tx;
      const int* st = sel + bt * K;
      int lo = 0, hi = live[bt];
      const int n = hi;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (st[mid] < j) lo = mid + 1; else hi = mid;
      }
      if (lo < n && st[lo] == j) {
        const float* d = drec + (bt * K + lo) * (6 + C);
#pragma unroll
        for (int i = 0; i < 6 + C; ++i) acc[i] += d[i];
      }
    }
  }
  float* o = dvals + ((long long)b * kb + j) * FB_NCH;
#pragma unroll
  for (int i = 0; i < 6 + C; ++i) o[i] = acc[i];
  for (int i = 6 + C; i < FB_NCH; ++i) o[i] = 0.0f;
}

// Each returns the cudaError_t of its launches, or -1 for an unsupported C.
extern "C" int d3ga_fused(const void* vals, const void* rects, int NB, int kb, int K, int C,
                          void* out, void* counts, void* cuda_stream) {
  const float* v = (const float*)vals;
  const int* r = (const int*)rects;
  float* o = (float*)out;
  int* c = (int*)counts;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  const size_t smem = (size_t)K * sizeof(int);
#define FWD(CC) fused_kernel<CC><<<NB * FB_TB, CW_NPIX, smem, s>>>(v, r, kb, K, o, c)
  CW_SWITCH_C(C, FWD)
#undef FWD
  return (int)cudaGetLastError();
}

// The forward cut at `stage` (0-3, see the header); counts is written by
// stage 3 only. Returns the cudaError_t, or -1 for an unsupported C or
// stage.
extern "C" int d3ga_fused_stage(const void* vals, const void* rects, int NB, int kb, int K, int C,
                                int stage, void* out, void* counts, void* cuda_stream) {
  const float* v = (const float*)vals;
  const int* r = (const int*)rects;
  float* o = (float*)out;
  int* c = (int*)counts;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  const size_t smem = (size_t)K * sizeof(int);
#define STAGED(CC, SS) fused_kernel<CC, SS><<<NB * FB_TB, CW_NPIX, smem, s>>>(v, r, kb, K, o, c)
#define CUT(CC)                          \
  switch (stage) {                       \
    case 0: STAGED(CC, 0); break;        \
    case 1: STAGED(CC, 1); break;        \
    case 2: STAGED(CC, 2); break;        \
    case 3: STAGED(CC, 3); break;        \
    default: return -1;                  \
  }
  CW_SWITCH_C(C, CUT)
#undef CUT
#undef STAGED
  return (int)cudaGetLastError();
}

extern "C" int d3ga_fused_bwd(const void* vals, const void* rects, const void* g, int NB, int kb,
                              int K, int C, void* drec, void* sel, void* live, void* dvals,
                              void* cuda_stream) {
  const float* v = (const float*)vals;
  const int* r = (const int*)rects;
  const float* gg = (const float*)g;
  float* dr = (float*)drec;
  int* se = (int*)sel;
  int* li = (int*)live;
  float* dv = (float*)dvals;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  const size_t smem = (size_t)K * sizeof(int);
  const dim3 route_grid((kb + CW_NPIX - 1) / CW_NPIX, NB);
#define BWD(CC)                                                                              \
  do {                                                                                       \
    fused_bwd_kernel<CC><<<NB * FB_TB, CW_NPIX, smem, s>>>(v, r, gg, kb, K, dr, se, li);     \
    const cudaError_t e = cudaGetLastError();                                                \
    if (e != cudaSuccess) return (int)e;                                                     \
    fused_route_kernel<CC><<<route_grid, CW_NPIX, 0, s>>>(r, kb, K, dr, se, li, dv);         \
  } while (0)
  CW_SWITCH_C(C, BWD)
#undef BWD
  return (int)cudaGetLastError();
}
