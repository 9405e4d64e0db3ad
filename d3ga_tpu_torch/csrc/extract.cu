// K1: per-tile front-K extraction from the sorted selection stream.
//
// Replaces the TPU kernel d3ga_tpu/raster/pallas_extract.py::extract_slices
// (_extract_body): out[t, j] = stream[starts[t] + j] for j < kk, 0 where
// starts[t] + j >= m. Unlike the TPU kernel, any kk is accepted. With
// `counts` [T] given, positions j >= min(counts[t], kk) get `fill` and are
// not read: the caller's live mask and `where` (the JAX package runs
// them after extract_slices) happen in the kernel. Every element is moved
// as a 32-bit pattern, so one kernel serves int32 and float32 streams
// bit-exactly (fill is passed as its bits).
//
// Bound on Hopper: bytes. Each live output element is one 4-byte load and
// each output element one 4-byte store, plus T starts (and T counts):
// 4 * (n_live + 2T + T kk) bytes, 3.2 MB at T = 2688, kk = 256 (~0.96 us
// at 3.35 TB/s); the windows of neighbouring tiles overlap in the stream,
// so each live word is read once from device memory. At 1 KB a tile the
// launch itself costs more than the traffic: block scheduling and
// per-thread instructions, not bytes, set the time.
//
// Design (extract_vec_kernel, kk % 4 == 0 and a 16-byte aligned output):
// - each thread writes 16 bytes (uint4) of an output row: rows are kk
//   words, so each starts 16-byte aligned, and the store is one vector
//   store; a warp writes 512 contiguous bytes;
// - the grid is flat over the T * kk / 4 vectors, 256 threads a block:
//   at kk 256 a block holds 4 tiles x 64 threads, 672 blocks where the
//   one-block-per-tile design launched 2,688;
// - loads: the window's start is not 16-byte aligned. The thread reads
//   the aligned 16-byte word group holding its first word and, unless
//   the start is aligned, the next one, and shifts the four words into
//   place (the shift is the same for a whole row). Chosen over four
//   4-byte loads because it issues two load instructions instead of
//   four and half the L1 wavefronts for the same bytes; the second
//   group is the neighbour thread's first, an L1 hit. Where the window
//   crosses m or the tile's count, or the stream is not 16-byte aligned,
//   the words are read one by one;
// - rows past a tile's count are written with fill and never read; at
//   the serving width ~84% of the output is such.
// Other kk take extract_word_kernel: the same flat grid, a thread a word.
//
// Baseline (d3ga_extract_slices_v1, extract_slices_v1_kernel): the design
// before, one block per tile, threads over j, 4-byte loads and stores,
// no counts. Kept only so that chip_smoke.py can time the two designs in
// turns; no wrapper of the main path reaches it. d3ga_extract_floor
// launches an empty kernel on either design's grid: the least time a
// launch of that shape takes on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

__device__ __forceinline__ uint32_t word(const uint32_t* __restrict__ stream, long long m,
                                         long long p, int j, int lim, uint32_t fill) {
  if (j >= lim) return fill;
  return (p >= 0 && p < m) ? stream[p] : 0u;
}

template <bool COUNTS, bool VLOAD>
__global__ void __launch_bounds__(THREADS)
extract_vec_kernel(const uint32_t* __restrict__ stream, int m, const int* __restrict__ starts,
                   const int* __restrict__ counts, int kq, long long n_vec, uint32_t fill,
                   uint4* __restrict__ out) {
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (v >= n_vec) return;
  const int t = (int)(v / kq);
  const int j0 = (int)(v - (long long)t * kq) * 4;
  const int lim = COUNTS ? min(max(counts[t], 0), kq * 4) : kq * 4;
  uint4 r;
  if (j0 >= lim) {
    r = make_uint4(fill, fill, fill, fill);
  } else {
    const long long p0 = (long long)starts[t] + j0;
    if (j0 + 4 <= lim && p0 >= 0 && p0 + 4 <= m) {
      if (VLOAD) {
        const int sh = (int)(p0 & 3);
        const long long base = p0 - sh;
        const uint4 lo = *reinterpret_cast<const uint4*>(stream + base);
        if (sh == 0) {
          r = lo;
        } else {
          // words base + 4 .. p0 + 3 (< m) of the next group
          const uint4 hi = base + 8 <= m ? *reinterpret_cast<const uint4*>(stream + base + 4)
                                         : make_uint4(stream[base + 4],
                                                      sh > 1 ? stream[base + 5] : 0u,
                                                      sh > 2 ? stream[base + 6] : 0u, 0u);
          if (sh == 1) r = make_uint4(lo.y, lo.z, lo.w, hi.x);
          else if (sh == 2) r = make_uint4(lo.z, lo.w, hi.x, hi.y);
          else r = make_uint4(lo.w, hi.x, hi.y, hi.z);
        }
      } else {
        r = make_uint4(stream[p0], stream[p0 + 1], stream[p0 + 2], stream[p0 + 3]);
      }
    } else {
      r = make_uint4(word(stream, m, p0, j0, lim, fill), word(stream, m, p0 + 1, j0 + 1, lim, fill),
                     word(stream, m, p0 + 2, j0 + 2, lim, fill),
                     word(stream, m, p0 + 3, j0 + 3, lim, fill));
    }
  }
  out[v] = r;
}

template <bool COUNTS>
__global__ void __launch_bounds__(THREADS)
extract_word_kernel(const uint32_t* __restrict__ stream, int m, const int* __restrict__ starts,
                    const int* __restrict__ counts, int kk, long long n_words, uint32_t fill,
                    uint32_t* __restrict__ out) {
  const long long v = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (v >= n_words) return;
  const int t = (int)(v / kk);
  const int j = (int)(v - (long long)t * kk);
  const int lim = COUNTS ? min(max(counts[t], 0), kk) : kk;
  out[v] = word(stream, m, (long long)starts[t] + j, j, lim, fill);
}

static bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// The flat grid of extract_vec_kernel (vec) or extract_word_kernel.
static int blocks_for(int n_tiles, int kk, bool vec) {
  const long long items = (long long)n_tiles * (vec ? kk / 4 : kk);
  return (int)((items + THREADS - 1) / THREADS);
}

// counts may be null (no fill). Returns the cudaError_t of the launch.
extern "C" int d3ga_extract_slices(const void* stream, int m, const void* starts,
                                   const void* counts, int n_tiles, int kk, unsigned int fill,
                                   void* out, void* cuda_stream) {
  if (kk < 1 || n_tiles < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  const bool vec = kk % 4 == 0 && aligned16(out);
  const bool vload = aligned16(stream);
  const uint32_t* s = (const uint32_t*)stream;
  const int* st = (const int*)starts;
  const int* c = (const int*)counts;
  const int blocks = blocks_for(n_tiles, kk, vec);
  cudaStream_t cs = (cudaStream_t)cuda_stream;
  if (vec) {
    const long long n_vec = (long long)n_tiles * (kk / 4);
    uint4* o = (uint4*)out;
    if (c && vload)
      extract_vec_kernel<true, true><<<blocks, THREADS, 0, cs>>>(s, m, st, c, kk / 4, n_vec, fill, o);
    else if (c)
      extract_vec_kernel<true, false><<<blocks, THREADS, 0, cs>>>(s, m, st, c, kk / 4, n_vec, fill, o);
    else if (vload)
      extract_vec_kernel<false, true><<<blocks, THREADS, 0, cs>>>(s, m, st, c, kk / 4, n_vec, fill, o);
    else
      extract_vec_kernel<false, false><<<blocks, THREADS, 0, cs>>>(s, m, st, c, kk / 4, n_vec, fill, o);
  } else {
    const long long n_words = (long long)n_tiles * kk;
    uint32_t* o = (uint32_t*)out;
    if (c)
      extract_word_kernel<true><<<blocks, THREADS, 0, cs>>>(s, m, st, c, kk, n_words, fill, o);
    else
      extract_word_kernel<false><<<blocks, THREADS, 0, cs>>>(s, m, st, c, kk, n_words, fill, o);
  }
  return (int)cudaGetLastError();
}

// -- baseline: one block per tile -----------------------------------------

__global__ void extract_slices_v1_kernel(const uint32_t* __restrict__ stream, int m,
                                         const int* __restrict__ starts, int kk,
                                         uint32_t* __restrict__ out) {
  const int t = blockIdx.x;
  const long long s = starts[t];
  uint32_t* o = out + (long long)t * kk;
  for (int j = threadIdx.x; j < kk; j += blockDim.x) {
    const long long p = s + j;
    o[j] = (p >= 0 && p < m) ? stream[p] : 0u;
  }
}

static int v1_threads(int kk) { return kk < 256 ? ((kk + 31) / 32) * 32 : 256; }

extern "C" int d3ga_extract_slices_v1(const void* stream, int m, const void* starts, int n_tiles,
                                      int kk, void* out, void* cuda_stream) {
  if (kk < 1 || n_tiles < 0) return (int)cudaErrorInvalidValue;
  if (n_tiles == 0) return 0;
  extract_slices_v1_kernel<<<n_tiles, v1_threads(kk), 0, (cudaStream_t)cuda_stream>>>(
      (const uint32_t*)stream, m, (const int*)starts, kk, (uint32_t*)out);
  return (int)cudaGetLastError();
}

// -- the launch floor -------------------------------------------------------

__global__ void extract_floor_kernel() {}

// An empty kernel on the grid the baseline (v1 != 0) or the vector design
// launches for n_tiles x kk.
extern "C" int d3ga_extract_floor(int n_tiles, int kk, int v1, void* cuda_stream) {
  if (kk < 1 || n_tiles < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t cs = (cudaStream_t)cuda_stream;
  if (v1)
    extract_floor_kernel<<<n_tiles, v1_threads(kk), 0, cs>>>();
  else
    extract_floor_kernel<<<blocks_for(n_tiles, kk, kk % 4 == 0), THREADS, 0, cs>>>();
  return (int)cudaGetLastError();
}
