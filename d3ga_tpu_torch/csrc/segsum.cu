// K4: per-Gaussian sums of id-sorted cotangent columns.
//
// Replaces the TPU kernel d3ga_tpu/raster/pallas_segsum.py::combine_sorted
// (_segsum_body): out[i, c] = sum of g[c, col(j)] over the j with
// ids[j] == i, for i < n; ids >= n are sentinels and are dropped. col(j)
// is perm[j] where a permutation is given (the columns stay in slot order
// and are read through the sort's permutation, no gathered copy), else j.
// By the dupsort selection's invariant an id occurs at most dup^2 (9)
// times.
//
// Bound on Hopper: bytes. It needs the live ids, their permutation
// entries and their cotangent columns (12 floats each; ~110 K live of the
// 688 K slots at the serving width, the rest sentinels sorted to the
// tail), and writes n x CR floats: 4 * (n_live * (CR + 2) + n * CR) bytes,
// 12.6 MB at n = 135,000, a few microseconds at 3.35 TB/s. The TPU kernel
// turns the sums into windowed one-hot matrix products because the TPU
// has no scatter or atomics; on Hopper the sorted stream is simply read.
//
// Design: one thread per Gaussian. A binary search over the sorted ids
// finds the start of its run (at most ~20 steps, the upper levels hot in
// cache), a scan finds its end, and the run is summed in sorted order
// into CR register accumulators, one column (a contiguous record row in
// the slot layout) at a time: deterministic and without atomics.

#include <cuda_runtime.h>

#define THREADS 256
#define MAX_CR 16

__global__ void __launch_bounds__(THREADS)
combine_sorted_kernel(const int* __restrict__ ids, const int* __restrict__ perm, int m,
                      const float* __restrict__ g, long long stride_c, long long stride_j,
                      int CR, int n, float* __restrict__ out) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (ids[mid] < i) lo = mid + 1;
    else hi = mid;
  }
  float acc[MAX_CR];
#pragma unroll
  for (int c = 0; c < MAX_CR; ++c) acc[c] = 0.0f;
  for (int j = lo; j < m && ids[j] == i; ++j) {
    const float* col = g + (perm ? (long long)perm[j] : (long long)j) * stride_j;
#pragma unroll
    for (int c = 0; c < MAX_CR; ++c)
      if (c < CR) acc[c] += col[c * stride_c];
  }
  float* o = out + (long long)i * CR;
#pragma unroll
  for (int c = 0; c < MAX_CR; ++c)
    if (c < CR) o[c] = acc[c];
}

// perm may be null. Returns the cudaError_t of the launch (cudaErrorInvalidValue
// for CR > MAX_CR).
extern "C" int d3ga_combine_sorted(const void* ids, const void* perm, int m, const void* g,
                                   long long stride_c, long long stride_j, int CR, int n,
                                   void* out, void* cuda_stream) {
  if (CR < 1 || CR > MAX_CR) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  combine_sorted_kernel<<<blocks, THREADS, 0, (cudaStream_t)cuda_stream>>>(
      (const int*)ids, (const int*)perm, m, (const float*)g, stride_c, stride_j, CR, n,
      (float*)out);
  return (int)cudaGetLastError();
}
