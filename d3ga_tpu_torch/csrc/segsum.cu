// K4: per-Gaussian sums of id-sorted cotangent columns.
//
// Replaces the TPU kernel d3ga_tpu/raster/pallas_segsum.py::combine_sorted
// (_segsum_body): out[i, c] = sum of g[c, col(j)] over the j with
// ids[j] == i, for i < n; ids >= n are sentinels and are dropped. col(j)
// is perm[j] where a permutation is given (the columns stay in slot order
// and are read through the sort's permutation, no gathered copy), else j.
// perm may be int32 or int64 (what torch.sort returns). The output has
// `rows` >= n rows; rows n.. are zero (combine_from_slots asks for n + 1:
// the records' sentinel row). By the dupsort selection's invariant an id
// occurs at most dup^2 (9) times; the kernel does not rely on it.
//
// Bound on Hopper: bytes. It needs the live ids, their permutation
// entries and their cotangent columns (12 floats each; ~110 K live of the
// 688 K slots at the serving width, the rest sentinels sorted to the
// tail), and writes rows x CR floats: 4 * n_live * (CR + 1) +
// perm_bytes * n_live + 4 * rows * CR bytes, ~13 MB at n = 135,000, a
// few microseconds at 3.35 TB/s. The TPU kernel turns the sums into
// windowed one-hot matrix products because the TPU has no scatter or
// atomics; on Hopper the sorted stream is simply read.
//
// Design (combine_warp_kernel): one warp per 32 consecutive Gaussians
// [i0, i0 + 32). The time of a one-wave launch is one warp's chain of
// dependent loads, so the design shortens that chain:
// - search: the warp finds lower_bound(ids, i0) and lower_bound(ids,
//   i0 + 32) together by a lane-parallel 32-ary search: each step the 32
//   lanes read 32 evenly spaced pivots and a ballot picks the sub-interval,
//   4 dependent steps at m = 688,128 where a binary search takes ~20;
// - runs: the warp reads its id range [a, b) in coalesced 32-wide chunks
//   (any length: a run may cross chunks). In each chunk, each lane finds
//   where its Gaussian's run starts by a 5-step binary search over the
//   chunk's ids held in the lanes (shuffles); where it ends is the next
//   lane's start;
// - rows: in each chunk every lane loads the row of ONE slot (its chunk
//   position, through perm), so all of the chunk's random rows are in
//   flight at once and a lane holds one row of registers, not a run's:
//   64 registers a thread keep the 4,219 warps of n = 135,000 in one wave
//   (4 blocks of 8 warps an SM). The rows go to the warp's shared-memory
//   stage; each lane then sums its run's rows from there in run order,
//   starting from 0.0f, as combine_sorted_plain does: bit-exact with it;
// - output: the warp's rows x CR result floats are contiguous in the
//   row-major output; they are staged in shared memory and written as
//   coalesced 16-byte stores where aligned, with a scalar tail. A
//   Gaussian with no slot (and each row past n) gets a zero row.
// Deterministic, no atomics, one launch.
//
// Baseline (d3ga_combine_sorted_v1, combine_sorted_v1_kernel): the design
// before, one thread per Gaussian with a binary search over all m ids, a
// scan of its run and CR scalar stores at a CR-float stride; int32 perm,
// n rows. Kept only so that chip_smoke.py can time the two designs in
// turns; no wrapper of the main path reaches it.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define MAX_CR 16
#define WARPS 8
#define THREADS (WARPS * 32)
#define FULL 0xffffffffu

// Lane-parallel lower bounds of v0 and v1 in ids[0, m), searched together:
// the answer lies in [lo, hi] with ids[j] < v below lo and >= v from hi on.
__device__ __forceinline__ void warp_lower_bounds(const int* __restrict__ ids, int m, int v0,
                                                  int v1, int lane, int& r0, int& r1) {
  int lo0 = 0, hi0 = m, lo1 = 0, hi1 = m;
  while (hi0 > lo0 || hi1 > lo1) {  // warp-uniform
    const int s0 = (hi0 - lo0 + 31) >> 5, s1 = (hi1 - lo1 + 31) >> 5;
    const int q0 = lo0 + lane * s0, q1 = lo1 + lane * s1;
    const bool p0 = q0 < hi0 && ids[q0] < v0;
    const bool p1 = q1 < hi1 && ids[q1] < v1;
    // the pivots below v are a prefix of the lanes
    const int c0 = __popc(__ballot_sync(FULL, p0));
    const int c1 = __popc(__ballot_sync(FULL, p1));
    if (c0 == 0) hi0 = lo0;
    else { hi0 = min(hi0, lo0 + c0 * s0); lo0 += (c0 - 1) * s0 + 1; }
    if (c1 == 0) hi1 = lo1;
    else { hi1 = min(hi1, lo1 + c1 * s1); lo1 += (c1 - 1) * s1 + 1; }
  }
  r0 = lo0;
  r1 = lo1;
}

// How many of the warp's 32 ascending values d are < v (v per lane).
__device__ __forceinline__ int count_below(int d, int v) {
  int pos = 0;
#pragma unroll
  for (int s = 16; s >= 1; s >>= 1)
    if (__shfl_sync(FULL, d, pos + s - 1) < v) pos += s;
  return pos + (__shfl_sync(FULL, d, 31) < v ? 1 : 0);
}

template <int PERM>  // bytes of a perm entry; 0: no permutation
__device__ __forceinline__ long long column(const void* perm, int j) {
  if (PERM == 8) return static_cast<const long long*>(perm)[j];
  if (PERM == 4) return static_cast<const int*>(perm)[j];
  return j;
}

// VEC: CR % 4 == 0, and each row is CR contiguous floats, 16-byte aligned
template <int PERM, bool VEC>
__global__ void __launch_bounds__(THREADS, 4)
combine_warp_kernel(const int* __restrict__ ids, const void* __restrict__ perm, int m,
                    const float* __restrict__ g, long long stride_c, long long stride_j, int CR,
                    int n, int rows, float* __restrict__ out, bool vec_out) {
  __shared__ __align__(16) float stage[WARPS][32 * MAX_CR];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long i0l = ((long long)blockIdx.x * WARPS + w) * 32;
  if (i0l >= rows) return;  // the whole warp
  const int i0 = (int)i0l;
  float* st = stage[w];

  int a, b;
  warp_lower_bounds(ids, m, min(i0, n), (int)min(i0l + 32, (long long)n), lane, a, b);

  const int mine = i0 + lane;
  float acc[MAX_CR];
#pragma unroll
  for (int c = 0; c < MAX_CR; ++c) acc[c] = 0.0f;
  for (int base = a; base < b; base += 32) {  // warp-uniform
    const int p = base + lane;
    const bool live = p < b;
    const int d = live ? ids[p] : INT_MAX;
    if (live) {  // this chunk position's row, to the stage
      const float* row = g + column<PERM>(perm, p) * stride_j;
      if (VEC) {
#pragma unroll
        for (int c = 0; c < MAX_CR; c += 4)
          if (c < CR)
            *reinterpret_cast<float4*>(st + lane * CR + c) =
                *reinterpret_cast<const float4*>(row + c);
      } else {
#pragma unroll
        for (int c = 0; c < MAX_CR; ++c)
          if (c < CR) st[lane * CR + c] = row[c * stride_c];
      }
    }
    // this lane's run in the chunk: [k0, k1)
    const int k0 = count_below(d, mine);
    int k1 = __shfl_down_sync(FULL, k0, 1);
    if (lane == 31) k1 = min(32, b - base);
    __syncwarp();
    for (int k = k0; k < k1; ++k) {  // in run order
      if (VEC) {
#pragma unroll
        for (int c = 0; c < MAX_CR; c += 4)
          if (c < CR) {
            const float4 r = *reinterpret_cast<const float4*>(st + k * CR + c);
            acc[c] += r.x;
            acc[c + 1] += r.y;
            acc[c + 2] += r.z;
            acc[c + 3] += r.w;
          }
      } else {
#pragma unroll
        for (int c = 0; c < MAX_CR; ++c)
          if (c < CR) acc[c] += st[k * CR + c];
      }
    }
    __syncwarp();
  }

  // the warp's rows, staged, then stored contiguously
#pragma unroll
  for (int c = 0; c < MAX_CR; ++c)
    if (c < CR) st[lane * CR + c] = acc[c];
  __syncwarp();
  const int nfl = (int)min(32LL, rows - i0l) * CR;
  float* o = out + i0l * CR;
  int done = 0;
  if (vec_out) {
    const int nv = nfl >> 2;
    for (int v = lane; v < nv; v += 32)
      reinterpret_cast<float4*>(o)[v] = reinterpret_cast<const float4*>(st)[v];
    done = nv << 2;
  }
  for (int f = done + lane; f < nfl; f += 32) o[f] = st[f];
}

template <int PERM>
static void launch_warp(int blocks, cudaStream_t s, bool vec_in, const int* ids, const void* perm,
                        int m, const float* g, long long stride_c, long long stride_j, int CR,
                        int n, int rows, float* out, bool vec_out) {
  if (vec_in)
    combine_warp_kernel<PERM, true><<<blocks, THREADS, 0, s>>>(
        ids, perm, m, g, stride_c, stride_j, CR, n, rows, out, vec_out);
  else
    combine_warp_kernel<PERM, false><<<blocks, THREADS, 0, s>>>(
        ids, perm, m, g, stride_c, stride_j, CR, n, rows, out, vec_out);
}

// perm may be null (perm_bytes 0), int32 (4) or int64 (8). out has rows >= n
// rows. Returns the cudaError_t of the launch (cudaErrorInvalidValue for
// CR > MAX_CR or a bad perm_bytes).
extern "C" int d3ga_combine_sorted(const void* ids, const void* perm, int perm_bytes, int m,
                                   const void* g, long long stride_c, long long stride_j, int CR,
                                   int n, int rows, void* out, void* cuda_stream) {
  if (CR < 1 || CR > MAX_CR || rows < n || n < 0) return (int)cudaErrorInvalidValue;
  if (perm == nullptr) perm_bytes = 0;
  if (perm_bytes != 0 && perm_bytes != 4 && perm_bytes != 8) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const long long warps = ((long long)rows + 31) / 32;
  const int blocks = (int)((warps + WARPS - 1) / WARPS);
  const bool vec_in = stride_c == 1 && CR % 4 == 0 && stride_j % 4 == 0 &&
                      (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const bool vec_out = (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  cudaStream_t s = (cudaStream_t)cuda_stream;
  const int* i = (const int*)ids;
  const float* gf = (const float*)g;
  float* o = (float*)out;
  if (perm_bytes == 8)
    launch_warp<8>(blocks, s, vec_in, i, perm, m, gf, stride_c, stride_j, CR, n, rows, o, vec_out);
  else if (perm_bytes == 4)
    launch_warp<4>(blocks, s, vec_in, i, perm, m, gf, stride_c, stride_j, CR, n, rows, o, vec_out);
  else
    launch_warp<0>(blocks, s, vec_in, i, perm, m, gf, stride_c, stride_j, CR, n, rows, o, vec_out);
  return (int)cudaGetLastError();
}

// -- baseline: the one-thread-per-Gaussian design ------------------------

#define V1_THREADS 256

__global__ void __launch_bounds__(V1_THREADS)
combine_sorted_v1_kernel(const int* __restrict__ ids, const int* __restrict__ perm, int m,
                         const float* __restrict__ g, long long stride_c, long long stride_j,
                         int CR, int n, float* __restrict__ out) {
  const int i = blockIdx.x * V1_THREADS + threadIdx.x;
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

// perm may be null or int32; out has n rows.
extern "C" int d3ga_combine_sorted_v1(const void* ids, const void* perm, int m, const void* g,
                                      long long stride_c, long long stride_j, int CR, int n,
                                      void* out, void* cuda_stream) {
  if (CR < 1 || CR > MAX_CR) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int blocks = (n + V1_THREADS - 1) / V1_THREADS;
  combine_sorted_v1_kernel<<<blocks, V1_THREADS, 0, (cudaStream_t)cuda_stream>>>(
      (const int*)ids, (const int*)perm, m, (const float*)g, stride_c, stride_j, CR, n,
      (float*)out);
  return (int)cudaGetLastError();
}
