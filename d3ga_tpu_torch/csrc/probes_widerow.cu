// P2: the wide-row passthrough, the card's counterpart of the TPU probe
// tools/widerow_probe.py::passthrough (o = x * 1.000001 over a grid of
// blocks of `bs` leading entries). The probe asks whether an operand costs
// per row or per byte: the same bytes as records [2688, 256, 16] against
// [2688, 32, 128], an image [1024, 672, 4] against [1024, 2688].
//
// The design (`probes_passthrough`, `passthrough_kernel`): a row is no unit
// of this card's memory system, which moves 32-byte sectors, so the kernel
// walks the operand as one flat array of float4s, with no (row, column)
// split and no divide. Each thread keeps WR_UNROLL independent 16-byte
// loads in flight (an unrolled batch, WR_THREADS float4s apart so a warp's
// loads stay contiguous), read with ld.global.nc.L1::no_allocate and
// written with st.global.cs: the operand streams through once and need
// not stay in L1 or L2. The grid is sized to the card, not to the TPU's
// block of `bs` leading entries (a VMEM tile, no unit of this card): as
// many CTAs as the SMs hold at once (the occupancy calculator's count,
// times the SMs), each striding over the array by the grid's width,
// fewer where the array is smaller. The kernel stays templated on the row
// width W, so each case's width has its own instantiation, but W no longer
// enters the index arithmetic: a difference between the cases is the
// memory system's. One float32 multiply an element, so the output is
// bit-equal to the plain x * 1.000001 (no fast math).
// Bound: bytes, the operand read once and written once, over 3.35 TB/s.
// (Case A's input is 44 MB and the L2 holds 50 MB: back-to-back calls on
// the same tensor may partly hit L2, so there the bound is no hard floor.)
//
// The design before (`probes_passthrough_v1`, `passthrough_v1_kernel`): one
// CTA of 256 threads a TPU block of `bs` leading entries (672 CTAs of 64 KB
// at case A), threads walking the tile in float4s split into (row, column)
// of W by an integer divide, one load in flight at a time. Kept for
// `chip_smoke.py`'s comparisons.

#include <cuda_runtime.h>

#define WR_THREADS 256
#define WR_UNROLL 4

__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void st_stream(float4* p, float4 v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"l"(p), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 scaled(float4 e) {
  e.x *= 1.000001f;
  e.y *= 1.000001f;
  e.z *= 1.000001f;
  e.w *= 1.000001f;
  return e;
}

template <int W>
__global__ void __launch_bounds__(WR_THREADS)
passthrough_kernel(const float4* __restrict__ x, float4* __restrict__ o, long long n4) {
  static_assert(W % 4 == 0, "rows of whole float4s");
  const long long step = (long long)gridDim.x * WR_THREADS * WR_UNROLL;
  long long i = (long long)blockIdx.x * WR_THREADS * WR_UNROLL + threadIdx.x;
  for (; i + (WR_UNROLL - 1) * WR_THREADS < n4; i += step) {
    float4 v[WR_UNROLL];
#pragma unroll
    for (int u = 0; u < WR_UNROLL; ++u) v[u] = ld_stream(x + i + u * WR_THREADS);
#pragma unroll
    for (int u = 0; u < WR_UNROLL; ++u) st_stream(o + i + u * WR_THREADS, scaled(v[u]));
  }
  // the last, partial batch
#pragma unroll
  for (int u = 0; u < WR_UNROLL; ++u)
    if (i + u * WR_THREADS < n4) st_stream(o + i + u * WR_THREADS, scaled(ld_stream(x + i + u * WR_THREADS)));
}

template <int W>
static int launch(const float4* x, float4* o, long long n4, cudaStream_t st) {
  static int full = 0;  // CTAs the card holds at once
  if (!full) {
    int dev, sms, per_sm;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, passthrough_kernel<W>, WR_THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    full = sms * per_sm;
  }
  const long long need = (n4 + WR_THREADS * WR_UNROLL - 1) / (WR_THREADS * WR_UNROLL);
  const unsigned grid = (unsigned)(need < full ? need : full);
  if (grid) passthrough_kernel<W><<<grid, WR_THREADS, 0, st>>>(x, o, n4);
  return (int)cudaGetLastError();
}

// x, o: n floats (n % 4 == 0, 16-byte aligned) in rows of `width`.
// Returns the cudaError_t of the launch.
extern "C" int probes_passthrough(const void* x, void* o, long long n, int width, void* cuda_stream) {
  const float4* X = (const float4*)x;
  float4* O = (float4*)o;
  const long long n4 = n / 4;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  switch (width) {
    case 4: return launch<4>(X, O, n4, st);
    case 16: return launch<16>(X, O, n4, st);
    case 128: return launch<128>(X, O, n4, st);
    case 2688: return launch<2688>(X, O, n4, st);
    default: return launch<0>(X, O, n4, st);
  }
}

// ---- the design before ----

template <int W>
__global__ void __launch_bounds__(WR_THREADS)
passthrough_v1_kernel(const float4* __restrict__ x, float4* __restrict__ o, long long rows,
                      int tile_rows, int width) {
  constexpr int W4C = W / 4;
  const int w4 = W ? W4C : width / 4;  // float4s a row
  const long long r0 = (long long)blockIdx.x * tile_rows;
  const int nrows = (int)min((long long)tile_rows, rows - r0);
  const float4* xs = x + r0 * w4;
  float4* os = o + r0 * w4;
  const int n4 = nrows * w4;
  for (int v = threadIdx.x; v < n4; v += WR_THREADS) {
    const int r = v / w4, c = v - r * w4;  // the row of W and its float4
    os[r * w4 + c] = scaled(xs[r * w4 + c]);
  }
}

// x, o: rows x width float32 (width % 4 == 0, 16-byte aligned); tile_rows
// rows a CTA. Returns the cudaError_t of the launch.
extern "C" int probes_passthrough_v1(const void* x, void* o, long long rows, int width,
                                     int tile_rows, void* cuda_stream) {
  const float4* X = (const float4*)x;
  float4* O = (float4*)o;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  const unsigned grid = (unsigned)((rows + tile_rows - 1) / tile_rows);
  switch (width) {
    case 4: passthrough_v1_kernel<4><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width); break;
    case 16: passthrough_v1_kernel<16><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width); break;
    case 128: passthrough_v1_kernel<128><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width); break;
    case 2688: passthrough_v1_kernel<2688><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width); break;
    default: passthrough_v1_kernel<0><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width);
  }
  return (int)cudaGetLastError();
}
