// P2: the wide-row passthrough, the card's counterpart of the TPU probe
// tools/widerow_probe.py::passthrough (o = x * 1.000001 over a grid of
// blocks of `bs` leading entries). The probe asks whether an operand costs
// per row or per byte: the same bytes as records [2688, 256, 16] against
// [2688, 32, 128], an image [1024, 672, 4] against [1024, 2688].
//
// The kernel is templated on the row width W (the last axis; 0 takes it at
// run time), and each CTA takes the TPU block's rows as its tile: `bs`
// leading entries, tile_rows = bs x (the rows of W a leading entry holds).
// Threads walk the tile in float4s, each split into (row, column) of W;
// the row width changes only that index arithmetic, which the compiler
// folds into the flat offset: on this card a row is no unit of the memory
// system, which moves 32-byte sectors. One float32 multiply an element,
// so the output is bit-equal to the plain x * 1.000001 (no fast math).
// Bound: bytes, the operand read once and written once, over 3.35 TB/s.

#include <cuda_runtime.h>

#define WR_THREADS 256

template <int W>
__global__ void __launch_bounds__(WR_THREADS)
passthrough_kernel(const float4* __restrict__ x, float4* __restrict__ o, long long rows,
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
    float4 e = xs[r * w4 + c];
    e.x *= 1.000001f;
    e.y *= 1.000001f;
    e.z *= 1.000001f;
    e.w *= 1.000001f;
    os[r * w4 + c] = e;
  }
}

// x, o: rows x width float32 (width % 4 == 0, 16-byte aligned); tile_rows
// rows a CTA. Returns the cudaError_t of the launch.
extern "C" int probes_passthrough(const void* x, void* o, long long rows, int width,
                                  int tile_rows, void* cuda_stream) {
  const float4* X = (const float4*)x;
  float4* O = (float4*)o;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  const unsigned grid = (unsigned)((rows + tile_rows - 1) / tile_rows);
  switch (width) {
    case 4: passthrough_kernel<4><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width); break;
    case 16: passthrough_kernel<16><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width); break;
    case 128: passthrough_kernel<128><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width); break;
    case 2688: passthrough_kernel<2688><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width); break;
    default: passthrough_kernel<0><<<grid, WR_THREADS, 0, st>>>(X, O, rows, tile_rows, width);
  }
  return (int)cudaGetLastError();
}
