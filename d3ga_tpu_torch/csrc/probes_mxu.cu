// P1: matmul and roll probes, the card's counterparts of the TPU probe
// tools/mxu_probe.py::matmul_case (one Pallas kernel of a fori_loop of
// data-dependent dot_generals at DEFAULT / HIGH / HIGHEST precision) and
// ::roll_case (a fori_loop of pltpu.roll + select).
//
// Matmul. One launch runs n_ops products out = aa @ b back to back, where
// aa starts as a and after each product aa += out[0][0] * 1e-30: the next
// product needs the last one's corner, so nothing is hoisted out of the
// loop, and (1e-30 of the corner being far below half an ulp of every
// element) aa stays a, so the output is a @ b. b is [K, N], or [N, K]
// with contract_last (a @ b^T).
// Precisions, as a TPU's map onto this card:
//   HIGHEST -> FP32 SIMT: each thread a 4x4 (2x4) block of fmaf chains;
//   DEFAULT -> one TF32 pass on the tensor cores
//              (mma.sync.aligned.m16n8k8 tf32, operands rounded by
//              cvt.rna.tf32.f32);
//   HIGH    -> 3xTF32: a = big + small (both TF32), the product
//              small*big + big*small + big*big (bf16_3x's counterpart).
// Each k-tile of 32 (8 where K is 8) is summed into a fresh partial that is
// then added to the float32 accumulator, so long contractions (K 4096) do
// not lose a chain of K roundings (or the tensor cores' truncating adds)
// against the plain versions. Operands whose tiles fit in 200 KB of shared
// memory ([128,128]@[128,16], [16,128]@[128,256], [256,8]@[8,256]) are
// copied there once a launch, as the TPU kernel holds them in VMEM, and
// each product's aa += ... is applied to them in place; larger ones stream
// from L2 through a ring of 4 shared-memory stages by cp.async (16 bytes a
// copy), three k-tiles in flight while one is multiplied, the running
// shift added to each staged element of a. TF32 operands are rounded as
// the mma fragments are read (3xTF32 splits them there). M, N and K are
// padded with zeros to the tile inside the kernel (N 3 and 16 to 16, K 8
// stays 8); the padding never reaches the output.
// One CTA of 256 threads computes a whole product, tile by tile, as the TPU
// kernel is one program on one core: that gives a per-SM rate. Launched
// with one CTA per SM on replicated operands (a [ctas, M, K], b and out
// likewise), the same code gives the chip's rate.
// Bound: operations, 2 M K N a product at the per-SM peak of the type
// (FP32 67 TFLOP/s, TF32 495 TFLOP/s dense, over 132 SMs; 3xTF32 three TF32
// passes); streamed operands stay in L2 (at most 4.25 MB) and each of
// their tiles is staged through shared memory again for every product.
//
// Roll. n trips of 8 steps of m = roll(x, s, axis); x = where(m > x, m,
// x * 0.999999f) on a [R, L] float32 array (L a power of two, R too for a
// roll along rows), as np.roll (roll(x, s)[i] = x[i - s]). A TPU rolls
// vregs; here a CTA holds its slab in shared memory (one row of L for a
// roll along lanes, all of [R, L] for a roll along rows, 128 KB at
// [4096, 8]), each thread reads its elements' sources into registers, a
// barrier, writes, a barrier.
// Bound: operations, three FP32-pipe instructions an element a step
// (multiply, compare, select) over the SMs the launch occupies.

#include <cuda_runtime.h>
#include <stdint.h>

#define MX_THREADS 256
#define MX_STAGES 4  // k-tiles in the shared-memory ring
// operands whose blocks fit in this much shared memory stay there
#define MX_RESIDENT_BYTES (200 * 1024)
#define MX_CHAIN 1e-30f

enum { PREC_HIGHEST = 0, PREC_DEFAULT = 1, PREC_HIGH = 2 };

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d += a b on one m16n8k8 TF32 tile, float32 accumulate.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A CTA tile of BM x BN outputs, staged BK deep: a's block as [m][k] (rows
// of LDA = BK + 4 floats), b's as [k][n] (rows of LDB = BN + 8); the
// padding keeps the mma fragments' reads on 32 distinct banks and every
// row 16-byte aligned.
//   SIMT: TX x TY threads, each a TM x TN block of outputs (rows ty TM..,
//   columns tx TN..), reading 4 k at a time: TM float4s of a and 4 of b
//   feed 4 TM TN fmaf.
//   mma: WARPS_M x WARPS_N warps, each 16 rows x NT tiles of 8 columns.
template <int BM_, int BN_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_;
  static constexpr int LDA = BK + 4, LDB = BN + 8;
  static constexpr int TN = 4, TX = BN / TN, TY = MX_THREADS / TX, TM = BM / TY;
  static constexpr int WARPS_M = BM / 16, WARPS_N = (MX_THREADS / 32) / WARPS_M;
  static constexpr int NT = BN / (8 * WARPS_N);
  // the groups of 4 floats of a k-tile each thread copies
  static constexpr int NA = (BM * BK / 4 + MX_THREADS - 1) / MX_THREADS;
  static constexpr int NB = (BK * BN / 4 + MX_THREADS - 1) / MX_THREADS;
  static constexpr int A_FLOATS = BM * LDA, B_FLOATS = BK * LDB, STAGE = A_FLOATS + B_FLOATS;
  static_assert(TX * TY == MX_THREADS && TM * TY == BM && BK % 4 == 0, "SIMT layout");
  static_assert(WARPS_M * WARPS_N * 32 == MX_THREADS && NT * 8 * WARPS_N == BN, "mma layout");
  static_assert(A_FLOATS % 4 == 0 && STAGE % 4 == 0, "16-byte aligned blocks");
};

using Wide = Tile<64, 64, 32>;     // the square shapes
using WideK8 = Tile<64, 64, 8>;    // [256, 8] @ [8, 256]
using Narrow = Tile<128, 16, 32>;  // N <= 16
using NarrowK8 = Tile<128, 16, 8>;
using Flat = Tile<16, 128, 32>;    // M <= 16
using FlatK8 = Tile<16, 128, 8>;

// Copies 16 bytes (cp_async16) or 4 (cp_async4) from global to shared
// memory asynchronously, or zeros them where !valid (src-size 0).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Starts the copies of a's k-tile k0 of rows m0.. into the block at dst
// (zeros outside a): groups of 4 consecutive k, 16 bytes at once where K
// is a multiple of 4, else float by float.
template <class G>
__device__ __forceinline__ void issue_a(float* dst, const float* __restrict__ a, int M, int K,
                                        int m0, int k0) {
#pragma unroll
  for (int q = 0; q < G::NA; ++q) {
    const int i = threadIdx.x + q * MX_THREADS;
    if (i < G::BM * G::BK / 4) {
      const int r = i / (G::BK / 4), c = i % (G::BK / 4) * 4;
      const int m = m0 + r, k = k0 + c;
      float* d = dst + r * G::LDA + c;
      const float* src = a + (long long)m * K + k;
      if (K % 4 == 0) {
        cp_async16(d, m < M && k < K ? src : a, m < M && k < K);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = m < M && k + e < K;
          cp_async4(d + e, ok ? src + e : a, ok);
        }
      }
    }
  }
}

// The same for b's k-tile k0 of columns n0..: groups of 4 consecutive n,
// 16 bytes at once where b is [K, N] with N a multiple of 4, else float by
// float (contract_last: b is [N, K]).
template <class G>
__device__ __forceinline__ void issue_b(float* dst, const float* __restrict__ b, int K, int N,
                                        int contract_last, int n0, int k0) {
#pragma unroll
  for (int q = 0; q < G::NB; ++q) {
    const int i = threadIdx.x + q * MX_THREADS;
    if (i < G::BK * G::BN / 4) {
      const int r = i / (G::BN / 4), c = i % (G::BN / 4) * 4;
      const int k = k0 + r, n = n0 + c;
      float* d = dst + r * G::LDB + c;
      if (!contract_last && N % 4 == 0) {
        const bool ok = k < K && n < N;
        cp_async16(d, ok ? b + (long long)k * N + n : b, ok);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = k < K && n + e < N;
          const long long at =
              contract_last ? (long long)(n + e) * K + k : (long long)k * N + n + e;
          cp_async4(d + e, ok ? b + at : b, ok);
        }
      }
    }
  }
}

// += shift on the elements of a's block (k-tile k0, rows m0..) that this
// thread copied: its own copies are visible to it after
// cp.async.wait_group; the padding stays 0.
template <class G>
__device__ __forceinline__ void shift_own(float* blk, int M, int K, int m0, int k0, float shift) {
#pragma unroll
  for (int q = 0; q < G::NA; ++q) {
    const int i = threadIdx.x + q * MX_THREADS;
    const int r = i / (G::BK / 4), c = i % (G::BK / 4) * 4;
    if (i < G::BM * G::BK / 4 && m0 + r < M) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + c + e < K) blk[r * G::LDA + c + e] += shift;
    }
  }
}

__device__ __forceinline__ void load4(float (&dst)[4], const float* src) {
  const float4 v = *reinterpret_cast<const float4*>(src);
  dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
}

// The accumulators of one output tile: SIMT TM x TN a thread, mma NT x 4.
template <int PREC, class G>
struct Acc {
  static constexpr int ROWS = PREC == PREC_HIGHEST ? G::TM : G::NT;
  static constexpr int COLS = PREC == PREC_HIGHEST ? G::TN : 4;
  float v[ROWS][COLS];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) v[i][j] = 0.0f;
  }
  // += part, and part = 0
  __device__ __forceinline__ void fold(Acc& part) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < COLS; ++j) v[i][j] += part.v[i][j], part.v[i][j] = 0.0f;
  }
};

// part += a k-tile (a's block at sa, b's at sb), by FP32 SIMT fmaf.
template <class G>
__device__ __forceinline__ void simt_step(const float* sa, const float* sb,
                                          Acc<PREC_HIGHEST, G>& part) {
  const int tx = threadIdx.x % G::TX, ty = threadIdx.x / G::TX;
#pragma unroll
  for (int kk = 0; kk < G::BK; kk += 4) {
    float av[G::TM][4], bv[4][G::TN];
#pragma unroll
    for (int i = 0; i < G::TM; ++i) load4(av[i], sa + (ty * G::TM + i) * G::LDA + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q) load4(bv[q], sb + (kk + q) * G::LDB + tx * G::TN);
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int i = 0; i < G::TM; ++i)
#pragma unroll
        for (int j = 0; j < G::TN; ++j) part.v[i][j] = fmaf(av[i][q], bv[q][j], part.v[i][j]);
  }
}

// part += a k-tile (a's block at sa, b's at sb) on the tensor cores: TF32
// (the operands rounded as the fragments are read) or 3xTF32.
template <int PREC, class G>
__device__ __forceinline__ void mma_step(const float* sa, const float* sb, Acc<PREC, G>& part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp % G::WARPS_M, wn = warp / G::WARPS_M;
  const float* ar = sa + (wm * 16 + g) * G::LDA;
#pragma unroll
  for (int kc = 0; kc < G::BK; kc += 8) {
    // a fragment: a0 (row g, col t4), a1 (g + 8, t4), a2 (g, t4 + 4),
    // a3 (g + 8, t4 + 4); b: b0 (row t4, col g), b1 (t4 + 4, g)
    const float ax[4] = {ar[kc + t4], ar[8 * G::LDA + kc + t4], ar[kc + t4 + 4],
                         ar[8 * G::LDA + kc + t4 + 4]};
    uint32_t ab[4], as[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float big = to_tf32(ax[e]);
      ab[e] = __float_as_uint(big);
      if constexpr (PREC == PREC_HIGH) as[e] = __float_as_uint(to_tf32(ax[e] - big));
    }
#pragma unroll
    for (int t = 0; t < G::NT; ++t) {
      const int col = (wn * G::NT + t) * 8 + g;
      const float bx[2] = {sb[(kc + t4) * G::LDB + col], sb[(kc + t4 + 4) * G::LDB + col]};
      uint32_t bb[2], bs[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float big = to_tf32(bx[e]);
        bb[e] = __float_as_uint(big);
        if constexpr (PREC == PREC_HIGH) bs[e] = __float_as_uint(to_tf32(bx[e] - big));
      }
      if constexpr (PREC == PREC_HIGH) {
        mma_tf32(part.v[t], as, bb);
        mma_tf32(part.v[t], ab, bs);
      }
      mma_tf32(part.v[t], ab, bb);
    }
  }
}

template <int PREC, class G>
__device__ __forceinline__ void step(const float* sa, const float* sb, Acc<PREC, G>& part) {
  if constexpr (PREC == PREC_HIGHEST)
    simt_step<G>(sa, sb, part);
  else
    mma_step<PREC, G>(sa, sb, part);
}

// A finished output tile: publishes element (0, 0) of the product when the
// tile holds it (thread 0 holds it in both layouts), and stores the tile
// when `store` (SIMT: TM x TN a thread; mma: c0, c1 at (row g, columns
// 2 t4, 2 t4 + 1), c2, c3 at row g + 8).
template <int PREC, class G>
__device__ __forceinline__ void finish_tile(const Acc<PREC, G>& acc, float* __restrict__ out,
                                            int M, int N, int m0, int n0, bool store,
                                            float* corner) {
  if (m0 == 0 && n0 == 0 && threadIdx.x == 0) *corner = acc.v[0][0];
  if (!store) return;
  if constexpr (PREC == PREC_HIGHEST) {
    const int tx = threadIdx.x % G::TX, ty = threadIdx.x / G::TX;
#pragma unroll
    for (int i = 0; i < G::TM; ++i)
#pragma unroll
      for (int j = 0; j < G::TN; ++j) {
        const int m = m0 + ty * G::TM + i, n = n0 + tx * G::TN + j;
        if (m < M && n < N) out[(long long)m * N + n] = acc.v[i][j];
      }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int wm = warp % G::WARPS_M, wn = warp / G::WARPS_M;
#pragma unroll
    for (int t = 0; t < G::NT; ++t) {
      const int n = n0 + (wn * G::NT + t) * 8 + 2 * t4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 16 + g + (e >> 1) * 8, nn = n + (e & 1);
        if (m < M && nn < N) out[(long long)m * N + nn] = acc.v[t][e];
      }
    }
  }
}

// One output tile, its k-tiles streamed from L2 through the ring
// (MX_STAGES - 1 in flight while one is multiplied), each summed into a
// fresh partial that is then folded into the accumulator.
template <int PREC, class G>
__device__ __forceinline__ void streamed_tile(float* ring, const float* __restrict__ a,
                                              const float* __restrict__ b, float* __restrict__ out,
                                              int M, int K, int N, int contract_last, int m0,
                                              int n0, float shift, bool store, float* corner) {
  Acc<PREC, G> acc, part;
  acc.zero();
  part.zero();
  const int nk = (K + G::BK - 1) / G::BK;
#pragma unroll
  for (int st = 0; st < MX_STAGES - 1; ++st) {
    if (st < nk) {
      issue_a<G>(ring + st * G::STAGE, a, M, K, m0, st * G::BK);
      issue_b<G>(ring + st * G::STAGE + G::A_FLOATS, b, K, N, contract_last, n0, st * G::BK);
    }
    cp_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    float* stage = ring + (kt % MX_STAGES) * G::STAGE;
    cp_wait<MX_STAGES - 2>();  // this thread's copies of k-tile kt have landed
    shift_own<G>(stage, M, K, m0, kt * G::BK, shift);
    // every copy and shift of k-tile kt is done, and every thread is done
    // with k-tile kt - 1, whose stage the next copies refill
    __syncthreads();
    const int next = kt + MX_STAGES - 1;
    if (next < nk) {
      float* ns = ring + (next % MX_STAGES) * G::STAGE;
      issue_a<G>(ns, a, M, K, m0, next * G::BK);
      issue_b<G>(ns + G::A_FLOATS, b, K, N, contract_last, n0, next * G::BK);
    }
    cp_commit();
    step<PREC, G>(stage, stage + G::A_FLOATS, part);
    acc.fold(part);
  }
  __syncthreads();  // the next tile refills the ring
  finish_tile<PREC, G>(acc, out, M, N, m0, n0, store, corner);
}

// Resident operands: a's blocks [tiles_m][nk] and b's [nk][tiles_n] copied
// into shared memory once a launch, as the TPU kernel holds its operands
// in VMEM; each product reads them in place, and aa += acc[0][0] * 1e-30
// is applied to the staged a itself.
template <int PREC, class G>
__device__ __forceinline__ void resident_products(float* smem, const float* __restrict__ a,
                                                  const float* __restrict__ b,
                                                  float* __restrict__ out, int M, int K, int N,
                                                  int contract_last, int n_ops, float* corner) {
  const int nk = (K + G::BK - 1) / G::BK;
  const int tiles_m = (M + G::BM - 1) / G::BM, tiles_n = (N + G::BN - 1) / G::BN;
  float* bs = smem + tiles_m * nk * G::A_FLOATS;
  for (int mt = 0; mt < tiles_m; ++mt)
    for (int kt = 0; kt < nk; ++kt)
      issue_a<G>(smem + (mt * nk + kt) * G::A_FLOATS, a, M, K, mt * G::BM, kt * G::BK);
  for (int kt = 0; kt < nk; ++kt)
    for (int nt = 0; nt < tiles_n; ++nt)
      issue_b<G>(bs + (kt * tiles_n + nt) * G::B_FLOATS, b, K, N, contract_last, nt * G::BN,
                 kt * G::BK);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  for (int op = 0; op < n_ops; ++op) {
    for (int t = 0; t < tiles_m * tiles_n; ++t) {
      const int mt = t / tiles_n, nt = t % tiles_n;
      Acc<PREC, G> acc, part;
      acc.zero();
      part.zero();
      for (int kt = 0; kt < nk; ++kt) {
        step<PREC, G>(smem + (mt * nk + kt) * G::A_FLOATS, bs + (kt * tiles_n + nt) * G::B_FLOATS,
                      part);
        acc.fold(part);
      }
      finish_tile<PREC, G>(acc, out, M, N, mt * G::BM, nt * G::BN, op == n_ops - 1, corner);
    }
    __syncthreads();
    const float d = *corner * MX_CHAIN;
    for (int mt = 0; mt < tiles_m; ++mt)
      for (int kt = 0; kt < nk; ++kt)
        shift_own<G>(smem + (mt * nk + kt) * G::A_FLOATS, M, K, mt * G::BM, kt * G::BK, d);
    __syncthreads();  // the shifted a, and `corner` read by all
  }
}

// The shared memory the resident layout takes.
template <class G>
static size_t resident_bytes(int M, int K, int N) {
  const size_t nk = (K + G::BK - 1) / G::BK;
  const size_t tiles_m = (M + G::BM - 1) / G::BM, tiles_n = (N + G::BN - 1) / G::BN;
  return (tiles_m * nk * G::A_FLOATS + nk * tiles_n * G::B_FLOATS) * sizeof(float);
}

template <int PREC, class G>
__global__ void __launch_bounds__(MX_THREADS)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
              int M, int K, int N, int contract_last, int n_ops, int resident) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float corner;
  const long long cta = blockIdx.x;  // its own copy of the operands
  a += cta * M * K;
  b += cta * K * N;
  out += cta * M * N;
  if (resident) {
    resident_products<PREC, G>(smem, a, b, out, M, K, N, contract_last, n_ops, &corner);
    return;
  }
  const int tiles_n = (N + G::BN - 1) / G::BN;
  const int tiles = (M + G::BM - 1) / G::BM * tiles_n;
  float shift = 0.0f;
  for (int op = 0; op < n_ops; ++op) {
    for (int t = 0; t < tiles; ++t)
      streamed_tile<PREC, G>(smem, a, b, out, M, K, N, contract_last, t / tiles_n * G::BM,
                             t % tiles_n * G::BN, shift, op == n_ops - 1, &corner);
    __syncthreads();
    // aa += acc[0][0] * 1e-30, as one running shift of the staged a; the
    // next write of `corner` comes after the next product's first barrier,
    // so every thread has read it
    shift += corner * MX_CHAIN;
  }
}

template <int PREC, class G>
static int launch_matmul(const float* a, const float* b, float* out, int M, int K, int N,
                         int contract_last, int n_ops, int ctas, cudaStream_t st) {
  const size_t res = resident_bytes<G>(M, K, N);
  const int resident = res <= MX_RESIDENT_BYTES;
  const size_t smem = resident ? res : (size_t)MX_STAGES * G::STAGE * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(matmul_kernel<PREC, G>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  matmul_kernel<PREC, G><<<ctas, MX_THREADS, smem, st>>>(a, b, out, M, K, N, contract_last, n_ops,
                                                          resident);
  return (int)cudaGetLastError();
}

template <int PREC>
static int dispatch_tile(const float* a, const float* b, float* out, int M, int K, int N,
                         int contract_last, int n_ops, int ctas, cudaStream_t st) {
  const bool k8 = K % 32 != 0;
#define MX_GO(G) launch_matmul<PREC, G>(a, b, out, M, K, N, contract_last, n_ops, ctas, st)
  if (N <= 16) return k8 ? MX_GO(NarrowK8) : MX_GO(Narrow);
  if (M <= 16) return k8 ? MX_GO(FlatK8) : MX_GO(Flat);
  return k8 ? MX_GO(WideK8) : MX_GO(Wide);
#undef MX_GO
}

// a [ctas, M, K], b [ctas, K, N] (or [ctas, N, K] with contract_last), out
// [ctas, M, N]: one CTA per copy. Returns the cudaError_t of the launch, or
// -1 for an unknown precision.
extern "C" int probes_matmul(const void* a, const void* b, void* out, int M, int K, int N,
                             int contract_last, int prec, int n_ops, int ctas,
                             void* cuda_stream) {
  const float* A = (const float*)a;
  const float* B = (const float*)b;
  float* O = (float*)out;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  switch (prec) {
    case PREC_HIGHEST: return dispatch_tile<PREC_HIGHEST>(A, B, O, M, K, N, contract_last, n_ops, ctas, st);
    case PREC_DEFAULT: return dispatch_tile<PREC_DEFAULT>(A, B, O, M, K, N, contract_last, n_ops, ctas, st);
    case PREC_HIGH: return dispatch_tile<PREC_HIGH>(A, B, O, M, K, N, contract_last, n_ops, ctas, st);
    default: return -1;
  }
}

#define RL_MAX_THREADS 512

struct Shifts {
  int s[8];
};

// PER elements a thread; the CTA's slab is blockDim.x * PER elements
// (rows of 2^log_lanes).
template <int PER>
__global__ void __launch_bounds__(RL_MAX_THREADS)
roll_kernel(const float* __restrict__ x, float* __restrict__ o, int log_lanes, int row_mask,
            int axis, int n, Shifts sh) {
  extern __shared__ float buf[];
  __shared__ int s_shift[8];
  if (threadIdx.x < 8) s_shift[threadIdx.x] = sh.s[threadIdx.x];
  const int lane_mask = (1 << log_lanes) - 1;
  const long long base = (long long)blockIdx.x * PER * blockDim.x;
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    buf[i] = x[base + i];
  }
  __syncthreads();
  for (int step = 0; step < 8 * n; ++step) {
    const int s = s_shift[step & 7];
    float nv[PER];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int i = threadIdx.x + q * blockDim.x;
      const int r = i >> log_lanes, c = i & lane_mask;
      const int src = axis ? (r << log_lanes) | ((c - s) & lane_mask)
                           : (((r - s) & row_mask) << log_lanes) | c;
      const float m = buf[src], v = buf[i];
      nv[q] = m > v ? m : v * 0.999999f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER; ++q) buf[threadIdx.x + q * blockDim.x] = nv[q];
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int i = threadIdx.x + q * blockDim.x;
    o[base + i] = buf[i];
  }
}

template <int PER>
static int launch_roll(const float* x, float* o, int ctas, int slab, int log_lanes, int row_mask,
                       int axis, int n, Shifts sh, cudaStream_t st) {
  const size_t smem = (size_t)slab * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(roll_kernel<PER>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  roll_kernel<PER><<<ctas, slab / PER, smem, st>>>(x, o, log_lanes, row_mask, axis, n, sh);
  return (int)cudaGetLastError();
}

// x, o [rows, 2^log_lanes] float32; axis 1 rolls each row (one CTA a
// row), axis 0 the rows (one CTA; rows a power of two). shifts: 8 ints in
// [0, the axis' size). Returns the cudaError_t, or -1 for a slab the
// kernel does not take (under 512 floats or over 2^15, or rows not a
// power of two along axis 0).
extern "C" int probes_roll(const void* x, void* o, int rows, int log_lanes, int axis, int n,
                           const int* shifts, void* cuda_stream) {
  Shifts sh;
  for (int u = 0; u < 8; ++u) sh.s[u] = shifts[u];
  if (!axis && (rows & (rows - 1))) return -1;
  const long long slab = axis ? 1LL << log_lanes : (long long)rows << log_lanes;
  const int ctas = axis ? rows : 1;
  const float* X = (const float*)x;
  float* O = (float*)o;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  if (slab < 512 || slab > (1 << 15)) return -1;
  const int sl = (int)slab;
  if (sl <= 16 * RL_MAX_THREADS) return launch_roll<16>(X, O, ctas, sl, log_lanes, rows - 1, axis, n, sh, st);
  if (sl <= 32 * RL_MAX_THREADS) return launch_roll<32>(X, O, ctas, sl, log_lanes, rows - 1, axis, n, sh, st);
  return launch_roll<64>(X, O, ctas, sl, log_lanes, rows - 1, axis, n, sh, st);
}
