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
// with contract_last (a @ b^T). Precisions, as a TPU's map onto this card:
//   HIGHEST -> FP32 SIMT (the tensor cores have no FP32 mode);
//   DEFAULT -> one TF32 pass on the tensor cores, operands rounded by
//              cvt.rna.tf32.f32 (the tensor cores would truncate them);
//   HIGH    -> 3xTF32: x = big + small (both TF32), the product
//              small*big + big*small + big*big (bf16_3x's counterpart).
// Each k-tile of 32 is summed into a fresh partial that is then added to
// the float32 accumulator, so long contractions (K 4096) do not lose a
// chain of K roundings (or the tensor cores' truncating adds) against the
// plain versions. One CTA computes a whole product, tile by tile, as the
// TPU kernel is one program on one core: that gives a per-SM rate.
// Launched with one CTA per SM on replicated operands (a [ctas, M, K], b
// and out likewise), the same code gives the chip's rate.
//
// The design (`probes_matmul`, `wgmma_matmul_kernel` / `simt_matmul_kernel`):
// a CTA of two warpgroups takes output tiles of 128 rows x BN columns
// (BN 8, 16 or 128: the smallest of them that holds N, N = 3 in 8). Its
// operands' k-tiles of 32 floats are one 128-byte row each in shared
// memory, K-major, in the 128-byte swizzle (16-byte chunk c of row r at
// r * 128 + (c ^ r % 8) * 16), the layout a `wgmma` descriptor reads (SBO
// 1024 bytes, a k8 step +32 bytes on its start address). While the
// tensor cores (or the FMA pipe) take k-tile kt, every thread adds the
// chain's shift to a's elements of k-tile kt + 1 (held in registers),
// rounds them to TF32 (3xTF32: splits them into big and small),
// stores them into the other of two stages, and then issues the loads of
// the k-tile due in those registers next (two register sets on the tensor
// cores, k-tiles kt + 2 and kt + 3 in flight; one for FP32, whose blocks
// take the registers), predicated loads only, so none waits for its data
// before that store. b [K, N] (no contract_last) goes in
// transposed, each warp on 4 k and a lane a column, since TF32 `wgmma`
// takes K-major operands only. A `fence.proxy.async` makes those stores
// visible to `wgmma`. TF32 and 3xTF32: each warpgroup runs
// `wgmma.mma_async m64nBNk8` on its 64 rows, 4 k-steps a k-tile (3
// `wgmma`s a step for 3xTF32) into a partial of BN / 2 registers (scale-d
// 0 on the k-tile's first), folded into the accumulator when it is done.
// FP32: each thread a block of 8 rows x BN / 16 columns (rows 8 ty.., the
// columns tx + 16 j), reading 4 k at a time as 16-byte chunks of both
// operands' rows (16 FMAs a chunk read). M 16 (and N > 16) runs as the
// transposed product out^T = b^T a^T, so the 64-row tiles fill; the
// padding (rows, columns, and k past K, all zeros) never reaches the
// output. K % 4 == 0. Nothing stays resident between products: a and b
// come from L2 again for every one.
// Bound: operations, 2 M K N a product at the per-SM peak of the type
// (FP32 67 TFLOP/s, TF32 495 TFLOP/s dense, over 132 SMs; 3xTF32 three TF32
// passes). What binds first on one SM is its feed from L2: at [512]^3 a
// CTA's 16 output tiles re-read a and b, 8 MB a product (a 32 KB k-tile
// for every 1 M multiply-adds), and the loads of a k-tile, not the
// `wgmma`s, set the k-loop's pace (PERF.md); FP32 is bound by its FMA
// and shared-memory pipes.
//
// The design before (`probes_matmul_v1`, `matmul_kernel`): one CTA of 256
// threads, TF32 and 3xTF32 on `mma.sync.m16n8k8`, FP32 as 4x4 fmaf blocks
// a thread; operands whose tiles fit in 200 KB of shared memory
// ([128,128]@[128,16], [16,128]@[128,256], [256,8]@[8,256]) copied there
// once a launch, as the TPU kernel holds them in VMEM, each product's
// aa += ... applied to them in place; larger ones streamed from L2 through
// a ring of 4 shared-memory stages by cp.async (16 bytes a copy), three
// k-tiles in flight while one is multiplied, the running shift added to
// each staged element of a; TF32 operands rounded as the mma fragments are
// read; M, N and K padded with zeros to the tile inside the kernel (N 3
// and 16 to 16, K 8 stays 8). Kept for `chip_smoke.py`'s comparisons.
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
extern "C" int probes_matmul_v1(const void* a, const void* b, void* out, int M, int K, int N,
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

// ---- the design: wgmma (TF32, 3xTF32) and an 8x8-a-thread SIMT (FP32) ----

#define WG_THREADS 256  // two warpgroups
#define WG_BM 128       // output rows a tile: 64 a warpgroup
#define WG_ROW 128      // bytes of a staged row: a k-tile of 32 floats

// The byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
// (its base 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int r, int c) { return r * WG_ROW + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ void sts128(uint32_t addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x), "f"(v.y),
               "f"(v.z), "f"(v.w)
               : "memory");
}
__device__ __forceinline__ float4 lds128(uint32_t addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ float4 tf32x4(float4 v) {
  return make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z), to_tf32(v.w));
}

// A wgmma shared-memory descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (SBO), the leading offset unused (a k-tile is
// one swizzle row wide).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the generic-proxy stores of a stage become visible to wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator registers across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// part (+)= A B on one m64n8k8 TF32 step, operands in shared memory.
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(scale_d));
}

// part (+)= A B on one m64n16k8 TF32 step, operands in shared memory.
__device__ __forceinline__ void wgmma_n16(float (&d)[8], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// part (+)= A B on one m64n128k8 TF32 step, operands in shared memory.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (BN == 8) wgmma_n8(d, da, db, scale_d);
  else if constexpr (BN == 16) wgmma_n16(d, da, db, scale_d);
  else wgmma_n128(d, da, db, scale_d);
}

// One operand of the product as the tile loop reads it: rows (the
// product's M or N) of K floats, K-major (element (r, k) at p[r ld + k]:
// a, and b with contract_last) or not (at p[k ld + r]: b [K, N]); a's
// elements get the chain's shift.
struct Operand {
  const float* p;
  int rows, ld, kmajor, shifted;
};

// The (row, 16-byte chunk) of a tile of R rows that item j of this thread
// loads and stores: K-major, 8 threads a row, a float4 each; else a warp
// a chunk (4 k), a lane a row.
__device__ __forceinline__ void item(int kmajor, int j, int& r, int& c) {
  if (kmajor) {
    const int i = threadIdx.x + WG_THREADS * j;
    r = i >> 3, c = i & 7;
  } else {
    r = (threadIdx.x & 31) + 32 * j, c = threadIdx.x >> 5;
  }
}

template <int R>
struct Staged {
  static constexpr int N = R >= 32 ? R / 32 : 1;  // float4 items a thread
  float4 v[N];

  // k-tile k0 of rows row0.. into registers, zeros past the operand's rows
  // and K: predicated loads only, so none waits for its data before
  // `store` needs it
  __device__ __forceinline__ void load(const Operand& o, int row0, int k0, int K) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int r, c;
      item(o.kmajor, j, r, c);
      const int row = row0 + r, k = k0 + 4 * c;
      const bool live = r < R && row < o.rows;
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (o.kmajor) {
        if (live && k < K) x = __ldg(reinterpret_cast<const float4*>(o.p + (long long)row * o.ld + k));
      } else {
        const float* q = o.p + (long long)k * o.ld + row;
        if (live && k < K) x.x = __ldg(q);
        if (live && k + 1 < K) x.y = __ldg(q + o.ld);
        if (live && k + 2 < K) x.z = __ldg(q + 2 * o.ld);
        if (live && k + 3 < K) x.w = __ldg(q + 3 * o.ld);
      }
      v[j] = x;
    }
  }

  // into the stage's tile at `big` (and `small`), a's elements plus the
  // chain's shift (a is K-major: a float4 is all inside K or all past
  // it): as they are (FP32), rounded to TF32, or split into TF32 big and
  // small
  template <int PREC>
  __device__ __forceinline__ void store(const Operand& o, int row0, int k0, int K, float shift,
                                        uint32_t big, uint32_t small) const {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      int r, c;
      item(o.kmajor, j, r, c);
      if (r >= R) continue;
      float4 x = v[j];
      if (o.shifted && row0 + r < o.rows && k0 + 4 * c < K)
        x = make_float4(x.x + shift, x.y + shift, x.z + shift, x.w + shift);
      const uint32_t at = sw128(r, c);
      if constexpr (PREC == PREC_HIGHEST) {
        sts128(big + at, x);
      } else {
        const float4 b = tf32x4(x);
        sts128(big + at, b);
        if constexpr (PREC == PREC_HIGH)
          sts128(small + at, tf32x4(make_float4(x.x - b.x, x.y - b.y, x.z - b.z, x.w - b.w)));
      }
    }
  }
};

// The shared memory of a stage: [A big | B big] (+ [A small | B small]
// for 3xTF32), each tile 1024-byte aligned.
template <int PREC, int BN>
struct Layout {
  static constexpr int A = WG_BM * WG_ROW, B = BN * WG_ROW;
  static constexpr int SPLIT = PREC == PREC_HIGH ? 2 : 1;
  static constexpr int STAGE = SPLIT * (A + B);
  static constexpr int BYTES = 2 * STAGE + 1024;  // + the base's alignment
  static_assert(B % 1024 == 0, "tiles 1024-byte aligned");
};

// FP32: part += a k-tile's first `chunks` chunks of 4 k, each thread its
// 8 x TN block (rows 8 ty + i, columns tx + 16 j).
template <int BN>
__device__ __forceinline__ void simt_ktile(uint32_t sa, uint32_t sb, int chunks,
                                           float (&part)[8 * (BN / 16)]) {
  constexpr int TN = BN / 16;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  for (int c = 0; c < chunks; ++c) {
    float4 bv[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = lds128(sb + sw128(tx + 16 * j, c));
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float4 av = lds128(sa + sw128(ty * 8 + i, c));
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float& p = part[i * TN + j];
        p = fmaf(av.x, bv[j].x, p);
        p = fmaf(av.y, bv[j].y, p);
        p = fmaf(av.z, bv[j].z, p);
        p = fmaf(av.w, bv[j].w, p);
      }
    }
  }
}

// out index of the product's element (r, c): out^T's when transposed
__device__ __forceinline__ long long out_at(int r, int c, int Mp, int Np, int trans) {
  return trans ? (long long)c * Mp + r : (long long)r * Np + c;
}

// One output tile (rows row0.. of A, columns col0.. of B): the k-tiles
// through two register-staged stages, each summed into a fresh partial.
template <int PREC, int BN>
__device__ __forceinline__ void gemm_tile(uint32_t smem, const Operand& A, const Operand& B, int K,
                                          int row0, int col0, float shift, float* __restrict__ out,
                                          int trans, bool store, float* corner) {
  using L = Layout<PREC, BN>;
  constexpr bool TC = PREC != PREC_HIGHEST;
  constexpr int NACC = TC ? BN / 2 : 8 * (BN / 16);
  float acc[NACC], part[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f, part[i] = 0.0f;
  const int nk = (K + 31) / 32;
  const int wg = threadIdx.x >> 7;
  if constexpr (TC) {
    // two register sets: while the tensor cores take k-tile kt, k-tile
    // kt + 1 goes from one set into the other stage and k-tile kt + 3's
    // loads are issued into that set right after; k-tile kt + 2's are on
    // their way in the other set
    Staged<WG_BM> ra0, ra1;
    Staged<BN> rb0, rb1;
    auto put = [&](auto& sa, auto& sb, int kt) {
      const uint32_t base = smem + (kt & 1) * L::STAGE;
      sa.template store<PREC>(A, row0, kt * 32, K, shift, base, base + L::A + L::B);
      sb.template store<PREC>(B, col0, kt * 32, K, shift, base + L::A, base + 2 * L::A + L::B);
    };
    auto fetch = [&](auto& sa, auto& sb, int kt) {
      sa.load(A, row0, kt * 32, K);
      sb.load(B, col0, kt * 32, K);
    };
    auto iter = [&](int kt, auto& sa, auto& sb) {
      const uint32_t base = smem + (kt & 1) * L::STAGE;
      const int steps = min(4, (K - kt * 32 + 7) / 8);
      const uint64_t a_big = gmma_desc(base + wg * 64 * WG_ROW), b_big = gmma_desc(base + L::A);
      const uint64_t a_small = gmma_desc(base + L::A + L::B + wg * 64 * WG_ROW);
      const uint64_t b_small = gmma_desc(base + 2 * L::A + L::B);
      fence_regs(part);
      wgmma_fence();
      for (int s = 0; s < steps; ++s) {
        const uint64_t o = 2 * s;  // +32 bytes on the start address
        if constexpr (PREC == PREC_HIGH) {
          wgmma_step<BN>(part, a_small + o, b_big + o, s > 0);
          wgmma_step<BN>(part, a_big + o, b_small + o, 1);
          wgmma_step<BN>(part, a_big + o, b_big + o, 1);
        } else {
          wgmma_step<BN>(part, a_big + o, b_big + o, s > 0);
        }
      }
      wgmma_commit();
      if (kt + 1 < nk) {
        put(sa, sb, kt + 1);
        fence_proxy_async();
      }
      if (kt + 3 < nk) fetch(sa, sb, kt + 3);
      wgmma_wait0();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += part[i];
      __syncthreads();
    };
    fetch(ra0, rb0, 0);
    put(ra0, rb0, 0);
    if (nk > 1) fetch(ra1, rb1, 1);
    if (nk > 2) fetch(ra0, rb0, 2);
    fence_proxy_async();
    __syncthreads();
    for (int kt = 0; kt < nk; kt += 2) {
      iter(kt, ra1, rb1);
      if (kt + 1 < nk) iter(kt + 1, ra0, rb0);
    }
  } else {
    // one register set (the FP32 blocks take the registers): k-tile kt + 1
    // goes into the other stage after the FMAs of k-tile kt, and k-tile
    // kt + 2's loads are issued right after
    Staged<WG_BM> ra;
    Staged<BN> rb;
    auto put = [&](int kt) {
      const uint32_t base = smem + (kt & 1) * L::STAGE;
      ra.template store<PREC>(A, row0, kt * 32, K, shift, base, base + L::A + L::B);
      rb.template store<PREC>(B, col0, kt * 32, K, shift, base + L::A, base + 2 * L::A + L::B);
    };
    auto fetch = [&](int kt) {
      ra.load(A, row0, kt * 32, K);
      rb.load(B, col0, kt * 32, K);
    };
    fetch(0);
    put(0);
    if (nk > 1) fetch(1);
    __syncthreads();
    for (int kt = 0; kt < nk; ++kt) {
      const uint32_t base = smem + (kt & 1) * L::STAGE;
      simt_ktile<BN>(base, base + L::A, min(8, (K - kt * 32 + 3) / 4), part);
#pragma unroll
      for (int i = 0; i < NACC; ++i) acc[i] += part[i], part[i] = 0.0f;
      if (kt + 1 < nk) put(kt + 1);
      if (kt + 2 < nk) fetch(kt + 2);
      __syncthreads();
    }
  }
  // the product's (0, 0): thread 0's first accumulator in both layouts
  if (row0 == 0 && col0 == 0 && threadIdx.x == 0) *corner = acc[0];
  if (!store) return;
  const int Mp = A.rows, Np = B.rows;
  if constexpr (TC) {
    // wgmma's accumulator: register 4 j + e of a warpgroup's thread t holds
    // row 16 (t / 32) + (t % 32) / 4 + 8 (e / 2), column 8 j + 2 (t % 4) + e % 2
    const int t = threadIdx.x & 127;
    const int r = row0 + wg * 64 + (t >> 5) * 16 + ((t & 31) >> 2);
#pragma unroll
    for (int i = 0; i < NACC; ++i) {
      const int rr = r + 8 * ((i >> 1) & 1), cc = col0 + 8 * (i >> 2) + 2 * (t & 3) + (i & 1);
      if (rr < Mp && cc < Np) out[out_at(rr, cc, Mp, Np, trans)] = acc[i];
    }
  } else {
    const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        const int rr = row0 + ty * 8 + i, cc = col0 + tx + 16 * j;
        if (rr < Mp && cc < Np) out[out_at(rr, cc, Mp, Np, trans)] = acc[i * (BN / 16) + j];
      }
  }
}

// n_ops chained products a @ b on one CTA per copy of the operands (the
// kernel's name tells the tensor-core instantiations from the SIMT ones).
template <int PREC, int BN>
__device__ __forceinline__ void matmul_chain(const float* __restrict__ a, const float* __restrict__ b,
                                             float* __restrict__ out, int M, int K, int N,
                                             int contract_last, int trans, int n_ops) {
  extern __shared__ float4 smem4[];
  __shared__ float corner;
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem4);
  const uint32_t smem = (raw + 1023) & ~1023u;
  const long long cta = blockIdx.x;  // its own copy of the operands
  a += cta * M * K;
  b += cta * K * N;
  out += cta * M * N;
  const Operand oa{a, M, K, 1, 1}, ob{b, N, contract_last ? K : N, contract_last, 0};
  const Operand& A = trans ? ob : oa;
  const Operand& B = trans ? oa : ob;
  const int tiles_n = (B.rows + BN - 1) / BN;
  const int tiles = (A.rows + WG_BM - 1) / WG_BM * tiles_n;
  float shift = 0.0f;
  for (int op = 0; op < n_ops; ++op) {
    for (int t = 0; t < tiles; ++t)
      gemm_tile<PREC, BN>(smem, A, B, K, t / tiles_n * WG_BM, t % tiles_n * BN, shift, out, trans,
                          op == n_ops - 1, &corner);
    __syncthreads();
    // aa += out[0][0] * 1e-30, as one running shift of a's staged elements;
    // the next write of `corner` comes after the next product's first
    // barrier, so every thread has read it
    shift += corner * MX_CHAIN;
  }
}

template <int PREC, int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
wgmma_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
                    int M, int K, int N, int contract_last, int trans, int n_ops) {
  matmul_chain<PREC, BN>(a, b, out, M, K, N, contract_last, trans, n_ops);
}

template <int BN>
__global__ void __launch_bounds__(WG_THREADS, 1)
simt_matmul_kernel(const float* __restrict__ a, const float* __restrict__ b, float* __restrict__ out,
                   int M, int K, int N, int contract_last, int trans, int n_ops) {
  matmul_chain<PREC_HIGHEST, BN>(a, b, out, M, K, N, contract_last, trans, n_ops);
}

template <int PREC, int BN>
static int launch_chain(const float* a, const float* b, float* out, int M, int K, int N,
                        int contract_last, int trans, int n_ops, int ctas, cudaStream_t st) {
  auto kernel = [] {
    if constexpr (PREC == PREC_HIGHEST) return simt_matmul_kernel<BN>;
    else return wgmma_matmul_kernel<PREC, BN>;
  }();
  const int smem = Layout<PREC, BN>::BYTES;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<ctas, WG_THREADS, smem, st>>>(a, b, out, M, K, N, contract_last, trans, n_ops);
  return (int)cudaGetLastError();
}

template <int PREC>
static int dispatch_bn(const float* a, const float* b, float* out, int M, int K, int N,
                       int contract_last, int trans, int bn, int n_ops, int ctas, cudaStream_t st) {
  switch (bn) {
    case 8:
      if constexpr (PREC == PREC_HIGHEST) return -1;
      else return launch_chain<PREC, 8>(a, b, out, M, K, N, contract_last, trans, n_ops, ctas, st);
    case 16: return launch_chain<PREC, 16>(a, b, out, M, K, N, contract_last, trans, n_ops, ctas, st);
    case 128: return launch_chain<PREC, 128>(a, b, out, M, K, N, contract_last, trans, n_ops, ctas, st);
    default: return -1;
  }
}

// a [ctas, M, K], b [ctas, K, N] (or [ctas, N, K] with contract_last), out
// [ctas, M, N]: one CTA per copy. trans runs the product as out^T = b^T
// a^T; bn is the tile's columns (8 TF32 only, 16, 128), K % 4 == 0 (the
// plan of `probes/mxu.py::plan`). Returns the cudaError_t of the launch, or
// -1 for a precision, bn or K the kernel does not take.
extern "C" int probes_matmul(const void* a, const void* b, void* out, int M, int K, int N,
                             int contract_last, int prec, int trans, int bn, int n_ops, int ctas,
                             void* cuda_stream) {
  const float* A = (const float*)a;
  const float* B = (const float*)b;
  float* O = (float*)out;
  cudaStream_t st = (cudaStream_t)cuda_stream;
  if (K % 4) return -1;
  switch (prec) {
    case PREC_HIGHEST: return dispatch_bn<PREC_HIGHEST>(A, B, O, M, K, N, contract_last, trans, bn, n_ops, ctas, st);
    case PREC_DEFAULT: return dispatch_bn<PREC_DEFAULT>(A, B, O, M, K, N, contract_last, trans, bn, n_ops, ctas, st);
    case PREC_HIGH: return dispatch_bn<PREC_HIGH>(A, B, O, M, K, N, contract_last, trans, bn, n_ops, ctas, st);
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
