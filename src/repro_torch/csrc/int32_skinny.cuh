// modmatmul_int32_skinny<MAXM, MASKED>: exact GF(p) products with few
// rows and a shallow contraction, the fused mask included.
//
//   out[b] = a[b] @ b_[b] (+ v @ R(key))  (mod p)
//   a [M, K], M <= 32, K <= 32;  b_ [K, N], N up to millions
//
// Replaces, for these shapes, two Pallas tile bodies of the JAX package
// (src/repro/kernels/modmatmul/kernel.py):
//
//   _modmatmul_int32_kernel  (kernel.py:152)  the limb dot and Barrett
//   _apply_fused_mask        (kernel.py:193)  the in-kernel v @ R(key)
//
// The protocol's Phase-1 share, Phase-2 mix/noise and Phase-3 decode
// products are all of this kind: a small public matrix (17 x 6, 17 x 17,
// 17 x 2, 6 x 6) against a batch of wide operands.
//
// What bounds it on the H100: bytes.  Each B element is used by only M
// multiply-adds, so the kernel reads B once and writes `out` once, and
// must do so at the memory rate.  At Phase-1 share B ([17, 6] @ [4, 6,
// 5242880]) that is 0.50 GB read and 1.43 GB written: 0.576 ms at 3.35
// TB/s.  The arithmetic must stay below that on the 32-bit integer
// pipe (64 lanes per SM per clock, about 16.7 T ops/s on 132 SMs), so a
// Barrett reduction per multiply-add (five ops) is too dear.
//
// The design.  Every block loads the whole coefficient matrix (A, and v
// for the mask) once into shared memory, each coefficient c as one word
// holding the two 16-bit halves (c, 256*c mod p).  Each thread owns COLS
// consecutive columns and reads each of its K rows of B as one 8- or
// 16-byte load.  A value b < 2**16 is its own limb pair: byte 0 is
// bl = b & 255 and byte 1 is bh = b >> 8.  So one dp2a.lo,
//
//     acc = dp2a_lo((256c mod p) << 16 | c, b, acc)
//         = acc + c * bl + (256c mod p) * bh     (one instruction)
//
// adds a term congruent to c*b.  Each term is at most 2 * 65520 * 255 =
// 33_415_200, so 128 of them stay below 2**32 (128 * 33_415_200 =
// 4_277_145_600): the accumulators are reduced once, at the end, and the
// cap is K + z <= SKINNY_MAX_TERMS = 128.
//
// All M outputs of a column stay in registers; each output row is
// written once, coalesced.  The rows are padded with zero coefficients
// to MAXM, a multiple of 4, and computed without a branch: four rows'
// coefficients are one 16-byte shared load, and the loads can be
// scheduled ahead of their use.  The grid is (column blocks, batch): no
// barrier after the coefficient load.  A thread starts the loads of up to
// KCHUNK rows of B before it uses any, so several are in flight.
//
// The mask as z more rows of B.  v @ R is [M, z] @ [z, N]: each thread
// makes the threefry word of each (mask row, owned column) once, reduces
// it, and accumulates it with coefficients v like a loaded row.  The
// COLS x z chains of one thread are independent, and at two or more
// resident blocks per SM other warps hide their latency.
#pragma once

#include "common.cuh"

namespace gfmm {

constexpr int SKINNY_THREADS = 256;
constexpr int SKINNY_MAX_M = 32;
constexpr int SKINNY_MAX_K = 32;
constexpr int SKINNY_MAX_TERMS = 128;  // K + z
static_assert((unsigned long long)SKINNY_MAX_TERMS * 2ull * 65520ull * 255ull < (1ull << 32),
              "the skinny kernel's uint32 accumulators would wrap");

// Columns a thread owns: the accumulators take MAXM * COLS registers.
template <int MAXM>
struct SkinnyCols {
  static constexpr int value = MAXM <= 16 ? 4 : 2;
};

template <int COLS>
struct IntVec;
template <>
struct IntVec<2> {
  using T = int2;
};
template <>
struct IntVec<4> {
  using T = int4;
};

template <int COLS>
__device__ __forceinline__ void load_cols(const int* p, uint32_t (&x)[COLS]) {
  const typename IntVec<COLS>::T w = __ldcs(reinterpret_cast<const typename IntVec<COLS>::T*>(p));
  const int* e = reinterpret_cast<const int*>(&w);
#pragma unroll
  for (int j = 0; j < COLS; ++j) x[j] = (uint32_t)e[j];
}

template <int COLS>
__device__ __forceinline__ void store_cols(int* p, const uint32_t (&x)[COLS]) {
  typename IntVec<COLS>::T w;
  int* e = reinterpret_cast<int*>(&w);
#pragma unroll
  for (int j = 0; j < COLS; ++j) e[j] = (int)x[j];
  __stcs(reinterpret_cast<typename IntVec<COLS>::T*>(p), w);
}

// vec: N % COLS == 0 and b, out aligned to COLS ints (the launcher
// checks), so whole column groups move as one vector access.
template <int MAXM, bool MASKED>
__global__ void __launch_bounds__(SKINNY_THREADS)
    modmatmul_int32_skinny(const Params P, const bool vec) {
  static_assert(MAXM % 4 == 0, "rows are read four at a time");
  constexpr int COLS = SkinnyCols<MAXM>::value;
  constexpr int KCHUNK = 16 / COLS;  // rows of B a thread loads before using them
  extern __shared__ uint4 coef[];    // [K + z][MAXM / 4]: 4 packed (c, 256c mod p)
  const int M = P.M, N = P.N, K = P.K;
  const int T = K + (MASKED ? P.z : 0);
  const int bb = blockIdx.y;
  const int* __restrict__ a = P.a + (size_t)bb * (size_t)P.a_bs;
  uint32_t* coef_w = reinterpret_cast<uint32_t*>(coef);
  for (int i = threadIdx.x; i < T * MAXM; i += SKINNY_THREADS) {
    const int t = i / MAXM, m = i % MAXM;
    uint32_t c = 0u;  // padding rows contribute nothing
    if (m < M)
      c = t < K ? (uint32_t)a[(size_t)m * K + t] : (uint32_t)P.v[(size_t)m * P.z + (t - K)];
    coef_w[i] = c | (barrett(c << 8, P.p, P.mu) << 16);  // c < 2**16
  }
  __syncthreads();

  const long long col0 = ((long long)blockIdx.x * SKINNY_THREADS + threadIdx.x) * COLS;
  if (col0 >= N) return;
  const bool full = vec && col0 + COLS <= N;
  uint32_t acc[MAXM][COLS];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[m][j] = 0u;

  // x[j] < p: a value of B or a mask word
  auto accumulate = [&](int t, const uint32_t(&x)[COLS]) {
    const uint4* ct = coef + t * (MAXM / 4);
#pragma unroll
    for (int q = 0; q < MAXM / 4; ++q) {
      const uint4 c = ct[q];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        acc[4 * q + 0][j] = __dp2a_lo(c.x, x[j], acc[4 * q + 0][j]);
        acc[4 * q + 1][j] = __dp2a_lo(c.y, x[j], acc[4 * q + 1][j]);
        acc[4 * q + 2][j] = __dp2a_lo(c.z, x[j], acc[4 * q + 2][j]);
        acc[4 * q + 3][j] = __dp2a_lo(c.w, x[j], acc[4 * q + 3][j]);
      }
    }
  };

  const int* __restrict__ b = P.b + (size_t)bb * (size_t)P.b_bs + col0;
  for (int k0 = 0; k0 < K; k0 += KCHUNK) {
    uint32_t x[KCHUNK][COLS];
#pragma unroll
    for (int kk = 0; kk < KCHUNK; ++kk) {
      if (k0 + kk < K) {
        const int* row = b + (size_t)(k0 + kk) * N;
        if (full) {
          load_cols<COLS>(row, x[kk]);
        } else {
#pragma unroll
          for (int j = 0; j < COLS; ++j) x[kk][j] = col0 + j < N ? (uint32_t)row[j] : 0u;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < KCHUNK; ++kk)
      if (k0 + kk < K) accumulate(k0 + kk, x[kk]);
  }
  if constexpr (MASKED) {
    for (int zi = 0; zi < P.z; ++zi) {
      uint32_t x[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        x[j] = col0 + j < N ? mask_word(P, (uint32_t)bb, (uint32_t)zi, (uint32_t)(col0 + j)) : 0u;
      accumulate(K + zi, x);
    }
  }

  int* __restrict__ out = P.out + (size_t)bb * (size_t)M * (size_t)N + col0;
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < M) {
      uint32_t r[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) r[j] = barrett(acc[m][j], P.p, P.mu);
      int* dst = out + (size_t)m * N;
      if (full) {
        store_cols<COLS>(dst, r);
      } else {
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          if (col0 + j < N) dst[j] = (int)r[j];
      }
    }
  }
}

template <int MAXM, bool MASKED>
cudaError_t launch_skinny(const Params& P, int batch, cudaStream_t stream) {
  constexpr int COLS = SkinnyCols<MAXM>::value;
  const long long span = (long long)SKINNY_THREADS * COLS;
  const bool vec = P.N % COLS == 0 && P.b_bs % COLS == 0 &&
                   (reinterpret_cast<uintptr_t>(P.b) | reinterpret_cast<uintptr_t>(P.out)) %
                           (sizeof(int) * COLS) ==
                       0;
  const int terms = P.K + (MASKED ? P.z : 0);
  const size_t smem = sizeof(uint32_t) * (size_t)terms * MAXM;  // <= 16 KB
  dim3 grid((unsigned)((P.N + span - 1) / span), batch);
  modmatmul_int32_skinny<MAXM, MASKED><<<grid, SKINNY_THREADS, smem, stream>>>(P, vec);
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t launch_skinny_rows(const Params& P, int batch, cudaStream_t stream) {
  switch ((P.M + 3) / 4) {  // M rounded up to a multiple of 4
    case 1: return launch_skinny<4, MASKED>(P, batch, stream);
    case 2: return launch_skinny<8, MASKED>(P, batch, stream);
    case 3: return launch_skinny<12, MASKED>(P, batch, stream);
    case 4: return launch_skinny<16, MASKED>(P, batch, stream);
    case 5: return launch_skinny<20, MASKED>(P, batch, stream);
    case 6: return launch_skinny<24, MASKED>(P, batch, stream);
    case 7: return launch_skinny<28, MASKED>(P, batch, stream);
    case 8: return launch_skinny<32, MASKED>(P, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gfmm
