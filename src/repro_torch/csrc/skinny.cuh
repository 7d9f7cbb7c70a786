// modmatmul_int32_skinny<MAXM, MASKED> and modmatmul_f32_skinny<MAXM,
// MASKED>: exact GF(p) products with few rows and a shallow contraction,
// the fused mask included.
//
//   out[b] = a[b] @ b_[b] (+ v @ R(key))  (mod p)
//   a [M, K], M <= 32, K <= 32;  b_ [K, N], N up to millions
//
// The loaded-terms forms: the same body with z rows loaded from memory
// in place of the mask words, and B's K terms read in place from a
// larger operand x.  Term k < K is block k of x: output column n of it
// is the element
//
//   x[b][off[k] + (n / bc) * ld + n % bc]
//
// with off [K] per-term element offsets (int64, on the device), bc the
// block's width and ld x's row stride; term K + i is row i of r [z, N].
//
//   modmatmul_{int32,f32}_skinny_blocks_plus<MAXM>:
//     out[b] = a[b] @ blocks_off(x[b]) + v @ r[b]  (mod p)
//   The Phase-1 share, F = V[:, pos] @ blocks + V[:, spos] @ R, in one
//   pass: the t*s data blocks of A^T or B are read where they lie (no
//   permute copy, no zero-filled coefficient stack, no scatter), the z
//   secrets as loaded rows.
//
//   modmatmul_{int32,f32}_skinny_rows_plus<MAXM>:
//     out[b] = a[b] @ h[b][rows] + v @ r[b]  (mod p)
//   The special case bc = ld = N, off[k] = rows[k] * N: whole rows picked
//   from a taller h by index.  The Phase-2 degree reduction, I = mix.T @
//   H[ids2] + Vnoise @ R_sum, in one pass: H's selected rows are read in
//   place (no gather copy), and the two terms meet in the accumulators
//   (no second output to add).
//
// Replace, for these shapes, the Pallas tile bodies of the JAX package
// (src/repro/kernels/modmatmul/kernel.py):
//
//   _modmatmul_int32_kernel  (kernel.py:152)  the int32 variant: limb dot and Barrett
//   _modmatmul_kernel        (kernel.py:101)  the f32 variant: float limb dots
//   _apply_fused_mask        (kernel.py:193)  the in-kernel v @ R(key), both variants
//
// The protocol's Phase-1 share, Phase-2 mix/noise and Phase-3 decode
// products are all of this kind: a small public matrix (17 x 6, 17 x 17,
// 17 x 2, 6 x 6) against a batch of wide operands.
//
// What bounds it on the H100: bytes.  Each B element is used by only M
// multiply-adds, so the kernel reads B once and writes `out` once, and
// must do so at the memory rate.  At Phase-1 share B ([17, 6] @ [4, 6,
// 5242880]) that is 0.50 GB read and 1.43 GB written: 0.576 ms at 3.35
// TB/s.  The arithmetic must stay below that.  The f32 form at P2 mix is
// near the ridge: 4 * 17 * 17 * 4 * 524_288 = 2.4 G FFMA is 0.072 ms at
// 33.5 T FFMA/s (132 SMs x 128 lanes x 1.98 GHz), against a bytes bound
// of 0.085 ms, so its rows are free of branches and a B element is
// converted to limbs once, not once per row.
//
// The design, shared by both variants.  Every block loads the whole
// coefficient matrix (A, and v for the mask) once into shared memory,
// each coefficient in the form its arithmetic wants (below).  Each
// thread owns COLS consecutive columns and reads each of its K rows of B
// as one 8- or 16-byte load.  All M outputs of a column stay in
// registers; each output row is written once, coalesced.  The rows are
// padded with zero coefficients to MAXM, a multiple of 4, and computed
// without a branch, four rows' coefficients at a time, so the shared
// loads can be scheduled ahead of their use.  The grid is (column
// blocks, batch): no barrier after the coefficient load.  A thread
// starts the loads of up to KCHUNK rows of B before it uses any, so
// several are in flight.
//
// The mask as z more rows of B.  v @ R is [M, z] @ [z, N]: each thread
// makes the threefry word of each (mask row, owned column) once, reduces
// it, and accumulates it with coefficients v like a loaded row.  The
// COLS x z chains of one thread are independent, and at two or more
// resident blocks per SM other warps hide their latency.
//
// Loaded terms (Extra::loaded).  The K + z terms are all read from
// memory by the same chunked loop: term k < K from x at its element
// offset (row indices times N in the rows form; the offsets sit in
// shared memory beside the coefficients), term K + i from row i of r.
// The coefficient block is [a | v], as in the masked form.  The blocks
// form (BLOCKS) divides a thread's first column by bc once, for its
// offset (col0 / bc) * ld + col0 % bc inside a block; the rows form
// knows bc = ld = N at compile time and adds nothing to the rows' reads.  A
// column group is one vector load where bc, ld and every offset keep it
// COLS-aligned (the launcher checks bc and ld, the block's barrier ANDs
// the offsets' check), else COLS scalar loads, each column placed in its
// block row on its own.
//
// The arithmetic is the policy parameter (SkinnyInt32, SkinnyF32):
//
// * int32: a value b < 2**16 is its own limb pair: byte 0 is
//   bl = b & 255 and byte 1 is bh = b >> 8.  So one dp2a.lo with the
//   coefficient packed as (256c mod p) << 16 | c,
//
//     acc = dp2a_lo((256c mod p) << 16 | c, b, acc)
//         = acc + c * bl + (256c mod p) * bh     (one instruction)
//
//   adds a term congruent to c*b.  Each term is at most 2 * 65520 * 255
//   = 33_415_200, so 128 of them stay below 2**32: one Barrett at the end.
// * f32: with c' = 256c mod p, the coefficient is stored as the four
//   limb floats (c'_hi, c_hi, c'_lo, c_lo), and
//
//     c*b == 256*(c'_hi*b_hi + c_hi*b_lo) + (c'_lo*b_hi + c_lo*b_lo)  (mod p)
//
//   in two f32 accumulators, 4 FFMA per term.  Each accumulator gains at
//   most 2 * 255**2 = 130_050 a term, so 128 terms stay exact below 2**24.
//   b's limbs become floats by the magic-number trick (a PRMT under the
//   exponent of 2**23 and an FADD), no I2F.  One reduction at the end;
//   up to 64 terms (every site of the protocol) the sums are below 2**23,
//   convert to integers by an FADD each, and need one Barrett only.
//
// Both caps are K + z <= SKINNY_MAX_TERMS = 128, loaded rows or mask words.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace gfmm {

constexpr int SKINNY_THREADS = 256;
constexpr int SKINNY_MAX_M = 32;
constexpr int SKINNY_MAX_K = 32;
constexpr int SKINNY_MAX_TERMS = 128;  // K + z
static_assert((unsigned long long)SKINNY_MAX_TERMS * 2ull * 65520ull * 255ull < (1ull << 32),
              "the int32 skinny accumulators would wrap");
static_assert(SKINNY_MAX_TERMS * 2 * 255 * 255 < (1 << 24),
              "the f32 skinny accumulators would pass 2**24");
constexpr int SKINNY_F32_SHORT_TERMS = 64;  // K + z at which the sums stay below 2**23
static_assert(SKINNY_F32_SHORT_TERMS * 2 * 255 * 255 < (1 << 23) && (1ull << 23) * 257ull <= (1ull << 32),
              "a short f32 sum converts to an integer directly and 256 * W1 + W0 fits uint32");

// The dp2a form: packed integer coefficients, uint32 accumulators.
struct SkinnyInt32 {
  using Coef = uint32_t;  // (256c mod p) << 16 | c
  using Acc = uint32_t;
  using Val = uint32_t;   // b itself: its bytes are the limbs
  __device__ static Coef coef(uint32_t c, const Params& P) {
    return c | (barrett(c << 8, P.p, P.mu) << 16);  // c < 2**16
  }
  __device__ static void load4(const Coef* p, Coef (&c)[4]) {  // one 16-byte load
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    c[0] = w.x;
    c[1] = w.y;
    c[2] = w.z;
    c[3] = w.w;
  }
  __device__ static Val val(uint32_t x) { return x; }
  __device__ static void zero(Acc& acc) { acc = 0u; }
  __device__ static void mac(Acc& acc, Coef c, Val x) { acc = __dp2a_lo(c, x, acc); }
  __device__ static uint32_t finish(Acc acc, const Params& P, bool) { return barrett(acc, P.p, P.mu); }
};

// The float-limb form: four limb floats per coefficient, two f32
// accumulators (weights 256 and 1).
struct SkinnyF32 {
  using Coef = float4;  // (c'_hi, c_hi, c'_lo, c_lo), c' = 256c mod p
  using Acc = float2;   // (W1, W0)
  using Val = float2;   // (b_hi, b_lo)
  __device__ static Coef coef(uint32_t c, const Params& P) {
    const uint32_t cp = barrett(c << 8, P.p, P.mu);
    return make_float4(limb_f<1>(cp), limb_f<1>(c), limb_f<0>(cp), limb_f<0>(c));
  }
  __device__ static void load4(const Coef* p, Coef (&c)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) c[i] = p[i];
  }
  __device__ static Val val(uint32_t x) { return make_float2(limb_f<1>(x), limb_f<0>(x)); }
  __device__ static void zero(Acc& acc) { acc = make_float2(0.f, 0.f); }
  __device__ static void mac(Acc& acc, Coef c, Val x) {
    acc.x = __fmaf_rn(c.x, x.x, acc.x);
    acc.x = __fmaf_rn(c.y, x.y, acc.x);
    acc.y = __fmaf_rn(c.z, x.x, acc.y);
    acc.y = __fmaf_rn(c.w, x.y, acc.y);
  }
  // short: at most SKINNY_F32_SHORT_TERMS terms, so both sums are below
  // 2**23 and convert to integers directly; 256 * W1 + W0 < 2**32 then.
  __device__ static uint32_t finish(Acc acc, const Params& P, bool short_sum) {
    if (short_sum) return barrett(float_to_u(acc.x) * 256u + float_to_u(acc.y), P.p, P.mu);
    const uint32_t w1 = float_to_u(mod_f(acc.x, P.pf, P.inv_p));
    const uint32_t w0 = float_to_u(mod_f(acc.y, P.pf, P.inv_p));
    return barrett(w1 * 256u + w0, P.p, P.mu);  // < 2**25
  }
};

// Columns a thread owns: the accumulators take MAXM * COLS of Acc.
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

// What follows B's K rows as z more terms: nothing, the mask words made
// in the kernel, or z rows loaded from memory.
enum class Extra { none, mask, loaded };

template <int COLS>
__device__ __forceinline__ void store_cols(int* p, const uint32_t (&x)[COLS]) {
  typename IntVec<COLS>::T w;
  int* e = reinterpret_cast<int*>(&w);
#pragma unroll
  for (int j = 0; j < COLS; ++j) e[j] = (int)x[j];
  __stcs(reinterpret_cast<typename IntVec<COLS>::T*>(p), w);
}

// vec: N % COLS == 0 and b, out (and r, bc and ld, for loaded terms)
// aligned to COLS ints with batch strides that keep them so (the
// launcher checks), so whole column groups move as one vector access.
// BLOCKS (loaded terms only): the blocks form; otherwise whole rows, bc =
// ld = N known to the compiler.
template <class Arith, int MAXM, Extra E, bool BLOCKS = false>
__device__ __forceinline__ void skinny_body(const Params& P, const bool vec) {
  static_assert(MAXM % 4 == 0, "rows are read four at a time");
  using Coef = typename Arith::Coef;
  constexpr int COLS = SkinnyCols<MAXM>::value;
  constexpr int KCHUNK = 16 / COLS;  // rows of B a thread loads before using them
  extern __shared__ __align__(16) unsigned char skinny_smem[];
  Coef* coef = reinterpret_cast<Coef*>(skinny_smem);  // [K + z][MAXM]
  const int M = P.M, N = P.N, K = P.K;
  const int T = K + (E == Extra::none ? 0 : P.z);
  const int KB = E == Extra::loaded ? T : K;  // terms read from memory
  const int bb = blockIdx.y;
  const int* __restrict__ a = P.a + (size_t)bb * (size_t)P.a_bs;
  for (int i = threadIdx.x; i < T * MAXM; i += SKINNY_THREADS) {
    const int t = i / MAXM, m = i % MAXM;
    uint32_t c = 0u;  // padding rows contribute nothing
    if (m < M)
      c = t < K ? (uint32_t)a[(size_t)m * K + t] : (uint32_t)P.v[(size_t)m * P.z + (t - K)];
    coef[i] = Arith::coef(c, P);
  }
  long long* offs = reinterpret_cast<long long*>(coef + T * MAXM);  // [K], loaded terms only
  bool offs_vec = true;  // every term's offset keeps a column group aligned
  if constexpr (E == Extra::loaded) {
    bool aligned = true;
    for (int k = threadIdx.x; k < K; k += SKINNY_THREADS) {
      offs[k] = BLOCKS ? P.offs[k] : P.offs[k] * N;
      aligned = aligned && (offs[k] & (COLS - 1)) == 0;
    }
    offs_vec = __syncthreads_and(aligned);
  } else {
    __syncthreads();
  }

  const long long col0 = ((long long)blockIdx.x * SKINNY_THREADS + threadIdx.x) * COLS;
  if (col0 >= N) return;
  const bool full = vec && col0 + COLS <= N;
  // a loaded term's first owned column lies (col0 / bc) * ld + col0 % bc
  // into its block: col0 itself in the rows form (bc = N)
  long long coloff = col0;
  if constexpr (E == Extra::loaded && BLOCKS) {
    if (P.bc != N) {
      const unsigned q = (unsigned)col0 / (unsigned)P.bc;
      coloff = (long long)q * P.ld + ((unsigned)col0 - q * (unsigned)P.bc);
    }
  }
  typename Arith::Acc acc[MAXM][COLS];
#pragma unroll
  for (int m = 0; m < MAXM; ++m)
#pragma unroll
    for (int j = 0; j < COLS; ++j) Arith::zero(acc[m][j]);

  // x[j] < p: a value of B or a mask word; each is converted once
  auto accumulate = [&](int t, const uint32_t(&x)[COLS]) {
    typename Arith::Val xv[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) xv[j] = Arith::val(x[j]);
    const Coef* ct = coef + t * MAXM;
#pragma unroll
    for (int q = 0; q < MAXM / 4; ++q) {
      Coef c[4];
      Arith::load4(ct + 4 * q, c);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < COLS; ++j) Arith::mac(acc[4 * q + i][j], c[i], xv[j]);
    }
  };

  // every memory row starts at the thread's first column: a loaded term
  // k < K at b + offs[k], b already moved by coloff
  const int* __restrict__ b = P.b + (size_t)bb * (size_t)P.b_bs + (E == Extra::loaded ? coloff : col0);
  const int* __restrict__ rz = E == Extra::loaded ? P.r + (size_t)bb * (size_t)P.r_bs + col0 : nullptr;
  auto row_of = [&](int t) -> const int* {  // the memory row of term t < KB
    if constexpr (E == Extra::loaded)
      return t < K ? b + offs[t] : rz + (size_t)(t - K) * N;
    else
      return b + (size_t)t * N;
  };
  // owned column j of term t one at a time: a loaded term's column may
  // lie in the block's next row
  auto element = [&](int t, const int* row, int j) -> uint32_t {
    if (col0 + j >= N) return 0u;
    if constexpr (E == Extra::loaded && BLOCKS) {
      if (t < K && P.bc != N) {
        const unsigned n = (unsigned)(col0 + j), q = n / (unsigned)P.bc;
        return (uint32_t)row[(long long)q * P.ld + (n - q * (unsigned)P.bc) - coloff];
      }
    }
    return (uint32_t)row[j];
  };
  // fast: every term's column group is one vector load (decided once, so
  // the chunk's loads go out back to back without a branch)
  auto terms = [&](auto fast) {
    for (int k0 = 0; k0 < KB; k0 += KCHUNK) {
      uint32_t x[KCHUNK][COLS];
#pragma unroll
      for (int kk = 0; kk < KCHUNK; ++kk) {
        if (k0 + kk < KB) {
          const int* row = row_of(k0 + kk);
          if (decltype(fast)::value || (full && (E != Extra::loaded || k0 + kk >= K))) {
            load_cols<COLS>(row, x[kk]);
          } else {
#pragma unroll
            for (int j = 0; j < COLS; ++j) x[kk][j] = element(k0 + kk, row, j);
          }
        }
      }
#pragma unroll
      for (int kk = 0; kk < KCHUNK; ++kk)
        if (k0 + kk < KB) accumulate(k0 + kk, x[kk]);
    }
  };
  if (E == Extra::loaded && full && offs_vec)
    terms(std::true_type{});
  else
    terms(std::false_type{});  // the other forms decide a term's vector load term by term
  if constexpr (E == Extra::mask) {
    for (int zi = 0; zi < P.z; ++zi) {
      uint32_t x[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j)
        x[j] = col0 + j < N ? mask_word(P, (uint32_t)bb, (uint32_t)zi, (uint32_t)(col0 + j)) : 0u;
      accumulate(K + zi, x);
    }
  }

  const bool short_sum = T <= SKINNY_F32_SHORT_TERMS;  // uniform across the grid
  int* __restrict__ out = P.out + (size_t)bb * (size_t)M * (size_t)N + col0;
#pragma unroll
  for (int m = 0; m < MAXM; ++m) {
    if (m < M) {
      uint32_t r[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) r[j] = Arith::finish(acc[m][j], P, short_sum);
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

// Compiled names of their own, so the profiler and the launch counts
// tell the variants apart; every name holds modmatmul_<variant>_skinny.
template <int MAXM, bool MASKED>
__global__ void __launch_bounds__(SKINNY_THREADS)
    modmatmul_int32_skinny(const Params P, const bool vec) {
  skinny_body<SkinnyInt32, MAXM, MASKED ? Extra::mask : Extra::none>(P, vec);
}

template <int MAXM, bool MASKED>
__global__ void __launch_bounds__(SKINNY_THREADS)
    modmatmul_f32_skinny(const Params P, const bool vec) {
  skinny_body<SkinnyF32, MAXM, MASKED ? Extra::mask : Extra::none>(P, vec);
}

template <int MAXM>
__global__ void __launch_bounds__(SKINNY_THREADS)
    modmatmul_int32_skinny_rows_plus(const Params P, const bool vec) {
  skinny_body<SkinnyInt32, MAXM, Extra::loaded>(P, vec);
}

template <int MAXM>
__global__ void __launch_bounds__(SKINNY_THREADS)
    modmatmul_f32_skinny_rows_plus(const Params P, const bool vec) {
  skinny_body<SkinnyF32, MAXM, Extra::loaded>(P, vec);
}

// The blocks form: the loaded-terms body with BLOCKS, under a name of its
// own, so the profiler tells the share's launches from the reduce's.
template <int MAXM>
__global__ void __launch_bounds__(SKINNY_THREADS)
    modmatmul_int32_skinny_blocks_plus(const Params P, const bool vec) {
  skinny_body<SkinnyInt32, MAXM, Extra::loaded, true>(P, vec);
}

// At MAXM = 20 the f32 blocks form would take 130 registers, two past the
// 128 that let two blocks share an SM (the other f32 forms take 128);
// asking for two keeps it at the stack form's speed (1.15 against 1.72 ms
// for share B at the main width on an H100).
template <int MAXM>
__global__ void __launch_bounds__(SKINNY_THREADS, MAXM == 20 ? 2 : 1)
    modmatmul_f32_skinny_blocks_plus(const Params P, const bool vec) {
  skinny_body<SkinnyF32, MAXM, Extra::loaded, true>(P, vec);
}

template <int MAXM, Extra E, bool BLOCKS>
auto skinny_kernel(SkinnyInt32) {
  if constexpr (E == Extra::loaded)
    return BLOCKS ? modmatmul_int32_skinny_blocks_plus<MAXM> : modmatmul_int32_skinny_rows_plus<MAXM>;
  else
    return modmatmul_int32_skinny<MAXM, E == Extra::mask>;
}
template <int MAXM, Extra E, bool BLOCKS>
auto skinny_kernel(SkinnyF32) {
  if constexpr (E == Extra::loaded)
    return BLOCKS ? modmatmul_f32_skinny_blocks_plus<MAXM> : modmatmul_f32_skinny_rows_plus<MAXM>;
  else
    return modmatmul_f32_skinny<MAXM, E == Extra::mask>;
}

// BLOCKS (loaded terms only): the blocks form's kernel, else the rows form's.
template <class Arith, int MAXM, Extra E, bool BLOCKS>
cudaError_t launch_skinny(const Params& P, int batch, cudaStream_t stream) {
  constexpr int COLS = SkinnyCols<MAXM>::value;
  const long long span = (long long)SKINNY_THREADS * COLS;
  uintptr_t addrs = reinterpret_cast<uintptr_t>(P.b) | reinterpret_cast<uintptr_t>(P.out);
  long long strides = P.b_bs;
  if (E == Extra::loaded) {
    addrs |= reinterpret_cast<uintptr_t>(P.r);
    strides |= P.r_bs | P.bc | P.ld;
  }
  const bool vec = P.N % COLS == 0 && strides % COLS == 0 && addrs % (sizeof(int) * COLS) == 0;
  const int terms = P.K + (E == Extra::none ? 0 : P.z);
  // int32: <= 16 KB; f32: <= 64 KB, above the default 48 KB window;
  // loaded terms add their K offsets
  const size_t smem = sizeof(typename Arith::Coef) * (size_t)terms * MAXM +
                      (E == Extra::loaded ? sizeof(long long) * (size_t)P.K : 0);
  auto kernel = skinny_kernel<MAXM, E, BLOCKS>(Arith{});
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((unsigned)((P.N + span - 1) / span), batch);
  kernel<<<grid, SKINNY_THREADS, smem, stream>>>(P, vec);
  return cudaGetLastError();
}

template <class Arith, Extra E, bool BLOCKS = false>
cudaError_t launch_skinny_by_m(const Params& P, int batch, cudaStream_t stream) {
  if (P.M > SKINNY_MAX_M || P.K > SKINNY_MAX_K || P.K + P.z > SKINNY_MAX_TERMS)
    return cudaErrorInvalidValue;
  if (E == Extra::loaded && (P.bc < 1 || P.bc > P.N || P.ld < 1))
    return cudaErrorInvalidValue;
  switch ((P.M + 3) / 4) {  // M rounded up to a multiple of 4
    case 1: return launch_skinny<Arith, 4, E, BLOCKS>(P, batch, stream);
    case 2: return launch_skinny<Arith, 8, E, BLOCKS>(P, batch, stream);
    case 3: return launch_skinny<Arith, 12, E, BLOCKS>(P, batch, stream);
    case 4: return launch_skinny<Arith, 16, E, BLOCKS>(P, batch, stream);
    case 5: return launch_skinny<Arith, 20, E, BLOCKS>(P, batch, stream);
    case 6: return launch_skinny<Arith, 24, E, BLOCKS>(P, batch, stream);
    case 7: return launch_skinny<Arith, 28, E, BLOCKS>(P, batch, stream);
    case 8: return launch_skinny<Arith, 32, E, BLOCKS>(P, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace gfmm
