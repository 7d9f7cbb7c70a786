// Shared pieces of the GF(p) matmul kernels (p < 2**16): launch
// parameters, the integer and float modular helpers, the limb
// conversions, the threefry mask word and the fused-mask epilogue of a
// wgmma tile, and the asynchronous-copy, wgmma and mbarrier primitives.
// Included by modmatmul.cu, the one translation unit the kernels are
// built from.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gfmm {

struct Params {
  const int* a;
  const int* b;
  int* out;
  const int* v;      // [M, z] fused-mask coefficients (MASKED only)
  int M, N, K, z;
  long long a_bs;    // batch strides in elements; 0 = shared 2D operand
  long long b_bs;
  uint32_t p;
  uint32_t mu;       // floor(2**32 / p), the Barrett constant
  uint32_t f_hihi;   // 2**16 mod p
  uint32_t f_mid;    // 2**8 mod p
  uint32_t k0, k1;   // threefry key words (MASKED only)
  float pf, inv_p;   // p and 1/p rounded to float
  // the skinny form with loaded terms only (skinny.cuh, Extra::loaded):
  // output column n of term k < K is b[offs[k] + (n / bc) * ld + n % bc]
  // (batch stride b_bs); the rows form is bc = ld = N with offs[k] a row
  const long long* offs;  // [K] where term k starts: a row of b, or an element offset
  long long bc, ld;       // a block's width and its row stride in elements
  const int* r;           // [z, N] per batch element: terms K .. K + z - 1
  long long r_bs;         // r's batch stride in elements; 0 = shared 2D
};

// ---------------------------------------------------------------------
// integer helpers: gf.barrett_reduce_u32 / gf._barrett_recombine
// ---------------------------------------------------------------------
// __umulhi(x, mu) is floor(x * mu / 2**32), exactly the quotient the JAX
// package assembles from 16-bit limb products; floor(x/p) - q is 0 or 1
// for every uint32 x.
__device__ __forceinline__ uint32_t barrett(uint32_t x, uint32_t p, uint32_t mu) {
  uint32_t r = x - __umulhi(x, mu) * p;
  return r >= p ? r - p : r;
}

__device__ __forceinline__ uint32_t recombine(uint32_t hh, uint32_t mid, uint32_t ll,
                                              const Params& P) {
  uint32_t t = barrett(barrett(hh, P.p, P.mu) * P.f_hihi, P.p, P.mu) +
               barrett(barrett(mid, P.p, P.mu) * P.f_mid, P.p, P.mu) +
               barrett(ll, P.p, P.mu);
  return barrett(t, P.p, P.mu);  // sum of three residues < 3p
}

__device__ __forceinline__ uint32_t add_mod(uint32_t x, uint32_t y, uint32_t p) {
  uint32_t s = x + y;  // both < p < 2**16
  return s >= p ? s - p : s;
}

// ---------------------------------------------------------------------
// float helpers: kernel.py's _modf32, and the limb conversions
// ---------------------------------------------------------------------
// x mod p for x an exact integer with |x| < 2**24.  The quotient comes from
// a multiply by the rounded reciprocal, rounded to an integer by the
// 1.5 * 2**23 magic add (an FFMA and an FADD; floorf would be FRND on the
// conversion pipe).  x * (1/p) is within one of x/p for x < 2**24, so the
// rounded quotient may be one off either way, and both corrections
// below undo it; x - q*p is exact in one FFMA.
constexpr float ROUND_MAGIC = 12582912.f;  // 1.5 * 2**23: ulp 1 around it
// The three-op part: x - q*p with q within one of x/p, so the result is
// in (-p, p) for |x| < 2**24 (the negative side included).  A running
// sum needs no more than this to stay bounded.
__device__ __forceinline__ float fold_f(float x, float pf, float inv_p) {
  const float q = __fsub_rn(__fmaf_rn(x, inv_p, ROUND_MAGIC), ROUND_MAGIC);
  return __fmaf_rn(-q, pf, x);
}
__device__ __forceinline__ float mod_f(float x, float pf, float inv_p) {
  float r = fold_f(x, pf, inv_p);
  r = r < 0.f ? r + pf : r;
  return r >= pf ? r - pf : r;
}

// An exact integer float in [0, 2**23) as uint32, without F2I: adding
// 2**23 puts the integer in the low mantissa bits.
__device__ __forceinline__ uint32_t float_to_u(float x) {
  return __float_as_uint(__fadd_rn(x, 8388608.f)) - 0x4B000000u;
}

// Byte `sel` (0 = lo limb, 1 = hi limb) of x < 2**16 as an exact float,
// without I2F: PRMT puts the byte under the exponent of 2**23, and
// subtracting 2**23 leaves it.
template <int SEL>
__device__ __forceinline__ float limb_f(uint32_t x) {
  return __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7650 | SEL)) - 8388608.f;
}

// x0, x1 < 2**16 -> fp16 pairs (lo(x0), lo(x1)) and (hi(x0), hi(x1)),
// exact, in two PRMTs and two HSUB2 after one PRMT that gathers the
// bytes: PRMT puts each byte under the byte 0x64, which makes the fp16
// value 1024 + byte, and subtracting (1024, 1024) leaves the byte.  The
// lower half of each word is x0's limb.
__device__ __forceinline__ void limbs_h2(uint32_t x0, uint32_t x1, uint32_t& lo, uint32_t& hi) {
  const uint32_t t = __byte_perm(x0, x1, 0x5140);  // x0.b0 x1.b0 x0.b1 x1.b1
  const uint32_t l = __byte_perm(t, 0x64646464u, 0x4140);
  const uint32_t h = __byte_perm(t, 0x64646464u, 0x4342);
  asm("sub.rn.f16x2 %0, %1, %2;" : "=r"(lo) : "r"(l), "r"(0x64006400u));
  asm("sub.rn.f16x2 %0, %1, %2;" : "=r"(hi) : "r"(h), "r"(0x64006400u));
}

// ---------------------------------------------------------------------
// threefry2x32, 20 rounds: gf.threefry2x32 (first output word)
// ---------------------------------------------------------------------
__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;

__device__ __forceinline__ uint32_t threefry_x0(uint32_t k0, uint32_t k1, uint32_t c0) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0;
  uint32_t x1 = k1;  // counter word c1 = 0
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  return x0;
}

#undef TF_ROUND

// The mask word of gf.field_mask at (batch bb, mask row zi, column col)
// of the [batch, z, N] mask: counter (bb*z + zi)*N + col, row-major, in
// uint32 (the wrapper checks that batch*z*N < 2**32), reduced mod p.
__device__ __forceinline__ uint32_t mask_word(const Params& P, uint32_t bb, uint32_t zi,
                                              uint32_t col) {
  const uint32_t ctr = (bb * (uint32_t)P.z + zi) * (uint32_t)P.N + col;
  return barrett(threefry_x0(P.k0, P.k1, ctr), P.p, P.mu);
}

// ---------------------------------------------------------------------
// cp.async (sm_80+): global -> shared without staging in registers.
// src-size 0 copies nothing and fills the destination with zeros, which
// is how ragged tile edges are loaded.
// ---------------------------------------------------------------------
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------
// wgmma synchronization (sm_90a)
// ---------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator accesses across the
// asynchronous wgmma window.
template <int N>
__device__ __forceinline__ void fence_operands(uint32_t (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+r"(d[e])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int e = 0; e < N; ++e) asm volatile("" : "+f"(d[e])::"memory");
}

// ---------------------------------------------------------------------
// mbarrier (sm_90): arrival-count barriers in shared memory
// ---------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------
// the fused mask of a wgmma tile: kernel.py's _apply_fused_mask
// ---------------------------------------------------------------------
// r += v[row, :] @ R[:, col]  (mod p) for one thread's residues r (< p)
// in wgmma's m64nN accumulator layout: r[4j + 2h + c] is row row0 + 8h,
// block column col0 + 8j + c, for n8 tiles j < NJ.  NTHREADS threads
// (thread index tid) run it together: they make each of the block's BN
// columns' mask words once, NTHREADS / BN mask rows per pass, into
// mask_r (NTHREADS words of idle shared memory), with sync() between
// passes.  The caller syncs before mask_r is first written.
template <int NTHREADS, int BN, int NJ, typename Sync>
__device__ __forceinline__ void add_fused_mask(uint32_t (&r)[4 * NJ], const Params& P,
                                               uint32_t* mask_r, int tid, int bb, int n0,
                                               int row0, int col0, Sync sync) {
  static_assert(NTHREADS % BN == 0, "the mask pass maps threads onto whole rows of words");
  constexpr int ZSTEP = NTHREADS / BN;
  for (int z0 = 0; z0 < P.z; z0 += ZSTEP) {
    {
      const int zi = z0 + tid / BN;
      const int col = n0 + tid % BN;
      mask_r[tid] = (zi < P.z && col < P.N)
                        ? mask_word(P, (uint32_t)bb, (uint32_t)zi, (uint32_t)col)
                        : 0u;
    }
    sync();
    const int zn = min(ZSTEP, P.z - z0);
    for (int dz = 0; dz < zn; ++dz) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row >= P.M) continue;
        const uint32_t vz = (uint32_t)P.v[(size_t)row * P.z + z0 + dz];
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint32_t w = mask_r[dz * BN + col0 + 8 * j + c];
            // v < p and w < p: the product fits uint32
            const int e = 4 * j + 2 * h + c;
            r[e] = add_mod(r[e], barrett(vz * w, P.p, P.mu), P.p);
          }
      }
    }
    sync();
  }
}

}  // namespace gfmm
