// Shared pieces of the GF(p) matmul kernels (p < 2**16): launch
// parameters, the integer and float modular helpers, the threefry mask
// word, and the asynchronous-copy primitives.  Included by
// modmatmul.cu, the one translation unit the kernels are built from.
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
  float pf, inv_p;          // p and 1/p rounded to float
  float hihi_hi, hihi_lo;  // (f_hihi * 256) mod p, f_hihi mod p
  float mid_hi, mid_lo;    // (f_mid * 256) mod p, f_mid mod p
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
// float helpers: kernel.py's _modf32 / _mulmod_const
// ---------------------------------------------------------------------
// x is an exact integer below 2**24.  The quotient comes from a multiply
// by the rounded reciprocal instead of an IEEE division (a dozen
// instructions): x * (1/p) is within one of x/p for x < 2**24, so
// floor() may be one off either way, and both corrections below undo it.
__device__ __forceinline__ float mod_f(float x, float pf, float inv_p) {
  float r = x - floorf(x * inv_p) * pf;
  r = r < 0.f ? r + pf : r;
  return r >= pf ? r - pf : r;
}

// x * c mod p for x in [0, p): split x into 8-bit limbs so each product
// stays below 2**24 (c_hi = (c*256) mod p, c_lo = c mod p).
__device__ __forceinline__ float mulmod_const(float x, float c_hi, float c_lo, float pf,
                                              float inv_p) {
  float x_hi = floorf(x * (1.f / 256.f));
  float x_lo = x - x_hi * 256.f;
  return mod_f(mod_f(x_hi * c_hi, pf, inv_p) + mod_f(x_lo * c_lo, pf, inv_p), pf, inv_p);
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

}  // namespace gfmm
