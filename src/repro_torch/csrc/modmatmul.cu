// Exact GF(p) matrix multiplication, p < 2**16, for Hopper (sm_90a).
//
//   out[b] = a[b] @ b_[b] (mod p)          [B, M, K] @ [B, K, N] -> [B, M, N]
//   out[b] += v @ R(key)  (mod p)          MASKED: blinding fused in the epilogue
//
// All operands are int32 in [0, p); either side may be a single 2D
// matrix shared by every batch element (batch stride 0, never copied).
//
// This one source replaces the three Pallas tile bodies of the JAX
// package (src/repro/kernels/modmatmul/kernel.py):
//
//   Variant::INT32    <- _modmatmul_int32_kernel  (kernel.py:152)
//   Variant::F32LIMB  <- _modmatmul_kernel        (kernel.py:101)
//   MASKED = true     <- _apply_fused_mask        (kernel.py:193)
//
// What changed from the TPU design.  The Pallas grid is (B, M/bm, N/bn,
// K/bk) with K a *sequential* grid axis and the accumulator held in the
// output block between grid steps.  CUDA blocks run in no order, so the
// K axis becomes a loop inside each block and the accumulator lives in
// registers; blocks cover (N tiles, M tiles, B).  The Pallas wrapper
// padded every operand to tile multiples on the host; here the loads
// mask the ragged M/N/K edges (zeros contribute nothing) and the stores
// skip them, so nothing is padded or copied.
//
// What bounds it on the H100.  Per output element and K step the INT32
// variant does four 32-bit integer multiply-adds on the CUDA cores
// (hi*hi, hi*lo, lo*hi, lo*lo of the 8-bit limbs); the F32LIMB variant
// four float FMAs.  At the protocol's Phase-2 product ([68, 256, 2560] @
// [68, 2560, 2048]) that is ~0.37 T limb MACs, so the kernel is bound by
// CUDA-core issue rate, far above both the int8 tensor-core bound and
// the bytes bound of the same work.  This first version is a plain
// shared-memory tiled kernel that is exactly right; the limb layout and
// the three raw accumulators (hh, mid, ll) are what a later version maps
// onto u8/s8 mma.sync or wgmma with s32 accumulate, keeping the same
// Barrett epilogue in registers.  Skinny-M tiles for the Phase-1 and
// Phase-3 shapes (M = 17 or 6, K <= 17) are later work too: at BM = 64
// those launches leave most of each block idle.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;              // output rows per block
constexpr int BN = 64;              // output columns per block
constexpr int BK = 32;              // K depth staged in shared memory per step
constexpr int TX = 16;              // threads along N
constexpr int TY = 16;              // threads along M
constexpr int TM = BM / TY;         // 4 rows per thread
constexpr int TN = BN / TX;         // 4 columns per thread
constexpr int THREADS = TX * TY;    // 256

// INT32: the raw uint32 accumulators take at most 2 * 255**2 per K step
// (the cross sum); 33024 steps stay below 2**32 (33024 * 130050 =
// 4_294_771_200), so they fold through the Barrett recombination every
// 33024 K and the kernel has no depth limit.
constexpr int INT32_FOLD_K = 33024;
static_assert(INT32_FOLD_K % BK == 0, "fold period must be whole K steps");
constexpr int INT32_FOLD_TILES = INT32_FOLD_K / BK;

// F32LIMB: the reference's lazy schedule.  After 128 K steps the raw
// cross sum is <= 2 * 128 * 255**2 = 16_646_400 < 2**24 and the final
// accumulate 3*(p-1) + 128*255**2 < 2**24: every float stays an exact
// integer.
constexpr int F32_LAZY_K = 128;
static_assert(F32_LAZY_K % BK == 0, "reduction period must be whole K steps");
static_assert(THREADS % BN == 0, "the mask pass maps threads onto whole rows of words");
constexpr int F32_LAZY_TILES = F32_LAZY_K / BK;

enum class Variant : int { INT32 = 0, F32LIMB = 1 };

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
// package assembles from 16-bit limb products; floor(x/p) - q is 0 or 1.
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

// ---------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------
template <Variant V>
struct LimbType { using T = uint32_t; };
template <>
struct LimbType<Variant::F32LIMB> { using T = float; };

template <Variant V, bool MASKED>
__global__ void __launch_bounds__(THREADS) modmatmul_kernel(const Params P) {
  using T = typename LimbType<V>::T;
  // Limbs are split as the operands are staged: hi = x >> 8, lo = x & 255.
  // A is stored K-major so a thread's TM rows are one broadcast read; the
  // +1 column keeps the transposing stores free of bank conflicts.
  __shared__ T a_hi[BK][BM + 1];
  __shared__ T a_lo[BK][BM + 1];
  __shared__ T b_hi[BK][BN];
  __shared__ T b_lo[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int bb = blockIdx.z;
  const int M = P.M, N = P.N, K = P.K;
  const int* __restrict__ a = P.a + (size_t)bb * (size_t)P.a_bs;
  const int* __restrict__ b = P.b + (size_t)bb * (size_t)P.b_bs;

  T hh[TM][TN], mid[TM][TN], ll[TM][TN];
  uint32_t acc[TM][TN];  // running result in [0, p)
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      hh[i][j] = mid[i][j] = ll[i][j] = T(0);
      acc[i][j] = 0u;
    }

  // Fold the raw limb sums into acc (mod p) and clear them.
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        if constexpr (V == Variant::INT32) {
          acc[i][j] = add_mod(acc[i][j], recombine(hh[i][j], mid[i][j], ll[i][j], P), P.p);
        } else {
          float h = mod_f(hh[i][j], P.pf, P.inv_p);
          float c = mod_f(mid[i][j], P.pf, P.inv_p);
          float tile = mulmod_const(h, P.hihi_hi, P.hihi_lo, P.pf, P.inv_p) +
                       mulmod_const(c, P.mid_hi, P.mid_lo, P.pf, P.inv_p) + ll[i][j];
          acc[i][j] = (uint32_t)mod_f((float)acc[i][j] + tile, P.pf, P.inv_p);
        }
        hh[i][j] = mid[i][j] = ll[i][j] = T(0);
      }
  };

  constexpr int FOLD_TILES = V == Variant::INT32 ? INT32_FOLD_TILES : F32_LAZY_TILES;
  const int ntiles = (K + BK - 1) / BK;
  int since_fold = 0;
  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BK;
    // stage A[m0:m0+BM, k0:k0+BK] (coalesced along K) and
    // B[k0:k0+BK, n0:n0+BN] (coalesced along N); ragged edges load 0
#pragma unroll
    for (int l = 0; l < BM * BK / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      const uint32_t x = (gm < M && gk < K) ? (uint32_t)a[(size_t)gm * K + gk] : 0u;
      a_hi[c][r] = T(x >> 8);
      a_lo[c][r] = T(x & 255u);
    }
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      const uint32_t x = (gk < K && gn < N) ? (uint32_t)b[(size_t)gk * N + gn] : 0u;
      b_hi[r][c] = T(x >> 8);
      b_lo[r][c] = T(x & 255u);
    }
    __syncthreads();
    const int kmax = min(BK, K - k0);  // the last step may be ragged
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      T ah[TM], al[TM], bh[TN], bl[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ah[i] = a_hi[kk][ty + i * TY];
        al[i] = a_lo[kk][ty + i * TY];
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        bh[j] = b_hi[kk][tx + j * TX];
        bl[j] = b_lo[kk][tx + j * TX];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          hh[i][j] += ah[i] * bh[j];
          mid[i][j] += ah[i] * bl[j] + al[i] * bh[j];
          ll[i][j] += al[i] * bl[j];
        }
    }
    __syncthreads();
    if (++since_fold == FOLD_TILES) {
      fold();
      since_fold = 0;
    }
  }
  fold();

  if constexpr (MASKED) {
    // Add v[row, :] @ R[:, col], R generated here: element (bb, zi, col)
    // of the [batch, z, N] mask has counter (bb*z + zi)*N + col, the
    // row-major index gf.field_mask uses (the wrapper checks that
    // batch*z*N < 2**32).  The block makes each of its columns' words
    // once, ZSTEP mask rows per pass, into shared memory; every thread
    // then applies them to its TM x TN elements.
    constexpr int ZSTEP = THREADS / BN;  // 4 mask rows per pass
    __shared__ uint32_t mask_r[ZSTEP][BN];
    uint32_t msum[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) msum[i][j] = 0u;
    for (int z0 = 0; z0 < P.z; z0 += ZSTEP) {
      {
        const int zi = z0 + tid / BN;
        const int col = n0 + tid % BN;
        uint32_t r = 0u;  // past z or N: contributes nothing
        if (zi < P.z && col < N) {
          const uint32_t ctr = ((uint32_t)bb * (uint32_t)P.z + (uint32_t)zi) * (uint32_t)N +
                               (uint32_t)col;
          r = barrett(threefry_x0(P.k0, P.k1, ctr), P.p, P.mu);
        }
        mask_r[tid / BN][tid % BN] = r;
      }
      __syncthreads();
      const int zn = min(ZSTEP, P.z - z0);
      for (int dz = 0; dz < zn; ++dz) {
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int row = m0 + ty + i * TY;
          if (row >= M) continue;
          const uint32_t vz = (uint32_t)P.v[(size_t)row * P.z + z0 + dz];
#pragma unroll
          for (int j = 0; j < TN; ++j)
            // v < p and r < p: the product fits uint32; reducing each
            // term keeps the sum <= z*p, wrap-free for z < 2**16
            msum[i][j] += barrett(vz * mask_r[dz][tx + j * TX], P.p, P.mu);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        acc[i][j] = add_mod(acc[i][j], barrett(msum[i][j], P.p, P.mu), P.p);
  }

  int* __restrict__ out = P.out + (size_t)bb * (size_t)M * (size_t)N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + i * TY;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + j * TX;
      if (col < N) out[(size_t)row * N + col] = (int)acc[i][j];
    }
  }
}

template <Variant V, bool MASKED>
void launch(const Params& P, int batch, cudaStream_t stream) {
  dim3 grid((P.N + BN - 1) / BN, (P.M + BM - 1) / BM, batch);
  modmatmul_kernel<V, MASKED><<<grid, THREADS, 0, stream>>>(P);
}

}  // namespace

// Launch one product on `stream`.  variant: 0 = INT32, 1 = F32LIMB;
// masked: 0/1.  The caller (kernel.py) has checked shapes, dtypes,
// contiguity, p < 2**16, the grid limits and the mask counter space.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int modmatmul_launch(int variant, int masked, const void* a, const void* b,
                                void* out, int batch, int M, int N, int K,
                                long long a_bs, long long b_bs, unsigned p,
                                const void* v, int z, unsigned k0, unsigned k1,
                                void* stream) {
  Params P;
  P.a = static_cast<const int*>(a);
  P.b = static_cast<const int*>(b);
  P.out = static_cast<int*>(out);
  P.v = static_cast<const int*>(v);
  P.M = M;
  P.N = N;
  P.K = K;
  P.z = z;
  P.a_bs = a_bs;
  P.b_bs = b_bs;
  P.p = p;
  P.mu = (uint32_t)((1ull << 32) / p);
  P.f_hihi = (1u << 16) % p;
  P.f_mid = 256u % p;
  P.k0 = k0;
  P.k1 = k1;
  P.pf = (float)p;
  P.inv_p = 1.f / (float)p;
  P.hihi_hi = (float)((P.f_hihi * 256u) % p);
  P.hihi_lo = (float)(P.f_hihi % p);
  P.mid_hi = (float)((P.f_mid * 256u) % p);
  P.mid_lo = (float)(P.f_mid % p);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0) {
    if (masked) launch<Variant::INT32, true>(P, batch, s);
    else launch<Variant::INT32, false>(P, batch, s);
  } else if (variant == 1) {
    if (masked) launch<Variant::F32LIMB, true>(P, batch, s);
    else launch<Variant::F32LIMB, false>(P, batch, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
