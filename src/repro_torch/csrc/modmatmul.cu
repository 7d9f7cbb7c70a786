// Exact GF(p) matrix multiplication, p < 2**16, for Hopper (sm_90a).
//
//   out[b] = a[b] @ b_[b] (mod p)          [B, M, K] @ [B, K, N] -> [B, M, N]
//   out[b] += v @ R(key)  (mod p)          MASKED: blinding fused in
//
// All operands are int32 in [0, p); either side may be a single 2D
// matrix shared by every batch element (batch stride 0, never copied).
//
// Three compiled designs replace the three Pallas tile bodies of the JAX
// package (src/repro/kernels/modmatmul/kernel.py):
//
//   modmatmul_int32_mma     (int32_mma.cuh)    <- _modmatmul_int32_kernel (kernel.py:152)
//                                                 and _apply_fused_mask (kernel.py:193)
//                                                 for every shape not skinny
//   modmatmul_int32_skinny  (int32_skinny.cuh) <- the same two, for M <= 32 and K <= 32
//   modmatmul_f32_simt      (this file)        <- _modmatmul_kernel (kernel.py:101)
//                                                 and _apply_fused_mask
//
// The wrapper (repro_torch/kernels/modmatmul/kernel.py: choose_design)
// picks the design from the variant and the shape.
//
// What changed from the TPU design.  The Pallas grid is (B, M/bm, N/bn,
// K/bk) with K a *sequential* grid axis and the accumulator held in the
// output block between grid steps.  CUDA blocks run in no order, so the
// K axis becomes a loop inside each block and the accumulator lives in
// registers.  The Pallas wrapper padded every operand to tile multiples
// on the host; here the loads mask the ragged M/N/K edges (zeros
// contribute nothing) and the stores skip them, so nothing is padded.
//
// The f32-limb SIMT kernel.  Per output element and K step it does four
// float FMAs of the 8-bit limbs on the CUDA cores, with the reference's
// lazy 128-deep reduction; it is bound by CUDA-core instruction rate, far
// above the tensor-core and bytes bounds of the same work.  A plain
// shared-memory tiled kernel that is exactly right; the main path does
// not run it (backend "auto" on the card picks the int32 designs).

#include "common.cuh"
#include "int32_mma.cuh"
#include "int32_skinny.cuh"

namespace gfmm {
namespace simt {

constexpr int BM = 64;              // output rows per block
constexpr int BN = 64;              // output columns per block
constexpr int BK = 32;              // K depth staged in shared memory per step
constexpr int TX = 16;              // threads along N
constexpr int TY = 16;              // threads along M
constexpr int TM = BM / TY;         // 4 rows per thread
constexpr int TN = BN / TX;         // 4 columns per thread
constexpr int THREADS = TX * TY;    // 256

// The reference's lazy schedule.  After 128 K steps the raw cross sum is
// <= 2 * 128 * 255**2 = 16_646_400 < 2**24 and the final accumulate
// 3*(p-1) + 128*255**2 < 2**24: every float stays an exact integer.
constexpr int LAZY_K = 128;
static_assert(LAZY_K % BK == 0, "reduction period must be whole K steps");
static_assert(THREADS % BN == 0, "the mask pass maps threads onto whole rows of words");
constexpr int LAZY_TILES = LAZY_K / BK;

template <bool MASKED>
__global__ void __launch_bounds__(THREADS) modmatmul_f32_simt(const Params P) {
  // Limbs are split as the operands are staged: hi = x >> 8, lo = x & 255.
  // A is stored K-major so a thread's TM rows are one broadcast read; the
  // +1 column keeps the transposing stores free of bank conflicts.
  __shared__ float a_hi[BK][BM + 1];
  __shared__ float a_lo[BK][BM + 1];
  __shared__ float b_hi[BK][BN];
  __shared__ float b_lo[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int bb = blockIdx.z;
  const int M = P.M, N = P.N, K = P.K;
  const int* __restrict__ a = P.a + (size_t)bb * (size_t)P.a_bs;
  const int* __restrict__ b = P.b + (size_t)bb * (size_t)P.b_bs;

  float hh[TM][TN], mid[TM][TN], ll[TM][TN];
  uint32_t acc[TM][TN];  // running result in [0, p)
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      hh[i][j] = mid[i][j] = ll[i][j] = 0.f;
      acc[i][j] = 0u;
    }

  // Fold the raw limb sums into acc (mod p) and clear them.
  auto fold = [&]() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float h = mod_f(hh[i][j], P.pf, P.inv_p);
        float c = mod_f(mid[i][j], P.pf, P.inv_p);
        float tile = mulmod_const(h, P.hihi_hi, P.hihi_lo, P.pf, P.inv_p) +
                     mulmod_const(c, P.mid_hi, P.mid_lo, P.pf, P.inv_p) + ll[i][j];
        acc[i][j] = (uint32_t)mod_f((float)acc[i][j] + tile, P.pf, P.inv_p);
        hh[i][j] = mid[i][j] = ll[i][j] = 0.f;
      }
  };

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
      a_hi[c][r] = float(x >> 8);
      a_lo[c][r] = float(x & 255u);
    }
#pragma unroll
    for (int l = 0; l < BK * BN / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int r = idx / BN, c = idx % BN;
      const int gk = k0 + r, gn = n0 + c;
      const uint32_t x = (gk < K && gn < N) ? (uint32_t)b[(size_t)gk * N + gn] : 0u;
      b_hi[r][c] = float(x >> 8);
      b_lo[r][c] = float(x & 255u);
    }
    __syncthreads();
    const int kmax = min(BK, K - k0);  // the last step may be ragged
#pragma unroll 4
    for (int kk = 0; kk < kmax; ++kk) {
      float ah[TM], al[TM], bh[TN], bl[TN];
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
    if (++since_fold == LAZY_TILES) {
      fold();
      since_fold = 0;
    }
  }
  fold();

  if constexpr (MASKED) {
    // Add v[row, :] @ R[:, col].  The block makes each of its columns'
    // mask words once, ZSTEP mask rows per pass, into shared memory;
    // every thread then applies them to its TM x TN elements.
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
        mask_r[tid / BN][tid % BN] =  // past z or N: contributes nothing
            (zi < P.z && col < N) ? mask_word(P, (uint32_t)bb, (uint32_t)zi, (uint32_t)col) : 0u;
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

template <bool MASKED>
cudaError_t launch(const Params& P, int batch, cudaStream_t stream) {
  dim3 grid((P.N + BN - 1) / BN, (P.M + BM - 1) / BM, batch);
  modmatmul_f32_simt<MASKED><<<grid, THREADS, 0, stream>>>(P);
  return cudaGetLastError();
}

}  // namespace simt
}  // namespace gfmm

// Launch one product on `stream`.  design: 0 = f32 SIMT, 1 = int32 mma,
// 2 = int32 skinny; masked: 0/1.  The caller (kernel.py) has checked
// shapes, dtypes, contiguity, p < 2**16, the design's shape rule and
// grid limits, and the mask counter space.  Returns the launch's CUDA
// error (0 on success); a refused shape returns cudaErrorInvalidValue.
extern "C" int modmatmul_launch(int design, int masked, const void* a, const void* b,
                                void* out, int batch, int M, int N, int K,
                                long long a_bs, long long b_bs, unsigned p,
                                const void* v, int z, unsigned k0, unsigned k1,
                                void* stream) {
  using namespace gfmm;
  Params P;
  P.a = static_cast<const int*>(a);
  P.b = static_cast<const int*>(b);
  P.out = static_cast<int*>(out);
  P.v = static_cast<const int*>(v);
  P.M = M;
  P.N = N;
  P.K = K;
  P.z = masked ? z : 0;
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
  cudaError_t err;
  switch (design) {
    case 0:
      err = masked ? simt::launch<true>(P, batch, s) : simt::launch<false>(P, batch, s);
      break;
    case 1:
      err = masked ? mma::launch<true>(P, batch, s) : mma::launch<false>(P, batch, s);
      break;
    case 2:
      if (M > SKINNY_MAX_M || K > SKINNY_MAX_K || K + P.z > SKINNY_MAX_TERMS)
        return (int)cudaErrorInvalidValue;
      err = masked ? launch_skinny_rows<true>(P, batch, s) : launch_skinny_rows<false>(P, batch, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}

// The compiled constants the wrapper mirrors (kernel.py checks them
// against its own copy when the library loads).
extern "C" void modmatmul_constants(int* out) {
  out[0] = gfmm::mma::BM;
  out[1] = gfmm::mma::BN;
  out[2] = gfmm::mma::BK;
  out[3] = gfmm::mma::FOLD_K;
  out[4] = gfmm::SKINNY_MAX_M;
  out[5] = gfmm::SKINNY_MAX_K;
  out[6] = gfmm::SKINNY_MAX_TERMS;
  out[7] = gfmm::SKINNY_THREADS;
  out[8] = gfmm::simt::BM;
  out[9] = gfmm::simt::BN;
  out[10] = gfmm::simt::BK;
}
