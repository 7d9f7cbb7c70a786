// Exact GF(p) matrix multiplication, p < 2**16, for Hopper (sm_90a).
//
//   out[b] = a[b] @ b_[b] (mod p)          [B, M, K] @ [B, K, N] -> [B, M, N]
//   out[b] += v @ R(key)  (mod p)          MASKED: blinding fused in
//   out[b] = a[b] @ h[b][rows] + v @ r[b]  skinny only: rows picked, z rows loaded
//   out[b] = a[b] @ blocks(x[b]) + v @ r[b] skinny only: blocks read in place, z rows loaded
//
// All operands are int32 in [0, p); either side may be a single 2D
// matrix shared by every batch element (batch stride 0, never copied).
//
// Four compiled designs, each with a MASKED form, replace the three
// Pallas tile bodies of the JAX package
// (src/repro/kernels/modmatmul/kernel.py):
//
//   modmatmul_int32_mma     (int32_mma.cuh) <- _modmatmul_int32_kernel (kernel.py:152)
//                                              and _apply_fused_mask (kernel.py:193),
//                                              every int32 shape not skinny
//   modmatmul_int32_skinny  (skinny.cuh)    <- the same two, for M <= 32, K <= 32
//   modmatmul_f32_wgmma     (f32_wgmma.cuh) <- _modmatmul_kernel (kernel.py:101)
//                                              and _apply_fused_mask, every f32
//                                              shape not skinny
//   modmatmul_f32_skinny    (skinny.cuh)    <- the same two, for M <= 32, K <= 32
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

#include "common.cuh"
#include "f32_wgmma.cuh"
#include "int32_mma.cuh"
#include "skinny.cuh"

// Launch one product on `stream`.  design: 1 = int32 mma, 2 = int32
// skinny, 3 = f32 wgmma, 4 = f32 skinny; masked: 0/1.  The caller
// (kernel.py) has checked shapes, dtypes, contiguity, p < 2**16, the
// design's shape rule and grid limits, and the mask counter space, and
// passes `scratch` of modmatmul_scratch_bytes (f32 wgmma: A's planes).
// Returns the launch's CUDA error (0 on success); a refused shape or
// design returns cudaErrorInvalidValue.
static gfmm::Params make_params(const void* a, const void* b, void* out, int M, int N, int K,
                                long long a_bs, long long b_bs, unsigned p, const void* v, int z) {
  gfmm::Params P{};
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
  P.pf = (float)p;
  P.inv_p = 1.f / (float)p;
  return P;
}

extern "C" int modmatmul_launch(int design, int masked, const void* a, const void* b,
                                void* out, int batch, int M, int N, int K,
                                long long a_bs, long long b_bs, unsigned p,
                                const void* v, int z, unsigned k0, unsigned k1,
                                void* scratch, void* stream) {
  using namespace gfmm;
  Params P = make_params(a, b, out, M, N, K, a_bs, b_bs, p, v, masked ? z : 0);
  P.k0 = k0;
  P.k1 = k1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case 1:
      return (int)(masked ? mma::launch<true>(P, batch, s) : mma::launch<false>(P, batch, s));
    case 2:
      return (int)(masked ? launch_skinny_by_m<SkinnyInt32, Extra::mask>(P, batch, s)
                          : launch_skinny_by_m<SkinnyInt32, Extra::none>(P, batch, s));
    case 3:
      if (scratch == nullptr) return (int)cudaErrorInvalidValue;
      return (int)(masked ? wgmma_f32::launch<true>(P, batch, static_cast<unsigned char*>(scratch), s)
                          : wgmma_f32::launch<false>(P, batch, static_cast<unsigned char*>(scratch), s));
    case 4:
      return (int)(masked ? launch_skinny_by_m<SkinnyF32, Extra::mask>(P, batch, s)
                          : launch_skinny_by_m<SkinnyF32, Extra::none>(P, batch, s));
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Launch out[b] = a[b] @ h[b][rows] + v @ r[b] (mod p) on `stream`: the
// skinny designs' loaded-rows form, design 2 (int32) or 4 (f32).  h's
// rows are N apart and its batch elements h_bs apart; rows [K] (int64,
// device memory) index h's rows; v [M, z]; r's z rows are N apart and
// its batch elements r_bs apart.  The caller (kernel.py) has checked
// what it checks for modmatmul_launch; the indices are read unchecked,
// so keeping them inside h is its caller's part.
extern "C" int modmatmul_rows_plus_launch(int design, const void* a, const void* h,
                                          const void* rows, const void* v, const void* r,
                                          void* out, int batch, int M, int N, int K, int z,
                                          long long a_bs, long long h_bs, long long r_bs,
                                          unsigned p, void* stream) {
  using namespace gfmm;
  Params P = make_params(a, h, out, M, N, K, a_bs, h_bs, p, v, z);
  P.offs = static_cast<const long long*>(rows);
  P.bc = P.ld = N;  // term k is the whole row rows[k]
  P.r = static_cast<const int*>(r);
  P.r_bs = r_bs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case 2: return (int)launch_skinny_by_m<SkinnyInt32, Extra::loaded>(P, batch, s);
    case 4: return (int)launch_skinny_by_m<SkinnyF32, Extra::loaded>(P, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch out[b] = a[b] @ blocks(x[b]) + v @ r[b] (mod p) on `stream`: the
// skinny designs' blocks form, design 2 (int32) or 4 (f32).  Term k < K
// is block k of x: output column n reads x[offs[k] + (n / bc) * ld + n %
// bc], x's batch elements x_bs apart; offs [K] (int64, device memory)
// are element offsets; v [M, z]; r's z rows are N apart and its batch
// elements r_bs apart.  N is a whole number of block rows of bc
// columns.  The caller (kernel.py) has checked what it checks for
// modmatmul_launch; the offsets are read unchecked, so keeping every
// block inside x is its caller's part.
extern "C" int modmatmul_blocks_plus_launch(int design, const void* a, const void* x,
                                            const void* offs, const void* v, const void* r,
                                            void* out, int batch, int M, int N, int K, int z,
                                            long long a_bs, long long x_bs, long long r_bs,
                                            long long bc, long long ld, unsigned p, void* stream) {
  using namespace gfmm;
  Params P = make_params(a, x, out, M, N, K, a_bs, x_bs, p, v, z);
  P.offs = static_cast<const long long*>(offs);
  P.bc = bc;
  P.ld = ld;
  P.r = static_cast<const int*>(r);
  P.r_bs = r_bs;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (design) {
    case 2: return (int)launch_skinny_by_m<SkinnyInt32, Extra::loaded, true>(P, batch, s);
    case 4: return (int)launch_skinny_by_m<SkinnyF32, Extra::loaded, true>(P, batch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Device scratch bytes one launch of `design` needs (batch_a: A's batch,
// 1 for a shared 2D A).
extern "C" long long modmatmul_scratch_bytes(int design, int batch_a, int M, int K) {
  if (design != 3) return 0;
  gfmm::Params P{};
  P.M = M;
  P.K = K;
  return (long long)gfmm::wgmma_f32::a_split_bytes(P, batch_a);
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
  out[8] = gfmm::wgmma_f32::BM;
  out[9] = gfmm::wgmma_f32::BN;
  out[10] = gfmm::wgmma_f32::BK;
  out[11] = gfmm::wgmma_f32::FOLD_K;
}
