// modmatmul_int32_mma<VEC, MASKED>: exact GF(p) products of any depth on
// the integer tensor cores.
//
//   out[b] = a[b] @ b_[b] (+ v @ R(key))  (mod p)     [M, K] @ [K, N]
//
// Replaces _modmatmul_int32_kernel (src/repro/kernels/modmatmul/
// kernel.py:152), and _apply_fused_mask (kernel.py:193) with it, for
// every shape the skinny kernel does not take; on the protocol's path
// that is the Phase-2 worker multiply, [68, 256, 2560] @ [68, 2560, 2048]
// at Mistral-NeMo q-projection width.
//
// Arithmetic: the reference's limb decomposition.  x = 256*hi + lo with
// both limbs in [0, 255], so the operands are u8, and
//
//   a @ b = 2**16 (ah @ bh) + 2**8 (ah @ bl + al @ bh) + al @ bl
//
// The four limb dots run as wgmma.mma_async m64n64k32 .s32.u8.u8 into
// three s32 accumulator sets: hh, mid (the two cross dots share one) and
// ll.  mid gains at most 2 * 255**2 = 130_050 per K step, so the sets are
// folded through the Barrett recombination every FOLD_K = 16_512 K
// (16_512 * 130_050 = 2_147_385_600 < 2**31): no value relies on
// wrap-around, and the kernel has no depth limit.  The fold leaves the
// running residue (< p) in ll, which then gains at most 16_512 * 255**2
// more, still below 2**31.
//
// What bounds it on the H100.  At the Phase-2 multiply the work is 0.73
// T int8 operations (four limb dots of 2 * 68 * 256 * 2560 * 2048):
// 0.37 ms at 1 979 TOPS; the bytes are 1.75 GB (A and B read once, out
// written once): 0.52 ms at 3.35 TB/s.  So it is bound by bytes if the
// tensor cores run near their rate.  In this design shared memory binds
// first: per 128 x 128 x 32 block step the staged int32 tiles are
// written (32 KB) and read back by the split, the split writes 16 KB of
// u8 planes, and the four warpgroups' wgmma read 64 KB of them, so the
// staging and the products contend for the same bandwidth (PERF.md has
// the measurements).  What the design does about the bound:
//
// * The operands stay int32 until shared memory, so each K step moves
//   4 bytes per element for one u8 limb product: a block's tiles are
//   re-read from L2 by every block of its row or column, and that L2
//   traffic, not HBM, is what a small block tile runs into.  One 128 x
//   128 block per SM halves it against 128 x 64.
// * B (1.43 GB of the 1.75) is read from device memory about once:
//   blocks are numbered M tile fastest, so the M tiles that share a B
//   panel run side by side and the second read hits L2.
// * The int32 tiles arrive by cp.async in a ring of STAGES buffers, so a
//   tile is requested STAGES - 2 K steps before it is split.
// * The limbs are split inside the kernel, from the staged int32 tile
//   into u8 planes in shared memory, with no pass over device memory.
//   For 8-bit types wgmma takes both operands K-major from shared
//   memory, and ldmatrix's transpose works on 16-bit elements only, so
//   the split writes B's planes transposed, [N][K].  The planes are in
//   wgmma's unswizzled K-major layout: 8-row x 16-byte core matrices,
//   each 128 contiguous bytes.
// * wgmma reads both operands from shared memory itself: no fragment
//   registers and no fragment loads.  Four warpgroups each own a 64 x 64
//   output tile: 96 accumulator registers a thread.  The wgmma of tile
//   k run asynchronously while the same warps split tile k+1, and stay
//   in flight across the next barrier (three plane buffers); one
//   barrier per K tile.
#pragma once

#include "common.cuh"

namespace gfmm {
namespace mma {

constexpr int BM = 128;  // output rows per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 32;   // K depth per stage: one k32 wgmma step
constexpr int WG_M = 2;  // warpgroups along M
constexpr int WG_N = 2;  // warpgroups along N
constexpr int THREADS = 128 * WG_M * WG_N;  // 512
constexpr int WGM = BM / WG_M;              // 64 rows per warpgroup
constexpr int WGN = BN / WG_N;              // 64 columns per warpgroup
static_assert(WGM == 64 && WGN == 64, "the wgmma instruction below is m64n64k32");
constexpr int ACC = WGM * WGN / 128;        // 32 accumulators a thread per set
constexpr int STAGES = 4;                   // int32 tiles in the cp.async ring

constexpr int FOLD_K = 16512;
static_assert((unsigned long long)FOLD_K * 2ull * 255ull * 255ull < (1ull << 31),
              "the merged cross accumulator would pass 2**31 between folds");
static_assert((unsigned long long)FOLD_K * 255ull * 255ull + 65535ull < (1ull << 31),
              "ll carries the residue (< p) plus one fold period of products");
static_assert(FOLD_K % BK == 0, "fold period must be whole K tiles");
constexpr int FOLD_TILES = FOLD_K / BK;

// Staged int32 tiles.  A rows are padded to A_STRIDE ints so that eight
// rows' 16-byte reads at one K offset fall in eight different bank
// groups; B's 16-byte column chunks are XOR-swizzled by row (b_chunk) so
// that four rows 4 apart at eight columns fall in 32 different banks.
constexpr int A_STRIDE = BK + 4;
constexpr int TILE_A_INTS = BM * BK;         // the values of one A tile
constexpr int STAGE_A_INTS = BM * A_STRIDE;  // int32 [BM][A_STRIDE]
constexpr int STAGE_B_INTS = BK * BN;        // int32 [BK][BN], chunks swizzled
constexpr int STAGE_INTS = STAGE_A_INTS + STAGE_B_INTS;
// one plane buffer: A hi, A lo ([BM][BK] u8 each), B hi, B lo ([BN][BK] u8)
constexpr int PLANE_A_WORDS = BM * BK / 4;
constexpr int PLANE_B_WORDS = BN * BK / 4;
constexpr int PLANES_WORDS = 2 * (PLANE_A_WORDS + PLANE_B_WORDS);
constexpr int PLANE_BUFS = 3;  // split, multiplied, and still being read by wgmma
constexpr int SMEM_BYTES = 4 * (STAGES * STAGE_INTS + PLANE_BUFS * PLANES_WORDS);  // 184 KB
constexpr int ZSTEP = THREADS / BN;  // mask rows made per pass of the epilogue
static_assert(THREADS % BN == 0, "the mask pass maps threads onto whole rows of words");
static_assert(ZSTEP * BN <= STAGES * STAGE_INTS, "the mask rows reuse the staging ring");

// The unswizzled K-major layout of a [rows][32] u8 plane: core matrix
// (r / 8, k / 16) is 8 rows of 16 bytes, 128 contiguous bytes; core
// matrices adjacent in K are LBO = 128 bytes apart, adjacent 8-row groups
// SBO = 256 bytes.  Word offset of bytes 4w..4w+3 of row r:
__device__ __forceinline__ int plane_word(int r, int w) {
  return (r >> 3) * 64 + (w >> 2) * 32 + (r & 7) * 4 + (w & 3);
}

// Position of B's 16-byte column chunk c in staged row k.
__device__ __forceinline__ int b_chunk(int k, int c) { return c ^ (((k >> 2) & 3) << 1); }

// wgmma shared-memory matrix descriptor of a plane tile starting at row
// group `base` (16-byte units: start, LBO = 128 B, SBO = 256 B; no swizzle).
__device__ __forceinline__ uint64_t plane_desc(const uint32_t* base) {
  return (uint64_t)((smem_addr(base) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

// x0..x3 (each < 2**16, consecutive in K) -> their lo and hi bytes packed
// in K order, the lowest K in the lowest byte.
__device__ __forceinline__ void split_limbs(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3,
                                            uint32_t& hi, uint32_t& lo) {
  const uint32_t t01 = __byte_perm(x0, x1, 0x5140);  // x0.b0 x1.b0 x0.b1 x1.b1
  const uint32_t t23 = __byte_perm(x2, x3, 0x5140);
  lo = __byte_perm(t01, t23, 0x5410);  // x0.b0 x1.b0 x2.b0 x3.b0
  hi = __byte_perm(t01, t23, 0x7632);  // x0.b1 x1.b1 x2.b1 x3.b1
}

// d[64 x 64, s32] += A[64 x 32, u8] @ B[32 x 64, u8], both K-major in
// shared memory.  Thread t of the warpgroup holds, for n8 tile j,
// d[4j + 2h + c] = D[16 * (t / 32) + (t % 32) / 4 + 8h][8j + 2 * (t % 4) + c].
__device__ __forceinline__ void wgmma_u8(uint32_t (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.u8.u8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: d += a @ b
}

// Stage the int32 tiles A[m0:+BM, k0:+BK] and B[k0:+BK, n0:+BN] into one
// ring slot; ragged edges are zero-filled.  VEC: K % 4 == 0, N % 4 == 0
// and 16-byte aligned operands, so 16-byte copies never straddle an edge.
template <bool VEC>
__device__ __forceinline__ void load_tile(int* slot, const int* __restrict__ a,
                                          const int* __restrict__ b, int m0, int n0, int k0,
                                          int M, int N, int K, int tid) {
  const uint32_t sa = smem_addr(slot);
  const uint32_t sb = smem_addr(slot + STAGE_A_INTS);
  if constexpr (VEC) {
#pragma unroll
    for (int l = 0; l < TILE_A_INTS / 4 / THREADS; ++l) {
      const int c = tid + l * THREADS;
      const int r = c / (BK / 4), kc = (c % (BK / 4)) * 4;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async16(sa + 4 * (r * A_STRIDE + kc), ok ? a + (size_t)(m0 + r) * K + k0 + kc : a, ok);
    }
#pragma unroll
    for (int l = 0; l < STAGE_B_INTS / 4 / THREADS; ++l) {
      const int c = tid + l * THREADS;
      const int r = c / (BN / 4), nc = (c % (BN / 4)) * 4;
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async16(sb + 4 * (r * BN + 4 * b_chunk(r, nc / 4)), ok ? b + (size_t)(k0 + r) * N + n0 + nc : b,
                 ok);
    }
  } else {
#pragma unroll 4
    for (int l = 0; l < TILE_A_INTS / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BK, kc = e % BK;
      const bool ok = m0 + r < M && k0 + kc < K;
      cp_async4(sa + 4 * (r * A_STRIDE + kc), ok ? a + (size_t)(m0 + r) * K + k0 + kc : a, ok);
    }
#pragma unroll 4
    for (int l = 0; l < STAGE_B_INTS / THREADS; ++l) {
      const int e = tid + l * THREADS;
      const int r = e / BN, nc = e % BN;
      const bool ok = k0 + r < K && n0 + nc < N;
      cp_async4(sb + 4 * (r * BN + 4 * b_chunk(r, nc / 4) + nc % 4),
                ok ? b + (size_t)(k0 + r) * N + n0 + nc : b, ok);
    }
  }
}

// Staged int32 tile -> u8 planes: A as [BM][BK] (rows are K-contiguous
// already), B transposed to [BN][BK].  Each warp's 32 stores cover the
// 8 rows x 4 words of a bank-conflict-free set: lane -> row (lane & 7)
// and word (lane >> 3) of a group.  The stores are generic-proxy writes
// that wgmma (the async proxy) reads after the next barrier, so they are
// fenced for it.
__device__ __forceinline__ void split_tile(const int* slot, uint32_t* planes, int tid) {
  const int* sa = slot;
  const int* sb = slot + STAGE_A_INTS;
  uint32_t* a_hi = planes;
  uint32_t* a_lo = planes + PLANE_A_WORDS;
  uint32_t* b_hi = planes + 2 * PLANE_A_WORDS;
  uint32_t* b_lo = b_hi + PLANE_B_WORDS;
  const int lane = tid & 31;
#pragma unroll
  for (int l = 0; l < PLANE_A_WORDS / THREADS; ++l) {
    const int grp = tid / 32 + l * (THREADS / 32);  // (row group, word half)
    const int r = (grp >> 1) * 8 + (lane & 7), kw = (grp & 1) * 4 + (lane >> 3);
    const int4 x = *reinterpret_cast<const int4*>(sa + r * A_STRIDE + kw * 4);
    uint32_t hi, lo;
    split_limbs(x.x, x.y, x.z, x.w, hi, lo);
    const int o = plane_word(r, kw);
    a_hi[o] = hi;
    a_lo[o] = lo;
  }
#pragma unroll
  for (int l = 0; l < PLANE_B_WORDS / THREADS; ++l) {
    const int grp = tid / 32 + l * (THREADS / 32);
    const int n = (grp >> 1) * 8 + (lane & 7), kw = (grp & 1) * 4 + (lane >> 3);
    uint32_t x[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 4 * kw + j;
      x[j] = (uint32_t)sb[k * BN + 4 * b_chunk(k, n / 4) + n % 4];
    }
    uint32_t hi, lo;
    split_limbs(x[0], x[1], x[2], x[3], hi, lo);
    const int o = plane_word(n, kw);
    b_hi[o] = hi;
    b_lo[o] = lo;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <bool VEC, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1) modmatmul_int32_mma(const Params P, int m_tiles) {
  extern __shared__ __align__(128) int smem[];
  int* ring = smem;                                                            // STAGES slots
  uint32_t* planes = reinterpret_cast<uint32_t*>(smem + STAGES * STAGE_INTS);  // PLANE_BUFS

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid / 128, wq = (tid / 32) % 4;  // warpgroup, warp within it
  const int wg_m = wg % WG_M, wg_n = wg / WG_M;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = (blockIdx.x % m_tiles) * BM;
  const int n0 = (blockIdx.x / m_tiles) * BN;
  const int bb = blockIdx.y;
  const int M = P.M, N = P.N, K = P.K;
  const int* __restrict__ a = P.a + (size_t)bb * (size_t)P.a_bs;
  const int* __restrict__ b = P.b + (size_t)bb * (size_t)P.b_bs;

  uint32_t hh[ACC], mid[ACC], ll[ACC];
#pragma unroll
  for (int e = 0; e < ACC; ++e) hh[e] = mid[e] = ll[e] = 0u;

  auto fold = [&]() {
#pragma unroll
    for (int e = 0; e < ACC; ++e) {
      ll[e] = recombine(hh[e], mid[e], ll[e], P);
      hh[e] = mid[e] = 0u;
    }
  };

  // this warpgroup's A rows and B columns within a plane: whole 8-row
  // groups, so a descriptor is the plane's start plus 256 B per group
  const int a_off = wg_m * WGM * BK / 4;  // words
  const int b_off = wg_n * WGN * BK / 4;
  auto products = [&](const uint32_t* pl) {
    const uint64_t a_hi = plane_desc(pl + a_off);
    const uint64_t a_lo = plane_desc(pl + PLANE_A_WORDS + a_off);
    const uint64_t b_hi = plane_desc(pl + 2 * PLANE_A_WORDS + b_off);
    const uint64_t b_lo = plane_desc(pl + 2 * PLANE_A_WORDS + PLANE_B_WORDS + b_off);
    wgmma_fence();
    wgmma_u8(hh, a_hi, b_hi);
    wgmma_u8(mid, a_hi, b_lo);
    wgmma_u8(mid, a_lo, b_hi);
    wgmma_u8(ll, a_lo, b_lo);
    wgmma_commit();
  };

  // Pipeline: tile t is staged in ring slot t % STAGES and split into
  // plane buffer t % PLANE_BUFS.  Iteration kt: wait for tile kt+1, one
  // barrier, request tile kt+STAGES-1, start the products of tile kt,
  // split tile kt+1 meanwhile, then wait for the products of tile kt-1:
  // one wgmma group stays in flight across the barrier.
  const int ntiles = (K + BK - 1) / BK;
  auto slot = [&](int t) { return ring + (t % STAGES) * STAGE_INTS; };
  auto plane = [&](int t) { return planes + (t % PLANE_BUFS) * PLANES_WORDS; };
  auto settle = [&]() {  // every product started so far is in the registers
    wgmma_wait<0>();
    fence_operands(hh);
    fence_operands(mid);
    fence_operands(ll);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) load_tile<VEC>(slot(s), a, b, m0, n0, s * BK, M, N, K, tid);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  split_tile(slot(0), plane(0), tid);
  // The fold runs between fold periods, with no product in flight: an
  // accumulator written by other code inside the pipeline would make
  // ptxas serialize every wgmma.
  for (int kt0 = 0; kt0 < ntiles; kt0 += FOLD_TILES) {
    const int kend = min(ntiles, kt0 + FOLD_TILES);
    for (int kt = kt0; kt < kend; ++kt) {
      cp_async_wait<STAGES - 3>();
      // tile kt+1 has landed for every thread; plane(kt) is complete;
      // every warpgroup's products of tile kt-2, the last reader of
      // plane(kt+1), are done, and so is the split of the slot tile
      // kt+STAGES-1 reuses
      __syncthreads();
      const int ahead = kt + STAGES - 1;
      if (ahead < ntiles) load_tile<VEC>(slot(ahead), a, b, m0, n0, ahead * BK, M, N, K, tid);
      cp_async_commit();
      products(plane(kt));
      if (kt + 1 < ntiles) split_tile(slot(kt + 1), plane(kt + 1), tid);
      wgmma_wait<1>();  // the products of tile kt-1 are done
    }
    settle();
    fold();
  }
  // ll now holds the product mod p

  // accumulator e of this thread: n8 tile j = e / 4, row half h, column c
  const int row0 = m0 + wg_m * WGM + 16 * wq + g;  // + 8h
  const int col0 = wg_n * WGN + 2 * tq;            // + 8j + c, within the block

  if constexpr (MASKED) {
    // the mask words go into the idle staging ring
    cp_async_wait<0>();
    __syncthreads();
    add_fused_mask<THREADS, BN, ACC / 4>(ll, P, reinterpret_cast<uint32_t*>(ring), tid, bb, n0,
                                         row0, col0, [] { __syncthreads(); });
  }

  int* __restrict__ out = P.out + (size_t)bb * (size_t)M * (size_t)N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < ACC / 4; ++j) {
      const int col = n0 + col0 + 8 * j;
      int* dst = out + (size_t)row * N + col;
      const uint32_t x0 = ll[4 * j + 2 * h], x1 = ll[4 * j + 2 * h + 1];
      if (VEC && col + 1 < N) {
        *reinterpret_cast<int2*>(dst) = make_int2((int)x0, (int)x1);
      } else {
        if (col < N) dst[0] = (int)x0;
        if (col + 1 < N) dst[1] = (int)x1;
      }
    }
  }
}

template <bool VEC, bool MASKED>
cudaError_t launch_vec(const Params& P, int batch, cudaStream_t stream) {
  auto kernel = modmatmul_int32_mma<VEC, MASKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int m_tiles = (P.M + BM - 1) / BM;
  const long long blocks = (long long)m_tiles * ((P.N + BN - 1) / BN);
  dim3 grid((unsigned)blocks, batch);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(P, m_tiles);
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t launch(const Params& P, int batch, cudaStream_t stream) {
  const bool vec = P.K % 4 == 0 && P.N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(P.a) | reinterpret_cast<uintptr_t>(P.b) |
                    reinterpret_cast<uintptr_t>(P.out)) % 16 == 0;
  return vec ? launch_vec<true, MASKED>(P, batch, stream) : launch_vec<false, MASKED>(P, batch, stream);
}

}  // namespace mma
}  // namespace gfmm
