// modmatmul_f32_wgmma<VEC, MASKED>: exact GF(p) products of any depth
// from float arithmetic on 8-bit limbs, on the fp16 tensor cores.
//
//   out[b] = a[b] @ b_[b] (+ v @ R(key))  (mod p)     [M, K] @ [K, N]
//
// Replaces _modmatmul_kernel (src/repro/kernels/modmatmul/kernel.py:101),
// and _apply_fused_mask (kernel.py:193) with it, for every f32-variant
// shape the skinny kernel does not take; on the protocol's path that is
// the Phase-2 worker multiply, [68, 256, 2560] @ [68, 2560, 2048] at
// Mistral-NeMo q-projection width (backend "cuda").  Two launches: the
// pre-pass split_a_planes, then modmatmul_f32_wgmma.
//
// Arithmetic.  x = 256*hi + lo with both limbs in [0, 255].  An 8-bit
// limb is exact in fp16 (11 significant bits), a limb product is below
// 2**16, and the f32 accumulator stays exact while every partial sum is
// an integer below 2**24.  With a' = 256*a mod p,
//
//   a*b = a*(256*b_hi) + a*b_lo == a'*b_hi + a*b_lo
//       == 256*(a'_hi*b_hi + a_hi*b_lo) + (a'_lo*b_hi + a_lo*b_lo)  (mod p)
//
// so two accumulator sets suffice, W1 and W0, each a product of depth
// 2K that shares B's planes: [a'_hi | a_hi] and [a'_lo | a_lo] against
// [b_hi ; b_lo].  A is the small operand, so the prescale is one Barrett
// per A element as A is split.  Each set gains at most 2 * 255**2 =
// 130_050 per K; the sets are folded in place every FOLD_K = 128 K, after
// which |W| < p, and the next 128 K add at most 16_646_400 (65_520 +
// 16_646_400 < 2**24).  The final 256*W1 + W0 is
// formed once, in integers, in the epilogue.
//
// What bounds it on the H100.  At the Phase-2 multiply the bytes bound is
// 0.522 ms (A and B read once as int32, out written once, at 3.35 TB/s);
// the fp16 tensor-core floor of this design is 8 * 68 * 256 * 2560 *
// 2048 / 989e12 = 0.738 ms (two sets, depth 2K).  Below those, what bound
// the first versions (PERF.md, ablate.py) was the SM's issue slots: the
// limb split of the int32 operands, done in every block for its tiles,
// costs as many instructions as the wgmma leave free.  The design:
//
// * A's split runs once, in a pre-pass (split_a_planes): A (the small
//   operand) becomes its fp16 planes in device memory, 8 bytes per
//   element, with the prescale (one Barrett per element) done there and
//   not once per N tile.  The main kernel copies the planes as they are.
// * Warp specialization.  Warpgroups 0 and 1 are the producer of B: they
//   keep B's int32 tiles in flight by cp.async, RING_STAGES - 1 K tiles
//   ahead, in a ring of slots (zero-filled past the ragged edges) that
//   is theirs alone (cp.async.wait_group and a named barrier of their
//   256 threads), and split each landed tile into B's fp16 planes, a
//   ring of PLANE_STAGES buffers guarded by mbarriers (full: planes
//   written; empty: both consumers' products of the buffer done).  One
//   producer warpgroup was too few to split B at the products' pace.
//   setmaxnreg moves registers from the producers to the consumers.
// * Two consumer warpgroups each own a 64 x 128 output tile (64 f32 per
//   thread per set: 128 accumulator registers).  Each copies its 64 rows
//   of A's planes by cp.async into its own rows of A_STAGES buffers, two
//   K tiles ahead, and runs wgmma.mma_async m64n128k16 .f32.f16.f16.
// * The fold needs its set out of flight, and a fold inside the
//   pipelined loop makes ptxas serialize the wgmma.  So each consumer
//   drains and folds between fold periods, and the two fold at different
//   times (the second one's first period is half long): while one
//   warpgroup folds on the FP32 pipe, the other's wgmma keep the tensor
//   cores busy.  A fold is three ops per accumulator (fold_f), which
//   leaves the set in (-p, p); the epilogue reduces it into [0, p).
// * The split is branch-free byte shuffling: a PRMT puts each byte of
//   the int32 value under 0x64 (the fp16 value 1024 + limb), one HSUB2
//   leaves both limbs of a pair; no I2F.  The planes are K-major with
//   the 128-byte swizzle, which wgmma reads with no bank conflicts and
//   the split writes with none (a warp's 16-byte stores cover each 8-row
//   swizzle atom's eight chunk positions).
// * The grid is (N tiles, M tiles, batch): N tiles fastest, up to
//   2**31 - 1 of them; M tiles up to 65535 (M < 8.4M).  The N tiles that
//   share an A tile run side by side, and at the protocol's shapes (two
//   M tiles) both readers of a B panel run in the same wave, so the
//   second read of B hits L2.  No integer division picks the tile: its
//   SASS would convert with I2F.
#pragma once

#include "common.cuh"

namespace gfmm {
namespace wgmma_f32 {

constexpr int BM = 128;  // output rows per block: one 64-row tile per consumer
constexpr int BN = 128;  // output columns per block
constexpr int BK = 32;   // int32 K per stage: fp16 operands 2 * BK = 64 deep
constexpr int PRODUCERS = 2;  // warpgroups
constexpr int CONSUMERS = 2;
constexpr int PTHREADS = 128 * PRODUCERS;
constexpr int THREADS = PTHREADS + 128 * CONSUMERS;  // 512
constexpr int RING_STAGES = 4;   // B's int32 tiles: RING_STAGES - 1 in flight
constexpr int PLANE_STAGES = 3;  // B's fp16 plane buffers between producer and consumers
constexpr int A_STAGES = 3;      // A plane buffers, each consumer's rows its own
constexpr int NJ = BN / 8;          // n8 tiles of a consumer's row
constexpr int ACC = 64 * BN / 128;  // f32 accumulators a thread per set: 64
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 216;
static_assert(PTHREADS * PRODUCER_REGS + 128 * CONSUMERS * CONSUMER_REGS <= 65536 / THREADS / 8 * 8 * THREADS,
              "setmaxnreg must not ask for more registers than the launch holds");

constexpr int FOLD_K = 128;
static_assert(FOLD_K * 2 * 255 * 255 + 65520 < (1 << 24),
              "a set carries its residue (< p) plus one fold period of limb products");
static_assert(FOLD_K % BK == 0 && FOLD_K / BK % 2 == 0, "fold period must be an even count of K tiles");
constexpr int FOLD_TILES = FOLD_K / BK;

constexpr int ROW_BYTES = 2 * BK * 2;  // a plane row: 64 halves, one 128-byte swizzle row
static_assert(ROW_BYTES == 128, "the planes use the 128-byte swizzle");
constexpr int PLANE_A_BYTES = BM * ROW_BYTES;  // W1's A plane, then W0's
constexpr int A_STAGE_BYTES = 2 * PLANE_A_BYTES;
constexpr int PLANE_B_BYTES = BN * ROW_BYTES;
constexpr int SLOT_BYTES = BK * BN * 4;  // one int32 B tile [BK][BN]
// A's planes in device memory (split_a_planes): per (batch, row, K tile)
// 256 bytes, W1's 128-byte plane row [a'_hi | a_hi] then W0's [a'_lo | a_lo]
constexpr int A_TILE_ROW_BYTES = 2 * ROW_BYTES;
constexpr int BAR_BYTES = 8 * 2 * PLANE_STAGES;
constexpr int SMEM_BYTES = A_STAGES * A_STAGE_BYTES + PLANE_STAGES * PLANE_B_BYTES +
                           RING_STAGES * SLOT_BYTES + BAR_BYTES + 1024;  // + alignment slack
static_assert(SMEM_BYTES <= 232448, "more shared memory than a block can have");

// Byte offset of 16-byte chunk c of row r in a plane of 128-byte rows
// with the 128-byte swizzle (TMA's SWIZZLE_128B, wgmma's layout type 1):
// chunk c of row r sits at chunk c ^ (r % 8) of an 8-row, 1024-byte atom.
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma descriptor of a K-major plane with the 128-byte swizzle starting
// at shared address `saddr` (1024-byte aligned): SBO = 1024 bytes between
// 8-row atoms; LBO is unused by swizzled K-major layouts (1 by
// convention).  A k16 step advances the start by 32 bytes (+2).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

// d[64 x 128, f32] += A[64 x 16, f16] @ B[16 x 128, f16], both K-major in
// shared memory.  Thread t of the warpgroup holds, for n8 tile j,
// d[4j + 2h + c] = D[16 * (t / 32) + (t % 32) / 4 + 8h][8j + 2 * (t % 4) + c].
__device__ __forceinline__ void wgmma_f16(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));  // scale-d = 1: d += a @ b
}

// A [batch, M, K] int32 -> its fp16 planes in device memory, in the
// order the main kernel copies them: [batch][M][K tile][W1 row | W0 row],
// zero past K.  One thread per 8-value K chunk of a row; the grid is (K
// chunks / 128, min(M, 65535), batch) and a block strides over the rows
// by gridDim.y, so there is no integer division and no cap on M.
template <bool VEC>
__global__ void __launch_bounds__(128) split_a_planes(const Params P, unsigned char* planes,
                                                      int ntiles) {
  const int item = blockIdx.x * 128 + threadIdx.x;  // K tile * 4 + chunk
  if (item >= ntiles * 4) return;
  const int bb = blockIdx.z, K = P.K;
  const int gk = 8 * item;
  const int kt = item >> 2, kc = item & 3;
  for (int m = blockIdx.y; m < P.M; m += gridDim.y) {
    const int* src = P.a + (size_t)bb * (size_t)P.a_bs + (size_t)m * K + gk;
    uint32_t x[8];
    if constexpr (VEC) {  // K % 4 == 0: a 16-byte chunk is all in or all out
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int4 v = make_int4(0, 0, 0, 0);
        if (gk + 4 * h < K) v = __ldg(reinterpret_cast<const int4*>(src) + h);
        x[4 * h] = v.x;
        x[4 * h + 1] = v.y;
        x[4 * h + 2] = v.z;
        x[4 * h + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = gk + e < K ? (uint32_t)__ldg(src + e) : 0u;
    }
    uint32_t ap[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) ap[e] = barrett(x[e] << 8, P.p, P.mu);  // 256a mod p
    uint4 ah, al, aph, apl;
    limbs_h2(x[0], x[1], al.x, ah.x);
    limbs_h2(x[2], x[3], al.y, ah.y);
    limbs_h2(x[4], x[5], al.z, ah.z);
    limbs_h2(x[6], x[7], al.w, ah.w);
    limbs_h2(ap[0], ap[1], apl.x, aph.x);
    limbs_h2(ap[2], ap[3], apl.y, aph.y);
    limbs_h2(ap[4], ap[5], apl.z, aph.z);
    limbs_h2(ap[6], ap[7], apl.w, aph.w);
    uint4* dst = reinterpret_cast<uint4*>(
        planes + (((size_t)bb * P.M + m) * ntiles + kt) * A_TILE_ROW_BYTES);
    dst[kc] = aph;       // W1: [a'_hi | a_hi]
    dst[4 + kc] = ah;
    dst[8 + kc] = apl;   // W0: [a'_lo | a_lo]
    dst[12 + kc] = al;
  }
}

template <bool VEC, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1) modmatmul_f32_wgmma(const Params P,
                                                                   const unsigned char* a_split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms must be 1024-byte aligned in the shared window
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* a_planes = smem_raw + (base - raw);                 // A_STAGES
  unsigned char* b_planes = a_planes + A_STAGES * A_STAGE_BYTES;     // PLANE_STAGES
  unsigned char* ring = b_planes + PLANE_STAGES * PLANE_B_BYTES;     // RING_STAGES
  const uint32_t a_base = base, b_base = base + A_STAGES * A_STAGE_BYTES;
  const uint32_t bars = b_base + PLANE_STAGES * PLANE_B_BYTES + RING_STAGES * SLOT_BYTES;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (PLANE_STAGES + s); };

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  // grid (N tiles, M tiles, batch): no integer division, whose SASS
  // would convert with I2F
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int bb = blockIdx.z;
  const int M = P.M, N = P.N, K = P.K;
  const int ntiles = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < PLANE_STAGES; ++s) {
      mbar_init(full_bar(s), PTHREADS);         // every producer thread
      mbar_init(empty_bar(s), 128 * CONSUMERS);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg < PRODUCERS) {
    // ---------------- producer: B's int32 tiles -> fp16 planes ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int* __restrict__ b = P.b + (size_t)bb * (size_t)P.b_bs;
    auto producer_sync = [] { asm volatile("bar.sync 2, %0;\n" ::"n"(PTHREADS) : "memory"); };
    // Stage the int32 tile B[k0:+BK, n0:+BN] into its ring slot; ragged
    // edges are zero-filled.  VEC: N % 4 == 0 and 16-byte aligned
    // operands, so a 16-byte copy never straddles an edge.
    auto load_b = [&](int t) {
      const uint32_t sb = smem_addr(ring + (t % RING_STAGES) * SLOT_BYTES);
      const int k0 = t * BK;
      if constexpr (VEC) {
#pragma unroll
        for (int l = 0; l < BK * BN / 4 / PTHREADS; ++l) {
          const int q = tid + PTHREADS * l, k = q / (BN / 4), c = q % (BN / 4);
          const bool ok = k0 + k < K && n0 + 4 * c < N;
          cp_async16(sb + k * (BN * 4) + 16 * c, ok ? b + (size_t)(k0 + k) * N + n0 + 4 * c : b, ok);
        }
      } else {
#pragma unroll 4
        for (int l = 0; l < BK * BN / PTHREADS; ++l) {
          const int e = tid + PTHREADS * l, k = e / BN, n = e % BN;
          const bool ok = k0 + k < K && n0 + n < N;
          cp_async4(sb + k * (BN * 4) + 4 * n, ok ? b + (size_t)(k0 + k) * N + n0 + n : b, ok);
        }
      }
    };
    // B's planes of one staged tile into buffer `pb`: item j is column
    // tid % BN, K chunk tid / BN + (PTHREADS / BN) * j, one 16-byte chunk
    // of each plane row it feeds.
    auto split_b = [&](const unsigned char* slot, unsigned char* pb) {
      const int bn = tid % BN;
      const int* sbt = reinterpret_cast<const int*>(slot) + bn;
#pragma unroll
      for (int j = 0; j < BK * BN / 8 / PTHREADS; ++j) {
        const int kc = tid / BN + (PTHREADS / BN) * j;
        uint32_t x[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) x[e] = (uint32_t)sbt[(8 * kc + e) * BN];
        uint4 bh, bl;
        limbs_h2(x[0], x[1], bl.x, bh.x);
        limbs_h2(x[2], x[3], bl.y, bh.y);
        limbs_h2(x[4], x[5], bl.z, bh.z);
        limbs_h2(x[6], x[7], bl.w, bh.w);
        *reinterpret_cast<uint4*>(pb + sw128(bn, kc)) = bh;  // [b_hi ; b_lo] along K
        *reinterpret_cast<uint4*>(pb + sw128(bn, 4 + kc)) = bl;
      }
    };
    // Tile kt+AHEAD is requested at step kt into the slot of tile kt-1,
    // which every producer thread has split before the step's barrier.
    constexpr int AHEAD = RING_STAGES - 1;
#pragma unroll
    for (int t = 0; t < AHEAD; ++t) {
      if (t < ntiles) load_b(t);
      cp_async_commit();
    }
    for (int kt = 0; kt < ntiles; ++kt) {
      cp_async_wait<AHEAD - 1>();
      // every producer thread's copies of tile kt have landed, and every
      // one has split tile kt-1
      producer_sync();
      if (kt + AHEAD < ntiles) load_b(kt + AHEAD);
      cp_async_commit();
      const int s = kt % PLANE_STAGES;
      // the buffer's last readers: both consumers' products of tile kt - PLANE_STAGES
      if (kt >= PLANE_STAGES) mbar_wait(empty_bar(s), ((kt / PLANE_STAGES) + 1) & 1);
      split_b(ring + (kt % RING_STAGES) * SLOT_BYTES, b_planes + s * PLANE_B_BYTES);
      // generic-proxy stores that wgmma (the async proxy) reads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(full_bar(s));
    }
  } else {
    // ---------------- consumers: A's planes, wgmma and the folds ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int c = wg - PRODUCERS;
    const int ctid = tid - PTHREADS;
    const int lane = tid & 31, wq = (ctid / 32) % 4;
    auto wg_sync = [c] {  // this consumer warpgroup's 128 threads
      asm volatile("bar.sync %0, 128;\n" ::"r"(3 + c) : "memory");
    };
    // Copy this warpgroup's 64 rows of A's planes of tile t into buffer
    // t % A_STAGES (16-byte chunk q of a row's 256 bytes: W1's chunk q,
    // then W0's chunk q - 8), swizzled; rows past M are zero-filled.
    const int ntiles_a = ntiles;
    const unsigned char* a_rows =
        a_split + ((size_t)(P.a_bs ? bb : 0) * M + m0 + c * 64) * ntiles_a * A_TILE_ROW_BYTES;
    auto load_a = [&](int t) {
      const uint32_t st = a_base + (t % A_STAGES) * A_STAGE_BYTES;
#pragma unroll
      for (int l = 0; l < 64 * 16 / 128; ++l) {
        const int q = (ctid & 127) + 128 * l, r = q >> 4, ch = q & 15;
        const int row = c * 64 + r;
        const bool ok = m0 + row < M;
        cp_async16(st + (ch >> 3) * PLANE_A_BYTES + sw128(row, ch & 7),
                   ok ? a_rows + ((size_t)r * ntiles_a + t) * A_TILE_ROW_BYTES + 16 * ch : a_split, ok);
      }
    };

    float w1[ACC], w0[ACC];
#pragma unroll
    for (int e = 0; e < ACC; ++e) w1[e] = w0[e] = 0.f;
    const uint32_t a_off = (uint32_t)(c * 64 * ROW_BYTES);  // this consumer's 64 rows
#pragma unroll
    for (int t = 0; t < A_STAGES - 1; ++t) {
      if (t < ntiles) load_a(t);
      cp_async_commit();
    }

    // The second consumer's first fold period is half long, so the two
    // never drain and fold at the same time.
    int period = c == 0 ? FOLD_TILES : FOLD_TILES / 2;
    for (int kt0 = 0; kt0 < ntiles;) {
      const int kend = min(ntiles, kt0 + period);
      period = FOLD_TILES;
      for (int kt = kt0; kt < kend; ++kt) {
        // this warpgroup's copies of A(kt) have landed (A(kt+1) may be in
        // flight); meanwhile its products of tile kt-1 run
        const int sa = kt % A_STAGES;
        cp_async_wait<A_STAGES - 2>();
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg_sync();
        const int s = kt % PLANE_STAGES;
        mbar_wait(full_bar(s), (kt / PLANE_STAGES) & 1);  // B's planes of tile kt
        const uint32_t at = a_base + sa * A_STAGE_BYTES + a_off;
        const uint64_t d1 = sw128_desc(at);
        const uint64_t d0 = sw128_desc(at + PLANE_A_BYTES);
        const uint64_t db = sw128_desc(b_base + s * PLANE_B_BYTES);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 2 * BK / 16; ++kk) wgmma_f16(w1, d1 + 2 * kk, db + 2 * kk);
#pragma unroll
        for (int kk = 0; kk < 2 * BK / 16; ++kk) wgmma_f16(w0, d0 + 2 * kk, db + 2 * kk);
        wgmma_commit();
        wgmma_wait<1>();  // the products of tile kt-1 are done
        if (kt > kt0) mbar_arrive(empty_bar((kt - 1) % PLANE_STAGES));
        // A(kt + A_STAGES - 1) into the buffer of tile kt-1, whose products
        // are done
        if (kt + A_STAGES - 1 < ntiles) load_a(kt + A_STAGES - 1);
        cp_async_commit();
      }
      wgmma_wait<0>();
      fence_operands(w1);
      fence_operands(w0);
      mbar_arrive(empty_bar((kend - 1) % PLANE_STAGES));
#pragma unroll
      for (int e = 0; e < ACC; ++e) {
        w1[e] = fold_f(w1[e], P.pf, P.inv_p);
        w0[e] = fold_f(w0[e], P.pf, P.inv_p);
      }
      kt0 = kend;
    }

    // |W1|, |W0| < p; reduced to [0, p), the product is 256 * W1 + W0
    // (mod p), < 2**25
    uint32_t r[ACC];
#pragma unroll
    for (int e = 0; e < ACC; ++e)
      r[e] = barrett(float_to_u(mod_f(w1[e], P.pf, P.inv_p)) * 256u +
                         float_to_u(mod_f(w0[e], P.pf, P.inv_p)),
                     P.p, P.mu);

    const int row0 = m0 + c * 64 + 16 * wq + (lane >> 2);  // + 8h
    const int col0 = 2 * (lane & 3);                        // + 8j + c, within the block
    if constexpr (MASKED) {
      // after every consumer's last products the A planes are idle
      auto sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(128 * CONSUMERS) : "memory"); };
      sync();
      add_fused_mask<128 * CONSUMERS, BN, NJ>(r, P, reinterpret_cast<uint32_t*>(a_planes), ctid, bb,
                                              n0, row0, col0, sync);
    }

    int* __restrict__ out = P.out + (size_t)bb * (size_t)M * (size_t)N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = n0 + col0 + 8 * j;
        int* dst = out + (size_t)row * N + col;
        const uint32_t x0 = r[4 * j + 2 * h], x1 = r[4 * j + 2 * h + 1];
        if (VEC && col + 1 < N) {
          *reinterpret_cast<int2*>(dst) = make_int2((int)x0, (int)x1);
        } else {
          if (col < N) dst[0] = (int)x0;
          if (col + 1 < N) dst[1] = (int)x1;
        }
      }
    }
  }
}

// Bytes of A's planes for `batch_a` A matrices (the wrapper allocates them).
inline size_t a_split_bytes(const Params& P, int batch_a) {
  return (size_t)batch_a * P.M * ((P.K + BK - 1) / BK) * A_TILE_ROW_BYTES;
}

template <bool VEC, bool MASKED>
cudaError_t launch_vec(const Params& P, int batch, unsigned char* a_split, cudaStream_t stream) {
  const int ntiles = (P.K + BK - 1) / BK;
  if (ntiles > 0) {
    dim3 pgrid((ntiles * 4 + 127) / 128, P.M < 65535 ? P.M : 65535, P.a_bs ? batch : 1);
    split_a_planes<VEC><<<pgrid, 128, 0, stream>>>(P, a_split, ntiles);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto kernel = modmatmul_f32_wgmma<VEC, MASKED>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((P.N + BN - 1) / BN, (P.M + BM - 1) / BM, batch);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(P, a_split);
  return cudaGetLastError();
}

template <bool MASKED>
cudaError_t launch(const Params& P, int batch, unsigned char* a_split, cudaStream_t stream) {
  const bool vec = P.K % 4 == 0 && P.N % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(P.a) | reinterpret_cast<uintptr_t>(P.b) |
                    reinterpret_cast<uintptr_t>(P.out)) % 16 == 0;
  return vec ? launch_vec<true, MASKED>(P, batch, a_split, stream)
             : launch_vec<false, MASKED>(P, batch, a_split, stream);
}

}  // namespace wgmma_f32
}  // namespace gfmm
