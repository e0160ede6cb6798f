// flash_attention: o = softmax(q kᵀ * scale) v, non-causal, unmasked,
// with an online softmax, never materializing the (S, Sk) score matrix.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// nnstreamer_tpu/ops/kernels.py (the pl.pallas_call over the grid
// (B, S/bq, Sk/bk) whose last axis runs in order and carries the running
// max, normalizer and accumulator in VMEM scratch).  Its caller is the
// ViT's attention (models/vit.py, `Block.attention`).
//
// Math, as the Pallas body: s = (q·kᵀ) * scale in f32 (the scale after the
// dot), a running max m, a normalizer l and an f32 accumulator acc per
// query row; per K/V tile
//   m' = max(m, rowmax(s)),  c = exp(m - m'),  p = exp(s - m'),
//   l = l*c + rowsum(p),     acc = acc*c + p·v,
// and at the end o = acc / l, cast to q's type.  The bf16 kernel works in
// base 2 (x = s·scale·log2(e), 2^x), which is the same function, takes
// acc / l as acc · (1/l), and rounds p to bf16 for p·v on the tensor cores.
//
// Layout: q, k, v and o are each a rank-4 (B, H, S, D) view with element
// strides (sB, sH, sS, 1): a 16-byte aligned base, strides multiples of 16
// bytes.  That takes the ViT's head-split views of its qkv projection
// ((S·3D, dh, 3D, 1), k and v at offsets D and 2D) without a copy, and o
// is written in the (B, S, H, D) layout the output projection reads.  D is
// 64 or 128, any S >= 1 and Sk >= 1; all bf16 or all f32.
//
// Bound at the ViT's shape, bf16 (64, 4, 256, 128): bytes.  q, k, v and o
// are 67.1 MB, 0.020 ms at 3.35 TB/s; the 8.6 GFLOP take 0.0087 ms at
// 989 TFLOP/s.  What the design does about it (bf16):
//
// - Loads by TMA (cp.async.bulk.tensor over 4-d maps of the strided
//   layout, 128-byte swizzle) into two-stage Q, K and V rings, each slot
//   with a full and an empty mbarrier.  No thread spends registers or
//   instructions on addresses; the next tiles are in flight while the
//   tensor cores work.  TMA zero-fills K/V rows past Sk and Q rows past S.
// - Warp specialisation: a producer warpgroup (one thread issues the Q and
//   K loads, another the V loads, so neither ring waits on the other)
//   drops to 40 registers with setmaxnreg.dec, and two consumer
//   warpgroups rise to 232 with setmaxnreg.inc, inside one if/else whose
//   branches never meet.
// - Persistent CTAs: the grid is min(work items, SMs), one 384-thread CTA
//   an SM.  A CTA walks the (b·h, 128-row query tile) items in order, so
//   the producer loads the next item's Q and K/V while the consumers
//   finish the current one (at S = Sk = 256 a tile's K/V loop has only two
//   iterations: the overlap has to come across items), and the two query
//   tiles of a head run on neighbouring CTAs at once, so the second read
//   of its K/V hits L2.
// - wgmma: each consumer warpgroup owns 64 of the item's 128 query rows.
//   S = Q·Kᵀ is m64n128k16 with Q and K K-major in shared memory; P·V is
//   m64nDk16 with P from registers (the f32 score accumulator packed to
//   bf16 pairs is the A fragment) and V read MN-major from shared memory
//   with the transpose bit, so no transpose copy is made.  A D = 128 row
//   is two 64-column swizzle atoms (two TMA boxes); the descriptors walk
//   both.
// - Softmax at the issue rate: the row max is taken on the raw scores, so
//   a score costs one FFMA and one exp2; four partial maxima and sums a
//   row keep dependency chains short; only the ragged tile pays for the
//   key mask.
// - Epilogue: acc · (1/l) (a division per element cost more than the
//   rest of the epilogue) to bf16 into a swizzled shared tile, then a TMA
//   store per warpgroup that clips query rows past S.
//
// Design (f32), CUDA-core FMA (off the main path; the f32 tests and the
// f32 card-against-CPU checks use it): one 4-warp block per (b·h, 16-row
// query tile), 4 query rows per warp, 32-row K/V tiles in shared memory
// (K rows padded by one float) read through the same strided layout.  A
// lane scores one key of the tile against the warp's 4 rows; the max and
// sum are warp reductions; each lane then owns D/32 columns of the
// accumulator and folds in p_j·v_j for the 32 keys, p_j broadcast by
// shuffle.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

// A rank-4 (B, H, S, D) view with element strides; the last dim's is 1.
struct Layout {
  int64_t B, H, S, D, sB, sH, sS;
};

// -- bf16: TMA, wgmma, warp-specialised -------------------------------------

constexpr int kBM = 128;                  // query rows per work item
constexpr int kBN = 128;                  // key rows per K/V tile
constexpr int kWgRows = 64;               // query rows per consumer warpgroup
constexpr int kKStages = 2;               // K ring
constexpr int kVStages = 2;               // V ring
constexpr int kQStages = 2;               // Q ring
constexpr int kAtomCols = 64;             // bf16 columns per 128-byte swizzle atom
constexpr int kQAtomBytes = kBM * 128;    // one 64-column atom of a Q or O tile
constexpr int kKVAtomBytes = kBN * 128;   // one 64-column atom of a K or V tile
constexpr int kFaThreads = 384;           // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumers = 256;
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(kBM == 2 * kWgRows, "two consumer warpgroups share a query tile");
static_assert(kProducerRegs * 128 + kConsumerRegs * kConsumers <= 65536, "register file");

// Shared memory, in bytes from a 1024-aligned base (the 128-byte swizzle
// repeats every 1024 bytes, and TMA and wgmma agree on it from there).
template <int D>
struct Smem {
  static constexpr int kAtoms = D / kAtomCols;
  static constexpr int kQTile = kAtoms * kQAtomBytes;    // a Q or O tile
  static constexpr int kKVTile = kAtoms * kKVAtomBytes;  // a K or V tile
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQStages * kQTile;
  static constexpr int kV = kK + kKStages * kKVTile;
  static constexpr int kO = kV + kVStages * kKVTile;
  static constexpr int kBar = kO + kQTile;
  static constexpr int kBars = 2 * (kQStages + kKStages + kVStages);
  static constexpr int kBytes = kBar + 8 * kBars + 1024;  // + 1024 to align the base
};
static_assert(Smem<128>::kBytes <= 232448, "shared memory of one H100 block");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One box of a 4-d tensor map into shared memory; completes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// One box from shared memory to a 4-d tensor map; rows out of bounds are
// not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until every committed wgmma group has completed.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from reading a wgmma accumulator above the wait that
// completes it, and from reusing the registers of an A fragment that a
// running wgmma still reads.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets in 16-byte units, layout type 1
// (128-byte swizzle) in bits 62-63.  K-major (Q, K): rows of 128 bytes,
// 8-row groups 1024 bytes apart (SBO), LBO unused.  MN-major (V): SBO =
// 1024 bytes between groups of 8 key rows, LBO = the distance between two
// 64-column atoms of D.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// d = A·Bᵀ (scale_d = 0) or d += A·Bᵀ (scale_d = 1), m64n128k16: A and B
// K-major in shared memory, given by descriptors.
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A·B, m64n128k16: A from registers (4 bf16 pairs a thread), B
// MN-major in shared memory (descriptor; the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A·B, m64n64k16: A from registers (4 bf16 pairs a thread), B
// MN-major in shared memory (descriptor; the transpose bit is set).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__global__ void __launch_bounds__(kFaThreads, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                const __grid_constant__ CUtensorMap mo, int H, int Sk,
                                int n_qtiles, int n_items, float scale_log2) {
  using L = Smem<D>;
  constexpr int kAtoms = L::kAtoms;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const smem = smem_raw + (base - raw);
  const uint32_t bars = base + L::kBar;
  // full_q, empty_q [kQStages]; full_k, empty_k [kKStages]; full_v, empty_v [kVStages]
  const auto full_q = [&](int s) { return bars + 8 * s; };
  const auto empty_q = [&](int s) { return bars + 8 * (kQStages + s); };
  const auto full_k = [&](int s) { return bars + 8 * (2 * kQStages + s); };
  const auto empty_k = [&](int s) { return bars + 8 * (2 * kQStages + kKStages + s); };
  const auto full_v = [&](int s) { return bars + 8 * (2 * kQStages + 2 * kKStages + s); };
  const auto empty_v = [&](int s) {
    return bars + 8 * (2 * kQStages + 2 * kKStages + kVStages + s);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kQStages; ++s) {
      mbar_init(full_q(s), 1);
      mbar_init(empty_q(s), kConsumers);
    }
    for (int s = 0; s < kKStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(empty_k(s), kConsumers);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(full_v(s), 1);
      mbar_init(empty_v(s), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: lane 0 of warp 8 loads Q and K, lane 0 of warp 9 V ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    const int ptid = threadIdx.x - 2 * 128;
    if (ptid == 0) {
      int it = 0, n = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
        const int bh = item / n_qtiles, q0 = (item - bh * n_qtiles) * kBM;
        const int b = bh / H, h = bh - b * H;
        const int qs = n % kQStages;
        mbar_wait(empty_q(qs), ((n / kQStages) & 1) ^ 1);
        mbar_expect_tx(full_q(qs), L::kQTile);  // a full box counts, zero fill included
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_load(base + L::kQ + qs * L::kQTile + a * kQAtomBytes, &mq, full_q(qs),
                   a * kAtomCols, q0, h, b);
        for (int kt = 0; kt < Sk; kt += kBN, ++it) {
          const int s = it % kKStages;
          mbar_wait(empty_k(s), ((it / kKStages) & 1) ^ 1);
          mbar_expect_tx(full_k(s), L::kKVTile);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            tma_load(base + L::kK + s * L::kKVTile + a * kKVAtomBytes, &mk, full_k(s),
                     a * kAtomCols, kt, h, b);
        }
      }
    } else if (ptid == 32) {
      int it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int bh = item / n_qtiles;
        const int b = bh / H, h = bh - b * H;
        for (int kt = 0; kt < Sk; kt += kBN, ++it) {
          const int s = it % kVStages;
          mbar_wait(empty_v(s), ((it / kVStages) & 1) ^ 1);
          mbar_expect_tx(full_v(s), L::kKVTile);
#pragma unroll
          for (int a = 0; a < kAtoms; ++a)
            tma_load(base + L::kV + s * L::kKVTile + a * kKVAtomBytes, &mv, full_v(s),
                     a * kAtomCols, kt, h, b);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) -----------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator row group, lane in the quad
    // This thread's accumulator element i sits at row 16·warp + g + 8·((i>>1)&1)
    // of the warpgroup's 64 and column 8·(i>>2) + 2·t4 + (i&1): the m16n8
    // C layout repeated along N.
    const bool pos = scale_log2 >= 0.f;
    const float fill = pos ? -INFINITY : INFINITY;  // never a row's extreme
    // partial extreme and sum (of 4 a row) that element i feeds
    const auto part = [](int i) { return (i & 1) | (((i >> 2) & 1) << 1); };
    int it = 0, n = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++n) {
      const int bh = item / n_qtiles, q0 = (item - bh * n_qtiles) * kBM;
      const int b = bh / H, h = bh - b * H;
      const int qs = n % kQStages;
      const uint32_t sq = base + L::kQ + qs * L::kQTile + wg * kWgRows * 128;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      float m[2] = {-INFINITY, -INFINITY};
      float l[2] = {0.f, 0.f};  // this lane's share of the row sums
      mbar_wait(full_q(qs), (n / kQStages) & 1);

      const int n_tiles = (Sk + kBN - 1) / kBN;
      for (int t = 0; t < n_tiles; ++t, ++it) {
        const int kt = t * kBN;
        const int ks = it % kKStages, vs = it % kVStages;
        const uint32_t sk = base + L::kK + ks * L::kKVTile;

        // S = Q·Kᵀ: D/16 k-steps of 32 bytes along each 64-column atom
        float sc[kBN / 2];
        mbar_wait(full_k(ks), (it / kKStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
#pragma unroll
          for (int kk = 0; kk < kAtomCols / 16; ++kk)
            wgmma_ss(sc, sw128_desc(sq + a * kQAtomBytes + kk * 32, 16, 1024),
                     sw128_desc(sk + a * kKVAtomBytes + kk * 32, 16, 1024), (a | kk) != 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(sc);
        mbar_arrive(empty_k(ks));
        if (t == n_tiles - 1) mbar_arrive(empty_q(qs));  // the item's last read of Q

        // Online softmax in base 2, x = s·scale·log2(e).  The row's extreme
        // is taken on the raw scores (the max, or the min for a negative
        // scale), so a score costs one FFMA and one exp2; four partial
        // extremes and sums a row keep the dependency chains short.  Key
        // columns past Sk take part in neither.
        const bool ragged = kt + kBN > Sk;
        if (ragged) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i)
            if (kt + 8 * (i >> 2) + 2 * t4 + (i & 1) >= Sk) sc[i] = fill;
        }
        float ext[2][4];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) ext[r][q] = fill;
        if (pos) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i)
            ext[(i >> 1) & 1][part(i)] = fmaxf(ext[(i >> 1) & 1][part(i)], sc[i]);
        } else {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i)
            ext[(i >> 1) & 1][part(i)] = fminf(ext[(i >> 1) & 1][part(i)], sc[i]);
        }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float e = pos ? fmaxf(fmaxf(ext[r][0], ext[r][1]), fmaxf(ext[r][2], ext[r][3]))
                        : fminf(fminf(ext[r][0], ext[r][1]), fminf(ext[r][2], ext[r][3]));
#pragma unroll
          for (int w = 1; w <= 2; w <<= 1) {  // the quad shares the row
            const float o = __shfl_xor_sync(0xffffffffu, e, w);
            e = pos ? fmaxf(e, o) : fminf(e, o);
          }
          const float mx = fmaxf(m[r], e * scale_log2);
          corr[r] = exp2f(m[r] - mx);  // 2^-inf = 0 on the first tile
          m[r] = mx;
        }
        float rs[2][4] = {};
        // p = 2^(x - m); on the ragged tile, 0 past Sk (for any scale, 0
        // included); full tiles pay for no mask
        const auto exps = [&](auto masked) {
#pragma unroll
          for (int i = 0; i < kBN / 2; ++i) {
            float p = exp2f(fmaf(sc[i], scale_log2, -m[(i >> 1) & 1]));
            if (decltype(masked)::value && kt + 8 * (i >> 2) + 2 * t4 + (i & 1) >= Sk) p = 0.f;
            sc[i] = p;
            rs[(i >> 1) & 1][part(i)] += p;
          }
        };
        if (ragged)
          exps(std::true_type{});
        else
          exps(std::false_type{});
#pragma unroll
        for (int r = 0; r < 2; ++r)
          l[r] = l[r] * corr[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
        if (t > 0) {  // on the item's first tile acc is still 0
#pragma unroll
          for (int i = 0; i < D / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
        }

        // acc += P·V: score blocks 2j and 2j+1 (keys 16j..16j+15) are the A
        // fragment of k-step j, P rounded to bf16
        uint32_t pa[kBN / 16][4];
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j) {
          pa[j][0] = pack_bf16(sc[8 * j + 0], sc[8 * j + 1]);
          pa[j][1] = pack_bf16(sc[8 * j + 2], sc[8 * j + 3]);
          pa[j][2] = pack_bf16(sc[8 * j + 4], sc[8 * j + 5]);
          pa[j][3] = pack_bf16(sc[8 * j + 6], sc[8 * j + 7]);
        }
        // V MN-major (transpose bit), 16 key rows (2048 bytes) a k-step
        const uint32_t sv = base + L::kV + vs * L::kKVTile;
        mbar_wait(full_v(vs), (it / kVStages) & 1);
        wgmma_fence();
#pragma unroll
        for (int j = 0; j < kBN / 16; ++j)
          wgmma_rs(acc, pa[j], sw128_desc(sv + j * 16 * 128, kKVAtomBytes, 1024));
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(empty_v(vs));
      }

      // epilogue: o = acc / l to bf16 (one division a row, then products),
      // into the swizzled O tile, then one TMA store per atom, which clips
      // rows past S
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        inv[r] = 1.f / l[r];
      }
      uint8_t* const so = smem + L::kO + wg * kWgRows * 128;
      if (tid == 0)  // the previous item's store has read the tile
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      named_bar_sync(1 + wg, 128);
#pragma unroll
      for (int i = 0; i < D / 2; i += 2) {
        const int r = (i >> 1) & 1;
        const int row = warp * 16 + g + 8 * r;
        const int col = 8 * (i >> 2) + 2 * t4;
        const int cc = col % kAtomCols;
        const int off = (col / kAtomCols) * kQAtomBytes + row * 128 +
                        ((((cc >> 3) ^ (row & 7)) << 4) | ((cc & 7) * 2));
        *reinterpret_cast<__nv_bfloat162*>(so + off) =
            __floats2bfloat162_rn(acc[i] * inv[r], acc[i + 1] * inv[r]);
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      named_bar_sync(1 + wg, 128);
      if (tid == 0) {
#pragma unroll
        for (int a = 0; a < kAtoms; ++a)
          tma_store(&mo, base + L::kO + wg * kWgRows * 128 + a * kQAtomBytes,
                    a * kAtomCols, q0 + wg * kWgRows, h, b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      }
    }
    if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// -- f32: CUDA cores ---------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kRowsPerWarp = 4;
constexpr int kBQ32 = kRowsPerWarp * (kThreads / 32);  // 16 query rows
constexpr int kBK32 = 32;                               // one key per lane

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o, Layout lq,
                               Layout lk, Layout lv, Layout lo, int n_qtiles, float scale) {
  constexpr int kCols = D / 32;  // accumulator columns per lane
  __shared__ float sQ[kBQ32][D];
  __shared__ float sK[kBK32][D + 1];  // +1: lanes read distinct banks
  __shared__ float sV[kBK32][D];

  const int64_t bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBQ32;
  const int64_t b = bh / lq.H, h = bh % lq.H;
  q += b * lq.sB + h * lq.sH;
  k += b * lk.sB + h * lk.sH;
  v += b * lv.sB + h * lv.sH;
  o += b * lo.sB + h * lo.sH;
  const int S = static_cast<int>(lq.S), Sk = static_cast<int>(lk.S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * kRowsPerWarp;

  for (int i = threadIdx.x; i < kBQ32 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r][c] = q0 + r < S ? q[(q0 + r) * lq.sS + c] : 0.f;
  }

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kCols];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  for (int kt = 0; kt < Sk; kt += kBK32) {
    for (int i = threadIdx.x; i < kBK32 * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = kt + r < Sk;
      sK[r][c] = in ? k[(kt + r) * lk.sS + c] : 0.f;
      sV[r][c] = in ? v[(kt + r) * lv.sS + c] : 0.f;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s[r] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float kd = sK[lane][d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) s[r] = fmaf(sQ[wrow + r][d], kd, s[r]);
    }
    const bool valid = kt + lane < Sk;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const float sr = valid ? s[r] * scale : -INFINITY;
      float mx = sr;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      const float p = expf(sr - m_new);
      float sum = p;
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[r] = l[r] * corr + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= corr;
      for (int j = 0; j < kBK32; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, sV[j][lane + 32 * c], acc[r][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + wrow + r;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) o[row * lo.sS + lane + 32 * c] = acc[r][c] / l[r];
  }
}

// -- launch ------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, fetched through the runtime (this
// library does not link libcuda); null when it is not there.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                      cudaEnableDefault, &found);
#else
    cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A bf16 4-d map over (D, S, H, B), innermost first, with a box of 64
// columns by `box_rows` rows and the 128-byte swizzle; out-of-bounds
// elements load as zero.
bool encode_map(EncodeTiledFn enc, CUtensorMap* map, const void* ptr, const Layout& t,
                uint32_t box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(t.D), static_cast<cuuint64_t>(t.S),
                              static_cast<cuuint64_t>(t.H), static_cast<cuuint64_t>(t.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(t.sS) * 2,
                                 static_cast<cuuint64_t>(t.sH) * 2,
                                 static_cast<cuuint64_t>(t.sB) * 2};
  const cuuint32_t box[4] = {kAtomCols, box_rows, 1, 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

constexpr int kMaxDevices = 64;

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, const Layout* t,
                        float scale, cudaStream_t stream) {
  static int sm_count[kMaxDevices];  // per device, set once: 0 until then
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  if (!encode_map(enc, &mq, q, t[0], kBM) || !encode_map(enc, &mk, k, t[1], kBN) ||
      !encode_map(enc, &mv, v, t[2], kBN) || !encode_map(enc, &mo, o, t[3], kWgRows))
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    rc = cudaFuncSetAttribute(flash_attention_bf16_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::kBytes);
    if (rc != cudaSuccess) return rc;
    int sms = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc != cudaSuccess) return rc;
    sm_count[dev] = sms;
  }
  const int64_t n_qtiles = (t[0].S + kBM - 1) / kBM;
  const int64_t n_items = t[0].B * t[0].H * n_qtiles;
  if (n_items > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const int grid = static_cast<int>(n_items < sm_count[dev] ? n_items : sm_count[dev]);
  flash_attention_bf16_kernel<D><<<grid, kFaThreads, Smem<D>::kBytes, stream>>>(
      mq, mk, mv, mo, static_cast<int>(t[0].H), static_cast<int>(t[1].S),
      static_cast<int>(n_qtiles), static_cast<int>(n_items), scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, const Layout* t,
                       float scale, cudaStream_t stream) {
  const int64_t n_qtiles = (t[0].S + kBQ32 - 1) / kBQ32;
  const int64_t blocks = t[0].B * t[0].H * n_qtiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_attention_f32_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), t[0], t[1], t[2], t[3], static_cast<int>(n_qtiles), scale);
  return cudaGetLastError();
}

bool same(const Layout& a, const Layout& b, bool seq) {
  return a.B == b.B && a.H == b.H && a.D == b.D && (!seq || a.S == b.S);
}

}  // namespace

// q, k, v, o: device pointers; `layouts` holds four (B, H, S, D, sB, sH,
// sS) rows in elements, for q, k, v and o (q and o (B, H, S, D), k and v
// (B, H, Sk, D)); dtype codes: 0 float32, 1 bfloat16; D is 64 or 128.
// Launches on `stream` and returns cudaGetLastError() (0 on success); a
// layout, D or dtype it does not take returns cudaErrorInvalidValue
// without launching.
extern "C" int nns_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   const int64_t* layouts, int dtype_code, float scale,
                                   void* stream) {
  Layout t[4];
  for (int i = 0; i < 4; ++i) {
    const int64_t* r = layouts + 7 * i;
    t[i] = Layout{r[0], r[1], r[2], r[3], r[4], r[5], r[6]};
    if (t[i].B < 1 || t[i].H < 1 || t[i].S < 1 || t[i].S > 0x7fffffff)
      return cudaErrorInvalidValue;
  }
  if (!same(t[0], t[3], true) || !same(t[1], t[2], true) || !same(t[0], t[1], false))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t d = t[0].D;
  if (dtype_code == 1) {
    if (d == 64) return launch_bf16<64>(q, k, v, o, t, scale, st);
    if (d == 128) return launch_bf16<128>(q, k, v, o, t, scale, st);
  } else if (dtype_code == 0) {
    if (d == 64) return launch_f32<64>(q, k, v, o, t, scale, st);
    if (d == 128) return launch_f32<128>(q, k, v, o, t, scale, st);
  }
  return cudaErrorInvalidValue;
}
