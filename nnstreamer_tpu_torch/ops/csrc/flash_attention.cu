// flash_attention: o = softmax(q kᵀ * scale) v, non-causal, unmasked,
// with an online softmax, never materializing the (S, Sk) score matrix.
//
// Replaces the Pallas TPU kernel `flash_attention` in
// nnstreamer_tpu/ops/kernels.py (the pl.pallas_call over the grid
// (B, S/bq, Sk/bk) whose last axis runs in order and carries the running
// max, normalizer and accumulator in VMEM scratch).  Its caller is the
// ViT's attention (models/vit.py `_attention`), q, k, v (B, H, S, dh).
//
// Math, as the Pallas body: q and k are taken to f32, s = (q·kᵀ) * scale
// in f32 (the scale after the dot), a running max m, a normalizer l and an
// f32 accumulator acc per query row; per K/V tile
//   m' = max(m, rowmax(s)),  c = exp(m - m'),  p = exp(s - m'),
//   l = l*c + rowsum(p),     acc = acc*c + p·v,
// and at the end o = acc / l, cast to q's type.
//
// Inputs: q (BH, S, D), k and v (BH, Sk, D), contiguous, 16-byte aligned,
// all bf16 or all f32, D = 64 or 128, any S >= 1 and Sk >= 1 (the ragged
// tile is masked: key columns past Sk score -inf and their K/V rows are
// zero-filled; query rows past S are computed on zeros and not stored).
//
// Bound at the ViT's shape, bf16 (64*4, 256, 128): bytes.  q, k, v and o
// are 67.1 MB, 0.020 ms at 3.35 TB/s; the 8.6 GFLOP take 0.0087 ms at
// 989 TFLOP/s.  Each query tile reads all of K and V once more (S/64 = 4
// times at S = 256), but from L2: the 4 blocks of one (b, h) run at once.
//
// Design (bf16), a simple first form:
// - the TPU grid's sequential K axis becomes a loop inside the block: one
//   4-warp block per (b*h, 64-row query tile); each warp owns 16 query
//   rows;
// - the Q tile is staged through shared memory once and kept in registers
//   as mma A fragments;
// - K and V tiles of 64 rows are loaded into shared memory (rows padded by
//   8 elements, so the fragment loads hit 32 distinct banks);
// - Q·Kᵀ and P·V run on the tensor cores with mma.sync.m16n8k16 (bf16 in,
//   f32 accumulate); the score fragment of Q·Kᵀ is reused as the A fragment
//   of P·V, with P rounded to bf16; V's B fragments come from
//   ldmatrix.trans;
// - the row max and row sum are reduced across the 4 lanes that share a
//   row with two xor shuffles.
// What bounds it: tiles are loaded synchronously (no cp.async/TMA
// pipeline, so loads and tensor-core work do not overlap) and mma.sync
// reaches a fraction of Hopper's rate (wgmma is needed for the rest).
// Those are the next steps, with reading q, k, v straight out of the qkv
// projection by stride.
//
// Design (f32), CUDA-core FMA: one 4-warp block per (b*h, 16-row query
// tile), 4 query rows per warp, 32-row K/V tiles in shared memory (K rows
// padded by one float).  A lane scores one key of the tile against the
// warp's 4 rows; the max and sum are warp reductions; each lane then owns
// D/32 columns of the accumulator and folds in p_j·v_j for the 32 keys,
// p_j broadcast by shuffle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;

// -- bf16: tensor cores ------------------------------------------------------

constexpr int kBQ = 64;  // query rows per block (16 per warp)
constexpr int kBK = 64;  // key rows per tile
static_assert(kBQ == kBK, "load_tile_bf16 loads kBQ rows for Q, K and V tiles");

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a·b, one m16n8k16 tile: bf16 inputs, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory, transposed on load.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows [row0, row0 + 64) of a (nrows, D) matrix into a (64, D + 8) tile,
// zero past nrows; 16-byte loads and stores.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src, int row0,
                                               int nrows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int c = threadIdx.x; c < kBQ * kChunks; c += kThreads) {
    const int r = c / kChunks, cc = c % kChunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < nrows)
      val = *reinterpret_cast<const uint4*>(src + static_cast<int64_t>(row0 + r) * D + cc * 8);
    *reinterpret_cast<uint4*>(dst + r * kLd + cc * 8) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                                int Sk, int n_qtiles, float scale) {
  constexpr int kLd = D + 8;
  constexpr int kKSteps = D / 16;  // k-steps of Q·Kᵀ
  constexpr int kDTiles = D / 8;   // n-tiles of the accumulator
  constexpr int kSTiles = kBK / 8; // n-tiles of the score block
  __shared__ __align__(16) bf16 sK[kBK * kLd];
  __shared__ __align__(16) bf16 sV[kBK * kLd];

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBQ;
  q += static_cast<int64_t>(bh) * S * D;
  k += static_cast<int64_t>(bh) * Sk * D;
  v += static_cast<int64_t>(bh) * Sk * D;
  o += static_cast<int64_t>(bh) * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;  // mma group and lane within it
  const int wrow = warp * 16;

  // Q tile → registers (A fragments), staged through sK.
  load_tile_bf16<D>(sK, q, q0, S);
  __syncthreads();
  uint32_t qf[kKSteps][4];
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const bf16* base = sK + (wrow + g) * kLd + kk * 16 + 2 * t4;
    qf[kk][0] = ld32(base);
    qf[kk][1] = ld32(base + 8 * kLd);
    qf[kk][2] = ld32(base + 8);
    qf[kk][3] = ld32(base + 8 * kLd + 8);
  }
  __syncthreads();

  // per thread: rows wrow+g (index 0) and wrow+g+8 (index 1)
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};
  float acc[kDTiles][4];
#pragma unroll
  for (int dn = 0; dn < kDTiles; ++dn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dn][e] = 0.f;

  for (int kt = 0; kt < Sk; kt += kBK) {
    load_tile_bf16<D>(sK, k, kt, Sk);
    load_tile_bf16<D>(sV, v, kt, Sk);
    __syncthreads();

    // s = Q·Kᵀ for this warp's 16 rows and the tile's 64 keys
    float s[kSTiles][4];
#pragma unroll
    for (int n = 0; n < kSTiles; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const bf16* kr = sK + (n * 8 + g) * kLd + kk * 16 + 2 * t4;
        mma_bf16(s[n], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    // scale after the dot; mask the ragged tile; running max
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kt + n * 8 + 2 * t4 + (e & 1);
        s[n][e] = col < Sk ? s[n][e] * scale : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      corr[i] = expf(m[i] - mx[i]);  // exp(-inf) = 0 on the first tile
      m[i] = mx[i];
    }
#pragma unroll
    for (int n = 0; n < kSTiles; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l[i] = l[i] * corr[i] + rs[i];
    }
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      acc[dn][0] *= corr[0];
      acc[dn][1] *= corr[0];
      acc[dn][2] *= corr[1];
      acc[dn][3] *= corr[1];
    }

    // acc += P·V: score tiles 2j, 2j+1 form the A fragment of k-step j
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kDTiles; dn += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sV + (j * 16 + (lane & 15)) * kLd + dn * 8 + (lane >> 4) * 8);
        mma_bf16(acc[dn], a, b[0], b[1]);
        mma_bf16(acc[dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // the next tile overwrites sK and sV
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + wrow + g + 8 * i;
    if (row >= S) continue;
    bf16* orow = o + static_cast<int64_t>(row) * D + 2 * t4;
#pragma unroll
    for (int dn = 0; dn < kDTiles; ++dn) {
      __nv_bfloat162 val = __floats2bfloat162_rn(acc[dn][2 * i] / l[i],
                                                 acc[dn][2 * i + 1] / l[i]);
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8) = val;
    }
  }
}

// -- f32: CUDA cores ---------------------------------------------------------

constexpr int kRowsPerWarp = 4;
constexpr int kBQ32 = kRowsPerWarp * (kThreads / 32);  // 16 query rows
constexpr int kBK32 = 32;                               // one key per lane

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                               const float* __restrict__ v, float* __restrict__ o, int S,
                               int Sk, int n_qtiles, float scale) {
  constexpr int kCols = D / 32;  // accumulator columns per lane
  __shared__ float sQ[kBQ32][D];
  __shared__ float sK[kBK32][D + 1];  // +1: lanes read distinct banks
  __shared__ float sV[kBK32][D];

  const int bh = blockIdx.x / n_qtiles;
  const int q0 = (blockIdx.x % n_qtiles) * kBQ32;
  q += static_cast<int64_t>(bh) * S * D;
  k += static_cast<int64_t>(bh) * Sk * D;
  v += static_cast<int64_t>(bh) * Sk * D;
  o += static_cast<int64_t>(bh) * S * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wrow = warp * kRowsPerWarp;

  for (int i = threadIdx.x; i < kBQ32 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    sQ[r][c] = q0 + r < S ? q[static_cast<int64_t>(q0 + r) * D + c] : 0.f;
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
      const int64_t off = static_cast<int64_t>(kt + r) * D + c;
      sK[r][c] = in ? k[off] : 0.f;
      sV[r][c] = in ? v[off] : 0.f;
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
    for (int c = 0; c < kCols; ++c)
      o[static_cast<int64_t>(row) * D + lane + 32 * c] = acc[r][c] / l[r];
  }
}

// -- launch ------------------------------------------------------------------

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int64_t bh,
                        int S, int Sk, float scale, cudaStream_t stream) {
  const int n_qtiles = (S + kBQ - 1) / kBQ;
  const int64_t blocks = bh * n_qtiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_attention_bf16_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, Sk, n_qtiles, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int64_t bh,
                       int S, int Sk, float scale, cudaStream_t stream) {
  const int n_qtiles = (S + kBQ32 - 1) / kBQ32;
  const int64_t blocks = bh * n_qtiles;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  flash_attention_f32_kernel<D><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, Sk, n_qtiles, scale);
  return cudaGetLastError();
}

}  // namespace

// q (bh, S, d), k and v (bh, Sk, d), o (bh, S, d); dtype codes: 0 float32,
// 1 bfloat16; d is 64 or 128.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); an unsupported d or dtype returns
// cudaErrorInvalidValue without launching.
extern "C" int nns_flash_attention(const void* q, const void* k, const void* v, void* o,
                                   int64_t bh, int S, int Sk, int d, int dtype_code,
                                   float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || Sk < 1 || bh < 1) return cudaErrorInvalidValue;
  if (dtype_code == 1) {
    if (d == 64) return launch_bf16<64>(q, k, v, o, bh, S, Sk, scale, st);
    if (d == 128) return launch_bf16<128>(q, k, v, o, bh, S, Sk, scale, st);
  } else if (dtype_code == 0) {
    if (d == 64) return launch_f32<64>(q, k, v, o, bh, S, Sk, scale, st);
    if (d == 128) return launch_f32<128>(q, k, v, o, bh, S, Sk, scale, st);
  }
  return cudaErrorInvalidValue;
}
