// layer_norm: y = (x - mean) * rsqrt(var + eps) * g + b over the last dim,
// with f32 statistics and the population variance, one rounding to x's type.
//
// Replaces no TPU kernel.  The JAX package's ViT normalises with `_ln`
// (nnstreamer_tpu/models/vit.py), a few jnp operations that XLA fuses into
// one pass; PyTorch runs the same operations eagerly, as about twelve
// kernels that each read or write the whole activation in f32.  This kernel
// gives the port that fusion back.  Its caller is the ViT's `LayerNorm`
// (models/vit.py), two a block and one before the head.
//
// Math, as the plain version (ops/kernels.py layer_norm_reference): x
// widened to f32; mu = sum(x) / width; var = sum((x - mu)^2) / width, the
// two-pass form, from the values already in registers (no E[x^2] - mu^2,
// which cancels); r = rsqrt(var + eps); y = ((x - mu) * r) * g + b in f32,
// each step rounded as the plain version rounds it (the _rn intrinsics keep
// nvcc from contracting the last two into an FMA), then one rounding to
// x's type.  Only the order of the two sums differs.
//
// Bound: bytes.  A row is read once and written once, 4 bytes an element in
// bf16: at the ViT-B/16 cell's shape (8192 * 196 rows of 768) 4.93 GB a
// call, 1.47 ms at 3.35 TB/s; about 10 operations an element are nothing
// beside that.  What the design does about it:
//
// - One warp a row, the row in registers: lane i holds the 16-byte vectors
//   i, i + 32, ..., so each load instruction of the warp covers 512
//   contiguous bytes.  NV, the vectors a lane holds, is a template
//   parameter the launcher picks from the width (bf16 768 -> 3); lanes
//   past the row's end are masked.  The sums go across the warp by
//   __shfl_xor_sync: no shared memory, no block barrier.
// - Two rows in flight a warp: the next row's loads are issued before the
//   current row's reductions.  Loads stream past L1 (ld.global.nc with no
//   L1 allocation); stores are 16 bytes a lane.
// - g and b (f32, `width` each) are loaded once a warp and kept in
//   registers across the rows it walks: a grid-stride loop over rows, with
//   as many blocks an SM as fit at once.
// - Offsets in 64 bits: the cell's activation holds 1.23e9 elements.
//
// A row of at most 4 KiB (8 vectors a lane): bf16 widths up to 2048, f32 up
// to 1024, each a multiple of the 16-byte vector (8 bf16, 4 f32).  Rows may
// lie any multiple of 16 bytes apart; the output is contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 8 rows at a time a block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxVecs = 8;    // 16-byte vectors a lane: rows of at most 4 KiB

__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// One 16-byte vector of T as N floats, and back.
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void widen(const uint4& v, float* f) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // the lower half is the first element
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  __device__ static uint4 narrow(const float* f) {
    return make_uint4(pack(f[0], f[1]), pack(f[2], f[3]), pack(f[4], f[5]),
                      pack(f[6], f[7]));
  }
};

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  return s;
}

template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
    layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ g,
                      const float* __restrict__ b, T* __restrict__ y, int64_t rows,
                      int64_t x_stride, int width, float eps) {
  using V = Vec<T>;
  constexpr int E = NV * V::N;
  const int lane = threadIdx.x & 31;
  const int nvec = width / V::N;
  bool live[NV];
  float gr[E], br[E];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int v = lane + 32 * j;
    live[j] = v < nvec;
#pragma unroll
    for (int e = 0; e < V::N; ++e) {
      gr[j * V::N + e] = live[j] ? g[v * V::N + e] : 0.f;
      br[j * V::N + e] = live[j] ? b[v * V::N + e] : 0.f;
    }
  }
  const int64_t step = static_cast<int64_t>(gridDim.x) * kWarps;
  int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  uint4 cur[NV], next[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) cur[j] = next[j] = make_uint4(0, 0, 0, 0);
  auto load_row = [&](int64_t r, uint4* dst) {
    const uint4* src = reinterpret_cast<const uint4*>(x + r * x_stride) + lane;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      if (live[j]) dst[j] = load_stream(src + 32 * j);
  };
  if (row < rows) load_row(row, cur);
  for (; row < rows; row += step) {
    if (row + step < rows) load_row(row + step, next);
    float f[E];
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      V::widen(cur[j], f + j * V::N);  // masked vectors hold zeros
#pragma unroll
      for (int e = 0; e < V::N; ++e) s += f[j * V::N + e];
    }
    const float mu = warp_sum(s) / width;
    float q = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!live[j]) continue;
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        const float d = f[j * V::N + e] - mu;
        q += d * d;
      }
    }
    const float r = rsqrtf(warp_sum(q) / width + eps);
    uint4* dst = reinterpret_cast<uint4*>(y + row * static_cast<int64_t>(width)) + lane;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      if (!live[j]) continue;
      float o[V::N];
#pragma unroll
      for (int e = 0; e < V::N; ++e) {
        const int i = j * V::N + e;
        o[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[i], mu), r), gr[i]), br[i]);
      }
      dst[32 * j] = V::narrow(o);
    }
#pragma unroll
    for (int j = 0; j < NV; ++j) cur[j] = next[j];
  }
}

template <typename T, int NV>
cudaError_t launch(const void* x, const float* g, const float* b, void* y, int64_t rows,
                   int64_t x_stride, int width, float eps, cudaStream_t stream) {
  // blocks an SM that fit at once; the same on every card of one process
  static int per_sm = 0;
  if (per_sm == 0) {
    int n = 0;
    cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, layer_norm_kernel<T, NV>, kThreads, 0);
    if (err != cudaSuccess) return err;
    per_sm = n > 0 ? n : 1;
  }
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int64_t blocks = (rows + kWarps - 1) / kWarps;
  const int64_t most = static_cast<int64_t>(sms) * per_sm;
  if (blocks > most) blocks = most;
  layer_norm_kernel<T, NV><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(x), g, b, static_cast<T*>(y), rows, x_stride, width, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const float* g, const float* b, void* y, int64_t rows,
                     int64_t x_stride, int width, float eps, cudaStream_t s) {
  constexpr int N = Vec<T>::N;
  if (width < N || width % N != 0 || width > 32 * kMaxVecs * N) return cudaErrorInvalidValue;
  switch ((width / N + 31) / 32) {
    case 1: return launch<T, 1>(x, g, b, y, rows, x_stride, width, eps, s);
    case 2: return launch<T, 2>(x, g, b, y, rows, x_stride, width, eps, s);
    case 3: return launch<T, 3>(x, g, b, y, rows, x_stride, width, eps, s);
    case 4: return launch<T, 4>(x, g, b, y, rows, x_stride, width, eps, s);
    case 5: return launch<T, 5>(x, g, b, y, rows, x_stride, width, eps, s);
    case 6: return launch<T, 6>(x, g, b, y, rows, x_stride, width, eps, s);
    case 7: return launch<T, 7>(x, g, b, y, rows, x_stride, width, eps, s);
    case 8: return launch<T, 8>(x, g, b, y, rows, x_stride, width, eps, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x: `rows` rows of `width` elements, `x_stride` elements apart (16-byte
// aligned base and stride); g, b: `width` f32 each; y: contiguous, x's type.
// dtype_code: 0 float32, 1 bfloat16.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int nns_layer_norm(const void* x, const void* g, const void* b, void* y,
                              int64_t rows, int64_t x_stride, int width, int dtype_code,
                              float eps, void* stream) {
  if (rows < 1) return cudaErrorInvalidValue;
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return dispatch<float>(x, gf, bf, y, rows, x_stride, width, eps, s);
    case 1: return dispatch<__nv_bfloat16>(x, gf, bf, y, rows, x_stride, width, eps, s);
    default: return cudaErrorInvalidValue;
  }
}
