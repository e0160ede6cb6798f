// scale_bias_cast: y = ((x + bias) * scale) cast to f32 or bf16, elementwise.
//
// Replaces the Pallas TPU kernel `scale_bias_cast` in
// nnstreamer_tpu/ops/kernels.py (the pl.pallas_call that tiles x as
// (rows, 128) blocks).  It is the normalize prologue of the detection
// pipeline: tensor_transform typecast:float32,add:-127.5,div:127.5 folded
// to (x + b/a) * a by elements/transform.py.
//
// Bound: bytes.  The kernel does 2 floating-point operations per element
// and moves n * (sizeof(in) + sizeof(out)) bytes, so on an H100 it can be
// no faster than that byte count over the HBM bandwidth (uint8 -> f32 at
// batch 256 x 300 x 300 x 3: 69.1 MB read + 276.5 MB written).
//
// Design: one pass, nothing staged in shared memory.  Each thread moves
// one vector of V elements per step, V chosen so that the wider side of the
// cast is a 16-byte access: uint8 -> f32 loads 4 bytes and stores 16,
// f32 -> f32 loads and stores 16, f32 -> bf16 loads 16 and stores 8.  So a
// warp's loads and its stores each cover one contiguous span (full
// coalescing on both sides; a thread that loaded 16 uint8 would have to
// write 64 bytes, and a warp's stores would then stride 64 bytes apart).
// The values are widened to f32, `bias` is added, the sum is multiplied
// by `scale` and the result is cast to f32 or bf16 (round to nearest
// even).  A grid-stride loop covers the array; a scalar loop covers the
// tail and any input or output that is not 16-byte aligned, so any
// contiguous tensor is accepted.  The operation order and the f32
// scalars match the plain PyTorch version (ops/kernels.py
// scale_bias_cast_reference) so the two agree bit for bit; an add
// followed by a multiply gives nvcc nothing to contract into an FMA.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T>
__device__ __forceinline__ float to_f32(T v) { return static_cast<float>(v); }
template <>
__device__ __forceinline__ float to_f32<__half>(__half v) { return __half2float(v); }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename O>
__device__ __forceinline__ O from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename I, typename O>
__device__ __forceinline__ O apply(I v, float scale, float bias) {
  float f = to_f32(v) + bias;
  return from_f32<O>(f * scale);
}

// A plain-old-data vector of N bytes (the unit of one load or store).
template <int N> struct Bytes;
template <> struct Bytes<4> { using T = uint32_t; };
template <> struct Bytes<8> { using T = uint2; };
template <> struct Bytes<16> { using T = uint4; };

template <typename I, typename O>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (sizeof(I) > sizeof(O) ? sizeof(I) : sizeof(O));
}

template <typename I, typename O>
__global__ void scale_bias_cast_kernel(const I* __restrict__ x, O* __restrict__ y,
                                       int64_t n, int64_t nvec, float scale,
                                       float bias) {
  constexpr int V = vec_elems<I, O>();
  using In = typename Bytes<V * sizeof(I)>::T;
  using Out = typename Bytes<V * sizeof(O)>::T;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const In* xv = reinterpret_cast<const In*>(x);
  Out* yv = reinterpret_cast<Out*>(y);
  for (int64_t i = tid; i < nvec; i += stride) {
    alignas(16) In raw = xv[i];
    const I* e = reinterpret_cast<const I*>(&raw);
    alignas(16) O out[V];
#pragma unroll
    for (int j = 0; j < V; ++j) out[j] = apply<I, O>(e[j], scale, bias);
    yv[i] = *reinterpret_cast<const Out*>(out);
  }
  for (int64_t i = nvec * V + tid; i < n; i += stride) y[i] = apply<I, O>(x[i], scale, bias);
}

template <typename I, typename O>
cudaError_t launch(const void* x, void* y, int64_t n, float scale, float bias,
                   cudaStream_t stream) {
  constexpr int V = vec_elems<I, O>();
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  const int64_t nvec = aligned ? n / V : 0;
  const int threads = 256;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t work = nvec > 0 ? nvec : n;
  int64_t blocks = (work + threads - 1) / threads;
  const int64_t max_blocks = static_cast<int64_t>(sms) * 32;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  scale_bias_cast_kernel<I, O><<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      static_cast<const I*>(x), static_cast<O*>(y), n, nvec, scale, bias);
  return cudaGetLastError();
}

template <typename I>
cudaError_t launch_out(int out_code, const void* x, void* y, int64_t n, float scale,
                       float bias, cudaStream_t stream) {
  switch (out_code) {
    case 0: return launch<I, float>(x, y, n, scale, bias, stream);
    case 1: return launch<I, __nv_bfloat16>(x, y, n, scale, bias, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Input codes: 0 uint8, 1 int8, 2 uint16, 3 int16, 4 int32, 5 float16,
// 6 bfloat16, 7 float32.  Output codes: 0 float32, 1 bfloat16.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nns_scale_bias_cast(const void* x, void* y, int64_t n, int in_code,
                                   int out_code, float scale, float bias,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (in_code) {
    case 0: return launch_out<uint8_t>(out_code, x, y, n, scale, bias, s);
    case 1: return launch_out<int8_t>(out_code, x, y, n, scale, bias, s);
    case 2: return launch_out<uint16_t>(out_code, x, y, n, scale, bias, s);
    case 3: return launch_out<int16_t>(out_code, x, y, n, scale, bias, s);
    case 4: return launch_out<int32_t>(out_code, x, y, n, scale, bias, s);
    case 5: return launch_out<__half>(out_code, x, y, n, scale, bias, s);
    case 6: return launch_out<__nv_bfloat16>(out_code, x, y, n, scale, bias, s);
    case 7: return launch_out<float>(out_code, x, y, n, scale, bias, s);
    default: return cudaErrorInvalidValue;
  }
}
