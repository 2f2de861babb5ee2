// Fused RMSNorm for Hopper (sm_90a): the norm of every T5 block and of
// the DeepSeek-V2 stack in one pass over each row.
//
//   out = (float(w) * (float(x) * rsqrt(mean(float(x)^2) + eps))).to(x.dtype)
//
// over rows of d elements, in float32 with one rounding at the end.  x is
// bf16 or f32, w bf16 or f32 (under autocast an f32 weight meets a bf16
// x); out has x's dtype and is contiguous.  Rows of x lie row_stride
// elements apart (row_stride >= d, 16-byte aligned), so a slice of a wider
// row (DeepSeek-V2's kv_a_layernorm: 512 of 576) is read in place.
//
// Replaces no TPU kernel: the JAX package's RMSNorm
// (mevi_tpu/models/t5.py:53) is plain jnp, which XLA fuses into one pass.
// The port's composition of the same arithmetic in PyTorch ops launched
// nine kernels a call (cast, square, mean, add, rsqrt, two broadcasting
// multiplies, the weight's cast, the cast back), each reading and writing
// the whole row in float32: about 40 bytes moved for each bf16 element
// where one pass needs 4.
//
// What bounds it: bytes.  A row costs 3 flops an element against 2 + 2
// bytes (bf16), so device memory bandwidth (3.35 TB/s on an H100 SXM);
// the least time is (rows * d * (in + out itemsize) + d * w itemsize) /
// 3.35 TB/s.  The design reads each element once and writes it once:
//   1. one warp a row, kWarps rows a block; each lane issues all of its
//      16-byte loads of the row (8 bf16 or 4 f32 elements each, vector
//      k * 32 + lane) before any arithmetic, and keeps them in registers
//      through the reduction to the write: at bf16 2, 3 and 8 vectors a
//      lane at d 512, 768 and 2,048 (kD, fixed at compile time); any
//      other multiple of 8 up to 8,192 takes a loop that reads the row
//      twice (the second read mostly from L1 / L2);
//   2. the float32 sum of squares of a lane, then a butterfly of warp
//      shuffles: every lane ends with the same sum, in a fixed order, so
//      two launches (and a CUDA graph's replay) are bitwise equal; no
//      atomics, no shared partial sums;
//   3. the weight converted to float32 once a block into shared memory,
//      by all threads while the rows' loads are in flight;
//   4. 16-byte stores of the rounded row.
// The kernel allocates nothing and never synchronises; it launches on the
// caller's stream (PyTorch's current one), so it is captured inside the
// beam's CUDA graph.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;               // rows a block
constexpr int kThreads = kWarps * 32;

// 16 bytes of T as float32, and back with round-to-nearest-even.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void widen(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void widen(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ __forceinline__ static uint4 narrow(const float* f) {
    uint4 v;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    return v;
  }
};

__device__ __forceinline__ float to_float(float w) { return w; }
__device__ __forceinline__ float to_float(__nv_bfloat16 w) {
  return __bfloat162float(w);
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& v, float s) {
  float f[Vec<T>::kN];
  Vec<T>::widen(v, f);
#pragma unroll
  for (int e = 0; e < Vec<T>::kN; ++e) s = fmaf(f[e], f[e], s);
  return s;
}

// One 16-byte vector of the output: w * (x * r), rounded once; w points
// at the vector's kN float32 weights in shared memory (16-byte aligned).
template <typename T>
__device__ __forceinline__ uint4 scale(const uint4& v, const float* w,
                                       float r) {
  constexpr int kN = Vec<T>::kN;
  float f[kN], g[kN];
  Vec<T>::widen(v, f);
#pragma unroll
  for (int q = 0; q < kN / 4; ++q)
    reinterpret_cast<float4*>(g)[q] = reinterpret_cast<const float4*>(w)[q];
#pragma unroll
  for (int e = 0; e < kN; ++e) f[e] = __fmul_rn(g[e], __fmul_rn(f[e], r));
  return Vec<T>::narrow(f);
}

// kD: the row width this instance is unrolled for (0: any multiple of 8).
template <typename T, typename W, int kD>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, long long row_stride,
               const W* __restrict__ w, int d, int rows, float eps,
               T* __restrict__ out) {
  extern __shared__ float4 wsh4[];      // d float32 weights
  float* wsh = reinterpret_cast<float*>(wsh4);
  constexpr int kN = Vec<T>::kN;
  constexpr int kV = kD / (kN * 32);    // vectors a lane (kD > 0)
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps +
                        (threadIdx.x >> 5);
  const bool live = row < rows;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * row_stride);
  const int nvec = d / kN;

  uint4 v[kV > 0 ? kV : 1];
  if (kV > 0 && live) {
#pragma unroll
    for (int k = 0; k < kV; ++k) v[k] = xr[k * 32 + lane];
  }
  for (int i = threadIdx.x; i < d; i += kThreads) wsh[i] = to_float(w[i]);

  float s = 0.f;                        // live is the same on a warp
  if (kV > 0 && live) {
#pragma unroll
    for (int k = 0; k < kV; ++k) s = sum_squares<T>(v[k], s);
  } else if (live) {
    for (int k = lane; k < nvec; k += 32) s = sum_squares<T>(xr[k], s);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  const float r = rsqrtf(s / static_cast<float>(d) + eps);
  __syncthreads();                      // the weight is in shared memory
  if (!live) return;

  uint4* o = reinterpret_cast<uint4*>(out + row * d);
  if (kV > 0) {
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int j = k * 32 + lane;
      o[j] = scale<T>(v[k], wsh + j * kN, r);
    }
  } else {
    for (int k = lane; k < nvec; k += 32) o[k] = scale<T>(xr[k], wsh + k * kN, r);
  }
}

template <typename T, typename W, int kD>
cudaError_t launch_d(const void* x, long long row_stride, const void* w,
                     int d, int rows, float eps, void* out,
                     cudaStream_t stream) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  const size_t smem = static_cast<size_t>(d) * sizeof(float);
  rmsnorm_kernel<T, W, kD><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), row_stride, static_cast<const W*>(w), d, rows,
      eps, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T, typename W>
cudaError_t launch(const void* x, long long row_stride, const void* w, int d,
                   int rows, float eps, void* out, cudaStream_t stream) {
  switch (d) {
    case 512:
      return launch_d<T, W, 512>(x, row_stride, w, d, rows, eps, out, stream);
    case 768:
      return launch_d<T, W, 768>(x, row_stride, w, d, rows, eps, out, stream);
    case 2048:
      return launch_d<T, W, 2048>(x, row_stride, w, d, rows, eps, out, stream);
    default:
      return launch_d<T, W, 0>(x, row_stride, w, d, rows, eps, out, stream);
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  The caller guarantees d % 8 ==
// 0, d <= 8192, rows > 0, row_stride >= d with 16-byte aligned rows, x,
// w and out 16-byte aligned, out contiguous (rows, d).  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int mevi_rmsnorm(const void* x, int x_dtype, long long row_stride,
                            const void* w, int w_dtype, int d, int rows,
                            float eps, void* out, void* stream) {
  if (d % 8 || d <= 0 || d > 8192 || rows <= 0 || row_stride < d)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (x_dtype == 0 && w_dtype == 0)
    return launch<float, float>(x, row_stride, w, d, rows, eps, out, s);
  if (x_dtype == 0 && w_dtype == 1)
    return launch<float, bf16>(x, row_stride, w, d, rows, eps, out, s);
  if (x_dtype == 1 && w_dtype == 0)
    return launch<bf16, float>(x, row_stride, w, d, rows, eps, out, s);
  if (x_dtype == 1 && w_dtype == 1)
    return launch<bf16, bf16>(x, row_stride, w, d, rows, eps, out, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* mevi_rmsnorm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
