// RMSNorm forward for Hopper (sm_90a). Replaces the Pallas TPU kernel
// repro/kernels/rmsnorm/kernel.py::rmsnorm_fwd (_rmsnorm_kernel).
//
// For each row x of an (R, D) matrix, in f32:
//
//   var = (sum_d x[d]^2) / D
//   r   = 1 / sqrt(var + eps)                (IEEE sqrt, then an IEEE division)
//   y   = (x * r) * scale                    rounded to x's dtype (nearest even)
//
// the multiplication order of the TPU kernel. The library is built with
// --fmad=false, so the sum of squares writes its fused multiply-adds itself
// (__fmaf_rn) and every other product and sum rounds on its own. rsqrtf is
// not used: it is up to 2 ulp off, and the plain version divides by an IEEE
// square root as well.
//
// Bound: bytes. Each element is read once and written once (2 * R * D *
// itemsize bytes, plus D * 4 of scale): at qwen3-1.7b's prefill_32k
// activations (1,048,576 x 2048, bf16) 8.59 GB, 2.56 ms at 3.35 TB/s; four
// f32 operations an element are 0.13 ms at 67 TFLOP/s.
//
// Design. The TPU kernel takes 256-row blocks with D whole in VMEM. Here one
// warp owns one row (four rows to a 128-thread block, the grid striding over
// the rows), so the row's reduction is one warp's: each lane sums the squares
// of its elements in order, then xor shuffles add the 32 partial sums in a
// fixed tree (the result does not depend on the launch). Loads and stores
// are 16 bytes a lane where D and the pointers allow it (8 bf16 or 4 f32),
// else one element a lane. When a lane's share of the row fits in 8 or 16
// vectors (D <= 4096 bf16, D <= 2048 f32) the row stays in registers between
// the sum and the scaling, and each element crosses device memory once each
// way; longer rows are read a second time for the scaling (from L1 or L2).
// Register buffers sized to the row (8 vectors up to D = 2048 bf16) and small
// blocks keep more rows in flight per SM: on the H100, chip_smoke.py timed
// qwen3-1.7b's prefill_32k rows at 3.50 ms with 16 vectors and 256 threads,
// and at 2.95-3.01 ms so (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlocks = 132 * 64;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// E elements of T, loaded and stored as one access of E * sizeof(T) bytes
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

template <typename T, int E>
__device__ __forceinline__ float sum_sq(const Vec<T, E>& a, float acc) {
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float f = to_f(a.v[e]);
    acc = __fmaf_rn(f, f, acc);
  }
  return acc;
}

// (a * r) * scale[0:E], with scale read in 16-byte pieces where E allows
template <typename T, int E>
__device__ __forceinline__ Vec<T, E> scaled(const Vec<T, E>& a, const float* __restrict__ scale,
                                            float r) {
  float s[E];
  if constexpr (E % 4 == 0) {
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      const float4 q = *reinterpret_cast<const float4*>(scale + e);
      s[e] = q.x;
      s[e + 1] = q.y;
      s[e + 2] = q.z;
      s[e + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) s[e] = scale[e];
  }
  Vec<T, E> out;
#pragma unroll
  for (int e = 0; e < E; ++e) out.v[e] = from_f<T>(__fmul_rn(__fmul_rn(to_f(a.v[e]), r), s[e]));
  return out;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// E: elements per access (16 bytes' worth, or 1). NV: vectors a lane keeps in
// registers (0: read the row twice).
template <typename T, int E, int NV>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(const T* __restrict__ x,
                                                           const float* __restrict__ scale,
                                                           T* __restrict__ y, long long R, int D,
                                                           float eps) {
  using V = Vec<T, E>;
  const int lane = threadIdx.x % 32;
  const int nvec = D / E;
  for (long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32; row < R;
       row += (long long)gridDim.x * kWarps) {
    const V* xr = reinterpret_cast<const V*>(x + row * D);
    V* yr = reinterpret_cast<V*>(y + row * D);
    float ss = 0.f;
    if constexpr (NV > 0) {
      V buf[NV];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = lane + 32 * i;
        if (j < nvec) {
          buf[i] = xr[j];
          ss = sum_sq(buf[i], ss);
        }
      }
      const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)D), eps)));
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int j = lane + 32 * i;
        if (j < nvec) yr[j] = scaled(buf[i], scale + j * E, r);
      }
    } else {
      for (int j = lane; j < nvec; j += 32) ss = sum_sq(xr[j], ss);
      const float r = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(__fdiv_rn(warp_sum(ss), (float)D), eps)));
      for (int j = lane; j < nvec; j += 32) yr[j] = scaled(xr[j], scale + j * E, r);
    }
  }
}

template <typename T, int E, int NV>
int launch(const void* x, const float* scale, void* y, long long R, int D, float eps,
           cudaStream_t stream) {
  const long long want = (R + kWarps - 1) / kWarps;
  const int blocks = (int)(want < kMaxBlocks ? want : kMaxBlocks);
  rmsnorm_kernel<T, E, NV><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<T*>(y), R, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const float* scale, void* y, long long R, int D, float eps,
             cudaStream_t stream) {
  constexpr int E = 16 / sizeof(T);
  const bool aligned = D % E == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0 &&
                       (uintptr_t)scale % 16 == 0;
  // as few registers as the row needs: more warps in flight per SM
  if (!aligned) return launch<T, 1, 0>(x, scale, y, R, D, eps, stream);
  if (D / E <= 32 * 8) return launch<T, E, 8>(x, scale, y, R, D, eps, stream);
  if (D / E <= 32 * 16) return launch<T, E, 16>(x, scale, y, R, D, eps, stream);
  return launch<T, E, 0>(x, scale, y, R, D, eps, stream);
}

}  // namespace

extern "C" {

// x, y (R, D) contiguous, both bf16 when is_bf16, else f32; scale (D,) f32.
// Returns cudaGetLastError() after the one launch.
int rmsnorm_fwd(const void* x, const void* scale, void* y, long long R, int D, float eps,
                int is_bf16, void* stream) {
  if (R < 1 || D < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scale);
  if (is_bf16) return dispatch<__nv_bfloat16>(x, sc, y, R, D, eps, s);
  return dispatch<float>(x, sc, y, R, D, eps, s);
}

}  // extern "C"
