// Flash attention forward for Hopper (sm_90a). Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_fwd (_flash_kernel).
//
// For each (b, h) with kv head h / (Hq / Hkv), and q scaled to f32 by
// 1/sqrt(hd) before the product:
//
//   s[i][j] = (q[i] * scale) . k[j],  masked to -1e30 where the key is not seen
//   o[i]    = sum_j p[i][j] v[j] / max(l[i], 1e-30),
//   p[i][j] = exp(s[i][j] - m[i]) where seen, else 0;  l[i] = sum_j p[i][j]
//
// with an online softmax over key tiles (m and l carried as the TPU kernel
// carries them in VMEM scratch). A key j is seen by query i (absolute position
// q_offset + i) when j < Sk, j <= q_offset + i under `causal`, and
// q_offset + i - j < window under a window. A row that sees no key gives 0.
// The output is rounded to q's dtype (round to nearest even).
//
// Bound: operations. 4 * B * Hq * Sq * Sk * hd flops for the two products
// (46.08 GFLOP at whisper-large-v3's encoder layer, B 4, H 20, S 1500, hd 64)
// against 61.44 MB of q, k, v and o in bf16: 750 flops per byte. In f32 on the
// CUDA cores, as here and in the TPU kernel, that is 0.688 ms at 67 TFLOP/s;
// bf16 tensor cores would make it 0.047 ms (989 TFLOP/s).
//
// Design. The TPU kernel runs a grid (B, Hq, n_q, n_kv) whose kv axis is
// sequential and one 1500 x 1500 block at whisper's shape (no 128-divisor).
// Here one block owns 64 queries of one (b, h) and loops over the key tiles of
// 64 that some of its queries can see (tiles wholly masked by the causal or
// window rule are skipped: they would leave m, l and the sum unchanged). Keys
// past Sk in the ragged last tile are staged as zeros and masked out of the
// softmax (a zero key would score 0 and take weight). q (scaled, transposed),
// k (transposed), v and the tile's probabilities (transposed) are staged in
// shared memory as f32. 256 threads form a 16 x 16 grid: thread
// (ti, tj) computes the 4 x 4 scores of queries 4ti.. and keys 4tj.. as outer
// products of float4 rows with explicit fused multiply-adds (the library is
// built with --fmad=false), reduces the row max and sum over its 16 lanes with
// warp shuffles, and keeps m, l and the 4 x hd/16 accumulator of queries 4ti..
// and dims (hd/16)tj.. in registers. GQA is index arithmetic: no copy of k or
// v per head. (Sq/64) x Hq x B blocks: 1,920 at whisper's encoder shape.
//
// Later work, not done here: Q.K^T and P.V on the tensor cores (mma.sync or
// wgmma on bf16), TMA staging of the next tile while this one computes, and
// the 8-way bank conflicts of the transposed stores into shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // row padding of the shared tiles, in floats (float4-aligned)
constexpr float kNegInf = -1e30f;
constexpr size_t kMaxSmem = 232448;  // what one block may use on Hopper

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

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)HD * (kBQ + kPad) + (size_t)HD * (kBK + kPad) + (size_t)kBK * (HD + kPad) +
         (size_t)kBK * (kBQ + kPad);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    int Hq, int Hkv, int Sq, int Sk, int causal, int has_window, int window, int q_offset,
    float scale) {
  constexpr int LQ = kBQ + kPad, LK = kBK + kPad, LD = HD + kPad;
  constexpr int DPT = HD / 16;  // output dims per thread: 4 or 8
  extern __shared__ float4 smem4[];
  float* Qt = reinterpret_cast<float*>(smem4);  // [HD][LQ]  q * scale, transposed
  float* Kt = Qt + HD * LQ;                     // [HD][LK]  the key tile, transposed
  float* Vs = Kt + HD * LK;                     // [kBK][LD] the value tile
  float* Pt = Vs + kBK * LD;                    // [kBK][LQ] the tile's p, transposed

  const int tid = threadIdx.x;
  const int ti = tid / 16, tj = tid % 16;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int64_t q_off = ((int64_t)b * Hq + h) * Sq * HD;
  const int64_t kv_off = ((int64_t)b * Hkv + hk) * Sk * HD;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    const float x = q0 + i < Sq ? to_f(q[q_off + (int64_t)(q0 + i) * HD + d]) : 0.f;
    Qt[d * LQ + i] = __fmul_rn(x, scale);
  }

  // the keys some query of this block may see: [kbeg, kend)
  const long long qlo = (long long)q_offset + q0;
  const long long qhi = (long long)q_offset + min(Sq, q0 + kBQ) - 1;
  long long kend = Sk, kbeg = 0;
  if (causal) kend = kend < qhi + 1 ? kend : qhi + 1;
  if (has_window) kbeg = qlo - window + 1 > 0 ? qlo - window + 1 : 0;
  kbeg = kbeg / kBK * kBK;

  long long qpos[4];
  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    qpos[r] = qlo + 4 * ti + r;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[r][c] = 0.f;
  }

  for (long long k0 = kbeg; k0 < kend; k0 += kBK) {
    __syncthreads();  // q is staged; the previous tile's Kt, Vs and Pt are no longer read
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int j = e / HD, d = e % HD;
      const bool in = k0 + j < Sk;
      const int64_t g = kv_off + (k0 + j) * HD + d;
      Kt[d * LK + j] = in ? to_f(k[g]) : 0.f;
      Vs[j * LD + d] = in ? to_f(v[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4] = {};
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
      ld4(Qt + d * LQ + 4 * ti, qv);
      ld4(Kt + d * LK + 4 * tj, kv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = __fmaf_rn(qv[r], kv[c], s[r][c]);
    }

    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      bool seen[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long kp = k0 + 4 * tj + c;
        seen[c] = kp < Sk && (!causal || kp <= qpos[r]) && (!has_window || qpos[r] - kp < window);
        s[r][c] = seen[c] ? s[r][c] : kNegInf;
        mx = fmaxf(mx, s[r][c]);
      }
      // the 16 lanes of one ti hold the row's 64 keys
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(__fsub_rn(m[r], m_new));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = seen[c] ? expf(__fsub_rn(s[r][c], m_new)) : 0.f;
        sum = __fadd_rn(sum, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      l[r] = __fadd_rn(__fmul_rn(l[r], alpha[r]), sum);
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(Pt + (4 * tj + c) * LQ + 4 * ti) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < DPT; ++c) acc[r][c] = __fmul_rn(acc[r][c], alpha[r]);
    for (int j = 0; j < kBK; ++j) {
      float pv[4], vv[DPT];
      ld4(Pt + j * LQ + 4 * ti, pv);
#pragma unroll
      for (int c4 = 0; c4 < DPT; c4 += 4) {
        float t[4];
        ld4(Vs + j * LD + DPT * tj + c4, t);
#pragma unroll
        for (int c = 0; c < 4; ++c) vv[c4 + c] = t[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[r][c] = __fmaf_rn(pv[r], vv[c], acc[r][c]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = q0 + 4 * ti + r;
    if (i >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    T* orow = o + q_off + (int64_t)i * HD + DPT * tj;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[c] = from_f<T>(__fdiv_rn(acc[r][c], denom));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
           int Sk, int causal, int has_window, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Sk, causal, has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B, int Hq, int Hkv, int Sq,
             int Sk, int hd, int causal, int has_window, int window, int q_offset, float scale,
             cudaStream_t stream) {
  if (hd == 64)
    return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, has_window, window, q_offset,
                         scale, stream);
  return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Sk, causal, has_window, window, q_offset,
                        scale, stream);
}

static_assert(smem_floats<128>() * sizeof(float) <= kMaxSmem,
              "hd = 128 tiles exceed shared memory");

}  // namespace

extern "C" {

// q, o (B, Hq, Sq, hd) and k, v (B, Hkv, Sk, hd), all bf16 when is_bf16, else
// f32; contiguous. hd is 64 or 128. `window` is read only when has_window.
// Returns cudaGetLastError() after the one launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int Sq, int Sk, int hd, int causal, int has_window, int window,
                        int q_offset, float scale, int is_bf16, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || Hq > 65535 ||
      B > 65535 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, causal, has_window,
                                   window, q_offset, scale, s);
  return dispatch<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, hd, causal, has_window, window, q_offset,
                         scale, s);
}

}  // extern "C"
