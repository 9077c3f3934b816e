// The Mamba2 SSD chunk scan for Hopper (sm_90a). Replaces the Pallas TPU
// kernel repro/kernels/ssd_scan/kernel.py::ssd_scan_fwd (_ssd_kernel).
//
// For each (b, h), in order over the chunks of length `chunk`, it carries an
// f32 state S (hd, ds); head h reads group h / (nh / G) of B and C. Within a
// chunk, with dA_cum the inclusive cumsum of dt * A:
//
//   y  = (C B^T o L) (dt o x) + exp(dA_cum) o (C S^T),
//        L[i, j] = exp(dA_cum[i] - dA_cum[j]) for j <= i, else 0
//   S <- exp(dA_total) S + ((dt o x) o w)^T B,  w = exp(dA_total - dA_cum)
//
// y is rounded to x's dtype (round to nearest even); the last S is returned.
//
// Bound: operations. The function needs C B^T once per (b, g, chunk) and,
// per (b, h, chunk), (C B^T o L)(dt o x), C S^T and the state update; L is
// zero above the diagonal, so the two intra-chunk products need only the
// t = chunk (chunk + 1) / 2 entries j <= i. That is 2 * t * ds flops per
// (b, g, chunk) plus 2 * (t * hd + 2 * chunk * hd * ds) per (b, h, chunk):
// 19.4 GFLOP at mamba2-1.3b's prefill shape (B 4, S 2048, nh 64, G 1, hd 64,
// ds 128, chunk 64) against 157 MB of inputs and outputs, ~120 flops per
// byte. Without tensor cores that is ~6x above the f32 ridge of the card
// (67 TFLOP/s over 3.35 TB/s = 20 flops per byte). This kernel does more
// than that: it computes C B^T for every head and the full chunk x chunk
// products (30.1 GFLOP at that shape).
//
// Design. The TPU kernel runs a grid (B, nh, n_chunks) whose chunk axis is
// sequential and keeps S in VMEM scratch between grid steps. Blocks here run in
// no order, so one block owns one (b, h) and loops over its chunks; S lives in
// shared memory for the whole loop. Each chunk is staged in shared memory as
// f32 (C and B transposed, dt * x, the masked scores) and the three products
// are register-tiled: every thread computes 4 x 4 outputs as outer products of
// two float4 rows of shared memory, with explicit fused multiply-adds (the
// library is built with --fmad=false, so nothing else is contracted). The
// cumsum is sequential in f32, as the TPU kernel's. B * nh blocks of 256
// threads and ~137 KB of dynamic shared memory: one block per SM, 256 blocks
// at the full shape, just under two waves on 132 SMs.
//
// Later work, not done here: C B^T does not depend on h within a group (1.05
// of the 3.67 MFLOP per (b, h, chunk), G = 1 at full width) and could be shared
// by the heads of a group; the tiles above the diagonal of the two
// intra-chunk products could be skipped; bf16 B and C could go through wgmma
// on the tensor cores; TMA could stage the next chunk while this one computes;
// the transposed stores into shared memory take 4-way bank conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;  // row padding of the shared tiles, in floats (keeps float4 alignment)
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

// acc[r][c] += a[r] * b[c]
__device__ __forceinline__ void outer4(float (&acc)[4][4], const float (&a)[4],
                                       const float (&b)[4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = __fmaf_rn(a[r], b[c], acc[r][c]);
}

size_t smem_floats(int hd, int ds, int chunk) {
  const size_t lc = chunk + kPad, ld = hd + kPad;
  return 2 * ds * lc + ds * ld + chunk * ld + chunk * lc + 4 * (size_t)chunk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ Cm, const float* __restrict__ init,
    T* __restrict__ y, float* __restrict__ final_state, int nh, int G, int S, int hd, int ds,
    int chunk) {
  extern __shared__ float4 smem4[];
  const int LC = chunk + kPad, LD = hd + kPad;
  float* Ct = reinterpret_cast<float*>(smem4);  // [ds][LC]   C of the chunk, transposed
  float* Bt = Ct + ds * LC;                     // [ds][LC]   B of the chunk, transposed
  float* St = Bt + ds * LC;                     // [ds][LD]   the carried state, transposed
  float* dx = St + ds * LD;                     // [chunk][LD] dt * x
  float* Mt = dx + chunk * LD;                  // [chunk][LC] (C B^T o L), transposed
  float* dts = Mt + chunk * LC;                 // [chunk]    dt
  float* cum = dts + chunk;                     // [chunk]    inclusive cumsum of dt * A
  float* ecum = cum + chunk;                    // [chunk]    exp(cum)
  float* w = ecum + chunk;                      // [chunk]    exp(cum[-1] - cum)

  const int tid = threadIdx.x;
  const int bh = blockIdx.x;  // b * nh + h
  const int h = bh % nh, b = bh / nh;
  const int g = h / (nh / G);
  const float a = A[h];
  const int64_t x_off = (int64_t)bh * S * hd;
  const int64_t t_off = (int64_t)bh * S;
  const int64_t bc_off = ((int64_t)b * G + g) * S * ds;
  const int64_t s_off = (int64_t)bh * hd * ds;
  const int q4 = chunk / 4, d4 = hd / 4, n4 = ds / 4;

  for (int e = tid; e < hd * ds; e += kThreads) St[(e % ds) * LD + e / ds] = init[s_off + e];

  for (int c0 = 0; c0 < S; c0 += chunk) {
    __syncthreads();  // the previous chunk is done with every tile
    for (int e = tid; e < chunk * ds; e += kThreads) {
      const int l = e / ds, n = e % ds;
      const int64_t gi = bc_off + (int64_t)(c0 + l) * ds + n;
      Ct[n * LC + l] = to_f(Cm[gi]);
      Bt[n * LC + l] = to_f(Bm[gi]);
    }
    for (int e = tid; e < chunk * hd; e += kThreads) {
      const int l = e / hd, d = e % hd;
      const float xv = to_f(x[x_off + (int64_t)(c0 + l) * hd + d]);
      dx[l * LD + d] = __fmul_rn(xv, __ldg(dt + t_off + c0 + l));
    }
    if (tid < chunk) dts[tid] = dt[t_off + c0 + tid];
    __syncthreads();
    if (tid == 0) {
      float s = 0.f;
      for (int l = 0; l < chunk; ++l) {
        s = __fadd_rn(s, __fmul_rn(dts[l], a));
        cum[l] = s;
      }
    }
    __syncthreads();
    const float total = cum[chunk - 1];
    if (tid < chunk) {
      ecum[tid] = expf(cum[tid]);
      w[tid] = expf(__fsub_rn(total, cum[tid]));
    }

    // scores: M[i][j] = (sum_n C[i][n] B[j][n]) * L[i][j], stored as Mt[j][i]
    for (int t = tid; t < q4 * q4; t += kThreads) {
      const int i0 = (t / q4) * 4, j0 = (t % q4) * 4;
      float acc[4][4] = {};
      for (int n = 0; n < ds; ++n) {
        float cv[4], bv[4];
        ld4(Ct + n * LC + i0, cv);
        ld4(Bt + n * LC + j0, bv);
        outer4(acc, cv, bv);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = j0 + c;
        float m[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = i0 + r;
          m[r] = j <= i ? __fmul_rn(acc[r][c], expf(__fsub_rn(cum[i], cum[j]))) : 0.f;
        }
        *reinterpret_cast<float4*>(Mt + j * LC + i0) = make_float4(m[0], m[1], m[2], m[3]);
      }
    }
    __syncthreads();

    // y[i][d] = sum_j M[i][j] dx[j][d] + exp(cum[i]) * sum_n C[i][n] S[d][n]
    for (int t = tid; t < q4 * d4; t += kThreads) {
      const int i0 = (t / d4) * 4, d0 = (t % d4) * 4;
      float intra[4][4] = {}, inter[4][4] = {};
      for (int j = 0; j < chunk; ++j) {
        float mv[4], xv[4];
        ld4(Mt + j * LC + i0, mv);
        ld4(dx + j * LD + d0, xv);
        outer4(intra, mv, xv);
      }
      for (int n = 0; n < ds; ++n) {
        float cv[4], sv[4];
        ld4(Ct + n * LC + i0, cv);
        ld4(St + n * LD + d0, sv);
        outer4(inter, cv, sv);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float e = ecum[i0 + r];
        T* yr = y + x_off + (int64_t)(c0 + i0 + r) * hd + d0;
#pragma unroll
        for (int c = 0; c < 4; ++c)
          yr[c] = from_f<T>(__fadd_rn(intra[r][c], __fmul_rn(inter[r][c], e)));
      }
    }
    __syncthreads();

    // S[d][n] <- exp(total) S[d][n] + sum_l (dx[l][d] w[l]) B[l][n]
    const float etot = expf(total);
    for (int t = tid; t < n4 * d4; t += kThreads) {
      const int n0 = (t / d4) * 4, d0 = (t % d4) * 4;
      float acc[4][4] = {};
      for (int l = 0; l < chunk; l += 4) {
        float bl[4][4];  // bl[r][q] = B[l + q][n0 + r]
#pragma unroll
        for (int r = 0; r < 4; ++r) ld4(Bt + (n0 + r) * LC + l, bl[r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float xw[4], bq[4];
          ld4(dx + (l + q) * LD + d0, xw);
          const float wq = w[l + q];
#pragma unroll
          for (int c = 0; c < 4; ++c) xw[c] = __fmul_rn(xw[c], wq);
#pragma unroll
          for (int r = 0; r < 4; ++r) bq[r] = bl[r][q];
          outer4(acc, bq, xw);
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* sr = St + (n0 + r) * LD + d0;
#pragma unroll
        for (int c = 0; c < 4; ++c) sr[c] = __fadd_rn(__fmul_rn(etot, sr[c]), acc[r][c]);
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < hd * ds; e += kThreads) final_state[s_off + e] = St[(e % ds) * LD + e / ds];
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* init, void* y, void* final_state, int B, int nh, int G, int S, int hd,
           int ds, int chunk, cudaStream_t stream) {
  const size_t bytes = smem_floats(hd, ds, chunk) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<B * nh, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(Cm), static_cast<const float*>(init),
      static_cast<T*>(y), static_cast<float*>(final_state), nh, G, S, hd, ds, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (B, nh, S, hd) and Bm, Cm (B, G, S, ds) are bf16 when is_bf16, else f32;
// dt (B, nh, S), A (nh,), init and final_state (B, nh, hd, ds) are f32; all
// contiguous. Returns cudaGetLastError() after the one launch.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                 const void* init, void* y, void* final_state, int B, int nh, int G, int S,
                 int hd, int ds, int chunk, int is_bf16, void* stream) {
  if (B < 1 || nh < 1 || G < 1 || nh % G != 0 || S < 0 || chunk < 4 || chunk % 4 != 0 ||
      S % chunk != 0 || hd < 4 || hd % 4 != 0 || ds < 4 || ds % 4 != 0 ||
      smem_floats(hd, ds, chunk) * sizeof(float) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, init, y, final_state, B, nh, G, S, hd, ds,
                                 chunk, s);
  return launch<float>(x, dt, A, Bm, Cm, init, y, final_state, B, nh, G, S, hd, ds, chunk, s);
}

}  // extern "C"
