// Fused federated server step on the flat (C, Np) float32 delta buffer, for
// Hopper (sm_90a). Replaces the Pallas TPU kernel
// repro/kernels/fedcore/kernel.py::server_apply (body _server_apply_kernel).
//
// One pass computes, per element i:
//   pg_i   = sum_c wn_c * delta[c, i]  (+ noise_i, pre-scaled DP noise)
//   FedAvg  p <- p - lr*pg
//   FedMom  m <- mu*m + pg;  p <- p - lr*(nesterov ? mu*m + pg : m)
//   FedAdam m <- mu*m + (1-mu)*pg;  v <- b2*v + (1-b2)*pg^2;
//           p <- p - lr*(m/b1c)/(sqrt(v/b2c) + eps)
// and three reductions: ||pg||^2, ||new params||^2 and per-client ||delta_c||^2.
// params and the optimizer lanes are updated in place: each element is read
// and written by the same thread, so the aliasing is safe.
//
// Bound: memory. Each input byte is read once and each output byte written
// once: (C + 2 + 2L) * 4 * Np bytes for L optimizer lanes (+ 4 * Np with DP
// noise), against ~(2C + 10) flops per element — far below the card's
// operations-per-byte ridge. The design therefore only streams: 16-byte
// (float4) coalesced loads in a grid-stride loop.
//
// The TPU kernel accumulated the norms in revisited output blocks, which is
// race-free only because its grid runs in order. Hopper blocks run in any
// order, so here each block writes its partial sums (2 + C doubles) to a
// scratch row, and a second kernel sums the rows in a fixed order. No atomics:
// the norms are bitwise identical from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Opt { kFedAvg = 0, kFedMom = 1, kFedAdam = 2 };

struct Hyper {
  float lr, momentum, one_minus_momentum, beta2, one_minus_beta2, eps, b1c, b2c;
  int opt, nesterov;
};

__device__ __forceinline__ float update(const Hyper& h, float p, float g, float* m, float* v) {
  if (h.opt == kFedAvg) {
    return p - h.lr * g;
  }
  if (h.opt == kFedMom) {
    const float nm = h.momentum * (*m) + g;
    *m = nm;
    const float upd = h.nesterov ? h.momentum * nm + g : nm;
    return p - h.lr * upd;
  }
  const float nm = h.momentum * (*m) + h.one_minus_momentum * g;
  const float nv = h.beta2 * (*v) + h.one_minus_beta2 * (g * g);
  *m = nm;
  *v = nv;
  return p - (h.lr * (nm / h.b1c)) / (sqrtf(nv / h.b2c) + h.eps);
}

__device__ __forceinline__ double sq4(float4 a) {
  return (double)a.x * a.x + (double)a.y * a.y + (double)a.z * a.z + (double)a.w * a.w;
}

__device__ __forceinline__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// MAXC bounds the cohort at compile time so the per-client accumulators stay
// in registers; clients k >= c are skipped.
template <int MAXC>
__global__ void __launch_bounds__(kThreads) server_apply_kernel(
    const float* __restrict__ deltas, const float* __restrict__ wn, float* params,
    float* lane0, float* lane1, const float* __restrict__ noise,
    double* __restrict__ partials, int64_t n4, int c, Hyper h) {
  float w[MAXC];
  double acc_d[MAXC];
#pragma unroll
  for (int k = 0; k < MAXC; ++k) {
    w[k] = k < c ? wn[k] : 0.f;
    acc_d[k] = 0.0;
  }
  double acc_pg = 0.0, acc_np = 0.0;

  const float4* d4 = reinterpret_cast<const float4*>(deltas);
  const float4* z4 = reinterpret_cast<const float4*>(noise);
  float4* p4 = reinterpret_cast<float4*>(params);
  float4* m4 = reinterpret_cast<float4*>(lane0);
  float4* v4 = reinterpret_cast<float4*>(lane1);
  const int64_t stride = (int64_t)gridDim.x * kThreads;

  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n4; i += stride) {
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int k = 0; k < MAXC; ++k) {
      if (k < c) {
        const float4 d = __ldcs(d4 + (int64_t)k * n4 + i);
        g.x += w[k] * d.x;
        g.y += w[k] * d.y;
        g.z += w[k] * d.z;
        g.w += w[k] * d.w;
        acc_d[k] += sq4(d);
      }
    }
    if (z4 != nullptr) {
      const float4 z = __ldcs(z4 + i);
      g.x += z.x;
      g.y += z.y;
      g.z += z.z;
      g.w += z.w;
    }
    float4 p = p4[i];
    float4 m = m4 != nullptr ? m4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 v = v4 != nullptr ? v4[i] : make_float4(0.f, 0.f, 0.f, 0.f);
    p.x = update(h, p.x, g.x, &m.x, &v.x);
    p.y = update(h, p.y, g.y, &m.y, &v.y);
    p.z = update(h, p.z, g.z, &m.z, &v.z);
    p.w = update(h, p.w, g.w, &m.w, &v.w);
    p4[i] = p;
    if (m4 != nullptr) m4[i] = m;
    if (v4 != nullptr) v4[i] = v;
    acc_pg += sq4(g);
    acc_np += sq4(p);
  }

  // block reduction in a fixed order: warp shuffles, then warp 0..7 in turn
  __shared__ double smem[kWarps][2 + MAXC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  acc_pg = warp_sum(acc_pg);
  acc_np = warp_sum(acc_np);
#pragma unroll
  for (int k = 0; k < MAXC; ++k) acc_d[k] = warp_sum(acc_d[k]);
  if (lane == 0) {
    smem[warp][0] = acc_pg;
    smem[warp][1] = acc_np;
#pragma unroll
    for (int k = 0; k < MAXC; ++k) smem[warp][2 + k] = acc_d[k];
  }
  __syncthreads();
  const int width = 2 + c;
  if (threadIdx.x < width) {
    double s = 0.0;
    for (int wi = 0; wi < kWarps; ++wi) s += smem[wi][threadIdx.x];
    partials[(int64_t)blockIdx.x * width + threadIdx.x] = s;
  }
}

// One block per reduced quantity j: sums column j of the (nblocks, width)
// partials in a fixed order and writes it as float32.
__global__ void __launch_bounds__(kThreads) reduce_partials_kernel(
    const double* __restrict__ partials, int nblocks, int width, float* __restrict__ out) {
  const int j = blockIdx.x;
  double s = 0.0;
  for (int b = threadIdx.x; b < nblocks; b += kThreads) s += partials[(int64_t)b * width + j];
  __shared__ double smem[kWarps];
  s = warp_sum(s);
  if ((threadIdx.x & 31) == 0) smem[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double t = 0.0;
    for (int wi = 0; wi < kWarps; ++wi) t += smem[wi];
    out[j] = (float)t;
  }
}

template <int MAXC>
void launch(int grid, cudaStream_t stream, const float* deltas, const float* wn, float* params,
            float* lane0, float* lane1, const float* noise, double* partials, int64_t n4, int c,
            const Hyper& h) {
  server_apply_kernel<MAXC><<<grid, kThreads, 0, stream>>>(deltas, wn, params, lane0, lane1,
                                                           noise, partials, n4, c, h);
}

}  // namespace

extern "C" {

// deltas (c, n) f32 with 1 <= c <= 32; wn (c,) f32 weights already divided by their sum;
// params/lane0/lane1 (n,) f32 updated in place (lanes null when unused);
// noise (n,) f32 or null; partials (grid, 2 + c) f64 scratch;
// out (2 + c,) f32 = [||pg||^2, ||new params||^2, ||delta_0||^2, ...].
// one_minus_* are passed in (not formed here) so they carry the float32 value
// of the double difference, as the reference's constants do.
// n must be a multiple of 4 and every pointer 16-byte aligned.
// Returns cudaGetLastError() after both launches.
int fedcore_server_apply(const float* deltas, const float* wn, float* params, float* lane0,
                         float* lane1, const float* noise, double* partials, float* out,
                         long long n, int c, int opt, int nesterov, float lr, float momentum,
                         float one_minus_momentum, float beta2, float one_minus_beta2,
                         float eps, float b1c, float b2c, int grid, void* stream) {
  if (c < 1 || c > 32 || n % 4 != 0 || grid < 1 || opt < kFedAvg || opt > kFedAdam) {
    return (int)cudaErrorInvalidValue;
  }
  Hyper h;
  h.lr = lr;
  h.momentum = momentum;
  h.one_minus_momentum = one_minus_momentum;
  h.beta2 = beta2;
  h.one_minus_beta2 = one_minus_beta2;
  h.eps = eps;
  h.b1c = b1c;
  h.b2c = b2c;
  h.opt = opt;
  h.nesterov = nesterov;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t n4 = n / 4;
  if (c <= 4) {
    launch<4>(grid, s, deltas, wn, params, lane0, lane1, noise, partials, n4, c, h);
  } else if (c <= 8) {
    launch<8>(grid, s, deltas, wn, params, lane0, lane1, noise, partials, n4, c, h);
  } else if (c <= 16) {
    launch<16>(grid, s, deltas, wn, params, lane0, lane1, noise, partials, n4, c, h);
  } else {
    launch<32>(grid, s, deltas, wn, params, lane0, lane1, noise, partials, n4, c, h);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_partials_kernel<<<2 + c, kThreads, 0, s>>>(partials, grid, 2 + c, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
