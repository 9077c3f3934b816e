// Flash decode for Hopper (sm_90a): one query token against a long KV cache.
// Replaces the Pallas TPU kernel
// repro/kernels/flash_decode/kernel.py::flash_decode_fwd (_decode_kernel).
//
// For each batch row b and query head h, with kv head h / (Hq / Hkv), q
// scaled to f32 by 1/sqrt(hd) before the product, and the keys of row b that
// are seen — pos < kv_len[b], pos < S and, under a window, pos > kv_len[b] -
// 1 - window:
//
//   s[j] = (q * scale) . k[j]
//   o    = sum_j p[j] v[j] / max(l, 1e-30),  p[j] = exp(s[j] - m),  l = sum_j p[j]
//
// with an online softmax in f32 (m, l and the sum carried as the TPU kernel
// carries them in VMEM over its sequential kv axis). A row that sees no key
// gives 0. The output is rounded to q's dtype (round to nearest even).
//
// Bound: bytes. Each seen key and value row is read once per kv head (the
// bound counts no other bytes of the cache) and q and o once: at qwen3-1.7b's
// decode_32k layer (B 128, Hkv 8, S 32768, hd 128, bf16) 17.18 GB, 5.13 ms
// at 3.35 TB/s. The products are 2 * Hq / Hkv flops a cache byte, far under
// the 20 that f32 on the CUDA cores could keep up with.
//
// Design. The TPU grid is (B, Hq, S / 512) and re-reads each kv head's cache
// once per query head of its group. Here one block takes up to four query
// heads of one kv head (GT = 1, 2 or 4; a group of more than four heads is
// covered by several blocks, each reading the cache once) and a split of the
// keys the row sees: the seen range [lo, hi) of each row is cut on the card
// into n_split equal pieces, rounded to whole tiles, so a sliding window or a
// short kv_len spreads its few keys over as many blocks as a full cache, and
// keys no split owns are never read. n_split is chosen by the wrapper so that
// B * Hkv * n_split fills the card. Inside a block, each key row is read by a
// group of LPK lanes, 16 bytes a lane (8 bf16 or 4 f32; 8 f32 at hd 256),
// four rows to a lane group in flight at once; the lanes of a group add their
// partial dot products with xor shuffles, and every group keeps its own m, l
// and accumulator for its keys in registers. At the end the block merges its
// groups in shared memory (log-sum-exp, in group order) and writes the
// split's (m, l, acc) to a scratch buffer; a second kernel merges the splits,
// one block per (b, h) whose warps take the splits in turn, and divides.
// Every sum is taken in a fixed order, so two launches give the same bits.
// GQA is index arithmetic: no copy of k or v per head. k and v may be strided
// views (the model's (B, S, Hkv, hd) cache read in place); each row's hd
// values must be contiguous and 16-byte aligned.
//
// Later work, not done here: cp.async or TMA staging of the next rows in
// shared memory (prefetching them into registers instead was tried and ran
// slower: the extra registers cost more blocks per SM than the overlap
// gained), cheaper exponentials, and eight heads to a block for groups of
// eight.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNK = 4;  // key rows one lane group has in flight at once
constexpr float kNegInf = -1e30f;
constexpr int kMaxSplits = 8192;  // the merge keeps one weight per split in shared memory

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

template <typename T, int HD>
struct Tiling {
  static constexpr int LPK = HD * (int)sizeof(T) / 16 < 32 ? HD * (int)sizeof(T) / 16 : 32;
  static constexpr int EPL = HD / LPK;       // elements of a row per lane: 8 (bf16) or 4, 8 (f32)
  static constexpr int G = kThreads / LPK;   // lane groups per block
  static constexpr int TILE = G * kNK;       // key rows per block per step
};

// one lane's EPL elements of a row, read in 16-byte pieces
template <typename T, int N>
struct alignas(16) Vec {
  T v[N];
};

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ kv_len, float* __restrict__ part_m, float* __restrict__ part_l,
    float* __restrict__ part_acc, int Hq, int Hkv, int S, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss, int has_window, int window,
    int n_split, float scale) {
  using Tl = Tiling<T, HD>;
  constexpr int LPK = Tl::LPK, EPL = Tl::EPL, G = Tl::G, TILE = Tl::TILE;
  using V = Vec<T, EPL>;
  __shared__ float sm_m[G][GT], sm_l[G][GT];
  __shared__ float sm_acc[G][GT][HD];

  const int tid = threadIdx.x;
  const int gi = tid / LPK, sub = tid % LPK;
  const int split = blockIdx.x, b = blockIdx.z;
  const int grp = Hq / Hkv, n_hc = (grp + GT - 1) / GT;
  const int hk = blockIdx.y / n_hc, hc = blockIdx.y % n_hc;
  const int h0 = hk * grp + hc * GT;          // first query head of this block
  const int nh = min(GT, grp - hc * GT);      // query heads of this block

  const T* qb = q + ((int64_t)b * Hq + h0) * HD + sub * EPL;
  float qv[GT][EPL];
#pragma unroll
  for (int t = 0; t < GT; ++t)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[t][e] = t < nh ? __fmul_rn(to_f(qb[t * HD + e]), scale) : 0.f;

  // the keys this row sees, [lo, hi), and this split's share of them
  const long long kvl = kv_len[b];
  const long long hi = kvl < S ? kvl : S;
  long long lo = has_window ? kvl - window : 0;
  lo = lo > 0 ? lo : 0;
  const long long n = hi > lo ? hi - lo : 0;
  const long long chunk = ((n + n_split - 1) / n_split + TILE - 1) / TILE * TILE;
  const long long s0 = lo + split * chunk;
  const long long s1 = s0 + chunk < hi ? s0 + chunk : hi;

  const T* kb = k + b * k_sb + hk * k_sh + sub * EPL;
  const T* vb = v + b * v_sb + hk * v_sh + sub * EPL;
  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int t = 0; t < GT; ++t) {
    m[t] = kNegInf;
    l[t] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[t][e] = 0.f;
  }

  for (long long t0 = s0; t0 < s1; t0 += TILE) {
    V kr[kNK], vr[kNK];
    bool ok[kNK];
#pragma unroll
    for (int u = 0; u < kNK; ++u) {
      const long long pos = t0 + u * G + gi;
      ok[u] = pos < s1;
      if (ok[u]) {
        kr[u] = *reinterpret_cast<const V*>(kb + pos * k_ss);
        vr[u] = *reinterpret_cast<const V*>(vb + pos * v_ss);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) kr[u].v[e] = vr[u].v[e] = from_f<T>(0.f);
      }
    }
    float s[GT][kNK];
#pragma unroll
    for (int t = 0; t < GT; ++t)
#pragma unroll
      for (int u = 0; u < kNK; ++u) {
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) d = __fmaf_rn(qv[t][e], to_f(kr[u].v[e]), d);
        // the LPK lanes of a group hold one row: xor offsets below LPK stay inside it
#pragma unroll
        for (int off = LPK / 2; off > 0; off >>= 1)
          d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, off));
        s[t][u] = d;
      }
#pragma unroll
    for (int t = 0; t < GT; ++t) {
      float mx = m[t];
#pragma unroll
      for (int u = 0; u < kNK; ++u) mx = ok[u] ? fmaxf(mx, s[t][u]) : mx;
      const float alpha = expf(__fsub_rn(m[t], mx));
      float p[kNK], psum = 0.f;
#pragma unroll
      for (int u = 0; u < kNK; ++u) {
        p[u] = ok[u] ? expf(__fsub_rn(s[t][u], mx)) : 0.f;
        psum = __fadd_rn(psum, p[u]);
      }
      l[t] = __fadd_rn(__fmul_rn(l[t], alpha), psum);
      m[t] = mx;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        float a = __fmul_rn(acc[t][e], alpha);
#pragma unroll
        for (int u = 0; u < kNK; ++u) a = __fmaf_rn(p[u], to_f(vr[u].v[e]), a);
        acc[t][e] = a;
      }
    }
  }

  // merge the block's lane groups, in group order
#pragma unroll
  for (int t = 0; t < GT; ++t) {
    if (sub == 0) {
      sm_m[gi][t] = m[t];
      sm_l[gi][t] = l[t];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[gi][t][sub * EPL + e] = acc[t][e];
  }
  __syncthreads();
  for (int idx = tid; idx < nh * HD; idx += kThreads) {
    const int t = idx / HD, d = idx % HD;
    float M = kNegInf;
    for (int g = 0; g < G; ++g) M = fmaxf(M, sm_m[g][t]);
    float L = 0.f, A = 0.f;
    for (int g = 0; g < G; ++g) {
      const float w = expf(__fsub_rn(sm_m[g][t], M));
      L = __fadd_rn(L, __fmul_rn(sm_l[g][t], w));
      A = __fadd_rn(A, __fmul_rn(sm_acc[g][t][d], w));
    }
    const int64_t row = ((int64_t)b * Hq + h0 + t) * n_split + split;
    part_acc[row * HD + d] = A;
    if (d == 0) {
      part_m[row] = M;
      part_l[row] = L;
    }
  }
}

// one block of kCombineThreads per (b, h): the splits' weights exp(m_i - M)
// first, then each warp sums l and the accumulators of the splits i = w, w +
// kCombineWarps, ... (lanes over hd), and the warps' sums are added in warp
// order; acc / max(l, 1e-30) rounded to T. Every sum in a fixed order.
constexpr int kCombineThreads = 256;
constexpr int kCombineWarps = kCombineThreads / 32;

template <typename T, int HD>
__global__ void __launch_bounds__(kCombineThreads) decode_combine_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, T* __restrict__ o, int n_split) {
  extern __shared__ float w[];  // [n_split] weights
  __shared__ float red[kCombineWarps][HD], red_l[kCombineWarps], m_red[kCombineWarps];
  const int64_t bh = blockIdx.x;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;

  float M = kNegInf;
  for (int i = tid; i < n_split; i += kCombineThreads) M = fmaxf(M, pm[i]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  if (lane == 0) m_red[warp] = M;
  __syncthreads();
  M = kNegInf;
  for (int j = 0; j < kCombineWarps; ++j) M = fmaxf(M, m_red[j]);  // a max: any order
  for (int i = tid; i < n_split; i += kCombineThreads) w[i] = expf(__fsub_rn(pm[i], M));
  __syncthreads();

  constexpr int DPL = (HD + 31) / 32;  // dims per lane
  float A[DPL], Lw = 0.f;
#pragma unroll
  for (int c = 0; c < DPL; ++c) A[c] = 0.f;
#pragma unroll 4
  for (int i = warp; i < n_split; i += kCombineWarps) {
    const float* row = part_acc + (bh * n_split + i) * HD;
    Lw = __fadd_rn(Lw, __fmul_rn(pl[i], w[i]));
#pragma unroll
    for (int c = 0; c < DPL; ++c)
      if (lane + 32 * c < HD) A[c] = __fadd_rn(A[c], __fmul_rn(row[lane + 32 * c], w[i]));
  }
#pragma unroll
  for (int c = 0; c < DPL; ++c)
    if (lane + 32 * c < HD) red[warp][lane + 32 * c] = A[c];
  if (lane == 0) red_l[warp] = Lw;
  __syncthreads();
  for (int d = tid; d < HD; d += kCombineThreads) {
    float L = 0.f, acc = 0.f;
    for (int j = 0; j < kCombineWarps; ++j) {
      L = __fadd_rn(L, red_l[j]);
      acc = __fadd_rn(acc, red[j][d]);
    }
    o[bh * HD + d] = from_f<T>(__fdiv_rn(acc, fmaxf(L, 1e-30f)));
  }
}

struct Args {
  const void *q, *k, *v, *kv_len;
  void *o, *part_m, *part_l, *part_acc;
  int B, Hq, Hkv, S;
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int has_window, window, n_split;
  float scale;
};

template <typename T, int HD, int GT>
int launch(const Args& a, cudaStream_t stream) {
  const int grp = a.Hq / a.Hkv;
  const dim3 grid(a.n_split, a.Hkv * ((grp + GT - 1) / GT), a.B);
  float* pm = static_cast<float*>(a.part_m);
  float* pl = static_cast<float*>(a.part_l);
  float* pa = static_cast<float*>(a.part_acc);
  decode_split_kernel<T, HD, GT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const int*>(a.kv_len), pm, pl, pa, a.Hq, a.Hkv, a.S, a.k_sb, a.k_sh, a.k_ss,
      a.v_sb, a.v_sh, a.v_ss, a.has_window, a.window, a.n_split, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  decode_combine_kernel<T, HD><<<a.B * a.Hq, kCombineThreads, a.n_split * sizeof(float), stream>>>(
      pm, pl, pa, static_cast<T*>(a.o), a.n_split);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int by_group(const Args& a, cudaStream_t stream) {
  const int grp = a.Hq / a.Hkv;
  if (grp == 1) return launch<T, HD, 1>(a, stream);
  if (grp == 2) return launch<T, HD, 2>(a, stream);
  return launch<T, HD, 4>(a, stream);
}

template <typename T>
int by_head_dim(const Args& a, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return by_group<T, 32>(a, stream);
    case 64: return by_group<T, 64>(a, stream);
    case 128: return by_group<T, 128>(a, stream);
    default: return by_group<T, 256>(a, stream);
  }
}

}  // namespace

extern "C" {

// q, o (B, Hq, hd) contiguous; k and v (B, Hkv, S, hd) with element strides
// (sb, sh, ss) and unit stride along hd, rows 16-byte aligned; kv_len (B,)
// int32 on the card; all of q, k, v, o bf16 when is_bf16, else f32. part_m,
// part_l (B, Hq, n_split) and part_acc (B, Hq, n_split, hd) f32 scratch. hd is
// 32, 64, 128 or 256. `window` is read only when has_window. Returns
// cudaGetLastError() after the two launches.
int flash_decode_fwd(const void* q, const void* k, const void* v, const void* kv_len, void* o,
                     void* part_m, void* part_l, void* part_acc, int B, int Hq, int Hkv, int S,
                     int hd, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss, int has_window, int window, int n_split,
                     float scale, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || n_split < 1 ||
      n_split > kMaxSplits ||
      (long long)Hkv * ((Hq / Hkv + 3) / 4) > 65535 ||
      (hd != 32 && hd != 64 && hd != 128 && hd != 256))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, kv_len, o, part_m, part_l, part_acc, B, Hq, Hkv, S, k_sb, k_sh, k_ss,
               v_sb, v_sh, v_ss, has_window, window, n_split, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) return by_head_dim<__nv_bfloat16>(a, hd, s);
  return by_head_dim<float>(a, hd, s);
}

}  // extern "C"
