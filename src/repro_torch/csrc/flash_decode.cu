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
// carries them in VMEM over its sequential kv axis; here m in units of log2). A row that sees no key
// gives 0. The output is rounded to q's dtype (round to nearest even).
//
// Bound: bytes. Each seen key and value row is read once per kv head (the
// bound counts no other bytes of the cache) and q and o once: at qwen3-1.7b's
// decode_32k layer (B 128, Hkv 8, S 32768, hd 128, bf16) 17.18 GB, 5.13 ms
// at 3.35 TB/s. The products are 2 * Hq / Hkv flops a cache byte, far under
// the 20 that f32 on the CUDA cores could keep up with.
//
// Design (redesigned for Hopper). The TPU grid is (B, Hq, S / 512) and
// re-reads each kv head's cache once per query head of its group. Here one
// block takes up to four query heads of one kv head (GT = 1, 2 or 4; a group
// of more than four heads is covered by several blocks, each reading the
// cache once) and a split of the keys the row sees: the seen range [lo, hi)
// of each row is cut on the card into n_split equal pieces, rounded to whole
// tiles, so a sliding window or a short kv_len spreads its few keys over as
// many blocks as a full cache, and keys no split owns are never read.
// n_split is chosen by the wrapper so that B * Hkv * n_split fills the card.
//   - Staging. One producer warp keeps a ring of NS >= 3 stages of K and V
//     tiles in shared memory full with TMA (cp.async.bulk.tensor over 4-d
//     tensor maps (hd, S, Hkv, B) of the caller's strides: the model's
//     (B, S, Hkv, hd) cache is read in place; completion on mbarriers). A
//     tile is at most 16 KB of K and 16 KB of V, and the ring ~64 KB or 3
//     stages, so two blocks on an SM keep 64-190 KB in flight whatever the
//     compute does: loads no longer wait on the dot products.
//   - Four consumer warps read the tiles from shared memory. A lane group of
//     LPK lanes holds one key row at a time, 16 bytes a lane (8 bf16 or 4 f32;
//     32 bytes at f32 hd 256), and takes KNK rows of each tile. Its GT x KNK
//     partial dot products are combined by a reduce-scatter over xor
//     shuffles (each step keeps half the values and sends the other half), so
//     that each lane ends with one whole score (key, head); where the group
//     has more lanes than scores, R = LPK / (GT x KNK) lanes share one.
//   - Each exponential once per (key, head): q is scaled by scale * log2(e)
//     in f32, so p = 2^(s - m) is one ex2.approx.ftz.f32 (the SFU's exp2,
//     relative error about 2^-22 (PTX ISA), far under the held tolerance)
//     by the lane that owns the score. The row maximum of a head is an xor
//     max over its KNK lanes; the lanes then gather the tile's p and the
//     heads' rescale factors with GT x KNK + GT indexed shuffles and update
//     their GT x EPL accumulators from the V rows in shared memory. Each lane
//     keeps l for its own slot; the slots of a head are summed at the end.
//   - At the end the block merges its groups in shared memory (log-sum-exp,
//     in group order; the ring's memory is reused) and writes the split's
//     (m, l, acc) to a scratch buffer; a second kernel merges the splits, one
//     block per (b, h) whose warps take the splits in turn, and divides.
//     Every sum is taken in a fixed order, so two launches give the same bits.
// GQA is index arithmetic: no copy of k or v per head. Each row's hd values
// must be contiguous and every stride and the base 16-byte aligned (TMA).
// kv_len is a (B,) int32 array on the card or, when that pointer is null, one
// value for every row passed as a kernel argument (no device copy per call).
#include "hopper.cuh"

namespace {

constexpr int kConsumers = 128;              // four consumer warps
constexpr int kThreads = kConsumers + 32;    // and one producer warp
constexpr float kNegInf = -1e30f;
constexpr int kMaxSplits = 8192;  // the merge keeps one weight per split in shared memory
constexpr int kTileBytes = 16384;  // at most this much of K (and of V) in one tile
constexpr int kRingBytes = 65536;  // the ring aims at this much, in 3 to 8 stages

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

constexpr int cmin(int a, int b) { return a < b ? a : b; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T, int HD, int GT>
struct Tiling {
  static constexpr int ROWB = HD * (int)sizeof(T);           // bytes of a row
  static constexpr int LPK = cmin(ROWB / 16, 32);             // lanes per key row
  static constexpr int EPL = HD / LPK;                        // elements of a row per lane
  static constexpr int G = kConsumers / LPK;                  // lane groups
  static constexpr int KNK = cmin(LPK / GT, kTileBytes / (G * ROWB));  // rows per group per tile
  static constexpr int P = GT * KNK;                          // scores per group per tile
  static constexpr int R = LPK / P;                           // lanes per score
  static constexpr int TILE = G * KNK;                        // rows per tile
  static constexpr int TILE_BYTES = TILE * ROWB;
  static constexpr int NS = cmin(8, cmax(3, kRingBytes / (2 * TILE_BYTES)));  // stages
  static constexpr size_t ring = (size_t)NS * 2 * TILE_BYTES;
  static constexpr size_t merge = (size_t)G * GT * (HD + 2) * 4;  // reuses the ring
  static constexpr size_t bars = ring > merge ? ring : merge;
  static constexpr size_t bytes = bars + 16 * NS + 128;  // + full/empty barriers, alignment
  static_assert(KNK >= 1 && P <= LPK && TILE <= 256 && bytes <= kMaxSmem, "decode tiling");
};

// one lane's EPL elements of a row, read in 16-byte pieces
template <typename T, int N>
struct alignas(16) Vec {
  T v[N];
};

// reduce-scatter of N values over the lanes that differ in bit O and below:
// at each step a lane keeps the half its bit selects and adds the partner's
// copy of it, so after log2(N) steps d[0] holds one whole sum
template <int N, int O>
struct Scatter {
  template <int P>
  __device__ __forceinline__ static void run(float (&d)[P], int sub) {
    const bool upper = (sub & O) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = upper ? d[i] : d[i + N / 2];
      const float keep = upper ? d[i + N / 2] : d[i];
      d[i] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, O));
    }
    Scatter<N / 2, O / 2>::run(d, sub);
  }
};
template <int O>
struct Scatter<1, O> {
  template <int P>
  __device__ __forceinline__ static void run(float (&)[P], int) {}
};

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(
    const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
    const T* __restrict__ q, const int* __restrict__ kv_len, int kv_len_all,
    float* __restrict__ part_m, float* __restrict__ part_l, float* __restrict__ part_acc, int Hq,
    int Hkv, int S, int has_window, int window, int n_split, float scale_log2) {
  using Tl = Tiling<T, HD, GT>;
  constexpr int LPK = Tl::LPK, EPL = Tl::EPL, G = Tl::G, KNK = Tl::KNK, P = Tl::P, R = Tl::R;
  constexpr int TILE = Tl::TILE, TB = Tl::TILE_BYTES, NS = Tl::NS, ROWB = Tl::ROWB;
  using V = Vec<T, EPL>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Tl::bars);
  uint64_t* empty = full + NS;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x, b = blockIdx.z;
  const int grp = Hq / Hkv, n_hc = (grp + GT - 1) / GT;
  const int hk = blockIdx.y / n_hc, hc = blockIdx.y % n_hc;
  const int h0 = hk * grp + hc * GT;          // first query head of this block
  const int nh = min(GT, grp - hc * GT);      // query heads of this block

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the keys this row sees, [lo, hi), and this split's share of them
  const long long kvl = kv_len ? kv_len[b] : kv_len_all;
  const long long hi = kvl < S ? kvl : S;
  long long lo = has_window ? kvl - window : 0;
  lo = lo > 0 ? lo : 0;
  const long long n = hi > lo ? hi - lo : 0;
  const long long chunk = ((n + n_split - 1) / n_split + TILE - 1) / TILE * TILE;
  const long long s0 = lo + split * chunk;
  const long long s1 = s0 + chunk < hi ? s0 + chunk : hi;
  const int n_tiles = s1 > s0 ? (int)((s1 - s0 + TILE - 1) / TILE) : 0;

  if (warp == kConsumers / 32) {  // the producer warp: one thread issues every copy
    if (lane == 0) {
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NS;
        mbar_wait(empty + s, ((i / NS) & 1) ^ 1);  // the first round passes at once
        mbar_expect_tx(full + s, 2 * TB);
        const int row = (int)(s0 + (long long)i * TILE);  // rows past S arrive as zeros
        tma_load(&tk, smem + (size_t)s * 2 * TB, full + s, 0, row, hk, b);
        tma_load(&tv, smem + (size_t)s * 2 * TB + TB, full + s, 0, row, hk, b);
      }
    }
    return;
  }

  const int gi = tid / LPK, sub = tid % LPK;
  float qv[GT][EPL];
  const T* qb = q + ((int64_t)b * Hq + h0) * HD + sub * EPL;
#pragma unroll
  for (int t = 0; t < GT; ++t)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qv[t][e] = t < nh ? __fmul_rn(to_f(qb[t * HD + e]), scale_log2) : 0.f;

  // this lane's score: head (sub / R) / KNK, row us of the group's KNK rows in a tile
  const int us = (sub / R) % KNK;
  float m = kNegInf, l = 0.f;  // its head's running max (log2 units); l of this lane's slot
  float acc[GT][EPL];
#pragma unroll
  for (int t = 0; t < GT; ++t)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[t][e] = 0.f;

  const int row0 = gi * KNK;  // the group's first row in a tile
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NS;
    mbar_wait(full + s, (i / NS) & 1);
    const uint8_t* kt = smem + (size_t)s * 2 * TB + sub * EPL * (int)sizeof(T);
    const uint8_t* vt = kt + TB;
    const long long t0 = s0 + (long long)i * TILE;
    const int valid = s1 - t0 < TILE ? (int)(s1 - t0) : TILE;  // rows of this split

    float d[P];
#pragma unroll
    for (int u = 0; u < KNK; ++u) {
      const V kr = *reinterpret_cast<const V*>(kt + (row0 + u) * ROWB);
      float kf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) kf[e] = to_f(kr.v[e]);
#pragma unroll
      for (int t = 0; t < GT; ++t) {
        float dd = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) dd = __fmaf_rn(qv[t][e], kf[e], dd);
        d[t * KNK + u] = dd;
      }
    }
    Scatter<P, LPK / 2>::run(d, sub);
    float sc = d[0];
#pragma unroll
    for (int o = R / 2; o > 0; o >>= 1) sc = __fadd_rn(sc, __shfl_xor_sync(0xffffffffu, sc, o));
    // a key outside the split (a row past kv_len, S or the next split's
    // start) scores -inf: no part in the max, p = 0
    sc = row0 + us < valid ? sc : neg_inf();
    float mx = sc;
#pragma unroll
    for (int o = KNK * R / 2; o >= R; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_new = fmaxf(m, mx);
    const float alpha = ex2(__fsub_rn(m, m_new));
    const float p = ex2(__fsub_rn(sc, m_new));
    l = __fadd_rn(__fmul_rn(l, alpha), p);
    m = m_new;

    float pg[P], al[GT];
#pragma unroll
    for (int j = 0; j < P; ++j) pg[j] = __shfl_sync(0xffffffffu, p, j * R, LPK);
#pragma unroll
    for (int t = 0; t < GT; ++t) al[t] = __shfl_sync(0xffffffffu, alpha, t * KNK * R, LPK);
#pragma unroll
    for (int t = 0; t < GT; ++t)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[t][e] = __fmul_rn(acc[t][e], al[t]);
#pragma unroll
    for (int u = 0; u < KNK; ++u) {
      if (row0 + u < valid) {  // a row outside the split may hold anything, even NaN
        const V vr = *reinterpret_cast<const V*>(vt + (row0 + u) * ROWB);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float vf = to_f(vr.v[e]);
#pragma unroll
          for (int t = 0; t < GT; ++t) acc[t][e] = __fmaf_rn(pg[t * KNK + u], vf, acc[t][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);
  }

  // each head's l: the sum of its slots (one lane of every R), in a fixed order
  float lt = sub % R == 0 ? l : 0.f;
#pragma unroll
  for (int o = KNK * R / 2; o > 0; o >>= 1) lt = __fadd_rn(lt, __shfl_xor_sync(0xffffffffu, lt, o));
  float mt[GT], ltt[GT];
#pragma unroll
  for (int t = 0; t < GT; ++t) {
    mt[t] = __shfl_sync(0xffffffffu, m, t * KNK * R, LPK);
    ltt[t] = __shfl_sync(0xffffffffu, lt, t * KNK * R, LPK);
  }

  // merge the block's lane groups, in group order, in the ring's memory
  bar_sync(1, kConsumers);  // every consumer is done with the ring
  float* sm_m = reinterpret_cast<float*>(smem);  // [G][GT]
  float* sm_l = sm_m + G * GT;                   // [G][GT]
  float* sm_acc = sm_l + G * GT;                 // [G][GT][HD]
#pragma unroll
  for (int t = 0; t < GT; ++t) {
    if (sub == 0) {
      sm_m[gi * GT + t] = mt[t];
      sm_l[gi * GT + t] = ltt[t];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[(gi * GT + t) * HD + sub * EPL + e] = acc[t][e];
  }
  bar_sync(1, kConsumers);
  for (int idx = tid; idx < nh * HD; idx += kConsumers) {
    const int t = idx / HD, dd = idx % HD;
    float M = kNegInf;
    for (int g = 0; g < G; ++g) M = fmaxf(M, sm_m[g * GT + t]);
    float L = 0.f, A = 0.f;
    for (int g = 0; g < G; ++g) {
      const float w = exp2f(__fsub_rn(sm_m[g * GT + t], M));
      L = __fadd_rn(L, __fmul_rn(sm_l[g * GT + t], w));
      A = __fadd_rn(A, __fmul_rn(sm_acc[(g * GT + t) * HD + dd], w));
    }
    const int64_t row = ((int64_t)b * Hq + h0 + t) * n_split + split;
    part_acc[row * HD + dd] = A;
    if (dd == 0) {
      part_m[row] = M;
      part_l[row] = L;
    }
  }
}

// one block of kCombineThreads per (b, h): the splits' weights 2^(m_i - M)
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
  for (int i = tid; i < n_split; i += kCombineThreads) w[i] = exp2f(__fsub_rn(pm[i], M));
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
  int kv_len_all, has_window, window, n_split;
  float scale_log2;
};

// the split kernel's shared-memory limit, raised once per device
template <typename T, int HD, int GT>
int set_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(decode_split_kernel<T, HD, GT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Tiling<T, HD, GT>::bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return (int)err;
}

template <typename T, int HD, int GT>
int launch(const Args& a, cudaStream_t stream) {
  using Tl = Tiling<T, HD, GT>;
  const CUtensorMapDataType type =
      sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)a.S, (cuuint64_t)a.Hkv,
                              (cuuint64_t)a.B};
  const cuuint64_t ks[3] = {(cuuint64_t)a.k_ss * sizeof(T), (cuuint64_t)a.k_sh * sizeof(T),
                            (cuuint64_t)a.k_sb * sizeof(T)};
  const cuuint64_t vs[3] = {(cuuint64_t)a.v_ss * sizeof(T), (cuuint64_t)a.v_sh * sizeof(T),
                            (cuuint64_t)a.v_sb * sizeof(T)};
  CUtensorMap tk, tv;
  int err = make_map_4d(&tk, type, a.k, dims, ks, HD, Tl::TILE, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err) err = make_map_4d(&tv, type, a.v, dims, vs, HD, Tl::TILE, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (!err) err = set_smem<T, HD, GT>();
  if (err) return err;
  const int grp = a.Hq / a.Hkv;
  const dim3 grid(a.n_split, a.Hkv * ((grp + GT - 1) / GT), a.B);
  float* pm = static_cast<float*>(a.part_m);
  float* pl = static_cast<float*>(a.part_l);
  float* pa = static_cast<float*>(a.part_acc);
  decode_split_kernel<T, HD, GT><<<grid, kThreads, Tl::bytes, stream>>>(
      tk, tv, static_cast<const T*>(a.q), static_cast<const int*>(a.kv_len), a.kv_len_all, pm,
      pl, pa, a.Hq, a.Hkv, a.S, a.has_window, a.window, a.n_split, a.scale_log2);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T, HD><<<a.B * a.Hq, kCombineThreads, a.n_split * sizeof(float), stream>>>(
      pm, pl, pa, static_cast<T*>(a.o), a.n_split);
  return (int)cudaGetLastError();
}

// F(T, HD, GT) for the head dim and group size given
template <typename T, typename F>
int dispatch(int hd, int grp, F f) {
  const int gt = grp == 1 ? 1 : grp == 2 ? 2 : 4;
#define REPRO_DECODE_GT(HD)                                                \
  return gt == 1 ? f.template operator()<T, HD, 1>()                       \
                 : gt == 2 ? f.template operator()<T, HD, 2>()             \
                           : f.template operator()<T, HD, 4>()
  switch (hd) {
    case 32: REPRO_DECODE_GT(32);
    case 64: REPRO_DECODE_GT(64);
    case 128: REPRO_DECODE_GT(128);
    default: REPRO_DECODE_GT(256);
  }
#undef REPRO_DECODE_GT
}

struct Launch {
  const Args& a;
  cudaStream_t stream;
  template <typename T, int HD, int GT>
  int operator()() const { return launch<T, HD, GT>(a, stream); }
};

}  // namespace

extern "C" {

// q, o (B, Hq, hd) contiguous; k and v (B, Hkv, S, hd) with element strides
// (sb, sh, ss) and unit stride along hd, the base and every stride 16-byte
// aligned; kv_len (B,) int32 on the card, or null: then kv_len_all is every
// row's; all of q, k, v, o bf16 when is_bf16, else f32. part_m, part_l
// (B, Hq, n_split) and part_acc (B, Hq, n_split, hd) f32 scratch. hd is 32,
// 64, 128 or 256. `window` is read only when has_window. scale_log2 is
// 1/sqrt(hd) * log2(e) in f32. Returns cudaGetLastError() after the two
// launches, or 1000 when the driver has no cuTensorMapEncodeTiled, 1001 +
// CUresult when it refuses a tensor map.
int flash_decode_fwd(const void* q, const void* k, const void* v, const void* kv_len, void* o,
                     void* part_m, void* part_l, void* part_acc, int B, int Hq, int Hkv, int S,
                     int hd, long long k_sb, long long k_sh, long long k_ss, long long v_sb,
                     long long v_sh, long long v_ss, int kv_len_all, int has_window, int window,
                     int n_split, float scale_log2, int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || n_split < 1 ||
      n_split > kMaxSplits || (long long)Hkv * ((Hq / Hkv + 3) / 4) > 65535 ||
      (hd != 32 && hd != 64 && hd != 128 && hd != 256))
    return (int)cudaErrorInvalidValue;
  const Args a{q,    k,    v,    kv_len, o,    part_m,     part_l,     part_acc, B,
               Hq,   Hkv,  S,    k_sb,   k_sh, k_ss,       v_sb,       v_sh,     v_ss,
               kv_len_all, has_window, window, n_split, scale_log2};
  const Launch f{a, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? dispatch<__nv_bfloat16>(hd, Hq / Hkv, f) : dispatch<float>(hd, Hq / Hkv, f);
}

}  // extern "C"
