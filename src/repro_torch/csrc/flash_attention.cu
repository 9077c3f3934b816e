// Flash attention forward for Hopper (sm_90a). Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention_fwd (_flash_kernel).
// Below it, the causal ALiBi training pair, which replaces no TPU kernel (the
// reference trains its ALiBi models on plain einsums): the bf16 forward with
// the ALiBi term and a log-sum-exp output, and its backward (see there).
//
// For each (b, h) with kv head h / (Hq / Hkv), with scale = 1/sqrt(hd):
//
//   s[i][j] = scale * (q[i] . k[j]),  masked to -1e30 where the key is not seen
//   o[i]    = sum_j p[i][j] v[j] / max(l[i], 1e-30),
//   p[i][j] = exp(s[i][j] - m[i]) where seen, else 0;  l[i] = sum_j p[i][j]
//
// with an online softmax over key tiles (m and l carried as the TPU kernel
// carries them in VMEM scratch). A key j is seen by query i (absolute position
// q_offset + i) when j < Sk, j <= q_offset + i under `causal`, and
// q_offset + i - j < window under a window. A row that sees no key gives 0.
// The output is rounded to q's dtype (round to nearest even). q, k, v and o
// are read and written through their (b, h, s) strides, so the model's
// (B, S, H, hd) layout is used in place; the hd axis is contiguous.
//
// Bound: operations. 4 * B * Hq * (seen pairs) * hd flops for the two products
// (46.08 GFLOP at whisper-large-v3's encoder layer, B 4, H 20, S 1500, hd 64)
// against 61.44 MB of q, k, v and o in bf16: 750 flops per byte.
//
// bf16 inputs: the tensor-core kernel (flash_fwd_bf16). Bound 0.047 ms at the
// encoder layer on the bf16 tensor cores (989 TFLOP/s); the hi/lo split of P
// below makes the tensor-core work 57.6 GFLOP (0.058 ms).
//   - A block owns 64 queries of one (b, h): one consumer warpgroup and one
//     producer warp, two blocks per SM at hd 64 (1,920 blocks at the encoder
//     layer). Two consumer warpgroups per block (128 queries, taking turns to
//     issue their products) were measured no faster, and went (PERF.md).
//   - The producer loads the q tile once and keeps a ring of kNS stages of
//     64-key K and V tiles full with TMA (cp.async.bulk.tensor, 128-byte
//     swizzle, completion on mbarriers; K and V each have their own full and
//     free barriers, so the next K lands while this V is read). The tensor
//     maps are 4-d (hd, S, H, B) over the caller's strides; TMA fills rows
//     past Sq or Sk with zeros, and those keys are masked out of the softmax
//     (a zero key would score 0 and take weight).
//   - S = Q.K^T runs as wgmma.mma_async m64n64k16 on bf16 from shared memory
//     (both operands K-major), f32 accumulators. Products of bf16 values are
//     exact in f32; only the order of the sums differs from the reference.
//     scale * log2(e) is applied to the f32 scores after the product, so each
//     exponential is ex2.approx of one fused multiply-add.
//   - Tile i's S is issued ahead of tile i-1's P.V, so that tile i's softmax
//     can run while that P.V is on the tensor cores.
//   - The softmax works on the accumulator fragment in registers: each thread
//     holds two rows; row maxima over a quad with two shuffles; the row sums
//     stay per thread until the epilogue. Masks (causal, window, q_offset, the
//     ragged last tile) are applied only on tiles that need them; tiles that
//     no query of the block can see are not loaded.
//   - O += P.V takes P from registers as wgmma's A operand (the accumulator
//     layout of S is the A-fragment layout), split as hi = bf16(p) and
//     lo = bf16(p - hi): rounding p to bf16 once would break the held
//     tolerance (one bf16 ulp of the f32 result) 20-68 times over. Both halves
//     multiply the same V tile, read from shared memory as an MN-major B
//     operand, into one f32 accumulator. The epilogue divides by
//     max(l, 1e-30), rounds to bf16 and stores through o's strides.
//
// f32 inputs: the CUDA-core kernel (flash_fwd_f32), as first written but for
// the strides (and a register cap keeping three blocks per SM at hd 64). Its
// tolerance, 1e-5 * max|y| with no relative part, is beyond TF32 products.
// Bound 0.688 ms at the encoder shape on the CUDA cores (67 TFLOP/s). One
// block per 64 queries of one (b, h); q (scaled by 1/sqrt(hd) before the
// product, transposed), k (transposed), v and the tile's p (transposed) are
// staged in shared memory as f32; 256 threads form a 16 x 16 grid, thread
// (ti, tj) computing 4 x 4 scores as outer products of float4 rows with
// explicit fused multiply-adds (the library is built with --fmad=false).
//
// Where the bf16 kernel's time goes (PERF.md): removing the exponentials, the
// split of P or the K/V loads from it leaves its time as it is; removing the
// P.V products, or Q.K^T, shortens it. ptxas moves the wait for P.V up into
// the softmax (the SASS shows it), and a version that kept the two apart
// (double-buffered P fragments) was no faster: each SM sub-partition holds
// two consumer warps, too few to hide the softmax's dependency chains and the
// per-tile waits. Later work: more warps or more independent work per
// sub-partition (128-key tiles at lower register cost, three blocks per SM),
// a persistent grid, a TMA store of o.
#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // queries per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kPad = 4;        // row padding of the shared tiles, in floats (float4-aligned)

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

// (b, h, s) strides of q, k, v and o, in elements
struct Strides {
  int64_t qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os;
};

template <int HD>
__global__ void __launch_bounds__(kThreads, HD == 64 ? 3 : 2) flash_fwd_f32(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ o, Strides st, int Hq, int Hkv, int Sq, int Sk, int causal,
    int has_window, int window, int q_offset, float scale) {
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
  const float* qb = q + b * st.qb + h * st.qh;
  const float* kb = k + b * st.kb + hk * st.kh;
  const float* vb = v + b * st.vb + hk * st.vh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    const float x = q0 + i < Sq ? qb[(int64_t)(q0 + i) * st.qs + d] : 0.f;
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
      Kt[d * LK + j] = in ? kb[(k0 + j) * st.ks + d] : 0.f;
      Vs[j * LD + d] = in ? vb[(k0 + j) * st.vs + d] : 0.f;
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
    float* orow = o + b * st.ob + h * st.oh + (int64_t)i * st.os + DPT * tj;
#pragma unroll
    for (int c = 0; c < DPT; ++c) orow[c] = __fdiv_rn(acc[r][c], denom);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, const Strides& st, int B,
               int Hq, int Hkv, int Sq, int Sk, int causal, int has_window, int window,
               int q_offset, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<HD>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_f32<HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st, Hq, Hkv, Sq, Sk, causal, has_window, window, q_offset, scale);
  return (int)cudaGetLastError();
}

static_assert(smem_floats<128>() * sizeof(float) <= kMaxSmem,
              "hd = 128 tiles exceed shared memory");

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 64;  // query rows per consumer warpgroup
constexpr int kKeys = 64;  // keys per k/v tile
constexpr int kNS = 3;     // k/v stages in the ring
constexpr int kRowB = 128; // bytes of one swizzled row: 64 bf16 (a column block)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// shared memory of one block: the q tile, then kNS k tiles and kNS v tiles of
// kKeys keys, each [HD / 64 column blocks][rows][64] bf16 in 128-byte-swizzled
// rows, then the mbarriers
template <int HD>
struct Layout {
  static constexpr size_t q_bytes = (size_t)kTile * HD * 2;
  static constexpr size_t kv_bytes = (size_t)kKeys * HD * 2;
  static constexpr size_t k_at = q_bytes;
  static constexpr size_t v_at = k_at + kNS * kv_bytes;
  static constexpr size_t bar_at = v_at + kNS * kv_bytes;
  static constexpr int n_bars = 1 + 4 * kNS;  // q_full, k_full[], v_full[], k_free[], v_free[]
  static constexpr size_t bytes = bar_at + 8 * n_bars + 1024;  // + alignment slack
};

// scale, mask and exponentiate one tile's scores in place (sc: the S
// accumulator of rows qp0 and qp0 + 8, keys k0 + 8 j + 2 tq4 + {0, 1}), carry
// the row maxima m (log2 units) and the row sums l, return the factors alpha
// by which the tile rescales the rows' earlier sums
template <bool ALIBI>
__device__ __forceinline__ void softmax_tile(float (&sc)[kKeys / 2], bool mask, long long k0,
                                             long long qp0, int tq4, int Sk, int causal,
                                             int has_window, int window, float scale_log2,
                                             float slope_log2, float& m0, float& m1, float& l0,
                                             float& l1, float& a0, float& a1) {
  const long long qp1 = qp0 + 8;
  if constexpr (ALIBI) {
    // the biased score in log2 units, scale * log2(e) * s - slope * log2(e) * (i - j),
    // folded into the multiply-add that scales s; the row maxima are then taken over it.
    // slope * (i - j) is the row's slope * (i - k0 - 2 tq4) less slope times the key's
    // offset in the thread's columns, a constant: one more multiply-add, and no index
    // arithmetic on unmasked tiles (the kernel is launched causal: no seen key lies
    // past its row)
    const float rb0 = __fmul_rn(slope_log2, (float)(qp0 - k0 - 2 * tq4));
    const float rb1 = __fmul_rn(slope_log2, (float)(qp1 - k0 - 2 * tq4));
#pragma unroll
    for (int r = 0; r < kKeys / 2; ++r) {
      const float off = (float)(8 * (r / 4) + (r & 1));
      sc[r] = __fmaf_rn(sc[r], scale_log2, -__fmaf_rn(-slope_log2, off, (r & 2) ? rb1 : rb0));
    }
    if (mask) {
#pragma unroll
      for (int r = 0; r < kKeys / 2; ++r) {
        const long long kp = k0 + 8 * (r / 4) + 2 * tq4 + (r & 1);
        const long long qp = (r & 2) ? qp1 : qp0;
        const bool seen = kp < Sk && (!causal || kp <= qp) && (!has_window || qp - kp < window);
        sc[r] = seen ? sc[r] : neg_inf();
      }
    }
  } else if (mask) {
#pragma unroll
    for (int r = 0; r < kKeys / 2; ++r) {
      const long long kp = k0 + 8 * (r / 4) + 2 * tq4 + (r & 1);
      const long long qp = (r & 2) ? qp1 : qp0;
      const bool seen = kp < Sk && (!causal || kp <= qp) && (!has_window || qp - kp < window);
      sc[r] = seen ? sc[r] : neg_inf();
    }
  }
  float mx0 = neg_inf(), mx1 = neg_inf();
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
  }
  // a masked score is -inf: exp2 gives 0 while m stays finite (-1e30 at most)
  const float n0 = fmaxf(m0, ALIBI ? mx0 : __fmul_rn(mx0, scale_log2));
  const float n1 = fmaxf(m1, ALIBI ? mx1 : __fmul_rn(mx1, scale_log2));
  a0 = ex2(__fsub_rn(m0, n0));
  a1 = ex2(__fsub_rn(m1, n1));
  m0 = n0;
  m1 = n1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < kKeys / 8; ++j) {
    if constexpr (ALIBI) {
      sc[4 * j] = ex2(__fsub_rn(sc[4 * j], n0));
      sc[4 * j + 1] = ex2(__fsub_rn(sc[4 * j + 1], n0));
      sc[4 * j + 2] = ex2(__fsub_rn(sc[4 * j + 2], n1));
      sc[4 * j + 3] = ex2(__fsub_rn(sc[4 * j + 3], n1));
    } else {
      sc[4 * j] = ex2(__fmaf_rn(sc[4 * j], scale_log2, -n0));
      sc[4 * j + 1] = ex2(__fmaf_rn(sc[4 * j + 1], scale_log2, -n0));
      sc[4 * j + 2] = ex2(__fmaf_rn(sc[4 * j + 2], scale_log2, -n1));
      sc[4 * j + 3] = ex2(__fmaf_rn(sc[4 * j + 3], scale_log2, -n1));
    }
    sum0 = __fadd_rn(sum0, __fadd_rn(sc[4 * j], sc[4 * j + 1]));
    sum1 = __fadd_rn(sum1, __fadd_rn(sc[4 * j + 2], sc[4 * j + 3]));
  }
  l0 = __fadd_rn(__fmul_rn(l0, a0), sum0);
  l1 = __fadd_rn(__fmul_rn(l1, a1), sum1);
}

// p as wgmma's A fragments, one per 16 keys (the S accumulator's layout is
// the A-fragment layout): hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_p(const float (&p)[kKeys / 2],
                                        uint32_t (&hi)[kKeys / 16][4],
                                        uint32_t (&lo)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = p[8 * kk + 2 * e], y = p[8 * kk + 2 * e + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      hi[kk][e] = pack_bf16(h);
      lo[kk][e] = pack_bf16(
          __floats2bfloat162_rn(__fsub_rn(x, __low2float(h)), __fsub_rn(y, __high2float(h))));
    }
}

// 128 consumer threads and one producer warp; at most 200 registers a thread
// keeps two blocks on an SM at hd 64 (hd 128 needs more and gets one)
constexpr int kThreadsBf16 = 128 + 32;
constexpr int kRegs = 200;

// ALIBI: add the head's ALiBi term (slopes[h]) to every score, and take the
// query tiles last to first across the grid's y axis (heads on x), so that
// the causal grid starts its longest blocks first; it is launched causal. LSE: write each row's
// log-sum-exp (natural log, f32) to lse[(b * Hq + h) * lse_len + row] for
// every row of the block, the padding rows past Sq included, and the bf16
// residual of o, bf16(o_f32 - bf16(o_f32)), to o_lo through o's strides.
template <int HD, bool ALIBI, bool LSE>
__global__ void __maxnreg__(kRegs) flash_fwd_bf16(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o, int64_t osb,
    int64_t osh, int64_t oss, int Hq, int Hkv, int Sq, int Sk, int causal, int has_window,
    int window, int q_offset, float scale_log2, const float* __restrict__ slopes,
    float* __restrict__ lse, int lse_len, __nv_bfloat16* __restrict__ o_lo) {
  using L = Layout<HD>;
  constexpr int CB = HD / 64, NK = kKeys;
  static_assert(NK == 64, "one m64n64k16 wgmma per 16 dims covers a key tile");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar_at);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + kNS;
  uint64_t* k_free = bars + 1 + 2 * kNS;
  uint64_t* v_free = bars + 1 + 3 * kNS;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = (ALIBI ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.x) * kTile;
  const int h = ALIBI ? blockIdx.x : blockIdx.y, b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const float slope_log2 = ALIBI ? __fmul_rn(slopes[h], kLog2e) : 0.f;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kNS; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_free + s, 4);  // lane 0 of every consumer warp
      mbar_init(v_free + s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // the key tiles some query of this block may see: NK-aligned from kbeg, below kend
  const long long qlo = (long long)q_offset + q0;
  const long long qhi = (long long)q_offset + min(Sq, q0 + kTile) - 1;
  long long kend = Sk, kbeg = 0;
  if (causal) kend = kend < qhi + 1 ? kend : qhi + 1;
  if (has_window) kbeg = qlo - window + 1 > 0 ? qlo - window + 1 : 0;
  kbeg = kbeg / NK * NK;
  const int n_tiles = kend > kbeg ? (int)((kend - kbeg + NK - 1) / NK) : 0;
  auto stage = [](int i) { return i % kNS; };
  auto parity = [](int i) { return (uint32_t)((i / kNS) & 1); };

  if (warp == 4) {  // the producer warp: one thread issues every copy
    if (lane == 0) {
      mbar_expect_tx(q_full, (uint32_t)L::q_bytes);
      for (int cb = 0; cb < CB; ++cb)
        tma_load(&tq, smem + (size_t)cb * kTile * kRowB, q_full, cb * 64, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int k0 = (int)kbeg + i * NK;
        const uint32_t free_parity = parity(i) ^ 1;  // the first round passes at once
        uint8_t* kt = smem + L::k_at + stage(i) * L::kv_bytes;
        uint8_t* vt = smem + L::v_at + stage(i) * L::kv_bytes;
        mbar_wait(k_free + stage(i), free_parity);
        mbar_expect_tx(k_full + stage(i), (uint32_t)L::kv_bytes);
        for (int cb = 0; cb < CB; ++cb)
          tma_load(&tk, kt + cb * NK * kRowB, k_full + stage(i), cb * 64, k0, hk, b);
        mbar_wait(v_free + stage(i), free_parity);
        mbar_expect_tx(v_full + stage(i), (uint32_t)L::kv_bytes);
        for (int cb = 0; cb < CB; ++cb)
          tma_load(&tv, vt + cb * NK * kRowB, v_full + stage(i), cb * 64, k0, hk, b);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread holds rows qp0 and qp0 + 8
  const int w = warp, g = lane / 4, tq4 = lane % 4;
  const long long qp0 = qlo + 16 * w + g;
  const uint32_t q_addr = smem_u32(smem);
  float acc[CB][32];
  float sc[NK / 2];  // S, then p in place
  uint32_t p_hi[NK / 16][4], p_lo[NK / 16][4];
  auto issue_s = [&](int i) {  // S = Q . K_i^T
    const uint32_t k_addr = smem_u32(smem + L::k_at + stage(i) * L::kv_bytes);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;  // 16 dims = 32 bytes into the swizzled row
      wgmma_ss(sc, sw128_desc(q_addr + (kk / 4) * kTile * kRowB + off),
               sw128_desc(k_addr + (kk / 4) * NK * kRowB + off), kk > 0);
    }
  };
  auto issue_pv = [&](int i) {  // O += (hi + lo) . V_i
    const uint32_t v_addr = smem_u32(smem + L::v_at + stage(i) * L::kv_bytes);
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const uint64_t dv = sw128_desc(v_addr + cb * NK * kRowB + kk * 16 * kRowB);
        wgmma_rs(acc[cb], p_hi[kk], dv);
        wgmma_rs(acc[cb], p_lo[kk], dv);
      }
  };
  auto fence_pv = [&] {  // after the wait for a P.V: acc is written, p may be reused
#pragma unroll
    for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk) {
      fence_regs(p_hi[kk]);
      fence_regs(p_lo[kk]);
    }
  };
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // m in units of log2, scaled
  auto softmax = [&](int i, float& a0, float& a1) {  // tile i's p, in place in sc
    const long long k0 = kbeg + (long long)i * NK;
    const bool mask =
        k0 + NK > Sk || (causal && k0 + NK - 1 > qlo) || (has_window && qhi - k0 >= window);
    softmax_tile<ALIBI>(sc, mask, k0, qp0, tq4, Sk, causal, has_window, window, scale_log2,
                        slope_log2, m0, m1, l0, l1, a0, a1);
  };

#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[cb][r] = 0.f;
  mbar_wait(q_full, 0);
  if (n_tiles > 0) {
    // tile 0: S, then its p
    float a0, a1;
    mbar_wait(k_full + stage(0), parity(0));
    wgmma_fence();
    issue_s(0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    if (lane == 0) mbar_arrive(k_free + stage(0));
    softmax(0, a0, a1);
    split_p(sc, p_hi, p_lo);
    // each further tile's S runs on the tensor cores ahead of the previous
    // tile's P.V, and its softmax while that P.V runs
    for (int i = 1; i < n_tiles; ++i) {
      mbar_wait(k_full + stage(i), parity(i));
      mbar_wait(v_full + stage(i - 1), parity(i - 1));
      wgmma_fence();
      issue_s(i);
      wgmma_commit();
      issue_pv(i - 1);
      wgmma_commit();
      wgmma_wait<1>();  // S of tile i
      fence_regs(sc);
      if (lane == 0) mbar_arrive(k_free + stage(i));
      softmax(i, a0, a1);
      wgmma_wait<0>();  // P.V of tile i - 1
      fence_pv();
      if (lane == 0) mbar_arrive(v_free + stage(i - 1));
#pragma unroll
      for (int cb = 0; cb < CB; ++cb)
#pragma unroll
        for (int r = 0; r < 32; ++r) acc[cb][r] = __fmul_rn(acc[cb][r], (r & 2) ? a1 : a0);
      split_p(sc, p_hi, p_lo);
    }
    mbar_wait(v_full + stage(n_tiles - 1), parity(n_tiles - 1));
    wgmma_fence();
    issue_pv(n_tiles - 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_pv();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 = __fadd_rn(l0, __shfl_xor_sync(0xffffffffu, l0, off));
    l1 = __fadd_rn(l1, __shfl_xor_sync(0xffffffffu, l1, off));
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  const int row0 = q0 + 16 * w + g, row1 = row0 + 8;
  __nv_bfloat16* ob = o + b * osb + h * osh;
  if constexpr (LSE) {
    if (tq4 == 0) {
      float* lb = lse + ((int64_t)b * Hq + h) * lse_len;
      lb[row0] = __fmul_rn(__fadd_rn(m0, log2f(l0)), kLn2);
      lb[row1] = __fmul_rn(__fadd_rn(m1, log2f(l1)), kLn2);
    }
    // o rounded to bf16, and in o_lo (o's strides) what that rounding left
    // out, so that the backward reads o to about 16 bits
    __nv_bfloat16* lo = o_lo + b * osb + h * osh;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + 8 * j + 2 * tq4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = half ? row1 : row0;
          const float d = half ? d1 : d0;
          if (row >= Sq) continue;
          const float x = __fdiv_rn(acc[cb][4 * j + 2 * half], d);
          const float y = __fdiv_rn(acc[cb][4 * j + 2 * half + 1], d);
          const __nv_bfloat162 hi = __floats2bfloat162_rn(x, y);
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row * oss + col) = hi;
          *reinterpret_cast<__nv_bfloat162*>(lo + (int64_t)row * oss + col) =
              __floats2bfloat162_rn(__fsub_rn(x, __low2float(hi)), __fsub_rn(y, __high2float(hi)));
        }
      }
  } else {
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cb * 64 + 8 * j + 2 * tq4;
        if (row0 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row0 * oss + col) =
              __floats2bfloat162_rn(__fdiv_rn(acc[cb][4 * j], d0),
                                    __fdiv_rn(acc[cb][4 * j + 1], d0));
        if (row1 < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)row1 * oss + col) =
              __floats2bfloat162_rn(__fdiv_rn(acc[cb][4 * j + 2], d1),
                                    __fdiv_rn(acc[cb][4 * j + 3], d1));
      }
  }
}

// a 4-d map (hd, S, H, B) of bf16 with (s, h, b) strides in elements, boxes of
// 64 x rows, 128-byte swizzle, zeros past each extent
int make_map(CUtensorMap* map, const void* base, int hd, int S, int H, int B, int64_t ss,
             int64_t sh, int64_t sb, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, 64,
                     (uint32_t)rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int HD, bool ALIBI = false, bool LSE = false>
int launch_bf16(const void* q, const void* k, const void* v, void* o, const Strides& st, int B,
                int Hq, int Hkv, int Sq, int Sk, int causal, int has_window, int window,
                int q_offset, float scale, cudaStream_t stream, const float* slopes = nullptr,
                float* lse = nullptr, void* o_lo = nullptr) {
  using L = Layout<HD>;
  static_assert(L::bytes <= kMaxSmem, "tiles exceed shared memory");
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, HD, Sq, Hq, B, st.qs, st.qh, st.qb, kTile);
  if (!err) err = make_map(&tk, k, HD, Sk, Hkv, B, st.ks, st.kh, st.kb, kKeys);
  if (!err) err = make_map(&tv, v, HD, Sk, Hkv, B, st.vs, st.vh, st.vb, kKeys);
  if (err) return err;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_bf16<HD, ALIBI, LSE>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (Sq + kTile - 1) / kTile;
  const dim3 grid = ALIBI ? dim3(Hq, n_q, B) : dim3(n_q, Hq, B);
  flash_fwd_bf16<HD, ALIBI, LSE><<<grid, kThreadsBf16, L::bytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st.ob, st.oh, st.os, Hq, Hkv, Sq, Sk, causal,
      has_window, window, q_offset, scale * kLog2e, slopes, lse, n_q * kTile,
      static_cast<__nv_bfloat16*>(o_lo));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Causal ALiBi training attention: the forward above as flash_fwd_bf16<HD,
// true, true>, and this backward. Self-attention, Sq = Sk = S, q_offset 0, no
// window, bf16 in and out, f32 accumulation. With L the forward's
// log-sum-exp, D[i] = sum_d dO[i][d] * O[i][d] and, for j <= i,
//
//   P[i][j]  = exp(scale * q[i].k[j] - slope * (i - j) - L[i])   (recomputed)
//   dP[i][j] = dO[i] . v[j],   dS[i][j] = P[i][j] * (dP[i][j] - D[i])
//   dq[i] = scale * sum_j dS[i][j] k[j],  dk[j] = scale * sum_i dS[i][j] q[i],
//   dv[j] = sum_i P[i][j] dO[i]
//
// with the sums over the query heads of a kv head for dk and dv (GQA). Two
// launches, each writing its outputs once, so nothing is summed with atomics
// and a second call gives the same bits:
//   - flash_bwd_dq: one block per 64-query tile of one (b, h), its key tiles
//     from the first to the diagonal. It first writes D for its rows (read
//     from o + o_lo and dO), then per key tile runs S = Q.K^T and dP =
//     dO.V^T as wgmma from shared memory, forms P and dS in registers and adds dS.K
//     with dS as wgmma's register A operand. The next tile's two products are
//     issued while this tile's dS.K runs.
//   - flash_bwd_dkdv: one block per 64-key tile of one (b, kv head), its
//     query tiles from the diagonal to the last, for each query head of the
//     group. It holds K and V in shared memory and runs S^T = K.Q^T and
//     dP^T = V.dO^T, then dV += P^T.dO and dK += dS^T.Q from registers. A ring
//     of kNSB stages brings each query tile's Q, dO (TMA) and its L and D
//     (bulk copies).
// P and dS enter the tensor cores rounded once to bf16, as the bf16 einsums
// of the plain path do; the softmax statistics and every sum stay in f32.
// Bound: operations, 5 products of 2 * hd flops per seen (i, j) pair for
// each head: 43 GFLOP at photon-1.3b's layer (B 1, S 2048, H 16, hd 128),
// 0.0434 ms at 989 TFLOP/s; the dq kernel recomputes S and dP, so the two
// launches run 7 products.
// ---------------------------------------------------------------------------

constexpr int kNSB = 3;  // stages of the dk/dv kernel's ring
constexpr int kNSQ = 2;  // stages of the dq kernel's ring: two blocks share an SM at hd 128

// one bulk copy of `bytes` (a multiple of 16) into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// an accumulator fragment as wgmma A fragments, each value rounded once to bf16
__device__ __forceinline__ void pack_frags(const float (&x)[kKeys / 2],
                                           uint32_t (&f)[kKeys / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      f[kk][e] = pack_bf16(__floats2bfloat162_rn(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]));
}

// S (+)= A . B^T over hd for two 64-row tiles, both K-major in 128-byte-swizzled
// [HD / 64][64][64] layout (as TMA writes them)
template <int HD>
__device__ __forceinline__ void issue_rowdot(float (&d)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk % 4) * 32;
    wgmma_ss(d, sw128_desc(a_addr + (kk / 4) * kTile * kRowB + off),
             sw128_desc(b_addr + (kk / 4) * kKeys * kRowB + off), kk > 0);
  }
}

// acc[cb] += F . T for F (64 x 64) in A fragments and T a 64-row tile read
// MN-major (T's rows are the sum's index)
template <int HD>
__device__ __forceinline__ void issue_fragdot(float (&acc)[HD / 64][32],
                                              const uint32_t (&f)[kKeys / 16][4],
                                              uint32_t t_addr) {
#pragma unroll
  for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
    for (int cb = 0; cb < HD / 64; ++cb)
      wgmma_rs(acc[cb], f[kk], sw128_desc(t_addr + cb * kKeys * kRowB + kk * 16 * kRowB));
}

// store rows r0 and r0 + 8 of a (64, HD) accumulator times `mul`, as bf16, below `rows`
template <int HD>
__device__ __forceinline__ void store_rows(const float (&acc)[HD / 64][32], float mul,
                                           __nv_bfloat16* base, int64_t rs, int r0, int rows,
                                           int tq4) {
#pragma unroll
  for (int cb = 0; cb < HD / 64; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = cb * 64 + 8 * j + 2 * tq4;
      if (r0 < rows)
        *reinterpret_cast<__nv_bfloat162*>(base + (int64_t)r0 * rs + col) =
            __floats2bfloat162_rn(__fmul_rn(acc[cb][4 * j], mul),
                                  __fmul_rn(acc[cb][4 * j + 1], mul));
      if (r0 + 8 < rows)
        *reinterpret_cast<__nv_bfloat162*>(base + (int64_t)(r0 + 8) * rs + col) =
            __floats2bfloat162_rn(__fmul_rn(acc[cb][4 * j + 2], mul),
                                  __fmul_rn(acc[cb][4 * j + 3], mul));
    }
}

template <int HD>
struct BwdLayout {
  static constexpr size_t tile = (size_t)kTile * HD * 2;  // 64 rows of bf16
  // dq: Q and dO, then kNSQ stages of (K, V), then D of the block's rows
  static constexpr size_t dq_ring = 2 * tile;
  static constexpr size_t dq_d = dq_ring + kNSQ * 2 * tile;
  static constexpr size_t dq_bar = dq_d + kTile * 4;
  static constexpr size_t dq_bytes = dq_bar + 8 * (1 + 2 * kNSQ) + 1024;
  // dkdv: K and V, then kNSB stages of (Q, dO), then kNSB stages of (L, D)
  static constexpr size_t kv_ring = 2 * tile;
  static constexpr size_t kv_vec = kv_ring + kNSB * 2 * tile;
  static constexpr size_t kv_bar = kv_vec + kNSB * 2 * kTile * 4;
  static constexpr size_t kv_bytes = kv_bar + 8 * (1 + 2 * kNSB) + 1024;
};

template <int HD>
__global__ void __launch_bounds__(kThreadsBf16, 1) flash_bwd_dq(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const __nv_bfloat16* __restrict__ o, const __nv_bfloat16* __restrict__ o_lo, int64_t osb,
    int64_t osh, int64_t oss, const __nv_bfloat16* __restrict__ dout, int64_t dsb, int64_t dsh,
    int64_t dss,
    const float* __restrict__ lse, float* __restrict__ dbuf, int lse_len,
    const float* __restrict__ slopes, __nv_bfloat16* __restrict__ dq, int64_t qsb, int64_t qsh,
    int64_t qss, int Hq, int Hkv, int S, float scale, float scale_log2) {
  using L = BwdLayout<HD>;
  constexpr int CB = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* d_rows = reinterpret_cast<float*>(smem + L::dq_d);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::dq_bar);
  uint64_t* qd_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* free_ = bars + 1 + kNSQ;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int qt = (int)(gridDim.y - 1 - blockIdx.y), q0 = qt * kTile;
  const int h = blockIdx.x, b = blockIdx.z, hk = h / (Hq / Hkv);
  const int n = qt + 1;  // key tiles 0 .. qt
  auto stage = [](int i) { return i % kNSQ; };
  auto parity = [](int i) { return (uint32_t)((i / kNSQ) & 1); };

  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kNSQ; ++s) {
      mbar_init(full + s, 1);
      mbar_init(free_ + s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(qd_full, (uint32_t)(2 * L::tile));
      for (int cb = 0; cb < CB; ++cb) {
        tma_load(&tq, smem + cb * kTile * kRowB, qd_full, cb * 64, q0, h, b);
        tma_load(&tdo, smem + L::tile + cb * kTile * kRowB, qd_full, cb * 64, q0, h, b);
      }
      for (int j = 0; j < n; ++j) {
        uint8_t* kt = smem + L::dq_ring + stage(j) * 2 * L::tile;
        mbar_wait(free_ + stage(j), parity(j) ^ 1);
        mbar_expect_tx(full + stage(j), (uint32_t)(2 * L::tile));
        for (int cb = 0; cb < CB; ++cb) {
          tma_load(&tk, kt + cb * kKeys * kRowB, full + stage(j), cb * 64, j * kKeys, hk, b);
          tma_load(&tv, kt + L::tile + cb * kKeys * kRowB, full + stage(j), cb * 64, j * kKeys,
                   hk, b);
        }
      }
    }
    return;
  }

  // D of the block's rows from o + o_lo (o to about 16 bits: with o in bf16
  // alone the rows of dS would not sum to 0 within f32 round-off, and where
  // a head's softmax saturates that error outweighs dS itself): two threads a
  // row, half of hd each; 0 past S
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1, row = q0 + r;
    float d = 0.f;
    if (row < S) {
      const int64_t at = b * osb + h * osh + (int64_t)row * oss + half * (HD / 2);
      const __nv_bfloat16* drow =
          dout + b * dsb + h * dsh + (int64_t)row * dss + half * (HD / 2);
#pragma unroll
      for (int c = 0; c < HD / 2; c += 8) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o + at + c);
        const uint4 lv = *reinterpret_cast<const uint4*>(o_lo + at + c);
        const uint4 dv = *reinterpret_cast<const uint4*>(drow + c);
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* l2 = reinterpret_cast<const __nv_bfloat162*>(&lv);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]), lf = __bfloat1622float2(l2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          d = __fmaf_rn(__fadd_rn(of.x, lf.x), df.x, d);
          d = __fmaf_rn(__fadd_rn(of.y, lf.y), df.y, d);
        }
      }
    }
    d = __fadd_rn(d, __shfl_xor_sync(0xffffffffu, d, 1));
    if (half == 0) {
      d_rows[r] = d;
      dbuf[((int64_t)b * Hq + h) * lse_len + row] = d;
    }
  }
  bar_sync(1, 128);

  const int w = warp, g = lane / 4, tq4 = lane % 4;
  const int row0 = q0 + 16 * w + g, row1 = row0 + 8;
  const float* lb = lse + ((int64_t)b * Hq + h) * lse_len;
  const float l2_0 = __fmul_rn(lb[row0], kLog2e), l2_1 = __fmul_rn(lb[row1], kLog2e);
  const float D0 = d_rows[16 * w + g], D1 = d_rows[16 * w + g + 8];
  const float slope_log2 = __fmul_rn(slopes[h], kLog2e);
  const uint32_t q_addr = smem_u32(smem), do_addr = q_addr + (uint32_t)L::tile;

  float acc[CB][32];
  float sc[kKeys / 2], dp[kKeys / 2];
  uint32_t ds[kKeys / 16][4];
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[cb][r] = 0.f;
  auto k_addr = [&](int j) {
    return smem_u32(smem + L::dq_ring + stage(j) * 2 * L::tile);
  };
  auto issue_sdp = [&](int j) {  // S = Q.K_j^T, dP = dO.V_j^T: two groups
    issue_rowdot<HD>(sc, q_addr, k_addr(j));
    wgmma_commit();
    issue_rowdot<HD>(dp, do_addr, k_addr(j) + (uint32_t)L::tile);
    wgmma_commit();
  };

  mbar_wait(qd_full, 0);
  mbar_wait(full + stage(0), parity(0));
  wgmma_fence();
  issue_sdp(0);
  for (int j = 0; j < n; ++j) {
    wgmma_wait<1>();  // S of tile j, and dS.K of tile j - 1
    fence_regs(sc);
    if (j > 0) {
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) fence_regs(ds[kk]);
      if (lane == 0) mbar_arrive(free_ + stage(j - 1));
    }
    // slope * (i - j) + L as the forward forms the bias: a row term less the
    // key's constant offset in the thread's columns
    const int k0 = j * kKeys;
    const float rb0 = __fmaf_rn(slope_log2, (float)(row0 - k0 - 2 * tq4), l2_0);
    const float rb1 = __fmaf_rn(slope_log2, (float)(row1 - k0 - 2 * tq4), l2_1);
#pragma unroll
    for (int r = 0; r < kKeys / 2; ++r) {
      const float off = (float)(8 * (r / 4) + (r & 1));
      const float bias = __fmaf_rn(-slope_log2, off, (r & 2) ? rb1 : rb0);
      sc[r] = ex2(__fmaf_rn(sc[r], scale_log2, -bias));
    }
    if (j == qt) {  // the diagonal tile: keys past the row are not seen
#pragma unroll
      for (int r = 0; r < kKeys / 2; ++r)
        if (k0 + 8 * (r / 4) + 2 * tq4 + (r & 1) > ((r & 2) ? row1 : row0)) sc[r] = 0.f;
    }
    wgmma_wait<0>();  // dP of tile j
    fence_regs(dp);
#pragma unroll
    for (int r = 0; r < kKeys / 2; ++r)
      dp[r] = __fmul_rn(sc[r], __fsub_rn(dp[r], (r & 2) ? D1 : D0));
    pack_frags(dp, ds);
    wgmma_fence();
    issue_fragdot<HD>(acc, ds, k_addr(j));  // dQ += dS.K_j
    wgmma_commit();
    if (j + 1 < n) {
      mbar_wait(full + stage(j + 1), parity(j + 1));
      issue_sdp(j + 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) fence_regs(acc[cb]);
  store_rows<HD>(acc, scale, dq + b * qsb + h * qsh, qss, row0, S, tq4);
}

template <int HD>
__global__ void __launch_bounds__(kThreadsBf16, 1) flash_bwd_dkdv(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ dbuf, int lse_len,
    const float* __restrict__ slopes, __nv_bfloat16* __restrict__ dk, int64_t ksb, int64_t ksh,
    int64_t kss, __nv_bfloat16* __restrict__ dv, int64_t vsb, int64_t vsh, int64_t vss, int Hq,
    int Hkv, int S, float scale, float scale_log2) {
  using L = BwdLayout<HD>;
  constexpr int CB = HD / 64;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kv_bar);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* free_ = bars + 1 + kNSB;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kt = blockIdx.y, k0 = kt * kKeys;
  const int hk = blockIdx.x, b = blockIdx.z, grp = Hq / Hkv;
  const int n_q = (S + kTile - 1) / kTile, per_head = n_q - kt;
  const int n = grp * per_head;  // (query head of the group, query tile kt .. n_q - 1)
  auto stage = [](int i) { return i % kNSB; };
  auto parity = [](int i) { return (uint32_t)((i / kNSB) & 1); };
  auto head_of = [&](int i) { return hk * grp + i / per_head; };
  auto qtile_of = [&](int i) { return kt + i % per_head; };

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kNSB; ++s) {
      mbar_init(full + s, 1);
      mbar_init(free_ + s, 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 4) {
    if (lane == 0) {
      mbar_expect_tx(kv_full, (uint32_t)(2 * L::tile));
      for (int cb = 0; cb < CB; ++cb) {
        tma_load(&tk, smem + cb * kKeys * kRowB, kv_full, cb * 64, k0, hk, b);
        tma_load(&tv, smem + L::tile + cb * kKeys * kRowB, kv_full, cb * 64, k0, hk, b);
      }
      for (int i = 0; i < n; ++i) {
        const int h = head_of(i), q0 = qtile_of(i) * kTile;
        uint8_t* qs = smem + L::kv_ring + stage(i) * 2 * L::tile;
        float* vec = reinterpret_cast<float*>(smem + L::kv_vec) + stage(i) * 2 * kTile;
        const int64_t at = ((int64_t)b * Hq + h) * lse_len + q0;
        mbar_wait(free_ + stage(i), parity(i) ^ 1);
        mbar_expect_tx(full + stage(i), (uint32_t)(2 * L::tile + 2 * kTile * 4));
        for (int cb = 0; cb < CB; ++cb) {
          tma_load(&tq, qs + cb * kTile * kRowB, full + stage(i), cb * 64, q0, h, b);
          tma_load(&tdo, qs + L::tile + cb * kTile * kRowB, full + stage(i), cb * 64, q0, h, b);
        }
        bulk_load(vec, lse + at, kTile * 4, full + stage(i));
        bulk_load(vec + kTile, dbuf + at, kTile * 4, full + stage(i));
      }
    }
    return;
  }

  // this thread holds keys kr0 and kr0 + 8, queries q0 + 8 (r / 4) + 2 tq4 + (r & 1)
  const int w = warp, g = lane / 4, tq4 = lane % 4;
  const int kr0 = k0 + 16 * w + g, kr1 = kr0 + 8;
  const uint32_t k_addr = smem_u32(smem), v_addr = k_addr + (uint32_t)L::tile;
  auto q_addr = [&](int i) {
    return smem_u32(smem + L::kv_ring + stage(i) * 2 * L::tile);
  };

  float dka[CB][32], dva[CB][32];
  float st[kKeys / 2], dp[kKeys / 2];
  uint32_t pf[kKeys / 16][4], sf[kKeys / 16][4];
#pragma unroll
  for (int cb = 0; cb < CB; ++cb)
#pragma unroll
    for (int r = 0; r < 32; ++r) dka[cb][r] = dva[cb][r] = 0.f;
  auto issue_sdp = [&](int i) {  // S^T = K.Q_i^T, dP^T = V.dO_i^T: two groups
    issue_rowdot<HD>(st, k_addr, q_addr(i));
    wgmma_commit();
    issue_rowdot<HD>(dp, v_addr, q_addr(i) + (uint32_t)L::tile);
    wgmma_commit();
  };

  mbar_wait(kv_full, 0);
  mbar_wait(full + stage(0), parity(0));
  wgmma_fence();
  issue_sdp(0);
  for (int i = 0; i < n; ++i) {
    wgmma_wait<1>();  // S^T of step i, and the dV, dK products of step i - 1
    fence_regs(st);
    if (i > 0) {
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        fence_regs(dka[cb]);
        fence_regs(dva[cb]);
      }
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        fence_regs(pf[kk]);
        fence_regs(sf[kk]);
      }
      if (lane == 0) mbar_arrive(free_ + stage(i - 1));
    }
    const int qt = qtile_of(i), q0 = qt * kTile;
    const float slope_log2 = __fmul_rn(slopes[head_of(i)], kLog2e);
    const float* lv = reinterpret_cast<const float*>(smem + L::kv_vec) + stage(i) * 2 * kTile;
    // slope * (i - j) = a row (key) term plus the query's constant offset in
    // the thread's columns; then + L of the query
    const float rk0 = __fmul_rn(slope_log2, (float)(q0 + 2 * tq4 - kr0));
    const float rk1 = __fmul_rn(slope_log2, (float)(q0 + 2 * tq4 - kr1));
#pragma unroll
    for (int r = 0; r < kKeys / 2; ++r) {
      const int qc = 8 * (r / 4) + 2 * tq4 + (r & 1);
      const float off = (float)(8 * (r / 4) + (r & 1));
      const float dist = __fmaf_rn(slope_log2, off, (r & 2) ? rk1 : rk0);
      st[r] = ex2(__fmaf_rn(st[r], scale_log2, -__fmaf_rn(lv[qc], kLog2e, dist)));
    }
    if (qt == kt || q0 + kTile > S) {  // the diagonal tile, or queries past S
#pragma unroll
      for (int r = 0; r < kKeys / 2; ++r) {
        const int qp = q0 + 8 * (r / 4) + 2 * tq4 + (r & 1), kp = (r & 2) ? kr1 : kr0;
        if (kp > qp || qp >= S) st[r] = 0.f;
      }
    }
    pack_frags(st, pf);
    wgmma_wait<0>();  // dP^T of step i
    fence_regs(dp);
#pragma unroll
    for (int r = 0; r < kKeys / 2; ++r) {
      const int qc = 8 * (r / 4) + 2 * tq4 + (r & 1);
      dp[r] = __fmul_rn(st[r], __fsub_rn(dp[r], lv[kTile + qc]));
    }
    pack_frags(dp, sf);
    wgmma_fence();
    issue_fragdot<HD>(dva, pf, q_addr(i) + (uint32_t)L::tile);  // dV += P^T.dO_i
    issue_fragdot<HD>(dka, sf, q_addr(i));                      // dK += dS^T.Q_i
    wgmma_commit();
    if (i + 1 < n) {
      mbar_wait(full + stage(i + 1), parity(i + 1));
      issue_sdp(i + 1);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int cb = 0; cb < CB; ++cb) {
    fence_regs(dka[cb]);
    fence_regs(dva[cb]);
  }
  store_rows<HD>(dka, scale, dk + b * ksb + hk * ksh, kss, kr0, S, tq4);
  store_rows<HD>(dva, 1.f, dv + b * vsb + hk * vsh, vss, kr0, S, tq4);
}

// the (b, h, s) strides of q, k, v, o, dO, dq, dk and dv, in elements
struct BwdStrides {
  int64_t q[3], k[3], v[3], o[3], d[3], dq[3], dk[3], dv[3];
};

template <int HD>
int launch_alibi_bwd(const void* q, const void* k, const void* v, const void* o,
                     const void* o_lo, const void* dout, const float* lse, float* dbuf,
                     const float* slopes, void* dq, void* dk, void* dv, const BwdStrides& st,
                     int B, int Hq, int Hkv, int S, float scale, cudaStream_t stream) {
  using L = BwdLayout<HD>;
  static_assert(L::dq_bytes <= kMaxSmem && L::kv_bytes <= kMaxSmem, "tiles exceed shared memory");
  CUtensorMap tq, tk, tv, tdo;
  int err = make_map(&tq, q, HD, S, Hq, B, st.q[2], st.q[1], st.q[0], kTile);
  if (!err) err = make_map(&tk, k, HD, S, Hkv, B, st.k[2], st.k[1], st.k[0], kKeys);
  if (!err) err = make_map(&tv, v, HD, S, Hkv, B, st.v[2], st.v[1], st.v[0], kKeys);
  if (!err) err = make_map(&tdo, dout, HD, S, Hq, B, st.d[2], st.d[1], st.d[0], kTile);
  if (err) return err;
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq<HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)L::dq_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(flash_bwd_dkdv<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)L::kv_bytes);
  if (e != cudaSuccess) return (int)e;
  const int n_q = (S + kTile - 1) / kTile, lse_len = n_q * kTile;
  const float scale_log2 = scale * kLog2e;
  const auto* ob = static_cast<const __nv_bfloat16*>(o);
  const auto* lo = static_cast<const __nv_bfloat16*>(o_lo);
  const auto* db = static_cast<const __nv_bfloat16*>(dout);
  flash_bwd_dq<HD><<<dim3(Hq, n_q, B), kThreadsBf16, L::dq_bytes, stream>>>(
      tq, tk, tv, tdo, ob, lo, st.o[0], st.o[1], st.o[2], db, st.d[0], st.d[1], st.d[2], lse,
      dbuf, lse_len, slopes, static_cast<__nv_bfloat16*>(dq), st.dq[0], st.dq[1], st.dq[2], Hq,
      Hkv, S, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkdv<HD><<<dim3(Hkv, n_q, B), kThreadsBf16, L::kv_bytes, stream>>>(
      tq, tk, tv, tdo, lse, dbuf, lse_len, slopes, static_cast<__nv_bfloat16*>(dk), st.dk[0],
      st.dk[1], st.dk[2], static_cast<__nv_bfloat16*>(dv), st.dv[0], st.dv[1], st.dv[2], Hq, Hkv,
      S, scale, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o (B, Hq, Sq, hd) and k, v (B, Hkv, Sk, hd), all bf16 when is_bf16, else
// f32, addressed through their (b, h, s) strides in elements (the hd axis is
// contiguous; for bf16 every stride is a multiple of 8 and every pointer
// 16-byte aligned, as TMA needs). hd is 64 or 128. `window` is read only when
// has_window. Returns cudaGetLastError() after the one launch, or 1000 when
// the driver has no cuTensorMapEncodeTiled, 1001 + CUresult when it refuses a
// tensor map.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                        int Hkv, int Sq, int Sk, int hd, int64_t qb, int64_t qh, int64_t qs,
                        int64_t kb, int64_t kh, int64_t ks, int64_t vb, int64_t vh, int64_t vs,
                        int64_t ob, int64_t oh, int64_t os, int causal, int has_window,
                        int window, int q_offset, float scale, int is_bf16, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || Sq < 1 || Sk < 1 || Hq > 65535 ||
      B > 65535 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Strides st{qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os};
  if (is_bf16)
    return hd == 64 ? launch_bf16<64>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, causal, has_window,
                                      window, q_offset, scale, s)
                    : launch_bf16<128>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, causal, has_window,
                                       window, q_offset, scale, s);
  return hd == 64 ? launch_f32<64>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, causal, has_window,
                                   window, q_offset, scale, s)
                  : launch_f32<128>(q, k, v, o, st, B, Hq, Hkv, Sq, Sk, causal, has_window,
                                    window, q_offset, scale, s);
}

// Causal ALiBi self-attention forward for training: bf16 q, o (B, Hq, S, hd)
// and k, v (B, Hkv, S, hd) through their (b, h, s) strides, as
// flash_attention_fwd takes them; o_lo, o's rounding residual, through o's
// strides; slopes (Hq,) f32 on the device; lse (B, Hq, lse_len) f32 with
// lse_len = S rounded up to 64, every row written. One launch.
int flash_attention_alibi_fwd(const void* q, const void* k, const void* v, void* o, void* o_lo,
                              float* lse, const float* slopes, int B, int Hq, int Hkv, int S,
                              int hd, const int64_t* strides, float scale, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B > 65535 ||
      (S + kTile - 1) / kTile > 65535 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  const int64_t* x = strides;  // q, k, v, o: (b, h, s) each
  const Strides st{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8], x[9], x[10], x[11]};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_bf16<64, true, true>(q, k, v, o, st, B, Hq, Hkv, S, S, 1, 0, 0, 0,
                                                scale, s, slopes, lse, o_lo)
                  : launch_bf16<128, true, true>(q, k, v, o, st, B, Hq, Hkv, S, S, 1, 0, 0, 0,
                                                 scale, s, slopes, lse, o_lo);
}

// Its backward: dq (B, Hq, S, hd), dk and dv (B, Hkv, S, hd), bf16, from q, k,
// v, o and o_lo (o's strides), dO (o's shape) and the forward's lse; dbuf
// (B, Hq, lse_len) f32 is scratch for D. strides: (b, h, s) of q, k, v, o,
// dO, dq, dk, dv. Two launches; returns the first error.
int flash_attention_alibi_bwd(const void* q, const void* k, const void* v, const void* o,
                              const void* o_lo, const void* dout, const float* lse, float* dbuf,
                              const float* slopes, void* dq, void* dk, void* dv, int B, int Hq,
                              int Hkv, int S, int hd, const int64_t* strides, float scale,
                              void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || B > 65535 ||
      (S + kTile - 1) / kTile > 65535 || (hd != 64 && hd != 128))
    return (int)cudaErrorInvalidValue;
  BwdStrides st;
  int64_t* dst[8] = {st.q, st.k, st.v, st.o, st.d, st.dq, st.dk, st.dv};
  for (int t = 0; t < 8; ++t)
    for (int a = 0; a < 3; ++a) dst[t][a] = strides[3 * t + a];
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return hd == 64 ? launch_alibi_bwd<64>(q, k, v, o, o_lo, dout, lse, dbuf, slopes, dq, dk, dv,
                                         st, B, Hq, Hkv, S, scale, s)
                  : launch_alibi_bwd<128>(q, k, v, o, o_lo, dout, lse, dbuf, slopes, dq, dk, dv,
                                          st, B, Hq, Hkv, S, scale, s);
}

}  // extern "C"
