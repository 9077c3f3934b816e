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
// (67 TFLOP/s over 3.35 TB/s = 20 flops per byte): 0.290 ms. On the bf16
// tensor cores (989 TFLOP/s) it is 0.0196 ms, and the 157 MB bound it at
// 0.047 ms.
//
// Two kernels, routed by dtype and shape before the launch (neither falls
// back on the other):
//
// bf16 x, B and C with chunk 64, hd 64 or 128 and ds 64 or 128: the
// tensor-core route (ssd_cb_kernel, then ssd_scan_tc_kernel, one call).
//   - C B^T once per (b, g, chunk): ssd_cb_kernel stages the chunk's C and B
//     (64 x ds bf16 each) with TMA and runs wgmma m64n64k16 (both K-major,
//     f32 accumulators; products of bf16 values are exact) into a
//     (B, G, n_chunks, 64, 64) f32 scratch array (2 MB at mamba2-1.3b's
//     shape), which the heads of the group then read through L2.
//   - The scan: one block per (b, two heads of one group) where hd is 64 and
//     the group even (128 blocks, one wave, at mamba2-1.3b's shape), else one
//     head; hd / 64 consumer warpgroups a head (one per 64 rows of the state)
//     and one producer warp. The producer keeps a ring of two stages full:
//     each head's x tile (64 x hd), the group's B and C tiles (64 x ds) and
//     its C B^T tile by TMA (128-byte swizzle), and each head's dt, inclusive
//     cumsum of dt * A (sequential in f32, as the TPU kernel's), exp(cum),
//     dt * exp(total - cum) and exp(total), computed a chunk ahead. Two
//     heads give every SM sub-partition two consumer warps whose chains of
//     products, waits and barriers interleave.
//   - Each consumer warpgroup keeps its 64 x ds rows of the f32 state S in
//     registers, as wgmma accumulators, for the whole chunk loop.
//   - y_inter = exp(cum) o (C S^T): C (exact bf16, K-major) from the stage;
//     S split into hi = bf16(S) and lo = bf16(S - hi), written by the
//     warpgroup into shared memory in the swizzled K-major layout.
//   - y_intra = M' x with M' = C B^T o L o dt_j (L = exp(cum_i - cum_j) for
//     j <= i, else 0) built in f32 in the accumulator layout from the staged
//     C B^T and fed from registers as two bf16 A fragments (hi, lo); x
//     (exact bf16) is the MN-major B operand. L is ex2.approx of (cum_i -
//     cum_j) log2(e): about 2^-22 relative error (PTX ISA) plus one rounding
//     of the product, against one bf16 ulp held on y.
//   - S <- exp(total) S + (x o dt o w)^T B: x o dt o w (f32, w = exp(total -
//     cum)) in three bf16 terms (hi, mid, lo) as MN-major A operands, B
//     (exact bf16) from the stage as the MN-major B operand, accumulated into
//     the state's registers.
//   - Terms: tests/test_torch_ssm.py emulates these roundings on the CPU.
//     One bf16 term per f32 operand breaks the held tolerances (y 34-41
//     units, state 220-236); two terms everywhere hold them (y 0.98, state
//     0.25-0.59 units); a third term for the state operand brings the state
//     to 0.08-0.15 units for 20% more tensor work, and is taken.
//   - The tensor-core work is 2 x 64 x 64 x ds x 5 + 2 x 64 x 64 x 64 x 2 flops
//     per (b, h, chunk) (at mamba2-1.3b's shape 43 GFLOP, 0.044 ms at the
//     bf16 peak); the chain per chunk (terms into shared memory, three
//     products, waits) runs in order inside a warpgroup.
//
// f32, and bf16 outside those shapes: the CUDA-core kernel
// (ssd_scan_kernel), as first written. The TPU kernel runs a grid
// (B, nh, n_chunks) whose chunk axis is sequential and keeps S in VMEM
// scratch between grid steps. Blocks here run in no order, so one block owns
// one (b, h) and loops over its chunks; S lives in shared memory for the
// whole loop. Each chunk is staged in shared memory as f32 (C and B
// transposed, dt * x, the masked scores) and the three products are
// register-tiled: every thread computes 4 x 4 outputs as outer products of
// two float4 rows of shared memory, with explicit fused multiply-adds (the
// library is built with --fmad=false, so nothing else is contracted). The
// cumsum is sequential in f32, as the TPU kernel's. B * nh blocks of 256
// threads and ~137 KB of dynamic shared memory: one block per SM. It computes
// C B^T for every head and the full chunk x chunk products (30.1 GFLOP at
// mamba2-1.3b's shape).
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 4;  // row padding of the shared tiles, in floats (keeps float4 alignment)

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core route
// ---------------------------------------------------------------------------

constexpr int kChunk = 64;      // rows of a chunk: one wgmma M and one k-loop of 4 x k16
constexpr int kBlk = 64 * 64 * 2;  // bytes of one 64 x 64 bf16 swizzled block
constexpr int kTermsS = 2, kTermsM = 2, kTermsX = 3;  // bf16 terms per f32 operand
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;

// C B^T of one (b, g, chunk) into cb (B, G, n_chunks, 64, 64) f32
template <int NB>
__global__ void __launch_bounds__(128) ssd_cb_kernel(const __grid_constant__ CUtensorMap tb,
                                                     const __grid_constant__ CUtensorMap tc,
                                                     float* __restrict__ cb) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Cs = smem;             // [NB][64 i][64 n]
  uint8_t* Bs = smem + NB * kBlk;  // [NB][64 j][64 n]
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * NB * kBlk);
  const int c = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int w = threadIdx.x / 32, lane = threadIdx.x % 32, g8 = lane / 4, tq = lane % 4;
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar, 2 * NB * kBlk);
    for (int k = 0; k < NB; ++k) {
      tma_load(&tc, Cs + k * kBlk, bar, 64 * k, c * kChunk, g, b);
      tma_load(&tb, Bs + k * kBlk, bar, 64 * k, c * kChunk, g, b);
    }
  }
  mbar_wait(bar, 0);
  float acc[32];
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4 * NB; ++kk) {
    const uint32_t off = (kk / 4) * kBlk + (kk % 4) * 32;
    wgmma_ss(acc, sw128_desc(smem_u32(Cs) + off), sw128_desc(smem_u32(Bs) + off), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  float* out = cb + (((int64_t)b * gridDim.y + g) * gridDim.x + c) * kChunk * kChunk;
  const int i0 = 16 * w + g8;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * tq;
    *reinterpret_cast<float2*>(out + i0 * kChunk + col) = make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(out + (i0 + 8) * kChunk + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// per-chunk scalars of one head, computed by the producer a chunk ahead
struct ChunkScalars {
  float dt[kChunk], cum[kChunk], ecum[kChunk], dtw[kChunk];  // dtw = dt * exp(total - cum)
  float etot;                                                // exp(total)
};
constexpr int kScalarBytes = (sizeof(ChunkScalars) + 15) / 16 * 16;
constexpr int kCbBytes = kChunk * kChunk * 4;  // one chunk's C B^T, f32

// shared memory of one scan block (HPB heads of one group, NWG warpgroups
// each): kStages stages of [x of each head | B | C | C B^T] tiles, a terms
// buffer per head (S in two terms, then x o dt o w in three), the scalars,
// the barriers
template <int NWG, int NB, int HPB>
struct ScanLayout {
  static constexpr int x_bytes = NWG * kBlk, bc_bytes = NB * kBlk;
  static constexpr int b_at = HPB * x_bytes, c_at = b_at + bc_bytes, cb_at = c_at + bc_bytes;
  static constexpr int stage = cb_at + kCbBytes;
  static constexpr int term_s = NWG * NB * kBlk;  // one term of S: [NB][hd rows][64]
  static constexpr int term_x = NWG * kBlk;       // one term of x o dt o w: [NWG][64][64]
  static constexpr int terms = kTermsS * term_s > kTermsX * term_x ? kTermsS * term_s
                                                                    : kTermsX * term_x;
  static constexpr int terms_at = kStages * stage;
  static constexpr int scalars_at = terms_at + HPB * terms;
  static constexpr int bars_at = scalars_at + kStages * HPB * kScalarBytes;
  static constexpr size_t bytes = (size_t)bars_at + 16 * kStages + 1024;  // + alignment slack
  static constexpr int threads = 128 * NWG * HPB + 32;
  static_assert(bytes <= kMaxSmem, "ssd tiles exceed shared memory");
};

// split v into N bf16 terms (v ~ t[0] + t[1] + ...), packing the pair (x, y)
template <int N>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t (&t)[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    t[k] = pack_bf16(h);
    x = __fsub_rn(x, __low2float(h));
    y = __fsub_rn(y, __high2float(h));
  }
}

// (C B^T)[i][j], j even, and [i][j + 1] from the staged f32 tile: two
// 64 x 32 blocks of 128-byte rows in TMA's 128-byte swizzle
__device__ __forceinline__ float2 cb_pair(const uint8_t* cbs, int i, int j) {
  const int jb = j / 32, jj = j % 32;
  return *reinterpret_cast<const float2*>(cbs + jb * (kChunk * 128) + i * 128 +
                                          (((jj / 4) ^ (i & 7)) << 4) + (jj % 4) * 4);
}

template <int NWG, int NB, int HPB>
__global__ void __launch_bounds__(ScanLayout<NWG, NB, HPB>::threads, 1) ssd_scan_tc_kernel(
    const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tb,
    const __grid_constant__ CUtensorMap tc, const __grid_constant__ CUtensorMap tcb,
    const float* __restrict__ dt, const float* __restrict__ A, const float* __restrict__ init,
    __nv_bfloat16* __restrict__ y, float* __restrict__ final_state, int nh, int G, int S) {
  using L = ScanLayout<NWG, NB, HPB>;
  constexpr int HD = 64 * NWG, DS = 64 * NB, NCH = 128 * NWG;  // NCH: consumer threads a head
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars_at);
  uint64_t* empty = full + kStages;
  auto stage_at = [&](int s) { return smem + s * L::stage; };
  auto scalars = [&](int s, int hi) {
    return reinterpret_cast<ChunkScalars*>(smem + L::scalars_at + (s * HPB + hi) * kScalarBytes);
  };

  const int h0 = blockIdx.x * HPB, b = blockIdx.y;
  const int g = h0 / (nh / G);
  const int n_chunks = S / kChunk;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, HPB * NCH / 32);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == HPB * NCH / 32) {  // the producer warp
    const float a = lane < HPB ? A[h0 + lane] : 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const int s = c % kStages;
      float dtv[HPB][2];  // loaded before the wait, so their latency overlaps it
#pragma unroll
      for (int hi = 0; hi < HPB; ++hi) {
        const float* dtb = dt + ((int64_t)b * nh + h0 + hi) * S + c * kChunk;
        dtv[hi][0] = dtb[lane];
        dtv[hi][1] = dtb[lane + 32];
      }
      mbar_wait(empty + s, ((c / kStages) & 1) ^ 1);  // the first round passes at once
#pragma unroll
      for (int hi = 0; hi < HPB; ++hi) {
        scalars(s, hi)->dt[lane] = dtv[hi][0];
        scalars(s, hi)->dt[lane + 32] = dtv[hi][1];
      }
      __syncwarp();
      if (lane < HPB) {  // inclusive cumsum of dt * A, in order, one lane a head
        ChunkScalars* sc = scalars(s, lane);
        float run = 0.f;
        for (int l = 0; l < kChunk; ++l) {
          run = __fadd_rn(run, __fmul_rn(sc->dt[l], a));
          sc->cum[l] = run;
        }
      }
      __syncwarp();
#pragma unroll
      for (int hi = 0; hi < HPB; ++hi) {
        ChunkScalars* sc = scalars(s, hi);
        const float total = sc->cum[kChunk - 1];
#pragma unroll
        for (int l = lane; l < kChunk; l += 32) {
          sc->ecum[l] = expf(sc->cum[l]);
          sc->dtw[l] = __fmul_rn(sc->dt[l], expf(__fsub_rn(total, sc->cum[l])));
        }
        if (lane == 0) sc->etot = expf(total);
      }
      __syncwarp();
      if (lane == 0) {
        uint8_t* st = stage_at(s);
        mbar_expect_tx(full + s, L::stage);
        for (int hi = 0; hi < HPB; ++hi)
          for (int k = 0; k < NWG; ++k)
            tma_load(&tx, st + hi * L::x_bytes + k * kBlk, full + s, 64 * k, c * kChunk, h0 + hi,
                     b);
        for (int k = 0; k < NB; ++k) {
          tma_load(&tb, st + L::b_at + k * kBlk, full + s, 64 * k, c * kChunk, g, b);
          tma_load(&tc, st + L::c_at + k * kBlk, full + s, 64 * k, c * kChunk, g, b);
        }
        const int cb_row = (((b * G) + g) * n_chunks + c) * kChunk;
        for (int k = 0; k < 2; ++k)
          tma_load(&tcb, st + L::cb_at + k * (kCbBytes / 2), full + s, 32 * k, cb_row, 0, 0);
      }
    }
    return;
  }

  // a consumer: warpgroup wr of head hi owns state rows (and y columns)
  // 64 wr .. 64 wr + 63 of head h0 + hi
  const int wg = warp / 4, hi = wg / NWG, wr = wg % NWG, w = warp % 4, g8 = lane / 4, tq = lane % 4;
  const int tid = threadIdx.x % NCH, bar = 1 + hi;  // the head's threads and named barrier
  const int r0 = 16 * w + g8;  // this thread's rows r0 and r0 + 8 of any 64-row tile
  const int64_t bh = (int64_t)b * nh + h0 + hi;
  uint8_t* terms = smem + L::terms_at + hi * L::terms;
  const uint32_t tm = smem_u32(terms);
  float st[NB][32];  // S[64 wr + r0 (+8)][64 k + 8 j + 2 tq (+1)]
  {
    const float* src = init + bh * HD * DS;
#pragma unroll
    for (int k = 0; k < NB; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int d = 64 * wr + r0 + 8 * hr, n = 64 * k + 8 * j + 2 * tq;
          const float2 v = *reinterpret_cast<const float2*>(src + d * DS + n);
          st[k][4 * j + 2 * hr] = v.x;
          st[k][4 * j + 2 * hr + 1] = v.y;
        }
  }
  __nv_bfloat16* yb = y + bh * S * HD;

  for (int c = 0; c < n_chunks; ++c) {
    const int s = c % kStages;
    mbar_wait(full + s, (c / kStages) & 1);
    const ChunkScalars* sc = scalars(s, hi);
    const uint8_t* xsp = stage_at(s) + hi * L::x_bytes;
    const uint8_t* cbs = stage_at(s) + L::cb_at;
    const uint32_t xs = smem_u32(xsp), bs = smem_u32(stage_at(s) + L::b_at),
                   cs = smem_u32(stage_at(s) + L::c_at);

    // S into the terms buffer as hi and lo, K-major for C S^T, once every
    // warpgroup of the head is done with the previous chunk's x terms there
    bar_sync(bar, NCH);
#pragma unroll
    for (int k = 0; k < NB; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          uint32_t t[kTermsS];
          split_pair(st[k][4 * j + 2 * hr], st[k][4 * j + 2 * hr + 1], t);
          const uint32_t off = k * (HD * 128) + sw128_offset(64 * wr + r0 + 8 * hr, 8 * j + 2 * tq);
#pragma unroll
          for (int e = 0; e < kTermsS; ++e)
            *reinterpret_cast<uint32_t*>(terms + e * L::term_s + off) = t[e];
        }
    fence_proxy_async();
    bar_sync(bar, NCH);

    // y = C S^T for this warpgroup's 64 columns of y (its rows of S)
    float yacc[32];
    wgmma_fence();
#pragma unroll
    for (int e = 0; e < kTermsS; ++e)
#pragma unroll
      for (int kk = 0; kk < 4 * NB; ++kk) {
        const uint32_t off = (kk / 4) * kBlk + (kk % 4) * 32;
        wgmma_ss(yacc, sw128_desc(cs + off),
                 sw128_desc(tm + e * L::term_s + (kk / 4) * (HD * 128) + wr * kBlk + (kk % 4) * 32),
                 (e | kk) != 0);
      }
    wgmma_commit();

    // meanwhile M' = C B^T o L o dt_j in the accumulator layout, as A fragments
    uint32_t mf[kTermsM][4][4];
    {
      const float cum0 = sc->cum[r0], cum1 = sc->cum[r0 + 8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + 8 * (e & 1), j = 16 * kk + 8 * (e >> 1) + 2 * tq;
          const float2 v = cb_pair(cbs, i, j);
          const float ci = (e & 1) ? cum1 : cum0;
          // L = 2^((cum_i - cum_j) log2 e): the difference as the plain version
          // takes it, one rounding of the product, the SFU's exp2
          const float m0 =
              j <= i ? __fmul_rn(__fmul_rn(v.x, ex2(__fmul_rn(__fsub_rn(ci, sc->cum[j]), kLog2e))),
                                 sc->dt[j])
                     : 0.f;
          const float m1 =
              j + 1 <= i
                  ? __fmul_rn(__fmul_rn(v.y, ex2(__fmul_rn(__fsub_rn(ci, sc->cum[j + 1]), kLog2e))),
                              sc->dt[j + 1])
                  : 0.f;
          uint32_t t[kTermsM];
          split_pair(m0, m1, t);
#pragma unroll
          for (int q = 0; q < kTermsM; ++q) mf[q][kk][e] = t[q];
        }
    }
    wgmma_wait<0>();
    fence_regs(yacc);
    {
      const float e0 = sc->ecum[r0], e1 = sc->ecum[r0 + 8];
#pragma unroll
      for (int r = 0; r < 32; ++r) yacc[r] = __fmul_rn(yacc[r], (r & 2) ? e1 : e0);
    }

    // x o dt o w (the state update's A operand) as three terms, MN-major as
    // x is staged, over the S terms
    bar_sync(bar, NCH);  // every warpgroup of the head is done reading the S terms
    for (int off = tid * 16; off < L::x_bytes; off += NCH * 16) {
      const float wl = sc->dtw[(off % kBlk) / 128];
      const uint4 raw = *reinterpret_cast<const uint4*>(xsp + off);
      const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint4 out[kTermsX];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t t[kTermsX];
        split_pair(__fmul_rn(__low2float(xv[p]), wl), __fmul_rn(__high2float(xv[p]), wl), t);
#pragma unroll
        for (int e = 0; e < kTermsX; ++e) reinterpret_cast<uint32_t*>(&out[e])[p] = t[e];
      }
#pragma unroll
      for (int e = 0; e < kTermsX; ++e)
        *reinterpret_cast<uint4*>(terms + e * L::term_x + off) = out[e];
    }
    fence_proxy_async();
    bar_sync(bar, NCH);

    // y += M' x ;  S <- exp(total) S + (x o dt o w)^T B
    const float etot = sc->etot;
#pragma unroll
    for (int k = 0; k < NB; ++k)
#pragma unroll
      for (int r = 0; r < 32; ++r) st[k][r] = __fmul_rn(st[k][r], etot);
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < kTermsM; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(yacc, mf[q][kk], sw128_desc(xs + wr * kBlk + kk * 16 * 128));
#pragma unroll
    for (int k = 0; k < NB; ++k)
#pragma unroll
      for (int e = 0; e < kTermsX; ++e)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_ss<1, 1>(st[k], sw128_desc(tm + e * L::term_x + wr * kBlk + kk * 16 * 128),
                         sw128_desc(bs + k * kBlk + kk * 16 * 128), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(yacc);
#pragma unroll
    for (int k = 0; k < NB; ++k) fence_regs(st[k]);
#pragma unroll
    for (int q = 0; q < kTermsM; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) fence_regs(mf[q][kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with the stage

    __nv_bfloat16* yc = yb + (int64_t)c * kChunk * HD + 64 * wr;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(yc + r0 * HD + col) =
          __floats2bfloat162_rn(yacc[4 * j], yacc[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(yc + (r0 + 8) * HD + col) =
          __floats2bfloat162_rn(yacc[4 * j + 2], yacc[4 * j + 3]);
    }
  }

  float* dst = final_state + bh * HD * DS;
#pragma unroll
  for (int k = 0; k < NB; ++k)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int d = 64 * wr + r0 + 8 * hr, n = 64 * k + 8 * j + 2 * tq;
        *reinterpret_cast<float2*>(dst + d * DS + n) =
            make_float2(st[k][4 * j + 2 * hr], st[k][4 * j + 2 * hr + 1]);
      }
}

// a 4-d bf16 map (inner, S, H, B) of a contiguous (B, H, S, inner) tensor,
// boxes of 64 x 64, 128-byte swizzle
int make_map(CUtensorMap* map, const void* base, int inner, int S, int H, int B) {
  const cuuint64_t dims[4] = {(cuuint64_t)inner, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)inner * 2, (cuuint64_t)S * inner * 2,
                                 (cuuint64_t)H * S * inner * 2};
  return make_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, 64, kChunk,
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int NWG, int NB, int HPB>
int launch_tc(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
              const void* init, void* y, void* final_state, void* cb, int B, int nh, int G,
              int S, cudaStream_t stream) {
  using L = ScanLayout<NWG, NB, HPB>;
  const cuuint64_t rows = (cuuint64_t)B * G * S;  // C B^T as rows of 64 f32
  const cuuint64_t cb_dims[4] = {(cuuint64_t)kChunk, rows, 1, 1};
  const cuuint64_t cb_strides[3] = {kChunk * 4, rows * kChunk * 4, rows * kChunk * 4};
  CUtensorMap tx, tb, tc, tcb;
  int err = make_map(&tx, x, 64 * NWG, S, nh, B);
  if (!err) err = make_map(&tb, Bm, 64 * NB, S, G, B);
  if (!err) err = make_map(&tc, Cm, 64 * NB, S, G, B);
  if (!err)
    err = make_map_4d(&tcb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, cb, cb_dims, cb_strides, 32, kChunk,
                      CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  const int cb_bytes = 2 * NB * kBlk + 16 + 1024;
  cudaError_t e = cudaFuncSetAttribute(ssd_cb_kernel<NB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, cb_bytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ssd_scan_tc_kernel<NWG, NB, HPB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::bytes);
  if (e != cudaSuccess) return (int)e;
  ssd_cb_kernel<NB><<<dim3(S / kChunk, G, B), 128, cb_bytes, stream>>>(tb, tc,
                                                                       static_cast<float*>(cb));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_scan_tc_kernel<NWG, NB, HPB><<<dim3(nh / HPB, B), L::threads, L::bytes, stream>>>(
      tx, tb, tc, tcb, static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const float*>(init), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(final_state), nh, G, S);
  return (int)cudaGetLastError();
}

// two heads of a group to a block where they fit (hd 64, an even group)
template <int NWG, int NB>
int launch_tc_heads(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                    const void* init, void* y, void* final_state, void* cb, int B, int nh, int G,
                    int S, cudaStream_t stream) {
  if constexpr (NWG == 1)
    if ((nh / G) % 2 == 0) return launch_tc<NWG, NB, 2>(x, dt, A, Bm, Cm, init, y, final_state, cb, B, nh, G, S, stream);
  return launch_tc<NWG, NB, 1>(x, dt, A, Bm, Cm, init, y, final_state, cb, B, nh, G, S, stream);
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

// The tensor-core route: x, y (B, nh, S, hd) and Bm, Cm (B, G, S, ds) bf16;
// dt (B, nh, S), A (nh,), init and final_state (B, nh, hd, ds) f32; all
// contiguous, every base 16-byte aligned; chunk 64; hd and ds each 64 or
// 128; cb (B, G, S / 64, 64, 64) f32 scratch. Returns cudaGetLastError()
// after the two launches, or 1000 when the driver has no
// cuTensorMapEncodeTiled, 1001 + CUresult when it refuses a tensor map.
// S = 0 launches nothing and copies init into final_state.
int ssd_scan_fwd_tc(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
                    const void* init, void* y, void* final_state, void* cb, int B, int nh, int G,
                    int S, int hd, int ds, void* stream) {
  if (B < 1 || B > 65535 || nh < 1 || nh > 65535 || G < 1 || nh % G != 0 || S < 0 ||
      S % kChunk != 0 || (hd != 64 && hd != 128) || (ds != 64 && ds != 128))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (S == 0)  // no chunk: the final state is the initial one, as on the CUDA-core route
    return (int)cudaMemcpyAsync(final_state, init, (size_t)B * nh * hd * ds * sizeof(float),
                                cudaMemcpyDeviceToDevice, s);
  if (hd == 64)
    return ds == 64
               ? launch_tc_heads<1, 1>(x, dt, A, Bm, Cm, init, y, final_state, cb, B, nh, G, S, s)
               : launch_tc_heads<1, 2>(x, dt, A, Bm, Cm, init, y, final_state, cb, B, nh, G, S, s);
  return ds == 64
             ? launch_tc_heads<2, 1>(x, dt, A, Bm, Cm, init, y, final_state, cb, B, nh, G, S, s)
             : launch_tc_heads<2, 2>(x, dt, A, Bm, Cm, init, y, final_state, cb, B, nh, G, S, s);
}

}  // extern "C"
