// The fused uplink codec kernels on the packed (rows, n) cohort buffer, for
// Hopper (sm_90a). Each replaces one Pallas TPU kernel of
// repro/kernels/fedcore/kernel.py:
//
//   topk_mask_ef   <- topk_mask_ef  (_topk_mask_ef_kernel)
//     kept = |x| >= t_row ? x : 0;  resid = x - kept (x where dropped)
//   sr_bf16        <- sr_bf16       (_sr_bf16_kernel)
//     out = high half of ((bits(x) + noise) & 0xFFFF0000), as bf16
//   int8_quant     <- int8_quant    (_int8_quant_kernel)
//     q = clamp(round_half_even(x / scale[row, leaf]), -127, 127) as int8
//   int8_dequant   <- int8_dequant  (_int8_dequant_kernel)
//     out = q * scale[row, leaf]
//
// Bound: memory. Each is one elementwise pass with a few operations per
// element (bytes per element: top-k 12, sr_bf16 10, quant 5, dequant 5), far
// below the card's operations-per-byte ridge. The design only streams, in a
// grid-stride loop with no shared memory: each thread takes 4 neighbouring
// elements (a 16-byte float4 of the f32 stream) at a time; the int8 pair,
// whose int8 side moves only 4 bytes a group, takes 4 such groups at block
// stride so that every thread keeps 4 coalesced loads in flight.
//
// The TPU kernels run once per client (vmap) and, for int8, once per leaf.
// Here one launch covers the whole cohort: rows are clients, the threshold
// is a (rows,) vector, and the int8 scale is a (rows, leaves) table indexed
// through the leaves' offsets in the packed row, so the 13 leaves of
// photon-75m cost one launch instead of 13 per client. Positions past the
// last leaf (the zero padding to the 8192-element block) quantize to 0 and
// dequantize to 0.0.
//
// Numerics are the plain versions' bit for bit: IEEE division (__fdiv_rn,
// whatever the flags), rintf (round half to even, as jnp.round / torch.round),
// explicit _rn operations so nothing contracts into an FMA, and for sr_bf16
// pure integer work. A bf16 pattern that is a NaN becomes the canonical quiet
// NaN with its sign kept (0x7FC0 | sign), as XLA's f32 -> bf16 convert gives.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int64_t first_index() {
  return (int64_t)blockIdx.x * kThreads + threadIdx.x;
}

__device__ __forceinline__ int64_t grid_stride() { return (int64_t)gridDim.x * kThreads; }

// ---- top-k mask + error feedback -----------------------------------------

// resid = x - kept: x - x where kept, x itself where dropped (x - 0 bit for
// bit, except that a NaN keeps its payload, as the plain version's select)
__device__ __forceinline__ void mask_ef(float x, float t, float* kept, float* resid) {
  const bool keep = fabsf(x) >= t;
  *kept = keep ? x : 0.f;
  *resid = keep ? __fsub_rn(x, x) : x;
}

__global__ void __launch_bounds__(kThreads) topk_mask_ef_kernel(
    const float4* __restrict__ xf, const float* __restrict__ thresh, float4* __restrict__ kept,
    float4* __restrict__ resid, int64_t row4, int64_t total4) {
  for (int64_t i = first_index(); i < total4; i += grid_stride()) {
    const float t = __ldg(thresh + i / row4);
    const float4 x = __ldcs(xf + i);
    float4 k, r;
    mask_ef(x.x, t, &k.x, &r.x);
    mask_ef(x.y, t, &k.y, &r.y);
    mask_ef(x.z, t, &k.z, &r.z);
    mask_ef(x.w, t, &k.w, &r.w);
    __stcs(kept + i, k);
    __stcs(resid + i, r);
  }
}

// ---- stochastic rounding to bf16 ------------------------------------------

__device__ __forceinline__ uint32_t sr_one(float x, uint32_t noise) {
  const uint32_t hi = ((__float_as_uint(x) + noise) & 0xFFFF0000u) >> 16;
  const bool nan = (hi & 0x7F80u) == 0x7F80u && (hi & 0x007Fu) != 0u;
  return nan ? ((hi & 0x8000u) | 0x7FC0u) : hi;
}

__global__ void __launch_bounds__(kThreads) sr_bf16_kernel(
    const float4* __restrict__ x, const uint4* __restrict__ noise, uint2* __restrict__ out,
    int64_t total4) {
  for (int64_t i = first_index(); i < total4; i += grid_stride()) {
    const float4 v = __ldcs(x + i);
    const uint4 z = __ldcs(noise + i);
    uint2 o;
    o.x = sr_one(v.x, z.x) | (sr_one(v.y, z.y) << 16);
    o.y = sr_one(v.z, z.z) | (sr_one(v.w, z.w) << 16);
    __stcs(out + i, o);
  }
}

// ---- per-(row, leaf) int8 quantization ------------------------------------

// The leaf holding row position `pos`: the last l with offsets[l] <= pos, or
// -1 past offsets[n_leaves] (the padding). offsets has n_leaves + 1 entries.
__device__ __forceinline__ int leaf_of(const long long* __restrict__ offsets, int n_leaves,
                                       int64_t pos) {
  if (pos >= __ldg(offsets + n_leaves)) return -1;
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(offsets + mid) <= pos) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// x / scale rounded half to even and clamped to [-127, 127]; 0 for a NaN (the
// saturating f32 -> int8 convert of XLA).
__device__ __forceinline__ signed char quant(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (r != r) return 0;
  return (signed char)(int)fminf(fmaxf(r, -127.f), 127.f);
}

// Each thread takes kUnroll groups of 4 elements at block stride (one float4
// and one char4 each), so a warp's every access is coalesced and a thread
// keeps kUnroll loads in flight. The thread remembers the leaf range
// [lo, hi) of its last lookup: a group inside it reuses the scale, and only
// a group in another leaf, or straddling a boundary, searches the offsets.
constexpr int kUnroll = 4;
constexpr int64_t kNoEnd = 0x7FFFFFFFFFFFFFFF;  // the padding's range runs to the row's end

struct LeafCache {
  int64_t row = -1, lo = 0, hi = 0;
  float scale = 0.f;
};

// Scales of the 4 elements at [pos, pos + 4) of `row`; `pad` marks those past
// the last leaf (their q is 0 and dequantizes to 0.0).
__device__ __forceinline__ void scales4(const float* __restrict__ scales,
                                        const long long* __restrict__ offsets, int n_leaves,
                                        int64_t row, int64_t pos, LeafCache* c, float s[4],
                                        bool pad[4]) {
  if (row != c->row || pos < c->lo || pos + 4 > c->hi) {
    const int l = leaf_of(offsets, n_leaves, pos);
    c->row = row;
    if (l < 0) {
      c->lo = __ldg(offsets + n_leaves);
      c->hi = kNoEnd;
      c->scale = 0.f;
    } else {
      c->lo = __ldg(offsets + l);
      c->hi = __ldg(offsets + l + 1);
      c->scale = __ldg(scales + row * n_leaves + l);
    }
  }
  if (pos + 4 <= c->hi) {  // all four in the cached range
    const bool p = c->hi == kNoEnd;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      s[k] = c->scale;
      pad[k] = p;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // a leaf boundary inside the group
    const int l = leaf_of(offsets, n_leaves, pos + k);
    pad[k] = l < 0;
    s[k] = l < 0 ? 0.f : __ldg(scales + row * n_leaves + l);
  }
}

__global__ void __launch_bounds__(kThreads) int8_quant_kernel(
    const float4* __restrict__ x, const float* __restrict__ scales,
    const long long* __restrict__ offsets, int n_leaves, char4* __restrict__ q, int64_t row4,
    int64_t total4) {
  LeafCache cache;
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x; base < total4;
       base += step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * kThreads;
      if (i < total4) v[u] = __ldcs(x + i);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * kThreads;
      if (i >= total4) break;
      const int64_t row = i / row4, pos = (i - row * row4) * 4;
      float s[4];
      bool pad[4];
      scales4(scales, offsets, n_leaves, row, pos, &cache, s, pad);
      char4 o;
      o.x = pad[0] ? 0 : quant(v[u].x, s[0]);
      o.y = pad[1] ? 0 : quant(v[u].y, s[1]);
      o.z = pad[2] ? 0 : quant(v[u].z, s[2]);
      o.w = pad[3] ? 0 : quant(v[u].w, s[3]);
      q[i] = o;
    }
  }
}

__global__ void __launch_bounds__(kThreads) int8_dequant_kernel(
    const char4* __restrict__ q, const float* __restrict__ scales,
    const long long* __restrict__ offsets, int n_leaves, float4* __restrict__ out, int64_t row4,
    int64_t total4) {
  LeafCache cache;
  const int64_t step = (int64_t)gridDim.x * kThreads * kUnroll;
  for (int64_t base = (int64_t)blockIdx.x * kThreads * kUnroll + threadIdx.x; base < total4;
       base += step) {
    char4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * kThreads;
      if (i < total4) v[u] = q[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + (int64_t)u * kThreads;
      if (i >= total4) break;
      const int64_t row = i / row4, pos = (i - row * row4) * 4;
      float s[4];
      bool pad[4];
      scales4(scales, offsets, n_leaves, row, pos, &cache, s, pad);
      __stcs(out + i, make_float4(pad[0] ? 0.f : __fmul_rn((float)v[u].x, s[0]),
                                  pad[1] ? 0.f : __fmul_rn((float)v[u].y, s[1]),
                                  pad[2] ? 0.f : __fmul_rn((float)v[u].z, s[2]),
                                  pad[3] ? 0.f : __fmul_rn((float)v[u].w, s[3])));
    }
  }
}

int grid_for(int64_t total4, int max_grid) {
  const int64_t want = (total4 + kThreads - 1) / kThreads;
  return (int)(want < 1 ? 1 : (want > max_grid ? max_grid : want));
}

}  // namespace

extern "C" {

// Every buffer is (rows, n) row-major and contiguous, n a multiple of 4 and
// every pointer 16-byte aligned (the int8 and bf16 ones 4- and 8-byte).
// Each function returns cudaGetLastError() after its one launch; max_grid
// caps the grid-stride grid.

// xf (rows, n) f32; thresh (rows,) f32 -> kept, resid (rows, n) f32.
int fedcore_topk_mask_ef(const float* xf, const float* thresh, float* kept, float* resid,
                         long long rows, long long n, int max_grid, void* stream) {
  if (rows < 1 || n < 4 || n % 4 != 0 || max_grid < 1) return (int)cudaErrorInvalidValue;
  const int64_t row4 = n / 4, total4 = rows * row4;
  topk_mask_ef_kernel<<<grid_for(total4, max_grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(xf), thresh, reinterpret_cast<float4*>(kept),
      reinterpret_cast<float4*>(resid), row4, total4);
  return (int)cudaGetLastError();
}

// x (total,) f32; noise (total,) u32 in [0, 2^16) -> out (total,) bf16 bits.
int fedcore_sr_bf16(const float* x, const uint32_t* noise, uint16_t* out, long long total,
                    int max_grid, void* stream) {
  if (total < 4 || total % 4 != 0 || max_grid < 1) return (int)cudaErrorInvalidValue;
  const int64_t total4 = total / 4;
  sr_bf16_kernel<<<grid_for(total4, max_grid), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const uint4*>(noise),
      reinterpret_cast<uint2*>(out), total4);
  return (int)cudaGetLastError();
}

// x (rows, n) f32; scales (rows, n_leaves) f32; offsets (n_leaves + 1,) i64,
// ascending, offsets[0] = 0, offsets[n_leaves] <= n -> q (rows, n) i8.
int fedcore_int8_quant(const float* x, const float* scales, const long long* offsets,
                       int n_leaves, int8_t* q, long long rows, long long n, int max_grid,
                       void* stream) {
  if (rows < 1 || n < 4 || n % 4 != 0 || n_leaves < 1 || max_grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t row4 = n / 4, total4 = rows * row4;
  int8_quant_kernel<<<grid_for((total4 + kUnroll - 1) / kUnroll, max_grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), scales, offsets, n_leaves,
      reinterpret_cast<char4*>(q), row4, total4);
  return (int)cudaGetLastError();
}

// q (rows, n) i8; scales, offsets as for fedcore_int8_quant -> out (rows, n) f32.
int fedcore_int8_dequant(const int8_t* q, const float* scales, const long long* offsets,
                         int n_leaves, float* out, long long rows, long long n, int max_grid,
                         void* stream) {
  if (rows < 1 || n < 4 || n % 4 != 0 || n_leaves < 1 || max_grid < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const int64_t row4 = n / 4, total4 = rows * row4;
  int8_dequant_kernel<<<grid_for((total4 + kUnroll - 1) / kUnroll, max_grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const char4*>(q), scales, offsets, n_leaves,
      reinterpret_cast<float4*>(out), row4, total4);
  return (int)cudaGetLastError();
}

}  // extern "C"
