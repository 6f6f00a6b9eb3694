// GBDI (multi-base B+Delta) KV page compressor for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/gbdi_codec.py:177
// `_gbdi_compress` (body :151, which calls `_encode_page` :82).  One page
// is R = KVH * page rows of D f32 values.  Per page: K = 4 bases on the
// dyadic lattice amin + (amax - amin) * {0, 1/4, 1/2, 1} over the rows'
// first elements; per row: the first nearest base (strict `<` chain),
// residuals against it, a pow2 scale -- the page's when the row's max
// residual fits 4 signed bits at it, else the row's own -- int8 deltas
// clip(round_half_even(r / scale), -127, 127), and a width tag (0 all
// deltas zero, 1 four-bit, 2 eight-bit).
//
// The output is bit-exact with the plain PyTorch version
// (repro_torch/kernels/ref.py `encode_pages_ref`), so:
//   * the lattice is a separate multiply and add (__fmul_rn, __fadd_rn),
//     as PyTorch computes it; multiplying by a power of two is exact, so
//     this also equals the JAX function's bits, contracted or not;
//   * pow2 scales come from exponent bits and are built from bits, as
//     in bdi_compress_kv.cu; divisions are __fdiv_rn, rounding rintf;
//   * every max/min reduction propagates NaN, as torch.amax/amin do: an
//     anchor span that overflows to inf makes base 0 `amin + inf * 0`,
//     a NaN, and the page must still encode as the plain version does
//     (bid 0, scale 1, deltas int8(NaN) = 0, width 2).  NaN in the
//     input itself is outside the contract (its payload bits are not
//     promised); the checks use none;
//   * the clip keeps NaN (fminf/fmaxf would turn it into -127), and the
//     float -> int conversion maps NaN to 0, as PyTorch's does on CUDA;
//   * no --use_fast_math (subnormal residuals must survive).
//
// Bound on the H100: memory.  Per page it reads R*D*4 bytes and writes
// R*D + 6R + 16; a few operations per byte.  Design: one block of 8
// warps per page, one warp per row at a time with lanes striding the
// row (coalesced).  Pass 1 reduces the anchors' min/max across the
// block, pass 2 finds each row's base and max residual (warp shuffle),
// pass 3 the page max, pass 4 re-reads the row (32 KB per page at
// yi-6b: L1/L2 hits) and writes deltas.  Per-row state lives in dynamic
// shared memory (8 bytes a row).  Vectorised loads, keeping the page in
// registers, and several pages per block are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pow2_scale.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBases = 4;

// NaN-propagating max/min (torch.amax / torch.amin semantics): a NaN
// on either side is returned, since a NaN `b` fails both comparisons
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

__device__ __forceinline__ float warp_max(float m) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, m, off);
    m = nan_max(m, o);
  }
  return m;
}

__device__ __forceinline__ float warp_min(float m) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, m, off);
    m = nan_min(m, o);
  }
  return m;
}

__global__ void __launch_bounds__(kThreads) gbdi_compress_kv_kernel(
    const float* __restrict__ x, int8_t* __restrict__ deltas,
    float* __restrict__ bases, int8_t* __restrict__ bid_out,
    float* __restrict__ scale_out, int8_t* __restrict__ wid_out, int rows,
    int d) {
  extern __shared__ float smem[];
  float* maxr = smem;                                   // [rows]
  int* bid_s = reinterpret_cast<int*>(smem + rows);     // [rows]
  __shared__ float red_a[kWarps], red_b[kWarps];
  __shared__ float base_s[kBases];
  __shared__ float page_scale;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const float* xp = x + row0 * d;

  // pass 1: min and max of the anchors x[r, 0]
  float lo = INFINITY, hi = -INFINITY;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const float a = xp[static_cast<long long>(r) * d];
    lo = nan_min(lo, a);
    hi = nan_max(hi, a);
  }
  lo = warp_min(lo);
  hi = warp_max(hi);
  if (lane == 0) {
    red_a[warp] = lo;
    red_b[warp] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float amin = red_a[0], amax = red_b[0];
    for (int w = 1; w < kWarps; ++w) {
      amin = nan_min(amin, red_a[w]);
      amax = nan_max(amax, red_b[w]);
    }
    const float span = __fsub_rn(amax, amin);
    const float frac[kBases] = {0.0f, 0.25f, 0.5f, 1.0f};
    for (int j = 0; j < kBases; ++j) {
      base_s[j] = __fadd_rn(amin, __fmul_rn(span, frac[j]));
      bases[static_cast<long long>(blockIdx.x) * kBases + j] = base_s[j];
    }
  }
  __syncthreads();

  // pass 2: per row, the first nearest base and the max |residual|
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = xp + static_cast<long long>(r) * d;
    const float a = xr[0];
    float best = fabsf(__fsub_rn(a, base_s[0]));
    int b = 0;
    for (int j = 1; j < kBases; ++j) {
      const float dist = fabsf(__fsub_rn(a, base_s[j]));
      if (dist < best) {
        best = dist;
        b = j;
      }
    }
    const float base = base_s[b];
    float m = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float res = fabsf(__fsub_rn(xr[c], base));
      m = nan_max(m, res);
    }
    m = warp_max(m);
    if (lane == 0) {
      maxr[r] = m;
      bid_s[r] = b;
    }
  }
  __syncthreads();

  // pass 3: the page's max residual -> page scale
  float m = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    m = nan_max(m, maxr[r]);
  }
  m = warp_max(m);
  if (lane == 0) red_a[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float pm = red_a[0];
    for (int w = 1; w < kWarps; ++w) pm = nan_max(pm, red_a[w]);
    page_scale = pow2_scale(pm);
  }
  __syncthreads();
  const float ps = page_scale;

  // pass 4: scale, deltas and width tag per row
  for (int r = warp; r < rows; r += kWarps) {
    const long long gr = row0 + r;
    const float* xr = x + gr * d;
    const int b = bid_s[r];
    const float base = base_s[b];
    const float mr = maxr[r];
    const bool fits4 = mr <= __fmul_rn(7.0f, ps);
    const float s = fits4 ? ps : pow2_scale(mr);
    int8_t* dr = deltas + gr * d;
    bool nonzero = false;
    for (int c = lane; c < d; c += 32) {
      float q = rintf(__fdiv_rn(__fsub_rn(xr[c], base), s));
      if (q == q) q = fminf(fmaxf(q, -127.0f), 127.0f);  // keep NaN
      nonzero |= (q != 0.0f);                            // NaN counts
      dr[c] = static_cast<int8_t>(static_cast<int>(q));  // NaN -> 0
    }
    nonzero = __any_sync(0xffffffffu, nonzero);
    if (lane == 0) {
      bid_out[gr] = static_cast<int8_t>(b);
      scale_out[gr] = s;
      wid_out[gr] = static_cast<int8_t>(nonzero ? (fits4 ? 1 : 2) : 0);
    }
  }
}

}  // namespace

// x f32 [pages * rows, d] -> deltas i8 [pages * rows, d], bases f32
// [pages, 4], base id i8, scale f32 and width i8 [pages * rows], all
// contiguous on the device; launched on `stream`.  Returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int gbdi_compress_kv(const void* x, void* deltas, void* bases,
                                void* bid, void* scale, void* wid,
                                long long pages, int rows, int d,
                                void* stream) {
  if (pages > 0) {
    const size_t smem = static_cast<size_t>(rows) * 8;
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(gbdi_compress_kv_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(smem));
    }
    gbdi_compress_kv_kernel<<<static_cast<unsigned>(pages), kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(deltas),
        static_cast<float*>(bases), static_cast<int8_t*>(bid),
        static_cast<float*>(scale), static_cast<int8_t*>(wid), rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}
