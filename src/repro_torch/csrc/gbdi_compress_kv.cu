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
//     in bdi_compress_kv.cu; divisions are __fdiv_rn (or, in the staged
//     instance, products with the exact reciprocal), rounding half to
//     even;
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
// R*D + 6R + 16; a few operations per byte.  One block of 8 warps per
// page; two instances, chosen by the launcher:
//
//   staged (D % 4 == 0, x 16-byte aligned, the page and 8 bytes a row
//     within the block's shared memory: 33 KB at yi-6b, R 64 x D 128;
//     172 KB at gemma3-27b's R 256 x D 168): every thread copies 16-byte
//     pieces of the contiguous page into shared memory with cp.async, in
//     one round, and every pass then reads shared memory.  Pass 1 reduces
//     the anchors' min/max across the block; pass 2 gives each row 8
//     lanes (a warp takes 4 rows at a time), which pick the row's base
//     and reduce its max residual over float4s with 3 shuffles; pass 3
//     takes the page max; pass 4 writes each row's deltas 4 to a word,
//     r / s as r times the exact reciprocal 2^-e (pow2_recip: the same
//     bits, NaN and inf included) rounded half to even by adding 1.5 *
//     2^23, and the width tag from a ballot of the row's 8 lanes.
//   generic (any other shape): one warp per row at a time with lanes
//     striding the row, reading x from global memory in each pass (pass
//     4 re-reads the row from L1/L2), IEEE division, one-byte stores.
//
// Per-row state lives in dynamic shared memory (8 bytes a row).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pow2_scale.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBases = 4;
constexpr int kRowLanes = 8;           // staged: lanes a row
constexpr int kStaticSmem = 1024;      // staged: room for the static arrays
constexpr unsigned kFull = 0xffffffffu;

// NaN-propagating max/min (torch.amax / torch.amin semantics): a NaN
// on either side is returned, since a NaN `b` fails both comparisons
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// max / min over the lanes that differ in the bits below `width`
__device__ __forceinline__ float lanes_max(float m, int width = 32) {
  for (int off = width / 2; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(kFull, m, off));
  return m;
}
__device__ __forceinline__ float lanes_min(float m) {
  for (int off = 16; off > 0; off >>= 1)
    m = nan_min(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

// Pass 1's end: the block's anchor min and max (every thread's lo, hi)
// -> the page's 4 bases in base_s and in bases_out.
__device__ __forceinline__ void page_bases(float lo, float hi, float* red_a,
                                           float* red_b, float* base_s,
                                           float* bases_out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  lo = lanes_min(lo);
  hi = lanes_max(hi);
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
      bases_out[static_cast<long long>(blockIdx.x) * kBases + j] = base_s[j];
    }
  }
  __syncthreads();
}

// The first nearest base of anchor a (strict `<` chain).
__device__ __forceinline__ int nearest_base(float a, const float* base_s) {
  float best = fabsf(__fsub_rn(a, base_s[0]));
  int b = 0;
  for (int j = 1; j < kBases; ++j) {
    const float dist = fabsf(__fsub_rn(a, base_s[j]));
    if (dist < best) {
      best = dist;
      b = j;
    }
  }
  return b;
}

// Pass 3: the page's max residual over maxr[rows] -> its pow2 scale.
__device__ __forceinline__ float page_scale_of(const float* maxr, int rows,
                                               float* red_a,
                                               float* scale_s) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float m = 0.0f;
  for (int r = threadIdx.x; r < rows; r += kThreads) m = nan_max(m, maxr[r]);
  m = lanes_max(m);
  if (lane == 0) red_a[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float pm = red_a[0];
    for (int w = 1; w < kWarps; ++w) pm = nan_max(pm, red_a[w]);
    *scale_s = pow2_scale(pm);
  }
  __syncthreads();
  return *scale_s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// Staged instance (D % 4 == 0): the page in shared memory, 8 lanes a row.
__global__ void __launch_bounds__(kThreads, 4) gbdi_compress_staged_kernel(
    const float* __restrict__ x, int8_t* __restrict__ deltas,
    float* __restrict__ bases, int8_t* __restrict__ bid_out,
    float* __restrict__ scale_out, int8_t* __restrict__ wid_out, int rows,
    int d) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red_a[kWarps], red_b[kWarps];
  __shared__ float base_s[kBases];
  __shared__ float scale_s;
  const int ng = d >> 2;                                // float4s a row
  float* xs = smem;                                     // [rows][d]
  float* maxr = xs + rows * d;                          // [rows]
  int* bid_s = reinterpret_cast<int*>(maxr + rows);     // [rows]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;

  // the page, contiguous, in one round of 16-byte copies
  const float4* xp = reinterpret_cast<const float4*>(x + row0 * d);
  float4* xs4 = reinterpret_cast<float4*>(xs);
  for (int i = threadIdx.x; i < rows * ng; i += kThreads)
    cp_async16(xs4 + i, xp + i);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // pass 1: min and max of the anchors x[r, 0]
  float lo = INFINITY, hi = -INFINITY;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    lo = nan_min(lo, xs[r * d]);
    hi = nan_max(hi, xs[r * d]);
  }
  page_bases(lo, hi, red_a, red_b, base_s, bases);

  // pass 2: per row, the first nearest base and the max |residual|; a
  // warp takes rows 4 at a time, lane (sub, l8) on float4s l8 + 8i of
  // row r0 + sub; every lane runs the shuffles
  const int sub = lane / kRowLanes;
  const int l8 = lane % kRowLanes;
  constexpr int kStep = kWarps * (32 / kRowLanes);
  for (int r0 = warp * (32 / kRowLanes); r0 < rows; r0 += kStep) {
    const int r = r0 + sub;
    const bool valid = r < rows;
    float m = 0.0f;
    int b = 0;
    if (valid) {
      b = nearest_base(xs[r * d], base_s);
      const float base = base_s[b];
      for (int c = l8; c < ng; c += kRowLanes) {
        const float4 v = xs4[r * ng + c];
        m = nan_max(m, fabsf(__fsub_rn(v.x, base)));
        m = nan_max(m, fabsf(__fsub_rn(v.y, base)));
        m = nan_max(m, fabsf(__fsub_rn(v.z, base)));
        m = nan_max(m, fabsf(__fsub_rn(v.w, base)));
      }
    }
    m = lanes_max(m, kRowLanes);
    if (valid && l8 == 0) {
      maxr[r] = m;
      bid_s[r] = b;
    }
  }
  __syncthreads();

  // pass 3: the page's max residual -> page scale
  const float ps = page_scale_of(maxr, rows, red_a, &scale_s);

  // pass 4: scale, deltas 4 to a word, and the width tag per row
  for (int r0 = warp * (32 / kRowLanes); r0 < rows; r0 += kStep) {
    const int r = r0 + sub;
    const bool valid = r < rows;
    bool nonzero = false;
    bool fits4 = false;
    float s = 1.0f;
    int b = 0;
    if (valid) {
      b = bid_s[r];
      const float base = base_s[b];
      const float mr = maxr[r];
      fits4 = mr <= __fmul_rn(7.0f, ps);
      s = fits4 ? ps : pow2_scale(mr);
      const float inv = pow2_recip(s);
      unsigned* dr = reinterpret_cast<unsigned*>(deltas + (row0 + r) * d);
      for (int c = l8; c < ng; c += kRowLanes) {
        const float4 v = xs4[r * ng + c];
        const float e[4] = {v.x, v.y, v.z, v.w};
        unsigned by[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float q = __fmul_rn(__fsub_rn(e[k], base), inv);
          // NaN: delta 0 (int8(NaN)), and the row counts as nonzero
          const float qc = q == q ? fminf(fmaxf(q, -127.0f), 127.0f) : 0.0f;
          by[k] = __float_as_uint(__fadd_rn(qc, 12582912.0f));
          nonzero |= (q != q) || (by[k] & 0xFFu) != 0;
        }
        dr[c] = __byte_perm(__byte_perm(by[0], by[1], 0x0040),
                            __byte_perm(by[2], by[3], 0x0040), 0x5410);
      }
    }
    const unsigned any = __ballot_sync(kFull, nonzero);
    if (valid && l8 == 0) {
      const long long gr = row0 + r;
      const bool row_any = (any >> (sub * kRowLanes)) & 0xFFu;
      bid_out[gr] = static_cast<int8_t>(b);
      scale_out[gr] = s;
      wid_out[gr] = static_cast<int8_t>(row_any ? (fits4 ? 1 : 2) : 0);
    }
  }
}

// Generic instance: one warp per row at a time, x from global memory.
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
  __shared__ float scale_s;

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
  page_bases(lo, hi, red_a, red_b, base_s, bases);

  // pass 2: per row, the first nearest base and the max |residual|
  for (int r = warp; r < rows; r += kWarps) {
    const float* xr = xp + static_cast<long long>(r) * d;
    const int b = nearest_base(xr[0], base_s);
    const float base = base_s[b];
    float m = 0.0f;
    for (int c = lane; c < d; c += 32) {
      const float res = fabsf(__fsub_rn(xr[c], base));
      m = nan_max(m, res);
    }
    m = lanes_max(m);
    if (lane == 0) {
      maxr[r] = m;
      bid_s[r] = b;
    }
  }
  __syncthreads();

  // pass 3: the page's max residual -> page scale
  const float ps = page_scale_of(maxr, rows, red_a, &scale_s);

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
    nonzero = __any_sync(kFull, nonzero);
    if (lane == 0) {
      bid_out[gr] = static_cast<int8_t>(b);
      scale_out[gr] = s;
      wid_out[gr] = static_cast<int8_t>(nonzero ? (fits4 ? 1 : 2) : 0);
    }
  }
}

// Dynamic shared memory the staged instance may take: the device's
// opt-in limit less room for the static arrays, granted once.
int staged_smem_limit() {
  static const int limit = [] {
    int dev = 0, bytes = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&bytes,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess ||
        cudaFuncSetAttribute(gbdi_compress_staged_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes - kStaticSmem) != cudaSuccess) {
      cudaGetLastError();   // clear it: the generic instance runs instead
      return 0;
    }
    return bytes - kStaticSmem;
  }();
  return limit;
}

}  // namespace

// x f32 [pages * rows, d] -> deltas i8 [pages * rows, d], bases f32
// [pages, 4], base id i8, scale f32 and width i8 [pages * rows], all
// contiguous on the device; launched on `stream`.  The staged instance
// takes d % 4 == 0, x 16-byte aligned, deltas 4-byte aligned and a page
// (plus 8 bytes a row) within the opt-in shared memory; any other shape
// runs the generic one.  Returns cudaGetLastError() so the caller sees a
// refused launch.
extern "C" int gbdi_compress_kv(const void* x, void* deltas, void* bases,
                                void* bid, void* scale, void* wid,
                                long long pages, int rows, int d,
                                void* stream) {
  if (pages <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t staged =
      static_cast<size_t>(rows) * d * sizeof(float) + static_cast<size_t>(rows) * 8;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(deltas) % 4 == 0;
  if (d % 4 == 0 && aligned &&
      staged <= static_cast<size_t>(staged_smem_limit())) {
    gbdi_compress_staged_kernel<<<static_cast<unsigned>(pages), kThreads,
                                  staged, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(deltas),
        static_cast<float*>(bases), static_cast<int8_t*>(bid),
        static_cast<float*>(scale), static_cast<int8_t*>(wid), rows, d);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(rows) * 8;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(gbdi_compress_kv_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  gbdi_compress_kv_kernel<<<static_cast<unsigned>(pages), kThreads, smem,
                            st>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(deltas),
      static_cast<float*>(bases), static_cast<int8_t*>(bid),
      static_cast<float*>(scale), static_cast<int8_t*>(wid), rows, d);
  return static_cast<int>(cudaGetLastError());
}
