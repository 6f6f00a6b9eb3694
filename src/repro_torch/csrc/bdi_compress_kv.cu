// BDI single-base KV row codec for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/bdi_compress.py:116
// `_bdi_compress_kv` (body :75 `_compress_kv_kernel`).  One row is one
// (kv head, token) vector of a KV page: base = the row's first element,
// scale = the smallest power of two s with max|x - base| / s <= 127, and
// deltas = clip(round_half_even((x - base) / s), -127, 127) as int8.
//
// The output must be bit-exact with the plain PyTorch version
// (repro_torch/kernels/ref.py `compress_rows`), so:
//   * the scale comes from the exponent bits of maxres / 127 by integer
//     arithmetic and is built from bits (never frexpf/log2f/exp2f), as
//     the plain version builds it: the subnormal ratio gives e = -126, a
//     ratio that underflowed to 0 (maxres > 0) the subnormal 2^-127, e =
//     128 inf, and maxres == 0 gives 1.0;
//   * every division is a true IEEE division (__fdiv_rn), and rounding is
//     half to even (rintf) -- CUDA roundf rounds halves away from zero;
//   * the file is built without --use_fast_math, so subnormals survive.
//
// Bound on the H100: memory.  It reads N*D*4 bytes and writes N*D + 8N;
// the arithmetic is a few operations per byte.  Design: one warp per row,
// lanes striding the row so each load instruction is coalesced; the max
// is a warp shuffle reduction (max is exact, so order does not matter);
// the second pass re-reads the row, which the first pass left in L1.
// Vectorised 16-byte loads and several rows per warp are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pow2_scale.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void bdi_compress_kv_kernel(const float* __restrict__ x,
                                       int8_t* __restrict__ deltas,
                                       float* __restrict__ base,
                                       float* __restrict__ scale,
                                       long long n, int d) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps leave together: row is warp-uniform
  const float* xr = x + row * d;
  const float b = xr[0];

  float m = 0.0f;
  for (int j = lane; j < d; j += 32) {
    m = fmaxf(m, fabsf(__fsub_rn(xr[j], b)));
  }
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  const float s = pow2_scale(m);

  int8_t* dr = deltas + row * d;
  for (int j = lane; j < d; j += 32) {
    float q = rintf(__fdiv_rn(__fsub_rn(xr[j], b), s));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    dr[j] = static_cast<int8_t>(static_cast<int>(q));
  }
  if (lane == 0) {
    base[row] = b;
    scale[row] = s;
  }
}

}  // namespace

// x f32 [n, d] -> deltas i8 [n, d], base f32 [n], scale f32 [n], all
// contiguous on the device; launched on `stream`.  Returns
// cudaGetLastError() so the caller sees a refused launch.
extern "C" int bdi_compress_kv(const void* x, void* deltas, void* base,
                               void* scale, long long n, int d,
                               void* stream) {
  if (n > 0) {
    const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bdi_compress_kv_kernel<<<static_cast<unsigned>(blocks),
                             kWarpsPerBlock * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(deltas),
        static_cast<float*>(base), static_cast<float*>(scale), n, d);
  }
  return static_cast<int>(cudaGetLastError());
}
