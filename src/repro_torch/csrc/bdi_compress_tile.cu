// BDI two-base tile compressor for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/bdi_compress.py:151
// `_bdi_compress` (body :29 `_compress_kernel`).  One tile is one row of
// T floats (T % 8 == 0, T <= 1024).  Each element picks the nearer of two
// bases, the implicit zero and the tile's first element
// (mask = |x - base| < |x|, strict, so an element at exactly base/2
// takes zero); the residuals share the smallest power-of-two scale s
// with max|r| / s <= 127, and deltas = clip(round_half_even(r / s), -127,
// 127) as int8.  The tile's class is ZERO (max|x| == 0; base written as
// +0.0, mask all 0), REP (every x == x[0]; mask all 1) or D8; ZERO and
// REP tiles get deltas 0.  The mask is packed in bit planes: element j
// is bit j / W of byte j % W, W = T / 8.
//
// Bit-exact with the plain PyTorch version (repro_torch/kernels/ref.py
// `compress_ref`), so: the residual is one rounded subtraction and the
// comparison is on it as it is -- for x = 3e38 and base = -3e38 it is
// +inf, and the element keeps the zero base; the scale comes from
// pow2_scale.cuh (bit-built 2^e); divisions are __fdiv_rn, rounding is
// rintf (half to even); no --use_fast_math.  Inputs are finite (the
// contract): then no residual chosen is inf and no NaN arises.
//
// Bound on the H100: memory.  Per tile it reads 4T bytes and writes
// T + T/8 + 12; a few operations per element.  Design: one warp per
// tile, lanes striding the tile so each load is coalesced; the maxima
// are warp shuffle reductions (max is exact, so order does not matter)
// and REP a warp vote; the second pass re-reads the tile from L1 and
// stages the mask bits as bytes in shared memory, from which each lane
// packs whole bytes of the bit planes.  Vectorised loads and several
// tiles per warp are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pow2_scale.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxTile = 1024;
constexpr int kZero = 0, kRep = 1, kD8 = 2;

__global__ void __launch_bounds__(kWarpsPerBlock * 32) bdi_compress_kernel(
    const float* __restrict__ x, int8_t* __restrict__ deltas,
    float* __restrict__ base_out, float* __restrict__ scale_out,
    uint8_t* __restrict__ maskp, int* __restrict__ enc_out, long long n,
    int t) {
  __shared__ uint8_t mask_s[kWarpsPerBlock][kMaxTile];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (row >= n) return;  // whole warps leave together: row is warp-uniform
  const float* xr = x + row * t;
  const float b = xr[0];

  float maxres = 0.0f, maxabs = 0.0f;
  bool rep = true;
  for (int j = lane; j < t; j += 32) {
    const float v = xr[j];
    const float rb = __fsub_rn(v, b);
    const float r = fabsf(rb) < fabsf(v) ? rb : v;
    maxres = fmaxf(maxres, fabsf(r));
    maxabs = fmaxf(maxabs, fabsf(v));
    rep = rep && (v == b);
  }
  for (int off = 16; off > 0; off >>= 1) {
    maxres = fmaxf(maxres, __shfl_xor_sync(0xffffffffu, maxres, off));
    maxabs = fmaxf(maxabs, __shfl_xor_sync(0xffffffffu, maxabs, off));
  }
  const bool is_zero = maxabs == 0.0f;
  const bool is_rep = __all_sync(0xffffffffu, rep) && !is_zero;
  const float s = pow2_scale(maxres);

  int8_t* dr = deltas + row * t;
  uint8_t* ms = mask_s[warp];
  for (int j = lane; j < t; j += 32) {
    const float v = xr[j];
    const float rb = __fsub_rn(v, b);
    bool m = fabsf(rb) < fabsf(v);
    float q = rintf(__fdiv_rn(m ? rb : v, s));
    q = fminf(fmaxf(q, -127.0f), 127.0f);
    if (is_zero || is_rep) {
      q = 0.0f;
      m = is_rep;
    }
    dr[j] = static_cast<int8_t>(static_cast<int>(q));
    ms[j] = m;
  }
  __syncwarp();
  const int w = t >> 3;
  uint8_t* mp = maskp + row * w;
  for (int i = lane; i < w; i += 32) {
    unsigned byte = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      byte |= static_cast<unsigned>(ms[k * w + i]) << k;
    }
    mp[i] = static_cast<uint8_t>(byte);
  }
  if (lane == 0) {
    base_out[row] = is_zero ? 0.0f : b;
    scale_out[row] = s;
    enc_out[row] = is_zero ? kZero : (is_rep ? kRep : kD8);
  }
}

}  // namespace

// x f32 [n, t] -> deltas i8 [n, t], base f32 [n], scale f32 [n], maskp
// u8 [n, t / 8], enc i32 [n], all contiguous on the device; launched on
// `stream`.  Returns cudaGetLastError() (cudaErrorInvalidValue for a t
// this kernel does not take).
extern "C" int bdi_compress(const void* x, void* deltas, void* base,
                            void* scale, void* maskp, void* enc, long long n,
                            int t, void* stream) {
  if (t < 8 || t % 8 != 0 || t > kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bdi_compress_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(deltas),
        static_cast<float*>(base), static_cast<float*>(scale),
        static_cast<uint8_t*>(maskp), static_cast<int*>(enc), n, t);
  }
  return static_cast<int>(cudaGetLastError());
}
