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
// pow2_scale.cuh (bit-built 2^e); rounding is half to even; no
// --use_fast_math.  Inputs are finite (the contract): then no residual
// chosen is inf and no NaN arises.
//
// Bound on the H100: memory.  Per tile it reads 4T bytes and writes
// T + T/8 + 12.  Two instances, chosen by the launcher:
//
//   T = 128 (the tile path's only length, core/bdi_value.py TILE), x
//     16-byte aligned: a warp takes 4 consecutive tiles and issues their
//     loads first, one 16-byte load a lane a tile (lane L holds elements
//     4L..4L+3), so 2 KB a warp are in flight and the values stay in
//     registers: one read, no second pass.  The max residual is a
//     shuffle reduction, ZERO and REP are votes.  r / s is r times the
//     exact reciprocal 2^-e (pow2_recip: the same bits, as both round
//     r * 2^-e once), rounded half to even by adding 1.5 * 2^23, whose
//     low byte is then the int8 delta; a lane stores its 4 deltas as one
//     word (128 coalesced bytes a tile).  The bit-plane mask comes from
//     four ballots, no shared memory: with W = 16, byte b holds bit
//     4p + b/4 of ballot (b % 4) as its bit p, so lanes 0-3 each gather
//     four bytes and store them as one word.
//   any other T (a multiple of 8 up to 1024): one warp a tile, lanes
//     striding it with 4-byte loads, the maxima shuffle reductions, a
//     second pass over the tile (from L1) with IEEE division, the mask
//     bits staged a byte an element in shared memory and packed from
//     there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "pow2_scale.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxTile = 1024;
constexpr int kTilesPerWarp = 4;     // T = 128: tiles whose loads go first
constexpr int kZero = 0, kRep = 1, kD8 = 2;
constexpr unsigned kFull = 0xffffffffu;

// Bits 0, 4, ..., 28 of x gathered into bits 0..7.
__device__ __forceinline__ unsigned every_fourth_bit(unsigned x) {
  x &= 0x11111111u;
  x = (x | (x >> 3)) & 0x03030303u;
  x = (x | (x >> 6)) & 0x000F000Fu;
  return (x | (x >> 12)) & 0xFFu;
}

// The int8 delta of residual r at reciprocal scale inv, in the low byte:
// clip(r * inv) + 1.5 * 2^23 rounds half to even at unit precision and
// leaves the integer's two's complement in the low mantissa bits.
__device__ __forceinline__ unsigned delta_byte(float r, float inv) {
  const float q = fminf(fmaxf(__fmul_rn(r, inv), -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(q, 12582912.0f));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32) bdi_compress128_kernel(
    const float4* __restrict__ x, unsigned* __restrict__ deltas,
    float* __restrict__ base_out, float* __restrict__ scale_out,
    unsigned* __restrict__ maskp, int* __restrict__ enc_out, long long n) {
  const int lane = threadIdx.x & 31;
  const long long tile0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock +
       (threadIdx.x >> 5)) * kTilesPerWarp;
  if (tile0 >= n) return;  // whole warps leave together
  float4 buf[kTilesPerWarp];
#pragma unroll
  for (int i = 0; i < kTilesPerWarp; ++i)
    buf[i] = tile0 + i < n ? __ldg(x + (tile0 + i) * 32 + lane)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int i = 0; i < kTilesPerWarp; ++i) {
    const long long row = tile0 + i;
    if (row >= n) break;     // warp-uniform
    const float v[4] = {buf[i].x, buf[i].y, buf[i].z, buf[i].w};
    const float b = __shfl_sync(kFull, v[0], 0);
    float r[4];
    bool m[4];
    float maxres = 0.0f;
    bool rep = true, zero = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float rb = __fsub_rn(v[k], b);
      m[k] = fabsf(rb) < fabsf(v[k]);
      r[k] = m[k] ? rb : v[k];
      maxres = fmaxf(maxres, fabsf(r[k]));
      rep = rep && (v[k] == b);
      zero = zero && (v[k] == 0.0f);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      maxres = fmaxf(maxres, __shfl_xor_sync(kFull, maxres, off));
    const bool is_zero = __all_sync(kFull, zero);
    const bool is_rep = __all_sync(kFull, rep) && !is_zero;
    const float s = pow2_scale(maxres);
    const float inv = pow2_recip(s);
    unsigned word = __byte_perm(
        __byte_perm(delta_byte(r[0], inv), delta_byte(r[1], inv), 0x0040),
        __byte_perm(delta_byte(r[2], inv), delta_byte(r[3], inv), 0x0040),
        0x5410);
    unsigned bal[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      bal[k] = __ballot_sync(kFull, is_rep || (m[k] && !is_zero));
    if (is_zero || is_rep) word = 0;
    deltas[row * 32 + lane] = word;
    if (lane < 4) {
      // bytes 4*lane + k, k < 4: bit p is bit 4p + lane of ballot k
      unsigned mw = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        mw |= every_fourth_bit(bal[k] >> lane) << (8 * k);
      maskp[row * 4 + lane] = mw;
    }
    if (lane == 0) {
      base_out[row] = is_zero ? 0.0f : b;
      scale_out[row] = s;
      enc_out[row] = is_zero ? kZero : (is_rep ? kRep : kD8);
    }
  }
}

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
    maxres = fmaxf(maxres, __shfl_xor_sync(kFull, maxres, off));
    maxabs = fmaxf(maxabs, __shfl_xor_sync(kFull, maxabs, off));
  }
  const bool is_zero = maxabs == 0.0f;
  const bool is_rep = __all_sync(kFull, rep) && !is_zero;
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
// `stream`.  t = 128 with x 16-byte aligned (and deltas and maskp 4-byte
// aligned) takes the 128 instance, any other t the generic one.  Returns
// cudaGetLastError() (cudaErrorInvalidValue for a t this kernel does not
// take).
extern "C" int bdi_compress(const void* x, void* deltas, void* base,
                            void* scale, void* maskp, void* enc, long long n,
                            int t, void* stream) {
  if (t < 8 || t % 8 != 0 || t > kMaxTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(deltas) % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(maskp) % 4 == 0;
  if (n > 0 && t == 128 && aligned) {
    constexpr long long kTiles = kWarpsPerBlock * kTilesPerWarp;
    const long long blocks = (n + kTiles - 1) / kTiles;
    bdi_compress128_kernel<<<static_cast<unsigned>(blocks),
                             kWarpsPerBlock * 32, 0, st>>>(
        static_cast<const float4*>(x), static_cast<unsigned*>(deltas),
        static_cast<float*>(base), static_cast<float*>(scale),
        static_cast<unsigned*>(maskp), static_cast<int*>(enc), n);
  } else if (n > 0) {
    const long long blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    bdi_compress_kernel<<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32,
                          0, st>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(deltas),
        static_cast<float*>(base), static_cast<float*>(scale),
        static_cast<uint8_t*>(maskp), static_cast<int*>(enc), n, t);
  }
  return static_cast<int>(cudaGetLastError());
}
