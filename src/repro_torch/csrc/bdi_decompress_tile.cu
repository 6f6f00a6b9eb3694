// BDI two-base tile decompressor for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/bdi_decompress.py:55
// `_bdi_decompress` (body :26 `_decompress_kernel`): the thesis' masked
// vector add, out[n, j] = delta[n, j] * scale[n] + mask[n, j] * base[n],
// with the mask unpacked from its bit planes (element j is bit j / W of
// byte j % W, W = T / 8) in registers.
//
// Bit-exact with the plain PyTorch version (repro_torch/kernels/ref.py
// `decompress_ref`): the mask term is a product, not a select (the two
// differ on a base of +-inf or NaN), and both products and the sum are
// pinned as __fmul_rn / __fadd_rn, the plain version's three rounding
// steps -- nvcc would otherwise contract d*s + m*b into an FMA, which is
// exact today only because d*s is exact for a power-of-two scale.
//
// Bound on the H100: memory.  Per tile it reads T + T/8 + 8 bytes and
// writes 4T; about three operations per output word.  Design: one thread
// per 4 consecutive elements of a tile, one 4-byte delta load and one
// 16-byte store; the tile's base, scale and mask bytes come through L1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float masked_fma(int8_t d, float s, float m,
                                            float b) {
  return __fadd_rn(__fmul_rn(static_cast<float>(d), s), __fmul_rn(m, b));
}

__global__ void __launch_bounds__(kThreads) bdi_decompress_kernel(
    const int8_t* __restrict__ deltas, const float* __restrict__ base,
    const float* __restrict__ scale, const uint8_t* __restrict__ maskp,
    float* __restrict__ out, long long groups, int t) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (i >= groups) return;
  const int tq = t >> 2;                         // groups of 4 per tile
  const long long row = i / tq;
  const int j0 = static_cast<int>(i - row * tq) * 4;
  const int w = t >> 3;
  const float s = scale[row];
  const float b = base[row];
  const uint8_t* mp = maskp + row * w;
  float m[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = j0 + k;
    m[k] = static_cast<float>((mp[j % w] >> (j / w)) & 1);
  }
  const char4 q = reinterpret_cast<const char4*>(deltas)[i];
  reinterpret_cast<float4*>(out)[i] =
      make_float4(masked_fma(q.x, s, m[0], b), masked_fma(q.y, s, m[1], b),
                  masked_fma(q.z, s, m[2], b), masked_fma(q.w, s, m[3], b));
}

}  // namespace

// deltas i8 [n, t], base f32 [n], scale f32 [n], maskp u8 [n, t / 8] ->
// out f32 [n, t], all contiguous on the device (deltas 4-byte and out
// 16-byte aligned, as PyTorch allocates them); launched on `stream`.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a t this kernel
// does not take).
extern "C" int bdi_decompress(const void* deltas, const void* base,
                              const void* scale, const void* maskp, void* out,
                              long long n, int t, void* stream) {
  if (t < 8 || t % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = n * (t / 4);
  if (groups > 0) {
    const long long blocks = (groups + kThreads - 1) / kThreads;
    bdi_decompress_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(deltas), static_cast<const float*>(base),
        static_cast<const float*>(scale),
        static_cast<const uint8_t*>(maskp), static_cast<float*>(out), groups,
        t);
  }
  return static_cast<int>(cudaGetLastError());
}
