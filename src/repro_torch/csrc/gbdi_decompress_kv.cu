// GBDI (multi-base B+Delta) KV page decompressor for Hopper (sm_90a).
//
// Replaces the Pallas kernel src/repro/kernels/gbdi_codec.py:215
// `_gbdi_decompress` (body :160, which calls `_decode_page` :129).  One
// page is R rows of D int8 deltas with 4 f32 page bases and, per row, an
// int8 base id and an f32 scale; the output row is d * scale + base[id],
// in f32, with base 0.0 for an id outside 0..3 (the where-chain's
// default).
//
// Bit-exact with the plain PyTorch version (repro_torch/kernels/ref.py
// `decode_pages_ref`): the product is pinned as __fmul_rn and the sum
// as __fadd_rn, the plain version's two rounding steps.  An int8 times
// a power-of-two scale is exact anyway, so a contracted FMA would give
// the same bits; the pinning makes that independent of the compiler.
//
// Bound on the H100: memory.  Per page it reads R*D + 5R + 16 bytes and
// writes R*D*4; about two operations per output word.  Design: one
// block per page; the 4 bases go to shared memory; each thread turns 4
// consecutive deltas (one 4-byte load) into one 16-byte store when D is
// a multiple of 4, else works element by element.  Rows' ids and scales
// are re-read per group from L1.  Several pages per block and wider
// loads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBases = 4;

__device__ __forceinline__ float row_base(const float* base_s, int8_t id) {
  return (id >= 0 && id < kBases) ? base_s[id] : 0.0f;
}

__global__ void __launch_bounds__(kThreads) gbdi_decompress_kv_kernel(
    const int8_t* __restrict__ deltas, const float* __restrict__ bases,
    const int8_t* __restrict__ bid, const float* __restrict__ scale,
    float* __restrict__ out, int rows, int d) {
  __shared__ float base_s[kBases];
  if (threadIdx.x < kBases) {
    base_s[threadIdx.x] =
        bases[static_cast<long long>(blockIdx.x) * kBases + threadIdx.x];
  }
  __syncthreads();
  const long long row0 = static_cast<long long>(blockIdx.x) * rows;
  const int8_t* dp = deltas + row0 * d;
  float* op = out + row0 * d;
  const int n = rows * d;
  if ((d & 3) == 0) {
    const char4* dp4 = reinterpret_cast<const char4*>(dp);
    float4* op4 = reinterpret_cast<float4*>(op);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      const int r = (4 * i) / d;
      const float s = scale[row0 + r];
      const float b = row_base(base_s, bid[row0 + r]);
      const char4 q = dp4[i];
      op4[i] = make_float4(
          __fadd_rn(__fmul_rn(static_cast<float>(q.x), s), b),
          __fadd_rn(__fmul_rn(static_cast<float>(q.y), s), b),
          __fadd_rn(__fmul_rn(static_cast<float>(q.z), s), b),
          __fadd_rn(__fmul_rn(static_cast<float>(q.w), s), b));
    }
  } else {
    for (int i = threadIdx.x; i < n; i += kThreads) {
      const int r = i / d;
      op[i] = __fadd_rn(__fmul_rn(static_cast<float>(dp[i]), scale[row0 + r]),
                        row_base(base_s, bid[row0 + r]));
    }
  }
}

}  // namespace

// deltas i8 [pages * rows, d], bases f32 [pages, 4], bid i8 and scale f32
// [pages * rows] -> out f32 [pages * rows, d], all contiguous on the
// device (16-byte aligned base pointers, as PyTorch allocates them);
// launched on `stream`.  Returns cudaGetLastError().
extern "C" int gbdi_decompress_kv(const void* deltas, const void* bases,
                                  const void* bid, const void* scale,
                                  void* out, long long pages, int rows, int d,
                                  void* stream) {
  if (pages > 0) {
    gbdi_decompress_kv_kernel<<<static_cast<unsigned>(pages), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int8_t*>(deltas), static_cast<const float*>(bases),
        static_cast<const int8_t*>(bid), static_cast<const float*>(scale),
        static_cast<float*>(out), rows, d);
  }
  return static_cast<int>(cudaGetLastError());
}
