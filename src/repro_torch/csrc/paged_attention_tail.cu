// Decode attention over BDI-compressed KV pages, with or without an f32
// tail, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of src/repro/kernels/paged_attention.py
// that share one body here (the tail step runs when tail_len is given):
// `_paged_attention_tail` (:211, body :95 `_paged_attn_tail_kernel`)
// through the entry point `paged_attention_tail`, and `_paged_attention`
// (:153, body :64 `_paged_attn_kernel`) through `paged_attention`, which
// has no tail step.  Online softmax: :37 `_accumulate`.  For each
// (sequence b, kv head h) it
// attends the G query heads of that group, q f32 [B, KVH, G, D] scaled by
// 1/sqrt(D), over the int8 pages the page table [B, PMAX] names
// (kd/vd i8 [P, KVH, page, D], kb/ks/vb/vs f32 [P, KVH, page], dequant
// d*s + b fused in, `lengths[b]` valid tokens), then over the sequence's
// f32 tail block [B, KVH, page, D] (`tail_len[b]` valid slots) if there
// is one.  The softmax is online in f32, with the Pallas kernel's guards
// so that a block with no valid token never makes a NaN; the output is
// acc / l after the last step, so a sequence with no valid key at all
// gives 0/0 = NaN, as the Pallas kernel and the plain version do.
//
// Bound on the H100: memory.  Per launch it must read
// B*KVH*(len + tail)*(2*D + 16) bytes of pages and tails; the arithmetic
// is 4*G*D flops per key, about 16 per byte at G = 8.  Design of this
// first version: one block per (b, h), so each page is read once for all
// G query heads; the block loads its own page-table entries, dequantises
// one K page and one V page into shared memory (page 16, D 128: 8 KB
// each, K rows padded by one float so the score loop is free of bank
// conflicts), computes the G x page scores, updates the running max and
// sum, and accumulates P V in registers.  Pages past the last valid token
// are skipped: a fully masked block leaves the state unchanged.  Plain
// f32 FMAs, no copy pipelining: B*KVH blocks (32 at B = 8) fill a quarter
// of the SMs.  TMA/wgmma and a split-over-pages variant with a combine
// step are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxAcc = 16;  // outputs per thread: needs G*D <= 2048

__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kd,
    const float* __restrict__ kb, const float* __restrict__ ks,
    const int8_t* __restrict__ vd, const float* __restrict__ vb,
    const float* __restrict__ vs, const int* __restrict__ page_table,
    const int* __restrict__ lengths, const float* __restrict__ tail_k,
    const float* __restrict__ tail_v, const int* __restrict__ tail_len,
    float* __restrict__ out, int kvh, int g, int d, int page, int pmax) {
  extern __shared__ float smem[];
  const int kstride = d + 1;
  float* q_s = smem;                    // [g][d], pre-scaled
  float* k_s = q_s + g * d;             // [page][d + 1]
  float* v_s = k_s + page * kstride;    // [page][d]
  float* p_s = v_s + page * d;          // [g][page] scores -> probabilities
  float* m_s = p_s + g * page;          // [g] running max
  float* l_s = m_s + g;                 // [g] running denominator
  float* a_s = l_s + g;                 // [g] this step's rescale factor

  const int bh = blockIdx.x;
  const int b = bh / kvh;
  const int h = bh - b * kvh;
  const int tid = threadIdx.x;
  const int gd = g * d;

  const float qscale = 1.0f / sqrtf(static_cast<float>(d));
  const float* qb = q + static_cast<long long>(bh) * gd;
  for (int i = tid; i < gd; i += kThreads) q_s[i] = qb[i] * qscale;
  if (tid < g) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.0f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.0f;

  const int len = lengths[b];
  const int npages = min((len + page - 1) / page, pmax);
  const bool has_tail = tail_len != nullptr;
  const int tlen = has_tail ? tail_len[b] : 0;

  for (int p = 0; p < npages + has_tail; ++p) {  // p == npages: the tail
    const bool tail = has_tail && p == npages;
    const int nvalid = tail ? tlen : min(page, len - p * page);
    __syncthreads();  // the previous step is done with k_s, v_s, p_s, a_s
    if (!tail) {
      const long long row0 =
          (static_cast<long long>(page_table[b * pmax + p]) * kvh + h) * page;
      const int8_t* kdp = kd + row0 * d;
      const int8_t* vdp = vd + row0 * d;
      for (int i = tid; i < page * d; i += kThreads) {
        const int t = i / d;
        const int c = i - t * d;
        k_s[t * kstride + c] =
            fmaf(static_cast<float>(kdp[i]), ks[row0 + t], kb[row0 + t]);
        v_s[i] = fmaf(static_cast<float>(vdp[i]), vs[row0 + t], vb[row0 + t]);
      }
    } else {
      const long long off = static_cast<long long>(bh) * page * d;
      for (int i = tid; i < page * d; i += kThreads) {
        const int t = i / d;
        const int c = i - t * d;
        k_s[t * kstride + c] = tail_k[off + i];
        v_s[i] = tail_v[off + i];
      }
    }
    __syncthreads();

    for (int i = tid; i < g * page; i += kThreads) {
      const int gi = i / page;
      const int t = i - gi * page;
      float s = -INFINITY;
      if (t < nvalid) {
        const float* qr = q_s + gi * d;
        const float* kr = k_s + t * kstride;
        float dot = 0.0f;
        for (int c = 0; c < d; ++c) dot = fmaf(qr[c], kr[c], dot);
        s = dot;
      }
      p_s[i] = s;
    }
    __syncthreads();

    if (tid < g) {
      float* pr = p_s + tid * page;
      float mb = -INFINITY;
      for (int t = 0; t < page; ++t) mb = fmaxf(mb, pr[t]);
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, mb);
      // no valid key so far: keep the max at -inf without exp(-inf + inf)
      const float m_safe = (m_new == -INFINITY) ? 0.0f : m_new;
      const float alpha = (m_prev == -INFINITY) ? 0.0f : expf(m_prev - m_safe);
      float sum = 0.0f;
      for (int t = 0; t < page; ++t) {
        const float e = (pr[t] == -INFINITY) ? 0.0f : expf(pr[t] - m_safe);
        pr[t] = e;
        sum += e;
      }
      l_s[tid] = l_s[tid] * alpha + sum;
      m_s[tid] = m_new;
      a_s[tid] = alpha;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < gd) {
        const int gi = i / d;
        const int c = i - gi * d;
        const float* pr = p_s + gi * page;
        float pv = 0.0f;
        for (int t = 0; t < nvalid; ++t) pv = fmaf(pr[t], v_s[t * d + c], pv);
        acc[j] = acc[j] * a_s[gi] + pv;
      }
    }
  }

  float* ob = out + static_cast<long long>(bh) * gd;
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < gd) ob[i] = acc[j] / l_s[i / d];
  }
}

}  // namespace

// All pointers are contiguous device buffers of the shapes above; the
// int arrays are int32.  Launched on `stream`; returns cudaGetLastError()
// (cudaErrorInvalidValue for a G*D this kernel does not take).
extern "C" int paged_attention_tail(
    const void* q, const void* kd, const void* kb, const void* ks,
    const void* vd, const void* vb, const void* vs, const void* page_table,
    const void* lengths, const void* tail_k, const void* tail_v,
    const void* tail_len, void* out, int batch, int kvh, int g, int d,
    int page, int pmax, void* stream) {
  if (g * d > kThreads * kMaxAcc) return static_cast<int>(cudaErrorInvalidValue);
  if (batch * kvh == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(g) * d + page * (d + 1) +
                       page * d + g * page + 3 * g);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(paged_attention_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  paged_attention_kernel<<<batch * kvh, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const int8_t*>(kd),
      static_cast<const float*>(kb), static_cast<const float*>(ks),
      static_cast<const int8_t*>(vd), static_cast<const float*>(vb),
      static_cast<const float*>(vs), static_cast<const int*>(page_table),
      static_cast<const int*>(lengths), static_cast<const float*>(tail_k),
      static_cast<const float*>(tail_v), static_cast<const int*>(tail_len),
      static_cast<float*>(out), kvh, g, d, page, pmax);
  return static_cast<int>(cudaGetLastError());
}

// The same without a tail (the kernel skips the tail step when tail_len
// is null).
extern "C" int paged_attention(const void* q, const void* kd, const void* kb,
                               const void* ks, const void* vd, const void* vb,
                               const void* vs, const void* page_table,
                               const void* lengths, void* out, int batch,
                               int kvh, int g, int d, int page, int pmax,
                               void* stream) {
  return paged_attention_tail(q, kd, kb, ks, vd, vb, vs, page_table, lengths,
                              nullptr, nullptr, nullptr, out, batch, kvh, g, d,
                              page, pmax, stream);
}
