// Decode attention over BDI-compressed KV pages, with or without an f32
// tail, for Hopper (sm_90a): a split over pages (flash-decoding) and a
// combine pass.
//
// Replaces two Pallas kernels of src/repro/kernels/paged_attention.py
// that share one body here: `_paged_attention_tail` (:211, body :95
// `_paged_attn_tail_kernel`) through the entry point
// `paged_attention_tail`, and `_paged_attention` (:153, body :64
// `_paged_attn_kernel`) through `paged_attention`, which has no tail.
// For each (sequence b, kv head h) it attends the G query heads of that
// group, q f32 [B, KVH, G, D] scaled by 1/sqrt(D), over the int8 pages
// the page table [B, PMAX] names (kd/vd i8 [P, KVH, page, D],
// kb/ks/vb/vs f32 [P, KVH, page], dequant d*s + b fused in, `lengths[b]`
// valid tokens), then over the sequence's f32 tail block
// [B, KVH, page, D] (`tail_len[b]` valid slots) if there is one.  The
// softmax keeps the guards of the Pallas kernel's `_accumulate` (:37): a
// block with no valid key keeps its max at -inf and adds nothing, never
// exp(-inf - -inf); a sequence with no valid key at all gives 0/0 = NaN,
// as the Pallas kernel and the plain version do.
//
// Bound on the H100: memory, B*KVH*(len + tail)*(2*D + 16) bytes of
// pages and tails a launch; the arithmetic, 4*G*D flops a key (16 a
// byte at G = 8), is as close behind in f32.  The Pallas kernel walks
// the pages of one (b, h) in order; on the H100 that is B*KVH blocks
// (32 at B = 8) for 132 SMs, each a chain of dependent loads.  So:
//
//   split pass, grid (B*KVH, n_split), 4 warps a block: split s takes the
//     page-table entries [4s, 4s + 4), one page a warp, and the last
//     split is the tail when there is one: n_split = ceil(PMAX/4) +
//     has_tail, from PMAX and never from `lengths` (reading those would
//     sync with the host).  The tail split is scheduled first (its P.V
//     reads V from L2).  A warp loads its page's K and V rows in 16-byte
//     loads (D/16 lanes a row, one load of base and scale a row) before
//     q is staged; dequantises K in registers and reads each query
//     head's columns from shared memory once for all its rows; reduces
//     the G x page scores over D with shuffles; takes the page's softmax
//     (max, exp, sum; two heads a pass of the warp); and accumulates P.V
//     from V staged in shared memory as it came (int8, dequantised as it
//     is read, 4 consecutive columns a lane).  The 4 warps' states are
//     merged in warp order and the split writes its unnormalised state
//     to scratch [B*KVH, n_split, G, D+2] f32, each row (m, l, acc[D]).
//     A split past the last valid token writes m = -inf, l = 0, acc = 0
//     and stops.
//   combine pass, grid (B*KVH, G), thread c on column c: M = max m_s,
//     then out = sum e^(m_s-M) acc_s / sum e^(m_s-M) l_s, the splits
//     walked in index order; a split with m_s = -inf adds exactly 0.
//
// Every sum runs in a fixed order (shuffle trees, warps in order, splits
// in index order) and nothing uses atomics, so two launches on the same
// inputs give the same bits.  Shapes taken: D in {16, 32, 64, 128}, page
// a multiple of 4 up to 16, G*D <= 1024, n_split <= 6000; kd, vd and the
// tails 16-byte aligned.  Plain f32 FMAs, no copy pipelining.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kSplitPages = kWarps;  // table entries a split takes
constexpr int kMaxPage = 16;
constexpr int kMaxGD = 1024;         // G*D: a lane keeps 8 of q, 8 x 4 of acc
constexpr int kMaxSplits = 6000;     // the combine keeps 8 bytes a split
constexpr int kMinBlocks = 5;        // split blocks an SM: 96 registers
constexpr unsigned kFull = 0xffffffffu;

bool shape_ok(int g, int d, int page) {
  return (d == 16 || d == 32 || d == 64 || d == 128) && page >= 4 &&
         page <= kMaxPage && page % 4 == 0 && g >= 1 && g * d <= kMaxGD;
}

// d*s + b for the 4 int8 of `w`.  Each byte goes to a float without the
// quarter-rate int-to-float unit: (d + 128) in the low byte of 2^23's
// bits is the float 2^23 + 128 + d, and subtracting 2^23 + 128 is exact.
__device__ __forceinline__ void dequant4(int w, float s, float b,
                                         float* out) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float f = __uint_as_float(__byte_perm(u, 0x4b000000u, 0x7650u + j));
    out[j] = fmaf(f - 8388736.0f, s, b);
  }
}

__device__ __forceinline__ void dequant16(int4 raw, float s, float b,
                                          float (&out)[16]) {
  dequant4(raw.x, s, b, out);
  dequant4(raw.y, s, b, out + 4);
  dequant4(raw.z, s, b, out + 8);
  dequant4(raw.w, s, b, out + 12);
}

// Index of q[g][c] in shared memory: the 16 columns of a lane's chunk are
// four float4s, sub-chunk i of every chunk side by side, so the lanes of
// one row read consecutive addresses (no bank conflict).
template <int D>
__device__ __forceinline__ int q_index(int g, int c) {
  return g * D + ((c & 15) >> 2) * (D / 4) + (c >> 4) * 4 + (c & 3);
}

// Row layout of a warp's page: lane (r, chunk) holds columns
// [16*chunk, 16*chunk + 16) of rows r + RPI*i, i < kPasses.
template <int D>
struct Rows {
  static constexpr int LPR = D / 16;                  // lanes a row
  static constexpr int RPI = 32 / LPR;                // rows a pass
  static constexpr int kPasses = (kMaxPage + RPI - 1) / RPI;
};

// The G x page scores of a warp's page from K in registers (zeros past
// nvalid): each query head's 16 columns are read from shared memory once
// and serve every row of the lane, GR heads at a time, so that
// GR * kPasses FMA chains and shuffle trees are in flight.
template <int D, int GR>
__device__ __forceinline__ void page_scores(
    const float (&k)[Rows<D>::kPasses][16], int nvalid, int lane, int g,
    int page, const float* q_s, float* s_w) {
  using R = Rows<D>;
  const int r = lane / R::LPR;
  const int chunk = lane % R::LPR;
  for (int g0 = 0; g0 < g; g0 += GR) {
    float part[GR][R::kPasses];
#pragma unroll
    for (int u = 0; u < GR; ++u) {
#pragma unroll
      for (int pi = 0; pi < R::kPasses; ++pi) part[u][pi] = 0.0f;
      if (g0 + u < g) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 qq = *reinterpret_cast<const float4*>(
              q_s + (g0 + u) * D + i * (D / 4) + chunk * 4);
#pragma unroll
          for (int pi = 0; pi < R::kPasses; ++pi) {
            part[u][pi] = fmaf(qq.x, k[pi][4 * i], part[u][pi]);
            part[u][pi] = fmaf(qq.y, k[pi][4 * i + 1], part[u][pi]);
            part[u][pi] = fmaf(qq.z, k[pi][4 * i + 2], part[u][pi]);
            part[u][pi] = fmaf(qq.w, k[pi][4 * i + 3], part[u][pi]);
          }
        }
      }
    }
#pragma unroll
    for (int o = R::LPR / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < GR; ++u)
#pragma unroll
        for (int pi = 0; pi < R::kPasses; ++pi)
          part[u][pi] += __shfl_xor_sync(kFull, part[u][pi], o);
    if (chunk == 0) {
#pragma unroll
      for (int u = 0; u < GR; ++u)
#pragma unroll
        for (int pi = 0; pi < R::kPasses; ++pi) {
          const int t = pi * R::RPI + r;
          if (g0 + u < g && t < nvalid) s_w[(g0 + u) * page + t] = part[u][pi];
        }
    }
  }
}

// A compressed page's K and V rows as this lane loads them: every load
// of the page is issued before any math (and before q is staged).
template <int D>
struct PageRegs {
  using R = Rows<D>;
  int4 kr[R::kPasses], vr[R::kPasses];
  float kb[R::kPasses], ks[R::kPasses], vb[R::kPasses], vs[R::kPasses];

  __device__ __forceinline__ void load(
      const int8_t* __restrict__ kd, const float* __restrict__ kbp,
      const float* __restrict__ ksp, const int8_t* __restrict__ vd,
      const float* __restrict__ vbp, const float* __restrict__ vsp,
      long long row0, int nvalid, int lane) {
    const int r = lane / R::LPR;
    const int chunk = lane % R::LPR;
#pragma unroll
    for (int pi = 0; pi < R::kPasses; ++pi) {
      const int t = pi * R::RPI + r;
      kr[pi] = vr[pi] = make_int4(0, 0, 0, 0);
      kb[pi] = ks[pi] = vb[pi] = vs[pi] = 0.0f;
      if (t < nvalid) {
        const long long row = row0 + t;
        kr[pi] = __ldg(reinterpret_cast<const int4*>(kd + row * D) + chunk);
        vr[pi] = __ldg(reinterpret_cast<const int4*>(vd + row * D) + chunk);
        kb[pi] = __ldg(kbp + row);
        ks[pi] = __ldg(ksp + row);
        vb[pi] = __ldg(vbp + row);
        vs[pi] = __ldg(vsp + row);
      }
    }
  }

  // Stage V as it came (int8, then base and scale; zeros past nvalid:
  // P.V steps 4 rows), dequantise K, take the scores.
  template <int GR>
  __device__ __forceinline__ void rows(int nvalid, int lane, int g, int page,
                                       const float* q_s, int8_t* vr_w,
                                       float2* vsb_w, float* s_w) const {
    const int r = lane / R::LPR;
    const int chunk = lane % R::LPR;
    float k[R::kPasses][16];
#pragma unroll
    for (int pi = 0; pi < R::kPasses; ++pi) {
      const int t = pi * R::RPI + r;
      if (t < page) {
        *reinterpret_cast<int4*>(vr_w + t * D + chunk * 16) = vr[pi];
        if (chunk == 0) vsb_w[t] = make_float2(vs[pi], vb[pi]);
      }
      dequant16(kr[pi], ks[pi], kb[pi], k[pi]);
    }
    page_scores<D, GR>(k, nvalid, lane, g, page, q_s, s_w);
  }
};

// The f32 tail block of (b, h): K rows at tk + t*D (V is read in P.V).
template <int D, int GR>
__device__ __forceinline__ void tail_rows(const float* __restrict__ tk,
                                          int nvalid, int lane, int g,
                                          int page, const float* q_s,
                                          float* s_w) {
  using R = Rows<D>;
  const int r = lane / R::LPR;
  const int chunk = lane % R::LPR;
  float k[R::kPasses][16];
#pragma unroll
  for (int pi = 0; pi < R::kPasses; ++pi) {
    const int t = pi * R::RPI + r;
    const float4* kp =
        reinterpret_cast<const float4*>(tk + t * D + chunk * 16);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = t < nvalid ? __ldg(kp + i)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      k[pi][4 * i] = a.x, k[pi][4 * i + 1] = a.y, k[pi][4 * i + 2] = a.z,
      k[pi][4 * i + 3] = a.w;
    }
  }
  page_scores<D, GR>(k, nvalid, lane, g, page, q_s, s_w);
}

// The page's softmax, two query heads at a time (lanes 16*h + t on key t
// of head h; page <= 16), GR heads a group: s_w turns from scores into
// e^(s - m), 0 past nvalid; m_w and l_w take the max and sum.
template <int GR>
__device__ __forceinline__ void page_softmax(int nvalid, int lane, int g,
                                             int page, float* s_w,
                                             float* m_w, float* l_w) {
  constexpr int NP = (GR + 1) / 2;  // pairs of heads a group
  const int half = lane >> 4;
  const int t = lane & 15;
  for (int g0 = 0; g0 < g; g0 += 2 * NP) {
    float s[NP], mb[NP], sum[NP];
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int gg = g0 + 2 * u + half;
      s[u] = (gg < g && t < nvalid) ? s_w[gg * page + t] : -INFINITY;
      mb[u] = s[u];
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < NP; ++u)
        mb[u] = fmaxf(mb[u], __shfl_xor_sync(kFull, mb[u], o));
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      // no valid key: keep the max at -inf without exp(-inf - -inf)
      const float m_safe = (mb[u] == -INFINITY) ? 0.0f : mb[u];
      s[u] = (s[u] == -INFINITY) ? 0.0f : expf(s[u] - m_safe);
      sum[u] = s[u];
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < NP; ++u)
        sum[u] += __shfl_xor_sync(kFull, sum[u], o);
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int gg = g0 + 2 * u + half;
      if (gg < g) {
        if (t < page) s_w[gg * page + t] = s[u];
        if (t == 0) {
          m_w[gg] = mb[u];
          l_w[gg] = sum[u];
        }
      }
    }
  }
}

// Shared memory of a split block, in floats: q, the warps' V pages
// (int8, then base and scale) and scores, which the warps' acc overlay
// for the merge once every warp is done with them; then m and l.
template <int D>
__host__ __device__ __forceinline__ int split_smem_floats(int g, int page) {
  const int work = g * D + kWarps * (page * D / 4 + 2 * page + g * page);
  const int merge = kWarps * g * D;
  return (work > merge ? work : merge) + 2 * kWarps * g;
}

// G > 0: the query heads a kv head, known at compile time; 0: g_rt.
template <int D, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks) split_kernel(
    const float* __restrict__ q, const int8_t* __restrict__ kd,
    const float* __restrict__ kb, const float* __restrict__ ks,
    const int8_t* __restrict__ vd, const float* __restrict__ vb,
    const float* __restrict__ vs, const int* __restrict__ page_table,
    const int* __restrict__ lengths, const float* __restrict__ tail_k,
    const float* __restrict__ tail_v, const int* __restrict__ tail_len,
    float* __restrict__ scratch, int kvh, int g_rt, int page, int pmax,
    int n_split) {
  extern __shared__ __align__(16) float smem[];
  const int g = G > 0 ? G : g_rt;
  constexpr int GR = G == 0 ? 1 : (G < 2 ? G : 2);  // heads a score group
  constexpr int SG = G == 0 ? 4 : (G < 8 ? G : 8);  // heads a softmax group
  const int gd = g * D;
  float* q_s = smem;                   // [g][D], laid out by q_index
  float* vsb_f = q_s + gd + kWarps * page * D / 4;
  int8_t* vr_all = reinterpret_cast<int8_t*>(q_s + gd);  // [kWarps][page][D]
  float2* vsb_all = reinterpret_cast<float2*>(vsb_f);    // [kWarps][page]
  float* s_all = vsb_f + 2 * kWarps * page;   // [kWarps][g][page]
  float* mbuf = smem;                          // [kWarps][g*D], the merge
  const int nsm = split_smem_floats<D>(g, page);
  float* m_all = smem + nsm - 2 * kWarps * g;       // [kWarps][g]
  float* l_all = m_all + kWarps * g;                // [kWarps][g]

  const int bh = blockIdx.x;
  // the tail (the last split) runs first: its P.V reads V from L2, and a
  // block scheduled last would end the launch late
  const bool has_tail = tail_len != nullptr;
  const int split = has_tail ? (blockIdx.y == 0 ? n_split - 1 : blockIdx.y - 1)
                             : blockIdx.y;
  const int b = bh / kvh;
  const int h = bh - b * kvh;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // q, the lengths and this warp's table entry in one round of loads
  const float* qb = q + static_cast<long long>(bh) * gd;
  constexpr int kQ = kMaxGD / kThreads;
  float qv[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * kThreads;
    qv[k] = i < gd ? __ldg(qb + i) : 0.0f;
  }
  const bool is_tail = has_tail && split == n_split - 1;
  const int p = split * kSplitPages + warp;
  const int len = lengths[b];
  const int tlen = is_tail ? min(tail_len[b], page) : 0;
  const int pid = (!is_tail && p < pmax) ? page_table[b * pmax + p] : 0;
  const int npages = len <= 0 ? 0 : min((len + page - 1) / page, pmax);
  float* dst = scratch + (static_cast<long long>(bh) * n_split + split) *
                             g * (D + 2);
  if (is_tail ? tlen <= 0 : split * kSplitPages >= npages) {
    for (int i = tid; i < g * (D + 2); i += kThreads)
      dst[i] = (i % (D + 2) == 0) ? -INFINITY : 0.0f;
    return;
  }
  int nvalid = 0;
  if (is_tail)
    nvalid = warp == 0 ? tlen : 0;
  else if (p < npages)
    nvalid = min(page, len - p * page);
  PageRegs<D> regs;
  if (!is_tail)
    regs.load(kd, kb, ks, vd, vb, vs,
              (static_cast<long long>(pid) * kvh + h) * page, nvalid, lane);

  const float qscale = 1.0f / sqrtf(static_cast<float>(D));
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * kThreads;
    if (i < gd) q_s[q_index<D>(i / D, i % D)] = qv[k] * qscale;
  }
  __syncthreads();

  int8_t* vr_w = vr_all + warp * page * D;
  float2* vsb_w = vsb_all + warp * page;
  float* s_w = s_all + warp * g * page;
  float* m_w = m_all + warp * g;
  float* l_w = l_all + warp * g;
  const long long toff = static_cast<long long>(bh) * page * D;
  // Every warp runs the same code (the shuffles must not sit under a
  // branch that depends on the warp); one with no valid key (nvalid 0)
  // ends with m = -inf, l = 0 and acc = 0.
  if (is_tail)
    tail_rows<D, GR>(tail_k + toff, nvalid, lane, g, page, q_s, s_w);
  else
    regs.template rows<GR>(nvalid, lane, g, page, q_s, vr_w, vsb_w, s_w);
  __syncwarp();
  page_softmax<SG>(nvalid, lane, g, page, s_w, m_w, l_w);
  __syncwarp();

  // P.V, 4 keys a step.  This lane holds 4 consecutive columns `col` of
  // query heads j*GPS + gsub (slot j), so one 4-byte load of V serves
  // every slot.
  constexpr int LPG = D / 4;           // lanes a query head
  constexpr int GPS = 32 / LPG;        // query heads a slot
  constexpr int kSlots = kMaxGD / 128;
  const int col = 4 * (lane % LPG);
  const int gsub = lane / LPG;
  const int nslot = (gd + 127) / 128;
  float acc[kSlots][4];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
  for (int t4 = 0; t4 < nvalid; t4 += 4) {
    float v[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int t = t4 + r;
      if (is_tail) {
        const float4 x =
            t < nvalid ? __ldg(reinterpret_cast<const float4*>(
                             tail_v + toff + t * D + col))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        v[r][0] = x.x, v[r][1] = x.y, v[r][2] = x.z, v[r][3] = x.w;
      } else {
        const float2 sb = vsb_w[t];
        dequant4(*reinterpret_cast<const int*>(vr_w + t * D + col), sb.x,
                 sb.y, v[r]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      if (j < nslot) {
        const int gj = min(j * GPS + gsub, g - 1);  // past g: never stored
        const float4 pp =
            *reinterpret_cast<const float4*>(s_w + gj * page + t4);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          acc[j][c] = fmaf(pp.x, v[0][c], acc[j][c]);
          acc[j][c] = fmaf(pp.y, v[1][c], acc[j][c]);
          acc[j][c] = fmaf(pp.z, v[2][c], acc[j][c]);
          acc[j][c] = fmaf(pp.w, v[3][c], acc[j][c]);
        }
      }
  }
  __syncthreads();  // every warp is done with q, V and the scores
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = (j * GPS + gsub) * D + col;
    if (j < nslot && e < gd)
      *reinterpret_cast<float4*>(mbuf + warp * gd + e) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();

  // merge the warps' states in warp order: first each query head's max,
  // sum and per-warp factors (m_all turns into the factors), then acc
  if (tid < g) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_all[w * g + tid]);
    float l = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_all[w * g + tid];
      const float sc = (mw == -INFINITY) ? 0.0f : expf(mw - m);
      l = fmaf(sc, l_all[w * g + tid], l);
      m_all[w * g + tid] = sc;
    }
    dst[tid * (D + 2)] = m;
    dst[tid * (D + 2) + 1] = l;
  }
  __syncthreads();
  for (int e = tid; e < gd; e += kThreads) {
    const int gi = e / D;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a = fmaf(m_all[w * g + gi], mbuf[w * gd + e], a);
    dst[gi * (D + 2) + 2 + (e - gi * D)] = a;
  }
}

// One block a (b*KVH + h, query head): the splits' weights e^(m_s - M)
// and l_s go to shared memory, then thread c walks the splits in index
// order for column c, kBatch loads at a time; the first batch is loaded
// with the m_s, before M is known.
template <int D>
__global__ void __launch_bounds__(kThreads) combine_kernel(
    const float* __restrict__ scratch, float* __restrict__ out, int n_split) {
  constexpr int kBatch = 72;  // one round of loads up to PMAX 284
  extern __shared__ float w_s[];       // [n_split] weights
  float* l_s = w_s + n_split;          // [n_split] sums
  __shared__ float red[kWarps];
  const int bh = blockIdx.x;
  const int gi = blockIdx.y;
  const int g = gridDim.y;
  const int tid = threadIdx.x;
  const long long stride = static_cast<long long>(g) * (D + 2);
  const float* base =
      scratch + (static_cast<long long>(bh) * n_split * g + gi) * (D + 2);
  float a[kBatch];
#pragma unroll
  for (int u = 0; u < kBatch; ++u)
    a[u] = (tid < D && u < n_split) ? base[u * stride + 2 + tid] : 0.0f;
  float m = -INFINITY;
  for (int s = tid; s < n_split; s += kThreads) {
    const float ms = base[s * stride];
    w_s[s] = ms;
    l_s[s] = base[s * stride + 1];
    m = fmaxf(m, ms);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m = fmaxf(m, red[w]);
  for (int s = tid; s < n_split; s += kThreads) {
    const float ms = w_s[s];
    w_s[s] = (ms == -INFINITY) ? 0.0f : expf(ms - m);  // adds exactly 0
  }
  __syncthreads();
  if (tid >= D) return;
  float num = 0.0f, den = 0.0f;
  for (int s0 = 0; s0 < n_split; s0 += kBatch) {  // index order
    if (s0 > 0) {
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        a[u] = s0 + u < n_split ? base[(s0 + u) * stride + 2 + tid] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (s0 + u < n_split) {
        num = fmaf(w_s[s0 + u], a[u], num);
        den = fmaf(w_s[s0 + u], l_s[s0 + u], den);
      }
  }
  out[(static_cast<long long>(bh) * g + gi) * D + tid] = num / den;
}

template <int D>
int launch(const void* q, const void* kd, const void* kb, const void* ks,
           const void* vd, const void* vb, const void* vs,
           const void* page_table, const void* lengths, const void* tail_k,
           const void* tail_v, const void* tail_len, void* out,
           void* scratch, int bkvh, int kvh, int g, int page, int pmax,
           int n_split, cudaStream_t stream) {
  const size_t smem = sizeof(float) * split_smem_floats<D>(g, page);
  if (n_split > 0) {
    const dim3 grid(bkvh, n_split);
    auto split = split_kernel<D, 0>;
    switch (g) {
      case 1: split = split_kernel<D, 1>; break;
      case 2: split = split_kernel<D, 2>; break;
      case 4: split = split_kernel<D, 4>; break;
      case 8: split = split_kernel<D, 8>; break;
      default: break;
    }
    split<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(kd),
        static_cast<const float*>(kb), static_cast<const float*>(ks),
        static_cast<const int8_t*>(vd), static_cast<const float*>(vb),
        static_cast<const float*>(vs), static_cast<const int*>(page_table),
        static_cast<const int*>(lengths), static_cast<const float*>(tail_k),
        static_cast<const float*>(tail_v), static_cast<const int*>(tail_len),
        static_cast<float*>(scratch), kvh, g, page, pmax, n_split);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  combine_kernel<D><<<dim3(bkvh, g), kThreads, 2 * sizeof(float) * n_split,
                      stream>>>(static_cast<const float*>(scratch),
                                static_cast<float*>(out), n_split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// All pointers are contiguous device buffers of the shapes above; the
// int arrays are int32; scratch is f32 [B*KVH, n_split, G, D+2] with
// n_split = ceil(pmax/4) + (tail_len != null).  Two launches on
// `stream`; returns cudaGetLastError() after them (cudaErrorInvalidValue
// for a shape this kernel does not take or a wrong n_split).
extern "C" int paged_attention_tail(
    const void* q, const void* kd, const void* kb, const void* ks,
    const void* vd, const void* vb, const void* vs, const void* page_table,
    const void* lengths, const void* tail_k, const void* tail_v,
    const void* tail_len, void* out, void* scratch, int batch, int kvh,
    int g, int d, int page, int pmax, int n_split, void* stream) {
  const int want = (pmax + kSplitPages - 1) / kSplitPages +
                   (tail_len != nullptr ? 1 : 0);
  if (!shape_ok(g, d, page) || pmax < 0 || n_split != want ||
      n_split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bkvh = batch * kvh;
  if (bkvh == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16:
      return launch<16>(q, kd, kb, ks, vd, vb, vs, page_table, lengths,
                        tail_k, tail_v, tail_len, out, scratch, bkvh, kvh, g,
                        page, pmax, n_split, st);
    case 32:
      return launch<32>(q, kd, kb, ks, vd, vb, vs, page_table, lengths,
                        tail_k, tail_v, tail_len, out, scratch, bkvh, kvh, g,
                        page, pmax, n_split, st);
    case 64:
      return launch<64>(q, kd, kb, ks, vd, vb, vs, page_table, lengths,
                        tail_k, tail_v, tail_len, out, scratch, bkvh, kvh, g,
                        page, pmax, n_split, st);
    default:
      return launch<128>(q, kd, kb, ks, vd, vb, vs, page_table, lengths,
                         tail_k, tail_v, tail_len, out, scratch, bkvh, kvh,
                         g, page, pmax, n_split, st);
  }
}

// The same without a tail (n_split = ceil(pmax/4)).
extern "C" int paged_attention(const void* q, const void* kd, const void* kb,
                               const void* ks, const void* vd, const void* vb,
                               const void* vs, const void* page_table,
                               const void* lengths, void* out, void* scratch,
                               int batch, int kvh, int g, int d, int page,
                               int pmax, int n_split, void* stream) {
  return paged_attention_tail(q, kd, kb, ks, vd, vb, vs, page_table, lengths,
                              nullptr, nullptr, nullptr, out, scratch, batch,
                              kvh, g, d, page, pmax, n_split, stream);
}
