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
//   split pass, grid (B*KVH, n_split, head groups), 4 warps a block.  A
//     warp takes a slot of up to 16 rows in the sequence's row space,
//     looked up page by page: a page of `page` rows is ceil(page / 16)
//     slots rounded up to a power of two, so that a slot's page and row
//     are shifts of its index; the last slots are partial or empty where
//     16 does not divide the page (a page of 8 is one slot of 8, of 36
//     four of 16, 16, 4 and 0, of 128 eight), and a split takes 4
//     consecutive slots, whichever pages they lie in (4 pages up to 16
//     rows, 2 up to 32, one at 64, half of one at 128).  The tail (the
//     sequence's f32 block of `page` rows) is as many slots more, in
//     ceil(slots / 4) splits after the pages': n_split = ceil(PMAX *
//     slots / 4) + tail splits, from PMAX and never from
//     `lengths` (reading those would sync with the host).  The tail
//     splits are scheduled first (their P.V reads V from L2).  Rows past
//     the page or past the valid tokens are masked: a slot's score and V
//     rows are padded to a multiple of 4 (P.V takes 4 keys a step) with
//     zero weights.  A warp loads its slot's K and V rows before q is
//     staged: at D 16, 32, 64 and 128 in 16-byte loads (D/16 lanes a row,
//     one load of base and scale a row), K dequantised in registers and
//     each query head's columns read from shared memory once for all the
//     lane's rows, the G x 16 scores reduced over D with shuffles.  Any
//     other D that is a multiple of 4 up to 256 (e.g. 168; its int8 rows
//     are only 4- or 8-byte aligned) runs the generic instance: lane L
//     loads the 4-column groups L and L + 32 of every row in 4-byte
//     loads, K's base and scale come from lane t for row t, and the 16
//     rows' partial dots are folded across the warp in 16 shuffles a head
//     (after the fold, lanes 2t and 2t+1 hold row t's score).  Then the
//     slot's softmax (max, exp, sum; two heads a pass of the warp) and P.V
//     from V staged in shared memory as it came (int8, dequantised as it
//     is read, 4 consecutive columns a lane).  The 4 warps' states are
//     merged in warp order and the split writes its unnormalised state to
//     scratch [B*KVH, n_split, G, D+2] f32, each row (m, l, acc[D]).  A
//     split past the last valid token writes m = -inf, l = 0, acc = 0 and
//     stops.
//   byte rows, any other D (not a multiple of 4, or over 256): the same
//     slots, splits and scratch, a plain body.  q is read from global
//     memory, K and V byte by byte (lane L on columns L, L + 32, ...),
//     the 16 rows' partial dots folded as in the generic instance, and
//     P.V accumulated in shared memory over column chunks of at most
//     1024 / G' columns, each merged over the warps before the next.
//   head groups: a lane keeps G*D / 128 x 4 accumulators up to G*D =
//     1024, so the G query heads of a kv head are cut into groups of G'
//     heads, G' = ceil(G / ceil(G / floor(1024 / D))) (at most 128; 64 on
//     the byte path), one grid row each, each with its own rows of the
//     scratch.  K/V are then read once a group (G 16 at D 128: two groups
//     of 8 on the G = 8 instance).
//   combine pass, grid (B*KVH, G, column blocks), thread c on column c
//     (128 threads, 256 for the generic D and the byte rows): M = max
//     m_s, then out = sum e^(m_s-M) acc_s / sum e^(m_s-M) l_s, the splits
//     walked in index order in chunks of 4096, each chunk's weights and
//     sums in shared memory, M the running max: num and den are rescaled
//     by e^(M_old - M_new) where a chunk raises it (one chunk, no
//     rescale, up to 4096 splits); a split with m_s = -inf adds exactly
//     0.
//
// Every sum runs in a fixed order (shuffle trees, warps in order, splits
// in index order) and nothing uses atomics, so two launches on the same
// inputs give the same bits.  Shapes taken (`shape_ok`): any G, D and page
// of at least 1 and PMAX of at least 0; kd, vd and the tails 16-byte
// aligned.  A warp's slot stays at 16 rows, so large pages cost the D 128
// instance no registers.  Plain f32 FMAs, no copy pipelining.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kWarpRows = 16;        // rows a warp takes (its slot)
constexpr int kMaxD = 256;           // generic D: lane groups L and L + 32
constexpr int kMaxGD = 1024;         // G'*D: a lane keeps 8 of q, 8 x 4 of acc
constexpr int kMaxGroup = 128;       // query heads a group
constexpr int kMaxGroupBytes = 64;   // on the byte path (scores in smem)
constexpr int kChunk = 4096;         // splits a combine chunk
constexpr int kMaxGridY = 65535;
constexpr int kMinBlocks = 5;        // split blocks an SM: 96 registers
constexpr int kMinBlocksAnyD = 4;    // the generic D keeps 64 loads in flight
constexpr unsigned kFull = 0xffffffffu;

bool shape_ok(int g, int d, int page) { return g >= 1 && d >= 1 && page >= 1; }

// The fast instances' D: a multiple of 4 up to 256 (16-, 8- or 4-byte
// loads of int8 rows); any other D takes the byte rows.
bool word_rows(int d) { return d % 4 == 0 && d <= kMaxD; }

// log2 of the 16-row slots a page: ceil(page / 16) rounded up to a power
// of two, so that a slot's page and row are shifts of its index (a
// division by a value known only at run time, or a branch around one,
// costs the short split blocks of a decode step a few percent); the
// last slots are partial or empty where 16 does not divide the page.
int slot_shift(int page) {
  int s = 0;
  while ((kWarpRows << s) < page) ++s;
  return s;
}

int slots_per_page(int page) { return 1 << slot_shift(page); }

// Splits over the pages (4 slots each) and over the tail.
int main_splits(int pmax, int page) {
  return static_cast<int>((static_cast<long long>(pmax) *
                               slots_per_page(page) + kWarps - 1) / kWarps);
}
int tail_splits(int page) { return (slots_per_page(page) + kWarps - 1) / kWarps; }

// Query heads a group: as many as keep G'*D within kMaxGD (at least one,
// at most `cap`), then the groups evened out.
int group_heads(int g, int d, int cap) {
  int per = kMaxGD / d;
  per = per < 1 ? 1 : (per > cap ? cap : per);
  const int groups = (g + per - 1) / per;
  return (g + groups - 1) / groups;
}

// A padded slot: rows rounded up to a multiple of 4 (P.V takes 4 keys a
// step; the padding has zero weight).
__host__ __device__ __forceinline__ int padded_rows(int page) {
  const int rw = page < kWarpRows ? page : kWarpRows;
  return (rw + 3) & ~3;
}

// Where a warp's slot lies: split index (the tail splits, the last
// n_split - n_main, are scheduled first), its rows and how many are valid.
struct Slot {
  int split;
  bool is_tail;
  bool empty;        // the whole split is past the valid tokens
  int nvalid;        // valid rows of this warp's slot
  int r0;            // first row of the slot in its page or the tail
  long long row0;    // first row of the slot in kd/kb/... (pages)
};

// First element of a tail slot in tail_k/tail_v.
__device__ __forceinline__ long long tail_offset(int bh, int page, int d,
                                                 int r0) {
  return (static_cast<long long>(bh) * page + r0) * d;
}

__device__ __forceinline__ Slot slot_of(
    int bh, int y, int warp, int kvh, int page, int shift, int pmax,
    int n_split, int n_main, const int* __restrict__ lengths,
    const int* __restrict__ tail_len, const int* __restrict__ page_table) {
  Slot s;
  const int nt = n_split - n_main;
  s.split = y < nt ? n_main + y : y - nt;
  const bool is_tail = s.split >= n_main;
  s.is_tail = is_tail;
  const int b = bh / kvh;
  const int h = bh - b * kvh;
  const int rw = page < kWarpRows ? page : kWarpRows;
  // the split's first slot among the pages' or the tail's, this warp's
  // slot, its page-table entry and its first row
  const int first = (is_tail ? s.split - n_main : s.split) * kWarps;
  const int j = first + warp;
  const int p = j >> shift;
  const int r0 = (is_tail ? j : j & ((1 << shift) - 1)) * kWarpRows;
  // the lengths and this warp's table entry in one round of loads
  const int len = lengths[b];
  const int tlen = is_tail ? min(tail_len[b], page) : 0;
  const int pid = (!is_tail && p < pmax) ? page_table[b * pmax + p] : 0;
  const int npages = len <= 0 ? 0 : min((len + page - 1) / page, pmax);
  s.empty = is_tail ? tlen <= first * kWarpRows : (first >> shift) >= npages;
  int nvalid = 0;
  if (is_tail) {
    if (r0 < page) nvalid = max(0, min(rw, tlen - r0));
  } else if (p < npages && r0 < page) {
    nvalid = max(0, min(min(rw, page - r0), len - p * page - r0));
  }
  s.nvalid = nvalid;
  s.r0 = r0;
  s.row0 = (static_cast<long long>(pid) * kvh + h) * page + r0;
  return s;
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

// Row layout of a warp's slot: lane (r, chunk) holds columns
// [16*chunk, 16*chunk + 16) of rows r + RPI*i, i < kPasses.
template <int D>
struct Rows {
  static constexpr int LPR = D / 16;                  // lanes a row
  static constexpr int RPI = 32 / LPR;                // rows a pass
  static constexpr int kPasses = (kWarpRows + RPI - 1) / RPI;
};

// The G x rw scores of a warp's slot from K in registers (zeros past
// nvalid): each query head's 16 columns are read from shared memory once
// and serve every row of the lane, GR heads at a time, so that
// GR * kPasses FMA chains and shuffle trees are in flight.
template <int D, int GR>
__device__ __forceinline__ void page_scores(
    const float (&k)[Rows<D>::kPasses][16], int nvalid, int lane, int g,
    int rw, const float* q_s, float* s_w) {
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
          if (g0 + u < g && t < nvalid) s_w[(g0 + u) * rw + t] = part[u][pi];
        }
    }
  }
}

// A compressed slot's K and V rows as this lane loads them: every load
// of the slot is issued before any math (and before q is staged).
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
  __device__ __forceinline__ void rows(int nvalid, int lane, int g, int rw,
                                       const float* q_s, int8_t* vr_w,
                                       float2* vsb_w, float* s_w) const {
    const int r = lane / R::LPR;
    const int chunk = lane % R::LPR;
    float k[R::kPasses][16];
#pragma unroll
    for (int pi = 0; pi < R::kPasses; ++pi) {
      const int t = pi * R::RPI + r;
      if (t < rw) {
        *reinterpret_cast<int4*>(vr_w + t * D + chunk * 16) = vr[pi];
        if (chunk == 0) vsb_w[t] = make_float2(vs[pi], vb[pi]);
      }
      dequant16(kr[pi], ks[pi], kb[pi], k[pi]);
    }
    page_scores<D, GR>(k, nvalid, lane, g, rw, q_s, s_w);
  }
};

// The f32 tail rows of a warp's slot: K rows at tk + t*D (V is read in
// P.V).
template <int D, int GR>
__device__ __forceinline__ void tail_rows(const float* __restrict__ tk,
                                          int nvalid, int lane, int g,
                                          int rw, const float* q_s,
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
  page_scores<D, GR>(k, nvalid, lane, g, rw, q_s, s_w);
}

// ---- the generic D: any multiple of 4 up to 256 -------------------------

// One step of the transposing fold of 16 per-lane partials (one a row)
// over the warp: lanes with bit N set keep the upper N/2 rows and send
// the lower, so N values become N/2, each summed with the partner's.
template <int N>
__device__ __forceinline__ void fold(float (&v)[kWarpRows], int lane) {
  const bool hi = lane & N;
#pragma unroll
  for (int j = 0; j < N / 2; ++j) {
    const float send = hi ? v[j] : v[j + N / 2];
    const float keep = hi ? v[j + N / 2] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, N);
  }
}

// The G x rw scores of a warp's slot at any D: lane L takes the 4-column
// groups L and L + 32 of every row; `krow(t, k)` gives row t's two groups
// (zeros past the row or past nvalid) and must be called by every lane.
// 16 shuffles a head fold the 16 rows' partial dots; lanes 2t and 2t+1
// then hold row t's score.
template <int GR, class KRow>
__device__ __forceinline__ void scores_any(const KRow& krow, int nvalid,
                                           int lane, int g, int d, int rw,
                                           const float* q_s, float* s_w) {
  const int ng = d >> 2;
  for (int g0 = 0; g0 < g; g0 += GR) {
    float4 qq[GR][2];
#pragma unroll
    for (int u = 0; u < GR; ++u)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        qq[u][i] = (g0 + u < g && c < ng)
                       ? *reinterpret_cast<const float4*>(
                             q_s + (g0 + u) * d + 4 * c)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    float part[GR][kWarpRows];
#pragma unroll
    for (int t = 0; t < kWarpRows; ++t) {
      float k[2][4];
      krow(t, k);
#pragma unroll
      for (int u = 0; u < GR; ++u) {
        float a = 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          a = fmaf(qq[u][i].x, k[i][0], a);
          a = fmaf(qq[u][i].y, k[i][1], a);
          a = fmaf(qq[u][i].z, k[i][2], a);
          a = fmaf(qq[u][i].w, k[i][3], a);
        }
        part[u][t] = a;
      }
    }
#pragma unroll
    for (int u = 0; u < GR; ++u) {
      fold<16>(part[u], lane);
      fold<8>(part[u], lane);
      fold<4>(part[u], lane);
      fold<2>(part[u], lane);
      part[u][0] += __shfl_xor_sync(kFull, part[u][0], 1);
    }
    const int t = lane >> 1;
    if (!(lane & 1) && t < nvalid) {
#pragma unroll
      for (int u = 0; u < GR; ++u)
        if (g0 + u < g) s_w[(g0 + u) * rw + t] = part[u][0];
    }
  }
}

// A compressed slot at any D: lane L loads the groups L and L + 32 of
// every row (4-byte loads), and row `lane`'s base and scale.
struct PageRegsAny {
  int kr[kWarpRows][2], vr[kWarpRows][2];
  float kb, ks, vb, vs;

  __device__ __forceinline__ void load(
      const int8_t* __restrict__ kd, const float* __restrict__ kbp,
      const float* __restrict__ ksp, const int8_t* __restrict__ vd,
      const float* __restrict__ vbp, const float* __restrict__ vsp,
      long long row0, int nvalid, int lane, int d) {
    const int ng = d >> 2;
#pragma unroll
    for (int t = 0; t < kWarpRows; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        kr[t][i] = vr[t][i] = 0;
        if (t < nvalid && c < ng) {
          const long long off = (row0 + t) * d;
          kr[t][i] = __ldg(reinterpret_cast<const int*>(kd + off) + c);
          vr[t][i] = __ldg(reinterpret_cast<const int*>(vd + off) + c);
        }
      }
    kb = ks = vb = vs = 0.0f;
    if (lane < nvalid) {
      kb = __ldg(kbp + row0 + lane);
      ks = __ldg(ksp + row0 + lane);
      vb = __ldg(vbp + row0 + lane);
      vs = __ldg(vsp + row0 + lane);
    }
  }

  template <int GR>
  __device__ __forceinline__ void rows(int nvalid, int lane, int g, int d,
                                       int rw, const float* q_s,
                                       int8_t* vr_w, float2* vsb_w,
                                       float* s_w) const {
    const int ng = d >> 2;
#pragma unroll
    for (int t = 0; t < kWarpRows; ++t)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int c = lane + 32 * i;
        if (t < rw && c < ng)
          reinterpret_cast<int*>(vr_w + t * d)[c] = vr[t][i];
      }
    if (lane < rw) vsb_w[lane] = make_float2(vs, vb);
    scores_any<GR>(
        [&](int t, float (&k)[2][4]) {
          const float s = __shfl_sync(kFull, ks, t);
          const float b = __shfl_sync(kFull, kb, t);
          dequant4(kr[t][0], s, b, k[0]);
          dequant4(kr[t][1], s, b, k[1]);
        },
        nvalid, lane, g, d, rw, q_s, s_w);
  }
};

// The f32 tail rows of a warp's slot at any D.
template <int GR>
__device__ __forceinline__ void tail_rows_any(const float* __restrict__ tk,
                                              int nvalid, int lane, int g,
                                              int d, int rw,
                                              const float* q_s, float* s_w) {
  const int ng = d >> 2;
  scores_any<GR>(
      [&](int t, float (&k)[2][4]) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = lane + 32 * i;
          const float4 a =
              (t < nvalid && c < ng)
                  ? __ldg(reinterpret_cast<const float4*>(tk + t * d) + c)
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          k[i][0] = a.x, k[i][1] = a.y, k[i][2] = a.z, k[i][3] = a.w;
        }
      },
      nvalid, lane, g, d, rw, q_s, s_w);
}

// ---- shared by every D ---------------------------------------------------

// The slot's softmax, two query heads at a time (lanes 16*h + t on key t
// of head h; rw <= 16), GR heads a group: s_w turns from scores into
// e^(s - m), 0 past nvalid; m_w and l_w take the max and sum.
template <int GR>
__device__ __forceinline__ void page_softmax(int nvalid, int lane, int g,
                                             int rw, float* s_w,
                                             float* m_w, float* l_w) {
  constexpr int NP = (GR + 1) / 2;  // pairs of heads a group
  const int half = lane >> 4;
  const int t = lane & 15;
  for (int g0 = 0; g0 < g; g0 += 2 * NP) {
    float s[NP], mb[NP], sum[NP];
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int gg = g0 + 2 * u + half;
      s[u] = (gg < g && t < nvalid) ? s_w[gg * rw + t] : -INFINITY;
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
        if (t < rw) s_w[gg * rw + t] = s[u];
        if (t == 0) {
          m_w[gg] = mb[u];
          l_w[gg] = sum[u];
        }
      }
    }
  }
}

// Shared memory of a split block, in floats: q, the warps' V slots
// (int8, then base and scale) and scores, which the warps' acc overlay
// for the merge once every warp is done with them; then m and l.  rw: a
// slot's rows padded to a multiple of 4.
__host__ __device__ __forceinline__ int split_smem_floats(int g, int d,
                                                          int rw) {
  const int work = g * d + kWarps * (rw * d / 4 + 2 * rw + g * rw);
  const int merge = kWarps * g * d;
  return (work > merge ? work : merge) + 2 * kWarps * g;
}

// Merge the 4 warps' softmax states of a group's G' heads in warp order:
// each head's max and sum go to dst, and m_all turns into the warps'
// factors e^(m_w - m).
__device__ __forceinline__ void merge_states(int g, int d, int tid,
                                             float* m_all,
                                             const float* l_all,
                                             float* dst) {
  for (int gi = tid; gi < g; gi += kThreads) {
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_all[w * g + gi]);
    float l = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = m_all[w * g + gi];
      const float sc = (mw == -INFINITY) ? 0.0f : expf(mw - m);
      l = fmaf(sc, l_all[w * g + gi], l);
      m_all[w * g + gi] = sc;
    }
    dst[static_cast<long long>(gi) * (d + 2)] = m;
    dst[static_cast<long long>(gi) * (d + 2) + 1] = l;
  }
}

// A split past the last valid token: m = -inf, l = 0, acc = 0.
__device__ __forceinline__ void write_empty(float* dst, int g, int d,
                                            int tid) {
  const int n = g * (d + 2);
  for (int i = tid; i < n; i += kThreads)
    dst[i] = (i % (d + 2) == 0) ? -INFINITY : 0.0f;
}

// D > 0: the head width, known at compile time (16, 32, 64 or 128); 0:
// d_rt, any multiple of 4 up to 256.  G > 0: the query heads of a group,
// known at compile time (every group full); 0: at most g_grp, the rest of
// g_all.  blockIdx.y + y0: the split (the tail's first), blockIdx.z the
// head group.
template <int D, int G>
__global__ void __launch_bounds__(kThreads,
                                  D > 0 ? kMinBlocks : kMinBlocksAnyD)
    split_kernel(const float* __restrict__ q, const int8_t* __restrict__ kd,
                 const float* __restrict__ kb, const float* __restrict__ ks,
                 const int8_t* __restrict__ vd, const float* __restrict__ vb,
                 const float* __restrict__ vs,
                 const int* __restrict__ page_table,
                 const int* __restrict__ lengths,
                 const float* __restrict__ tail_k,
                 const float* __restrict__ tail_v,
                 const int* __restrict__ tail_len,
                 float* __restrict__ scratch, int kvh, int g_all, int g_grp,
                 int d_rt, int page, int shift, int pmax, int n_split,
                 int n_main, int y0) {
  extern __shared__ __align__(16) float smem[];
  const int g0 = blockIdx.z * g_grp;
  const int g = G > 0 ? G : min(g_grp, g_all - g0);
  const int d = D > 0 ? D : d_rt;
  constexpr int GR = G == 0 ? 1 : (G < 2 ? G : 2);  // heads a score group
  constexpr int SG = G == 0 ? 4 : (G < 8 ? G : 8);  // heads a softmax group
  const int gd = g * d;
  const int rw = padded_rows(page);    // a slot's rows, padded
  float* q_s = smem;                   // [g][d], by q_index when D > 0
  float* vsb_f = q_s + gd + kWarps * rw * d / 4;
  int8_t* vr_all = reinterpret_cast<int8_t*>(q_s + gd);  // [kWarps][rw][d]
  float2* vsb_all = reinterpret_cast<float2*>(vsb_f);    // [kWarps][rw]
  float* s_all = vsb_f + 2 * kWarps * rw;     // [kWarps][g][rw]
  float* mbuf = smem;                          // [kWarps][g*d], the merge
  const int nsm = split_smem_floats(g, d, rw);
  float* m_all = smem + nsm - 2 * kWarps * g;       // [kWarps][g]
  float* l_all = m_all + kWarps * g;                // [kWarps][g]

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // q, the lengths and this warp's table entry in one round of loads
  const float* qb = q + (static_cast<long long>(bh) * g_all + g0) * d;
  constexpr int kQ = kMaxGD / kThreads;
  float qv[kQ];
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * kThreads;
    qv[k] = i < gd ? __ldg(qb + i) : 0.0f;
  }
  const Slot sl = slot_of(bh, blockIdx.y + y0, warp, kvh, page, shift,
                          pmax, n_split, n_main, lengths, tail_len,
                          page_table);
  const bool is_tail = sl.is_tail;
  const int nvalid = sl.nvalid;
  float* dst = scratch + ((static_cast<long long>(bh) * n_split + sl.split) *
                              g_all + g0) * (d + 2);
  if (sl.empty) {
    write_empty(dst, g, d, tid);
    return;
  }
  int8_t* vr_w = vr_all + warp * rw * d;
  using Regs = PageRegs<D == 0 ? 16 : D>;
  Regs regs;
  PageRegsAny regs_any;
  if (!is_tail) {
    if constexpr (D > 0)
      regs.load(kd, kb, ks, vd, vb, vs, sl.row0, nvalid, lane);
    else
      regs_any.load(kd, kb, ks, vd, vb, vs, sl.row0, nvalid, lane, d);
  }

  const float qscale = 1.0f / sqrtf(static_cast<float>(d));
#pragma unroll
  for (int k = 0; k < kQ; ++k) {
    const int i = tid + k * kThreads;
    if (i < gd) {
      if constexpr (D > 0)
        q_s[q_index<D>(i / D, i % D)] = qv[k] * qscale;
      else
        q_s[i] = qv[k] * qscale;
    }
  }
  __syncthreads();

  float2* vsb_w = vsb_all + warp * rw;
  float* s_w = s_all + warp * g * rw;
  float* m_w = m_all + warp * g;
  float* l_w = l_all + warp * g;
  const long long toff = tail_offset(bh, page, d, sl.r0);
  // Every warp runs the same code (the shuffles must not sit under a
  // branch that depends on the warp); one with no valid key (nvalid 0)
  // ends with m = -inf, l = 0 and acc = 0.
  if constexpr (D > 0) {
    if (is_tail)
      tail_rows<D, GR>(tail_k + toff, nvalid, lane, g, rw, q_s, s_w);
    else
      regs.template rows<GR>(nvalid, lane, g, rw, q_s, vr_w, vsb_w, s_w);
  } else {
    if (is_tail)
      tail_rows_any<GR>(tail_k + toff, nvalid, lane, g, d, rw, q_s, s_w);
    else
      regs_any.rows<GR>(nvalid, lane, g, d, rw, q_s, vr_w, vsb_w, s_w);
  }
  __syncwarp();
  page_softmax<SG>(nvalid, lane, g, rw, s_w, m_w, l_w);
  __syncwarp();

  // P.V, 4 keys a step.  Slot j of this lane is the 4 consecutive
  // elements 128*j + 4*lane of the [g][d] accumulator: query head gi,
  // columns col..col+3.  When d divides 128 the column is the same in
  // every slot, so one 4-byte load of V serves them all.
  constexpr int kSlots = kMaxGD / 128;
  const int nslot = (gd + 127) / 128;
  float acc[kSlots][4];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.0f;
  const float* tv = tail_v + toff;
  if constexpr (D > 0) {
    constexpr int LPG = D / 4;           // lanes a query head
    constexpr int GPS = 32 / LPG;        // query heads a slot
    const int col = 4 * (lane % LPG);
    const int gsub = lane / LPG;
    for (int t4 = 0; t4 < nvalid; t4 += 4) {
      float v[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int t = t4 + r;
        if (is_tail) {
          const float4 x =
              t < nvalid ? __ldg(reinterpret_cast<const float4*>(
                               tv + t * D + col))
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
              *reinterpret_cast<const float4*>(s_w + gj * rw + t4);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[j][c] = fmaf(pp.x, v[0][c], acc[j][c]);
            acc[j][c] = fmaf(pp.y, v[1][c], acc[j][c]);
            acc[j][c] = fmaf(pp.z, v[2][c], acc[j][c]);
            acc[j][c] = fmaf(pp.w, v[3][c], acc[j][c]);
          }
        }
    }
  } else {
    int sg[kSlots], sc[kSlots];   // each slot's score row and V column
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int e = 128 * j + 4 * lane;
      const int gi = e / d;
      sg[j] = min(gi, g - 1) * rw;                 // past g: never stored
      sc[j] = e < gd ? e - gi * d : 0;
    }
    for (int t4 = 0; t4 < nvalid; t4 += 4) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        if (j < nslot) {
          float v[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int t = t4 + r;
            if (is_tail) {
              const float4 x =
                  t < nvalid ? __ldg(reinterpret_cast<const float4*>(
                                   tv + t * d + sc[j]))
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
              v[r][0] = x.x, v[r][1] = x.y, v[r][2] = x.z, v[r][3] = x.w;
            } else {
              const float2 sb = vsb_w[t];
              dequant4(*reinterpret_cast<const int*>(vr_w + t * d + sc[j]),
                       sb.x, sb.y, v[r]);
            }
          }
          const float4 pp =
              *reinterpret_cast<const float4*>(s_w + sg[j] + t4);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[j][c] = fmaf(pp.x, v[0][c], acc[j][c]);
            acc[j][c] = fmaf(pp.y, v[1][c], acc[j][c]);
            acc[j][c] = fmaf(pp.z, v[2][c], acc[j][c]);
            acc[j][c] = fmaf(pp.w, v[3][c], acc[j][c]);
          }
        }
    }
  }
  __syncthreads();  // every warp is done with q, V and the scores
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int e = 128 * j + 4 * lane;
    if (j < nslot && e < gd)
      *reinterpret_cast<float4*>(mbuf + warp * gd + e) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
  __syncthreads();

  // merge the warps' states in warp order: first each query head's max,
  // sum and per-warp factors (m_all turns into the factors), then acc
  merge_states(g, d, tid, m_all, l_all, dst);
  __syncthreads();
  for (int e = tid; e < gd; e += kThreads) {
    const int gi = e / d;
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      a = fmaf(m_all[w * g + gi], mbuf[w * gd + e], a);
    dst[gi * (d + 2) + 2 + (e - gi * d)] = a;
  }
}

// Shared memory of a byte-rows block, in floats: the warps' scores, their
// P.V accumulators for one column chunk of cw columns, then m and l.
__host__ __device__ __forceinline__ int bytes_smem_floats(int g, int rw,
                                                          int cw) {
  return kWarps * g * rw + kWarps * g * cw + 2 * kWarps * g;
}

// K or V element (t, c) of a slot: the int8 page row dequantised, or the
// f32 tail row.
__device__ __forceinline__ float kv_at(bool is_tail,
                                       const int8_t* __restrict__ xd,
                                       const float* __restrict__ xs,
                                       const float* __restrict__ xb,
                                       const float* __restrict__ tx,
                                       long long row0, long long toff, int t,
                                       int c, int d) {
  if (is_tail) return __ldg(tx + toff + static_cast<long long>(t) * d + c);
  const long long row = row0 + t;
  return fmaf(static_cast<float>(__ldg(xd + row * d + c)), __ldg(xs + row),
              __ldg(xb + row));
}

// Any D (not a multiple of 4, or over 256): the slots, splits and scratch
// of split_kernel, a plain body over rows that are only byte-aligned.
__global__ void __launch_bounds__(kThreads) split_kernel_bytes(
    const float* __restrict__ q, const int8_t* __restrict__ kd,
    const float* __restrict__ kb, const float* __restrict__ ks,
    const int8_t* __restrict__ vd, const float* __restrict__ vb,
    const float* __restrict__ vs, const int* __restrict__ page_table,
    const int* __restrict__ lengths, const float* __restrict__ tail_k,
    const float* __restrict__ tail_v, const int* __restrict__ tail_len,
    float* __restrict__ scratch, int kvh, int g_all, int g_grp, int d,
    int page, int shift, int pmax, int n_split, int n_main, int y0,
    int cw) {
  extern __shared__ __align__(16) float smem[];
  const int g0 = blockIdx.z * g_grp;
  const int g = min(g_grp, g_all - g0);
  const int rw = padded_rows(page);
  float* s_all = smem;                          // [kWarps][g][rw]
  float* acc_all = s_all + kWarps * g * rw;     // [kWarps][g*cw]
  float* m_all = acc_all + kWarps * g * cw;     // [kWarps][g]
  float* l_all = m_all + kWarps * g;            // [kWarps][g]
  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Slot sl = slot_of(bh, blockIdx.y + y0, warp, kvh, page, shift,
                          pmax, n_split, n_main, lengths, tail_len,
                          page_table);
  float* dst = scratch + ((static_cast<long long>(bh) * n_split + sl.split) *
                              g_all + g0) * (d + 2);
  if (sl.empty) {
    write_empty(dst, g, d, tid);
    return;
  }
  const bool is_tail = sl.is_tail;
  const int nvalid = sl.nvalid;
  const long long toff = tail_offset(bh, page, d, sl.r0);
  const float qscale = 1.0f / sqrtf(static_cast<float>(d));
  const float* qb = q + (static_cast<long long>(bh) * g_all + g0) * d;
  float* s_w = s_all + warp * g * rw;
  for (int gi = 0; gi < g; ++gi) {
    float part[kWarpRows];
#pragma unroll
    for (int t = 0; t < kWarpRows; ++t) part[t] = 0.0f;
    for (int c0 = 0; c0 < d; c0 += 32) {
      const int c = c0 + lane;
      const float qq = c < d ? __ldg(qb + gi * d + c) * qscale : 0.0f;
#pragma unroll
      for (int t = 0; t < kWarpRows; ++t)
        if (t < nvalid && c < d)
          part[t] = fmaf(qq, kv_at(is_tail, kd, ks, kb, tail_k, sl.row0,
                                   toff, t, c, d),
                         part[t]);
    }
    fold<16>(part, lane);
    fold<8>(part, lane);
    fold<4>(part, lane);
    fold<2>(part, lane);
    part[0] += __shfl_xor_sync(kFull, part[0], 1);
    const int t = lane >> 1;
    if (!(lane & 1) && t < nvalid) s_w[gi * rw + t] = part[0];
  }
  __syncwarp();
  page_softmax<4>(nvalid, lane, g, rw, s_w, m_all + warp * g,
                  l_all + warp * g);
  __syncthreads();
  merge_states(g, d, tid, m_all, l_all, dst);
  __syncthreads();
  float* acc_w = acc_all + warp * g * cw;
  for (int cc0 = 0; cc0 < d; cc0 += cw) {
    const int cn = min(cw, d - cc0);
    const int ne = g * cn;
    for (int e = lane; e < ne; e += 32) {
      const int gi = e / cn;
      const int c = cc0 + (e - gi * cn);
      float a = 0.0f;
      for (int t = 0; t < nvalid; ++t)
        a = fmaf(s_w[gi * rw + t],
                 kv_at(is_tail, vd, vs, vb, tail_v, sl.row0, toff, t, c,
                       d),
                 a);
      acc_w[e] = a;
    }
    __syncthreads();
    for (int e = tid; e < ne; e += kThreads) {
      const int gi = e / cn;
      const int c = cc0 + (e - gi * cn);
      float a = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        a = fmaf(m_all[w * g + gi], acc_all[w * g * cw + e], a);
      dst[static_cast<long long>(gi) * (d + 2) + 2 + c] = a;
    }
    __syncthreads();
  }
}

// One block a (b*KVH + h, query head, block of kNT columns): thread c
// walks the splits in index order for column c, in chunks of kChunk whose
// weights e^(m_s - M) and sums l_s go to shared memory, M the running
// max (num and den rescaled where a chunk raises it; one chunk up to
// kChunk splits), kBatch loads at a time; a chunk's first batch is loaded
// with its m_s, before M is known.  D 0: d_rt columns, 256 threads a
// block.
template <int D>
__global__ void __launch_bounds__(D > 0 ? kThreads : kMaxD) combine_kernel(
    const float* __restrict__ scratch, float* __restrict__ out, int d_rt,
    int n_split) {
  constexpr int kNT = D > 0 ? kThreads : kMaxD;
  constexpr int kBatch = 72;  // one round of loads up to PMAX 284
  extern __shared__ float w_s[];       // [chunk] weights
  const int chunk = n_split < kChunk ? n_split : kChunk;
  float* l_s = w_s + chunk;            // [chunk] sums
  __shared__ float red[kNT / 32];
  const int d = D > 0 ? D : d_rt;
  const int bh = blockIdx.x;
  const int gi = blockIdx.y;
  const int g = gridDim.y;
  const int tid = threadIdx.x;
  const int col = blockIdx.z * kNT + tid;
  const bool live = col < d;
  const long long stride = static_cast<long long>(g) * (d + 2);
  const float* base =
      scratch + (static_cast<long long>(bh) * n_split * g + gi) * (d + 2);
  float a[kBatch];
  float big = -INFINITY, num = 0.0f, den = 0.0f;
  for (int c0 = 0; c0 < n_split; c0 += kChunk) {
    const int cn = min(kChunk, n_split - c0);
    const float* cb = base + c0 * stride;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      a[u] = (live && u < cn) ? cb[u * stride + 2 + col] : 0.0f;
    float m = -INFINITY;
    for (int s = tid; s < cn; s += kNT) {
      const float ms = cb[s * stride];
      w_s[s] = ms;
      l_s[s] = cb[s * stride + 1];
      m = fmaxf(m, ms);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if ((tid & 31) == 0) red[tid >> 5] = m;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kNT / 32; ++w) m = fmaxf(m, red[w]);
    m = fmaxf(m, big);
    // the chunks before, rescaled to the new max (0 while all were empty)
    const float f = (big == -INFINITY) ? 0.0f : expf(big - m);
    num *= f;
    den *= f;
    big = m;
    for (int s = tid; s < cn; s += kNT) {
      const float ms = w_s[s];
      w_s[s] = (ms == -INFINITY) ? 0.0f : expf(ms - m);  // adds exactly 0
    }
    __syncthreads();
    if (live) {
      for (int s0 = 0; s0 < cn; s0 += kBatch) {  // index order
        if (s0 > 0) {
#pragma unroll
          for (int u = 0; u < kBatch; ++u)
            a[u] = s0 + u < cn ? cb[(s0 + u) * stride + 2 + col] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (s0 + u < cn) {
            num = fmaf(w_s[s0 + u], a[u], num);
            den = fmaf(w_s[s0 + u], l_s[s0 + u], den);
          }
      }
    }
    __syncthreads();           // before the next chunk reuses w_s and red
  }
  if (live) out[(static_cast<long long>(bh) * g + gi) * d + col] = num / den;
}

// The split pass over grid rows of at most kMaxGridY splits, then the
// combine.
template <class Launch>
int split_rows(int n_split, Launch&& one) {
  for (int y0 = 0; y0 < n_split; y0 += kMaxGridY) {
    one(y0, min(kMaxGridY, n_split - y0));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <int D>
int combine(const void* scratch, void* out, int bkvh, int g, int d,
            int n_split, cudaStream_t stream) {
  constexpr int kNT = D > 0 ? kThreads : kMaxD;
  const dim3 grid(bkvh, g, (d + kNT - 1) / kNT);
  const float* in = static_cast<const float*>(scratch);
  float* o = static_cast<float*>(out);
  const int chunk = n_split < kChunk ? n_split : kChunk;
  combine_kernel<D><<<grid, kNT, 2 * sizeof(float) * chunk, stream>>>(
      in, o, d, n_split);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* kd, const void* kb, const void* ks,
           const void* vd, const void* vb, const void* vs,
           const void* page_table, const void* lengths, const void* tail_k,
           const void* tail_v, const void* tail_len, void* out,
           void* scratch, int bkvh, int kvh, int g, int d, int page,
           int pmax, int n_split, int n_main, cudaStream_t stream) {
  const int gg = group_heads(g, d, kMaxGroup);
  const int groups = (g + gg - 1) / gg;
  const size_t smem =
      sizeof(float) * split_smem_floats(gg, d, padded_rows(page));
  auto split = split_kernel<D, 0>;
  if (g % gg == 0) {
    switch (gg) {
      case 1: split = split_kernel<D, 1>; break;
      case 2: split = split_kernel<D, 2>; break;
      case 4: split = split_kernel<D, 4>; break;
      case 8: split = split_kernel<D, 8>; break;
      default: break;
    }
  }
  const int err = split_rows(n_split, [&](int y0, int ny) {
    split<<<dim3(bkvh, ny, groups), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(kd),
        static_cast<const float*>(kb), static_cast<const float*>(ks),
        static_cast<const int8_t*>(vd), static_cast<const float*>(vb),
        static_cast<const float*>(vs), static_cast<const int*>(page_table),
        static_cast<const int*>(lengths), static_cast<const float*>(tail_k),
        static_cast<const float*>(tail_v), static_cast<const int*>(tail_len),
        static_cast<float*>(scratch), kvh, g, gg, d, page, slot_shift(page),
        pmax, n_split, n_main, y0);
  });
  if (err) return err;
  return combine<D>(scratch, out, bkvh, g, d, n_split, stream);
}

int launch_bytes(const void* q, const void* kd, const void* kb,
                 const void* ks, const void* vd, const void* vb,
                 const void* vs, const void* page_table, const void* lengths,
                 const void* tail_k, const void* tail_v,
                 const void* tail_len, void* out, void* scratch, int bkvh,
                 int kvh, int g, int d, int page, int pmax, int n_split,
                 int n_main, cudaStream_t stream) {
  const int gg = group_heads(g, d, kMaxGroupBytes);
  const int groups = (g + gg - 1) / gg;
  const int cw = min(d, kMaxGD / gg);
  const size_t smem =
      sizeof(float) * bytes_smem_floats(gg, padded_rows(page), cw);
  const int err = split_rows(n_split, [&](int y0, int ny) {
    split_kernel_bytes<<<dim3(bkvh, ny, groups), kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const int8_t*>(kd),
        static_cast<const float*>(kb), static_cast<const float*>(ks),
        static_cast<const int8_t*>(vd), static_cast<const float*>(vb),
        static_cast<const float*>(vs), static_cast<const int*>(page_table),
        static_cast<const int*>(lengths), static_cast<const float*>(tail_k),
        static_cast<const float*>(tail_v), static_cast<const int*>(tail_len),
        static_cast<float*>(scratch), kvh, g, gg, d, page, slot_shift(page),
        pmax, n_split, n_main, y0, cw);
  });
  if (err) return err;
  return combine<0>(scratch, out, bkvh, g, d, n_split, stream);
}

}  // namespace

// All pointers are contiguous device buffers of the shapes above; the
// int arrays are int32; scratch is f32 [B*KVH, n_split, G, D+2] with
// n_split = ceil(pmax * slots / 4) + (tail_len != null ? ceil(slots / 4)
// : 0), slots = ceil(page / 16) rounded up to a power of two.  The launches go on `stream`; returns
// cudaGetLastError() after them (cudaErrorInvalidValue for a shape no
// kernel can take, G, D or page below 1 or PMAX below 0, or a wrong
// n_split).
extern "C" int paged_attention_tail(
    const void* q, const void* kd, const void* kb, const void* ks,
    const void* vd, const void* vb, const void* vs, const void* page_table,
    const void* lengths, const void* tail_k, const void* tail_v,
    const void* tail_len, void* out, void* scratch, int batch, int kvh,
    int g, int d, int page, int pmax, int n_split, void* stream) {
  if (!shape_ok(g, d, page) || pmax < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_main = main_splits(pmax, page);
  const int want = n_main + (tail_len != nullptr ? tail_splits(page) : 0);
  if (n_split != want) return static_cast<int>(cudaErrorInvalidValue);
  const int bkvh = batch * kvh;
  if (bkvh == 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_ARGS                                                          \
  q, kd, kb, ks, vd, vb, vs, page_table, lengths, tail_k, tail_v, tail_len, \
      out, scratch, bkvh, kvh, g, d, page, pmax, n_split, n_main, st
  if (!word_rows(d)) return launch_bytes(REPRO_ARGS);
  switch (d) {
    case 16: return launch<16>(REPRO_ARGS);
    case 32: return launch<32>(REPRO_ARGS);
    case 64: return launch<64>(REPRO_ARGS);
    case 128: return launch<128>(REPRO_ARGS);
    default: return launch<0>(REPRO_ARGS);
  }
#undef REPRO_ARGS
}

// The same without a tail (n_split = ceil(pmax * slots / 4)).
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
