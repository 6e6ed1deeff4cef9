// Device code of one 16-row query strip of window attention, head dim 32:
// softmax(scale * q k^T + bias [- 100 * (id_q != id_k)]) v, with k, v of
// one (window, head) staged in shared memory (Np = 16 * KT rows, zero
// padded, row stride kLd) and q staged with them or loaded as the strip's
// mma operands (K1 at 25 key tiles). Shared by K1 (window_attention.cu),
// K9 / K10 (window_attention_heads.cu) and, its online-softmax step on one
// key tile (strip_online), K11 and K6's attention pass
// (window_attention_flash.cu).
// What is added to the scaled logits is a template parameter ("terms":
// add(n-tile, l[4])), and so is where a strip's output rows go ("out":
// row(q)): K1's bf16 bias in accumulator order and
// region ids (RegionTerms; K11 reads the same, a key tile at a time), K9 /
// K10's fp32 bias and fp32 additive mask, both in accumulator order
// (FragTerms).
//
// A warp keeps its strip's 16 x Np logits in mma.sync (m16n8k16, bf16 in,
// fp32 accumulate) accumulators: a thread holds two rows, so the row max
// and sum are two quad shuffles. The bias comes in that accumulator order
// (ops/window_attention.py::fragment_terms; -inf in the padded keys). The
// probabilities are repacked in registers as the bf16 A operand of the P.V
// product, and V comes in through ldmatrix.trans. Up to 16 key tiles the
// strip is one pass; past that the whole strip would spill (19 tiles: 152
// logits a lane, 255 registers and a spill), so it is walked in parts of
// at most 10 16-key steps with an online max / sum rescale (unnormalised
// probabilities into P.V, one division at the end).
#pragma once

#include "common.cuh"

namespace clover {
namespace wa {

constexpr int kHd = 32;
constexpr int kLd = kHd + 8;  // row stride of the staged q/k/v: no ldmatrix bank conflicts

constexpr float kLog2e = 1.4426950408889634f;

// e^x, or 2^x for logits kept in log2 units: the same ex2.approx that
// __expf runs, without its multiply by log2(e)
template <bool kLog2>
__device__ __forceinline__ float softmax_exp(float x) {
  if constexpr (kLog2) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
  } else {
    return __expf(x);
  }
}

// K1's terms of strip s: the head's bias in accumulator order (-inf in the
// padded keys; bias_s is this lane's entry of n-tile 0) and, for shifted
// blocks, -100 where a key's region id (id_s, shared memory) is not the
// row's. kLog2 (K11): both in log2 units, times log2(e), the bias in the
// same FMA, for logits scaled by scale * log2(e).
template <bool kLog2 = false>
struct RegionTerms {
  const uint2* bias_s;
  const int* id_s;
  bool masked;
  int id0, id1, tq;  // region ids of this lane's rows q0, q1; its column pair
  __device__ __forceinline__ void add(int nt, float (&l)[4]) const {
    constexpr float u = kLog2 ? kLog2e : 1.f;
    const uint2 bv = bias_s[nt * 32];  // rows q0, q1 x keys k, k+1
    const float2 bq0 = bf16x2_to_float2(bv.x), bq1 = bf16x2_to_float2(bv.y);
    l[0] = fmaf(bq0.x, u, l[0]), l[1] = fmaf(bq0.y, u, l[1]);
    l[2] = fmaf(bq1.x, u, l[2]), l[3] = fmaf(bq1.y, u, l[3]);
    if (masked) {
      const int2 idk = *reinterpret_cast<const int2*>(id_s + nt * 8 + tq * 2);
      if (idk.x != id0) l[0] -= 100.f * u;
      if (idk.y != id0) l[1] -= 100.f * u;
      if (idk.x != id1) l[2] -= 100.f * u;
      if (idk.y != id1) l[3] -= 100.f * u;
    }
  }
};

// K9 / K10's terms: the head's fp32 bias and the window's fp32 additive mask,
// each in accumulator order (ops/window_attention.py::fragment_terms: -inf in
// the bias's padded keys, 0 in the rest of the padding); bias_s and mask_s
// are this lane's entries of n-tile 0 of the strip, one 16-byte load of each
// per n-tile, a warp's load one contiguous 512-byte line
struct FragTerms {
  const float4* bias_s;
  const float4* mask_s;  // nullptr: unshifted block
  __device__ __forceinline__ void add(int nt, float (&l)[4]) const {
    const float4 b = __ldg(bias_s + nt * 32);  // rows q0, q1 x keys k, k+1
    l[0] += b.x, l[1] += b.y, l[2] += b.z, l[3] += b.w;
    if (mask_s != nullptr) {
      const float4 m = __ldg(mask_s + nt * 32);
      l[0] += m.x, l[1] += m.y, l[2] += m.z, l[3] += m.w;
    }
  }
};

// Where the rows of one (window, head) live, as element offsets of the
// head's column 0: in(r) in the q / k / v tensors, out(r) in the output.
// K9 and K11's head-major layout, (Bn, nH, N, 32) q, k, v and out.
struct HeadRows {
  long base;  // ((b * nH + h) * N) * 32
  __device__ __forceinline__ long in(int r) const { return base + long(r) * kHd; }
  __device__ __forceinline__ long out(int r) const { return in(r); }
};

// K11's flat layout: (Bn*N, 3C) qkv rows (k at +C, v at +2C), (Bn*N, C) out
struct FlatRows {
  long row0;  // b * N
  int C, h;
  __device__ __forceinline__ long in(int r) const { return (row0 + r) * 3 * C + h * kHd; }
  __device__ __forceinline__ long out(int r) const { return (row0 + r) * C + h * kHd; }
};

// K10: token r of a window whose corner token is `corner` in a (B, Dp, Hp,
// Wp) grid of 3C-wide qkv rows (k at +C, v at +2C) and C-wide output rows:
// corner + rel[r], rel (shared memory) the same for every window of the grid
struct GridRows {
  long corner;
  const int* rel;
  int C, h;
  __device__ __forceinline__ long token(int r) const { return corner + rel[r]; }
  __device__ __forceinline__ long in(int r) const { return token(r) * 3 * C + h * kHd; }
  __device__ __forceinline__ long out(int r) const { return token(r) * C + h * kHd; }
};

// a strip's output rows: out + rows.out(q) (K1: RowStride)
template <class Rows>
struct OutRows {
  bf16* out;
  Rows rows;
  __device__ __forceinline__ bf16* row(int q) const { return out + rows.out(q); }
};

struct RowStride {
  bf16* base;
  int ld;
  __device__ __forceinline__ bf16* row(int q) const { return base + long(q) * ld; }
};

// Logits of n-tiles [nt0, nt0 + NTH) (8 keys each) of one 16-row query
// strip: scale * q k^T + terms, and this lane's maxima of its two rows
// over them.
template <int NTH, class Terms>
__device__ __forceinline__ void strip_logits(float (&sc)[NTH][4], const unsigned (&qa)[2][4],
                                             const bf16* ks, const Terms& terms, int nt0,
                                             int lane, float scale, float& m0, float& m1) {
#pragma unroll
  for (int i = 0; i < NTH; ++i) {
    unsigned kb[4];  // hd 0-7, 8-15, 16-23, 24-31 of keys nt*8 + lane % 8
    ldmatrix_x4(kb, ks + ((nt0 + i) * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
    sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    mma_bf16(sc[i], qa[0], kb[0], kb[1]);
    mma_bf16(sc[i], qa[1], kb[2], kb[3]);
  }
  m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int i = 0; i < NTH; ++i) {
    float l[4] = {sc[i][0] * scale, sc[i][1] * scale, sc[i][2] * scale, sc[i][3] * scale};
    terms.add(nt0 + i, l);
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[i][e] = l[e];
    m0 = fmaxf(m0, fmaxf(l[0], l[1]));
    m1 = fmaxf(m1, fmaxf(l[2], l[3]));
  }
}

// sc <- exp(sc - row max) in place (exp(-inf) = 0 for padded keys; 2^ for
// kLog2); this lane's sums of its two rows
template <int NTH, bool kLog2 = false>
__device__ __forceinline__ void strip_exp(float (&sc)[NTH][4], float m0, float m1, float& sum0,
                                          float& sum1) {
  sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < NTH; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[i][e] = softmax_exp<kLog2>(sc[i][e] - m0);
      sc[i][2 + e] = softmax_exp<kLog2>(sc[i][2 + e] - m1);
      sum0 += sc[i][e];
      sum1 += sc[i][2 + e];
    }
  }
}

// o += (sc * row scale) v over KS 16-key steps from step j0: step j is
// n-tiles 2j, 2j+1, whose accumulators are the A operand of one k-step
template <int KS>
__device__ __forceinline__ void strip_pv(float (&o)[4][4], const float (&sc)[2 * KS][4],
                                         float s0, float s1, const bf16* vs, int j0, int lane) {
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    const unsigned pa[4] = {pack_bf16(sc[2 * j][0] * s0, sc[2 * j][1] * s0),
                            pack_bf16(sc[2 * j][2] * s1, sc[2 * j][3] * s1),
                            pack_bf16(sc[2 * j + 1][0] * s0, sc[2 * j + 1][1] * s0),
                            pack_bf16(sc[2 * j + 1][2] * s1, sc[2 * j + 1][3] * s1)};
#pragma unroll
    for (int dp = 0; dp < 2; ++dp) {  // head columns dp*16 .. dp*16+15
      unsigned vb[4];
      ldmatrix_x4_trans(vb, a_tile_row(vs + (j0 + j) * 16 * kLd + dp * 16, kLd, lane));
      mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
      mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
    }
  }
}

// parts of the online softmax over KT key steps: 1 up to 16, else parts of
// at most 10 steps (19 -> 10 + 9, 25 -> 9 + 8 + 8)
template <int KT>
constexpr int kStripParts = KT <= 16 ? 1 : (KT + 9) / 10;

// One online-softmax step over KS 16-key steps from step j0: the running
// row max m and sum (m = -inf, sum = 0 before the first) updated, o
// rescaled by exp(m_old - m_new) and the unnormalised P.V added (kLog2:
// logits and m in log2 units, 2^ for exp)
template <int KS, bool kLog2 = false, class Terms>
__device__ __forceinline__ void strip_online(float (&o)[4][4], const unsigned (&qa)[2][4],
                                             const bf16* ks, const bf16* vs, const Terms& terms,
                                             int j0, int lane, float scale, float& m0, float& m1,
                                             float& sum0, float& sum1) {
  float sc[2 * KS][4], n0, n1, t0, t1;
  strip_logits<2 * KS>(sc, qa, ks, terms, 2 * j0, lane, scale, n0, n1);
  n0 = fmaxf(m0, quad_max(n0)), n1 = fmaxf(m1, quad_max(n1));
  const float f0 = softmax_exp<kLog2>(m0 - n0), f1 = softmax_exp<kLog2>(m1 - n1);
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] *= f0, o[d][1] *= f0, o[d][2] *= f1, o[d][3] *= f1;
  strip_exp<2 * KS, kLog2>(sc, n0, n1, t0, t1);
  sum0 = sum0 * f0 + t0, sum1 = sum1 * f1 + t1;
  m0 = n0, m1 = n1;
  strip_pv<KS>(o, sc, 1.f, 1.f, vs, j0, lane);
}

// part p of P of the key steps (the first parts take the remainder), with
// the running row max m and sum carried from the parts before it
template <int KT, int P, int p, class Terms>
__device__ __forceinline__ void strip_part(float (&o)[4][4], const unsigned (&qa)[2][4],
                                           const bf16* ks, const bf16* vs, const Terms& terms,
                                           int lane, float scale, float& m0, float& m1,
                                           float& sum0, float& sum1) {
  constexpr int J0 = (p * KT + P - 1) / P, KS = ((p + 1) * KT + P - 1) / P - J0;
  if constexpr (p == 0) {
    float sc[2 * KS][4];
    strip_logits<2 * KS>(sc, qa, ks, terms, 0, lane, scale, m0, m1);
    m0 = quad_max(m0), m1 = quad_max(m1);
    strip_exp<2 * KS>(sc, m0, m1, sum0, sum1);
    strip_pv<KS>(o, sc, 1.f, 1.f, vs, 0, lane);
  } else {
    strip_online<KS>(o, qa, ks, vs, terms, J0, lane, scale, m0, m1, sum0, sum1);
  }
  if constexpr (p + 1 < P) {
    strip_part<KT, P, p + 1>(o, qa, ks, vs, terms, lane, scale, m0, m1, sum0, sum1);
  }
}

// Strip s (rows s*16 .. s*16+15) of one (window, head): the strip's q as
// the A operand of its two k16 halves (qa), the staged k, v (ks, vs) and
// the terms of the strip's logits; rows < N are written to out.row(q).
template <int KT, class Terms, class Out>
__device__ __forceinline__ void attend_strip_qa(const unsigned (&qa)[2][4], const bf16* ks,
                                                const bf16* vs, const Terms& terms, int s,
                                                int lane, int N, float scale, const Out& out) {
  constexpr int NT = 2 * KT;  // 8-key n-tiles
  const int g = lane >> 2, tq = lane & 3;  // accumulator row / column pair of this lane
  // this lane holds rows q0 = s*16 + g and q1 = q0 + 8
  const int q0 = s * 16 + g, q1 = q0 + 8;
  float o[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float inv0, inv1;
  if constexpr (KT <= 16) {
    // one pass: the strip's whole 16 x Np logits in registers
    float sc[NT][4], m0, m1;
    strip_logits<NT>(sc, qa, ks, terms, 0, lane, scale, m0, m1);
    float sum0, sum1;
    strip_exp<NT>(sc, quad_max(m0), quad_max(m1), sum0, sum1);
    inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
    strip_pv<KT>(o, sc, inv0, inv1, vs, 0, lane);
    inv0 = inv1 = 1.f;
  } else {
    float m0, m1, sum0, sum1;
    strip_part<KT, kStripParts<KT>, 0>(o, qa, ks, vs, terms, lane, scale, m0, m1, sum0, sum1);
    inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int col = d * 8 + tq * 2;
    if (q0 < N) {
      *reinterpret_cast<unsigned*>(out.row(q0) + col) = pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    }
    if (q1 < N) {
      *reinterpret_cast<unsigned*>(out.row(q1) + col) = pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
    }
  }
}

// The same with the strip's q staged in shared memory (qs, the q of row 0)
template <int KT, class Terms, class Out>
__device__ __forceinline__ void attend_strip_with(const bf16* qs, const bf16* ks, const bf16* vs,
                                                  const Terms& terms, int s, int lane, int N,
                                                  float scale, const Out& out) {
  unsigned qa[2][4];
  ldmatrix_x4(qa[0], a_tile_row(qs + s * 16 * kLd, kLd, lane));
  ldmatrix_x4(qa[1], a_tile_row(qs + s * 16 * kLd + 16, kLd, lane));
  attend_strip_qa<KT>(qa, ks, vs, terms, s, lane, N, scale, out);
}

// The A operand of query rows r0 .. r0+15 of one head straight from device
// memory (q of row r at src + r * ld), rows >= N zero: the values
// ldmatrix_x4 gives from the staged strip (lane 4 g + t holds rows r0 + g,
// r0 + g + 8 at columns 16 kh + 2 t (+1) and 16 kh + 8 + 2 t (+1))
__device__ __forceinline__ void load_q_strip(unsigned (&qa)[2][4], const bf16* src, long ld,
                                             int r0, int N, int lane) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const unsigned* row = reinterpret_cast<const unsigned*>(src + long(r) * ld) + tq;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
      for (int c = 0; c < 2; ++c) qa[kh][half + 2 * c] = r < N ? __ldg(row + kh * 8 + c * 4) : 0u;
    }
  }
}

// K1's terms of strip s: the head's bias in accumulator order (bias_h) and
// the window's region ids in shared memory (id_s, read only when masked)
template <int KT>
__device__ __forceinline__ RegionTerms<> region_terms(const uint2* bias_h, const int* id_s,
                                                      bool masked, int s, int lane) {
  const int q0 = s * 16 + (lane >> 2);
  return {bias_h + long(s) * 2 * KT * 32 + lane, id_s, masked, masked ? id_s[q0] : 0,
          masked ? id_s[q0 + 8] : 0, lane & 3};
}

// K1: strip s with its q staged (qs) or as loaded operands (qa), K1's terms;
// rows < N are written to out_b (the head's column 0 of the window's row 0)
// at row stride ldo.
template <int KT>
__device__ __forceinline__ void attend_strip(const bf16* qs, const bf16* ks, const bf16* vs,
                                             const uint2* bias_h, const int* id_s, bool masked,
                                             int s, int lane, int N, float scale, bf16* out_b,
                                             int ldo) {
  attend_strip_with<KT>(qs, ks, vs, region_terms<KT>(bias_h, id_s, masked, s, lane), s, lane, N,
                        scale, RowStride{out_b, ldo});
}

template <int KT>
__device__ __forceinline__ void attend_strip(const unsigned (&qa)[2][4], const bf16* ks,
                                             const bf16* vs, const uint2* bias_h,
                                             const int* id_s, bool masked, int s, int lane,
                                             int N, float scale, bf16* out_b, int ldo) {
  attend_strip_qa<KT>(qa, ks, vs, region_terms<KT>(bias_h, id_s, masked, s, lane), s, lane, N,
                      scale, RowStride{out_b, ldo});
}

}  // namespace wa
}  // namespace clover
