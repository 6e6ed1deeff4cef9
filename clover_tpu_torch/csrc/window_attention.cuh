// Device code of one 16-row query strip of window attention, head dim 32:
// softmax(scale * q k^T + bias [- 100 * (id_q != id_k)]) v, with q, k, v of
// one (window, head) staged in shared memory (Np = 16 * KT rows, zero
// padded, row stride kLd). Shared by K1 (window_attention.cu) and K6's
// attention pass (attn_block.cu).
//
// A warp keeps its strip's 16 x Np logits in mma.sync (m16n8k16, bf16 in,
// fp32 accumulate) accumulators: a thread holds two rows, so the row max
// and sum are two quad shuffles. The bias comes in that accumulator order
// (ops/window_attention.py::fragment_bias; -inf in the padded keys). The
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

// Logits of n-tiles [nt0, nt0 + NTH) (8 keys each) of one 16-row query
// strip: scale * q k^T + bias (+ region mask), and this lane's maxima of
// its two rows over them.
template <int NTH>
__device__ __forceinline__ void strip_logits(float (&sc)[NTH][4], const unsigned (&qa)[2][4],
                                             const bf16* ks, const uint2* bias_s,
                                             const int* id_s, bool masked, int id0, int id1,
                                             int nt0, int lane, float scale, float& m0,
                                             float& m1) {
  const int tq = lane & 3;
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
    const uint2 bv = bias_s[(nt0 + i) * 32];  // rows q0, q1 x keys k, k+1
    const float2 bq0 = bf16x2_to_float2(bv.x), bq1 = bf16x2_to_float2(bv.y);
    float l[4] = {sc[i][0] * scale + bq0.x, sc[i][1] * scale + bq0.y,
                  sc[i][2] * scale + bq1.x, sc[i][3] * scale + bq1.y};
    if (masked) {
      const int2 idk = *reinterpret_cast<const int2*>(id_s + (nt0 + i) * 8 + tq * 2);
      if (idk.x != id0) l[0] -= 100.f;
      if (idk.y != id0) l[1] -= 100.f;
      if (idk.x != id1) l[2] -= 100.f;
      if (idk.y != id1) l[3] -= 100.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[i][e] = l[e];
    m0 = fmaxf(m0, fmaxf(l[0], l[1]));
    m1 = fmaxf(m1, fmaxf(l[2], l[3]));
  }
}

// sc <- exp(sc - row max) in place (exp(-inf) = 0 for padded keys); this
// lane's sums of its two rows
template <int NTH>
__device__ __forceinline__ void strip_exp(float (&sc)[NTH][4], float m0, float m1, float& sum0,
                                          float& sum1) {
  sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < NTH; ++i) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sc[i][e] = __expf(sc[i][e] - m0);
      sc[i][2 + e] = __expf(sc[i][2 + e] - m1);
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

// part p of P of the key steps (the first parts take the remainder), with
// the running row max m and sum carried from the parts before it
template <int KT, int P, int p>
__device__ __forceinline__ void strip_part(float (&o)[4][4], const unsigned (&qa)[2][4],
                                           const bf16* ks, const bf16* vs, const uint2* bias_s,
                                           const int* id_s, bool masked, int id0, int id1,
                                           int lane, float scale, float& m0, float& m1,
                                           float& sum0, float& sum1) {
  constexpr int J0 = (p * KT + P - 1) / P, KS = ((p + 1) * KT + P - 1) / P - J0;
  float sc[2 * KS][4];
  if constexpr (p == 0) {
    strip_logits<2 * KS>(sc, qa, ks, bias_s, id_s, masked, id0, id1, 0, lane, scale, m0, m1);
    m0 = quad_max(m0), m1 = quad_max(m1);
    strip_exp<2 * KS>(sc, m0, m1, sum0, sum1);
  } else {
    float n0, n1, t0, t1;
    strip_logits<2 * KS>(sc, qa, ks, bias_s, id_s, masked, id0, id1, 2 * J0, lane, scale, n0,
                         n1);
    n0 = fmaxf(m0, quad_max(n0)), n1 = fmaxf(m1, quad_max(n1));
    const float f0 = __expf(m0 - n0), f1 = __expf(m1 - n1);
#pragma unroll
    for (int d = 0; d < 4; ++d) o[d][0] *= f0, o[d][1] *= f0, o[d][2] *= f1, o[d][3] *= f1;
    strip_exp<2 * KS>(sc, n0, n1, t0, t1);
    sum0 = sum0 * f0 + t0, sum1 = sum1 * f1 + t1;
    m0 = n0, m1 = n1;
  }
  strip_pv<KS>(o, sc, 1.f, 1.f, vs, J0, lane);
  if constexpr (p + 1 < P) {
    strip_part<KT, P, p + 1>(o, qa, ks, vs, bias_s, id_s, masked, id0, id1, lane, scale, m0, m1,
                             sum0, sum1);
  }
}

// Strip s (rows s*16 .. s*16+15) of one (window, head): the staged q, k, v
// (qs, ks, vs), the head's bias in accumulator order (bias_h), the window's
// region ids in shared memory (id_s, read only when masked). Rows < N are
// written to out_b (the head's column 0 of the window's row 0) at row
// stride ldo.
template <int KT>
__device__ __forceinline__ void attend_strip(const bf16* qs, const bf16* ks, const bf16* vs,
                                             const uint2* bias_h, const int* id_s, bool masked,
                                             int s, int lane, int N, float scale, bf16* out_b,
                                             int ldo) {
  constexpr int NT = 2 * KT;  // 8-key n-tiles
  const int g = lane >> 2, tq = lane & 3;  // accumulator row / column pair of this lane
  unsigned qa[2][4];
  ldmatrix_x4(qa[0], a_tile_row(qs + s * 16 * kLd, kLd, lane));
  ldmatrix_x4(qa[1], a_tile_row(qs + s * 16 * kLd + 16, kLd, lane));
  // this lane holds rows q0 = s*16 + g and q1 = q0 + 8
  const int q0 = s * 16 + g, q1 = q0 + 8;
  const uint2* bias_s = bias_h + (long)s * NT * 32 + lane;
  const int id0 = masked ? id_s[q0] : 0, id1 = masked ? id_s[q1] : 0;
  float o[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float inv0, inv1;
  if constexpr (KT <= 16) {
    // one pass: the strip's whole 16 x Np logits in registers
    float sc[NT][4], m0, m1;
    strip_logits<NT>(sc, qa, ks, bias_s, id_s, masked, id0, id1, 0, lane, scale, m0, m1);
    float sum0, sum1;
    strip_exp<NT>(sc, quad_max(m0), quad_max(m1), sum0, sum1);
    inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
    strip_pv<KT>(o, sc, inv0, inv1, vs, 0, lane);
    inv0 = inv1 = 1.f;
  } else {
    float m0, m1, sum0, sum1;
    strip_part<KT, kStripParts<KT>, 0>(o, qa, ks, vs, bias_s, id_s, masked, id0, id1, lane,
                                         scale, m0, m1, sum0, sum1);
    inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
  }
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int col = d * 8 + tq * 2;
    if (q0 < N) {
      *reinterpret_cast<unsigned*>(out_b + (long)q0 * ldo + col) =
          pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    }
    if (q1 < N) {
      *reinterpret_cast<unsigned*>(out_b + (long)q1 * ldo + col) =
          pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
    }
  }
}

}  // namespace wa
}  // namespace clover
