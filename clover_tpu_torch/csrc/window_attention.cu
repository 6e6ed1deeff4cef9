// K1: shifted-window attention on the flat (Bn*N, 3C) qkv, head dim 32.
//
// For window b and head h:
//   out[b, :, h] = softmax(scale * q k^T + bias[h] - 100 * [id_q != id_k]) v
// with the region term only for shifted blocks (ids != nullptr; window b
// uses ids[b % nW]). The output is written in place in the flat (Bn*N, C)
// layout the proj GEMM reads.
//
// Replaces clover_tpu/ops/window_attention.py::_forward_flat2 (the Pallas
// kernel behind flat2_window_attention) and ::_forward_flat, its fallback
// for (Bn, N, 3C) qkv -- the same memory, so one kernel serves both.
//
// Bound on the H100: 4*N*N*hd flops per (window, head) against ~8*N*hd
// bytes of q/k/v/out plus the L2-resident bias, i.e. ~N/2 flop per byte:
// at N=196 the kernel sits below the ridge, so the (N, N) logits must never
// reach device memory and the softmax must not serialise the warps.
// Design: one block per (window, head), 4 warps. The block stages the
// head's q, k, v (N padded to a multiple of 16 with zero rows) in shared
// memory. Each warp takes 16-row query strips and keeps the strip's whole
// 16 x Np logits in registers as mma.sync (m16n8k16, bf16 in, fp32
// accumulate) accumulators: a thread holds two rows, so the row max and
// sum are two quad shuffles. The bias comes in that accumulator order
// (the wrapper lays it out once per call, -inf in the padded keys), so a
// lane reads its strip's bias as NT coalesced 8-byte loads. Padded query
// rows are never stored. The normalised probabilities are repacked in
// registers as the bf16 A operand of the P.V product (the accumulator
// layout of two n-tiles is the A layout of one k-step), and V comes in
// through ldmatrix.trans. Past 16 key tiles (N > 256: the 12-frame window
// 6x7x7, N=294) the whole strip would take 152 logits a lane and spill, so
// the strip is walked in two key halves with an online max / sum rescale
// (unnormalised probabilities into P.V, one division at the end); up to 16
// tiles it stays one pass. The TPU kernel's static softmax shift and
// region-lanes mask are TPU devices and are not carried over.

#include "common.cuh"

namespace clover {
namespace {

constexpr int kHd = 32;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLd = kHd + 8;  // row stride of the staged q/k/v: no ldmatrix bank conflicts

template <int KT>
constexpr size_t smem_bytes() {
  return align128(size_t(3) * KT * 16 * kLd * sizeof(bf16)) + KT * 16 * sizeof(int);
}

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

// KT: 16-key tiles, N <= 16 * KT
template <int KT>
__global__ void __launch_bounds__(kThreads)
window_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bias,
                        const int* __restrict__ ids, bf16* __restrict__ out, int N, int nH,
                        int nW, float scale) {
  constexpr int Np = KT * 16, NT = 2 * KT;  // padded keys; 8-key n-tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + Np * kLd;
  bf16* vs = ks + Np * kLd;
  int* id_s = reinterpret_cast<int*>(smem + align128(size_t(3) * Np * kLd * sizeof(bf16)));
  const int b = blockIdx.x, h = blockIdx.y;
  const int C = nH * kHd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // stage q, k, v of this (window, head): 4 x 16-byte pieces per 32-wide row
  const bf16* base = qkv + (long)b * N * 3 * C + h * kHd;
  for (int i = threadIdx.x; i < Np * 4; i += kThreads) {
    const int r = i >> 2, part = (i & 3) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv;
    if (r < N) {
      const bf16* row = base + (long)r * 3 * C + part;
      qv = *reinterpret_cast<const uint4*>(row);
      kv = *reinterpret_cast<const uint4*>(row + C);
      vv = *reinterpret_cast<const uint4*>(row + 2 * C);
    }
    *reinterpret_cast<uint4*>(qs + r * kLd + part) = qv;
    *reinterpret_cast<uint4*>(ks + r * kLd + part) = kv;
    *reinterpret_cast<uint4*>(vs + r * kLd + part) = vv;
  }
  const bool masked = ids != nullptr;
  if (masked) {
    for (int r = threadIdx.x; r < Np; r += kThreads) {
      id_s[r] = r < N ? ids[(long)(b % nW) * N + r] : -1;
    }
  }
  __syncthreads();

  // bias in accumulator order: [h][strip][n-tile][lane] x (q0: k, k+1; q1: k, k+1)
  const uint2* bias_h = reinterpret_cast<const uint2*>(bias) + (long)h * KT * NT * 32;
  bf16* out_b = out + (long)b * N * C + h * kHd;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row / column pair of this lane
  const int strips = (N + 15) / 16;
  for (int s = warp; s < strips; s += kWarps) {
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
      // two key halves of KA and KB 16-key steps, online max / sum rescale
      constexpr int KA = (KT + 1) / 2, KB = KT - KA;
      float m0, m1, sum0, sum1;
      {
        float sc[2 * KA][4];
        strip_logits<2 * KA>(sc, qa, ks, bias_s, id_s, masked, id0, id1, 0, lane, scale, m0, m1);
        m0 = quad_max(m0), m1 = quad_max(m1);
        strip_exp<2 * KA>(sc, m0, m1, sum0, sum1);
        strip_pv<KA>(o, sc, 1.f, 1.f, vs, 0, lane);
      }
      {
        float sc[2 * KB][4], n0, n1, t0, t1;
        strip_logits<2 * KB>(sc, qa, ks, bias_s, id_s, masked, id0, id1, 2 * KA, lane, scale,
                             n0, n1);
        n0 = fmaxf(m0, quad_max(n0)), n1 = fmaxf(m1, quad_max(n1));
        const float f0 = __expf(m0 - n0), f1 = __expf(m1 - n1);
#pragma unroll
        for (int d = 0; d < 4; ++d) o[d][0] *= f0, o[d][1] *= f0, o[d][2] *= f1, o[d][3] *= f1;
        strip_exp<2 * KB>(sc, n0, n1, t0, t1);
        sum0 = sum0 * f0 + t0, sum1 = sum1 * f1 + t1;
        strip_pv<KB>(o, sc, 1.f, 1.f, vs, KA, lane);
      }
      inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const int col = d * 8 + tq * 2;
      if (q0 < N) {
        *reinterpret_cast<unsigned*>(out_b + (long)q0 * C + col) =
            pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
      }
      if (q1 < N) {
        *reinterpret_cast<unsigned*>(out_b + (long)q1 * C + col) =
            pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
      }
    }
  }
}

template <int KT>
int launch(const void* qkv, const void* bias, const void* ids, void* out, int Bn, int N, int nH,
           int nW, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KT>();
  cudaError_t err = cudaFuncSetAttribute(window_attention_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attention_kernel<KT><<<dim3(Bn, nH), kThreads, smem, stream>>>(
      (const bf16*)qkv, (const bf16*)bias, (const int*)ids, (bf16*)out, N, nH, nW, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// key_tiles: 16-key tiles the caller padded N (and laid out the bias) to.
// The logits strip lives in registers, so it is a template argument with
// these instances: Swin's windows 6x7x7 (N=294, 12 frames), 4x7x7 (N=196),
// 2x7x7 (N=98), smaller.
extern "C" int clover_window_attention(const void* qkv, const void* bias, const void* ids,
                                       void* out, int Bn, int N, int nH, int nW, int key_tiles,
                                       float scale, void* stream) {
  using namespace clover;
  if (Bn <= 0 || N <= 0 || N > 16 * key_tiles || nH <= 0 ||
      (ids != nullptr && (nW <= 0 || Bn % nW))) {
    return (int)cudaErrorInvalidValue;
  }
  nW = ids != nullptr ? nW : 1;
  cudaStream_t st = (cudaStream_t)stream;
  switch (key_tiles) {
    case 4: return launch<4>(qkv, bias, ids, out, Bn, N, nH, nW, scale, st);
    case 7: return launch<7>(qkv, bias, ids, out, Bn, N, nH, nW, scale, st);
    case 13: return launch<13>(qkv, bias, ids, out, Bn, N, nH, nW, scale, st);
    case 16: return launch<16>(qkv, bias, ids, out, Bn, N, nH, nW, scale, st);
    case 19: return launch<19>(qkv, bias, ids, out, Bn, N, nH, nW, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
