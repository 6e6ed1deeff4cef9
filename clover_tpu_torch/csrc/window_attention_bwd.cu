// K5: backward of K1, the shifted-window attention on the flat qkv.
//
// For window b and head h, with qs = bf16(q * scale), the kernel recomputes
//   logits = qs k^T + bias[h] - 100 * [id_q != id_k],  P = softmax(logits) (fp32)
// and, for the incoming gradient g of the output,
//   dp = g v^T,  dlog = P * (dp - rowsum(dp * P)),
//   dq = bf16(dlog) k * scale,  dk = bf16(dlog)^T qs,  dv = bf16(P)^T g,
//   dbias[h] = sum over the windows of dlog (fp32).
// dq, dk, dv are written in place in the flat (Bn*N, 3C) layout the qkv
// GEMM's backward reads. The shift mask gets no gradient.
//
// Replaces clover_tpu/ops/window_attention.py::_backward_flat2 and
// ::_backward_flat2_grouped (the Pallas kernels behind the custom vjp of
// flat2_window_attention), and ::_backward_flat / ::_backward_flat_grouped,
// the same function on a (Bn, N, 3C) view; the grouped form is what the
// TPU runs at N=392 (the 32-frame 8x7x7 window, 25 key tiles here). The
// math is _bwd_softmax_core's default p32 form with the true row max.
//
// Bound on the H100: 9 products of N x N x hd per (window, head) against
// ~12*N*hd bytes of q/k/v/g/dq/dk/dv, i.e. compute-bound on the tensor cores
// once the (N, N) logits stay out of device memory. dbias is the other
// cost: (nH, N, N) fp32 summed over up to 1024 windows.
// Design: one block of 4 warps (8 at 25 key tiles, see kWarps) per
// (window chunk, head) walks the chunk's windows. It stages the head's qs,
// k, v, g (N padded to a multiple of 16, zero rows) in shared memory.
// Phase R: each warp takes 16-row query strips, sweeps the keys once for
// the row max, sum and rowsum(dp * P) (online, per lane, combined over the
// quad), keeps them in shared memory,
// then sweeps again for dlog, multiplies it into dq from registers and adds
// it into the block's dbias partial. Phase C: each warp takes 16-key tiles
// and walks all query strips with the transposed products, so dk and dv
// sum over the queries in registers and no two warps write one row. All
// products are mma.sync m16n8k16, bf16 in, fp32 accumulate; a lane never
// holds more than two 8-key tiles of logits, so any N the staging fits
// takes no extra registers (the key loops run to the window's strips, not
// to KT: KT sets only the staging and the bias layout). Shared memory at
// 25 tiles: qs, k, v, g at 400 padded rows and the row statistics, 134 KB,
// one block an SM, so that instance runs 8 warps a block. dbias is
// deterministic: each block owns an (Np, Np) fp32 partial per chunk in
// device memory, stored in the accumulators' order (coalesced float4 per
// lane) and owned by one lane per element, and a second kernel sums the
// chunks in a fixed order.

#include "common.cuh"

namespace clover {
namespace {

constexpr int kHd = 32;
constexpr int kLd = kHd + 8;  // row stride of the staged tiles: no ldmatrix bank conflicts

template <int KT>
constexpr size_t bwd_smem_bytes() {
  return align128(size_t(4) * KT * 16 * kLd * sizeof(bf16)) + KT * 16 * (3 * sizeof(float) + sizeof(int));
}

// warps a block: 4 while two blocks fit an SM's shared memory; past that
// (25 key tiles) one block an SM would run 4 warps alone, so it takes 8.
// Strips and key tiles are owned by one warp whatever the count, so the
// outputs do not depend on it.
template <int KT>
constexpr int kWarps = 2 * bwd_smem_bytes<KT>() <= 227 * 1024 ? 4 : 8;

// logits of one 8-key tile from its raw product: + bias + region mask
__device__ __forceinline__ void add_bias_mask(float (&l)[4], const float (&s)[4], uint2 bv,
                                              bool masked, int id0, int id1, int2 idk) {
  const float2 b0 = bf16x2_to_float2(bv.x), b1 = bf16x2_to_float2(bv.y);
  l[0] = s[0] + b0.x;
  l[1] = s[1] + b0.y;
  l[2] = s[2] + b1.x;
  l[3] = s[3] + b1.y;
  if (masked) {
    if (idk.x != id0) l[0] -= 100.f;
    if (idk.y != id0) l[1] -= 100.f;
    if (idk.x != id1) l[2] -= 100.f;
    if (idk.y != id1) l[3] -= 100.f;
  }
}

// KT: 16-key tiles, N <= 16 * KT
template <int KT>
__global__ void __launch_bounds__(kWarps<KT> * 32)
window_attention_bwd_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                            const bf16* __restrict__ bias_r, const bf16* __restrict__ bias_c,
                            const int* __restrict__ ids, bf16* __restrict__ dqkv,
                            float* __restrict__ part, int Bn, int N, int nH, int nW, int chunks,
                            float scale) {
  constexpr int Np = KT * 16, NT = 2 * KT;  // padded keys; 8-key n-tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + Np * kLd;
  bf16* vs = ks + Np * kLd;
  bf16* gs = vs + Np * kLd;
  float* m_s = reinterpret_cast<float*>(smem + align128(size_t(4) * Np * kLd * sizeof(bf16)));
  float* il_s = m_s + Np;  // 1 / row sum
  float* d_s = il_s + Np;  // rowsum(dp * P)
  int* id_s = reinterpret_cast<int*>(d_s + Np);
  const int chunk = blockIdx.x, h = blockIdx.y;
  const int C = nH * kHd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row / column pair of this lane
  const int strips = (N + 15) / 16;
  const bool masked = ids != nullptr;
  // bias in accumulator order, [h][strip][n-tile][lane] x 4: rows are
  // queries (bias_r) or keys (bias_c, the transpose)
  const uint2* bias_rh = reinterpret_cast<const uint2*>(bias_r) + (long)h * KT * NT * 32;
  const uint2* bias_ch = reinterpret_cast<const uint2*>(bias_c) + (long)h * KT * NT * 32;
  float4* part_h = reinterpret_cast<float4*>(part) + ((long)chunk * nH + h) * KT * NT * 32;

  for (int b = chunk; b < Bn; b += chunks) {
    const bool first = b == chunk;
    // stage qs = bf16(q * scale), k, v, g of this (window, head)
    const bf16* base = qkv + (long)b * N * 3 * C + h * kHd;
    const bf16* gbase = grad + (long)b * N * C + h * kHd;
    for (int i = threadIdx.x; i < Np * 4; i += kWarps<KT> * 32) {
      const int r = i >> 2, part8 = (i & 3) * 8;
      uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv, gv = qv;
      if (r < N) {
        const bf16* row = base + (long)r * 3 * C + part8;
        qv = *reinterpret_cast<const uint4*>(row);
        kv = *reinterpret_cast<const uint4*>(row + C);
        vv = *reinterpret_cast<const uint4*>(row + 2 * C);
        gv = *reinterpret_cast<const uint4*>(gbase + (long)r * C + part8);
        unsigned* qw = reinterpret_cast<unsigned*>(&qv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = bf16x2_to_float2(qw[e]);
          qw[e] = pack_bf16(f.x * scale, f.y * scale);
        }
      }
      *reinterpret_cast<uint4*>(qs + r * kLd + part8) = qv;
      *reinterpret_cast<uint4*>(ks + r * kLd + part8) = kv;
      *reinterpret_cast<uint4*>(vs + r * kLd + part8) = vv;
      *reinterpret_cast<uint4*>(gs + r * kLd + part8) = gv;
    }
    if (masked) {
      for (int r = threadIdx.x; r < Np; r += kWarps<KT> * 32) {
        id_s[r] = r < N ? ids[(long)(b % nW) * N + r] : -1;
      }
    }
    __syncthreads();

    // ---- phase R: query strips -> row statistics, dq, dbias
    for (int s = warp; s < strips; s += kWarps<KT>) {
      unsigned qa[2][4], ga[2][4];
      ldmatrix_x4(qa[0], a_tile_row(qs + s * 16 * kLd, kLd, lane));
      ldmatrix_x4(qa[1], a_tile_row(qs + s * 16 * kLd + 16, kLd, lane));
      ldmatrix_x4(ga[0], a_tile_row(gs + s * 16 * kLd, kLd, lane));
      ldmatrix_x4(ga[1], a_tile_row(gs + s * 16 * kLd + 16, kLd, lane));
      const int q0 = s * 16 + g, q1 = q0 + 8;
      const int id0 = masked ? id_s[q0] : 0, id1 = masked ? id_s[q1] : 0;
      const uint2* bias_s = bias_rh + (long)s * NT * 32 + lane;

      // logits and dp of n-tile nt (keys nt*8 .. nt*8+7) of this strip
      auto tile = [&](int nt, float (&l)[4], float (&dp)[4]) {
        unsigned kb[4], vb[4];
        ldmatrix_x4(kb, ks + (nt * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
        ldmatrix_x4(vb, vs + (nt * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
        float sc[4] = {0.f, 0.f, 0.f, 0.f};
        dp[0] = dp[1] = dp[2] = dp[3] = 0.f;
        mma_bf16(sc, qa[0], kb[0], kb[1]);
        mma_bf16(sc, qa[1], kb[2], kb[3]);
        mma_bf16(dp, ga[0], vb[0], vb[1]);
        mma_bf16(dp, ga[1], vb[2], vb[3]);
        const int2 idk = masked ? *reinterpret_cast<const int2*>(id_s + nt * 8 + tq * 2)
                                : make_int2(0, 0);
        add_bias_mask(l, sc, bias_s[nt * 32], masked, id0, id1, idk);
      };

      // sweep 1: per lane, online over its own keys: max, sum exp, sum exp*dp
      float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
      for (int nt = 0; nt < 2 * strips; ++nt) {
        float l[4], dp[4];
        tile(nt, l, dp);
        const int key = nt * 8 + tq * 2;
        const bool v0 = key < N, v1 = key + 1 < N;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float a = v0 ? l[2 * r] : -INFINITY, c = v1 ? l[2 * r + 1] : -INFINITY;
          const float mt = fmaxf(a, c);
          if (mt == -INFINITY) continue;
          if (mt > m[r]) {
            const float f = __expf(m[r] - mt);  // 0 while m is -inf
            sum[r] *= f;
            dsum[r] *= f;
            m[r] = mt;
          }
          const float ea = v0 ? __expf(a - m[r]) : 0.f, ec = v1 ? __expf(c - m[r]) : 0.f;
          sum[r] += ea + ec;
          dsum[r] += ea * dp[2 * r] + ec * dp[2 * r + 1];
        }
      }
      float M[2], inv[2], D[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        M[r] = quad_max(m[r]);
        const float f = m[r] == -INFINITY ? 0.f : __expf(m[r] - M[r]);
        inv[r] = 1.f / quad_sum(sum[r] * f);
        D[r] = quad_sum(dsum[r] * f) * inv[r];
      }
      if (tq == 0) {
        m_s[q0] = M[0], il_s[q0] = inv[0], d_s[q0] = D[0];
        m_s[q1] = M[1], il_s[q1] = inv[1], d_s[q1] = D[1];
      }

      // sweep 2: dlog -> dbias partial, dq += bf16(dlog) k over 16-key steps
      float dq[4][4];
#pragma unroll
      for (int d = 0; d < 4; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
      for (int j = 0; j < strips; ++j) {
        float dl[2][4];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int nt = 2 * j + u;
          float l[4], dp[4];
          tile(nt, l, dp);
          const int key = nt * 8 + tq * 2;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const float p = key + (e & 1) < N ? __expf(l[e] - M[r]) * inv[r] : 0.f;
            dl[u][e] = p * (dp[e] - D[r]);
          }
          float4* slot = part_h + ((long)s * NT + nt) * 32 + lane;
          float4 acc = make_float4(dl[u][0], dl[u][1], dl[u][2], dl[u][3]);
          if (!first) {
            const float4 old = *slot;
            acc.x += old.x, acc.y += old.y, acc.z += old.z, acc.w += old.w;
          }
          *slot = acc;
        }
        const unsigned pa[4] = {pack_bf16(dl[0][0], dl[0][1]), pack_bf16(dl[0][2], dl[0][3]),
                                pack_bf16(dl[1][0], dl[1][1]), pack_bf16(dl[1][2], dl[1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < 2; ++dp2) {  // head columns dp2*16 .. dp2*16+15
          unsigned kb[4];
          ldmatrix_x4_trans(kb, a_tile_row(ks + j * 16 * kLd + dp2 * 16, kLd, lane));
          mma_bf16(dq[2 * dp2], pa, kb[0], kb[1]);
          mma_bf16(dq[2 * dp2 + 1], pa, kb[2], kb[3]);
        }
      }
      bf16* dq_b = dqkv + (long)b * N * 3 * C + h * kHd;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int col = d * 8 + tq * 2;
        if (q0 < N) {
          *reinterpret_cast<unsigned*>(dq_b + (long)q0 * 3 * C + col) =
              pack_bf16(dq[d][0] * scale, dq[d][1] * scale);
        }
        if (q1 < N) {
          *reinterpret_cast<unsigned*>(dq_b + (long)q1 * 3 * C + col) =
              pack_bf16(dq[d][2] * scale, dq[d][3] * scale);
        }
      }
    }
    __syncthreads();  // row statistics of every strip are in shared memory

    // ---- phase C: 16-key tiles -> dk, dv summed over all query strips
    for (int kt = warp; kt < strips; kt += kWarps<KT>) {
      unsigned ka[2][4], va[2][4];
      ldmatrix_x4(ka[0], a_tile_row(ks + kt * 16 * kLd, kLd, lane));
      ldmatrix_x4(ka[1], a_tile_row(ks + kt * 16 * kLd + 16, kLd, lane));
      ldmatrix_x4(va[0], a_tile_row(vs + kt * 16 * kLd, kLd, lane));
      ldmatrix_x4(va[1], a_tile_row(vs + kt * 16 * kLd + 16, kLd, lane));
      const int k0 = kt * 16 + g, k1 = k0 + 8;
      const int idk0 = masked ? id_s[k0] : 0, idk1 = masked ? id_s[k1] : 0;
      const uint2* bias_k = bias_ch + (long)kt * NT * 32 + lane;
      float dk[4][4], dv[4][4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
        dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
      }
      for (int s = 0; s < strips; ++s) {
        float pt[2][4], dlt[2][4];  // P^T and dlog^T: rows keys k0, k1; columns queries
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qt = 2 * s + u;  // queries qt*8 .. qt*8+7
          unsigned qb[4], gb[4];
          ldmatrix_x4(qb, qs + (qt * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
          ldmatrix_x4(gb, gs + (qt * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
          float sc[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(sc, ka[0], qb[0], qb[1]);
          mma_bf16(sc, ka[1], qb[2], qb[3]);
          mma_bf16(dpt, va[0], gb[0], gb[1]);
          mma_bf16(dpt, va[1], gb[2], gb[3]);
          const int q = qt * 8 + tq * 2;
          const int2 idq = masked ? *reinterpret_cast<const int2*>(id_s + q) : make_int2(0, 0);
          float l[4];
          add_bias_mask(l, sc, bias_k[qt * 32], masked, idk0, idk1, idq);
          const float2 mq = *reinterpret_cast<const float2*>(m_s + q);
          const float2 iq = *reinterpret_cast<const float2*>(il_s + q);
          const float2 dq2 = *reinterpret_cast<const float2*>(d_s + q);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool hi = e & 1;  // column q + 1
            const float p = q + hi < N ? __expf(l[e] - (hi ? mq.y : mq.x)) * (hi ? iq.y : iq.x)
                                       : 0.f;
            pt[u][e] = p;
            dlt[u][e] = p * (dpt[e] - (hi ? dq2.y : dq2.x));
          }
        }
        const unsigned pa[4] = {pack_bf16(pt[0][0], pt[0][1]), pack_bf16(pt[0][2], pt[0][3]),
                                pack_bf16(pt[1][0], pt[1][1]), pack_bf16(pt[1][2], pt[1][3])};
        const unsigned da[4] = {pack_bf16(dlt[0][0], dlt[0][1]), pack_bf16(dlt[0][2], dlt[0][3]),
                                pack_bf16(dlt[1][0], dlt[1][1]), pack_bf16(dlt[1][2], dlt[1][3])};
#pragma unroll
        for (int dp2 = 0; dp2 < 2; ++dp2) {  // head columns dp2*16 .. dp2*16+15
          unsigned gt[4], qt4[4];
          ldmatrix_x4_trans(gt, a_tile_row(gs + s * 16 * kLd + dp2 * 16, kLd, lane));
          ldmatrix_x4_trans(qt4, a_tile_row(qs + s * 16 * kLd + dp2 * 16, kLd, lane));
          mma_bf16(dv[2 * dp2], pa, gt[0], gt[1]);
          mma_bf16(dv[2 * dp2 + 1], pa, gt[2], gt[3]);
          mma_bf16(dk[2 * dp2], da, qt4[0], qt4[1]);
          mma_bf16(dk[2 * dp2 + 1], da, qt4[2], qt4[3]);
        }
      }
      bf16* dk_b = dqkv + (long)b * N * 3 * C + C + h * kHd;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int col = d * 8 + tq * 2;
        if (k0 < N) {
          *reinterpret_cast<unsigned*>(dk_b + (long)k0 * 3 * C + col) = pack_bf16(dk[d][0], dk[d][1]);
          *reinterpret_cast<unsigned*>(dk_b + (long)k0 * 3 * C + C + col) =
              pack_bf16(dv[d][0], dv[d][1]);
        }
        if (k1 < N) {
          *reinterpret_cast<unsigned*>(dk_b + (long)k1 * 3 * C + col) = pack_bf16(dk[d][2], dk[d][3]);
          *reinterpret_cast<unsigned*>(dk_b + (long)k1 * 3 * C + C + col) =
              pack_bf16(dv[d][2], dv[d][3]);
        }
      }
    }
    __syncthreads();  // the next window overwrites the staged tiles
  }
}

// dbias[h][q][k] = sum over chunks of the partials, in chunk order
__global__ void __launch_bounds__(256)
dbias_finish_kernel(const float* __restrict__ part, float* __restrict__ dbias, int N, int nH,
                    int key_tiles, int chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)nH * N * N) return;
  const int k = (int)(i % N), q = (int)((i / N) % N), h = (int)(i / ((long)N * N));
  const int NT = 2 * key_tiles;
  // accumulator order: [strip][n-tile][lane = 4 * (q % 8) + (k % 8) / 2][2 * (q / 8 % 2) + k % 2]
  const long frag = (((long)(q >> 4) * NT + (k >> 3)) * 32 + (q & 7) * 4 + ((k >> 1) & 3)) * 4 +
                    ((q >> 3) & 1) * 2 + (k & 1);
  const long per = (long)key_tiles * 16 * key_tiles * 16;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += part[((long)c * nH + h) * per + frag];
  dbias[i] = acc;
}

template <int KT>
int launch_bwd(const void* qkv, const void* grad, const void* bias_r, const void* bias_c,
               const void* ids, void* dqkv, void* part, int Bn, int N, int nH, int nW, int chunks,
               float scale, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes<KT>();
  cudaError_t err = cudaFuncSetAttribute(window_attention_bwd_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_attention_bwd_kernel<KT><<<dim3(chunks, nH), kWarps<KT> * 32, smem, stream>>>(
      (const bf16*)qkv, (const bf16*)grad, (const bf16*)bias_r, (const bf16*)bias_c,
      (const int*)ids, (bf16*)dqkv, (float*)part, Bn, N, nH, nW, chunks, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// qkv (Bn*N, 3C), grad (Bn*N, C) bf16 -> dqkv (Bn*N, 3C) bf16, dbias (nH, N, N)
// fp32. bias_r / bias_c: the bf16 bias in accumulator order for key_tiles
// (as K1 takes it) and the same for its transpose; part: the chunks' fp32
// workspace, chunks x nH x (16 key_tiles)^2, written before it is read.
extern "C" int clover_window_attention_bwd(const void* qkv, const void* grad, const void* bias_r,
                                           const void* bias_c, const void* ids, void* dqkv,
                                           void* part, void* dbias, int Bn, int N, int nH, int nW,
                                           int key_tiles, int chunks, float scale, void* stream) {
  using namespace clover;
  if (Bn <= 0 || N <= 0 || N > 16 * key_tiles || nH <= 0 || chunks <= 0 || chunks > Bn ||
      (ids != nullptr && (nW <= 0 || Bn % nW))) {
    return (int)cudaErrorInvalidValue;
  }
  nW = ids != nullptr ? nW : 1;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
#define CLOVER_BWD_CASE(KT)                                                                     \
  case KT:                                                                                     \
    rc = launch_bwd<KT>(qkv, grad, bias_r, bias_c, ids, dqkv, part, Bn, N, nH, nW, chunks,     \
                        scale, st);                                                            \
    break;
  switch (key_tiles) {
    CLOVER_BWD_CASE(4)
    CLOVER_BWD_CASE(7)
    CLOVER_BWD_CASE(13)
    CLOVER_BWD_CASE(16)
    CLOVER_BWD_CASE(19)
    CLOVER_BWD_CASE(25)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CLOVER_BWD_CASE
  if (rc != 0) return rc;
  const long total = (long)nH * N * N;
  dbias_finish_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)part, (float*)dbias, N, nH, key_tiles, chunks);
  return (int)cudaGetLastError();
}
