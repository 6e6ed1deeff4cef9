// K11: key-tiled (flash) window attention, head dim 32, any N:
//   out[b, h] = softmax(scale * q k^T + bias[h] - 100 * [id_q != id_k]) v
// with the bias in bf16, the region term only for shifted blocks (window b
// uses ids[b % nW]), as an online softmax over tiles of 64 keys.
//
// Replaces clover_tpu/ops/window_attention.py::_forward_long (#10: head-
// major q, k, v (Bn, nH, N, 32), reached from the flat qkv through
// _forward_long_from_flat's relayout) and ::_forward_flat_flash (#11: the
// same recurrence on the flat (Bn*N, 3C) qkv, out (Bn*N, C)): one kernel
// template, two row layouts (wa::HeadRows, wa::FlatRows). The TPU reaches
// them under CLOVER_WA_LONG when no all-keys block fits its VMEM; the port
// picks them by SwinConfig.long_attn at N >= 384.
//
// Why it exists beside K1: its live state is O(tile), not O(N). A warp
// holds its 16-row query strip's q fragments, a 16 x 64 logit tile, the
// running row max and sum (fp32) and the 16 x 32 fp32 accumulator in
// registers; a block stages one 64-row query tile and a double-buffered
// ring of 64-key K / V tiles (cp.async) in 25 KB of shared memory. So it
// has no N limit (K1 keeps whole 16 x Np strips and stops at 400).
//
// Bound on the H100: 4*N*N*32 flops per (window, head) against ~8*N*32
// bytes of q, k, v and out plus the L2-resident bf16 bias; the K / V tiles
// are read once per 64-row query tile (7 times at N=392), from L2.
// Design: a block of 4 warps per (window, 64-row query tile, head), x =
// window * query tiles + tile, y = head. Per key tile: S = q k^T with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix fragments, *
// scale, + the bf16 bias and the -100 region term read per lane (-inf past
// N keys: the partial last tile, 392 = 6 * 64 + 8), the running max
// updated with one quad shuffle pair, the accumulator and sum rescaled by
// exp(m_old - m_new), P = exp(S - m_new) rounded to bf16 as the A operand
// of P.V (V through ldmatrix.trans); one division at the end. The same
// steps as the plain version (ops/window_attention.py::_flash_plain,
// FLASH_KEYS = 64), whose tiles the JAX kernel takes at 128 keys.

#include "window_attention.cuh"

namespace clover {
namespace {

using wa::kHd;
using wa::kLd;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTq = kWarps * 16;  // query rows per block
constexpr int kTk = 64;           // keys per tile

// K11's terms on the key tile from key0: rows q0, q1 of the head's bf16
// bias (clamped to N - 1), -100 where a key's region id is not the row's,
// -inf past N keys
struct FlashTerms {
  const bf16* b0;
  const bf16* b1;
  const int* ids;  // the window's region ids, or nullptr
  int id0, id1, N, tq, key0;
  __device__ __forceinline__ void add(int nt, float (&l)[4]) const {
    const int k = key0 + nt * 8 + tq * 2;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if (k + e < N) {
        l[e] += __bfloat162float(b0[k + e]);
        l[2 + e] += __bfloat162float(b1[k + e]);
        if (ids != nullptr) {
          const int idk = __ldg(ids + k + e);
          if (idk != id0) l[e] -= 100.f;
          if (idk != id1) l[2 + e] -= 100.f;
        }
      } else {
        l[e] = -INFINITY, l[2 + e] = -INFINITY;
      }
    }
  }
};

// rows [r0, r0 + n) of the head (element offsets rows.in(r) of src) into
// shared memory at row stride kLd, zero past N; one cp.async group's share
template <class Rows>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, const Rows& rows, int r0,
                                           int n, int N) {
  for (int i = threadIdx.x; i < n * 4; i += kThreads) {
    const int r = i >> 2, part = (i & 3) * 8;
    const bool valid = r0 + r < N;
    cp_async16_zfill(dst + r * kLd + part, src + rows.in(valid ? r0 + r : 0) + part, valid);
  }
}

struct HeadMajor {  // #10: (Bn, nH, N, 32) q, k, v and out
  int nH, N;
  __device__ wa::HeadRows rows(int b, int h) const { return {(long(b) * nH + h) * N * kHd}; }
};

struct Flat {  // #11: (Bn*N, 3C) qkv, (Bn*N, C) out
  int N, C;
  __device__ wa::FlatRows rows(int b, int h) const { return {long(b) * N, C, h}; }
};

template <class Layout>
__global__ void __launch_bounds__(kThreads)
flash_window_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const bf16* __restrict__ bias,
                              const int* __restrict__ ids, bf16* __restrict__ out, int N, int nW,
                              float scale, Layout layout) {
  __shared__ __align__(128) bf16 qs[kTq * kLd];
  __shared__ __align__(128) bf16 ks[2][kTk * kLd];
  __shared__ __align__(128) bf16 vs[2][kTk * kLd];
  const int q_tiles = (N + kTq - 1) / kTq, k_tiles = (N + kTk - 1) / kTk;
  const int b = blockIdx.x / q_tiles, row0 = (blockIdx.x % q_tiles) * kTq, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const auto rows = layout.rows(b, h);

  stage_rows(qs, q, rows, row0, kTq, N);
  stage_rows(ks[0], k, rows, 0, kTk, N);
  stage_rows(vs[0], v, rows, 0, kTk, N);
  cp_async_commit();

  // this lane's rows q0 = row0 + warp*16 + g and q1 = q0 + 8
  const int q0 = row0 + warp * 16 + (lane >> 2), q1 = q0 + 8;
  const bool active = row0 + warp * 16 < N;  // a strip wholly past N only stages
  const int* ids_w = ids != nullptr ? ids + long(b % nW) * N : nullptr;
  const long c0 = min(q0, N - 1), c1 = min(q1, N - 1);
  FlashTerms terms{bias + (long(h) * N + c0) * N, bias + (long(h) * N + c1) * N, ids_w,
                   ids_w != nullptr ? ids_w[c0] : 0, ids_w != nullptr ? ids_w[c1] : 0, N,
                   lane & 3, 0};
  unsigned qa[2][4];
  float o[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, sum0 = 0.f, sum1 = 0.f;

  for (int j = 0; j < k_tiles; ++j) {
    if (j + 1 < k_tiles) {  // the next tile's copies in flight while this one computes
      stage_rows(ks[(j + 1) & 1], k, rows, (j + 1) * kTk, kTk, N);
      stage_rows(vs[(j + 1) & 1], v, rows, (j + 1) * kTk, kTk, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      if (j == 0) {
        ldmatrix_x4(qa[0], a_tile_row(qs + warp * 16 * kLd, kLd, lane));
        ldmatrix_x4(qa[1], a_tile_row(qs + warp * 16 * kLd + 16, kLd, lane));
      }
      terms.key0 = j * kTk;
      float sc[kTk / 8][4], n0, n1, t0, t1;
      wa::strip_logits<kTk / 8>(sc, qa, ks[j & 1], terms, 0, lane, scale, n0, n1);
      n0 = fmaxf(m0, quad_max(n0)), n1 = fmaxf(m1, quad_max(n1));
      const float f0 = __expf(m0 - n0), f1 = __expf(m1 - n1);  // 0 at the first tile
#pragma unroll
      for (int d = 0; d < 4; ++d) o[d][0] *= f0, o[d][1] *= f0, o[d][2] *= f1, o[d][3] *= f1;
      wa::strip_exp<kTk / 8>(sc, n0, n1, t0, t1);
      sum0 = sum0 * f0 + t0, sum1 = sum1 * f1 + t1;
      m0 = n0, m1 = n1;
      wa::strip_pv<kTk / 16>(o, sc, 1.f, 1.f, vs[j & 1], 0, lane);
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }
  if (!active) return;
  const float inv0 = 1.f / quad_sum(sum0), inv1 = 1.f / quad_sum(sum1);
  const int tq = lane & 3;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int col = d * 8 + tq * 2;
    if (q0 < N) {
      *reinterpret_cast<unsigned*>(out + rows.out(q0) + col) =
          pack_bf16(o[d][0] * inv0, o[d][1] * inv0);
    }
    if (q1 < N) {
      *reinterpret_cast<unsigned*>(out + rows.out(q1) + col) =
          pack_bf16(o[d][2] * inv1, o[d][3] * inv1);
    }
  }
}

template <class Layout>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* ids,
           void* out, int Bn, int N, int nH, int nW, float scale, Layout layout,
           cudaStream_t stream) {
  if (Bn <= 0 || N <= 0 || nH <= 0 || (ids != nullptr && (nW <= 0 || Bn % nW))) {
    return (int)cudaErrorInvalidValue;
  }
  const long blocks = long(Bn) * ((N + kTq - 1) / kTq);
  if (blocks > 0x7fffffffL || nH > 65535) return (int)cudaErrorInvalidValue;
  flash_window_attention_kernel<Layout><<<dim3((unsigned)blocks, nH), kThreads, 0, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)bias, (const int*)ids,
      (bf16*)out, N, ids != nullptr ? nW : 1, scale, layout);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// #10's layout: q, k, v, out (Bn, nH, N, 32); bias (nH, N, N) bf16; ids
// (nW, N) int32 or null.
extern "C" int clover_flash_heads(const void* q, const void* k, const void* v, const void* bias,
                                  const void* ids, void* out, int Bn, int N, int nH, int nW,
                                  float scale, void* stream) {
  using namespace clover;
  return launch(q, k, v, bias, ids, out, Bn, N, nH, nW, scale, HeadMajor{nH, N},
                (cudaStream_t)stream);
}

// #11's layout: qkv (Bn*N, 3C), out (Bn*N, C), C = 32 nH.
extern "C" int clover_flash_flat(const void* qkv, const void* bias, const void* ids, void* out,
                                 int Bn, int N, int nH, int nW, float scale, void* stream) {
  using namespace clover;
  const int C = nH * kHd;
  const bf16* q = static_cast<const bf16*>(qkv);
  return launch(q, q + C, q + 2 * C, bias, ids, out, Bn, N, nH, nW, scale, Flat{N, C},
                (cudaStream_t)stream);
}
