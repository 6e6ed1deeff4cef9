// K11: key-tiled (flash) window attention, head dim 32, any N:
//   out[b, h] = softmax(scale * q k^T + bias[h] - 100 * [id_q != id_k]) v
// with the bias in bf16, the region term only for shifted blocks (window b
// uses ids[b % nW]), as an online softmax over tiles of 64 keys.
//
// Replaces clover_tpu/ops/window_attention.py::_forward_long (#10: head-
// major q, k, v (Bn, nH, N, 32), reached from the flat qkv through
// _forward_long_from_flat's relayout) and ::_forward_flat_flash (#11: the
// same recurrence on the flat (Bn*N, 3C) qkv, out (Bn*N, C)): one kernel
// template, two row layouts (wa::HeadRows, wa::FlatRows). K6's attention
// pass (attn_block.cu) runs it on the flat layout too. The TPU reaches
// them under CLOVER_WA_LONG when no all-keys block fits its VMEM; the port
// picks them by SwinConfig.long_attn at N >= 384.
//
// Why it exists beside K1: its live state is O(tile), not O(N). A warp
// holds its 16-row query strip's q fragments, a 16 x 64 logit tile, the
// running row max and sum (fp32) and the 16 x 32 fp32 accumulator in
// registers; a block stages 80 query rows and a double-buffered ring of
// 64-key K / V tiles with their region ids (cp.async), 27 KB of shared
// memory. So it has no N limit (K1 keeps whole 16 x Np strips and stops at
// 400).
//
// Bound on the H100: 4*N*N*32 flops per (window, head) against ~8*N*32
// bytes of q, k, v and out plus the bf16 bias; bytes bound it (3.84 ms per
// 32-frame forward). What holds it is latency: each warp's chain of
// ldmatrix, mma.sync, max, exp and P.V per tile, so the warps resident on
// an SM that have a strip set its pace, not the K / V traffic (read from
// L2 once per query tile, 5 times at N=392).
// Design: a block of 5 warps per (window, 80-row query tile, head), x =
// window * query tiles + tile, y = head, a warp per 16-row strip, four
// blocks an SM (96 registers, a few spilled): at N=392 the 25 strips fill
// 5 blocks with no idle warp, 20 busy warps an SM. (Measured slower on the
// H100: 4 warps, 28 slots for 25 strips; 7; 8 at two blocks an SM, 32
// slots, a block of 128 rows.) The terms are K1's (wa::RegionTerms): the
// bias as the wrapper lays it out in accumulator order
// (ops/window_attention.py::fragment_bias at ceil(N / 16) 16-key steps,
// -inf in the padded keys), one 8-byte load per lane and 8-key n-tile, and
// the key tile's region ids from shared memory, one int2 per n-tile. The
// walk stops at Np = 16 * ceil(N / 16) keys: whole 64-key tiles, then the
// last tile's 1-4 16-key steps (25 steps, 400 keys, at N=392); the -inf
// bias drops the padded keys of the last step and K / V rows past N are
// staged as zeros. Per tile (wa::strip_online): S = q k^T with mma.sync
// m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix fragments, in log2 units
// (* scale * log2(e), + the terms times log2(e) in the same FMA), the
// running max updated with one quad shuffle pair, the accumulator and sum
// rescaled by 2^(m_old - m_new), P = 2^(S - m_new) (ex2.approx, as __expf
// without its multiply) rounded to bf16 as the A operand of P.V (V through
// ldmatrix.trans); one division at the end. The same steps as the plain
// version (ops/window_attention.py::_flash_plain, FLASH_KEYS = 64), whose
// tiles the JAX kernel takes at 128 keys; ops/window_attention.py::
// flash_grid mirrors the launch shape.

#include <type_traits>

#include "window_attention.cuh"

namespace clover {
namespace {

using wa::kHd;
using wa::kLd;
constexpr int kWarps = 5;
constexpr int kBlocksPerSm = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTq = kWarps * 16;  // query rows per block
constexpr int kTk = 64;           // keys per tile
constexpr int kSteps = kTk / 16;  // 16-key steps of a whole tile
static_assert(kSteps == 4, "the tail switch below takes 1-4 steps");
template <int KS>
using Steps = std::integral_constant<int, KS>;

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

// region ids of keys [k0, k0 + n) into shared memory, 0 past N (those keys
// have a -inf bias)
__device__ __forceinline__ void stage_ids(int* dst, const int* ids, int k0, int n, int N) {
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const bool valid = k0 + i < N;
    cp_async4_zfill(dst + i, ids + (valid ? k0 + i : 0), valid);
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

// K6's attention pass: #11's layout under a type of its own, so that a
// profile tells K6's launches of this kernel from K11's
struct K6Flat : Flat {};

template <class Layout>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
flash_window_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const uint2* __restrict__ bias,
                              const int* __restrict__ ids, bf16* __restrict__ out, int N, int nW,
                              float scale, Layout layout) {
  __shared__ __align__(128) bf16 qs[kTq * kLd];
  __shared__ __align__(128) bf16 ks[2][kTk * kLd];
  __shared__ __align__(128) bf16 vs[2][kTk * kLd];
  __shared__ __align__(16) int id_s[2][kTk];
  const int KT = (N + 15) / 16;  // 16-key steps of the walk, and 16-row strips
  const int q_tiles = (N + kTq - 1) / kTq, k_tiles = (KT + kSteps - 1) / kSteps;
  const int b = blockIdx.x / q_tiles, row0 = (blockIdx.x % q_tiles) * kTq, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const auto rows = layout.rows(b, h);
  const int* ids_w = ids != nullptr ? ids + long(b % nW) * N : nullptr;

  // key tile j into buffer j % 2: its 16-key steps' K / V rows and region ids
  auto stage_keys = [&](int j) {
    const int k0 = j * kTk, n = min(kTk, 16 * KT - k0);
    stage_rows(ks[j & 1], k, rows, k0, n, N);
    stage_rows(vs[j & 1], v, rows, k0, n, N);
    if (ids_w != nullptr) stage_ids(id_s[j & 1], ids_w, k0, n, N);
  };
  stage_rows(qs, q, rows, row0, kTq, N);
  stage_keys(0);
  cp_async_commit();

  // this warp's strip s (rows s*16 .. s*16+15); this lane's rows q0, q1 = q0 + 8
  const int s = row0 / 16 + warp, q0 = s * 16 + (lane >> 2), q1 = q0 + 8;
  const bool active = s < KT;  // a strip wholly past N only stages
  const bool masked = ids_w != nullptr;
  // the strip's bias from n-tile 0, advanced a key tile at a time
  wa::RegionTerms<true> terms{bias + (long(h) * KT + s) * 2 * KT * 32 + lane, nullptr, masked,
                              masked && q0 < N ? __ldg(ids_w + q0) : 0,
                              masked && q1 < N ? __ldg(ids_w + q1) : 0, lane & 3};
  unsigned qa[2][4];
  float o[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, sum0 = 0.f, sum1 = 0.f;
  scale *= wa::kLog2e;  // the logits in log2 units

  for (int j = 0; j < k_tiles; ++j) {
    if (j + 1 < k_tiles) {  // the next tile's copies in flight while this one computes
      stage_keys(j + 1);
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
      terms.id_s = id_s[j & 1];
      const auto tile = [&](auto steps) {
        wa::strip_online<decltype(steps)::value, true>(o, qa, ks[j & 1], vs[j & 1], terms, 0, lane,
                                                       scale, m0, m1, sum0, sum1);
      };
      switch (min(kSteps, KT - j * kSteps)) {  // whole tiles, then the last one's steps
        case 4: tile(Steps<4>{}); break;
        case 3: tile(Steps<3>{}); break;
        case 2: tile(Steps<2>{}); break;
        default: tile(Steps<1>{});
      }
      terms.bias_s += kTk / 8 * 32;
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
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const uint2*)bias, (const int*)ids,
      (bf16*)out, N, ids != nullptr ? nW : 1, scale, layout);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// #10's layout: q, k, v, out (Bn, nH, N, 32); bias (nH, KT, 2 KT, 8, 4, 2,
// 2) bf16 in accumulator order, KT = ceil(N / 16); ids (nW, N) int32 or
// null.
extern "C" int clover_flash_heads(const void* q, const void* k, const void* v, const void* bias,
                                  const void* ids, void* out, int Bn, int N, int nH, int nW,
                                  float scale, void* stream) {
  using namespace clover;
  return launch(q, k, v, bias, ids, out, Bn, N, nH, nW, scale, HeadMajor{nH, N},
                (cudaStream_t)stream);
}

// #11's layout: qkv (Bn*N, 3C), out (Bn*N, C), C = 32 nH; bias and ids as
// #10's.
extern "C" int clover_flash_flat(const void* qkv, const void* bias, const void* ids, void* out,
                                 int Bn, int N, int nH, int nW, float scale, void* stream) {
  using namespace clover;
  const int C = nH * kHd;
  const bf16* q = static_cast<const bf16*>(qkv);
  return launch(q, q + C, q + 2 * C, bias, ids, out, Bn, N, nH, nW, scale, Flat{N, C},
                (cudaStream_t)stream);
}

// K6's pass 2 (attn_block.cu) on a chunk of whole windows: the arguments of
// clover_flash_flat.
extern "C" int clover_attn_block_attention(const void* qkv, const void* bias, const void* ids,
                                           void* out, int Bn, int N, int nH, int nW,
                                           float scale, void* stream) {
  using namespace clover;
  const int C = nH * kHd;
  const bf16* q = static_cast<const bf16*>(qkv);
  return launch(q, q + C, q + 2 * C, bias, ids, out, Bn, N, nH, nW, scale, K6Flat{{N, C}},
                (cudaStream_t)stream);
}
