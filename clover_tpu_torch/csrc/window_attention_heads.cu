// K9 and K10: window attention with an fp32 bias and an fp32 additive mask,
// head dim 32, N <= 400:
//   out[b, h] = softmax(scale * q k^T + bias[h] + mask[w(b)]) v
// with fp32 logits (bf16 products, fp32 accumulation), for each window b
// and head h; mask may be absent (unshifted block).
//
// K9 replaces clover_tpu/ops/window_attention.py::_forward (#7, a program
// per (window, head)) and ::_forward_v2 (#8, all heads of W windows a
// program; v2 a head loop, v4 one batched dot): three TPU blockings of one
// function on head-major (Bn, nH, N, 32) q, k, v and out; window b takes
// mask row b % nW. The TPU falls back to XLA where its VMEM cannot hold a
// block (N=392); this kernel takes every Swin-B window.
//
// K10 replaces ::fused_partition_window_attention (#9): the same attention
// with window b's token t = (td, th, tw) read straight from its 3C-wide qkv
// row in the padded (B, Dp, Hp, Wp, 3, nH, 32) grid and written to its
// C-wide row of the (B, Dp, Hp, Wp, nH, 32) output -- no partition or
// reverse copy; the mask is the (gd, gh, gw, N, N) grid, row (i, j, k) of
// the window's grid position. (On the TPU #9 runs only in interpret mode at
// 7-wide windows; Mosaic refuses the in-kernel collapse.)
//
// Bound on the H100: 4*N*N*32 flops per (window, head) against ~8*N*32
// bytes of q, k, v and out; the fp32 bias (nH*N*N) and the nW distinct
// mask tiles (nW*N*N fp32, 9.8 MB at the 8-frame stage 0) are read from
// device memory once and from L2 after that. At N=196 that is ~N/2 flops a
// byte, under the ridge: the logits must stay on chip.
// Design: K1's (window_attention.cuh) -- one block of 4 warps per (window,
// head), q, k, v of the head staged in shared memory (zero padded to 16 *
// KT rows), a warp's 16 x Np logit strip in mma.sync accumulators, an
// online rescale past 16 key tiles -- with DenseTerms adding the fp32 bias
// and mask, read per lane from L2 (rows clamped to N - 1, -inf past N
// keys), instead of K1's bf16 bias in accumulator order and region ids.
// A window's nH blocks each read its mask tile, from L2: on the H100 the
// mask adds ~13% to an 8-frame stage-0 call, the bound on what staging it
// once per window could gain; the scalar fp32 loads cost more (K9 takes
// about twice K1's time on the same shapes).

#include "window_attention.cuh"

namespace clover {
namespace {

using wa::kHd;
using wa::kLd;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int KT>
constexpr size_t smem_bytes() {
  return size_t(3) * KT * 16 * kLd * sizeof(bf16);
}

// K9: head-major q, k, v (Bn, nH, N, 32); window b of the grid's x
struct HeadMajor {
  int nH, N, nW;
  __device__ wa::HeadRows rows(int b, int h) const { return {(long(b) * nH + h) * N * kHd}; }
  __device__ int mask_row(int b) const { return b % nW; }
};

// K10: window b = ((bb * gd + i) * gh + j) * gw + k of a (B, Dp, Hp, Wp) grid
struct SpatialGrid {
  int Dp, Hp, Wp, wd, wh, ww, C;
  __device__ int windows() const { return (Dp / wd) * (Hp / wh) * (Wp / ww); }
  __device__ wa::GridRows rows(int b, int h) const {
    const int gh = Hp / wh, gw = Wp / ww, gd = Dp / wd;
    const int k = b % gw, j = (b / gw) % gh, i = (b / (gw * gh)) % gd, bb = b / (gw * gh * gd);
    const long corner = ((long(bb) * Dp + i * wd) * Hp + j * wh) * Wp + k * ww;
    return {corner, Hp, Wp, wh, ww, C, h};
  }
  __device__ int mask_row(int b) const { return b % windows(); }
};

// q, k, v: base pointers whose element offset rows.in(r) is row r of the
// head (K10: the same qkv shifted by 0, C, 2C)
template <int KT, class Layout>
__global__ void __launch_bounds__(kThreads)
window_attention_heads_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const float* __restrict__ bias,
                              const float* __restrict__ mask, bf16* __restrict__ out, int N,
                              float scale, Layout layout) {
  constexpr int Np = KT * 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + Np * kLd;
  bf16* vs = ks + Np * kLd;
  const int b = blockIdx.x, h = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const auto rows = layout.rows(b, h);

  // stage q, k, v of this (window, head): 4 x 16-byte pieces per 32-wide row
  for (int i = threadIdx.x; i < Np * 4; i += kThreads) {
    const int r = i >> 2, part = (i & 3) * 8;
    uint4 qv = make_uint4(0, 0, 0, 0), kv = qv, vv = qv;
    if (r < N) {
      const long off = rows.in(r) + part;
      qv = *reinterpret_cast<const uint4*>(q + off);
      kv = *reinterpret_cast<const uint4*>(k + off);
      vv = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(qs + r * kLd + part) = qv;
    *reinterpret_cast<uint4*>(ks + r * kLd + part) = kv;
    *reinterpret_cast<uint4*>(vs + r * kLd + part) = vv;
  }
  __syncthreads();

  const float* bias_h = bias + long(h) * N * N;
  const float* mask_w = mask != nullptr ? mask + long(layout.mask_row(b)) * N * N : nullptr;
  const wa::OutRows<decltype(rows)> dst{out, rows};
  const int strips = (N + 15) / 16;
  for (int s = warp; s < strips; s += kWarps) {
    const long r0 = min(s * 16 + (lane >> 2), N - 1), r1 = min(s * 16 + (lane >> 2) + 8, N - 1);
    const wa::DenseTerms terms{bias_h + r0 * N, bias_h + r1 * N,
                               mask_w != nullptr ? mask_w + r0 * N : nullptr,
                               mask_w != nullptr ? mask_w + r1 * N : nullptr, N, lane & 3};
    wa::attend_strip_with<KT>(qs, ks, vs, terms, s, lane, N, scale, dst);
  }
}

template <int KT, class Layout>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, int windows, int N, int nH, float scale, Layout layout,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<KT>();
  auto* kernel = window_attention_heads_kernel<KT, Layout>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(windows, nH), kThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float*)bias, (const float*)mask,
      (bf16*)out, N, scale, layout);
  return (int)cudaGetLastError();
}

template <class Layout>
int dispatch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
             void* out, int windows, int N, int nH, int key_tiles, float scale, Layout layout,
             cudaStream_t st) {
  if (windows <= 0 || N <= 0 || N > 16 * key_tiles || nH <= 0) return (int)cudaErrorInvalidValue;
  switch (key_tiles) {
    case 4: return launch<4>(q, k, v, bias, mask, out, windows, N, nH, scale, layout, st);
    case 7: return launch<7>(q, k, v, bias, mask, out, windows, N, nH, scale, layout, st);
    case 13: return launch<13>(q, k, v, bias, mask, out, windows, N, nH, scale, layout, st);
    case 16: return launch<16>(q, k, v, bias, mask, out, windows, N, nH, scale, layout, st);
    case 19: return launch<19>(q, k, v, bias, mask, out, windows, N, nH, scale, layout, st);
    case 25: return launch<25>(q, k, v, bias, mask, out, windows, N, nH, scale, layout, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace clover

// K9. key_tiles: 16-key tiles N is padded to (the instances of K1).
extern "C" int clover_window_attention_heads(const void* q, const void* k, const void* v,
                                             const void* bias, const void* mask, void* out,
                                             int Bn, int N, int nH, int nW, int key_tiles,
                                             float scale, void* stream) {
  using namespace clover;
  if (mask != nullptr && (nW <= 0 || Bn % nW)) return (int)cudaErrorInvalidValue;
  return dispatch(q, k, v, bias, mask, out, Bn, N, nH, key_tiles, scale,
                  HeadMajor{nH, N, mask != nullptr ? nW : 1}, (cudaStream_t)stream);
}

// K10: qkv (B, Dp, Hp, Wp, 3, nH, 32), out (B, Dp, Hp, Wp, nH, 32), the
// window (wd, wh, ww) dividing (Dp, Hp, Wp).
extern "C" int clover_window_attention_spatial(const void* qkv, const void* bias,
                                               const void* mask, void* out, int B, int Dp,
                                               int Hp, int Wp, int wd, int wh, int ww, int nH,
                                               int key_tiles, float scale, void* stream) {
  using namespace clover;
  if (B <= 0 || wd <= 0 || wh <= 0 || ww <= 0 || Dp % wd || Hp % wh || Wp % ww) {
    return (int)cudaErrorInvalidValue;
  }
  const int C = nH * kHd;
  const bf16* q = static_cast<const bf16*>(qkv);
  const int windows = B * (Dp / wd) * (Hp / wh) * (Wp / ww);
  return dispatch(q, q + C, q + 2 * C, bias, mask, out, windows, wd * wh * ww, nH, key_tiles,
                  scale, SpatialGrid{Dp, Hp, Wp, wd, wh, ww, C}, (cudaStream_t)stream);
}
