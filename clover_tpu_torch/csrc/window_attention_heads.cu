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
// bytes of q, k, v and out, plus the fp32 bias (nH*N*N) and the nW mask
// tiles read from device memory once: bytes, ~0.12 ms against 0.04 of
// products per 8-frame stage-0 call. What the card moves is more: each
// (window, head) reads the head's bias tile and the window's mask tile
// (Np*Np fp32 each, 173 KB at N=196) from L2, ~9x its q, k, v, so the
// kernel is held by how fast its terms come from L2.
// Design:
// - The terms come in accumulator order (ops/window_attention.py::
//   fragment_terms, laid out by the wrapper: -inf in the bias's padded
//   keys, 0 in the rest of the padding): a lane adds its two rows x two keys
//   of an 8-key tile with one 16-byte load of bias and one of mask, a warp's
//   load is one contiguous 512-byte line, and there is no per-key branch or
//   row clamp (wa::FragTerms). The values stay fp32.
// - A block of 4 warps takes one head and `per` windows that share a mask
//   row (window b = bb * nW + w for consecutive clips bb) and walks them:
//   q, k, v of a window are staged by cp.async (16 bytes a thread, zero fill
//   past N) into one of two buffers while the strips of the window before
//   run (two buffers up to 13 key tiles, 100 KB, two blocks an SM; one past
//   that or when the block has one window). Each warp then runs K1's strip
//   code (window_attention.cuh: a 16 x Np logit strip in mma.sync
//   accumulators, an online rescale past 16 key tiles). The wrapper picks
//   `per` (ops/window_attention.py::windows_per_block) so the grid keeps
//   four blocks for each block slot of the card; neighbouring blocks take
//   the heads of the same windows, so K10's blocks read the pieces of one
//   qkv row close together in time.
// - K10's index map: token r of every window sits at rel[r] from the
//   window's corner; the block writes rel once to shared memory, and a
//   window's corner costs three divisions, so the copy loop has none.

#include "window_attention.cuh"

namespace clover {
namespace {

using wa::kHd;
using wa::kLd;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTwoStageTiles = 13;  // two staging buffers up to this many key tiles

// one staging buffer: q, k, v of a window at Np = 16 * KT rows
template <int KT>
__host__ __device__ constexpr size_t stage_bytes() {
  return size_t(3) * KT * 16 * kLd * sizeof(bf16);
}

template <int KT>
constexpr size_t smem_bytes(int stages) {
  return stages * stage_bytes<KT>() + KT * 16 * sizeof(int);
}

// K9: head-major q, k, v and out (Bn, nH, N, 32)
struct HeadMajor {
  int nH, N;
  __device__ void prepare(int*) const {}
  __device__ wa::HeadRows rows(int b, int h, const int*) const {
    return {(long(b) * nH + h) * N * kHd};
  }
};

// K10: window b = ((bb * gd + i) * gh + j) * gw + k of a (B, Dp, Hp, Wp) grid
struct SpatialGrid {
  int Dp, Hp, Wp, wd, wh, ww, C;
  // rel[r]: token r = (td, th, tw) of a window as a token offset from its corner
  __device__ void prepare(int* rel) const {
    for (int r = threadIdx.x; r < wd * wh * ww; r += kThreads) {
      const int td = r / (wh * ww), rem = r - td * (wh * ww), th = rem / ww;
      rel[r] = (td * Hp + th) * Wp + (rem - th * ww);
    }
  }
  __device__ wa::GridRows rows(int b, int h, const int* rel) const {
    const int gd = Dp / wd, gh = Hp / wh, gw = Wp / ww;
    const int k = b % gw, j = (b / gw) % gh, i = (b / (gw * gh)) % gd, bb = b / (gw * gh * gd);
    return {((long(bb) * Dp + i * wd) * Hp + j * wh) * Wp + k * ww, rel, C, h};
  }
};

// q, k, v: base pointers whose element offset rows.in(r) is row r of the
// head (K10: the same qkv shifted by 0, C, 2C); bias (nH tiles) and mask (nW
// tiles, or nullptr) in accumulator order. Block x takes head x % nH and
// entries [e * per, e * per + per), e = x / nH, of the windows in (mask
// row, clip) order.
template <int KT, class Layout>
__global__ void __launch_bounds__(kThreads)
window_attention_heads_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, const float4* __restrict__ bias,
                              const float4* __restrict__ mask, bf16* __restrict__ out, int N,
                              int windows, int nH, int nW, int per, int stages, float scale,
                              Layout layout) {
  constexpr int Np = KT * 16, NT = 2 * KT;
  constexpr long kTile = long(KT) * NT * 32;  // float4s of one term tile
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);  // [stage][q | k | v][Np][kLd]
  int* rel = reinterpret_cast<int*>(smem + stages * stage_bytes<KT>());
  const int h = blockIdx.x % nH, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x / nH * per, j1 = min(j0 + per, windows), clips = windows / nW;
  // entry j: clip j % clips at mask row j / clips
  auto window = [&](int j) { return (j % clips) * nW + j / clips; };
  layout.prepare(rel);
  __syncthreads();

  // q, k, v of entry j into buffer st: 4 x 16-byte pieces per 32-wide row
  auto stage = [&](int j, int st) {
    const auto rows = layout.rows(window(j), h, rel);
    bf16* qs = buf + st * 3 * Np * kLd;
    for (int i = threadIdx.x; i < Np * 4; i += kThreads) {
      const int r = i >> 2, part = (i & 3) * 8;
      const bool valid = r < N;
      const long off = valid ? rows.in(r) + part : 0;
      bf16* dst = qs + r * kLd + part;
      cp_async16_zfill(dst, q + off, valid);
      cp_async16_zfill(dst + Np * kLd, k + off, valid);
      cp_async16_zfill(dst + 2 * Np * kLd, v + off, valid);
    }
  };
  for (int st = 0; st < stages; ++st) {
    if (j0 + st < j1) stage(j0 + st, st);
    cp_async_commit();
  }

  const float4* bias_h = bias + h * kTile + lane;
  const int strips = (N + 15) / 16;
  for (int j = j0; j < j1; ++j) {
    if (stages == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = (j - j0) % stages;
    const bf16* qs = buf + st * 3 * Np * kLd;
    const auto rows = layout.rows(window(j), h, rel);
    const float4* mask_w = mask != nullptr ? mask + (j / clips) * kTile + lane : nullptr;
    const wa::OutRows<decltype(rows)> dst{out, rows};
    for (int s = warp; s < strips; s += kWarps) {
      const wa::FragTerms terms{bias_h + s * NT * 32,
                                mask_w != nullptr ? mask_w + s * NT * 32 : nullptr};
      wa::attend_strip_with<KT>(qs, qs + Np * kLd, qs + 2 * Np * kLd, terms, s, lane, N, scale,
                                dst);
    }
    if (j + stages < j1) {
      __syncthreads();  // every warp is done with buffer st
      stage(j + stages, st);
    }
    cp_async_commit();
  }
}

template <int KT, class Layout>
int launch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
           void* out, int windows, int N, int nH, int nW, int per, float scale, Layout layout,
           cudaStream_t stream) {
  const int stages = per > 1 && KT <= kTwoStageTiles ? 2 : 1;
  auto* kernel = window_attention_heads_kernel<KT, Layout>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes<KT>(KT <= kTwoStageTiles ? 2 : 1));
  if (err != cudaSuccess) return (int)err;
  const int blocks = (windows + per - 1) / per * nH;
  kernel<<<blocks, kThreads, smem_bytes<KT>(stages), stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const float4*)bias, (const float4*)mask,
      (bf16*)out, N, windows, nH, nW, per, stages, scale, layout);
  return (int)cudaGetLastError();
}

template <class Layout>
int dispatch(const void* q, const void* k, const void* v, const void* bias, const void* mask,
             void* out, int windows, int N, int nH, int nW, int key_tiles, int per, float scale,
             Layout layout, cudaStream_t st) {
  if (windows <= 0 || N <= 0 || N > 16 * key_tiles || nH <= 0 || per <= 0 || nW <= 0 ||
      windows % nW) {
    return (int)cudaErrorInvalidValue;
  }
  switch (key_tiles) {
    case 4: return launch<4>(q, k, v, bias, mask, out, windows, N, nH, nW, per, scale, layout, st);
    case 7: return launch<7>(q, k, v, bias, mask, out, windows, N, nH, nW, per, scale, layout, st);
    case 13:
      return launch<13>(q, k, v, bias, mask, out, windows, N, nH, nW, per, scale, layout, st);
    case 16:
      return launch<16>(q, k, v, bias, mask, out, windows, N, nH, nW, per, scale, layout, st);
    case 19:
      return launch<19>(q, k, v, bias, mask, out, windows, N, nH, nW, per, scale, layout, st);
    case 25:
      return launch<25>(q, k, v, bias, mask, out, windows, N, nH, nW, per, scale, layout, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace clover

// K9. bias (nH tiles) and mask (nW tiles, or null) in accumulator order at
// key_tiles 16-key tiles (the instances of K1); per: windows a block walks.
extern "C" int clover_window_attention_heads(const void* q, const void* k, const void* v,
                                             const void* bias, const void* mask, void* out,
                                             int Bn, int N, int nH, int nW, int key_tiles,
                                             int per, float scale, void* stream) {
  using namespace clover;
  return dispatch(q, k, v, bias, mask, out, Bn, N, nH, mask != nullptr ? nW : 1, key_tiles, per,
                  scale, HeadMajor{nH, N}, (cudaStream_t)stream);
}

// K10: qkv (B, Dp, Hp, Wp, 3, nH, 32), out (B, Dp, Hp, Wp, nH, 32), the
// window (wd, wh, ww) dividing (Dp, Hp, Wp); the mask's tiles one per
// window of a clip's grid.
extern "C" int clover_window_attention_spatial(const void* qkv, const void* bias,
                                               const void* mask, void* out, int B, int Dp,
                                               int Hp, int Wp, int wd, int wh, int ww, int nH,
                                               int key_tiles, int per, float scale,
                                               void* stream) {
  using namespace clover;
  if (B <= 0 || wd <= 0 || wh <= 0 || ww <= 0 || Dp % wd || Hp % wh || Wp % ww) {
    return (int)cudaErrorInvalidValue;
  }
  const int C = nH * kHd, grid = (Dp / wd) * (Hp / wh) * (Wp / ww);
  const bf16* q = static_cast<const bf16*>(qkv);
  return dispatch(q, q + C, q + 2 * C, bias, mask, out, B * grid, wd * wh * ww, nH,
                  mask != nullptr ? grid : 1, key_tiles, per, scale,
                  SpatialGrid{Dp, Hp, Wp, wd, wh, ww, C}, (cudaStream_t)stream);
}
