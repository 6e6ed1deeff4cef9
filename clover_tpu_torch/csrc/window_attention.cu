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
// Also replaces ::_forward_flat_grouped, the head-group form the TPU takes
// at N=392 (the 32-frame 8x7x7 window), where all heads' bias does not fit
// its VMEM: a block per head never needs head groups.
//
// Bound on the H100: 4*N*N*hd flops per (window, head) against ~8*N*hd
// bytes of q/k/v/out plus the L2-resident bias, i.e. ~N/2 flop per byte:
// at N=196 the kernel sits below the ridge, so the (N, N) logits must never
// reach device memory and the softmax must not serialise the warps.
//
// The strip (window_attention.cuh): a warp keeps a 16-row query strip's
// whole 16 x Np logits in mma.sync (m16n8k16, bf16 in, fp32 accumulate)
// accumulators, the bias comes in that accumulator order as bf16 (the
// caller's terms: ops/window_attention.py::fragment_bias, the model's
// cached or table-gathered form), padded query rows are never stored; past
// 16 key tiles (N=294, N=392) the strip is walked in key parts of at most
// 10 steps with an online max / sum rescale. What holds it back on this
// card is latency (a strip's products, exponentials and bias loads chain)
// with few warps an SM (a strip's logits take ~100 registers a thread), so
// the launch is shaped to the call (ops/window_attention.py::k1_grid, which
// this entry point checks). A block of 4 warps takes one head and `per`
// clips of one mask row (a walk, as K9 / K10's in window_attention_heads.cu),
// so the row's region ids are staged once; a window's k, v (and q, up to 19
// key tiles) are staged by cp.async (16 bytes a thread, zero fill past N),
// into one of two buffers while the strips of the window before run where
// two fit; without q staged each warp loads its strip's q as mma operands
// from device memory. A large call takes one window a block with the
// registers capped for three blocks an SM (12 warps instead of 8); a small
// one, a wave of blocks each walking a few windows on two buffers. A block
// per strip group (a warp a strip, q per warp) lost to both at every call
// shape (PERF.md, section 6).
// The TPU kernel's static softmax shift and region-lanes mask are TPU
// devices and are not carried over.

#include "window_attention.cuh"

namespace clover {
namespace {

using wa::kHd;
using wa::kLd;
constexpr int kWalkWarps = 4;
constexpr size_t kStageLimit = 116224;  // two staging buffers stay under half an SM's memory
constexpr size_t kSmemSM = 233472;      // shared memory of an SM

// shared memory: `stages` buffers of `tiles` staged (Np, kLd) bf16 tiles,
// then the region ids (ops/window_attention.py::_k1_smem)
__host__ __device__ constexpr size_t buf_bytes(int kt, int tiles, int stages) {
  return align128(size_t(stages) * tiles * kt * 16 * kLd * sizeof(bf16));
}
__host__ __device__ constexpr size_t smem_bytes(int kt, int tiles, int stages) {
  return buf_bytes(kt, tiles, stages) + kt * 16 * sizeof(int);
}
// q is staged with k, v where three blocks' single buffers fit an SM (up
// to 19 key tiles); else each warp reads its q strip
__host__ __device__ constexpr bool stage_q(int kt) {
  return 3 * smem_bytes(kt, 3, 1) <= kSmemSM;
}
__host__ __device__ constexpr int tiles_of(int kt) { return stage_q(kt) ? 3 : 2; }
// the next window is staged into a second buffer where a block walks more
// than one clip and two buffers fit (up to 13 key tiles)
__host__ __device__ constexpr int stages_of(int kt, int per) {
  return per > 1 && 2 * smem_bytes(kt, tiles_of(kt), 1) <= kStageLimit ? 2 : 1;
}

// MINB: blocks an SM the registers are capped for. Block x takes head
// x % nH and clips [c0, c1) of mask row w (window b = c * nW + w),
// e = x / nH = w * chunks + c0 / per.
template <int KT, int MINB>
__global__ void __launch_bounds__(kWalkWarps * 32, MINB)
k1_walk_kernel(const bf16* __restrict__ qkv, const uint2* __restrict__ bias,
               const int* __restrict__ ids, bf16* __restrict__ out, int N, int nH, int nW,
               int clips, int per, int stages, float scale) {
  constexpr bool KQ = stage_q(KT);
  constexpr int Np = KT * 16, NT = 2 * KT, kTiles = tiles_of(KT);
  constexpr int kStage = kTiles * Np * kLd;  // bf16 elements of one buffer
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);  // [stage][(q) | k | v][Np][kLd]
  int* id_s = reinterpret_cast<int*>(smem + buf_bytes(KT, kTiles, stages));
  const int C = nH * kHd;
  const int h = blockIdx.x % nH, e = blockIdx.x / nH, chunks = (clips + per - 1) / per;
  const int w = e / chunks, c0 = (e % chunks) * per, c1 = min(c0 + per, clips);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool masked = ids != nullptr;

  // (q,) k, v of clip c into buffer st: 4 x 16-byte pieces per 32-wide row
  auto stage = [&](int c, int st) {
    const bf16* base = qkv + (long(c) * nW + w) * N * 3 * C + h * kHd;
    bf16* dst0 = buf + st * kStage;
    for (int i = threadIdx.x; i < Np * 4; i += kWalkWarps * 32) {
      const int r = i >> 2, part = (i & 3) * 8;
      const bool valid = r < N;
      const bf16* src = base + (valid ? long(r) * 3 * C : 0) + part;
      bf16* dst = dst0 + r * kLd + part;
      if constexpr (KQ) {
        cp_async16_zfill(dst, src, valid);
        dst += Np * kLd;
      }
      cp_async16_zfill(dst, src + C, valid);
      cp_async16_zfill(dst + Np * kLd, src + 2 * C, valid);
    }
  };
  for (int st = 0; st < stages; ++st) {
    if (c0 + st < c1) stage(c0 + st, st);
    cp_async_commit();
  }
  if (masked) {  // the mask row's region ids, -1 past N
    for (int r = threadIdx.x; r < Np; r += kWalkWarps * 32) {
      id_s[r] = r < N ? ids[long(w) * N + r] : -1;
    }
  }

  const uint2* bias_h = bias + long(h) * KT * NT * 32;
  const int strips = (N + 15) / 16;
  for (int c = c0; c < c1; ++c) {
    if (stages == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = (c - c0) % stages;
    const bf16* qs = buf + st * kStage;
    const bf16* ks = qs + (KQ ? Np * kLd : 0);
    const bf16* vs = ks + Np * kLd;
    const long row0 = (long(c) * nW + w) * N;
    bf16* out_b = out + row0 * C + h * kHd;
    for (int s = warp; s < strips; s += kWalkWarps) {
      if constexpr (KQ) {
        wa::attend_strip<KT>(qs, ks, vs, bias_h, id_s, masked, s, lane, N, scale, out_b, C);
      } else {
        unsigned qa[2][4];
        wa::load_q_strip(qa, qkv + row0 * 3 * C + h * kHd, 3 * C, s * 16, N, lane);
        wa::attend_strip<KT>(qa, ks, vs, bias_h, id_s, masked, s, lane, N, scale, out_b, C);
      }
    }
    if (c + stages < c1) {
      __syncthreads();  // every warp is done with buffer st
      stage(c + stages, st);
    }
    cp_async_commit();
  }
}

template <int KT, int MINB>
int walk(const bf16* q, const uint2* bt, const int* id, bf16* o, int N, int nH, int nW,
         int clips, int per, int stages, size_t smem, float scale, cudaStream_t stream) {
  auto* kernel = k1_walk_kernel<KT, MINB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (long)nH * nW * ((clips + per - 1) / per);
  kernel<<<unsigned(blocks), kWalkWarps * 32, smem, stream>>>(q, bt, id, o, N, nH, nW, clips, per,
                                                               stages, scale);
  return (int)cudaGetLastError();
}

template <int KT>
int launch(const void* qkv, const void* bias, const void* ids, void* out, int Bn, int N, int nH,
           int nW, int per, int min_blocks, float scale, cudaStream_t stream) {
  const int clips = Bn / nW;
  if (per < 1 || per > clips || (min_blocks != 1 && min_blocks != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const int stages = stages_of(KT, per);
  const size_t smem = smem_bytes(KT, tiles_of(KT), stages);
  auto run = min_blocks == 3 ? walk<KT, 3> : walk<KT, 1>;
  return run((const bf16*)qkv, (const uint2*)bias, (const int*)ids, (bf16*)out, N, nH, nW, clips,
             per, stages, smem, scale, stream);
}

}  // namespace
}  // namespace clover

// key_tiles: 16-key tiles the caller padded N (and laid out the bias) to.
// The logits strip lives in registers, so it is a template argument with
// these instances: Swin's windows 8x7x7 (N=392, 32 frames), 6x7x7 (N=294,
// 12 frames), 4x7x7 (N=196), 2x7x7 (N=98), smaller. The plan
// (ops/window_attention.py::k1_grid): a walk of `per` clips a block, the
// registers capped for `min_blocks` blocks an SM (1: no cap, or 3); the
// staging buffers and whether q is staged follow from `per` and KT.
extern "C" int clover_window_attention(const void* qkv, const void* bias, const void* ids,
                                       void* out, int Bn, int N, int nH, int nW, int key_tiles,
                                       int per, int min_blocks, float scale, void* stream) {
  using namespace clover;
  if (Bn <= 0 || N <= 0 || N > 16 * key_tiles || nH <= 0 ||
      (ids != nullptr && (nW <= 0 || Bn % nW))) {
    return (int)cudaErrorInvalidValue;
  }
  nW = ids != nullptr ? nW : 1;
  cudaStream_t st = (cudaStream_t)stream;
#define CLOVER_K1(KT) \
  case KT:           \
    return launch<KT>(qkv, bias, ids, out, Bn, N, nH, nW, per, min_blocks, scale, st);
  switch (key_tiles) {
    CLOVER_K1(4)
    CLOVER_K1(7)
    CLOVER_K1(13)
    CLOVER_K1(16)
    CLOVER_K1(19)
    CLOVER_K1(25)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CLOVER_K1
}
