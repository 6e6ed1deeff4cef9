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
// Also replaces ::_forward_flat_grouped, the head-group form the TPU takes
// at N=392 (the 32-frame 8x7x7 window), where all heads' bias does not fit
// its VMEM: a block per (window, head) never needs head groups.
// Design: one block per (window, head), 4 warps. The block stages the
// head's q, k, v (N padded to a multiple of 16 with zero rows) in shared
// memory. Each warp takes 16-row query strips and keeps the strip's whole
// 16 x Np logits in registers as mma.sync (m16n8k16, bf16 in, fp32
// accumulate) accumulators (window_attention.cuh). The
// bias comes in that accumulator order (the wrapper lays it out once per
// call, -inf in the padded keys), so a lane reads its strip's bias as NT
// coalesced 8-byte loads. Padded query rows are never stored. Past 16 key
// tiles (N > 256: the 12-frame window 6x7x7, N=294; the 32-frame 8x7x7,
// N=392) the strip is walked in key parts of at most 10 steps with an
// online max / sum rescale (19 tiles: 10 + 9, 25: 9 + 8 + 8); up to 16
// tiles it stays one pass. Shared memory at 25 tiles: q, k, v at 400
// padded rows, 96 KB. The TPU kernel's static softmax shift and region-lanes
// mask are TPU devices and are not carried over.

#include "window_attention.cuh"

namespace clover {
namespace {

using wa::kHd;
using wa::kLd;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

template <int KT>
constexpr size_t smem_bytes() {
  return align128(size_t(3) * KT * 16 * kLd * sizeof(bf16)) + KT * 16 * sizeof(int);
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
  const int strips = (N + 15) / 16;
  for (int s = warp; s < strips; s += kWarps) {
    wa::attend_strip<KT>(qs, ks, vs, bias_h, id_s, masked, s, lane, N, scale, out_b, C);
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
// these instances: Swin's windows 8x7x7 (N=392, 32 frames), 6x7x7 (N=294,
// 12 frames), 4x7x7 (N=196), 2x7x7 (N=98), smaller.
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
    case 25: return launch<25>(qkv, bias, ids, out, Bn, N, nH, nW, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
