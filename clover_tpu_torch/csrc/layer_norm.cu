// K4: row LayerNorm, (rows, C) bf16 -> bf16, fp32 weight / bias and statistics.
//
// Replaces clover_tpu/ops/layer_norm.py::_forward (_ln_kernel, the Pallas
// kernel behind fused_layer_norm). Bound on the H100 by device-memory bytes:
// a call moves 4 rows C + 8 C bytes and does ~10 fp32 operations per 4 of
// them, far under the card's ~295 operations a byte. So what counts is the
// bytes each SM keeps in flight (~25-32 KB: 3.35 TB/s times ~1 us of
// latency over 132 SMs) and that x is read from device memory once.
//
// Design: the width is a template parameter. T lanes take a row and each
// lane V 16-byte vectors (8 channels) of it, so one load or store
// instruction moves T x 16 contiguous bytes of each of a warp's 32 / T
// rows; a lane group takes RPT rows a step, so a warp has 512 V RPT bytes
// of x in flight a step (1-4 KB at the port's widths). A step's vectors are
// all loaded before any arithmetic and then stay in registers: the mean,
// the centred variance (two passes, as the reference) and the output come
// from them, and the sums reduce by shuffles inside the lane group. The
// blocks walk the steps with a stride, and each warp loads its next step
// into a second register buffer before it reduces the current one. weight
// and bias are loaded once as float4 and held in registers across the walk
// (reading them from L1 for each row measured no faster under the plan,
// PERF.md). The plan (ops/layer_norm.py::k4_plan) gives a warp about three
// steps: a longer walk measured slower on the largest calls, a one-step
// grid slower on the mid-sized ones. A width without an instance runs the
// generic path: a warp a row, three walks over its bf16 pairs.

#include "common.cuh"

namespace clover {
namespace {

constexpr int kWarps = 4;  // warps a block

// sum over the T lanes of a row's lane group (lanes T g .. T g + T - 1)
template <int T>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = T / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// channels 2k, 2k + 1 of a 16-byte vector of 8 bf16
__device__ __forceinline__ float2 pair(const uint4& v, int k) {
  return bf16x2_to_float2(k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w);
}

// two normalised channels, packed as bf16
__device__ __forceinline__ unsigned norm_pair(float2 f, float mean, float inv, float w0, float w1,
                                              float b0, float b1) {
  return pack_bf16((f.x - mean) * inv * w0 + b0, (f.y - mean) * inv * w1 + b1);
}

// Step s takes rows s R .. s R + R - 1 (R = RPT G, G = 32 / T lane groups a
// warp): lane group g takes rows s R + j G + g, j < RPT. Lane t of a group
// holds vectors t + T i (i < V) of each, channels 8 (t + T i) .. + 7. Warp
// w of the grid takes steps w, w + W, w + 2 W, ... (W warps in the grid).
template <int T, int V, int RPT>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, bf16* __restrict__ out, int rows, float eps) {
  constexpr int C = 8 * T * V, G = 32 / T, R = G * RPT;
  const int lane = threadIdx.x & 31, t = lane % T, g = lane / T;
  const long steps = ((long)rows + R - 1) / R;
  const long stride = (long)gridDim.x * kWarps;
  long s = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= steps) return;

  const float4* w4 = reinterpret_cast<const float4*>(w) + 2 * t;
  const float4* b4 = reinterpret_cast<const float4*>(b) + 2 * t;
  float4 wr[2 * V], br[2 * V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    wr[2 * i] = w4[2 * T * i], wr[2 * i + 1] = w4[2 * T * i + 1];
    br[2 * i] = b4[2 * T * i], br[2 * i + 1] = b4[2 * T * i + 1];
  }

  uint4 cur[RPT][V], nxt[RPT][V];
  auto load = [&](uint4 (&buf)[RPT][V], long step) {
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const long row = step * R + j * G + g;
      const uint4* src = reinterpret_cast<const uint4*>(x + row * C) + t;
#pragma unroll
      for (int i = 0; i < V; ++i) buf[j][i] = row < rows ? src[T * i] : make_uint4(0, 0, 0, 0);
    }
  };

  load(cur, s);
  for (;;) {
    const long next = s + stride;
    const bool more = next < steps;  // the same on every lane of the warp
    if (more) load(nxt, next);
    float mean[RPT], inv[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = pair(cur[j][i], k);
          sum += f.x + f.y;
        }
      }
      mean[j] = group_sum<T>(sum) / C;
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = pair(cur[j][i], k);
          const float a = f.x - mean[j], c = f.y - mean[j];
          sq += a * a + c * c;
        }
      }
      inv[j] = rsqrtf(group_sum<T>(sq) / C + eps);
    }
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const long row = s * R + j * G + g;
      if (row >= rows) continue;
      uint4* dst = reinterpret_cast<uint4*>(out + row * C) + t;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const uint4& v = cur[j][i];
        const float4 w0 = wr[2 * i], w1 = wr[2 * i + 1], b0 = br[2 * i], b1 = br[2 * i + 1];
        const float m = mean[j], r = inv[j];
        uint4 o;
        o.x = norm_pair(pair(v, 0), m, r, w0.x, w0.y, b0.x, b0.y);
        o.y = norm_pair(pair(v, 1), m, r, w0.z, w0.w, b0.z, b0.w);
        o.z = norm_pair(pair(v, 2), m, r, w1.x, w1.y, b1.x, b1.y);
        o.w = norm_pair(pair(v, 3), m, r, w1.z, w1.w, b1.z, b1.w);
        dst[T * i] = o;
      }
    }
    if (!more) break;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
#pragma unroll
      for (int i = 0; i < V; ++i) cur[j][i] = nxt[j][i];
    }
    s = next;
  }
}

// Any even C: a warp a row, three walks over the row's bf16 pairs (the
// first from device memory, the other two from L1).
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel_generic(const bf16* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, bf16* __restrict__ out, int rows, int C,
                          float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int C2 = C >> 1;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + row * C);
  const float2* w2 = reinterpret_cast<const float2*>(w);
  const float2* b2 = reinterpret_cast<const float2*>(b);
  __nv_bfloat162* yr = reinterpret_cast<__nv_bfloat162*>(out + row * C);

  float sum = 0.f;
  for (int i = lane; i < C2; i += 32) {
    const float2 v = __bfloat1622float2(xr[i]);
    sum += v.x + v.y;
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
  for (int i = lane; i < C2; i += 32) {
    const float2 v = __bfloat1622float2(xr[i]);
    const float a = v.x - mean, c = v.y - mean;
    sq += a * a + c * c;
  }
  const float inv = rsqrtf(warp_sum(sq) / C + eps);
  for (int i = lane; i < C2; i += 32) {
    const float2 v = __bfloat1622float2(xr[i]);
    const float2 ww = w2[i], bb = b2[i];
    yr[i] = __floats2bfloat162_rn((v.x - mean) * inv * ww.x + bb.x,
                                  (v.y - mean) * inv * ww.y + bb.y);
  }
}

template <int T, int V, int RPT>
int launch(const void* x, const void* w, const void* b, void* out, int rows, int blocks,
           float eps, cudaStream_t stream) {
  constexpr long block_rows = kWarps * (32 / T) * RPT;
  if (blocks < 1 || blocks > (rows + block_rows - 1) / block_rows) {
    return (int)cudaErrorInvalidValue;
  }
  layer_norm_kernel<T, V, RPT><<<blocks, kWarps * 32, 0, stream>>>(
      (const bf16*)x, (const float*)w, (const float*)b, (bf16*)out, rows, eps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// The plan (ops/layer_norm.py::k4_plan): the instance (threads: lanes a
// row; vectors: 16-byte vectors a lane holds of each row; rows_per_group:
// rows a lane group takes a step) and the blocks that walk the steps, at
// most one a step. vectors = 0 is the generic path (threads 32, one row a
// warp, a block per kWarps rows). A plan this file has no instance for is
// refused. The instances: C = 128 (Swin-B's stage 0), 256 (stage 1), 512
// (stage 2, merging 0), 768 (BERT-base), 1024 (stage 3, merging 1, the
// final norm), 2048 (merging 2).
extern "C" int clover_layer_norm(const void* x, const void* w, const void* b, void* out,
                                 int rows, int C, int threads, int vectors, int rows_per_group,
                                 int blocks, float eps, void* stream) {
  using namespace clover;
  cudaStream_t st = (cudaStream_t)stream;
  if (rows <= 0 || C <= 0 || (C & 1)) return (int)cudaErrorInvalidValue;
  if (vectors == 0) {
    if (threads != 32 || rows_per_group != 1 || blocks != (rows + kWarps - 1) / kWarps) {
      return (int)cudaErrorInvalidValue;
    }
    layer_norm_kernel_generic<<<blocks, kWarps * 32, 0, st>>>(
        (const bf16*)x, (const float*)w, (const float*)b, (bf16*)out, rows, C, eps);
    return (int)cudaGetLastError();
  }
#define CLOVER_K4(CC, T, V, RPT)                                          \
  if (C == CC && threads == T && vectors == V && rows_per_group == RPT) { \
    static_assert(CC == 8 * T * V, "an instance covers its width");      \
    return launch<T, V, RPT>(x, w, b, out, rows, blocks, eps, st);       \
  }
  CLOVER_K4(128, 16, 1, 2)
  CLOVER_K4(256, 32, 1, 2)
  CLOVER_K4(512, 32, 2, 2)
  CLOVER_K4(768, 32, 3, 1)
  CLOVER_K4(1024, 32, 4, 2)
  CLOVER_K4(2048, 32, 8, 1)
#undef CLOVER_K4
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* clover_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
