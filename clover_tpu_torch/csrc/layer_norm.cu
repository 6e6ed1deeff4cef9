// K4: row LayerNorm, (rows, C) bf16 -> bf16, fp32 statistics.
//
// Replaces clover_tpu/ops/layer_norm.py::_forward (_ln_kernel, the Pallas
// kernel behind fused_layer_norm). Bound on the H100 by device-memory
// bytes: ~10 flops per 4 bytes moved, far under the card's ~295 flop/byte
// ridge. Design: one warp per row, so a row's reduction never leaves the
// warp (shuffles only, no shared memory, no block barrier); the row is read
// once from device memory and the two later passes hit L1. Statistics are
// two-pass (mean, then centered variance) like the reference.

#include "common.cuh"

namespace clover {
namespace {

constexpr int kRowsPerBlock = 8;  // one warp per row

__global__ void __launch_bounds__(kRowsPerBlock * 32)
layer_norm_kernel(const bf16* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, bf16* __restrict__ out,
                  int rows, int C, float eps) {
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
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

}  // namespace
}  // namespace clover

extern "C" int clover_layer_norm(const void* x, const void* w, const void* b, void* out,
                                 int rows, int C, float eps, void* stream) {
  if (rows <= 0 || C <= 0 || (C & 1)) return (int)cudaErrorInvalidValue;
  const int grid = (rows + clover::kRowsPerBlock - 1) / clover::kRowsPerBlock;
  clover::layer_norm_kernel<<<grid, clover::kRowsPerBlock * 32, 0, (cudaStream_t)stream>>>(
      (const clover::bf16*)x, (const float*)w, (const float*)b, (clover::bf16*)out, rows, C,
      eps);
  return (int)cudaGetLastError();
}

extern "C" const char* clover_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
