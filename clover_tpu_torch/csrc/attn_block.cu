// K6: the fused window-attention half-block, head dim 32.
//
//   out = x + s * (proj(window_attention(LN1(x) Wqkv^T + b_qkv)) + b_proj)
//
// over windows of N tokens, x (Bn*N, C) bf16 row-major; Wqkv (3C, C) and
// Wproj (C, C) bf16 in torch Linear layout; LN affine and biases fp32; s the
// optional per-window fp32 row scale.
//
// Replaces clover_tpu/ops/attn_block.py::_forward (the Pallas kernel behind
// fused_window_attn_block) and ::_forward_grouped, the same function with
// the heads split into groups because the TPU's VMEM cannot hold all
// heads' bias at N=392.
//
// Bound on the H100: 2*N*(4C^2 + 2NC) flops per window against ~4*N*C
// bytes of activations: compute-bound on the tensor cores at every Swin-B
// stage (32-frame eval: 533 GFLOP at stage 0, 0.54 ms at 989 TFLOP/s). The
// TPU kernel keeps a whole window's x, qkv and fp32 proj accumulator in
// VMEM; on the H100 that fusion costs more than it saves (a block per
// (window, head) recomputed the window's LN and re-read its x per head, ran
// a 400 x 96 x C product that started over per head, and its phases in
// series on 8 warps). Writing qkv out is cheap beside it: 2 x 6C bytes a
// row against 8C^2 + 4NC flops. So K6 runs as passes over chunks of whole
// windows (ops/attn_block.py::k6_plan: the chunk's LN1 output, qkv and
// attention output under a fixed number of bytes), each a wide product:
//   1. k6_ln_rows: xn = bf16(LN1(x)), one warp a row;
//      k6_qkv_pass: qkv = bf16(xn Wqkv^T + b_qkv) (rows, 3C), the GEMM core
//      of csrc/gemm.cuh (shared with K7), 128 x 128 tiles, 64 deep (both
//      operands k-contiguous), b_qkv added to the fp32 accumulator;
//   2. the attention: K11's kernel on the flat qkv
//      (window_attention_flash.cu, clover_attn_block_attention);
//   3. k6_proj_pass: out = bf16(x + s * (attn Wproj^T + b_proj)), the same
//      core, b_proj, the row scale (row / N) and the residual added in fp32
//      in the epilogue, rounded once.
// A row's arithmetic does not depend on where its chunk starts, so any
// plan gives the same bits. PERF.md has the variants measured against this
// design on the H100 (LN1 folded into the qkv pass at C <= 256, a 32-deep
// proj pass, 32-48 MB chunks). Not yet: wgmma, TMA.

#include "gemm.cuh"

namespace clover {
namespace {

using gemm::Gemm;
using gemm::kBM;
using gemm::kBN;
using gemm::kThreads;

__global__ void __launch_bounds__(kThreads) k6_ln_rows(const bf16* __restrict__ x,
                                                       const float* __restrict__ ln_w,
                                                       const float* __restrict__ ln_b,
                                                       bf16* __restrict__ y, int rows, int C,
                                                       float eps) {
  gemm::ln_rows(x, ln_w, ln_b, y, rows, C, eps);
}

// qkv (rows, 3C) = bf16(xn Wqkv^T + b_qkv): tile (column tile blockIdx.x,
// row tile blockIdx.y); rows past `rows` are not stored
using GemmQkv = Gemm<false, false, 1, 64>;

__global__ void __launch_bounds__(kThreads, 2)
k6_qkv_pass(const bf16* __restrict__ xn, const bf16* __restrict__ wqkv,
            const float* __restrict__ bqkv, bf16* __restrict__ qkv, int rows, int C) {
  using G = GemmQkv;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const long row0 = (long)blockIdx.y * kBM;
  const int a_lim = min(kBM, rows - (int)row0);
  float acc[4][G::NT][4];
  const bf16* const ga[1] = {xn + row0 * C};
  const bf16* const gb[1] = {wqkv + (long)n0 * C};
  G::run(ga, gb, C, C, a_lim, C, reinterpret_cast<bf16*>(smem), acc);
  float2 bias[G::NT];
#pragma unroll
  for (int n = 0; n < G::NT; ++n)
    bias[n] = *reinterpret_cast<const float2*>(bqkv + n0 + wn * 32 + n * 8 + 2 * tq);
  const long ld = 3L * C;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 64 + m * 16 + gq + hh * 8;
      if (r >= a_lim) continue;
#pragma unroll
      for (int n = 0; n < G::NT; ++n)
        *reinterpret_cast<unsigned*>(qkv + (row0 + r) * ld + n0 + wn * 32 + n * 8 + 2 * tq) =
            pack_bf16(acc[m][n][2 * hh] + bias[n].x, acc[m][n][2 * hh + 1] + bias[n].y);
    }
}

// out (rows, C) = bf16(x + s * (attn Wproj^T + b_proj)), s = row_scale[row /
// N] (1 without): tile (column tile blockIdx.x, row tile blockIdx.y)
using GemmProj = Gemm<false, false, 1, 64>;

__global__ void __launch_bounds__(kThreads, 2)
k6_proj_pass(const bf16* __restrict__ attn, const bf16* __restrict__ wproj,
             const float* __restrict__ bproj, const float* __restrict__ row_scale,
             const bf16* __restrict__ x, bf16* __restrict__ out, int rows, int C, int N) {
  using G = GemmProj;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = blockIdx.x * kBN;
  const long row0 = (long)blockIdx.y * kBM;
  const int a_lim = min(kBM, rows - (int)row0);
  float acc[4][G::NT][4];
  const bf16* const ga[1] = {attn + row0 * C};
  const bf16* const gb[1] = {wproj + (long)c0 * C};
  G::run(ga, gb, C, C, a_lim, C, reinterpret_cast<bf16*>(smem), acc);
  float2 bias[G::NT];
#pragma unroll
  for (int n = 0; n < G::NT; ++n)
    bias[n] = *reinterpret_cast<const float2*>(bproj + c0 + wn * 32 + n * 8 + 2 * tq);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 64 + m * 16 + gq + hh * 8;
      if (r >= a_lim) continue;
      const long gr = row0 + r;
      const float rs = row_scale != nullptr ? row_scale[gr / N] : 1.f;
#pragma unroll
      for (int n = 0; n < G::NT; ++n) {
        const long at = gr * C + c0 + wn * 32 + n * 8 + 2 * tq;
        const float2 xv = bf16x2_to_float2(*reinterpret_cast<const unsigned*>(x + at));
        *reinterpret_cast<unsigned*>(out + at) =
            pack_bf16(xv.x + (acc[m][n][2 * hh] + bias[n].x) * rs,
                      xv.y + (acc[m][n][2 * hh + 1] + bias[n].y) * rs);
      }
    }
}

}  // namespace
}  // namespace clover

// Pass 1 on rows of a chunk: x (rows, C) bf16, ln_w / ln_b (C) and bqkv (3C)
// fp32, wqkv (3C, C) bf16; xn (rows, C) bf16 the caller's workspace; qkv
// (rows, 3C) bf16 out. C a multiple of 128.
extern "C" int clover_attn_block_qkv(const void* x, const void* ln_w, const void* ln_b,
                                     const void* wqkv, const void* bqkv, void* xn, void* qkv,
                                     int rows, int C, float eps, void* stream) {
  using namespace clover;
  dim3 grid;
  if (C <= 0 || C % kBN || !gemm::grid(rows, 3 * C, grid)) return (int)cudaErrorInvalidValue;
  const int rc = gemm::allow_smem(k6_qkv_pass, GemmQkv::pipe_bytes);
  if (rc) return rc;
  const cudaStream_t st = (cudaStream_t)stream;
  k6_ln_rows<<<(rows + 7) / 8, kThreads, 0, st>>>((const bf16*)x, (const float*)ln_w,
                                                  (const float*)ln_b, (bf16*)xn, rows, C, eps);
  k6_qkv_pass<<<grid, kThreads, GemmQkv::pipe_bytes, st>>>(
      (const bf16*)xn, (const bf16*)wqkv, (const float*)bqkv, (bf16*)qkv, rows, C);
  return (int)cudaGetLastError();
}

// Pass 3 on rows of a chunk of whole windows of N tokens: attn and x (rows,
// C) bf16, wproj (C, C) bf16, bproj (C) fp32, row_scale (rows / N) fp32 or
// nullptr; out (rows, C) bf16. C a multiple of 128.
extern "C" int clover_attn_block_proj(const void* attn, const void* wproj, const void* bproj,
                                      const void* row_scale, const void* x, void* out, int rows,
                                      int C, int N, void* stream) {
  using namespace clover;
  dim3 grid;
  if (C <= 0 || C % kBN || N <= 0 || rows % N || !gemm::grid(rows, C, grid)) {
    return (int)cudaErrorInvalidValue;
  }
  const int rc = gemm::allow_smem(k6_proj_pass, GemmProj::pipe_bytes);
  if (rc) return rc;
  k6_proj_pass<<<grid, kThreads, GemmProj::pipe_bytes, (cudaStream_t)stream>>>(
      (const bf16*)attn, (const bf16*)wproj, (const float*)bproj, (const float*)row_scale,
      (const bf16*)x, (bf16*)out, rows, C, N);
  return (int)cudaGetLastError();
}
