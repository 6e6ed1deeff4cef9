// K2 and K3: the transformer MLP half-block as passes of tiled GEMMs.
//
//   K2 (pre-LN, Swin):  out = x + s * (gelu(LN(x) W1^T + b1) W2^T + b2)
//   K3 (post-LN, BERT): out = LN(x + gelu(x W1^T + b1) W2^T + b2)
//   K3M (K3 training):  out = LN(x + m * (gelu(x W1^T + b1) W2^T + b2))
//
// x (rows, C) bf16 row-major; W1 (H, C) and W2 (C, H) bf16 in torch Linear
// layout; biases and LN affine fp32; s the optional per-row fp32 scale
// (DropPath's keep / keep_prob; 1 when absent), m the fp32 (rows, C)
// {0, 1/keep} hidden-dropout mask.
//
// K2 replaces clover_tpu/ops/mlp_block.py::_forward (_kernel, and its
// training forms _kernel_scaled / _kernel_stash / _kernel_stash_scaled:
// the stash is z = LN(x) W1^T + b1 as bf16 (rows, H), written from the fp32
// accumulator before GELU, and the LN mean and rstd as fp32 (rows,)); K3
// replaces ::_forward_postln (_kernel_postln), K3M ::_forward_postln_mask
// (_kernel_postln_mask).
//
// Bound on the H100: the two products are 4 rows C H flops against ~4 rows
// C bytes of x and out, so the function is compute-bound on the tensor
// cores (Swin-B's 8-frame eval: 105 GFLOP a call, 0.11 ms at 989 TFLOP/s).
// The TPU kernels keep the (rows, H) hidden in VMEM and walk it in chunks
// against an fp32 (rows, C) accumulator. On the H100 that fusion cost more
// than it saved: the accumulator in registers capped a block at 32-128 rows
// (one m16 tile a warp at C = 1024), every block streamed all of W1 and W2
// from L2 for those rows, and each hidden chunk put a GELU epilogue and two
// barriers between the products (112 TFLOP/s). Writing the hidden out and
// reading it back costs 2 x 2H bytes a row against 4 C H flops, so K2 and K3
// run as passes over chunks of rows (ops/mlp_block.py::k2_plan: a chunk's y
// and h under a fixed number of bytes, K2's h under twice the call's x),
// each a wide product on the GEMM core of csrc/gemm.cuh (shared with K6 and K7:
// 128 x 128 tiles, 8 warps, a 3-stage cp.async ring 64 deep, both operands
// k-contiguous, mma.sync m16n8k16 bf16 -> fp32). One C call queues every
// chunk's launches (clover_ln_mlp_residual, clover_mlp_postln):
//   1. mlp_ln_rows (K2): y = bf16(LN(x)), one warp a row, into the chunk's
//      rows of out (the fc2 pass overwrites them); in the stash form also
//      the fp32 mean and rstd;
//   2. mlp_fc1_pass: h = bf16(gelu(A W1^T + b1)) (rows, H), A = y (K2) or x
//      (K3), GELU (tanh or erf) on the fp32 accumulator plus b1, rounded
//      once; in the stash form also z = bf16(acc + b1) into the caller's
//      stash;
//   3. mlp_fc2_pass: K2, out = bf16(x + s * (h W2^T + b2)), b2, the row
//      scale and the residual added in fp32 in the epilogue, rounded once;
//      K3, the fp32 product (rows, C) into a partial;
//   4. postln_finish_kernel (K3): out = LN(x + b2 + partial), or with the
//      mask LN(x + (partial + b2) * m), one warp a row.
// A row's arithmetic does not depend on where its chunk starts, so any plan
// gives the same bits. PERF.md has the variants measured against this
// design on the H100. Not yet: wgmma, TMA, the hidden kept on chip.

#include <algorithm>

#include "gemm.cuh"

namespace clover {
namespace {

using gemm::Gemm;
using gemm::kBM;
using gemm::kBN;
using gemm::kThreads;

__device__ __forceinline__ float gelu(float h, int tanh_approx) {
  if (tanh_approx) {
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

// y = bf16(LN(x)), one warp a row; the fp32 mean and rstd too where not
// nullptr (the stash form's)
__global__ void __launch_bounds__(kThreads)
mlp_ln_rows(const bf16* __restrict__ x, const float* __restrict__ ln_w,
            const float* __restrict__ ln_b, bf16* __restrict__ y, float* __restrict__ mean,
            float* __restrict__ rstd, int rows, int C, float eps) {
  gemm::ln_rows(x, ln_w, ln_b, y, rows, C, eps, mean, rstd);
}

// both GEMM passes: k-contiguous operands, staged 64 deep
using GemmMlp = Gemm<false, false, 1, 64>;

// h (rows, H) = bf16(gelu(a W1^T + b1)); z (rows, H) = bf16(a W1^T + b1)
// where z is not nullptr: tile (column tile blockIdx.x, row tile blockIdx.y)
__global__ void __launch_bounds__(kThreads, 2)
mlp_fc1_pass(const bf16* __restrict__ a, const bf16* __restrict__ w1,
             const float* __restrict__ b1, bf16* __restrict__ h, bf16* __restrict__ z, int rows,
             int C, int H, int tanh_approx) {
  using G = GemmMlp;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * kBN;
  const long row0 = (long)blockIdx.y * kBM;
  const int a_lim = min(kBM, rows - (int)row0);
  float acc[4][G::NT][4];
  const bf16* const ga[1] = {a + row0 * C};
  const bf16* const gb[1] = {w1 + (long)n0 * C};
  G::run(ga, gb, C, C, a_lim, C, reinterpret_cast<bf16*>(smem), acc);
  float2 bias[G::NT];
#pragma unroll
  for (int n = 0; n < G::NT; ++n)
    bias[n] = *reinterpret_cast<const float2*>(b1 + n0 + wn * 32 + n * 8 + 2 * tq);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 64 + m * 16 + gq + hh * 8;
      if (r >= a_lim) continue;
#pragma unroll
      for (int n = 0; n < G::NT; ++n) {
        const long at = (row0 + r) * H + n0 + wn * 32 + n * 8 + 2 * tq;
        const float v0 = acc[m][n][2 * hh] + bias[n].x, v1 = acc[m][n][2 * hh + 1] + bias[n].y;
        if (z != nullptr) *reinterpret_cast<unsigned*>(z + at) = pack_bf16(v0, v1);
        *reinterpret_cast<unsigned*>(h + at) =
            pack_bf16(gelu(v0, tanh_approx), gelu(v1, tanh_approx));
      }
    }
}

// partial == nullptr: out (rows, C) = bf16(x + s * (h W2^T + b2)), s =
// row_scale[row] (1 without); else the fp32 partial (rows, C) = h W2^T:
// tile (column tile blockIdx.x, row tile blockIdx.y)
__global__ void __launch_bounds__(kThreads, 2)
mlp_fc2_pass(const bf16* __restrict__ h, const bf16* __restrict__ w2,
             const float* __restrict__ b2, const float* __restrict__ row_scale,
             const bf16* __restrict__ x, bf16* __restrict__ out, float* __restrict__ partial,
             int rows, int C, int H) {
  using G = GemmMlp;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = blockIdx.x * kBN;
  const long row0 = (long)blockIdx.y * kBM;
  const int a_lim = min(kBM, rows - (int)row0);
  float acc[4][G::NT][4];
  const bf16* const ga[1] = {h + row0 * H};
  const bf16* const gb[1] = {w2 + (long)c0 * H};
  G::run(ga, gb, H, H, a_lim, H, reinterpret_cast<bf16*>(smem), acc);
  if (partial != nullptr) {
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * 64 + m * 16 + gq + hh * 8;
        if (r >= a_lim) continue;
#pragma unroll
        for (int n = 0; n < G::NT; ++n)
          *reinterpret_cast<float2*>(partial + (row0 + r) * C + c0 + wn * 32 + n * 8 + 2 * tq) =
              make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
      }
    return;
  }
  float2 bias[G::NT];
#pragma unroll
  for (int n = 0; n < G::NT; ++n)
    bias[n] = *reinterpret_cast<const float2*>(b2 + c0 + wn * 32 + n * 8 + 2 * tq);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 64 + m * 16 + gq + hh * 8;
      if (r >= a_lim) continue;
      const long gr = row0 + r;
      const float rs = row_scale != nullptr ? row_scale[gr] : 1.f;
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

// K3's last pass: out = LN(x + b2 + partial), one warp per row, the row's
// C <= 1024 values held in registers. K3M, with the fp32 (rows, C) dropout
// mask m: out = LN(x + (partial + b2) * m), the JAX _kernel_postln_mask's
// order of operations.
__global__ void __launch_bounds__(256)
postln_finish_kernel(const bf16* __restrict__ x, const float* __restrict__ partial,
                     const float* __restrict__ b2, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const float* __restrict__ mask,
                     bf16* __restrict__ out, int rows, int C, float eps) {
  constexpr int kMaxPairs = 16;   // C <= 32 lanes * 2 * 16
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= rows) return;
  float2 z[kMaxPairs];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int c = (i * 32 + lane) * 2;
    if (c >= C) continue;
    float2 v = bf16x2_to_float2(*reinterpret_cast<const unsigned*>(x + row * C + c));
    const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
    const float2 p = *reinterpret_cast<const float2*>(partial + row * C + c);
    if (mask == nullptr) {
      v.x = v.x + bb.x + p.x;
      v.y = v.y + bb.y + p.y;
    } else {
      const float2 m = *reinterpret_cast<const float2*>(mask + row * C + c);
      v.x += (p.x + bb.x) * m.x;
      v.y += (p.y + bb.y) * m.y;
    }
    z[i] = v;
    sum += v.x + v.y;
  }
  const float mean = warp_sum(sum) / C;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    if ((i * 32 + lane) * 2 >= C) continue;
    sq += (z[i].x - mean) * (z[i].x - mean) + (z[i].y - mean) * (z[i].y - mean);
  }
  const float inv = rsqrtf(warp_sum(sq) / C + eps);
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int c = (i * 32 + lane) * 2;
    if (c >= C) continue;
    *reinterpret_cast<unsigned*>(out + row * C + c) =
        pack_bf16((z[i].x - mean) * inv * ln_w[c] + ln_b[c],
                  (z[i].y - mean) * inv * ln_w[c + 1] + ln_b[c + 1]);
  }
}

// The passes' launches on the caller's stream (their arguments checked by
// the C entries); each returns the launch's error, 0 when queued.
int launch_fc1(const bf16* a, const bf16* w1, const float* b1, bf16* h, bf16* z, int rows, int C,
               int H, int tanh_approx, cudaStream_t st) {
  dim3 grid;
  if (!gemm::grid(rows, H, grid)) return (int)cudaErrorInvalidValue;
  mlp_fc1_pass<<<grid, kThreads, GemmMlp::pipe_bytes, st>>>(a, w1, b1, h, z, rows, C, H,
                                                            tanh_approx);
  return (int)cudaGetLastError();
}

int launch_fc2(const bf16* h, const bf16* w2, const float* b2, const float* row_scale,
               const bf16* x, bf16* out, float* partial, int rows, int C, int H,
               cudaStream_t st) {
  dim3 grid;
  if (!gemm::grid(rows, C, grid)) return (int)cudaErrorInvalidValue;
  mlp_fc2_pass<<<grid, kThreads, GemmMlp::pipe_bytes, st>>>(h, w2, b2, row_scale, x, out,
                                                            partial, rows, C, H);
  return (int)cudaGetLastError();
}

int allow_passes() {
  const int rc = gemm::allow_smem(mlp_fc1_pass, GemmMlp::pipe_bytes);
  return rc ? rc : gemm::allow_smem(mlp_fc2_pass, GemmMlp::pipe_bytes);
}

}  // namespace
}  // namespace clover

// K2 (and its training forms) over rows in chunks of `chunk` rows, one call
// for every launch: per chunk LN rows into the chunk's rows of out (with
// the fp32 mean / rstd (rows) where mean is not nullptr), fc1 on them into
// the workspace h (chunk, H) bf16 (and the pre-GELU z (rows, H) bf16 where
// not nullptr), fc2 from h into out = x + s * (h W2^T + b2), s = row_scale
// (rows) fp32 or 1 where nullptr. x, out (rows, C) bf16; w1 (H, C), w2 (C,
// H) bf16; ln_w, ln_b, b2 (C), b1 (H) fp32. C and H multiples of 128.
extern "C" int clover_ln_mlp_residual(const void* x, const void* ln_w, const void* ln_b,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* row_scale, void* h, void* out,
                                      void* z, void* mean, void* rstd, int rows, int C, int H,
                                      int chunk, float eps, int tanh_approx, void* stream) {
  using namespace clover;
  if (rows <= 0 || C <= 0 || C % kBN || H <= 0 || H % kBN || chunk <= 0 ||
      ((mean == nullptr) != (rstd == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  int rc = allow_passes();
  const cudaStream_t st = (cudaStream_t)stream;
  for (long r0 = 0; r0 < rows && rc == 0; r0 += chunk) {
    const int n = (int)std::min<long>(chunk, rows - r0);
    const bf16* xc = (const bf16*)x + r0 * C;
    bf16* oc = (bf16*)out + r0 * C;
    mlp_ln_rows<<<(n + 7) / 8, kThreads, 0, st>>>(
        xc, (const float*)ln_w, (const float*)ln_b, oc,
        mean == nullptr ? nullptr : (float*)mean + r0,
        rstd == nullptr ? nullptr : (float*)rstd + r0, n, C, eps);
    rc = launch_fc1(oc, (const bf16*)w1, (const float*)b1, (bf16*)h,
                    z == nullptr ? nullptr : (bf16*)z + r0 * H, n, C, H, tanh_approx, st);
    if (rc) break;
    rc = launch_fc2((const bf16*)h, (const bf16*)w2, (const float*)b2,
                    row_scale == nullptr ? nullptr : (const float*)row_scale + r0, xc, oc,
                    nullptr, n, C, H, st);
  }
  return rc;
}

// K3 / K3M over rows in chunks of `chunk` rows, one call for every launch:
// per chunk fc1 with the erf GELU on x into the workspace h (chunk, H) bf16,
// fc2 into the workspace partial (chunk, C) fp32, the finish into out
// (rows, C) bf16. x (rows, C) bf16; w1 (H, C), w2 (C, H) bf16; b1 (H), b2,
// ln_w, ln_b (C) fp32; mask (rows, C) fp32 or nullptr (K3M or K3). C a
// multiple of 128, at most 1024; H of 128.
extern "C" int clover_mlp_postln(const void* x, const void* ln_w, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 const void* mask, void* h, void* partial, void* out, int rows,
                                 int C, int H, int chunk, float eps, void* stream) {
  using namespace clover;
  if (rows <= 0 || C <= 0 || C % kBN || C > 1024 || H <= 0 || H % kBN || chunk <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int rc = allow_passes();
  const cudaStream_t st = (cudaStream_t)stream;
  for (long r0 = 0; r0 < rows && rc == 0; r0 += chunk) {
    const int n = (int)std::min<long>(chunk, rows - r0);
    const bf16* xc = (const bf16*)x + r0 * C;
    rc = launch_fc1(xc, (const bf16*)w1, (const float*)b1, (bf16*)h, nullptr, n, C, H, 0, st);
    if (rc) break;
    rc = launch_fc2((const bf16*)h, (const bf16*)w2, nullptr, nullptr, nullptr, nullptr,
                    (float*)partial, n, C, H, st);
    if (rc) break;
    postln_finish_kernel<<<(n + 7) / 8, 256, 0, st>>>(
        xc, (const float*)partial, (const float*)b2, (const float*)ln_w, (const float*)ln_b,
        mask == nullptr ? nullptr : (const float*)mask + r0 * C, (bf16*)out + r0 * C, n, C,
        eps);
    rc = (int)cudaGetLastError();
  }
  return rc;
}
