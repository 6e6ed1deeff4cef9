// K7 and K8: the recompute backward of the Swin MLP half as passes of tiled
// GEMMs
//
//   out = x + s * (gelu(LN(x) W1^T + b1) W2^T + b2)
//
// from x, the parameters, the optional per-row DropPath scale s and the
// incoming gradient g, with LN, fc1 and GELU recomputed:
//   y = bf16(LN(x)), z = y W1^T + b1 (fp32), h = gelu(z),
//   u = g W2 (so that dh = s u = (g s) W2), dz = s u gelu'(z),
//   dy = bf16(dz) W1, dx = LN backward of dy + g (bf16),
//   dscale = sum_r dy xn, dbias = sum_r dy, db2 = sum_r g s,
//   dW1 = bf16(dz)^T y, db1 = sum_r dz, dW2 = g^T bf16(s h),
//   drs = sum_c g (h W2^T + b2) = sum_j h u + g . b2 (per row, where s is
//   given).
// g is bf16, so g W2 and g^T bf16(s h) take it exactly: the row scale is
// applied in fp32 to u and folded into the one rounding of s h.
//
// K7 replaces clover_tpu/ops/mlp_block.py::_backward_onepass
// (_kernel_bwd_onepass, tanh or erf). K8 replaces ::_backward_pallas (the
// pair _kernel_bwd_dx* / _kernel_bwd_dw*, erf only): the same function, so
// the same passes with the erf GELU (ops/mlp_block.py::
// ln_mlp_residual_bwd_pair; one C call, counted apart from K7's). The TPU kernel carries dW1 / dW2 in
// VMEM from one grid step to the next, since its grid runs in order; on the
// H100 blocks run at the same time, so the row sum of dW1 / dW2 is written
// here as a GEMM with K = rows (split over row groups into fp32 slots,
// summed in a fixed order), never as an accumulation into device memory.
//
// Bound: 10 rows C H flops (z, u, dy, dW1, dW2) on the tensor cores against
// ~6 rows C bytes of x, g and dx; the passes add dz and s h, 2 rows H bytes
// each, written once and read twice (pass B reads dz, pass D both).
//
// A call: a cast of W1 to bf16 and of W2 to bf16 W2^T, then per chunk of rows
//   1. k7_ln_rows: y = bf16(LN(x) ln_w + ln_b), one warp a row;
//   2. pass A (k7_pass_a): a 128-row x 128-hidden tile of z = y W1^T and
//      u = g W2 (two products sharing the tile and its pipeline) on 16
//      warps, 8 a product, which hand each other half the accumulators
//      through shared memory; in registers GELU, gelu', dz and s h (written
//      bf16), the tile's drs partial per row and its db1 partial per column
//      (from the fp32 dz);
//   3. pass B (k7_pass_b): dy = bf16(dz) W1 (K = H), fp32;
//   4. pass C (k7_ln_bwd): dx, drs (the pass-A partials in order + g . b2) and
//      per-block partials of dscale, dbias, db2; block b walks its rows;
//   5. pass D (k7_pass_d): dW1 = dz^T y (M = H, N = C) and dW2 =
//      g^T s h (M = C, N = H), K = a group of split_rows rows, into the
//      group's fp32 slot, with db1 from pass A's partials of its row tiles;
// and last k7_sum_slots sums the slots (dW1, dW2, db1; then dscale, dbias,
// db2) in slot order in fp64: two calls give the same bits, no atomics.
// The GEMM core (csrc/gemm.cuh, shared with K6's passes): 128 x 128 block
// tiles of 8 warps a product, a ring of 3 cp.async stages, mma.sync
// m16n8k16 bf16 -> fp32. Passes A and B stage 64 deep (their operands are
// k-contiguous: 128-byte rows); pass D's k-major tiles fetch 256-byte rows
// at 32. PERF.md has the variants measured against this one on the H100
// (4 stages, 64-column or 8-warp pass A, 128 x 256 pass D tiles, 32-deep A
// and B). Not yet: wgmma, TMA (one main loop serves the three GEMM passes).

#include <algorithm>

#include "gemm.cuh"

namespace clover {
namespace {

using gemm::Gemm;
using gemm::allow_smem;
using gemm::kBM;
using gemm::kBN;
using gemm::kThreads;
using gemm::row_stats;

// h = gelu(z) and gelu'(z) (the JAX _gelu_grad), tanh or erf; the tanh as
// 1 - 2 / (1 + e^2a), within ~1e-7 of tanhf
__device__ __forceinline__ void gelu_and_grad(float z, int tanh_approx, float& h, float& dg) {
  if (tanh_approx) {
    const float c = 0.7978845608028654f;
    const float t = 1.f - __fdividef(2.f, 1.f + __expf(2.f * c * (z + 0.044715f * z * z * z)));
    h = 0.5f * z * (1.f + t);
    dg = 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * c * (1.f + 0.134145f * z * z);
  } else {
    const float e = erff(z * 0.7071067811865476f);
    h = 0.5f * z * (1.f + e);
    dg = 0.5f * (1.f + e) + z * __expf(-0.5f * z * z) * 0.3989422804014327f;
  }
}

// W1 (H, C) fp32 -> bf16 as it is; W2 (C, H) fp32 -> bf16 W2^T (H, C), through
// a 32 x 32 shared tile. Grid (H / 32, C / 32), 32 x 8 threads.
__global__ void k7_cast_weights(const float* __restrict__ w1, const float* __restrict__ w2,
                                bf16* __restrict__ w1b, bf16* __restrict__ w2t, int C, int H) {
  __shared__ float t[32][33];
  const int j0 = blockIdx.x * 32, c0 = blockIdx.y * 32, tx = threadIdx.x, ty = threadIdx.y;
  for (int i = ty; i < 32; i += 8) {
    const long k = (long)(j0 + i) * C + c0 + tx;
    w1b[k] = __float2bfloat16_rn(w1[k]);
    t[i][tx] = w2[(long)(c0 + i) * H + j0 + tx];
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8)
    w2t[(long)(j0 + i) * C + c0 + tx] = __float2bfloat16_rn(t[tx][i]);
}

// y = bf16(LN(x) * ln_w + ln_b), one warp a row
__global__ void __launch_bounds__(kThreads) k7_ln_rows(const bf16* __restrict__ x,
                                                       const float* __restrict__ ln_w,
                                                       const float* __restrict__ ln_b,
                                                       bf16* __restrict__ y, int rows, int C,
                                                       float eps) {
  gemm::ln_rows(x, ln_w, ln_b, y, rows, C, eps);
}

// ------------------------------------------------------------------ pass A

// Tile (hidden tile blockIdx.x of 128 columns, row tile blockIdx.y) on 16
// warps, one block an SM: the first 8 run z = y W1^T, the other 8 u = g W2
// over the same tile (each warp 64 x 32); then each half hands the other the
// accumulators of two of its four m16 tiles through shared memory and
// finishes the other two: dz, s h -> (rows, H) bf16; drs_part[r * (H / 128)
// + blockIdx.x] (when given) and db1_part[blockIdx.y * H + j] fp32.
// Stages 64 deep: both operands are k-contiguous rows.
using GemmA = Gemm<false, false, 2, 64>;
constexpr size_t kPassABytes = GemmA::pipe_bytes + (4 * kBM + 4 * kBN) * sizeof(float);

__global__ void __launch_bounds__(GemmA::THREADS, 1)
k7_pass_a(const bf16* __restrict__ y, const bf16* __restrict__ g, const bf16* __restrict__ w1b,
          const bf16* __restrict__ w2t, const float* __restrict__ b1,
          const float* __restrict__ row_scale, bf16* __restrict__ dz, bf16* __restrict__ hs,
          float* __restrict__ drs_part, float* __restrict__ db1_part, int rows, int C, int H,
          int tanh_approx) {
  using G = GemmA;
  constexpr int NT = G::NT, HT = kThreads;
  static_assert(G::pipe_bytes >= 2 * 32 * HT * sizeof(float), "the hand-over fits");
  extern __shared__ __align__(128) unsigned char smem[];
  float* xch = reinterpret_cast<float*>(smem);                   // [32][2][HT], after the loop
  float* red = reinterpret_cast<float*>(smem + G::pipe_bytes);   // [4][kBM] drs, [4][kBN] db1
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int half = warp / 8, wm = warp % 8 / 4, wn = warp % 4, t8 = threadIdx.x % HT;
  const int gq = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * kBN;
  const long row0 = (long)blockIdx.y * kBM;
  const int a_lim = min(kBM, rows - (int)row0);

  float acc[4][NT][4];
  const bf16* const ga[2] = {y + row0 * C, g + row0 * C};
  const bf16* const gb[2] = {w1b + (long)j0 * C, w2t + (long)j0 * C};
  G::run(ga, gb, C, C, a_lim, C, reinterpret_cast<bf16*>(smem), acc);
  // z warps hand over m tiles 2-3, u warps 0-1; element k of the two tiles
  // at xch[(k * 2 + half) * HT + t8], the partner thread's t8 the same
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        xch[(((mm * NT + n) * 4 + e) * 2 + half) * HT + t8] =
            half ? acc[mm][n][e] : acc[2 + mm][n][e];   // constant indices: registers
  __syncthreads();

  float2 bias[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    bias[n] = *reinterpret_cast<const float2*>(b1 + j0 + wn * 32 + n * 8 + 2 * tq);
  float colsum[NT][2] = {};
#pragma unroll
  for (int mm = 0; mm < 2; ++mm)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int m = half * 2 + mm;
      const int r = wm * 64 + m * 16 + gq + hh * 8;
      const long gr = row0 + r;
      const bool valid = r < a_lim;
      const float s = valid ? (row_scale != nullptr ? row_scale[gr] : 1.f) : 0.f;
      float rsum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int j = j0 + wn * 32 + n * 8 + 2 * tq;
        float dzv[2], hsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float own = half ? acc[2 + mm][n][2 * hh + e] : acc[mm][n][2 * hh + e];
          const float other = xch[(((mm * NT + n) * 4 + 2 * hh + e) * 2 + 1 - half) * HT + t8];
          const float z = (half ? other : own) + (e ? bias[n].y : bias[n].x);
          const float u = half ? own : other;
          float h, dg;
          gelu_and_grad(z, tanh_approx, h, dg);
          dzv[e] = s * u * dg;
          hsv[e] = s * h;
          rsum += h * u;
          colsum[n][e] += dzv[e];
        }
        if (valid) {
          *reinterpret_cast<unsigned*>(dz + gr * H + j) = pack_bf16(dzv[0], dzv[1]);
          *reinterpret_cast<unsigned*>(hs + gr * H + j) = pack_bf16(hsv[0], hsv[1]);
        }
      }
      if (drs_part != nullptr) {
        rsum = quad_sum(rsum);
        if (tq == 0) red[wn * kBM + r] = rsum;
      }
    }
  // db1: the column's dz over this warp's 32 rows, then the four row quarters in order
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = colsum[n][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (gq == 0) red[4 * kBM + (wm * 2 + half) * kBN + wn * 32 + n * 8 + 2 * tq + e] = v;
    }
  __syncthreads();
  const int t = threadIdx.x;
  if (drs_part != nullptr && t < a_lim) {
    drs_part[(row0 + t) * (H / kBN) + blockIdx.x] =
        red[t] + red[kBM + t] + red[2 * kBM + t] + red[3 * kBM + t];
  }
  if (t < kBN) {
    const float* d = red + 4 * kBM + t;
    db1_part[(long)blockIdx.y * H + j0 + t] = d[0] + d[kBN] + d[2 * kBN] + d[3 * kBN];
  }
}

// ------------------------------------------------------------------ pass B

// dy[rows, C] (fp32) = dz W1: tile (column tile blockIdx.x, row tile
// blockIdx.y), stages 64 deep (dz's rows are k-contiguous)
using GemmB = Gemm<false, true, 1, 64>;

__global__ void __launch_bounds__(kThreads, 2)
k7_pass_b(const bf16* __restrict__ dz, const bf16* __restrict__ w1b, float* __restrict__ dy,
          int rows, int C, int H) {
  using G = GemmB;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int c0 = blockIdx.x * 128;
  const long row0 = (long)blockIdx.y * kBM;
  const int a_lim = min(kBM, rows - (int)row0);
  float acc[4][G::NT][4];
  const bf16* const ga[1] = {dz + row0 * H};
  const bf16* const gb[1] = {w1b + c0};   // W1 (H, C): depth j, column c
  G::run(ga, gb, H, C, a_lim, H, reinterpret_cast<bf16*>(smem), acc);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 64 + m * 16 + gq + hh * 8;
      if (r >= a_lim) continue;
#pragma unroll
      for (int n = 0; n < G::NT; ++n)
        *reinterpret_cast<float2*>(dy + (row0 + r) * C + c0 + wn * 32 + n * 8 + 2 * tq) =
            make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
    }
}

// ------------------------------------------------------------------ pass C

// The LN backward of dy, one warp a row; block b walks the rows b * 8 + warp,
// + 8 gridDim.x, ...; lane l owns the column pairs l + 32 i. Per block,
// part[blockIdx.x] = [dscale C][dbias C][db2 C] over its rows.
template <int C>
__global__ void __launch_bounds__(kThreads)
k7_ln_bwd(const bf16* __restrict__ x, const bf16* __restrict__ g, const float* __restrict__ dy,
          const float* __restrict__ ln_w, const float* __restrict__ b2,
          const float* __restrict__ row_scale, const float* __restrict__ drs_part, int n_ht,
          bf16* __restrict__ dx, float* __restrict__ drs, float* __restrict__ part, int rows,
          float eps) {
  constexpr int P = C / 64;   // column pairs a lane
  __shared__ float red[3 * C];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2 ds[P], db[P], d2[P];
#pragma unroll
  for (int i = 0; i < P; ++i) ds[i] = db[i] = d2[i] = make_float2(0.f, 0.f);
  for (long r = (long)blockIdx.x * 8 + warp; r < rows; r += 8L * gridDim.x) {
    const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + r * C);
    const __nv_bfloat162* gr = reinterpret_cast<const __nv_bfloat162*>(g + r * C);
    const float2* dyr = reinterpret_cast<const float2*>(dy + r * C);
    float mean, rstd;
    row_stats(xr, C / 2, eps, lane, mean, rstd);
    const float s = row_scale != nullptr ? row_scale[r] : 1.f;
    float2 xn[P], dyt[P];
    float s1 = 0.f, s2 = 0.f, gb = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = lane + 32 * i;
      const float2 xv = __bfloat1622float2(xr[c]), d = dyr[c];
      const float2 w = reinterpret_cast<const float2*>(ln_w)[c];
      xn[i] = make_float2((xv.x - mean) * rstd, (xv.y - mean) * rstd);
      dyt[i] = make_float2(d.x * w.x, d.y * w.y);
      s1 += dyt[i].x + dyt[i].y;
      s2 += dyt[i].x * xn[i].x + dyt[i].y * xn[i].y;
      ds[i].x += d.x * xn[i].x;
      ds[i].y += d.y * xn[i].y;
      db[i].x += d.x;
      db[i].y += d.y;
    }
    const float m1 = warp_sum(s1) / C, m2 = warp_sum(s2) / C;
    __nv_bfloat162* dxr = reinterpret_cast<__nv_bfloat162*>(dx + r * C);
#pragma unroll
    for (int i = 0; i < P; ++i) {
      const int c = lane + 32 * i;
      const float2 gv = __bfloat1622float2(gr[c]);
      dxr[c] = __floats2bfloat162_rn(rstd * (dyt[i].x - m1 - xn[i].x * m2) + gv.x,
                                     rstd * (dyt[i].y - m1 - xn[i].y * m2) + gv.y);
      d2[i].x += gv.x * s;
      d2[i].y += gv.y * s;
      if (drs != nullptr) {
        const float2 bv = reinterpret_cast<const float2*>(b2)[c];
        gb += gv.x * bv.x + gv.y * bv.y;
      }
    }
    if (drs != nullptr) {
      float hu = 0.f;
      for (int t = lane; t < n_ht; t += 32) hu += drs_part[r * n_ht + t];
      hu = warp_sum(hu);
      gb = warp_sum(gb);
      if (lane == 0) drs[r] = hu + gb;
    }
  }
  // the block's partials: its warps added in order through shared memory
  for (int wi = 0; wi < 8; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int i = 0; i < P; ++i) {
        const int c = 2 * (lane + 32 * i);
        const float2 v[3] = {ds[i], db[i], d2[i]};
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          red[k * C + c] = wi ? red[k * C + c] + v[k].x : v[k].x;
          red[k * C + c + 1] = wi ? red[k * C + c + 1] + v[k].y : v[k].y;
        }
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < 3 * C; i += kThreads) part[(long)blockIdx.x * 3 * C + i] = red[i];
}

// ------------------------------------------------------------------ pass D

// Pass D: blockIdx.x a 128 x 128 output tile of dW1 (H x C, M = H: A = dz,
// B = y; the first (H / 128) (C / 128)) or of dW2 (C x H, M = C: A = g, B =
// s h), over the row group blockIdx.y ([y * split_rows, + split_rows)),
// written into slot blockIdx.y of part ([dW1][dW2][db1], stride 2 H C + H);
// a dW1 tile of column 0 also sums db1 over the group's row tiles from pass
// A's partials. Stages 32 deep: the k-major tiles fetch 256-byte rows.
using GemmD = Gemm<true, true, 1, 32>;

__global__ void __launch_bounds__(kThreads, 2)
k7_pass_d(const bf16* __restrict__ dz, const bf16* __restrict__ hs, const bf16* __restrict__ y,
          const bf16* __restrict__ g, const float* __restrict__ db1_part, float* __restrict__ part,
          int rows, int C, int H, int split_rows) {
  using G = GemmD;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n1 = (H / kBM) * (C / kBN);
  const bool w2_tile = blockIdx.x >= n1;
  const int t = blockIdx.x - (w2_tile ? n1 : 0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  const int gq = lane >> 2, tq = lane & 3;
  const int N = w2_tile ? H : C;
  const int m0 = t / (N / kBN) * kBM, n0 = t % (N / kBN) * kBN;
  const long k0 = (long)blockIdx.y * split_rows;
  const int k_len = min(split_rows, rows - (int)k0);
  const bf16* const ga[1] = {w2_tile ? g + k0 * C + m0 : dz + k0 * H + m0};
  const bf16* const gb[1] = {w2_tile ? hs + k0 * H + n0 : y + k0 * C + n0};
  float acc[4][G::NT][4];
  G::run(ga, gb, w2_tile ? C : H, w2_tile ? H : C, 0, k_len, reinterpret_cast<bf16*>(smem), acc);

  float* slot = part + (long)blockIdx.y * (2L * H * C + H);
  float* out = slot + (w2_tile ? (long)H * C : 0);
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long r = m0 + wm * 64 + m * 16 + gq + hh * 8;
#pragma unroll
      for (int n = 0; n < G::NT; ++n)
        *reinterpret_cast<float2*>(out + r * N + n0 + wn * 32 + n * 8 + 2 * tq) =
            make_float2(acc[m][n][2 * hh], acc[m][n][2 * hh + 1]);
    }
  if (!w2_tile && n0 == 0 && threadIdx.x < kBM) {
    float v = 0.f;
    const int rt0 = (int)(k0 / kBM), rt1 = (int)((k0 + k_len + kBM - 1) / kBM);
    for (int rt = rt0; rt < rt1; ++rt) v += db1_part[(long)rt * H + m0 + threadIdx.x];
    slot[2L * H * C + m0 + threadIdx.x] = v;
  }
}

// out[i] = sum over the slots of part[s * stride + i] in fp64: blockDim.y
// running sums over every blockDim.y-th slot, added in order. Blocks of
// (X, Y), X * Y <= 1024, walk the outputs X at a time.
__global__ void k7_sum_slots(const float* __restrict__ part, long stride, int slots, long n,
                             float* __restrict__ out) {
  __shared__ double red[1024];
  const int X = blockDim.x, tx = threadIdx.x, ty = threadIdx.y;
  for (long i0 = (long)blockIdx.x * X; i0 < n; i0 += (long)gridDim.x * X) {
    const long i = i0 + tx;
    double v = 0.0;
    if (i < n)
      for (int s = ty; s < slots; s += blockDim.y) v += part[s * stride + i];
    red[ty * X + tx] = v;
    __syncthreads();
    if (ty == 0 && i < n) {
      double t = red[tx];
      for (int k = 1; k < (int)blockDim.y; ++k) t += red[k * X + tx];
      out[i] = (float)t;
    }
    __syncthreads();
  }
}

struct K7Args {
  const bf16 *x, *g, *w1b, *w2t;
  const float *ln_w, *ln_b, *b1, *b2, *row_scale;
  bf16 *dx, *y, *dz, *hs;
  float *drs, *dy, *drs_part, *db1_part, *dw_part, *ln_part;
  int C, H;
  float eps;
  int tanh_approx;
  cudaStream_t st;
};

int run_chunk(const K7Args& a, int n, int split_rows, int ln_blocks) {
  const int C = a.C, H = a.H, row_tiles = (n + kBM - 1) / kBM;
  int rc = allow_smem(k7_pass_a, kPassABytes);
  if (!rc) rc = allow_smem(k7_pass_b, GemmB::pipe_bytes);
  if (!rc) rc = allow_smem(k7_pass_d, GemmD::pipe_bytes);
  if (rc) return rc;
  k7_ln_rows<<<(n + 7) / 8, kThreads, 0, a.st>>>(a.x, a.ln_w, a.ln_b, a.y, n, C, a.eps);
  k7_pass_a<<<dim3(H / kBN, row_tiles), GemmA::THREADS, kPassABytes, a.st>>>(
      a.y, a.g, a.w1b, a.w2t, a.b1, a.row_scale, a.dz, a.hs, a.drs_part, a.db1_part, n, C, H,
      a.tanh_approx);
  k7_pass_b<<<dim3(C / kBN, row_tiles), kThreads, GemmB::pipe_bytes, a.st>>>(a.dz, a.w1b, a.dy,
                                                                             n, C, H);
  {
    const int nht = H / kBN;
    if (C == 128) {
      k7_ln_bwd<128><<<ln_blocks, kThreads, 0, a.st>>>(a.x, a.g, a.dy, a.ln_w, a.b2, a.row_scale,
          a.drs_part, nht, a.dx, a.drs, a.ln_part, n, a.eps);
    } else if (C == 256) {
      k7_ln_bwd<256><<<ln_blocks, kThreads, 0, a.st>>>(a.x, a.g, a.dy, a.ln_w, a.b2, a.row_scale,
          a.drs_part, nht, a.dx, a.drs, a.ln_part, n, a.eps);
    } else if (C == 512) {
      k7_ln_bwd<512><<<ln_blocks, kThreads, 0, a.st>>>(a.x, a.g, a.dy, a.ln_w, a.b2, a.row_scale,
          a.drs_part, nht, a.dx, a.drs, a.ln_part, n, a.eps);
    } else {
      k7_ln_bwd<1024><<<ln_blocks, kThreads, 0, a.st>>>(a.x, a.g, a.dy, a.ln_w, a.b2, a.row_scale,
          a.drs_part, nht, a.dx, a.drs, a.ln_part, n, a.eps);
    }
  }
  const int splits = (n + split_rows - 1) / split_rows;
  k7_pass_d<<<dim3(2 * (H / kBM) * (C / kBN), splits), kThreads, GemmD::pipe_bytes, a.st>>>(
      a.dz, a.hs, a.y, a.g, a.db1_part, a.dw_part, n, C, H, split_rows);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// K7. w1 (H, C) and w2 (C, H) fp32; y (chunk_rows, C) and dz, hs (chunk_rows,
// H) bf16, dy (chunk_rows, C), drs_part (chunk_rows, H / 128; with a row
// scale), db1_part (chunk_rows / 128, H) fp32 and w1b, w2t (H, C) bf16 are
// scratch; dw_part (dw_slots, 2 H C + H) and ln_part (ln_slots, 3 C) fp32
// the slots; out (2 H C + H + 3 C) fp32 = [dW1 (H, C)][dW2 (C, H)][db1]
// [dscale][dbias][db2]. The rows go in chunks of chunk_rows (a multiple of
// 128), each with row groups of split_rows (a multiple of 128) and at most
// ln_blocks LN blocks; dw_slots and ln_slots must be the totals that gives.
// drs (rows,) fp32 is written when row_scale is given.
extern "C" int clover_mlp_bwd_passes(const void* x, const void* ln_w, const void* ln_b,
                                     const void* w1, const void* b1, const void* w2,
                                     const void* b2, const void* g, const void* row_scale,
                                     void* dx, void* drs, void* w1b, void* w2t, void* y, void* dz,
                                     void* hs, void* dy, void* drs_part, void* db1_part,
                                     void* dw_part, void* ln_part, void* out, int rows, int C,
                                     int H, int chunk_rows, int split_rows, int ln_blocks,
                                     int dw_slots, int ln_slots, float eps,
                                     int tanh_approx, void* stream) {
  using namespace clover;
  if (rows <= 0 || H <= 0 || H % 128 || (C != 128 && C != 256 && C != 512 && C != 1024) ||
      chunk_rows <= 0 || chunk_rows % kBM || split_rows <= 0 || split_rows % kBM ||
      ln_blocks <= 0 || (drs == nullptr) != (row_scale == nullptr) ||
      (row_scale != nullptr && drs_part == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  // the slots this plan fills must be the ones the caller allocated
  int want_dw = 0, want_ln = 0;
  for (long r0 = 0; r0 < rows; r0 += chunk_rows) {
    const int n = (int)std::min((long)chunk_rows, rows - r0);
    want_dw += (n + split_rows - 1) / split_rows;
    want_ln += std::min(ln_blocks, (n + 7) / 8);
  }
  if (want_dw != dw_slots || want_ln != ln_slots) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  k7_cast_weights<<<dim3(H / 32, C / 32), dim3(32, 8), 0, st>>>(
      (const float*)w1, (const float*)w2, (bf16*)w1b, (bf16*)w2t, C, H);
  const long dw_stride = 2L * H * C + H;
  int dw_slot = 0, ln_slot = 0;
  for (long r0 = 0; r0 < rows; r0 += chunk_rows) {
    const int n = (int)std::min((long)chunk_rows, rows - r0);
    const int lnb = std::min(ln_blocks, (n + 7) / 8);
    const K7Args a{(const bf16*)x + r0 * C, (const bf16*)g + r0 * C, (const bf16*)w1b,
                   (const bf16*)w2t, (const float*)ln_w, (const float*)ln_b, (const float*)b1,
                   (const float*)b2, row_scale ? (const float*)row_scale + r0 : nullptr,
                   (bf16*)dx + r0 * C, (bf16*)y, (bf16*)dz, (bf16*)hs,
                   drs ? (float*)drs + r0 : nullptr, (float*)dy,
                   row_scale ? (float*)drs_part : nullptr, (float*)db1_part,
                   (float*)dw_part + dw_slot * dw_stride, (float*)ln_part + (long)ln_slot * 3 * C,
                   C, H, eps, tanh_approx, st};
    const int rc = run_chunk(a, n, split_rows, lnb);
    if (rc) return rc;
    dw_slot += (n + split_rows - 1) / split_rows;
    ln_slot += lnb;
  }
  // the slots: up to ~150 row groups of the products, one running sum an
  // output; hundreds to thousands of LN blocks, 32 running sums an output
  k7_sum_slots<<<(int)std::min(4096L, (dw_stride + 255) / 256), dim3(256, 1), 0, st>>>(
      (const float*)dw_part, dw_stride, dw_slots, dw_stride, (float*)out);
  k7_sum_slots<<<(3 * C + 31) / 32, dim3(32, 32), 0, st>>>(
      (const float*)ln_part, 3L * C, ln_slots, 3L * C, (float*)out + dw_stride);
  return (int)cudaGetLastError();
}
