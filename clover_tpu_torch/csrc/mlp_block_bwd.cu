// K8a/K8b: the recompute backward of the Swin MLP half
//
//   out = x + s * (gelu(LN(x) W1^T + b1) W2^T + b2)
//
// from x, the parameters, the optional per-row DropPath scale s and the
// incoming gradient g, with LN, fc1 and GELU recomputed on chip:
//   y = bf16(LN(x)), z = y W1^T + b1 (fp32), h = gelu(z),
//   u = g W2 (so that dh = s * u = (g s) W2), dz = dh * gelu'(z),
//   dy = bf16(dz) W1, dx = LN backward of dy + g (bf16),
//   dscale = sum_r dy * xn, dbias = sum_r dy, db2 = sum_r g s,
//   dW1 = bf16(dz)^T y, db1 = sum_r dz, dW2 = g^T bf16(s h),
//   drs = sum_c g * (h W2^T + b2) = sum_j h u + g . b2 (per row).
// g is bf16, so g W2 and g^T bf16(s h) take it exactly: the row scale is
// applied in fp32 to u and folded into the one rounding of s h.
//
// K8a and K8b replace clover_tpu/ops/mlp_block.py::_backward_pallas
// (_kernel_bwd_dx* and _kernel_bwd_dw*, erf only). K7, the one-pass form
// (::_backward_onepass), is csrc/mlp_block_bwd_passes.cu.
//
// Bound on the H100: K8a's products are 6 * rows * C * H flops (z, u, dy;
// drs rides on u, where the TPU kernel forms h W2^T) and K8b's 8 (z, u, dW1,
// dW2), against ~6 * rows * C bytes of activations: compute-bound on the
// tensor cores. The TPU kernel
// accumulates dW1 / dW2 in VMEM across a sequential grid; blocks here run
// at the same time, and the two directions of accumulation (dy over the
// hidden, the parameter gradients over the rows) are what each design
// answers.
//
// K8a (row kernel): a block per row block of R rows stages y = LN(x) and g
// as bf16 in shared memory and walks the hidden in chunks of 64. A chunk's
// z and u are two mma.sync products in registers (warps 2 x 4 over rows x
// chunk columns), GELU, gelu', dz and the drs terms are formed there,
// bf16(dz) goes to shared memory, and dy accumulates in registers over the
// chunks (as K2's output does): dx, drs and fixed-order partials of dscale
// / dbias / db2.
// K8b (dW kernel): a block owns a hidden chunk of HC = 8192 / C columns and
// a group of row blocks; per row block it recomputes LN, z and u for its
// chunk (the 8 warps split the K = C sum, added in shared memory in a fixed
// order) and adds dW1[chunk] and dW2[:, chunk] (M = C over the warps, N =
// HC, K = R) into register accumulators that live across its row blocks.
// The groups' partials are summed in a fixed order by the same second
// kernel.
// Weights come as bf16 W1 (H, C), W1^T (C, H) and W2^T (H, C), so every B
// fragment is a k-contiguous 32-bit load, read straight from device memory
// (L2-resident); activations go through ldmatrix. Tail rows stage as zeros
// with s = 0, so they add nothing. Not yet: TMA, wgmma.

#include "common.cuh"

namespace clover {
namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 64;   // hidden columns per chunk of the row kernel
constexpr int kPad = 8;

__device__ __forceinline__ unsigned ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned*>(p));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ float gelu_f(float z, int tanh_approx) {
  if (tanh_approx) {
    return 0.5f * z * (1.f + tanhf(0.7978845608028654f * (z + 0.044715f * z * z * z)));
  }
  return 0.5f * z * (1.f + erff(z * 0.7071067811865476f));
}

// d gelu(z) / dz, both modes (the JAX _gelu_grad)
__device__ __forceinline__ float gelu_grad(float z, int tanh_approx) {
  if (tanh_approx) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (z + 0.044715f * z * z * z));
    return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * c * (1.f + 0.134145f * z * z);
  }
  return 0.5f * (1.f + erff(z * 0.7071067811865476f)) +
         z * expf(-0.5f * z * z) * 0.3989422804014327f;
}

// Stage R rows from row0, one warp a row: y = bf16(LN(x) * ln_w + ln_b) and g
// as bf16 (row stride ld), the row scale (1 when absent), and optionally the
// LN mean / rstd and g . b2. Rows past the end stage as zeros with s = 0.
template <int R, int C>
__device__ void stage_rows(const bf16* __restrict__ x, const bf16* __restrict__ g,
                           const float* __restrict__ ln_w, const float* __restrict__ ln_b,
                           const float* __restrict__ b2, const float* __restrict__ row_scale,
                           long row0, int rows, float eps, bf16* y_s, bf16* g_s, float* s_s,
                           float* mean_s, float* rstd_s, float* gb2_s) {
  constexpr int ld = C + kPad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kWarps) {
    const long gr = row0 + r;
    __nv_bfloat162* yd = reinterpret_cast<__nv_bfloat162*>(y_s + r * ld);
    __nv_bfloat162* gd = reinterpret_cast<__nv_bfloat162*>(g_s + r * ld);
    if (gr >= rows) {
      for (int c = lane; c < C / 2; c += 32) {
        yd[c] = __floats2bfloat162_rn(0.f, 0.f);
        gd[c] = yd[c];
      }
      if (lane == 0) {
        s_s[r] = 0.f;
        if (mean_s != nullptr) mean_s[r] = rstd_s[r] = gb2_s[r] = 0.f;
      }
      continue;
    }
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(x + gr * C);
    const __nv_bfloat162* gs = reinterpret_cast<const __nv_bfloat162*>(g + gr * C);
    float sum = 0.f;
    for (int c = lane; c < C / 2; c += 32) {
      const float2 v = __bfloat1622float2(xs[c]);
      sum += v.x + v.y;
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C / 2; c += 32) {
      const float2 v = __bfloat1622float2(xs[c]);
      sq += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
    }
    const float inv = rsqrtf(warp_sum(sq) / C + eps);
    float gb = 0.f;
    for (int c = lane; c < C / 2; c += 32) {
      const float2 v = __bfloat1622float2(xs[c]);
      yd[c] = __floats2bfloat162_rn((v.x - mean) * inv * ln_w[2 * c] + ln_b[2 * c],
                                    (v.y - mean) * inv * ln_w[2 * c + 1] + ln_b[2 * c + 1]);
      gd[c] = gs[c];
      if (gb2_s != nullptr) {
        const float2 gv = __bfloat1622float2(gs[c]);
        gb += gv.x * b2[2 * c] + gv.y * b2[2 * c + 1];
      }
    }
    if (gb2_s != nullptr) gb = warp_sum(gb);
    if (lane == 0) {
      s_s[r] = row_scale != nullptr ? row_scale[gr] : 1.f;
      if (mean_s != nullptr) {
        mean_s[r] = mean;
        rstd_s[r] = inv;
        gb2_s[r] = gb;
      }
    }
  }
}

template <int R, int C>
struct RowTiling {
  static constexpr int ld = C + kPad, ldh = kChunk + kPad;
  static constexpr int MT = R / 32;      // m16 tiles a warp (2 warp rows)
  static constexpr int NT2 = C / 32;     // dy's n8 tiles a warp (4 warp columns)
  static constexpr size_t y = 0;
  static constexpr size_t gs = align128(y + size_t(R) * ld * sizeof(bf16));
  static constexpr size_t dz = align128(gs + size_t(R) * ld * sizeof(bf16));
  static constexpr size_t f = align128(dz + size_t(R) * ldh * sizeof(bf16));
  // floats: s, mean, rstd, g.b2 [R]; row sums [3][4][R]; column sums [2][2][C]
  static constexpr size_t smem = f + (size_t(16) * R + 4 * C) * sizeof(float);
  static_assert(R % 32 == 0 && C % 128 == 0, "2 x 4 warps");
};

// K8a's row kernel. Block b owns slot b of `part` (slot_stride floats:
// [dscale C][dbias C][db2 C]) and walks row blocks b, b + gridDim.x, ...
template <int R, int C>
__global__ void __launch_bounds__(kThreads, 1)
bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                const float* __restrict__ ln_b, const bf16* __restrict__ w1,
                const bf16* __restrict__ w1t, const float* __restrict__ b1,
                const bf16* __restrict__ w2t, const float* __restrict__ b2,
                const bf16* __restrict__ g, const float* __restrict__ row_scale,
                bf16* __restrict__ dx, float* __restrict__ drs, float* __restrict__ part,
                long slot_stride, int rows, int H, float eps, int tanh_approx) {
  using T = RowTiling<R, C>;
  constexpr int MT = T::MT, NT2 = T::NT2, ld = T::ld, ldh = T::ldh;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* y_s = reinterpret_cast<bf16*>(smem + T::y);
  bf16* g_s = reinterpret_cast<bf16*>(smem + T::gs);
  bf16* dz_s = reinterpret_cast<bf16*>(smem + T::dz);
  float* s_s = reinterpret_cast<float*>(smem + T::f);
  float* mean_s = s_s + R;
  float* rstd_s = mean_s + R;
  float* gb2_s = rstd_s + R;
  float* rowred = gb2_s + R;           // [3][4][R]: dy.w, dy.w.xn, drs per warp column
  float* colred = rowred + 12 * R;     // [2][2][C]: dscale, dbias per warp row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, gq = lane >> 2, tq = lane & 3;
  const int n_rb = (rows + R - 1) / R;
  float* tail = part + blockIdx.x * slot_stride;

  for (int rb = blockIdx.x; rb < n_rb; rb += gridDim.x) {
    const bool first = rb == (int)blockIdx.x;
    const long row0 = (long)rb * R;
    stage_rows<R, C>(x, g, ln_w, ln_b, b2, row_scale, row0, rows, eps, y_s, g_s, s_s, mean_s,
                     rstd_s, gb2_s);
    __syncthreads();

    float dyacc[MT][NT2][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NT2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dyacc[m][n][e] = 0.f;
    float drs_part[MT][2] = {};

    for (int j0 = 0; j0 < H; j0 += kChunk) {
      // z = y W1[chunk]^T and u = g W2[:, chunk]: rows wm*R/2 + m*16, columns wn*16 + n*8
      float zacc[MT][2][4], uacc[MT][2][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) zacc[m][n][e] = uacc[m][n][e] = 0.f;
      const bf16* ya = y_s + wm * (R / 2) * ld;
      const bf16* ga = g_s + wm * (R / 2) * ld;
#pragma unroll 2
      for (int kk = 0; kk < C; kk += 16) {
        unsigned ay[MT][4], ag[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ldmatrix_x4(ay[m], a_tile_row(ya + m * 16 * ld + kk, ld, lane));
          ldmatrix_x4(ag[m], a_tile_row(ga + m * 16 * ld + kk, ld, lane));
        }
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const long j = j0 + wn * 16 + n * 8 + gq;
          const bf16* p1 = w1 + j * C + kk + 2 * tq;
          const bf16* p2 = w2t + j * C + kk + 2 * tq;
          const unsigned b10 = ldg32(p1), b11 = ldg32(p1 + 8);
          const unsigned b20 = ldg32(p2), b21 = ldg32(p2 + 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(zacc[m][n], ay[m], b10, b11);
            mma_bf16(uacc[m][n], ag[m], b20, b21);
          }
        }
      }
      // GELU, gelu', dz and the drs terms in registers; bf16(dz) -> shared
#pragma unroll
      for (int m = 0; m < MT; ++m) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = wm * (R / 2) + m * 16 + gq + hh * 8;
          const float s = s_s[r];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = wn * 16 + n * 8 + 2 * tq;
            float dzv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float z = zacc[m][n][2 * hh + e] + b1[j0 + col + e];
              const float u = uacc[m][n][2 * hh + e];
              const float h = gelu_f(z, tanh_approx);
              dzv[e] = s * u * gelu_grad(z, tanh_approx);
              drs_part[m][hh] += h * u;
            }
            *reinterpret_cast<unsigned*>(dz_s + r * ldh + col) = pack_bf16(dzv[0], dzv[1]);
          }
        }
      }
      __syncthreads();

      // dy += bf16(dz) W1[chunk]: rows wm*R/2 + m*16, columns wn*C/4 + n*8
      const bf16* da = dz_s + wm * (R / 2) * ldh;
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) ldmatrix_x4(a[m], a_tile_row(da + m * 16 * ldh + kk, ldh, lane));
#pragma unroll
        for (int n = 0; n < NT2; ++n) {
          const bf16* p = w1t + (long)(wn * (C / 4) + n * 8 + gq) * H + j0 + kk + 2 * tq;
          const unsigned b0 = ldg32(p), b1v = ldg32(p + 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) mma_bf16(dyacc[m][n], a[m], b0, b1v);
        }
      }

      __syncthreads();   // dz_s is rewritten by the next chunk
    }

    // epilogue: the LN backward of dy, one m16 row pair (gq, gq + 8) of each
    // tile; xn is recomputed from x where it is used (registers hold dy)
    auto xn2 = [&](int r, int col) {
      const long gr = row0 + r;
      if (gr >= rows) return make_float2(0.f, 0.f);
      const float2 v = bf16x2_to_float2(*reinterpret_cast<const unsigned*>(x + gr * C + col));
      return make_float2((v.x - mean_s[r]) * rstd_s[r], (v.y - mean_s[r]) * rstd_s[r]);
    };
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * (R / 2) + m * 16 + gq + hh * 8;
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int n = 0; n < NT2; ++n) {
          const int col = wn * (C / 4) + n * 8 + 2 * tq;
          const float2 xn = xn2(r, col);
          const float t0 = dyacc[m][n][2 * hh] * ln_w[col];
          const float t1 = dyacc[m][n][2 * hh + 1] * ln_w[col + 1];
          s1 += t0 + t1;
          s2 += t0 * xn.x + t1 * xn.y;
        }
        s1 = quad_sum(s1);
        s2 = quad_sum(s2);
        const float d = quad_sum(drs_part[m][hh]);
        if (tq == 0) {
          rowred[wn * R + r] = s1;
          rowred[4 * R + wn * R + r] = s2;
          rowred[8 * R + wn * R + r] = d;
        }
      }
    __syncthreads();
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * (R / 2) + m * 16 + gq + hh * 8;
        const long gr = row0 + r;
        if (gr >= rows) continue;
        float m1 = 0.f, m2 = 0.f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          m1 += rowred[w * R + r];
          m2 += rowred[4 * R + w * R + r];
        }
        m1 /= C;
        m2 /= C;
        const float inv = rstd_s[r];
#pragma unroll
        for (int n = 0; n < NT2; ++n) {
          const int col = wn * (C / 4) + n * 8 + 2 * tq;
          const float2 xn = xn2(r, col);
          const float2 gv = bf16x2_to_float2(*reinterpret_cast<const unsigned*>(g_s + r * ld + col));
          const float d0 = inv * (dyacc[m][n][2 * hh] * ln_w[col] - m1 - xn.x * m2) + gv.x;
          const float d1 = inv * (dyacc[m][n][2 * hh + 1] * ln_w[col + 1] - m1 - xn.y * m2) + gv.y;
          *reinterpret_cast<unsigned*>(dx + gr * C + col) = pack_bf16(d0, d1);
        }
        if (drs != nullptr && wn == 0 && tq == 0) {
          drs[gr] = rowred[8 * R + r] + rowred[9 * R + r] + rowred[10 * R + r] +
                    rowred[11 * R + r] + gb2_s[r];
        }
      }
    // dscale = sum_r dy * xn and dbias = sum_r dy over this warp's rows, then the two warp rows
#pragma unroll
    for (int n = 0; n < NT2; ++n) {
      const int col = wn * (C / 4) + n * 8 + 2 * tq;
      float ds0 = 0.f, ds1 = 0.f, db0 = 0.f, db1v = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 xn = xn2(wm * (R / 2) + m * 16 + gq + hh * 8, col);
          ds0 += dyacc[m][n][2 * hh] * xn.x;
          ds1 += dyacc[m][n][2 * hh + 1] * xn.y;
          db0 += dyacc[m][n][2 * hh];
          db1v += dyacc[m][n][2 * hh + 1];
        }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        ds0 += __shfl_xor_sync(0xffffffffu, ds0, o);
        ds1 += __shfl_xor_sync(0xffffffffu, ds1, o);
        db0 += __shfl_xor_sync(0xffffffffu, db0, o);
        db1v += __shfl_xor_sync(0xffffffffu, db1v, o);
      }
      if (gq == 0) {
        colred[wm * C + col] = ds0;
        colred[wm * C + col + 1] = ds1;
        colred[2 * C + wm * C + col] = db0;
        colred[2 * C + wm * C + col + 1] = db1v;
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += kThreads) {
      float db2 = 0.f;
      for (int r = 0; r < R; ++r) db2 += __bfloat162float(g_s[r * ld + c]) * s_s[r];
      const float v[3] = {colred[c] + colred[C + c], colred[2 * C + c] + colred[3 * C + c], db2};
#pragma unroll
      for (int k = 0; k < 3; ++k) tail[k * C + c] = first ? v[k] : tail[k * C + c] + v[k];
    }
    __syncthreads();   // the next row block restages y_s, g_s and the row arrays
  }
}

template <int R, int C, int HC>
struct DwTiling {
  static constexpr int ld = C + kPad, ldh = HC + kPad;
  static constexpr int MT = R / 16, NT = HC / 8;     // z / u tiles (every warp, its K slice)
  static constexpr int MW = C / 128;                  // dW m16 tiles a warp (M = C over 8 warps)
  static constexpr size_t y = 0;
  static constexpr size_t gs = align128(y + size_t(R) * ld * sizeof(bf16));
  static constexpr size_t dz = align128(gs + size_t(R) * ld * sizeof(bf16));
  static constexpr size_t hs = align128(dz + size_t(R) * ldh * sizeof(bf16));
  static constexpr size_t f = align128(hs + size_t(R) * ldh * sizeof(bf16));
  // floats: s [R]; z and u K-slice partials [2][8][R * HC]; db1 [256]
  static constexpr size_t smem = f + (size_t(R) + 16 * R * HC + kThreads) * sizeof(float);
  static_assert(R % 16 == 0 && C % 128 == 0 && HC % 8 == 0 && kThreads % HC == 0, "tiling");
};

// K8b: dW1[chunk, :], db1[chunk], dW2[:, chunk] for hidden chunk blockIdx.x
// over the row blocks blockIdx.y, + gridDim.y, ...; group slot blockIdx.y of
// `part`: [dW1 H x C][dW2 C x H][db1 H] (torch layouts).
template <int R, int C, int HC>
__global__ void __launch_bounds__(kThreads, 1)
bwd_dw_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
              const float* __restrict__ ln_b, const bf16* __restrict__ w1,
              const float* __restrict__ b1, const bf16* __restrict__ w2t,
              const bf16* __restrict__ g, const float* __restrict__ row_scale,
              float* __restrict__ part, long slot_stride, int rows, int H, float eps) {
  using T = DwTiling<R, C, HC>;
  constexpr int MT = T::MT, NT = T::NT, MW = T::MW, ld = T::ld, ldh = T::ldh;
  constexpr int KW = C / kWarps;   // each warp's slice of the K = C sum
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* y_s = reinterpret_cast<bf16*>(smem + T::y);
  bf16* g_s = reinterpret_cast<bf16*>(smem + T::gs);
  bf16* dz_s = reinterpret_cast<bf16*>(smem + T::dz);
  bf16* hs_s = reinterpret_cast<bf16*>(smem + T::hs);
  float* s_s = reinterpret_cast<float*>(smem + T::f);
  float* zred = s_s + R;                  // [8][R * HC]
  float* ured = zred + 8 * R * HC;        // [8][R * HC]
  float* db1red = ured + 8 * R * HC;      // [256]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int j0 = blockIdx.x * HC;
  const int n_rb = (rows + R - 1) / R;

  float acc1[MW][NT][4], acc2[MW][NT][4];   // dW1^T and dW2 rows c = warp*C/8 + i*16
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[i][n][e] = acc2[i][n][e] = 0.f;
  float db1acc = 0.f;   // column threadIdx.x % HC

  for (int rb = blockIdx.y; rb < n_rb; rb += gridDim.y) {
    stage_rows<R, C>(x, g, ln_w, ln_b, nullptr, row_scale, (long)rb * R, rows, eps, y_s, g_s, s_s,
                     nullptr, nullptr, nullptr);
    __syncthreads();
    {  // this warp's K slice of z = y W1[chunk]^T and u = g W2[:, chunk]
      float zacc[MT][NT][4], uacc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) zacc[m][n][e] = uacc[m][n][e] = 0.f;
#pragma unroll
      for (int kk = warp * KW; kk < (warp + 1) * KW; kk += 16) {
        unsigned ay[MT][4], ag[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          ldmatrix_x4(ay[m], a_tile_row(y_s + m * 16 * ld + kk, ld, lane));
          ldmatrix_x4(ag[m], a_tile_row(g_s + m * 16 * ld + kk, ld, lane));
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const long j = j0 + n * 8 + gq;
          const bf16* p1 = w1 + j * C + kk + 2 * tq;
          const bf16* p2 = w2t + j * C + kk + 2 * tq;
          const unsigned b10 = ldg32(p1), b11 = ldg32(p1 + 8);
          const unsigned b20 = ldg32(p2), b21 = ldg32(p2 + 8);
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(zacc[m][n], ay[m], b10, b11);
            mma_bf16(uacc[m][n], ag[m], b20, b21);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int idx = (m * 16 + gq + hh * 8) * HC + n * 8 + 2 * tq;
            *reinterpret_cast<float2*>(zred + warp * R * HC + idx) =
                make_float2(zacc[m][n][2 * hh], zacc[m][n][2 * hh + 1]);
            *reinterpret_cast<float2*>(ured + warp * R * HC + idx) =
                make_float2(uacc[m][n][2 * hh], uacc[m][n][2 * hh + 1]);
          }
    }
    __syncthreads();
    // the K slices summed in warp order; GELU, gelu', dz (erf)
    for (int e = threadIdx.x; e < R * HC; e += kThreads) {
      const int r = e / HC, j = e % HC;
      float z = b1[j0 + j], u = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        z += zred[w * R * HC + e];
        u += ured[w * R * HC + e];
      }
      const float s = s_s[r];
      const float dz = s * u * gelu_grad(z, 0);
      dz_s[r * ldh + j] = __float2bfloat16_rn(dz);
      hs_s[r * ldh + j] = __float2bfloat16_rn(s * gelu_f(z, 0));
      db1acc += dz;
    }
    __syncthreads();
    // dW1^T[c, j] += sum_r y[r, c] dz[r, j], dW2[c, j] += sum_r g[r, c] (s h)[r, j]
#pragma unroll
    for (int kk = 0; kk < R; kk += 16) {
      unsigned bz[NT][2], bh[NT][2];
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        if constexpr (NT >= 2) {
          unsigned t[4];
          ldmatrix_x4_trans(t, a_tile_row(dz_s + kk * ldh + n * 8, ldh, lane));
          bz[n][0] = t[0], bz[n][1] = t[1], bz[n + 1][0] = t[2], bz[n + 1][1] = t[3];
          ldmatrix_x4_trans(t, a_tile_row(hs_s + kk * ldh + n * 8, ldh, lane));
          bh[n][0] = t[0], bh[n][1] = t[1], bh[n + 1][0] = t[2], bh[n + 1][1] = t[3];
        } else {
          ldmatrix_x2_trans(bz[n], a_tile_row(dz_s + kk * ldh + n * 8, ldh, lane));
          ldmatrix_x2_trans(bh[n], a_tile_row(hs_s + kk * ldh + n * 8, ldh, lane));
        }
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const int c0 = warp * (C / kWarps) + i * 16;
        unsigned a1[4], a2[4];
        ldmatrix_x4_trans(a1, b_tile_row(y_s + kk * ld + c0, ld, lane));
        ldmatrix_x4_trans(a2, b_tile_row(g_s + kk * ld + c0, ld, lane));
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          mma_bf16(acc1[i][n], a1, bz[n][0], bz[n][1]);
          mma_bf16(acc2[i][n], a2, bh[n][0], bh[n][1]);
        }
      }
    }
    __syncthreads();   // the next row block restages y_s and g_s
  }

  float* slot = part + blockIdx.y * slot_stride;
#pragma unroll
  for (int i = 0; i < MW; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long c = warp * (C / kWarps) + i * 16 + gq + hh * 8;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const long j = j0 + n * 8 + 2 * tq;
        slot[j * C + c] = acc1[i][n][2 * hh];
        slot[(j + 1) * C + c] = acc1[i][n][2 * hh + 1];
        *reinterpret_cast<float2*>(slot + (long)H * C + c * H + j) =
            make_float2(acc2[i][n][2 * hh], acc2[i][n][2 * hh + 1]);
      }
    }
  db1red[threadIdx.x] = db1acc;
  __syncthreads();
  if (threadIdx.x < HC) {
    float v = 0.f;
    for (int k = threadIdx.x; k < kThreads; k += HC) v += db1red[k];
    slot[2L * H * C + j0 + threadIdx.x] = v;
  }
}

// out[i] = sum over the slots of part[s * stride + i], in slot order, in
// fp64 (K8a sums up to thousands of row blocks' partials: an fp32 running
// sum would lose their last bits).
__global__ void sum_slots_kernel(const float* __restrict__ part, long stride, int slots, long n,
                                 float* __restrict__ out) {
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x) {
    double v = 0.0;
    for (int s = 0; s < slots; ++s) v += part[s * stride + i];
    out[i] = (float)v;
  }
}

int finish(const float* part, long stride, int slots, float* out, cudaStream_t st) {
  sum_slots_kernel<<<1024, 256, 0, st>>>(part, stride, slots, stride, out);
  return (int)cudaGetLastError();
}

struct RowArgs {
  const void *x, *ln_w, *ln_b, *w1, *w1t, *b1, *w2t, *b2, *g, *row_scale;
  void *dx, *drs, *part;
  long stride;
  int rows, H, slots;
  float eps;
  int tanh_approx;
  cudaStream_t st;
};

template <int R, int C>
int launch_rows(const RowArgs& a) {
  using T = RowTiling<R, C>;
  auto kern = bwd_rows_kernel<R, C>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem);
  if (err != cudaSuccess) return (int)err;
  if (a.slots > (a.rows + R - 1) / R) return (int)cudaErrorInvalidValue;
  kern<<<a.slots, kThreads, T::smem, a.st>>>(
      (const bf16*)a.x, (const float*)a.ln_w, (const float*)a.ln_b, (const bf16*)a.w1,
      (const bf16*)a.w1t, (const float*)a.b1, (const bf16*)a.w2t, (const float*)a.b2,
      (const bf16*)a.g, (const float*)a.row_scale, (bf16*)a.dx, (float*)a.drs, (float*)a.part,
      a.stride, a.rows, a.H, a.eps, a.tanh_approx);
  return (int)cudaGetLastError();
}

int launch_rows_c(const RowArgs& a, int C) {
  // rows a block by width, as K2: dy's R x C fp32 accumulator is at most 128
  // registers a thread
  if (C == 128) return launch_rows<128, 128>(a);
  if (C == 256) return launch_rows<64, 256>(a);
  if (C == 512) return launch_rows<64, 512>(a);
  if (C == 1024) return launch_rows<32, 1024>(a);
  return (int)cudaErrorInvalidValue;
}

template <int R, int C, int HC>
int launch_dw(const void* x, const void* ln_w, const void* ln_b, const void* w1, const void* b1,
              const void* w2t, const void* g, const void* row_scale, void* part, long stride,
              int rows, int H, int groups, float eps, cudaStream_t st) {
  using T = DwTiling<R, C, HC>;
  auto kern = bwd_dw_kernel<R, C, HC>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::smem);
  if (err != cudaSuccess) return (int)err;
  if (H % HC || groups > (rows + R - 1) / R) return (int)cudaErrorInvalidValue;
  kern<<<dim3(H / HC, groups), kThreads, T::smem, st>>>(
      (const bf16*)x, (const float*)ln_w, (const float*)ln_b, (const bf16*)w1, (const float*)b1,
      (const bf16*)w2t, (const bf16*)g, (const float*)row_scale, (float*)part, stride, rows, H,
      eps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// K8a. part: slots x 3 C fp32 workspace; out (3 C floats): [dscale][dbias]
// [db2]. drs (rows,) fp32 is written when row_scale is given. slots <= the
// row blocks.
extern "C" int clover_mlp_bwd_rows(const void* x, const void* ln_w, const void* ln_b,
                                   const void* w1, const void* w1t, const void* b1,
                                   const void* w2t, const void* b2, const void* g,
                                   const void* row_scale, void* dx, void* drs, void* part,
                                   void* out, int rows, int C, int H, int slots, float eps,
                                   int tanh_approx, void* stream) {
  using namespace clover;
  if (rows <= 0 || H <= 0 || H % kChunk || slots <= 0 || (drs == nullptr) != (row_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const long stride = 3L * C;
  const RowArgs a{x,  ln_w, ln_b, w1,   w1t,  b1,    w2t, b2,  g,
                  row_scale, dx, drs, part, stride, rows, H, slots, eps, tanh_approx,
                  (cudaStream_t)stream};
  const int rc = launch_rows_c(a, C);
  if (rc != 0) return rc;
  return finish((const float*)part, stride, slots, (float*)out, a.st);
}

// K8b (erf GELU). part: groups x (2 H C + H) fp32; out: [dW1 (H, C)][dW2 (C, H)][db1 H].
extern "C" int clover_mlp_bwd_dw(const void* x, const void* ln_w, const void* ln_b, const void* w1,
                                 const void* b1, const void* w2t, const void* g,
                                 const void* row_scale, void* part, void* out, int rows, int C,
                                 int H, int groups, float eps, void* stream) {
  using namespace clover;
  if (rows <= 0 || H <= 0 || groups <= 0) return (int)cudaErrorInvalidValue;
  const long stride = 2L * H * C + H;
  const cudaStream_t st = (cudaStream_t)stream;
  int rc;
  // a chunk of HC = 8192 / C hidden columns keeps dW1 and dW2's C x HC
  // accumulators at 64 registers a thread
  if (C == 128) {
    rc = launch_dw<16, 128, 64>(x, ln_w, ln_b, w1, b1, w2t, g, row_scale, part, stride, rows, H, groups, eps, st);
  } else if (C == 256) {
    rc = launch_dw<32, 256, 32>(x, ln_w, ln_b, w1, b1, w2t, g, row_scale, part, stride, rows, H, groups, eps, st);
  } else if (C == 512) {
    rc = launch_dw<32, 512, 16>(x, ln_w, ln_b, w1, b1, w2t, g, row_scale, part, stride, rows, H, groups, eps, st);
  } else if (C == 1024) {
    rc = launch_dw<32, 1024, 8>(x, ln_w, ln_b, w1, b1, w2t, g, row_scale, part, stride, rows, H, groups, eps, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return finish((const float*)part, stride, groups, (float*)out, st);
}
