// The GEMM core and LayerNorm rows shared by K7's passes
// (mlp_block_bwd_passes.cu), K6's (attn_block.cu) and K2 / K3's
// (mlp_block.cu).
//
// The core: 128 x 128 block tiles, 8 warps of 64 x 32 a product (2 x 4 of
// them), a ring of 3 cp.async stages of depth BK (row strides padded by 16
// bytes, so ldmatrix reads no bank twice), ldmatrix (.trans where the
// operand is stored k-major) and mma.sync m16n8k16 bf16 -> fp32. A
// k-contiguous operand fetches BK * 2 bytes a row a stage, so products
// whose operands are both k-contiguous stage 64 deep (128-byte rows);
// k-major tiles fetch 256-byte rows at 32. Not yet: wgmma, TMA.
#pragma once

#include "common.cuh"

namespace clover {
namespace gemm {

constexpr int kThreads = 256;   // 8 warps, one product's
constexpr int kBM = 128;        // output rows of a GEMM block tile
constexpr int kBN = 128;        // output columns of a GEMM block tile
constexpr int kStages = 3;      // the cp.async ring
constexpr int kPadE = 8;        // row padding of a stage tile, elements

// A row's LN statistics, one warp, two passes over x (the mean, then the
// centred squares); lane l owns the column pairs l, l + 32, ...
__device__ __forceinline__ void row_stats(const __nv_bfloat162* xr, int C2, float eps, int lane,
                                          float& mean, float& rstd) {
  float sum = 0.f;
  for (int c = lane; c < C2; c += 32) {
    const float2 v = __bfloat1622float2(xr[c]);
    sum += v.x + v.y;
  }
  mean = warp_sum(sum) / (2 * C2);
  float sq = 0.f;
  for (int c = lane; c < C2; c += 32) {
    const float2 v = __bfloat1622float2(xr[c]);
    sq += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
  }
  rstd = rsqrtf(warp_sum(sq) / (2 * C2) + eps);
}

// The body of an LN-rows kernel of kThreads threads: y = bf16(LN(x) * ln_w
// + ln_b), one warp a row (row blockIdx.x * 8 + warp); the row's fp32 mean
// and rstd also into mean_out / rstd_out where not nullptr
__device__ __forceinline__ void ln_rows(const bf16* __restrict__ x,
                                        const float* __restrict__ ln_w,
                                        const float* __restrict__ ln_b, bf16* __restrict__ y,
                                        int rows, int C, float eps,
                                        float* __restrict__ mean_out = nullptr,
                                        float* __restrict__ rstd_out = nullptr) {
  const int lane = threadIdx.x & 31;
  const long r = (long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;
  const int C2 = C / 2;
  const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(x + r * C);
  __nv_bfloat162* yr = reinterpret_cast<__nv_bfloat162*>(y + r * C);
  float mean, rstd;
  row_stats(xr, C2, eps, lane, mean, rstd);
  if (mean_out != nullptr && lane == 0) {
    mean_out[r] = mean;
    rstd_out[r] = rstd;
  }
  for (int c = lane; c < C2; c += 32) {
    const float2 v = __bfloat1622float2(xr[c]);
    yr[c] = __floats2bfloat162_rn((v.x - mean) * rstd * ln_w[2 * c] + ln_b[2 * c],
                                  (v.y - mean) * rstd * ln_w[2 * c + 1] + ln_b[2 * c + 1]);
  }
}

// A stage tile of R rows (m or n) and BK depth: k-contiguous [R][BK] where
// the operand is stored with k fastest (kT false), else k-major [BK][R].
template <int R, bool kT, int BK>
struct StageTile {
  static constexpr int ld = kT ? R + kPadE : BK + kPadE;
  static constexpr int elems = kT ? BK * ld : R * ld;
};

// cp.async one stage tile from the row-major operand at g (stride ld, the
// tile's origin applied), depth k0 .. k0 + BK - 1. k-contiguous: rows r >=
// lim are zero; k-major: depth rows k0 + k >= lim are zero.
template <int R, bool kT, int THREADS, int BK>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g, long ld, int k0, int lim) {
  using T = StageTile<R, kT, BK>;
  static_assert(R * BK % (8 * THREADS) == 0, "whole 16-byte copies a thread");
#pragma unroll
  for (int i = 0; i < R * BK / (8 * THREADS); ++i) {
    const int q = threadIdx.x + i * THREADS;
    if constexpr (!kT) {
      const int r = q / (BK / 8), c = (q % (BK / 8)) * 8;
      const bool ok = r < lim;
      cp_async16_zfill(s + r * T::ld + c, ok ? g + r * ld + k0 + c : g, ok);
    } else {
      const int k = q / (R / 8), c = (q % (R / 8)) * 8;
      const bool ok = k0 + k < lim;
      cp_async16_zfill(s + k * T::ld + c, ok ? g + (long)(k0 + k) * ld + c : g, ok);
    }
  }
}

// A GEMM block tile: operand storage (kAT / kBT: k-major), NP products per
// tile, each on its own 8 warps (2 x 4 over the tile, warp tiles of 64 x
// 32), BK the depth of a stage.
template <bool kAT, bool kBT, int NP, int BK>
struct Gemm {
  static constexpr int THREADS = NP * kThreads;
  static constexpr int NT = 4;   // n8 tiles of a warp
  using TA = StageTile<kBM, kAT, BK>;
  using TB = StageTile<kBN, kBT, BK>;
  static constexpr int stage = NP * (TA::elems + TB::elems);
  static constexpr size_t pipe_bytes = size_t(kStages) * stage * sizeof(bf16);

  // acc += A_p B_p over depth 0 .. k_len - 1 for this warp's product p =
  // warp / 8: ga[p] at the tile's (row 0, depth 0), gb[p] at its (column 0,
  // depth 0); a_lim valid A rows (k-contiguous A), k_len valid depth rows
  // (k-major operands)
  static __device__ __forceinline__ void run(const bf16* const (&ga)[NP],
                                             const bf16* const (&gb)[NP], long lda, long ldb,
                                             int a_lim, int k_len, bf16* smem,
                                             float (&acc)[4][NT][4]) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int wm = warp % 8 / 4, wn = warp % 4, p = warp / 8;
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
    const int KT = (k_len + BK - 1) / BK;
    auto load = [&](int kt) {
      bf16* st = smem + (kt % kStages) * stage;
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        bf16* sa = st + q * (TA::elems + TB::elems);
        load_tile<kBM, kAT, THREADS, BK>(sa, ga[q], lda, kt * BK, kAT ? k_len : a_lim);
        load_tile<kBN, kBT, THREADS, BK>(sa + TA::elems, gb[q], ldb, kt * BK, kBT ? k_len : kBN);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s);
      cp_async_commit();
    }
#pragma unroll 1
    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();
      __syncthreads();   // stage kt landed for every thread; stage kt - 1 is free
      if (kt + kStages - 1 < KT) load(kt + kStages - 1);
      cp_async_commit();
      const bf16* sa = smem + (kt % kStages) * stage + p * (TA::elems + TB::elems);
      const bf16* sb = sa + TA::elems;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        unsigned af[4][4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int r0 = wm * 64 + m * 16;
          if constexpr (kAT) {
            ldmatrix_x4_trans(af[m], b_tile_row(sa + kk * TA::ld + r0, TA::ld, lane));
          } else {
            ldmatrix_x4(af[m], a_tile_row(sa + r0 * TA::ld + kk, TA::ld, lane));
          }
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int n0 = wn * 32 + np * 16;
          unsigned b[4];
          if constexpr (kBT) {
            ldmatrix_x4_trans(b, a_tile_row(sb + kk * TB::ld + n0, TB::ld, lane));
          } else {
            ldmatrix_x4(b, b_tile_row(sb + n0 * TB::ld + kk, TB::ld, lane));
          }
#pragma unroll
          for (int m = 0; m < 4; ++m) {
            mma_bf16(acc[m][2 * np], af[m], b[0], b[1]);
            mma_bf16(acc[m][2 * np + 1], af[m], b[2], b[3]);
          }
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();   // the ring may be reused by the caller's epilogue
  }
};

// a GEMM pass's grid over a (rows, cols) output: (column tiles, row tiles);
// false past the card's limits
inline bool grid(long rows, int cols, dim3& g) {
  const long row_tiles = (rows + kBM - 1) / kBM;
  if (rows <= 0 || rows > 0x7fffffffL || row_tiles > 65535) return false;
  g = dim3(cols / kBN, (unsigned)row_tiles);
  return true;
}

template <typename K>
int allow_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace gemm
}  // namespace clover
