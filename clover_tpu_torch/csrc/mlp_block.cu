// K2 and K3: the transformer MLP half-block with the 4C hidden kept on chip.
//
//   K2 (pre-LN, Swin):  out = x + s * (gelu(LN(x) W1^T + b1) W2^T + b2)
//   K3 (post-LN, BERT): out = LN(x + gelu(x W1^T + b1) W2^T + b2)
//   K3M (K3 training):  out = LN(x + m * (gelu(x W1^T + b1) W2^T + b2))
//
// K2 replaces clover_tpu/ops/mlp_block.py::_forward (_kernel, behind
// fused_ln_mlp_residual); K3 replaces ::_forward_postln (_kernel_postln,
// behind fused_mlp_postln); K3M replaces ::_forward_postln_mask
// (_kernel_postln_mask, behind fused_mlp_postln_dropout): K3 with the fp32
// {0, 1/keep} hidden-dropout mask m applied in its second pass. W1 is the
// torch Linear weight (H, C), W2 is
// (C, H), both bf16; biases and LN affine are fp32. K2's training form
// (_kernel_stash / _kernel_stash_scaled) takes the optional per-row fp32
// scale s (DropPath's keep / keep_prob; 1 when absent) and stashes what the
// backward needs instead of recomputing it: z = LN(x) W1^T + b1 as bf16
// (rows, H), written from the fp32 accumulator before GELU, and the LN
// mean and rstd as fp32 (rows,). The stash costs one bf16 write of the
// (rows, H) hidden, which the eval form never makes.
//
// Bound on the H100: the two products are 4*rows*C*H flops against
// ~4*rows*C bytes of activations, so the kernel is compute-bound on the
// tensor cores once the (rows, H) hidden is kept out of device memory --
// which is the point of the fusion: the unfused form writes and re-reads
// that hidden. The weights stream from L2 once per block of R rows, so R
// sets the flops per byte of weight traffic (R flop/B).
//
// Design: a block of 8 warps owns R rows. It puts LN(x) (or x) in shared
// memory as bf16, then walks its hidden columns in chunks of HC=128:
// GEMM1 forms gelu(A W1[chunk]^T + b1) into shared memory as bf16 and GEMM2
// multiplies it straight into the fp32 R x C accumulator, which stays in
// registers for the whole kernel. Both products are mma.sync m16n8k16 (bf16
// in, fp32 accumulate) on ldmatrix fragments, with the warps as a 2 x 4
// grid over each product's output tile, so every A and B fragment a warp
// loads feeds several mma. The weight tiles -- W1 as HC x 64 k-tiles, W2 as
// C x KT2 k-tiles, one stream across all chunks -- go through a 3-slot
// shared-memory ring filled with cp.async two tiles ahead of the tile being
// multiplied. K3's 30 row blocks (B*L = 960 rows) would leave most SMs
// idle, so the caller splits its hidden over blocks: each writes an fp32
// partial sum and a second kernel adds the partials, the residual and b2
// and takes the LayerNorm (eps 1e-12). Not yet: TMA, wgmma, warp
// specialisation.

#include "common.cuh"

namespace clover {
namespace {

constexpr int kWarps = 8;        // as a 2 (rows) x 4 (columns) grid
constexpr int kThreads = kWarps * 32;
constexpr int kHc = 128;         // hidden columns per chunk
constexpr int kKt1 = 64;         // k-tile of W1 (over C)
constexpr int kSlots = 3;        // weight-tile ring: two tiles in flight
constexpr int kPad = 8;          // bf16 row padding: ldmatrix without bank conflicts

__device__ __forceinline__ float gelu(float h, int tanh_approx) {
  if (tanh_approx) {
    return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  }
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

template <int R_, int C_>
struct Tiling {
  static constexpr int R = R_, C = C_;
  static constexpr int kt2 = C <= 512 ? 32 : 16;            // k-tile of W2 (over HC)
  static constexpr int n1 = C / kKt1, n2 = kHc / kt2;        // weight tiles per chunk
  static constexpr int lda = C + kPad, ldh = kHc + kPad, ld1 = kKt1 + kPad, ld2 = kt2 + kPad;
  static constexpr int slot = kHc * ld1 > C * ld2 ? kHc * ld1 : C * ld2;  // bf16 elements
  static constexpr int mt = R / 32;                          // m16 tiles per warp
  static constexpr int nt2 = C / 32;                         // GEMM2 n8 tiles per warp
  static constexpr size_t a = 0;
  static constexpr size_t h = align128(a + size_t(R) * lda * sizeof(bf16));
  static constexpr size_t ring = align128(h + size_t(R) * ldh * sizeof(bf16));
  static constexpr size_t smem = ring + size_t(kSlots) * slot * sizeof(bf16);
  static_assert(R % 32 == 0 && C % 64 == 0, "2 x 4 warp grid of m16 x (n8 pairs) tiles");
};

// A = LN(x) (kLN) or x; the block's hidden columns are
// [blockIdx.y * h_block, (blockIdx.y + 1) * h_block). With partial == nullptr
// it writes out = x + acc + b2, else the fp32 partial[blockIdx.y] = acc.
// The stash outputs (z, ln_mean, ln_rstd) and row_scale are optional (nullptr:
// not written / 1); they exist only with kLN and one hidden split.
template <int R, int C, bool kLN>
__global__ void __launch_bounds__(kThreads, 1)
mlp_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
           const float* __restrict__ ln_b, const bf16* __restrict__ w1,
           const float* __restrict__ b1, const bf16* __restrict__ w2,
           const float* __restrict__ b2, const float* __restrict__ row_scale,
           bf16* __restrict__ out, float* __restrict__ partial, bf16* __restrict__ z,
           float* __restrict__ ln_mean, float* __restrict__ ln_rstd, int rows, int H,
           int h_block, float eps, int tanh_approx) {
  using T = Tiling<R, C>;
  constexpr int MT = T::mt, NT2 = T::nt2, per_chunk = T::n1 + T::n2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem + T::a);
  bf16* h_s = reinterpret_cast<bf16*>(smem + T::h);
  bf16* ring = reinterpret_cast<bf16*>(smem + T::ring);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;        // warp's row half, column quarter
  const int g = lane >> 2, tq = lane & 3;         // accumulator row / column pair
  const long row0 = (long)blockIdx.x * R;
  const int h0 = blockIdx.y * h_block;
  const int n_tiles = (h_block / kHc) * per_chunk;

  // weight tile i of the stream -> ring slot i % kSlots (one commit group
  // per call, empty past the end, so the group count stays uniform)
  auto issue = [&](int i) {
    if (i < n_tiles) {
      const int j0 = h0 + (i / per_chunk) * kHc, r = i % per_chunk;
      bf16* slot = ring + (i % kSlots) * T::slot;
      if (r < T::n1) {  // W1[j0:j0+HC, r*64:(r+1)*64] as [HC][ld1]
        for (int p = threadIdx.x; p < kHc * kKt1 / 8; p += kThreads) {
          const int row = p / (kKt1 / 8), col = (p % (kKt1 / 8)) * 8;
          cp_async16(slot + row * T::ld1 + col, w1 + (long)(j0 + row) * C + r * kKt1 + col);
        }
      } else {          // W2[:, k0:k0+kt2] as [C][ld2]
        const int k0 = j0 + (r - T::n1) * T::kt2;
        for (int p = threadIdx.x; p < C * T::kt2 / 8; p += kThreads) {
          const int row = p / (T::kt2 / 8), col = (p % (T::kt2 / 8)) * 8;
          cp_async16(slot + row * T::ld2 + col, w2 + (long)row * H + k0 + col);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kSlots - 1; ++i) issue(i);

  // stage the A operand, one warp per row: LN(x) in fp32, or x as it is
  for (int r = warp; r < R; r += kWarps) {
    const long gr = row0 + r;
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(a_s + r * T::lda);
    const __nv_bfloat162* src = reinterpret_cast<const __nv_bfloat162*>(x + gr * C);
    if (gr >= rows) {
      for (int c = lane; c < C / 2; c += 32) dst[c] = __floats2bfloat162_rn(0.f, 0.f);
      continue;
    }
    if (!kLN) {
      for (int c = lane; c < C / 2; c += 32) dst[c] = src[c];
      continue;
    }
    float sum = 0.f;
    for (int c = lane; c < C / 2; c += 32) {
      const float2 v = __bfloat1622float2(src[c]);
      sum += v.x + v.y;
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int c = lane; c < C / 2; c += 32) {
      const float2 v = __bfloat1622float2(src[c]);
      sq += (v.x - mean) * (v.x - mean) + (v.y - mean) * (v.y - mean);
    }
    const float inv = rsqrtf(warp_sum(sq) / C + eps);
    if (ln_mean != nullptr && lane == 0) {
      ln_mean[gr] = mean;
      ln_rstd[gr] = inv;
    }
    for (int c = lane; c < C / 2; c += 32) {
      const float2 v = __bfloat1622float2(src[c]);
      dst[c] = __floats2bfloat162_rn((v.x - mean) * inv * ln_w[2 * c] + ln_b[2 * c],
                                     (v.y - mean) * inv * ln_w[2 * c + 1] + ln_b[2 * c + 1]);
    }
  }

  float acc[MT][NT2][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
  float hacc[MT][4][4];   // GEMM1: rows wm*R/2 + m*16, hidden columns wn*32 + n*8

  const bf16* a_w = a_s + wm * (R / 2) * T::lda;  // this warp's rows of A and of h
  const bf16* h_w = h_s + wm * (R / 2) * T::ldh;
  for (int i = 0; i < n_tiles; ++i) {
    cp_async_wait<kSlots - 2>();  // tile i has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's, and slot (i-1) % kSlots is free
    issue(i + kSlots - 1);
    const bf16* slot = ring + (i % kSlots) * T::slot;
    const int r = i % per_chunk;
    if (r < T::n1) {
      // GEMM1 over k-tile r: hacc += A[:, r*64 : r*64+64] W1 tile^T
      if (r == 0) {
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) hacc[m][n][e] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < kKt1; kk += 16) {
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(a[m], a_tile_row(a_w + m * 16 * T::lda + r * kKt1 + kk, T::lda, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          unsigned b[4];
          ldmatrix_x4(b, b_tile_row(slot + (wn * 32 + np * 16) * T::ld1 + kk, T::ld1, lane));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(hacc[m][2 * np], a[m], b[0], b[1]);
            mma_bf16(hacc[m][2 * np + 1], a[m], b[2], b[3]);
          }
        }
      }
      if (r == T::n1 - 1) {
        // chunk done: gelu(. + b1) -> h_s as bf16, read by GEMM2 after the next barrier
        const int j0 = h0 + (i / per_chunk) * kHc;
#pragma unroll
        for (int m = 0; m < MT; ++m) {
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            const int col = wn * 32 + n * 8 + tq * 2;
            const float2 bb = *reinterpret_cast<const float2*>(b1 + j0 + col);
            if (z != nullptr) {  // the pre-GELU hidden, rows g and g+8 of the m16 tile
              const long gr = row0 + wm * (R / 2) + m * 16 + g;
              if (gr < rows) {
                *reinterpret_cast<unsigned*>(z + gr * H + j0 + col) =
                    pack_bf16(hacc[m][n][0] + bb.x, hacc[m][n][1] + bb.y);
              }
              if (gr + 8 < rows) {
                *reinterpret_cast<unsigned*>(z + (gr + 8) * H + j0 + col) =
                    pack_bf16(hacc[m][n][2] + bb.x, hacc[m][n][3] + bb.y);
              }
            }
            bf16* hr = h_s + (wm * (R / 2) + m * 16 + g) * T::ldh + col;
            *reinterpret_cast<unsigned*>(hr) =
                pack_bf16(gelu(hacc[m][n][0] + bb.x, tanh_approx),
                          gelu(hacc[m][n][1] + bb.y, tanh_approx));
            *reinterpret_cast<unsigned*>(hr + 8 * T::ldh) =
                pack_bf16(gelu(hacc[m][n][2] + bb.x, tanh_approx),
                          gelu(hacc[m][n][3] + bb.y, tanh_approx));
          }
        }
      }
    } else {
      // GEMM2: acc += h[:, k0 : k0+kt2] W2 tile^T, warp columns wn*C/4 ...
      const int k0 = (r - T::n1) * T::kt2;
#pragma unroll
      for (int kk = 0; kk < T::kt2; kk += 16) {
        unsigned a[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
          ldmatrix_x4(a[m], a_tile_row(h_w + m * 16 * T::ldh + k0 + kk, T::ldh, lane));
#pragma unroll
        for (int np = 0; np < NT2 / 2; ++np) {
          unsigned b[4];
          ldmatrix_x4(b,
                      b_tile_row(slot + (wn * (C / 4) + np * 16) * T::ld2 + kk, T::ld2, lane));
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            mma_bf16(acc[m][2 * np], a[m], b[0], b[1]);
            mma_bf16(acc[m][2 * np + 1], a[m], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // epilogue straight from the accumulators: rows g and g+8 of each m16
  // tile, column pairs tq*2 of each n8 tile
#pragma unroll
  for (int m = 0; m < MT; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long gr = row0 + wm * (R / 2) + m * 16 + g + hh * 8;
      if (gr >= rows) continue;
      const float rs = row_scale != nullptr ? row_scale[gr] : 1.f;
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        const int col = wn * (C / 4) + n * 8 + tq * 2;
        const float v0 = acc[m][n][2 * hh], v1 = acc[m][n][2 * hh + 1];
        if (partial != nullptr) {
          *reinterpret_cast<float2*>(partial + ((long)blockIdx.y * rows + gr) * C + col) =
              make_float2(v0, v1);
        } else {
          const float2 xv =
              bf16x2_to_float2(*reinterpret_cast<const unsigned*>(x + gr * C + col));
          const float2 bb = *reinterpret_cast<const float2*>(b2 + col);
          *reinterpret_cast<unsigned*>(out + gr * C + col) =
              pack_bf16(xv.x + (v0 + bb.x) * rs, xv.y + (v1 + bb.y) * rs);
        }
      }
    }
  }
}

// K3's second pass: out = LN(x + b2 + sum of the splits' partials), one warp
// per row, the row's C <= 1024 values held in registers. K3M, with the fp32
// (rows, C) dropout mask m: out = LN(x + (sum of the partials + b2) * m), the
// JAX _kernel_postln_mask's order of operations.
__global__ void __launch_bounds__(256)
postln_finish_kernel(const bf16* __restrict__ x, const float* __restrict__ partial,
                     const float* __restrict__ b2, const float* __restrict__ ln_w,
                     const float* __restrict__ ln_b, const float* __restrict__ mask,
                     bf16* __restrict__ out, int rows, int C, int splits, float eps) {
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
    if (mask == nullptr) {
      v.x += bb.x;
      v.y += bb.y;
      for (int s = 0; s < splits; ++s) {
        const float2 p =
            *reinterpret_cast<const float2*>(partial + ((long)s * rows + row) * C + c);
        v.x += p.x;
        v.y += p.y;
      }
    } else {
      float2 y = *reinterpret_cast<const float2*>(partial + row * C + c);
      for (int s = 1; s < splits; ++s) {
        const float2 p =
            *reinterpret_cast<const float2*>(partial + ((long)s * rows + row) * C + c);
        y.x += p.x;
        y.y += p.y;
      }
      const float2 m = *reinterpret_cast<const float2*>(mask + row * C + c);
      v.x += (y.x + bb.x) * m.x;
      v.y += (y.y + bb.y) * m.y;
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

struct Args {
  const void *x, *ln_w, *ln_b, *w1, *b1, *w2, *b2, *row_scale;
  void *out, *z, *ln_mean, *ln_rstd;
  int rows, H;
  float eps;
  int tanh_approx;
  cudaStream_t stream;
};

template <int R, int C, bool kLN>
int launch_tiles(const Args& a, float* partial, int splits) {
  using T = Tiling<R, C>;
  cudaError_t err = cudaFuncSetAttribute(mlp_kernel<R, C, kLN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)T::smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.rows + R - 1) / R, splits);
  mlp_kernel<R, C, kLN><<<grid, kThreads, T::smem, a.stream>>>(
      (const bf16*)a.x, (const float*)a.ln_w, (const float*)a.ln_b, (const bf16*)a.w1,
      (const float*)a.b1, (const bf16*)a.w2, (const float*)a.b2, (const float*)a.row_scale,
      (bf16*)a.out, partial, (bf16*)a.z, (float*)a.ln_mean, (float*)a.ln_rstd, a.rows, a.H,
      a.H / splits, a.eps, a.tanh_approx);
  return (int)cudaGetLastError();
}

// Rows per block by width (Swin-B's stages): the R x C fp32 accumulator is
// 128 registers a thread at most (R*C <= 32768 over 256 threads).
int launch_ln_mlp(const Args& a, int C) {
  if (C == 128) return launch_tiles<128, 128, true>(a, nullptr, 1);
  if (C == 256) return launch_tiles<64, 256, true>(a, nullptr, 1);
  if (C == 512) return launch_tiles<64, 512, true>(a, nullptr, 1);
  if (C == 1024) return launch_tiles<32, 1024, true>(a, nullptr, 1);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
}  // namespace clover

// row_scale (rows,) fp32 or nullptr; z (rows, H) bf16 and ln_mean / ln_rstd
// (rows,) fp32 are written when z is not nullptr (the training form).
extern "C" int clover_ln_mlp_residual(const void* x, const void* ln_w, const void* ln_b,
                                      const void* w1, const void* b1, const void* w2,
                                      const void* b2, const void* row_scale, void* out, void* z,
                                      void* ln_mean, void* ln_rstd, int rows, int C, int H,
                                      float eps, int tanh_approx, void* stream) {
  if (rows <= 0 || H <= 0 || H % clover::kHc ||
      (z != nullptr && (ln_mean == nullptr || ln_rstd == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  return clover::launch_ln_mlp({x, ln_w, ln_b, w1, b1, w2, b2, row_scale, out, z, ln_mean,
                                ln_rstd, rows, H, eps, tanh_approx, (cudaStream_t)stream},
                               C);
}

// The hidden is split over `splits` blocks per row block; partial is their
// fp32 workspace, splits x rows x C. C is BERT-base's width, the GELU erf.
// mask (rows, C) fp32 or nullptr: K3M, the training form with the hidden
// dropout, or K3.
extern "C" int clover_mlp_postln(const void* x, const void* ln_w, const void* ln_b,
                                 const void* w1, const void* b1, const void* w2, const void* b2,
                                 void* out, const void* mask, void* partial, int rows, int C,
                                 int H, int splits, float eps, void* stream) {
  using namespace clover;
  if (rows <= 0 || C != 768 || H <= 0 || splits <= 0 || H % (splits * kHc)) {
    return (int)cudaErrorInvalidValue;
  }
  // no row scale, no stash
  const Args a{x,   ln_w, ln_b, w1, b1, w2,  b2, nullptr, out, nullptr, nullptr, nullptr,
               rows, H,    eps,  0,  (cudaStream_t)stream};
  const int rc = launch_tiles<32, 768, false>(a, (float*)partial, splits);
  if (rc != 0) return rc;
  postln_finish_kernel<<<(rows + 7) / 8, 256, 0, a.stream>>>(
      (const bf16*)x, (const float*)partial, (const float*)b2, (const float*)ln_w,
      (const float*)ln_b, (const float*)mask, (bf16*)out, rows, C, splits, eps);
  return (int)cudaGetLastError();
}
