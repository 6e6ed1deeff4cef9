// K6: the fused window-attention half-block, head dim 32.
//
//   out = x + s * (proj(window_attention(LN1(x) Wqkv^T + b_qkv)) + b_proj)
//
// over windows of N tokens, x (Bn*N, C) bf16 row-major; Wqkv (3C, C) and
// Wproj (C, C) bf16 in torch Linear layout; LN affine and biases fp32; the
// per-head bias bf16 in K1's accumulator order (-inf in the padded keys);
// for shifted blocks the region ids (nW, N) (window b uses row b % nW, keys
// of another region get -100); s the optional per-window fp32 row scale.
//
// Replaces clover_tpu/ops/attn_block.py::_forward (the Pallas kernel behind
// fused_window_attn_block) and ::_forward_grouped, the same function with
// the heads split into groups because the TPU's VMEM cannot hold all
// heads' bias at N=392; a block per (window, head) never needs the split.
//
// Bound on the H100: 2*N*(4C^2 + 2NC) flops per window against ~4*N*C
// bytes of activations, so the half-block is compute-bound on the tensor
// cores at every Swin-B stage (32-frame eval: 533 GFLOP at stage 0, 0.54
// ms at 989 TFLOP/s) as long as the qkv tensor and the logits never reach
// device memory. The TPU kernel keeps a whole window's x and fp32 proj
// accumulator on chip; at C=1024 they are 784 KB and 1.6 MB, far beyond
// 227 KB of shared memory, so the work is split in two launches:
//
// K6a, one block of 8 warps per (window, head), heads of one window in
// neighbouring blocks so the window's x is read from L2: the LN1
// statistics of the window's rows (one warp per row, the row held in
// registers), then that head's 96 columns of the qkv product in 128-row
// chunks (mma.sync m16n8k16 on ldmatrix fragments, 4 x 2 warps over the
// 128 x 96 tile, k-tiles of 64): x is normalised and rounded to bf16 as it
// is staged (double-buffered through registers, so the loads of the next
// k-tile overlap the products of this one) and the weight tile comes by
// cp.async; + b_qkv, rounded to bf16, into the head's q, k, v in shared
// memory (zero past N). Then the attention, K1's strip code
// (window_attention.cuh), writes the head's 32 columns of the attention
// output (Bn*N, C) bf16 -- the only intermediate that reaches device memory.
//
// K6b, the proj: a 128 x 128 x 32 mma.sync GEMM over the attention output
// with a 3-slot cp.async ring, b_proj, the row scale and the residual in
// its epilogue. Not yet: wgmma, TMA, the two launches in one.

#include "window_attention.cuh"

namespace clover {
namespace {

using wa::kHd;
using wa::kLd;

// ---- K6a: LN1 + qkv + attention of one (window, head)
constexpr int kWarpsA = 8;
constexpr int kThreadsA = kWarpsA * 32;
constexpr int kMc = 128;           // qkv product rows per chunk
constexpr int kKt = 64;            // k-tile (over C)
constexpr int kLdx = kKt + 8;      // staged tile row stride: no ldmatrix bank conflicts
constexpr int kQkvCols = 3 * kHd;  // the head's q | k | v columns
constexpr int kMaxRowPieces = 4;   // 16-byte pieces of a row per lane: C <= 1024

template <int KT>
struct SmemA {
  static constexpr int Np = KT * 16;
  static constexpr size_t qkv = 0;                                            // 3 x Np x kLd bf16
  static constexpr size_t ids = align128(qkv + size_t(3) * Np * kLd * sizeof(bf16));
  static constexpr size_t mean = align128(ids + Np * sizeof(int));
  static constexpr size_t rstd = align128(mean + Np * sizeof(float));
  static constexpr size_t xt = align128(rstd + Np * sizeof(float));         // 2 x kMc x kLdx
  static constexpr size_t wt = align128(xt + size_t(2) * kMc * kLdx * sizeof(bf16));
  static constexpr size_t bytes = wt + size_t(2) * kQkvCols * kLdx * sizeof(bf16);
};

template <int KT>
__global__ void __launch_bounds__(kThreadsA, 1)
attn_block_attention_kernel(const bf16* __restrict__ x, const float* __restrict__ ln_w,
                            const float* __restrict__ ln_b, const bf16* __restrict__ wqkv,
                            const float* __restrict__ bqkv, const bf16* __restrict__ bias,
                            const int* __restrict__ ids, bf16* __restrict__ attn, int N, int C,
                            int nW, float scale, float eps) {
  using S = SmemA<KT>;
  constexpr int Np = S::Np, NT = 2 * KT;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem + S::qkv);
  bf16* ks = qs + Np * kLd;
  bf16* vs = ks + Np * kLd;
  int* id_s = reinterpret_cast<int*>(smem + S::ids);
  float* mean_s = reinterpret_cast<float*>(smem + S::mean);
  float* rstd_s = reinterpret_cast<float*>(smem + S::rstd);
  bf16* xt = reinterpret_cast<bf16*>(smem + S::xt);
  bf16* wt = reinterpret_cast<bf16*>(smem + S::wt);
  const int nH = C / kHd;
  const int h = blockIdx.x % nH, b = blockIdx.x / nH;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* xw = x + (long)b * N * C;

  // LN1 statistics, one warp per row, the row in registers: fp32 mean,
  // then the mean of squared deviations (as layer_norm_plain)
  const int pieces = C / 8;
  for (int r = warp; r < N; r += kWarpsA) {
    unsigned v[kMaxRowPieces][4];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowPieces; ++i) {
      const int p = lane + 32 * i;
      const uint4 q = p < pieces ? *reinterpret_cast<const uint4*>(xw + (long)r * C + p * 8)
                                 : make_uint4(0, 0, 0, 0);
      v[i][0] = q.x, v[i][1] = q.y, v[i][2] = q.z, v[i][3] = q.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = bf16x2_to_float2(v[i][e]);
        sum += f.x + f.y;
      }
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxRowPieces; ++i) {
      if (lane + 32 * i >= pieces) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = bf16x2_to_float2(v[i][e]);
        sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + eps);
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
  const bool masked = ids != nullptr;
  if (masked) {
    for (int r = threadIdx.x; r < Np; r += kThreadsA) {
      id_s[r] = r < N ? ids[(long)(b % nW) * N + r] : -1;
    }
  }
  __syncthreads();

  // the head's qkv product, chunk by chunk: warp (wm, wn) owns rows
  // wm*32 .. +31 and columns wn*48 .. +47 of the 128 x 96 chunk
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, tq = lane & 3;
  const int n_k = C / kKt;
  // weight row j of the head's 96: q, k or v row h*32 + j % 32
  auto w_row = [&](int j) { return wqkv + ((long)(j / kHd) * C + h * kHd + j % kHd) * C; };
  auto issue_w = [&](int kt, int buf) {
    bf16* dst = wt + buf * kQkvCols * kLdx;
    for (int p = threadIdx.x; p < kQkvCols * kKt / 8; p += kThreadsA) {
      const int j = p / (kKt / 8), col = (p % (kKt / 8)) * 8;
      cp_async16(dst + j * kLdx + col, w_row(j) + kt * kKt + col);
    }
    cp_async_commit();
  };
  constexpr int kXPieces = kMc * kKt / 8 / kThreadsA;  // 16-byte x pieces per thread per tile
  auto load_x = [&](uint4 (&raw)[kXPieces], int m0, int kt) {
#pragma unroll
    for (int i = 0; i < kXPieces; ++i) {
      const int p = threadIdx.x + i * kThreadsA;
      const int r = m0 + p / (kKt / 8), col = kt * kKt + (p % (kKt / 8)) * 8;
      raw[i] = r < N ? *reinterpret_cast<const uint4*>(xw + (long)r * C + col)
                     : make_uint4(0, 0, 0, 0);
    }
  };
  // LN(x) of the staged rows, rounded to bf16 as the JAX kernel rounds xn
  auto store_x = [&](const uint4 (&raw)[kXPieces], int m0, int kt, int buf) {
    bf16* dst = xt + buf * kMc * kLdx;
#pragma unroll
    for (int i = 0; i < kXPieces; ++i) {
      const int p = threadIdx.x + i * kThreadsA;
      const int rr = p / (kKt / 8), cc = (p % (kKt / 8)) * 8, r = m0 + rr, col = kt * kKt + cc;
      unsigned w[4] = {0u, 0u, 0u, 0u};
      if (r < N) {
        const float mu = mean_s[r], rs = rstd_s[r];
        const unsigned u[4] = {raw[i].x, raw[i].y, raw[i].z, raw[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = bf16x2_to_float2(u[e]);
          const int c = col + 2 * e;
          w[e] = pack_bf16((f.x - mu) * rs * ln_w[c] + ln_b[c],
                           (f.y - mu) * rs * ln_w[c + 1] + ln_b[c + 1]);
        }
      }
      *reinterpret_cast<uint4*>(dst + rr * kLdx + cc) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  };

  for (int m0 = 0; m0 < Np; m0 += kMc) {
    float acc[2][6][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 6; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
    const bool live = m0 + wm * 32 < Np;  // this warp has rows of the padded window
    uint4 raw[kXPieces];
    issue_w(0, 0);
    load_x(raw, m0, 0);
    store_x(raw, m0, 0, 0);
    for (int kt = 0; kt < n_k; ++kt) {
      const int buf = kt & 1;
      cp_async_wait<0>();  // this thread's copies of tile kt have landed ...
      __syncthreads();     // ... everyone's, x tile kt is stored, buf ^ 1 is free
      if (kt + 1 < n_k) {
        issue_w(kt + 1, buf ^ 1);
        load_x(raw, m0, kt + 1);   // in flight during the products below
      }
      const bf16* xs = xt + buf * kMc * kLdx + wm * 32 * kLdx;
      const bf16* ws = wt + buf * kQkvCols * kLdx + wn * 48 * kLdx;
      if (live) {
#pragma unroll
        for (int kk = 0; kk < kKt; kk += 16) {
          unsigned a[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            ldmatrix_x4(a[m], a_tile_row(xs + m * 16 * kLdx + kk, kLdx, lane));
          }
#pragma unroll
          for (int np = 0; np < 3; ++np) {
            unsigned bb[4];
            ldmatrix_x4(bb, b_tile_row(ws + np * 16 * kLdx + kk, kLdx, lane));
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              mma_bf16(acc[m][2 * np], a[m], bb[0], bb[1]);
              mma_bf16(acc[m][2 * np + 1], a[m], bb[2], bb[3]);
            }
          }
        }
      }
      if (kt + 1 < n_k) store_x(raw, m0, kt + 1, buf ^ 1);
    }
    // + b_qkv, rounded to bf16, into q / k / v; rows past N are zero (the
    // padded keys' v must be finite: their probabilities are 0)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int n = 0; n < 6; ++n) {
        const int j = wn * 48 + n * 8 + tq * 2, part = j / kHd, d = j % kHd;
        bf16* dst = qs + part * Np * kLd + d;
        const float2 bb = *reinterpret_cast<const float2*>(bqkv + part * C + h * kHd + d);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int r = m0 + wm * 32 + m * 16 + g + hh * 8;
          if (r >= Np) continue;
          *reinterpret_cast<unsigned*>(dst + r * kLd) =
              r < N ? pack_bf16(acc[m][n][2 * hh] + bb.x, acc[m][n][2 * hh + 1] + bb.y) : 0u;
        }
      }
    }
    __syncthreads();  // the x / W buffers are reused by the next chunk
  }

  // the attention of this head: K1's strips, 8 warps
  const uint2* bias_h = reinterpret_cast<const uint2*>(bias) + (long)h * KT * NT * 32;
  bf16* out_b = attn + (long)b * N * C + h * kHd;
  const int strips = (N + 15) / 16;
  for (int s = warp; s < strips; s += kWarpsA) {
    wa::attend_strip<KT>(qs, ks, vs, bias_h, id_s, masked, s, lane, N, scale, out_b, C);
  }
}

// ---- K6b: out = x + s * (attn Wproj^T + b_proj)
constexpr int kWarpsB = 8;        // 2 (rows) x 4 (columns)
constexpr int kThreadsB = kWarpsB * 32;
constexpr int kBm = 128, kBn = 128, kBk = 32;
constexpr int kLdb = kBk + 8;
constexpr int kSlots = 3;         // ring of (A, B) k-tiles: two in flight
constexpr size_t kSlotElems = size_t(kBm + kBn) * kLdb;
constexpr size_t kSmemB = kSlots * kSlotElems * sizeof(bf16);

__global__ void __launch_bounds__(kThreadsB)
attn_block_proj_kernel(const bf16* __restrict__ a, const bf16* __restrict__ w,
                       const float* __restrict__ bproj, const float* __restrict__ row_scale,
                       const bf16* __restrict__ x, bf16* __restrict__ out, int M, int C, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tq = lane & 3;
  const long row0 = (long)blockIdx.x * kBm;
  const int col0 = blockIdx.y * kBn;
  const int n_k = C / kBk;

  // k-tile i -> slot i % kSlots: A rows (clamped to M - 1; those rows are
  // never stored), B rows = output columns; one commit group per call
  auto issue = [&](int i) {
    if (i < n_k) {
      bf16* as = ring + (i % kSlots) * kSlotElems;
      bf16* bs = as + kBm * kLdb;
      for (int p = threadIdx.x; p < (kBm + kBn) * kBk / 8; p += kThreadsB) {
        const int r = (p / (kBk / 8)) % kBm, col = (p % (kBk / 8)) * 8;
        if (p < kBm * kBk / 8) {
          const long gr = row0 + r < M ? row0 + r : (long)M - 1;
          cp_async16(as + r * kLdb + col, a + gr * C + i * kBk + col);
        } else {
          cp_async16(bs + r * kLdb + col, w + (long)(col0 + r) * C + i * kBk + col);
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < kSlots - 1; ++i) issue(i);

  float acc[4][4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  for (int i = 0; i < n_k; ++i) {
    cp_async_wait<kSlots - 2>();  // tile i has landed (this thread's copies) ...
    __syncthreads();              // ... everyone's, and slot (i-1) % kSlots is free
    issue(i + kSlots - 1);
    const bf16* as = ring + (i % kSlots) * kSlotElems + wm * 64 * kLdb;
    const bf16* bs = ring + (i % kSlots) * kSlotElems + (kBm + wn * 32) * kLdb;
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      unsigned af[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        ldmatrix_x4(af[m], a_tile_row(as + m * 16 * kLdb + kk, kLdb, lane));
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned bb[4];
        ldmatrix_x4(bb, b_tile_row(bs + np * 16 * kLdb + kk, kLdb, lane));
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          mma_bf16(acc[m][2 * np], af[m], bb[0], bb[1]);
          mma_bf16(acc[m][2 * np + 1], af[m], bb[2], bb[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int m = 0; m < 4; ++m) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const long gr = row0 + wm * 64 + m * 16 + g + hh * 8;
      if (gr >= M) continue;
      const float rs = row_scale != nullptr ? row_scale[gr / N] : 1.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = col0 + wn * 32 + n * 8 + tq * 2;
        const float2 xv = bf16x2_to_float2(*reinterpret_cast<const unsigned*>(x + gr * C + col));
        const float2 bb = *reinterpret_cast<const float2*>(bproj + col);
        *reinterpret_cast<unsigned*>(out + gr * C + col) =
            pack_bf16(xv.x + (acc[m][n][2 * hh] + bb.x) * rs,
                      xv.y + (acc[m][n][2 * hh + 1] + bb.y) * rs);
      }
    }
  }
}

struct Args {
  const void *x, *ln_w, *ln_b, *wqkv, *bqkv, *bias, *ids, *wproj, *bproj, *row_scale;
  void *attn, *out;
  int Bn, N, C, nW;
  float scale, eps;
  cudaStream_t stream;
};

template <int KT>
int launch_attention(const Args& a) {
  constexpr size_t smem = SmemA<KT>::bytes;
  cudaError_t err = cudaFuncSetAttribute(attn_block_attention_kernel<KT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_block_attention_kernel<KT><<<a.Bn * (a.C / kHd), kThreadsA, smem, a.stream>>>(
      (const bf16*)a.x, (const float*)a.ln_w, (const float*)a.ln_b, (const bf16*)a.wqkv,
      (const float*)a.bqkv, (const bf16*)a.bias, (const int*)a.ids, (bf16*)a.attn, a.N, a.C,
      a.nW, a.scale, a.eps);
  return (int)cudaGetLastError();
}

int launch_proj(const Args& a) {
  cudaError_t err = cudaFuncSetAttribute(attn_block_proj_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)kSmemB);
  if (err != cudaSuccess) return (int)err;
  const long M = (long)a.Bn * a.N;
  attn_block_proj_kernel<<<dim3((unsigned)((M + kBm - 1) / kBm), a.C / kBn), kThreadsB, kSmemB,
                           a.stream>>>(
      (const bf16*)a.attn, (const bf16*)a.wproj, (const float*)a.bproj,
      (const float*)a.row_scale, (const bf16*)a.x, (bf16*)a.out, (int)M, a.C, a.N);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// key_tiles: 16-key tiles the caller padded N (and laid out the bias) to;
// instances 13 (N <= 208: the 4x7x7 window) and 25 (N <= 400: 8x7x7, the
// 32-frame eval's N=392). attn (Bn*N, C) bf16 is the caller's workspace for
// the attention output; row_scale (Bn,) fp32 or nullptr.
extern "C" int clover_attn_block(const void* x, const void* ln_w, const void* ln_b,
                                 const void* wqkv, const void* bqkv, const void* bias,
                                 const void* ids, const void* wproj, const void* bproj,
                                 const void* row_scale, void* attn, void* out, int Bn, int N,
                                 int C, int nW, int key_tiles, float scale, float eps,
                                 void* stream) {
  using namespace clover;
  if (Bn <= 0 || N <= 0 || N > 16 * key_tiles || C <= 0 || C % kBn || C > 1024 ||
      (long)Bn * N > 0x7fffffffL || (ids != nullptr && (nW <= 0 || Bn % nW))) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x,    ln_w, ln_b, wqkv, bqkv, bias, ids, wproj, bproj, row_scale, attn, out,
               Bn,   N,    C,    ids != nullptr ? nW : 1,  scale, eps,  (cudaStream_t)stream};
  int rc;
  switch (key_tiles) {
    case 13: rc = launch_attention<13>(a); break;
    case 25: rc = launch_attention<25>(a); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return launch_proj(a);
}
