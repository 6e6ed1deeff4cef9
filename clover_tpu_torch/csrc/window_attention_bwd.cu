// K5: backward of K1, the shifted-window attention on the flat qkv.
//
// For window b and head h, with qs = bf16(q * scale), the kernels recompute
//   logits = qs k^T + bias[h] - 100 * [id_q != id_k],  P = softmax(logits) (fp32)
// and, for the incoming gradient g of the output,
//   dp = g v^T,  dlog = P * (dp - rowsum(dp * P)),
//   dq = bf16(dlog) k * scale,  dk = bf16(dlog)^T qs,  dv = bf16(P)^T g,
//   dbias[h] = sum over the windows of dlog (fp32).
// dq, dk, dv are written in place in the flat (Bn*N, 3C) layout the qkv
// GEMM's backward reads. The shift mask gets no gradient.
//
// Replaces clover_tpu/ops/window_attention.py::_backward_flat2 and
// ::_backward_flat2_grouped (the Pallas kernels behind the custom vjp of
// flat2_window_attention), and ::_backward_flat / ::_backward_flat_grouped,
// the same function on a (Bn, N, 3C) view; the grouped form is what the
// TPU runs at N=392 (the 32-frame 8x7x7 window, 25 key tiles here). The
// math is _bwd_softmax_core's default p32 form with the true row max.
//
// Bound on the H100: 5 products of N x N x 32 per (window, head) against
// 14 * N * 32 bytes of q/k/v/g in and dq/dk/dv out, so bytes bound it
// (3.47 ms a 32-frame finetune step at 3.35 TB/s) once neither the (N, N)
// logits nor a dbias partial goes to device memory per window. The TPU
// keeps its (G, N, N) dbias block in VMEM across the window axis of its
// grid; one head's 640 KB at N=392 does not fit a block's 227 KB here, so
// the work is split in three launches from one C entry point:
//
// 1. Row pass, a block per (strip group, window, head), 8 warps, three
//    blocks an SM, a warp per 16-row query strip: the block stages k, v of
//    all keys by cp.async, each warp loads its strip's qs and g as mma
//    operands straight from device memory, sweeps the keys once in 16-key
//    steps for the row max, sum and rowsum(dp * P) (online per lane,
//    combined over the quad; the bias of the next step loaded ahead),
//    writes the row statistics (logsumexp, rowsum(dp * P)) as fp32, sweeps
//    again for dlog and multiplies it into dq in registers. No dbias.
// 2. Key pass, a block per (key group, window chunk, head) that walks the
//    chunk's windows, 16 warps, one block an SM: a warp takes one of the
//    group's two 16-key tiles and one of 8 interleaved groups of query
//    strips. The block stages qs, g of every query, k, v of its keys and
//    the row statistics by cp.async into a double buffer, the next window
//    while this one runs; each warp recomputes the transposed products,
//    P = exp(logits - logsumexp) and dlog (one exponential) and sums dv and
//    dk in registers. The strip groups' dk / dv of one key tile are summed
//    through shared memory in group order, each of the tile's 8 warps
//    summing and writing one eighth. The warp's share of dbias (its 16 keys
//    x its strips' queries, fp32, 8 registers a strip) stays in registers
//    across every window of the chunk: each element has one owner, and the
//    share is written once per chunk, in accumulator order.
// 3. Finish: dbias[h][q][k] = the chunks' shares summed in chunk order.
//
// All products are mma.sync m16n8k16, bf16 in, fp32 accumulate; a lane
// never holds more than two 8-key tiles of logits. Products per logit: 2 +
// 3 in the row pass, 4 in the key pass. Outputs are bitwise deterministic
// (no atomics). At 25 key tiles: row pass 64 KB of shared memory a block
// and 80 registers a thread (24 warps an SM), key pass 209 KB and 128
// registers (16 warps an SM). On the H100 the passes take ~22 and ~32 ms
// of a 32-frame finetune step (python3 -m clover_tpu_torch.ops.bwd_sweep):
// issue and latency of the 9 products and 3 exponentials per logit, not
// bytes, hold them back.

#include "common.cuh"

namespace clover {
namespace {

constexpr int kHd = 32;
constexpr int kLd = kHd + 8;  // row stride of the staged tiles: no ldmatrix bank conflicts
constexpr int kWarps = 8;           // a row-pass block, one query strip a warp, three an SM
constexpr int kKeyTiles = 2;        // 16-key tiles of a key-pass block
constexpr int kKeyStripGroups = 8;  // strip groups of one key tile, a warp each
constexpr int kKeyWarps = kKeyTiles * kKeyStripGroups;  // a key-pass block, one an SM

// most strips of one key-pass warp: strips s = group + i * kKeyStripGroups
template <int KT>
constexpr int kWarpStrips = (KT + kKeyStripGroups - 1) / kKeyStripGroups;

__host__ __device__ constexpr size_t tile_bytes(int rows) {  // two bf16 tiles of `rows` rows
  return align128(size_t(2) * rows * kLd * sizeof(bf16));
}

template <int KT>
__host__ __device__ constexpr size_t row_smem_bytes() {  // k, v; region ids
  return tile_bytes(KT * 16) + KT * 16 * sizeof(int);
}

// logits of one 8-key tile from its raw product: + bias + region mask
__device__ __forceinline__ void add_bias_mask(float (&l)[4], const float (&s)[4], uint2 bv,
                                              bool masked, int id0, int id1, int2 idk) {
  const float2 b0 = bf16x2_to_float2(bv.x), b1 = bf16x2_to_float2(bv.y);
  l[0] = s[0] + b0.x;
  l[1] = s[1] + b0.y;
  l[2] = s[2] + b1.x;
  l[3] = s[3] + b1.y;
  if (masked) {
    if (idk.x != id0) l[0] -= 100.f;
    if (idk.y != id0) l[1] -= 100.f;
    if (idk.x != id1) l[2] -= 100.f;
    if (idk.y != id1) l[3] -= 100.f;
  }
}

// cp.async of `rows` rows of one head (32 bf16 at src + r * ld) into dst
// (row stride kLd) by a block of `warps` warps, rows with first + r >= N
// zero-filled. scale_rows(qs) then scales the staged q in place: it walks
// the same order, so each thread touches the 16-byte pieces it copied itself
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, long ld, int rows,
                                           int first, int N, int warps) {
  for (int i = threadIdx.x; i < rows * 4; i += warps * 32) {
    const int r = i >> 2, c8 = (i & 3) * 8;
    const bool valid = first + r < N;
    cp_async16_zfill(dst + r * kLd + c8, src + (valid ? (first + r) * ld : 0) + c8, valid);
  }
}

__device__ __forceinline__ void scale_rows(bf16* qs, int rows, float scale, int warps) {
  for (int i = threadIdx.x; i < rows * 4; i += warps * 32) {
    uint4* p = reinterpret_cast<uint4*>(qs + (i >> 2) * kLd + (i & 3) * 8);
    uint4 v = *p;
    unsigned* w = reinterpret_cast<unsigned*>(&v);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = bf16x2_to_float2(w[e]);
      w[e] = pack_bf16(f.x * scale, f.y * scale);
    }
    *p = v;
  }
}

// A operand (16 rows x 32 head columns, two k16 halves) of rows r0 .. r0+15
// of one head straight from device memory (row stride ld), times `scale`,
// rows >= N zero: lane 4 g + t holds rows r0 + g, r0 + g + 8 at columns
// 16 kh + 2 t (+1) and 16 kh + 8 + 2 t (+1), the m16n8k16 A order
__device__ __forceinline__ void load_a_rows(unsigned (&a)[2][4], const bf16* src, long ld,
                                            int r0, int N, int lane, float scale) {
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + g + 8 * half;
    const unsigned* row = reinterpret_cast<const unsigned*>(src + (long)r * ld) + tq;
#pragma unroll
    for (int kh = 0; kh < 2; ++kh) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // columns 16 kh + 8 c + 2 t
        unsigned w = r < N ? __ldg(row + kh * 8 + c * 4) : 0u;
        if (scale != 1.f) {
          const float2 f = bf16x2_to_float2(w);
          w = pack_bf16(f.x * scale, f.y * scale);
        }
        a[kh][half + 2 * c] = w;
      }
    }
  }
}

// ---- 1. row pass: query strips -> row statistics, dq
template <int KT>
__global__ void __launch_bounds__(kWarps * 32, 3)
wa_bwd_row_pass(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                const bf16* __restrict__ bias_r, const int* __restrict__ ids,
                bf16* __restrict__ dqkv, float2* __restrict__ stats, int N, int nH, int nW,
                float scale) {
  constexpr int Np = KT * 16, NT = 2 * KT;  // padded keys; 8-key n-tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + Np * kLd;
  int* id_s = reinterpret_cast<int*>(smem + tile_bytes(Np));
  const int b = blockIdx.y, h = blockIdx.z;
  const int C = nH * kHd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // accumulator row / column pair of this lane
  const int strips = (N + 15) / 16;
  const int per = (strips + gridDim.x - 1) / gridDim.x;
  const int s = blockIdx.x * per + warp;  // this warp's strip
  const bool masked = ids != nullptr;
  const bf16* base = qkv + (long)b * N * 3 * C + h * kHd;

  stage_rows(ks, base + C, 3 * C, strips * 16, 0, N, kWarps);
  stage_rows(vs, base + 2 * C, 3 * C, strips * 16, 0, N, kWarps);
  cp_async_commit();
  if (masked) {
    for (int r = threadIdx.x; r < strips * 16; r += kWarps * 32) {
      id_s[r] = r < N ? ids[(long)(b % nW) * N + r] : -1;
    }
  }
  const bool active = warp < per && s < strips;
  unsigned qa[2][4], ga[2][4];  // qs = bf16(q * scale) and g of the strip, A operands
  if (active) {
    load_a_rows(qa, base, 3 * C, s * 16, N, lane, scale);
    load_a_rows(ga, grad + (long)b * N * C + h * kHd, C, s * 16, N, lane, 1.f);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (!active) return;
  const int q0 = s * 16 + g, q1 = q0 + 8;
  const int id0 = masked ? id_s[q0] : 0, id1 = masked ? id_s[q1] : 0;
  const uint2* bias_s =
      reinterpret_cast<const uint2*>(bias_r) + ((long)h * KT + s) * NT * 32 + lane;

  // logits and dp of n-tile nt (keys nt*8 .. nt*8+7) of this strip, its
  // bias bv; padded keys have bias -inf, so P = 0 there without a branch
  auto tile = [&](int nt, uint2 bv, float (&l)[4], float (&dp)[4]) {
    unsigned kb[4], vb[4];
    ldmatrix_x4(kb, ks + (nt * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
    ldmatrix_x4(vb, vs + (nt * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    dp[0] = dp[1] = dp[2] = dp[3] = 0.f;
    mma_bf16(sc, qa[0], kb[0], kb[1]);
    mma_bf16(sc, qa[1], kb[2], kb[3]);
    mma_bf16(dp, ga[0], vb[0], vb[1]);
    mma_bf16(dp, ga[1], vb[2], vb[3]);
    const int2 idk = masked ? *reinterpret_cast<const int2*>(id_s + nt * 8 + tq * 2)
                            : make_int2(0, 0);
    add_bias_mask(l, sc, bv, masked, id0, id1, idk);
  };

  // sweep 1, over 16-key steps (n-tiles 2j, 2j + 1, their bias loaded one
  // step ahead): per lane, online over its own keys: max, sum exp, sum exp*dp
  float m[2] = {-INFINITY, -INFINITY}, sum[2] = {0.f, 0.f}, dsum[2] = {0.f, 0.f};
  uint2 bn0 = bias_s[0], bn1 = bias_s[32];
  for (int j = 0; j < strips; ++j) {
    const uint2 b0 = bn0, b1 = bn1;
    if (j + 1 < strips) bn0 = bias_s[(2 * j + 2) * 32], bn1 = bias_s[(2 * j + 3) * 32];
    float l[2][4], dp[2][4];
    tile(2 * j, b0, l[0], dp[0]);
    tile(2 * j + 1, b1, l[1], dp[1]);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mt = fmaxf(fmaxf(l[0][2 * r], l[0][2 * r + 1]),
                             fmaxf(l[1][2 * r], l[1][2 * r + 1]));
      if (mt > m[r]) {
        const float f = __expf(m[r] - mt);  // 0 while m is -inf
        sum[r] *= f;
        dsum[r] *= f;
        m[r] = mt;
      }
      const float mr = m[r] == -INFINITY ? 0.f : m[r];  // no key < N yet: every term 0
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float ea = __expf(l[u][2 * r] - mr), ec = __expf(l[u][2 * r + 1] - mr);
        sum[r] += ea + ec;
        dsum[r] += ea * dp[u][2 * r] + ec * dp[u][2 * r + 1];
      }
    }
  }
  float lse[2], D[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float M = quad_max(m[r]);
    const float f = __expf(m[r] - M);  // 0 for a lane without a key < N
    const float total = quad_sum(sum[r] * f);
    lse[r] = M + logf(total);
    D[r] = quad_sum(dsum[r] * f) / total;
  }
  if (tq == 0) {  // padded rows: P = exp(-inf) = 0 in the key pass
    float2* st = stats + ((long)b * nH + h) * Np;
    st[q0] = q0 < N ? make_float2(lse[0], D[0]) : make_float2(INFINITY, 0.f);
    st[q1] = q1 < N ? make_float2(lse[1], D[1]) : make_float2(INFINITY, 0.f);
  }

  // sweep 2: dlog, dq += bf16(dlog) k over 16-key steps
  float dq[4][4];
#pragma unroll
  for (int d = 0; d < 4; ++d) dq[d][0] = dq[d][1] = dq[d][2] = dq[d][3] = 0.f;
  bn0 = bias_s[0], bn1 = bias_s[32];
  for (int j = 0; j < strips; ++j) {
    const uint2 bv[2] = {bn0, bn1};
    if (j + 1 < strips) bn0 = bias_s[(2 * j + 2) * 32], bn1 = bias_s[(2 * j + 3) * 32];
    float dl[2][4];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float l[4], dp[4];
      tile(2 * j + u, bv[u], l, dp);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        dl[u][e] = __expf(l[e] - lse[r]) * (dp[e] - D[r]);
      }
    }
    const unsigned pa[4] = {pack_bf16(dl[0][0], dl[0][1]), pack_bf16(dl[0][2], dl[0][3]),
                            pack_bf16(dl[1][0], dl[1][1]), pack_bf16(dl[1][2], dl[1][3])};
#pragma unroll
    for (int dp2 = 0; dp2 < 2; ++dp2) {  // head columns dp2*16 .. dp2*16+15
      unsigned kb[4];
      ldmatrix_x4_trans(kb, a_tile_row(ks + j * 16 * kLd + dp2 * 16, kLd, lane));
      mma_bf16(dq[2 * dp2], pa, kb[0], kb[1]);
      mma_bf16(dq[2 * dp2 + 1], pa, kb[2], kb[3]);
    }
  }
  bf16* dq_b = dqkv + (long)b * N * 3 * C + h * kHd;
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int col = d * 8 + tq * 2;
    if (q0 < N) {
      *reinterpret_cast<unsigned*>(dq_b + (long)q0 * 3 * C + col) =
          pack_bf16(dq[d][0] * scale, dq[d][1] * scale);
    }
    if (q1 < N) {
      *reinterpret_cast<unsigned*>(dq_b + (long)q1 * 3 * C + col) =
          pack_bf16(dq[d][2] * scale, dq[d][3] * scale);
    }
  }
}

// ---- 2. key pass: 16-key tiles -> dk, dv; dbias shares held across windows
// one buffer of the key pass's double buffer: one window's qs, g; k, v of
// the block's keys; the row statistics and region ids
struct KeyBuf {
  bf16 *qs, *gs, *ks, *vs;
  float2* st;
  int* id_s;
};

template <int KT>
__host__ __device__ constexpr size_t key_buf_bytes() {
  return align128(tile_bytes(KT * 16) + tile_bytes(kKeyTiles * 16) +
                  KT * 16 * (sizeof(float2) + sizeof(int)));
}

// two buffers; the dk / dv partials of kKeyWarps warps
template <int KT>
__host__ __device__ constexpr size_t key_smem_bytes() {
  return 2 * key_buf_bytes<KT>() + size_t(kKeyWarps) * 32 * 32 * sizeof(float);
}

template <int KT>
__device__ __forceinline__ KeyBuf key_buf(unsigned char* smem, int slot) {
  unsigned char* p = smem + slot * key_buf_bytes<KT>();
  KeyBuf kb;
  kb.qs = reinterpret_cast<bf16*>(p);
  kb.gs = kb.qs + KT * 16 * kLd;
  kb.ks = reinterpret_cast<bf16*>(p + tile_bytes(KT * 16));
  kb.vs = kb.ks + kKeyTiles * 16 * kLd;
  kb.st = reinterpret_cast<float2*>(p + tile_bytes(KT * 16) + tile_bytes(kKeyTiles * 16));
  kb.id_s = reinterpret_cast<int*>(kb.st + KT * 16);
  return kb;
}

template <int KT>
__global__ void __launch_bounds__(kKeyWarps * 32, 1)
wa_bwd_key_pass(const bf16* __restrict__ qkv, const bf16* __restrict__ grad,
                const bf16* __restrict__ bias_c, const int* __restrict__ ids,
                const float2* __restrict__ stats, bf16* __restrict__ dqkv,
                float4* __restrict__ part, int Bn, int N, int nH, int nW, float scale) {
  constexpr int Np = KT * 16, NT = 2 * KT, WS = kWarpStrips<KT>;
  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + 2 * key_buf_bytes<KT>());
  const int chunk = blockIdx.y, chunks = gridDim.y, h = blockIdx.z;
  const int C = nH * kHd;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wk = warp / kKeyStripGroups, group = warp % kKeyStripGroups;
  const int key0 = blockIdx.x * kKeyTiles * 16;  // the block's first key
  const int kt = blockIdx.x * kKeyTiles + wk;    // this warp's key tile
  const int strips = (N + 15) / 16;
  const bool active = kt < strips, masked = ids != nullptr;
  const int k0 = kt * 16 + g, k1 = k0 + 8;  // this lane's keys
  const uint2* bias_k =
      reinterpret_cast<const uint2*>(bias_c) + ((long)h * KT + kt) * NT * 32 + lane;

  // window b into buffer kb by cp.async (the region ids by plain loads)
  auto stage = [&](int b, const KeyBuf& kb) {
    const bf16* base = qkv + (long)b * N * 3 * C + h * kHd;
    stage_rows(kb.qs, base, 3 * C, strips * 16, 0, N, kKeyWarps);
    stage_rows(kb.gs, grad + (long)b * N * C + h * kHd, C, strips * 16, 0, N, kKeyWarps);
    stage_rows(kb.ks, base + C, 3 * C, kKeyTiles * 16, key0, N, kKeyWarps);
    stage_rows(kb.vs, base + 2 * C, 3 * C, kKeyTiles * 16, key0, N, kKeyWarps);
    const float2* st_b = stats + ((long)b * nH + h) * Np;
    for (int i = threadIdx.x; i < strips * 8; i += kKeyWarps * 32) {
      cp_async16(kb.st + 2 * i, st_b + 2 * i);
    }
    if (masked) {
      for (int r = threadIdx.x; r < strips * 16; r += kKeyWarps * 32) {
        kb.id_s[r] = r < N ? ids[(long)(b % nW) * N + r] : -1;
      }
    }
  };

  float share[WS][2][4];  // dbias of keys k0, k1 x the queries of this warp's strips
#pragma unroll
  for (int i = 0; i < WS; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) share[i][e >> 2][e & 3] = 0.f;
  }
  if (chunk < Bn) stage(chunk, key_buf<KT>(smem, 0));
  cp_async_commit();
  int slot = 0;
  for (int b = chunk; b < Bn; b += chunks, slot ^= 1) {
    const KeyBuf kb = key_buf<KT>(smem, slot);
    if (b + chunks < Bn) stage(b + chunks, key_buf<KT>(smem, slot ^ 1));
    cp_async_commit();
    cp_async_wait<1>();  // this window's group is in; the next one's stays in flight
    scale_rows(kb.qs, strips * 16, scale, kKeyWarps);
    __syncthreads();

    float dk[4][4], dv[4][4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      dk[d][0] = dk[d][1] = dk[d][2] = dk[d][3] = 0.f;
      dv[d][0] = dv[d][1] = dv[d][2] = dv[d][3] = 0.f;
    }
    if (active) {
      const bf16 *qs = kb.qs, *gs = kb.gs;
      unsigned ka[2][4], va[2][4];
      ldmatrix_x4(ka[0], a_tile_row(kb.ks + wk * 16 * kLd, kLd, lane));
      ldmatrix_x4(ka[1], a_tile_row(kb.ks + wk * 16 * kLd + 16, kLd, lane));
      ldmatrix_x4(va[0], a_tile_row(kb.vs + wk * 16 * kLd, kLd, lane));
      ldmatrix_x4(va[1], a_tile_row(kb.vs + wk * 16 * kLd + 16, kLd, lane));
      const int idk0 = masked ? kb.id_s[k0] : 0, idk1 = masked ? kb.id_s[k1] : 0;
#pragma unroll
      for (int i = 0; i < WS; ++i) {
        const int s = group + i * kKeyStripGroups;
        if (s < strips) {
          float pt[2][4], dlt[2][4];  // P^T and dlog^T: rows keys k0, k1; columns queries
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const int qt = 2 * s + u;  // queries qt*8 .. qt*8+7
            unsigned qb[4], gb[4];
            ldmatrix_x4(qb, qs + (qt * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
            ldmatrix_x4(gb, gs + (qt * 8 + (lane & 7)) * kLd + (lane >> 3) * 8);
            float sc[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(sc, ka[0], qb[0], qb[1]);
            mma_bf16(sc, ka[1], qb[2], qb[3]);
            mma_bf16(dpt, va[0], gb[0], gb[1]);
            mma_bf16(dpt, va[1], gb[2], gb[3]);
            const int q = qt * 8 + tq * 2;
            const int2 idq =
                masked ? *reinterpret_cast<const int2*>(kb.id_s + q) : make_int2(0, 0);
            float l[4];
            add_bias_mask(l, sc, bias_k[qt * 32], masked, idk0, idk1, idq);
            // (logsumexp, rowsum(dp * P)) of queries q, q + 1; padded queries
            // have bias -inf and logsumexp +inf, so P = 0 there
            const float4 sq = *reinterpret_cast<const float4*>(kb.st + q);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const bool hi = e & 1;  // column q + 1
              const float p = __expf(l[e] - (hi ? sq.z : sq.x));
              pt[u][e] = p;
              dlt[u][e] = p * (dpt[e] - (hi ? sq.w : sq.y));
              share[i][u][e] += dlt[u][e];
            }
          }
          const unsigned pa[4] = {pack_bf16(pt[0][0], pt[0][1]), pack_bf16(pt[0][2], pt[0][3]),
                                  pack_bf16(pt[1][0], pt[1][1]), pack_bf16(pt[1][2], pt[1][3])};
          const unsigned da[4] = {pack_bf16(dlt[0][0], dlt[0][1]), pack_bf16(dlt[0][2], dlt[0][3]),
                                  pack_bf16(dlt[1][0], dlt[1][1]), pack_bf16(dlt[1][2], dlt[1][3])};
#pragma unroll
          for (int dp2 = 0; dp2 < 2; ++dp2) {  // head columns dp2*16 .. dp2*16+15
            unsigned gt[4], qt4[4];
            ldmatrix_x4_trans(gt, a_tile_row(gs + s * 16 * kLd + dp2 * 16, kLd, lane));
            ldmatrix_x4_trans(qt4, a_tile_row(qs + s * 16 * kLd + dp2 * 16, kLd, lane));
            mma_bf16(dv[2 * dp2], pa, gt[0], gt[1]);
            mma_bf16(dv[2 * dp2 + 1], pa, gt[2], gt[3]);
            mma_bf16(dk[2 * dp2], da, qt4[0], qt4[1]);
            mma_bf16(dk[2 * dp2 + 1], da, qt4[2], qt4[3]);
          }
        }
      }
    }
    // dk, dv of the key tile: the strip groups' partials summed in group
    // order, warp `group` summing and writing the accumulators (dk or dv, d)
    // = (group / 4, group % 4)
    if (active) {
      float* red_w = red + warp * 32 * 32 + lane;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red_w[(d * 4 + e) * 32] = dk[d][e];
          red_w[(16 + d * 4 + e) * 32] = dv[d][e];
        }
      }
    }
    __syncthreads();  // partials in; this window's buffer is free for the window after next
    if (active) {
      const float* red_t = red + (wk * kKeyStripGroups) * 32 * 32 + group * 4 * 32 + lane;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int o = 0; o < kKeyStripGroups; ++o) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += red_t[o * 32 * 32 + e * 32];
      }
      const int col = (group & 3) * 8 + tq * 2;  // head column of accumulator d = group % 4
      bf16* out = dqkv + (long)b * N * 3 * C + (1 + (group >> 2)) * C + h * kHd + col;
      if (k0 < N) *reinterpret_cast<unsigned*>(out + (long)k0 * 3 * C) = pack_bf16(acc[0], acc[1]);
      if (k1 < N) *reinterpret_cast<unsigned*>(out + (long)k1 * 3 * C) = pack_bf16(acc[2], acc[3]);
    }
  }
  // the share, once per chunk: [chunk][h][key tile < strips][strip][n-tile][lane] x 4
  if (active) {
    float4* out = part + (((long)chunk * nH + h) * strips + kt) * KT * 2 * 32 + lane;
#pragma unroll
    for (int i = 0; i < WS; ++i) {
      const int s = group + i * kKeyStripGroups;
      if (s < strips) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          out[(s * 2 + u) * 32] = make_float4(share[i][u][0], share[i][u][1], share[i][u][2],
                                              share[i][u][3]);
        }
      }
    }
  }
}

// ---- 3. dbias[h][q][k] = sum over chunks of the key pass's shares, in chunk order
__global__ void __launch_bounds__(256)
wa_bwd_dbias_finish(const float* __restrict__ part, float* __restrict__ dbias, int N, int nH,
                    int key_tiles, int chunks) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)nH * N * N) return;
  const int k = (int)(i % N), q = (int)((i / N) % N), h = (int)(i / ((long)N * N));
  // accumulator order of P^T: rows keys (lane / 4 = k % 8, k / 8 % 2 the row half),
  // columns queries (lane % 4 = q / 2 % 4, q % 2), n-tile q / 8 % 2 of strip q / 16
  const int strips = (N + 15) / 16;
  const long frag = (((((long)h * strips + (k >> 4)) * key_tiles + (q >> 4)) * 2 +
                      ((q >> 3) & 1)) * 32 + (k & 7) * 4 + ((q >> 1) & 3)) * 4 +
                    ((k >> 3) & 1) * 2 + (q & 1);
  const long per = (long)nH * strips * 16 * key_tiles * 16;
  float acc = 0.f;
  for (int c = 0; c < chunks; ++c) acc += part[c * per + frag];
  dbias[i] = acc;
}

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int KT>
int launch_bwd(const void* qkv, const void* grad, const void* bias_r, const void* bias_c,
               const void* ids, void* dqkv, void* stats, void* part, int Bn, int N, int nH,
               int nW, int row_groups, int key_groups, int chunks, float scale,
               cudaStream_t stream) {
  constexpr size_t row_smem = row_smem_bytes<KT>(), key_smem = key_smem_bytes<KT>();
  cudaError_t err = allow_smem(wa_bwd_row_pass<KT>, row_smem);
  if (err == cudaSuccess) err = allow_smem(wa_bwd_key_pass<KT>, key_smem);
  if (err != cudaSuccess) return (int)err;
  wa_bwd_row_pass<KT><<<dim3(row_groups, Bn, nH), kWarps * 32, row_smem, stream>>>(
      (const bf16*)qkv, (const bf16*)grad, (const bf16*)bias_r, (const int*)ids, (bf16*)dqkv,
      (float2*)stats, N, nH, nW, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wa_bwd_key_pass<KT><<<dim3(key_groups, chunks, nH), kKeyWarps * 32, key_smem, stream>>>(
      (const bf16*)qkv, (const bf16*)grad, (const bf16*)bias_c, (const int*)ids,
      (const float2*)stats, (bf16*)dqkv, (float4*)part, Bn, N, nH, nW, scale);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace clover

// qkv (Bn*N, 3C), grad (Bn*N, C) bf16 -> dqkv (Bn*N, 3C) bf16, dbias (nH, N, N)
// fp32. bias_r / bias_c: the bf16 bias in accumulator order for key_tiles
// (as K1 takes it) and the same for its transpose. Workspaces, each written
// before it is read: stats, (Bn, nH, 16 key_tiles) float2 row statistics;
// part, chunks x nH x (16 strips) x (16 key_tiles) fp32 dbias shares
// (strips = ceil(N / 16)). row_groups: query-strip groups of a window, at
// most 8 strips each; key_groups: ceil(strips / 2) pairs of key tiles;
// chunks: windows b = c, c + chunks, ... walked by key-pass block c.
extern "C" int clover_window_attention_bwd(const void* qkv, const void* grad, const void* bias_r,
                                           const void* bias_c, const void* ids, void* dqkv,
                                           void* stats, void* part, void* dbias, int Bn, int N,
                                           int nH, int nW, int key_tiles, int row_groups,
                                           int key_groups, int chunks, float scale,
                                           void* stream) {
  using namespace clover;
  const int strips = (N + 15) / 16;
  if (Bn <= 0 || Bn > 65535 || N <= 0 || N > 16 * key_tiles || nH <= 0 || nH > 65535 ||
      row_groups <= 0 || row_groups > strips ||
      (strips + row_groups - 1) / row_groups > kWarps ||
      key_groups != (strips + kKeyTiles - 1) / kKeyTiles || chunks <= 0 || chunks > Bn ||
      (ids != nullptr && (nW <= 0 || Bn % nW))) {
    return (int)cudaErrorInvalidValue;
  }
  nW = ids != nullptr ? nW : 1;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
#define CLOVER_BWD_CASE(KT)                                                                   \
  case KT:                                                                                   \
    rc = launch_bwd<KT>(qkv, grad, bias_r, bias_c, ids, dqkv, stats, part, Bn, N, nH, nW,    \
                        row_groups, key_groups, chunks, scale, st);                          \
    break;
  switch (key_tiles) {
    CLOVER_BWD_CASE(4)
    CLOVER_BWD_CASE(7)
    CLOVER_BWD_CASE(13)
    CLOVER_BWD_CASE(16)
    CLOVER_BWD_CASE(19)
    CLOVER_BWD_CASE(25)
    default: return (int)cudaErrorInvalidValue;
  }
#undef CLOVER_BWD_CASE
  if (rc != 0) return rc;
  const long total = (long)nH * N * N;
  wa_bwd_dbias_finish<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      (const float*)part, (float*)dbias, N, nH, key_tiles, chunks);
  return (int)cudaGetLastError();
}
