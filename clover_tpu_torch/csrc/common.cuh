// Shared helpers for the port's Hopper kernels (sm_90a, bf16 in / bf16 out,
// fp32 statistics and accumulation). Each kernel file exposes plain C entry
// points that return cudaGetLastError() right after the launch, so the
// Python wrapper (clover_tpu_torch/ops/_build.py) can raise on a refused
// launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace clover {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// reductions over the four lanes of an mma accumulator row (lanes 4g .. 4g+3)
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// mma.sync / ldmatrix building blocks (bf16 operands, fp32 accumulators)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b, m16n8k16, bf16 operands, fp32 accumulator
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 bf16x2_to_float2(unsigned v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// 16-byte global -> shared copies that bypass the registers, in commit
// groups; cp_async_wait<N> waits until at most N of this thread's groups
// are still in flight
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}
// the same, zero-filling the 16 bytes instead where !valid (src is not read)
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}
// 4 bytes (through L1: .cg takes only 16), zero where !valid
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ldmatrix.x4 source address of this lane for a row-major 16 x 16 tile at p
// (row stride ld): lane i addresses row i % 8 of 8x8 matrix i / 8, matrices
// in the order the m16n8k16 A operand takes them (rows 0-7 | 8-15 of k 0-7,
// then of k 8-15)
__device__ __forceinline__ const bf16* a_tile_row(const bf16* p, int ld, int lane) {
  return p + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

// the same for a B operand stored n-major ([n][k], k contiguous): two 8-wide
// n-tiles of k16, registers {0, 1} for n-tile 0 and {2, 3} for n-tile 1
__device__ __forceinline__ const bf16* b_tile_row(const bf16* p, int ld, int lane) {
  return p + ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

// Byte offset rounded up so every shared-memory region starts 128-byte
// aligned (ldmatrix and cp.async take 16-byte aligned addresses).
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

}  // namespace clover
