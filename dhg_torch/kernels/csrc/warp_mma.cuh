// Warp-level tensor-core and copy primitives shared by attention.cu and
// bottleneck.cu: 16-byte cp.async with commit groups, ldmatrix (plain and
// transposed) and mma.sync m16n8k16 bf16 -> f32, all on shared memory.
//
// Fragment conventions (PTX ISA, mma.m16n8k16 with .row.col): lane = 4 g + tg.
// A (16 x 16, row-major) a0..a3 = rows g / g+8, columns 2tg..2tg+1 / +8.
// B (16 x 8) b0, b1 = column g, rows 2tg..2tg+1 / +8.
// C (16 x 8) c0, c1 = row g, columns 2tg, 2tg+1; c2, c3 = row g + 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wmma16 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 rn(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(rn(lo)) | ((uint32_t)__bfloat16_as_ushort(rn(hi)) << 16);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8x8 b16 matrices; lane i gives the row address of matrix i / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of rows [m0, m0 + 16) x columns [k0, k0 + 16) of a row-major
// bf16 tile with row stride ld; rows at or past `rows` read row rows - 1
// (their results are discarded by the caller).
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* base, int ld, int m0, int k0,
                                       int rows) {
  const int lane = threadIdx.x & 31;
  const int r = min(m0 + (lane & 15), rows - 1);
  ldsm_x4(a, base + r * ld + k0 + ((lane >> 4) << 3));
}

// B fragments of two n8 tiles (n0 .. n0 + 15) x k [k0, k0 + 16) from an
// [n][k] row-major tile (a torch Linear weight, or K for Q K^T):
// b[0], b[1] for columns n0..n0+7, b[2], b[3] for n0+8..n0+15.
__device__ __forceinline__ void load_b_nk(uint32_t* b, const bf16* base, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4(b, base + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + k0 + (((lane >> 3) & 1) << 3));
}

// The same two n8 tiles from a [k][n] row-major tile (V for P V).
__device__ __forceinline__ void load_b_kn(uint32_t* b, const bf16* base, int ld, int n0, int k0) {
  const int lane = threadIdx.x & 31;
  ldsm_x4_t(b, base + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld + n0 + ((lane >> 4) << 3));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace wmma16
