// Warp-level bf16 tensor-core product and its operand loads, shared by the
// probe kernels (caps_probe.cu, front_end_probe.cu) and the mean field's
// row-block product (row_block_product.cuh: kernel B5's iteration and the
// mean-field step).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace cvt {

// D += A (16x16, row-major) @ B (16x8, column-major), bf16 inputs, f32
// accumulators: PTX mma.sync.aligned.m16n8k16. Fragments (PTX ISA, "Matrix
// fragments for mma.m16n8k16 with floating point type"), with g = lane / 4
// and q = lane % 4, each A/B register holding two consecutive-k bf16 (the
// lower k in the low half):
//   a0 = A[g][2q..2q+1]     a1 = A[g+8][2q..2q+1]
//   a2 = A[g][2q+8..2q+9]   a3 = A[g+8][2q+8..2q+9]
//   b0 = B[2q..2q+1][g]     b1 = B[2q+8..2q+9][g]
//   d[0..1] = D[g][2q..2q+1]   d[2..3] = D[g+8][2q..2q+1]
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory (PTX ldmatrix.m8n8.x4): lanes
// 8m..8m+7 give the 16-byte rows of matrix m, and r[m] holds, in lane l,
// row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix m -- the layout
// of mma_bf16_16816's A registers (matrices: rows 0-7 / 8-15 by k 0-7 /
// 8-15) and, from a [n][k] tile, of its B registers.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem_row) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem_row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// 16 bytes global -> shared without registers (cp.async, cached in L2 only);
// with ok == false the 16 bytes are zero-filled and nothing is read
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(ok ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared without registers (cp.async.ca, the 4-byte form)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most `pending` of this thread's committed groups are in flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

// two consecutive bf16 (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// max that propagates NaN, as jnp.maximum / torch.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

}  // namespace cvt
