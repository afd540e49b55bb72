// Warpgroup bf16 tensor-core product (wgmma, sm_90a) with A from registers
// and B from shared memory, shared by the probe kernels P2
// (front_end_probe.cu) and P1's Q3 (caps_probe.cu).
//
// A's registers take mma.sync m16n8k16's A layout in each warp (mma_bf16.cuh),
// warp w of the warpgroup holding tile rows 16w..16w+15. The accumulators
// repeat mma.sync's C layout for each 8 columns: with g = lane / 4 and
// q = lane % 4, d[4nt + 2h + v] = D[16w + g + 8h][8nt + 2q + v].
//
// B lies in shared memory in wgmma's canonical K-major layout without
// swizzle: 8 x 8 bf16 core matrices of 128 contiguous bytes (8 n-rows of 8
// k), k-adjacent ones `lbo` bytes apart, n-adjacent ones `sbo`. A k-step of
// 16 covers two core matrices in k, so the descriptor of k-step s is the
// first one's plus s * 2 * lbo bytes (in units of 16 bytes).
#pragma once

#include <stdint.h>

namespace cvt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the matrix descriptor of a K-major, unswizzled operand at shared address
// `addr`: LBO between k-adjacent core matrices, SBO between n-adjacent ones
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// keep the compiler from moving accesses of d across the asynchronous product
template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int v = 0; v < N; ++v) asm volatile("" : "+f"(d[v])::"memory");
}

// before the first product that reads registers written since the last one
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most `pending` of the warpgroup's committed groups run
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}

// D (64 x 160, f32) = A (64 x 16, bf16 registers) @ B (16 x 160, bf16 at
// desc) + (accumulate ? D : 0), one warpgroup
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[80], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79 "
      "}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// max that propagates NaN, as nan_max (mma_bf16.cuh), in one instruction
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

}  // namespace cvt
