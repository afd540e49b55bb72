// Probe P2: the copy floor of the fused front-end kernel on Hopper.
//
// Replaces examples/mosaic_copy_floor_probe.py::main (its Pallas `kernel`).
// The fused front end computes the merged 3->40-channel first conv in its
// four pool phases as one space-to-depth (s2d) 3x3 conv, keeps the phase
// max and the ReLU in the epilogue, and stores only the pooled map. Per
// frame the s2d input is (34, 34, 12) bf16 (x rows 1156f + 34y + z), the
// weights w (128, 160) bf16 are s2d_pool_weights of the merged kernel as
// (108, 160) rows (u, v, (p, q, c)) zero-padded to K = 128, and the output
// is (1024, 40) bf16 rows 32i + j. For output row i of a block of F frames:
//
//   copies (variant copies_and_dot only): for each frame f and tap (r, t),
//     the 32 x rows 1156f + 34(i+r) + t + j (j < 32) to scratch rows 32f + j,
//     columns 36r + 12t .. +12 (the im2col build);
//   product: scratch (32F, 128) @ w (128, 160), bf16 on the tensor cores,
//     f32 accumulators;
//   epilogue: the max over the four 40-column phase groups, ReLU, bf16,
//     stored at rows 1024f + 32i + j.
//
// dot_only skips the copies and keeps the zeroed scratch, as the TPU probe
// does; the difference of the two is the copy floor.
//
// What bounds it on this card: the product, 2 x (1024 B) x 128 x 160 flops
// (43 GFLOP at B = 1024), ~0.043 ms at the dense bf16 peak, against ~112 MB
// of input and output (~0.034 ms at 3.35 TB/s).
//
// What the design does: one block of 8 warps holds w transposed (n-major,
// rows padded to 136 bf16 so a fragment's 8 n-rows fall in distinct banks)
// and the (32F, 136) scratch in shared memory, and walks the 32 output rows
// in order. A 12-channel s2d block is 24 bytes: 8-byte aligned but not a
// multiple of 16, so the copies move 8-byte words (three a row, coalesced
// over a run of 32 rows) and TMA boxes cannot do it. The product is
// mma.sync m16n8k16, a warp per 16-row tile: wgmma wants 64-row M tiles,
// and a frame gives 32 rows. The four phases of one output column c lie in
// n-tiles c/8 + 5p at the same fragment position (40 = 5 x 8), so the phase
// max and ReLU run in each thread's registers and never touch shared memory.
// A simple kernel first: no TMA, no wgmma, no pipelining of the copies with
// the product, one output row of F frames per step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kS2dSide = 34, kS2dRows = kS2dSide * kS2dSide, kS2dC = 12;
constexpr int kOutSide = 32, kOutRows = kOutSide * kOutSide;
constexpr int kK = 128, kN = 160, kPhaseC = 40;
constexpr int kStride = kK + 8;  // bf16 per shared row (68 words)
constexpr int kNTiles = kN / 8;
constexpr int kPhaseTiles = kPhaseC / 8;

template <bool kCopies>
__global__ void __launch_bounds__(kThreads)
front_end_probe_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       int frames_per_block, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* wt = reinterpret_cast<__nv_bfloat16*>(smem);  // [kN][kStride]
  __nv_bfloat16* a = wt + kN * kStride;                        // [32F][kStride]
  const int nf = frames_per_block;
  const int m_tiles = 2 * nf;  // 16-row tiles of the (32F, 128) scratch

  for (int e = threadIdx.x; e < kK * kN; e += kThreads) {
    const int k = e / kN, n = e % kN;
    wt[n * kStride + k] = w[e];
  }
  uint32_t* a_words = reinterpret_cast<uint32_t*>(a);
  for (int e = threadIdx.x; e < kOutSide * nf * kStride / 2; e += kThreads) a_words[e] = 0u;
  __syncthreads();

  const long frame0 = static_cast<long>(blockIdx.x) * nf;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;

#pragma unroll 1
  for (int i = 0; i < kOutSide; ++i) {
    if (kCopies) {
      // one item: 8 bytes (4 channels) of one x row into one scratch row
      for (int e = threadIdx.x; e < nf * 9 * kOutSide * 3; e += kThreads) {
        const int part = e % 3;
        int rest = e / 3;
        const int j = rest % kOutSide;
        rest /= kOutSide;
        const int tap = rest % 9, f = rest / 9;
        const int r = tap / 3, t = tap % 3;
        const __nv_bfloat16* src =
            x + ((frame0 + f) * kS2dRows + kS2dSide * (i + r) + t + j) * kS2dC + 4 * part;
        __nv_bfloat16* dst = a + (kOutSide * f + j) * kStride + 36 * r + 12 * t + 4 * part;
        *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(src);
      }
      __syncthreads();
    }
#pragma unroll 1
    for (int mt = warp; mt < m_tiles; mt += kWarps) {
      float acc[kNTiles][4] = {};
#pragma unroll
      for (int kk = 0; kk < kK / 16; ++kk) {
        const __nv_bfloat16* aa = a + (16 * mt + g) * kStride + 16 * kk + 2 * q;
        const uint32_t a0 = cvt::ld_bf16x2(aa), a1 = cvt::ld_bf16x2(aa + 8 * kStride);
        const uint32_t a2 = cvt::ld_bf16x2(aa + 8), a3 = cvt::ld_bf16x2(aa + 8 * kStride + 8);
#pragma unroll
        for (int nt = 0; nt < kNTiles; ++nt) {
          const __nv_bfloat16* wb = wt + (8 * nt + g) * kStride + 16 * kk + 2 * q;
          cvt::mma_bf16_16816(acc[nt], a0, a1, a2, a3, cvt::ld_bf16x2(wb),
                              cvt::ld_bf16x2(wb + 8));
        }
      }
      // rows 16mt + g and 16mt + g + 8 of the scratch: frame f, column j
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int m = 16 * mt + g + 8 * half;
        const int f = m / kOutSide, j = m % kOutSide;
        __nv_bfloat16* o = out + ((frame0 + f) * kOutRows + kOutSide * i + j) * kPhaseC + 2 * q;
#pragma unroll
        for (int ct = 0; ct < kPhaseTiles; ++ct) {
          float v0 = acc[ct][2 * half], v1 = acc[ct][2 * half + 1];
#pragma unroll
          for (int p = 1; p < 4; ++p) {
            v0 = cvt::nan_max(v0, acc[ct + kPhaseTiles * p][2 * half]);
            v1 = cvt::nan_max(v1, acc[ct + kPhaseTiles * p][2 * half + 1]);
          }
          *reinterpret_cast<__nv_bfloat162*>(o + 8 * ct) =
              __floats2bfloat162_rn(cvt::nan_max(v0, 0.0f), cvt::nan_max(v1, 0.0f));
        }
      }
    }
    __syncthreads();  // the next row's copies overwrite the scratch
  }
}

}  // namespace

// x: (frames * 1156, 12) bf16; w: (128, 160) bf16; out: (frames * 1024, 40)
// bf16; frames a multiple of frames_per_block. Returns the first CUDA error.
extern "C" int cvt_front_end_probe(const void* x, const void* w, int frames,
                                   int frames_per_block, int copies, void* out, void* stream) {
  if (frames <= 0) return 0;
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, int, __nv_bfloat16*) =
      copies ? front_end_probe_kernel<true> : front_end_probe_kernel<false>;
  // w^T plus the (32F, 128) scratch, rows padded
  const int smem = (kN + kOutSide * frames_per_block) * kStride *
                   static_cast<int>(sizeof(__nv_bfloat16));
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<frames / frames_per_block, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      frames_per_block, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
