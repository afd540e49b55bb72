// Probe P1: the fused front-end kernel's three building blocks on Hopper.
//
// Replaces examples/mosaic_caps_probe.py::main, whose Pallas kernels k1, k2
// and k3 asked whether Mosaic could express the pieces of the fused
// front-end kernel (docs/DESIGN.md, "the fused front-end kernel"). Each
// question here is the same computation at the same shapes:
//
//   Q1 (k1): nine 12-wide blocks x[:, t:t+12] written at column offsets 12t
//       of a 128-wide shared-memory tile (the im2col build), then the tile
//       stored. (128, 20) f32 -> (128, 128) f32.
//   Q2 (k2): the max over four 40-wide column groups of a (128, 160) tile
//       (the pool-phase max). (128, 160) f32 -> (128, 40) f32.
//   Q3 (k3): a loop over 4 frames whose row offset 64f is a run-time value,
//       each step a (32, 128) @ (128, 160) bf16 tensor-core product with f32
//       accumulation. (256, 128), (128, 160) bf16 -> (128, 160) f32.
//
// What bounds them on this card: launch latency. Each moves < 200 KB and Q3
// does 5.2 MFLOP; the answers are about what the hardware can express, not
// about speed.
//
// What the design does: Q1 stores each element with a 4-byte st.shared.f32,
// because the source slice x[:, t:t+12] starts at 4t bytes (not 16-byte
// aligned for t % 4 != 0), and in the real bf16 front end a 12-channel
// block is 24 bytes, not a multiple of 16, so neither 16-byte vector stores
// nor a TMA box (whose inner extent must be a multiple of 16 bytes) can
// place it; the finished tile leaves with 16-byte st.global.v4.f32 stores.
// Q2 stages the tile with 16-byte loads and takes the max in registers
// (four ld.shared.f32 at column 40p + c). Q3 uses mma.sync m16n8k16 (the
// warp-level tensor-core product): wgmma needs 64-row tiles of M, while one
// frame gives 32 rows, and the 16-row mma tiles divide that evenly.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kRowsPerBlock = 32;
constexpr int kThreads = 256;

// ---- Q1 ----------------------------------------------------------------
constexpr int kQ1In = 20, kQ1Out = 128, kTaps = 9, kTapW = 12;

__global__ void __launch_bounds__(kThreads)
q1_lane_offset_write(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(16) float tile[kRowsPerBlock * kQ1Out];
  const int r0 = blockIdx.x * kRowsPerBlock;
  for (int e = threadIdx.x; e < kRowsPerBlock * kQ1Out; e += kThreads) tile[e] = 0.0f;
  __syncthreads();
  for (int e = threadIdx.x; e < kRowsPerBlock * kTaps * kTapW; e += kThreads) {
    const int r = e / (kTaps * kTapW), c = e % (kTaps * kTapW);
    const int t = c / kTapW, j = c % kTapW;
    tile[r * kQ1Out + kTapW * t + j] = x[(r0 + r) * kQ1In + t + j];
  }
  __syncthreads();
  const float4* src = reinterpret_cast<const float4*>(tile);
  float4* dst = reinterpret_cast<float4*>(out + r0 * kQ1Out);
  for (int e = threadIdx.x; e < kRowsPerBlock * kQ1Out / 4; e += kThreads) dst[e] = src[e];
}

// ---- Q2 ----------------------------------------------------------------
constexpr int kQ2In = 160, kQ2Out = 40;

__global__ void __launch_bounds__(kThreads)
q2_phase_max(const float* __restrict__ x, float* __restrict__ out) {
  __shared__ __align__(16) float tile[kRowsPerBlock * kQ2In];
  const int r0 = blockIdx.x * kRowsPerBlock;
  const float4* src = reinterpret_cast<const float4*>(x + r0 * kQ2In);
  float4* dst = reinterpret_cast<float4*>(tile);
  for (int e = threadIdx.x; e < kRowsPerBlock * kQ2In / 4; e += kThreads) dst[e] = src[e];
  __syncthreads();
  for (int e = threadIdx.x; e < kRowsPerBlock * kQ2Out; e += kThreads) {
    const int r = e / kQ2Out, c = e % kQ2Out;
    const float* row = tile + r * kQ2In + c;
    float m = row[0];
#pragma unroll
    for (int p = 1; p < 4; ++p) m = cvt::nan_max(m, row[kQ2Out * p]);
    out[(r0 + r) * kQ2Out + c] = m;
  }
}

// ---- Q3 ----------------------------------------------------------------
constexpr int kQ3K = 128, kQ3N = 160, kQ3Frames = 4, kQ3FrameStride = 64, kQ3FrameRows = 32;
constexpr int kWStride = kQ3K + 8;  // bf16 per row of w^T: 68 words, so the
                                    // 8 n-rows of a fragment hit 8 bank groups
constexpr int kNTiles = kQ3N / 8;

__global__ void __launch_bounds__(64)
q3_loop_dyn_dot(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                float* __restrict__ out) {
  __shared__ __align__(16) __nv_bfloat16 wt[kQ3N * kWStride];  // w transposed: [n][k]
  for (int e = threadIdx.x; e < kQ3K * kQ3N; e += blockDim.x) {
    const int k = e / kQ3N, n = e % kQ3N;
    wt[n * kWStride + k] = w[e];
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int f = 0; f < kQ3Frames; ++f) {  // a run-time loop: the row offset is dynamic
    const int row0 = kQ3FrameStride * f + 16 * warp;  // this warp's 16 rows of x
    float acc[kNTiles][4] = {};
#pragma unroll
    for (int kk = 0; kk < kQ3K / 16; ++kk) {
      const int k0 = 16 * kk + 2 * q;
      const __nv_bfloat16* xa = x + (row0 + g) * kQ3K + k0;
      const uint32_t a0 = cvt::ld_bf16x2(xa), a1 = cvt::ld_bf16x2(xa + 8 * kQ3K);
      const uint32_t a2 = cvt::ld_bf16x2(xa + 8), a3 = cvt::ld_bf16x2(xa + 8 * kQ3K + 8);
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
        const __nv_bfloat16* wb = wt + (8 * nt + g) * kWStride + k0;
        cvt::mma_bf16_16816(acc[nt], a0, a1, a2, a3, cvt::ld_bf16x2(wb),
                            cvt::ld_bf16x2(wb + 8));
      }
    }
    float* o = out + (kQ3FrameRows * f + 16 * warp + g) * kQ3N + 2 * q;
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
      *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o + 8 * kQ3N + 8 * nt) = make_float2(acc[nt][2], acc[nt][3]);
    }
  }
}

}  // namespace

// x: (128, 20) f32; out: (128, 128) f32. Returns cudaGetLastError().
extern "C" int cvt_caps_q1(const void* x, void* out, void* stream) {
  q1_lane_offset_write<<<128 / kRowsPerBlock, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x: (128, 160) f32; out: (128, 40) f32. Returns cudaGetLastError().
extern "C" int cvt_caps_q2(const void* x, void* out, void* stream) {
  q2_phase_max<<<128 / kRowsPerBlock, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x: (256, 128) bf16; w: (128, 160) bf16; out: (128, 160) f32. Returns
// cudaGetLastError().
extern "C" int cvt_caps_q3(const void* x, const void* w, void* out, void* stream) {
  q3_loop_dyn_dot<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
