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
//   Q3 (k3): a run-time loop over 4 frames at row offsets 64f, each frame a
//       (32, 128) @ (128, 160) bf16 tensor-core product with f32
//       accumulation. (256, 128), (128, 160) bf16 -> (128, 160) f32.
//
// What bounds them on this card: launch latency. Each moves < 200 KB and Q3
// does 5.2 MFLOP; the answers are about what the hardware can express, not
// about speed. cvt_caps_empty launches a kernel that does nothing, the
// yardstick of their device times.
//
// What the design does: Q1 stores each element with a 4-byte st.shared.f32,
// because the source slice x[:, t:t+12] starts at 4t bytes (not 16-byte
// aligned for t % 4 != 0), and in the real bf16 front end a 12-channel
// block is 24 bytes, not a multiple of 16, so neither 16-byte vector stores
// nor a TMA box (whose inner extent must be a multiple of 16 bytes) can
// place it; the finished tile leaves with 16-byte st.global.v4.f32 stores.
// Q2 stages the tile with 16-byte loads and takes the max in registers
// (four ld.shared.f32 at column 40p + c). Q3 asks its question with the
// instruction the fused front end (front_end_probe.cu) depends on: wgmma
// m64n160k16 (wgmma_bf16.cuh), one warpgroup. wgmma's M tile is 64 rows and
// a frame gives 32, so each step of the run-time loop takes a frame pair's
// 2 x 32 rows as one tile, A in registers read straight from x, and w
// resident in shared memory in the canonical K-major core-matrix layout
// (LBO 128, SBO 2,048 bytes), 8 k-steps of 16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "wgmma_bf16.cuh"

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
constexpr int kQ3KSteps = kQ3K / 16;
constexpr int kCore = 128;                  // bytes of an 8 x 8 bf16 core matrix
constexpr int kQ3Sbo = (kQ3K / 8) * kCore;  // 2,048: the next 8 n
constexpr int kQ3WBytes = kQ3K * kQ3N * 2;  // 40,960

__global__ void __launch_bounds__(128)
q3_loop_dyn_dot(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                float* __restrict__ out) {
  __shared__ __align__(128) unsigned char wsm[kQ3WBytes];  // w in core matrices
  // thread k stages row k of w: 20 16-byte pieces of 8 n, all loads in
  // flight before the first store. With k across the lanes, a warp's 2-byte
  // stores meet 4 words a bank (k / 8), not 20 (lanes sharing a k)
  constexpr int kPieces = kQ3N / 8;
  const int k = threadIdx.x;
  uint4 piece[kPieces];
#pragma unroll
  for (int i = 0; i < kPieces; ++i)
    piece[i] = __ldg(reinterpret_cast<const uint4*>(w + k * kQ3N) + i);
  unsigned char* col = wsm + (k / 8) * kCore + (k % 8) * 2;
#pragma unroll
  for (int i = 0; i < kPieces; ++i) {
    const uint32_t v[4] = {piece[i].x, piece[i].y, piece[i].z, piece[i].w};
#pragma unroll
    for (int j = 0; j < 8; ++j)  // n = 8i + j: row j of core matrix (i, k / 8)
      *reinterpret_cast<uint16_t*>(col + i * kQ3Sbo + 16 * j) =
          static_cast<uint16_t>(v[j / 2] >> (16 * (j % 2)));
  }
  // w was written by plain stores and is read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const uint64_t desc0 = cvt::kmajor_desc(cvt::smem_u32(wsm), kCore, kQ3Sbo);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  float d[80] = {};
#pragma unroll 1
  for (int pair = 0; pair < kQ3Frames / 2; ++pair) {  // a run-time loop: dynamic row offsets
    // warp w holds tile rows 16w..16w+15: frame 2 pair + w / 2, its rows
    // 16 (w % 2) + g and + g + 8
    const int frame = 2 * pair + warp / 2, row = 16 * (warp % 2) + g;
    const __nv_bfloat16* xa = x + (kQ3FrameStride * frame + row) * kQ3K + 2 * q;
    uint32_t a[kQ3KSteps][4];
#pragma unroll
    for (int s = 0; s < kQ3KSteps; ++s) {
      a[s][0] = cvt::ld_bf16x2(xa + 16 * s);
      a[s][1] = cvt::ld_bf16x2(xa + 16 * s + 8 * kQ3K);
      a[s][2] = cvt::ld_bf16x2(xa + 16 * s + 8);
      a[s][3] = cvt::ld_bf16x2(xa + 16 * s + 8 * kQ3K + 8);
    }
    cvt::fence_operands(d);
    cvt::wgmma_fence();
#pragma unroll
    for (int s = 0; s < kQ3KSteps; ++s)  // k-step s: 2 core matrices, 256 bytes on
      cvt::wgmma_m64n160k16(d, a[s], desc0 + static_cast<uint64_t>(s * 2 * kCore >> 4), s);
    cvt::wgmma_commit();
    cvt::wgmma_wait<0>();
    cvt::fence_operands(d);
    float* o = out + (kQ3FrameRows * frame + row) * kQ3N + 2 * q;
#pragma unroll
    for (int nt = 0; nt < kQ3N / 8; ++nt) {
      *reinterpret_cast<float2*>(o + 8 * nt) = make_float2(d[4 * nt], d[4 * nt + 1]);
      *reinterpret_cast<float2*>(o + 8 * kQ3N + 8 * nt) =
          make_float2(d[4 * nt + 2], d[4 * nt + 3]);
    }
  }
}

// the launch yardstick: a kernel that does nothing
__global__ void empty_kernel() {}

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
  q3_loop_dyn_dot<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing. Returns cudaGetLastError().
extern "C" int cvt_caps_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
