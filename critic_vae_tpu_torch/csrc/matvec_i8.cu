// Per-frame int8 matvec of the device CRF's int8 build (kernel B4).
//
// Replaces critic_vae_tpu/crf/fused_build.py::matvec_i8 (body
// `_matvec_i8_kernel`): for each frame f of N pixels and each lane l,
//
//   out[f*N + i, l] = sum_j float(K8[f*N + i, j]) * float(y[f*N + j, l])
//
// with K8 int8 (kernel B3's output), y bf16 and the sum in f32. Widening an
// int8 to bf16 is exact, and so is every product (7 by 8 significant bits),
// so only the order of the f32 sum differs from the plain version.
//
// What bounds it on Hopper: the int8 reads, 16.8 MB a 64x64 frame per
// mean-field iteration, against 2 FMAs a byte at L = 2 — far below the
// ridge point, so HBM bandwidth.
//
// What the design does about it:
// * One warp walks kRowsPerWarp rows at once: each lane loads 16 int8 of a
//   row as one 16-byte load, so a warp reads 512 contiguous bytes of each
//   of its rows per step, and all of a block's loads of a step are issued
//   before any arithmetic.
// * The frame's y is staged through shared memory a tile of kTileJ pixels
//   at a time, converted to f32 once, and shared by the block's 32 rows.
//   Its layout pads every 16 pixels by one word, so the 32 lanes, each
//   reading pixel 16 * lane + u, hit 32 different banks.
// * Each lane keeps kRowsPerWarp x LG partial sums in registers; a fixed
//   butterfly of shuffles reduces them, so the result is deterministic.
// * LG, the lanes of one launch, is a template argument (1..8); the C entry
//   covers wider y in groups of 8 lanes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kThreads / 32 * kRowsPerWarp;
constexpr int kVec = 16;                 // int8 per 16-byte load
constexpr int kTileJ = 32 * kVec;        // pixels per staged tile of y
constexpr int kPad = kVec + 1;           // padded words per 16 pixels
constexpr int kMaxLanes = 8;

__device__ __forceinline__ float byte_at(unsigned word, int b) {
  // sign-extend byte b of a little-endian word
  return static_cast<float>(static_cast<int>(word << (24 - 8 * b)) >> 24);
}

// grid (ceil(N / kRowsPerBlock), C); N % 16 == 0
template <int LG>
__global__ void __launch_bounds__(kThreads)
matvec_i8_kernel(const signed char* __restrict__ k8, const __nv_bfloat16* __restrict__ y,
                 int n, int ldy, int l0, float* __restrict__ out) {
  __shared__ float ys[LG][kTileJ / kVec * kPad];
  const long f = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const __nv_bfloat16* yf = y + f * n * static_cast<long>(ldy) + l0;
  const signed char* kf = k8 + f * n * static_cast<long>(n);
  float acc[kRowsPerWarp][LG];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int l = 0; l < LG; ++l) acc[r][l] = 0.0f;

  for (int j0 = 0; j0 < n; j0 += kTileJ) {
    const int cols = min(kTileJ, n - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < cols * LG; e += kThreads) {
      const int jj = e / LG, l = e - jj * LG;
      ys[l][(jj / kVec) * kPad + jj % kVec] =
          __bfloat162float(yf[static_cast<long>(j0 + jj) * ldy + l]);
    }
    __syncthreads();
    const int jj = lane * kVec;
    if (jj >= cols) continue;  // N % 16 == 0: a chunk is whole or absent
    uint4 kv[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      kv[r] = row < n ? *reinterpret_cast<const uint4*>(kf + static_cast<long>(row) * n + j0 + jj)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      float yv[LG];
#pragma unroll
      for (int l = 0; l < LG; ++l) yv[l] = ys[l][lane * kPad + u];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const unsigned word = u < 4 ? kv[r].x : u < 8 ? kv[r].y : u < 12 ? kv[r].z : kv[r].w;
        const float kval = byte_at(word, u & 3);
#pragma unroll
        for (int l = 0; l < LG; ++l) acc[r][l] = fmaf(kval, yv[l], acc[r][l]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int l = 0; l < LG; ++l)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][l] += __shfl_xor_sync(0xffffffffu, acc[r][l], off);
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    float* o = out + (f * n + row) * static_cast<long>(ldy) + l0;
#pragma unroll
    for (int l = 0; l < LG; ++l) o[l] = acc[r][l];
  }
}

template <int LG>
void launch(const signed char* k8, const __nv_bfloat16* y, int frames, int n, int ldy,
            int l0, float* out, cudaStream_t s) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, frames);
  matvec_i8_kernel<LG><<<grid, kThreads, 0, s>>>(k8, y, n, ldy, l0, out);
}

}  // namespace

// k8: (C * N, N) int8, N % 16 == 0; y: (C * N, L) bf16; out: (C * N, L) f32;
// all contiguous. Returns cudaGetLastError().
extern "C" int cvt_matvec_i8(const void* k8, const void* y, int frames, int n, int lanes,
                             void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const signed char* k = static_cast<const signed char*>(k8);
  const __nv_bfloat16* yv = static_cast<const __nv_bfloat16*>(y);
  float* o = static_cast<float*>(out);
  for (int l0 = 0; frames > 0 && n > 0 && l0 < lanes; l0 += kMaxLanes) {
    switch (min(kMaxLanes, lanes - l0)) {
      case 1: launch<1>(k, yv, frames, n, lanes, l0, o, s); break;
      case 2: launch<2>(k, yv, frames, n, lanes, l0, o, s); break;
      case 3: launch<3>(k, yv, frames, n, lanes, l0, o, s); break;
      case 4: launch<4>(k, yv, frames, n, lanes, l0, o, s); break;
      case 5: launch<5>(k, yv, frames, n, lanes, l0, o, s); break;
      case 6: launch<6>(k, yv, frames, n, lanes, l0, o, s); break;
      case 7: launch<7>(k, yv, frames, n, lanes, l0, o, s); break;
      default: launch<8>(k, yv, frames, n, lanes, l0, o, s); break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
