// The row-block tensor-core product of the device CRF's mean field, shared
// by kernel B5's iteration (mean_field_resident.cu) and the mean-field step
// (mean_field_step.cu):
//
//   acc[r, l] = sum_j M[row0 + r, j] q[l, j]     r < kBM, l < 8 NT
//
// for one frame's bf16 M (N x N, row-major) and a lane-major bf16 q (lanes x
// N), with f32 sums. A block of kThreads owns kBM rows, 8 warps of 16, and
// walks all N columns in kBK-column stages: M and q stream through kStages
// cp.async stages in shared memory (16-byte chunks, XOR-swizzled so that
// ldmatrix is conflict-free), A fragments come from ldmatrix, and the sums
// stay in registers, so M is read exactly once for all 8 NT lanes and no sum
// crosses a block (deterministic). N % 8 == 0: a 16-byte chunk of a row is
// whole or absent.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace cvt {
namespace rows {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // rows a block
constexpr int kBK = 128;          // columns a stage: 256 bytes a row
constexpr int kChunks = kBK / 8;  // 16-byte chunks a row of a stage
constexpr int kStages = 2;
constexpr int kMaxTiles = 8;      // n-tiles of 8 lanes a block

__host__ __device__ constexpr int stage_elems(int nt) { return (kBM + 8 * nt) * kBK; }

// the dynamic shared memory of product<NT>
__host__ __device__ constexpr int smem_bytes(int nt) {
  return kStages * stage_elems(nt) * static_cast<int>(sizeof(__nv_bfloat16));
}

// acc[t]: rows g and g + 8 of warp w's 16 (g = lane / 4), lanes 8t + 2q and
// 8t + 2q + 1 (q = lane % 4): acc[t][2 hr + s] = row 16 w + g + 8 hr, lane
// 8t + 2q + s. mf: the frame's M; qf: its q from the block's first lane;
// lanes at or past `lanes` read as zero. smem: smem_bytes(NT), 16-byte
// aligned. Returns with every cp.async group waited for; the caller syncs
// the block before it reuses smem.
template <int NT>
__device__ __forceinline__ void product(const __nv_bfloat16* __restrict__ mf,
                                        const __nv_bfloat16* __restrict__ qf, int n, int row0,
                                        int lanes, __nv_bfloat16* smem, float (&acc)[NT][4]) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ktiles = (n + kBK - 1) / kBK;

  // stage s <- columns [kt kBK, (kt + 1) kBK) of the block's M rows and of
  // q's lanes; 16-byte chunk c of row r lands at chunk c ^ (r % 8)
  auto load = [&](int s, int kt) {
    __nv_bfloat16* sa = smem + s * stage_elems(NT);
    __nv_bfloat16* sb = sa + kBM * kBK;
    const int j0 = kt * kBK;
    for (int e = tid; e < kBM * kChunks; e += kThreads) {
      const int r = e / kChunks, ch = e % kChunks;
      const int row = row0 + r, col = j0 + ch * 8;
      const bool ok = row < n && col < n;
      cp_async16(sa + r * kBK + ((ch ^ (r & 7)) * 8),
                 ok ? mf + static_cast<long long>(row) * n + col : mf, ok);
    }
    for (int e = tid; e < 8 * NT * kChunks; e += kThreads) {
      const int l = e / kChunks, ch = e % kChunks;
      const int col = j0 + ch * 8;
      const bool ok = col < n && l < lanes;
      cp_async16(sb + l * kBK + ((ch ^ (l & 7)) * 8),
                 ok ? qf + static_cast<long long>(l) * n + col : qf, ok);
    }
  };

#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cp_async_commit();
  }
  const int ar = warp * 16 + (lane & 15);  // this lane's ldmatrix row of A
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    if (kt + kStages - 1 < ktiles) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();
    const __nv_bfloat16* sa = smem + (kt % kStages) * stage_elems(NT);
    const __nv_bfloat16* sb = sa + kBM * kBK;
#pragma unroll
    for (int kp = 0; kp < kBK / 32; ++kp) {
      // B fragments of two k-steps: matrices = 16-byte chunks 4 kp .. 4 kp + 3
      uint32_t b[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int br = t * 8 + (lane & 7);
        ldmatrix_x4(b[t], sb + br * kBK + (((4 * kp + (lane >> 3)) ^ (br & 7)) * 8));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = 2 * kp + h;
        uint32_t a[4];
        ldmatrix_x4(a, sa + ar * kBK + (((2 * ks + (lane >> 4)) ^ (ar & 7)) * 8));
#pragma unroll
        for (int t = 0; t < NT; ++t)
          mma_bf16_16816(acc[t], a[0], a[1], a[2], a[3], b[t][2 * h], b[t][2 * h + 1]);
      }
    }
  }
  cp_async_wait<0>();
}

}  // namespace rows
}  // namespace cvt
