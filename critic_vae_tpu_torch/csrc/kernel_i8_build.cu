// Quantized bilateral kernel of the device CRF's int8 build (kernel B3).
//
// Replaces critic_vae_tpu/crf/fused_build.py::build_kernel_i8 (body
// `_build_i8_kernel`). Per frame of N pixels, in one sweep:
//
//   k[i,j]    = exp(-1/2 |dxy/alpha|^2 - 1/2 |drgb/beta|^2)   for i != j, 0 on i == j
//   K8[i,j]   = round_half_even(127 * k[i,j])                  stored int8
//   rowsum[i] = sum_j K8[i,j]                                  stored f32
//
// k is exactly kernel B2's: the symmetric-tile build's k_bilateral
// (bilateral_tile.cuh), per-coordinate differences of feature planes made
// by IEEE division, exp(-1/2 (|dxy|^2 + |drgb|^2)), the diagonal masked.
//
// What bounds it on Hopper: the N^2 int8 store, 1 byte an entry (16.8 MB a
// 64x64 frame: 0.32 ms for 64 frames at 3.35 TB/s), and one exp with ~15
// f32 operations for each of the N(N-1)/2 distinct entries. Unlike B2 there
// is no second pass: the normalizers come from the quantized values, so
// the caller normalizes from the row sums of the stored bytes.
//
// What the design does about it: one pass of the symmetric-tile build.
// 0. tile_feats_kernel (the header's): per-pixel planes once a frame,
//    padded pixels at x = 1e30, so no entry needs a bounds check.
// 1. i8_tile_kernel: a block takes row tile I and its strip of column tiles
//    J >= I (strip_of), the next tile's planes prefetched by cp.async
//    (load_tile). Each distinct entry takes one exp (k_bilateral, the
//    diagonal's mask only in diagonal tiles, by_diagonal) and is quantized
//    once (__float2int_rn: half to even, as jnp.round). K8[I, J] goes out
//    with 16-byte stores: 16 int8 of a row a thread, 4 threads a 64-wide
//    row, 32 rows a pass of 128 threads, so 2 rows and 32 entries a thread;
//    for I != J, K8[J, I] through a transposed staging tile in shared
//    memory, with the same 16-byte stores.
// Row sums, in the same pass: the rows of I add their integer partials in
//    registers over the whole strip; the rows of J (I != J) take theirs from
//    the staging tile as it is read for the transposed store (K8 is
//    symmetric, so a row of K8[J, I] is a column of K8[I, J]). Each partial
//    goes into the f32 rowsum with one atomicAdd a row and block (rows of I)
//    or tile pair (rows of J). Every partial and total is an integer below
//    127 N < 2^24, which f32 holds exactly, so the sums are exact in any
//    order: bitwise reproducible, and equal to the sums of the stored bytes.
//    Chosen over the header's fixed slots because it needs no (C, N/64, N)
//    scratch and no second kernel, at the same exactness.
// Built without fast math: __expf would move entries across a rounding
// boundary of the 127 scale.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral_tile.cuh"

namespace cvt {
namespace {  // the header's unnamed namespace: its pieces unqualified

constexpr int kI8Threads = 128;
constexpr int kI8Blocks = 6;                // blocks an SM the registers allow
constexpr int kVec = 16;                    // int8 of one 16-byte store
constexpr int kGroups = kTile / kVec;       // 4 threads a 64-wide row
constexpr int kRpp = kI8Threads / kGroups;  // 32 rows a pass
constexpr int kReps = kTile / kRpp;         // 2 rows a thread
constexpr int kPlanes = kBil + 1;           // PlainEntry's planes; B3 leaves nb unused
constexpr float kQuantScale = 127.0f;

__device__ __forceinline__ void store16(signed char* p, const int (&q)[kVec]) {
  uint32_t w[4];
#pragma unroll
  for (int v = 0; v < 4; ++v)  // 0 <= q <= 127: the bytes need no masking
    w[v] = static_cast<uint32_t>(q[4 * v]) | (static_cast<uint32_t>(q[4 * v + 1]) << 8) |
           (static_cast<uint32_t>(q[4 * v + 2]) << 16) |
           (static_cast<uint32_t>(q[4 * v + 3]) << 24);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// the sum over the 4 threads of a row (lanes differing in bits 0-1)
__device__ __forceinline__ int row_group_sum(int s) {
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  return s + __shfl_xor_sync(0xffffffffu, s, 2);
}

// grid (row tiles x strips, C): K8[I, J] and K8[J, I] of the block's tile
// pairs and their row partials; n % 16 == 0, rowsum zeroed
__global__ void __launch_bounds__(kI8Threads, kI8Blocks)
i8_tile_kernel(const float* __restrict__ feat, int n, signed char* __restrict__ k8,
               float* __restrict__ rowsum) {
  __shared__ __align__(16) float si[kBil][kTile];
  __shared__ __align__(16) float sj[2][kBil][kTile];
  __shared__ int stage[kTile][kTile + 1];  // stage[j - J0][i - I0], padded
  const int nt = num_tiles(n), npad = nt * kTile;
  int ti, tj0, tj1;
  if (!strip_of(blockIdx.x, nt, ti, tj0, tj1)) return;
  const long long f = blockIdx.y;
  const float* fp = feat + f * kPlanes * npad;
  const int tid = threadIdx.x, g = tid % kGroups, rr = tid / kGroups, jl = g * kVec;
  const int i0 = ti * kTile;
  const long long step = static_cast<long long>(kRpp) * n;       // between a thread's rows
  signed char* const orow = k8 + (f * n + i0 + rr) * n + jl;      // + j0: K8[i0 + rr, j0 + jl]
  signed char* const ocol = k8 + (f * n + rr) * n + i0 + jl;      // + j0 n: K8[j0 + rr, i0 + jl]
  float* const rs = rowsum + f * n;
  load_tile(fp, kBil, npad, ti, &si[0][0]);
  load_tile(fp, kBil, npad, tj0, &sj[0][0][0]);
  float fi[kReps][kBil];
  int row[kReps];  // the thread's row partials over the strip
#pragma unroll
  for (int k = 0; k < kReps; ++k) row[k] = 0;
  for (int tj = tj0, buf = 0; tj < tj1; ++tj, buf ^= 1) {
    if (tj + 1 < tj1) {
      load_tile(fp, kBil, npad, tj + 1, &sj[buf ^ 1][0][0]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tj == tj0)
#pragma unroll
      for (int k = 0; k < kReps; ++k)
#pragma unroll
        for (int c = 0; c < kBil; ++c) fi[k][c] = si[c][rr + kRpp * k];
    const int j0 = tj * kTile;
    int q[kReps][kVec];
    by_diagonal(tj == ti, [&](auto diag) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        float fj[kBil];
#pragma unroll
        for (int c = 0; c < kBil; ++c) fj[c] = sj[buf][c][jl + u];
#pragma unroll
        for (int k = 0; k < kReps; ++k)
          q[k][u] = __float2int_rn(kQuantScale * k_bilateral<decltype(diag)::value>(fi[k], fj));
      }
    });
#pragma unroll
    for (int k = 0; k < kReps; ++k) {
#pragma unroll
      for (int u = 0; u < kVec; ++u) row[k] += q[k][u];
      // n % 16 == 0: a 16-column segment is whole or past N
      if (i0 + rr + kRpp * k < n && j0 + jl < n) store16(orow + k * step + j0, q[k]);
    }
    if (tj != ti) {  // the transposed tile: K8[j, i] = K8[i, j]; I is a whole tile
#pragma unroll
      for (int k = 0; k < kReps; ++k)
#pragma unroll
        for (int u = 0; u < kVec; ++u) stage[jl + u][rr + kRpp * k] = q[k][u];
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kReps; ++k) {
        const int jt = rr + kRpp * k;
        int t[kVec], s = 0;
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          t[u] = stage[jt][jl + u];
          s += t[u];
        }
        s = row_group_sum(s);  // row j0 + jt's partial over the columns of I
        if (j0 + jt < n) {
          store16(ocol + k * step + static_cast<long long>(j0) * n, t);
          if (g == 0) atomicAdd(rs + j0 + jt, static_cast<float>(s));
        }
      }
    }
    __syncthreads();  // sj[buf] and stage are free again
  }
#pragma unroll
  for (int k = 0; k < kReps; ++k) {
    const int s = row_group_sum(row[k]), i = i0 + rr + kRpp * k;
    if (g == 0 && i < n) atomicAdd(rs + i, static_cast<float>(s));
  }
}

}  // namespace
}  // namespace cvt

// imgs: (C, N, 3) uint8 contiguous, N % 16 == 0; feat: (C, 6, N rounded up
// to 64) f32 scratch; k8: (C * N, N) int8; rowsum: (C * N,) f32. Frames are
// h x w with N = h * w, pixel p at (x, y) = (p % w, p / w); C <= 65535.
// Returns cudaGetLastError().
extern "C" int cvt_kernel_i8_build(const void* imgs, int frames, int n, int w, float alpha,
                                   float beta, void* feat, void* k8, void* rowsum,
                                   void* stream) {
  if (frames > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* fe = static_cast<float*>(feat);
    const int npad = cvt::num_tiles(n) * cvt::kTile;
    cudaMemsetAsync(rowsum, 0, static_cast<long long>(frames) * n * sizeof(float), s);
    cvt::tile_feats_kernel<cvt::PlainEntry><<<dim3((npad + 255) / 256, frames), 256, 0, s>>>(
        static_cast<const unsigned char*>(imgs), n, w, alpha, beta, cvt::PlainEntry{}, fe);
    cvt::i8_tile_kernel<<<dim3(static_cast<unsigned>(cvt::num_tiles(n)) * cvt::num_strips(n),
                               frames),
                          cvt::kI8Threads, 0, s>>>(fe, n, static_cast<signed char*>(k8),
                                       static_cast<float*>(rowsum));
  }
  return static_cast<int>(cudaGetLastError());
}
