// Quantized bilateral kernel of the device CRF's int8 build (kernel B3).
//
// Replaces critic_vae_tpu/crf/fused_build.py::build_kernel_i8 (body
// `_build_i8_kernel`). Per frame of N pixels, in one sweep:
//
//   k[i,j]    = exp(-1/2 |dxy/alpha|^2 - 1/2 |drgb/beta|^2)   for i != j, 0 on i == j
//   K8[i,j]   = round_half_even(127 * k[i,j])                  stored int8
//   rowsum[i] = sum_j K8[i,j]                                  stored f32
//
// k is exactly kernel B2's (bilateral_build.cu `k_entry`): per-coordinate
// differences, IEEE division of coordinates and colours by alpha/beta, and
// the `logp < 0` predicate that excludes only the diagonal.
//
// What bounds it on Hopper: one expf per entry (16.7 M a 64x64 frame) and
// the N^2 int8 store, 1 byte an entry (16.8 MB a frame). Compared with B2
// there is no second pass: the normalizers come from the quantized values,
// which are only known once they are stored.
//
// What the design does about it:
// * B2's pass-2 layout: a block owns kRows rows by kCols columns; each
//   thread keeps the features of 4 adjacent columns in registers and walks
//   the tile's rows from shared memory, storing 4 int8 as one char4, so a
//   warp stores 128 contiguous bytes of a row.
// * The row sums are sums of integers <= 127 * N < 2^24. Each row's
//   partial over the block's columns is reduced with __reduce_add_sync
//   (warps) and shared memory (the block's 4 warps) and then added to the
//   f32 total with one atomicAdd per row and block. Every partial and total
//   is an integer below 2^24, which f32 holds exactly, so the additions are
//   exact in any order: the totals are deterministic and equal the sum of
//   the stored bytes.
// * Rounding is half-to-even (__float2int_rn), as jnp.round and torch.round.
// Built without fast math: __expf would move entries across a rounding
// boundary of the 127 scale.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kColsPerThread = 4;
constexpr int kCols = kThreads * kColsPerThread;  // columns per block
constexpr int kRows = 32;                         // rows per block
constexpr float kQuantScale = 127.0f;

struct Feat {
  float x, y, r, g, b;
};

__device__ __forceinline__ Feat load_feat(const unsigned char* img, int p, int w,
                                          float alpha, float beta) {
  Feat f;
  f.x = static_cast<float>(p % w) / alpha;
  f.y = static_cast<float>(p / w) / alpha;
  f.r = static_cast<float>(img[3 * p + 0]) / beta;
  f.g = static_cast<float>(img[3 * p + 1]) / beta;
  f.b = static_cast<float>(img[3 * p + 2]) / beta;
  return f;
}

// k[i,j] with the diagonal exactly zero, as bilateral_build.cu
__device__ __forceinline__ float k_entry(const Feat& i, const Feat& j) {
  const float dp0 = i.x - j.x, dp1 = i.y - j.y;
  const float logp = -0.5f * (dp0 * dp0 + dp1 * dp1);
  const float dc0 = i.r - j.r, dc1 = i.g - j.g, dc2 = i.b - j.b;
  const float logc = -0.5f * (dc0 * dc0 + dc1 * dc1 + dc2 * dc2);
  return logp < 0.0f ? expf(logp + logc) : 0.0f;
}

// grid (ceil(N / kCols), ceil(N / kRows), C); N % 4 == 0
__global__ void __launch_bounds__(kThreads)
build_i8_kernel(const unsigned char* __restrict__ imgs, int n, int w, float alpha,
                float beta, signed char* __restrict__ k8, float* __restrict__ rowsum) {
  __shared__ Feat srow[kRows];
  __shared__ int spart[kThreads / 32][kRows];
  const long f = blockIdx.z;
  const unsigned char* img = imgs + f * n * 3;
  const int j0 = blockIdx.x * kCols + threadIdx.x * kColsPerThread;
  const int i0 = blockIdx.y * kRows;
  for (int t = threadIdx.x; t < kRows; t += kThreads)
    srow[t] = load_feat(img, min(i0 + t, n - 1), w, alpha, beta);
  Feat fj[kColsPerThread];
#pragma unroll
  for (int c = 0; c < kColsPerThread; ++c)
    fj[c] = load_feat(img, min(j0 + c, n - 1), w, alpha, beta);
  __syncthreads();
  const bool in_range = j0 < n;  // N % 4 == 0: all 4 columns or none
  const int rows = min(kRows, n - i0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  signed char* o = k8 + (f * n + i0) * static_cast<long>(n) + j0;
  for (int t = 0; t < rows; ++t) {
    int q[kColsPerThread];
    int part = 0;
#pragma unroll
    for (int c = 0; c < kColsPerThread; ++c) {
      const float k = in_range ? k_entry(srow[t], fj[c]) : 0.0f;
      q[c] = __float2int_rn(k * kQuantScale);
      part += q[c];
    }
    if (in_range)
      *reinterpret_cast<char4*>(o + static_cast<long>(t) * n) =
          make_char4(static_cast<signed char>(q[0]), static_cast<signed char>(q[1]),
                     static_cast<signed char>(q[2]), static_cast<signed char>(q[3]));
    part = __reduce_add_sync(0xffffffffu, part);
    if (lane == 0) spart[warp][t] = part;
  }
  __syncthreads();
  if (threadIdx.x < rows) {
    int s = 0;
#pragma unroll
    for (int v = 0; v < kThreads / 32; ++v) s += spart[v][threadIdx.x];
    atomicAdd(rowsum + f * n + i0 + threadIdx.x, static_cast<float>(s));
  }
}

}  // namespace

// imgs: (C, N, 3) uint8 contiguous, N % 4 == 0; k8: (C * N, N) int8;
// rowsum: (C * N,) f32. Frames are h x w with N = h * w, pixel p at
// (x, y) = (p % w, p / w). Returns cudaGetLastError().
extern "C" int cvt_kernel_i8_build(const void* imgs, int frames, int n, int w,
                                   float alpha, float beta, void* k8, void* rowsum,
                                   void* stream) {
  if (frames > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaMemsetAsync(rowsum, 0, static_cast<long>(frames) * n * sizeof(float), s);
    const dim3 grid((n + kCols - 1) / kCols, (n + kRows - 1) / kRows, frames);
    build_i8_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(imgs), n, w, alpha, beta,
        static_cast<signed char*>(k8), static_cast<float*>(rowsum));
  }
  return static_cast<int>(cudaGetLastError());
}
