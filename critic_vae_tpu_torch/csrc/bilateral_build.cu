// Normalized bilateral message matrix of the device CRF (kernel B2).
//
// Replaces critic_vae_tpu/crf/fused_build.py::build_bilateral (bodies
// `_k_tile`, `_rowsum_kernel`, `_build_kernel`). Per frame of N pixels:
//
//   K[i,j]   = exp(-1/2 |dxy/alpha|^2 - 1/2 |drgb/beta|^2)   for i != j, 0 on i == j
//   n_i      = sqrt(w1) * rsqrt(sum_j K[i,j] + 1e-20)
//   M[i,j]   = (n_i * n_j) * K[i,j]                          stored f32 or bf16
//
// What bounds it on Hopper: each of the N^2 entries costs one expf (twice:
// once for the row sums, once for the store) and the store of M itself, 2 or
// 4 bytes an entry (33.5 MB a 64x64 frame in bf16). No matrix product is
// involved, so the tensor cores sit idle; the limit is SFU exp throughput
// plus the N^2 store bandwidth.
//
// What the design does about it:
// * Pass 1 (row sums): one thread owns one row and loops over ALL columns,
//   whose features (x/alpha, y/alpha, rgb/beta) are staged through shared
//   memory a tile at a time and read as broadcasts. On the TPU a sequential
//   grid axis carried the sum from step to step; here the loop inside the
//   block takes its place, so there are no atomics and the sums are
//   deterministic. The same thread then writes n_i, with sqrt(w1) folded in.
// * Pass 2 (store): a block owns a tile of kRows2 rows by kThreads2 columns;
//   each thread keeps its column's features and n_j in registers and walks
//   the tile's rows from shared memory, so every warp stores one contiguous
//   run of a row of M.
// * Differences are taken per coordinate, never through a Gram product, so
//   the i == j exponent is exactly 0 and `logp < 0` excludes the diagonal
//   (the positional term of two distinct pixels is at most -(1/alpha)^2/2).
// * Features are computed in the kernel from the uint8 frame with IEEE
//   division, as the plain version and the JAX package compute them; any N
//   works, the ragged edge is masked.
// Built without fast math: __expf and flush-to-zero would change the row sums
// of isolated pixels, whose off-diagonal terms underflow towards the 1e-20
// floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads1 = 128;   // rows per block, pass 1
constexpr int kCols1 = 512;      // columns staged per shared-memory tile, pass 1
constexpr int kThreads2 = 128;   // columns per block, pass 2
constexpr int kRows2 = 32;       // rows per block, pass 2
constexpr float kEpsNorm = 1e-20f;

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

// K[i,j] with the diagonal exactly zero (see the note above)
__device__ __forceinline__ float k_entry(const Feat& i, float jx, float jy,
                                         float jr, float jg, float jb) {
  const float dp0 = i.x - jx, dp1 = i.y - jy;
  const float logp = -0.5f * (dp0 * dp0 + dp1 * dp1);
  const float dc0 = i.r - jr, dc1 = i.g - jg, dc2 = i.b - jb;
  const float logc = -0.5f * (dc0 * dc0 + dc1 * dc1 + dc2 * dc2);
  return logp < 0.0f ? expf(logp + logc) : 0.0f;
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid (ceil(N / kThreads1), C): nvec[c, i] = sqrt(w1) * rsqrt(rowsum_i + eps)
__global__ void __launch_bounds__(kThreads1)
rowsum_kernel(const unsigned char* __restrict__ imgs, int n, int w, float w1,
              float alpha, float beta, float* __restrict__ nvec) {
  __shared__ float sx[kCols1], sy[kCols1], sr[kCols1], sg[kCols1], sb[kCols1];
  const unsigned char* img = imgs + static_cast<long>(blockIdx.y) * n * 3;
  const int i = blockIdx.x * kThreads1 + threadIdx.x;
  const Feat fi = load_feat(img, i < n ? i : 0, w, alpha, beta);
  float sum = 0.0f;
  for (int j0 = 0; j0 < n; j0 += kCols1) {
    const int cols = min(kCols1, n - j0);
    __syncthreads();
    for (int t = threadIdx.x; t < cols; t += kThreads1) {
      const Feat fj = load_feat(img, j0 + t, w, alpha, beta);
      sx[t] = fj.x; sy[t] = fj.y; sr[t] = fj.r; sg[t] = fj.g; sb[t] = fj.b;
    }
    __syncthreads();
    for (int t = 0; t < cols; ++t) sum += k_entry(fi, sx[t], sy[t], sr[t], sg[t], sb[t]);
  }
  if (i < n)
    nvec[static_cast<long>(blockIdx.y) * n + i] = sqrtf(w1) * (1.0f / sqrtf(sum + kEpsNorm));
}

// grid (ceil(N / kThreads2), ceil(N / kRows2), C): one (kRows2, kThreads2) tile of M
template <typename T>
__global__ void __launch_bounds__(kThreads2)
build_kernel(const unsigned char* __restrict__ imgs, int n, int w, float alpha,
             float beta, const float* __restrict__ nvec, T* __restrict__ out) {
  __shared__ Feat srow[kRows2];
  __shared__ float snrow[kRows2];
  const long c = blockIdx.z;
  const unsigned char* img = imgs + c * n * 3;
  const float* nv = nvec + c * n;
  const int j = blockIdx.x * kThreads2 + threadIdx.x;
  const int i0 = blockIdx.y * kRows2;
  for (int t = threadIdx.x; t < kRows2; t += kThreads2) {
    const int i = min(i0 + t, n - 1);
    srow[t] = load_feat(img, i, w, alpha, beta);
    snrow[t] = nv[i];
  }
  __syncthreads();
  if (j >= n) return;
  const Feat fj = load_feat(img, j, w, alpha, beta);
  const float nj = nv[j];
  const int rows = min(kRows2, n - i0);
  T* o = out + (c * n + i0) * static_cast<long>(n) + j;
  for (int t = 0; t < rows; ++t) {
    const float k = k_entry(srow[t], fj.x, fj.y, fj.r, fj.g, fj.b);
    store(o + static_cast<long>(t) * n, (snrow[t] * nj) * k);
  }
}

}  // namespace

// imgs: (C, N, 3) uint8 contiguous; nvec: (C, N) f32 scratch; out: (C, N, N)
// f32 (out_bf16 == 0) or bf16. Frames are h x w with N = h * w, pixel p at
// (x, y) = (p % w, p / w). Returns cudaGetLastError().
extern "C" int cvt_bilateral_build(const void* imgs, int frames, int n, int w,
                                   float w1, float alpha, float beta, void* nvec,
                                   void* out, int out_bf16, void* stream) {
  if (frames > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned char* im = static_cast<const unsigned char*>(imgs);
    float* nv = static_cast<float*>(nvec);
    rowsum_kernel<<<dim3((n + kThreads1 - 1) / kThreads1, frames), kThreads1, 0, s>>>(
        im, n, w, w1, alpha, beta, nv);
    const dim3 grid2((n + kThreads2 - 1) / kThreads2, (n + kRows2 - 1) / kRows2, frames);
    if (out_bf16) {
      build_kernel<__nv_bfloat16><<<grid2, kThreads2, 0, s>>>(
          im, n, w, alpha, beta, nv, static_cast<__nv_bfloat16*>(out));
    } else {
      build_kernel<float><<<grid2, kThreads2, 0, s>>>(
          im, n, w, alpha, beta, nv, static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
