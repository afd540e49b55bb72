// The spatial message of the device CRF's mean field in its own launch
// (kernel spatial_message): for every lane of a lane-major f32 y = ns * q,
//
//   s = ns * (conv(y) - y)
//
// where conv is the taps' 1-D Gaussian along H, then along W, zero outside
// the frame: the term that kernel mean_field_step adds as w2 s.
//
// Replaces no TPU kernel: the JAX package leaves the conv to XLA
// (critic_vae_tpu/crf/device.py:191 _mean_field_iterate). It runs before
// each launch of mean_field_step, which adds its s: computed in the step's
// epilogue instead, s would stage the taps' halo of y rows for every lane of
// a block, 4 rounds a block at the threshold sweep's 26 lanes (64x64, radius
// 15).
//
// What bounds it: bytes. y read once and s written once, 2 C P N f32 words
// (C = 64, P = 26, N = 4096: 54.5 MB, 16.3 us at 3.35 TB/s); 2 (2 radius + 1)
// FMAs an output (0.42 GFLOP at radius 15, 6.3 us at 67 TFLOP/s).
//
// What the design does about it:
// * A block takes one lane of one frame and a band of image rows: the
//   whole frame where its rows fit the shared memory (a 64x64 frame: one
//   band, 40 KB), else bands of at least kR rows, or as many as fit.
// * The column pass reads y from global memory, a warp's threads on
//   neighbouring columns (L1 serves the taps' reuse), and sums kR rows a
//   thread: kR + 7 rows in registers slide along the taps, 8 taps at a
//   time, so a value loaded feeds up to 8 kR FMAs. The sums go to shared
//   memory, each row padded with radius zeros on either side.
// * The row pass sums kR neighbouring columns a thread the same way, a
//   warp's threads on 32 rows (an odd pitch: no bank conflict), into a
//   second shared tile; the last pass writes s row-major, coalesced.
// * The same f32 FMAs in the same order as the step's epilogue before this
//   kernel took its place: the taps in ascending order from 0.0f, the
//   columns first, then ns * (sum - y). A tap that falls outside the frame,
//   skipped there, adds 0 * tap here (as do the padded taps of the last 8):
//   a sum from 0.0f is never -0, and x + (+-0) = x, so the sums are the same
//   bits, and the step's marginals those it gave before (the card test holds
//   their digests).
// * No sum crosses a block and nothing is atomic: launches are bitwise
//   reproducible.
// Built without fast math.
//
// Measured (an H100 80GB HBM3 at 700 W, C = 64, P = 26, 64x64): 0.060-0.062
// ms a launch, 27% of the byte bound. The FMAs' issue and each block's chain
// of latencies hold it, not memory: a lone block takes ~10 us, and waves of
// 396 blocks (3 an SM) ~15 us each.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr int kR = 16;                // outputs a thread sums, along either pass
constexpr int kTaps = 8;              // taps in registers at once
constexpr int kWin = kR + kTaps - 1;  // the inputs those taps reach
constexpr int kBudgetWords = 12288;   // 48 KB: a 64x64 frame's one band
constexpr int kMaxSmemBytes = 232448;

__host__ __device__ constexpr int tap_chunks(int radius) { return (2 * radius + kTaps) / kTaps; }

// a row of column sums: radius zeros, w sums, and zeros as far as the last
// column group's taps reach; odd
__host__ __device__ constexpr int col_pitch(int w, int radius) {
  return ((w + kR - 1) / kR * kR + kTaps * tap_chunks(radius) - 1) | 1;
}

__host__ __device__ constexpr int row_words(int w, int radius) {
  return col_pitch(w, radius) + (w | 1);
}

// acc[j] += taps[k] v[j + k - 8c] for the taps k of chunk c, in order, then
// the window moves 8 inputs on: load(m) gives input m of chunk 0's window
template <typename Load>
__device__ __forceinline__ void tap_sums(const float* __restrict__ taps, int ntaps, Load load,
                                         float (&acc)[kR]) {
  float v[kWin];
#pragma unroll
  for (int j = 0; j < kR; ++j) acc[j] = 0.0f;
#pragma unroll
  for (int m = 0; m < kWin; ++m) v[m] = load(m);
  const int chunks = (ntaps + kTaps - 1) / kTaps;
  for (int c = 0; c < chunks; ++c) {
    float t[kTaps];
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
      t[k] = kTaps * c + k < ntaps ? __ldg(taps + kTaps * c + k) : 0.0f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k)
#pragma unroll
      for (int j = 0; j < kR; ++j) acc[j] = fmaf(t[k], v[j + k], acc[j]);
    if (c + 1 < chunks) {
#pragma unroll
      for (int m = 0; m < kR - 1; ++m) v[m] = v[m + kTaps];
#pragma unroll
      for (int m = kR - 1; m < kWin; ++m) v[m] = load(kTaps * (c + 1) + m);
    }
  }
}

// grid (bands, P, C). y, s: (C, P, h w) f32; ns: (h w,) f32; taps: (2 radius
// + 1,) f32; bh: the rows of a band.
__global__ void __launch_bounds__(kThreads, 3)
spatial_message_kernel(const float* __restrict__ y, const float* __restrict__ ns,
                       const float* __restrict__ taps, int radius, int h, int w, int bh,
                       float* __restrict__ s) {
  extern __shared__ float smem[];
  const int ntaps = 2 * radius + 1;
  const int pitch = col_pitch(w, radius), opitch = w | 1;
  const int b0 = blockIdx.x * bh, nb = min(bh, h - b0);
  const long long plane = (static_cast<long long>(blockIdx.z) * gridDim.y + blockIdx.y) * h * w;
  const float* yp = y + plane;
  float* col = smem;               // (nb, pitch): radius zeros, w column sums, zeros
  float* out = smem + bh * pitch;  // (nb, opitch): the row sums
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  for (int r = warp; r < nb; r += kWarps) {
    for (int c = lane; c < radius; c += 32) col[r * pitch + c] = 0.0f;
    for (int c = radius + w + lane; c < pitch; c += 32) col[r * pitch + c] = 0.0f;
  }
  // the column pass: column x, output rows r0 .. r0 + kR - 1
  for (int e = tid; e < (nb + kR - 1) / kR * w; e += kThreads) {
    const int x = e % w, r0 = b0 + e / w * kR;
    float acc[kR];
    tap_sums(taps, ntaps, [&](int m) {
      const int i = r0 - radius + m;
      return i >= 0 && i < h ? __ldg(yp + static_cast<long long>(i) * w + x) : 0.0f;
    }, acc);
#pragma unroll
    for (int j = 0; j < kR; ++j)
      if (r0 - b0 + j < nb) col[(r0 - b0 + j) * pitch + radius + x] = acc[j];
  }
  __syncthreads();
  // the row pass: band row r, output columns x0 .. x0 + kR - 1
  for (int e = tid; e < (w + kR - 1) / kR * nb; e += kThreads) {
    const int r = e % nb, x0 = e / nb * kR;
    const float* cr = col + r * pitch + x0;
    float acc[kR];
    tap_sums(taps, ntaps, [&](int m) { return cr[m]; }, acc);
#pragma unroll
    for (int j = 0; j < kR; ++j)
      if (x0 + j < w) out[r * opitch + x0 + j] = acc[j];
  }
  __syncthreads();
  for (int r = warp; r < nb; r += kWarps)
    for (int x = lane; x < w; x += 32) {
      const int pix = (b0 + r) * w + x;
      s[plane + pix] = ns[pix] * (out[r * opitch + x] - yp[pix]);
    }
}

}  // namespace

// y, s: (frames, lanes, h w) f32, contiguous; ns: (h w,) f32; taps: (2
// radius + 1,) f32. frames, lanes <= 65535; a band's row of column and row
// sums, about 2 w + 2 radius words, within the shared memory (any w <= 5376
// at radius < 23,000). Returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments outside these limits.
extern "C" int cvt_spatial_message(const void* y, const void* ns, const void* taps, int radius,
                                   int frames, int lanes, int h, int w, void* s, void* stream) {
  if (frames <= 0 || lanes <= 0 || h <= 0) return static_cast<int>(cudaGetLastError());
  if (w <= 0 || radius < 0 || radius > kMaxSmemBytes || frames > 65535 || lanes > 65535 ||
      4LL * row_words(w, radius) > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rw = row_words(w, radius);
  int bh = min(h, max(kR, kBudgetWords / rw));
  bh = min(bh, kMaxSmemBytes / (4 * rw));
  const int smem = 4 * bh * rw;
  cudaFuncSetAttribute(spatial_message_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((h + bh - 1) / bh, lanes, frames);
  spatial_message_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(ns),
      static_cast<const float*>(taps), radius, h, w, bh, static_cast<float*>(s));
  return static_cast<int>(cudaGetLastError());
}
