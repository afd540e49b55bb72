// Fused diff-mask tail of the video pipeline's mask stage (kernel B1).
//
// Replaces critic_vae_tpu/ops/pallas_kernels.py::fused_diff_mask (body
// `_kernel`): per frame, |tanh(b) - tanh(a)| of the decoder's two pre-tanh
// outputs, the Rec.601 grey projection and the per-frame max.
//
// What bounds it on Hopper: memory. Per frame it reads 2 x 3 x H x W values
// (f32 or bf16) and writes H x W f32 plus one f32; the arithmetic (two tanhf
// and three FMAs per pixel) is far below the card's ridge point.
//
// What the design does about it: the decoder output stays in its NCHW
// layout, so one block owns one frame and its threads walk the pixel index
// with unit stride in every channel plane: every load and the grey store are
// coalesced, and the tanh'd reconstructions never reach device memory. The
// TPU kernel's (192, 64) block-sparse grey matmul existed only for the TPU's
// lane layout; here the projection is three FMAs in registers. The per-frame
// max is a warp-shuffle reduction followed by one pass over the per-warp
// partials in shared memory, so the kernel needs no atomics and is
// deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr float kRec601R = 0.2989f;
constexpr float kRec601G = 0.5870f;
constexpr float kRec601B = 0.1140f;

__device__ __forceinline__ float load_f32(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

// max that propagates NaN, as jnp.max / torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
diff_mask_kernel(const T* __restrict__ pre_one, const T* __restrict__ pre_zero,
                 int hw, float* __restrict__ grey, float* __restrict__ maxv) {
  const long frame = blockIdx.x;
  const T* a = pre_one + frame * 3 * hw;   // (3, H*W) plane of this frame
  const T* b = pre_zero + frame * 3 * hw;
  float* g = grey + frame * hw;

  float m = -CUDART_INF_F;
  for (int p = threadIdx.x; p < hw; p += kThreads) {
    float d0 = fabsf(tanhf(load_f32(b, p)) - tanhf(load_f32(a, p)));
    float d1 = fabsf(tanhf(load_f32(b, hw + p)) - tanhf(load_f32(a, hw + p)));
    float d2 = fabsf(tanhf(load_f32(b, 2 * hw + p)) - tanhf(load_f32(a, 2 * hw + p)));
    float v = fmaf(d2, kRec601B, fmaf(d1, kRec601G, d0 * kRec601R));
    g[p] = v;
    m = nan_max(m, v);
  }

  for (int off = 16; off > 0; off >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_max[warp] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    float r = warp_max[0];
    for (int i = 1; i < kThreads / 32; ++i) r = nan_max(r, warp_max[i]);
    maxv[frame] = r;
  }
}

}  // namespace

// pre_one, pre_zero: (B, 3, H*W) contiguous, f32 (is_bf16 == 0) or bf16.
// grey: (B, H*W) f32; maxv: (B,) f32. Returns cudaGetLastError().
extern "C" int cvt_diff_mask(const void* pre_one, const void* pre_zero,
                             int is_bf16, int batch, int hw, void* grey,
                             void* maxv, void* stream) {
  if (batch > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
      diff_mask_kernel<__nv_bfloat16><<<batch, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(pre_one),
          static_cast<const __nv_bfloat16*>(pre_zero), hw,
          static_cast<float*>(grey), static_cast<float*>(maxv));
    } else {
      diff_mask_kernel<float><<<batch, kThreads, 0, s>>>(
          static_cast<const float*>(pre_one), static_cast<const float*>(pre_zero),
          hw, static_cast<float*>(grey), static_cast<float*>(maxv));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
