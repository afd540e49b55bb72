// Fused diff-mask tail of the video pipeline's mask stage (kernel B1).
//
// Replaces critic_vae_tpu/ops/pallas_kernels.py::fused_diff_mask (body
// `_kernel`) and, by default, the XLA tail of critic_vae_tpu/ops/mask.py
// diff_images: per frame, |r(b) - r(a)| of the decoder's two pre-tanh
// outputs a (at the critic value) and b (at 0), the Rec.601 grey projection
// and the per-frame max. r is the JAX default's tanh: tanh of the input
// dtype, so for bf16 the accurate float32 tanhf rounded to the nearest bf16
// (what XLA gives for every finite bf16), then widened. With f32_tanh r is
// the widened input's float32 tanh, the Pallas kernel's arithmetic.
//
// What bounds it on Hopper: memory, with the tanh close behind. At (512, 3,
// 64, 64) bf16 it reads 25.2 MB and writes 8.4 MB, 0.0100 ms at 3.35 TB/s;
// its 12.6 M accurate tanhf, a few tens of instructions each, take about as
// many issue slots. No fast math: tanh.approx mis-rounds a large share of
// the bf16 results, and each mis-rounding moves a diff by 2^-8.
//
// What the design does about it:
// * One block a frame, 512 threads. Each thread takes 16 bytes of each of
//   the six channel planes (8 bf16 or 4 f32 pixels) with one vector load
//   each, all six issued before any tanh, so a 64x64 bf16 frame's 48 KB are
//   in flight at once, and two blocks an SM let one frame's loads run under
//   the other's tanh. The grey leaves as float4 stores. A decode whose
//   planes are not 16-byte aligned (H*W not a multiple of the vector) runs
//   the same kernel with scalar loads.
// * The reconstructions never reach device memory. The projection keeps the
//   plain version's order of rounded products and sums (no FMA
//   contraction), so the kernel equals it bitwise wherever tanhf does.
// * The per-frame max is a warp-shuffle reduction followed by one pass over
//   the per-warp partials in shared memory: no atomics, deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr float kRec601R = 0.2989f;
constexpr float kRec601G = 0.5870f;
constexpr float kRec601B = 0.1140f;

// max that propagates NaN, as jnp.max / torch.amax do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// V consecutive values at p as float: one 16-byte load when V fills it
template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 u = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __ldg(p + i);
  }
}

template <int V>
__device__ __forceinline__ void load(const __nv_bfloat16* p, float (&v)[V]) {
  if constexpr (V == 8) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = __bfloat162float(p[i]);
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V % 4 == 0) {
#pragma unroll
    for (int j = 0; j < V / 4; ++j)
      reinterpret_cast<float4*>(p)[j] = make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2],
                                                    v[4 * j + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = v[i];
  }
}

// x rounded to the nearest bf16 (ties to even) and widened, NaN kept NaN:
// __float2bfloat16_rn's result by integer operations. The conversion
// instruction (F2FP) runs at a quarter of their rate, and with it the bf16
// default was measurably slower on an H100, timed in turns with this form
__device__ __forceinline__ float round_bf16(float x) {
  const uint32_t u = __float_as_uint(x);
  const uint32_t r = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  return x != x ? x : __uint_as_float(r);
}

// the reconstruction: tanhf, rounded to bf16 and widened when kRound
template <bool kRound>
__device__ __forceinline__ float recon(float x) {
  const float t = tanhf(x);
  if constexpr (kRound) return round_bf16(t);
  return t;
}

// pre: the (2B, 3, H*W) decode; the frame at 0 lies zero_offset values after
// the frame at the critic value
template <typename T, int V, bool kRound>
__global__ void __launch_bounds__(kThreads, 2)
diff_mask_kernel(const T* __restrict__ pre, long zero_offset, int hw,
                 float* __restrict__ grey, float* __restrict__ maxv) {
  const long frame = blockIdx.x;
  const T* a = pre + frame * 3 * hw;
  const T* b = a + zero_offset;
  float* g = grey + frame * hw;

  float m = -CUDART_INF_F;
  for (int p = V * threadIdx.x; p < hw; p += V * kThreads) {
    float va[3][V], vb[3][V];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      load<V>(a + c * hw + p, va[c]);
      load<V>(b + c * hw + p, vb[c]);
    }
    float out[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float d[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) d[c] = fabsf(recon<kRound>(vb[c][i]) - recon<kRound>(va[c][i]));
      out[i] = __fadd_rn(__fadd_rn(__fmul_rn(d[0], kRec601R), __fmul_rn(d[1], kRec601G)),
                         __fmul_rn(d[2], kRec601B));
      m = nan_max(m, out[i]);
    }
    store<V>(g + p, out);
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

template <typename T, bool kRound>
void launch(const void* pre, bool vector, int batch, int hw, void* grey, void* maxv,
            cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const T* p = static_cast<const T*>(pre);
  const long zero = 3L * batch * hw;
  float* g = static_cast<float*>(grey);
  float* mx = static_cast<float*>(maxv);
  if (vector)
    diff_mask_kernel<T, kVec, kRound><<<batch, kThreads, 0, s>>>(p, zero, hw, g, mx);
  else
    diff_mask_kernel<T, 1, kRound><<<batch, kThreads, 0, s>>>(p, zero, hw, g, mx);
}

}  // namespace

// pre: the (2 * batch, 3, hw) decode, contiguous, f32 (is_bf16 == 0) or bf16;
// f32_tanh: tanh in f32 without the rounding to bf16. grey: (batch, hw) f32;
// maxv: (batch,) f32. Returns cudaGetLastError().
extern "C" int cvt_diff_mask(const void* pre, int is_bf16, int f32_tanh, int batch, int hw,
                             void* grey, void* maxv, void* stream) {
  if (batch > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int vec = is_bf16 ? 8 : 4;
    const bool vector = hw % vec == 0 && reinterpret_cast<uintptr_t>(pre) % 16 == 0 &&
                        reinterpret_cast<uintptr_t>(grey) % 16 == 0;
    if (!is_bf16)
      launch<float, false>(pre, vector, batch, hw, grey, maxv, s);
    else if (f32_tanh)
      launch<__nv_bfloat16, false>(pre, vector, batch, hw, grey, maxv, s);
    else
      launch<__nv_bfloat16, true>(pre, vector, batch, hw, grey, maxv, s);
  }
  return static_cast<int>(cudaGetLastError());
}
