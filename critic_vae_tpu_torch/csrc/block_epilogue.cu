// The post-conv chain of a conv block of the mask stage, in one pass
// (ops/epilogue.py).
//
// Replaces no TPU kernel: XLA fuses these elementwise ops and the window max
// into its conv fusions, so the JAX package has none to port. On the card
// ATen runs them as 3 to 6 separate passes over each full-resolution float32
// conv output; this kernel reads the conv output once and writes only the
// block's output. Two forms:
//
// * pool: a (B, C, H, W) conv output -> (B, C, H/2, W/2). Channels below
//   n_norm are an encoder block's: + bias, eval BatchNorm ((v - mean) * inv
//   + beta, inv = rsqrt(var + eps) * weight computed by torch), the 2x2
//   max, ReLU (or nothing: the encoder's last block takes ATen's tanh
//   after). Channels from n_norm on are a critic block's: + bias, ReLU, the
//   2x2 max. The merged front end's 40 channels (32 encoder, 8 critic) are
//   one launch, each branch written to its own output.
// * shuffle: a decoder stage's (B, 4C, H, W) phase conv output -> the
//   (B, C, 2H, 2W) interleave of F.pixel_shuffle(., 2), + bias, ReLU on
//   stages 1-3.
//
// Every value is bitwise the ATen chain's on the same conv output: each op
// in float32, in ATen's order, rounded once (__fadd_rn and friends, so no
// FMA contraction; no fast math); the max is max_pool_forward_nchw's loop
// (from -inf, row by row, taking v when v > max or v is NaN); ReLU is
// clamp_min's (NaN passes, else fmaxf(v, 0)).
//
// What bounds it on Hopper: bytes. The pool form reads 4 bytes and writes 1
// a conv output value, the shuffle form reads and writes 4 each; at the
// main path's chunk of 512 frames the launches move ~1.2 GB a chunk, about
// 0.37 ms at 3.35 TB/s (chip_smoke.py's phase 7c counts them per shape).
//
// What the design does about it: each thread reads 16-byte vectors along
// W, neighbouring threads neighbouring addresses. A pool thread takes two
// rows of 8 values (the 2x2 windows of 4 outputs, each row read once) and
// stores the 4 outputs as one float4; a shuffle thread takes 4 values of
// each of the two phase channels of one output row and stores the 8
// interleaved outputs as two float4. The per-channel constants come through
// the read-only cache, shared by every thread of a plane.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// ATen's clamp_min(v, 0): NaN passes through, else ::max (fmaxf)
__device__ __forceinline__ float relu(float v) { return isnan(v) ? v : fmaxf(v, 0.0f); }

// one step of max_pool_forward_nchw's window loop
__device__ __forceinline__ void pool_step(float& m, float v) {
  if (v > m || isnan(v)) m = v;
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
  v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

// y: (batch, c, 2 * ho, w) contiguous; params: bias (c), and for channels
// below n_norm mean, inv and beta at params + c, + 2c, + 3c; out_norm:
// (batch, n_norm, ho, w / 2); out_relu: (batch, c - n_norm, ho, w / 2)
__global__ void __launch_bounds__(kThreads)
block_epilogue_pool(const float* __restrict__ y, unsigned total, unsigned quads, unsigned ho,
                    unsigned c, unsigned n_norm, unsigned w, const float* __restrict__ params,
                    int relu_norm, float* __restrict__ out_norm,
                    float* __restrict__ out_relu) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned qx = t % quads;
  unsigned r = t / quads;
  const unsigned oy = r % ho;
  r /= ho;
  const unsigned ch = r % c;
  const unsigned b = r / c;
  const unsigned wo = w / 2;

  const float* row0 = y + ((static_cast<long>(b) * c + ch) * 2 * ho + 2 * oy) * w + 8 * qx;
  float v[2][8];
  load8(row0, v[0]);
  load8(row0 + w, v[1]);
  const float bias = __ldg(params + ch);

  float* dst;
  if (ch < n_norm) {
    const float mean = __ldg(params + c + ch);
    const float inv = __ldg(params + 2 * c + ch);
    const float beta = __ldg(params + 3 * c + ch);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[i][j] = __fadd_rn(__fmul_rn(__fsub_rn(__fadd_rn(v[i][j], bias), mean), inv), beta);
    dst = out_norm + ((static_cast<long>(b) * n_norm + ch) * ho + oy) * wo;
  } else {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) v[i][j] = relu(__fadd_rn(v[i][j], bias));
    dst = out_relu + ((static_cast<long>(b) * (c - n_norm) + (ch - n_norm)) * ho + oy) * wo;
  }
  const bool relu_after = ch < n_norm && relu_norm;  // the critic's came before the max
  float out[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float m = -CUDART_INF_F;
    pool_step(m, v[0][2 * k]);
    pool_step(m, v[0][2 * k + 1]);
    pool_step(m, v[1][2 * k]);
    pool_step(m, v[1][2 * k + 1]);
    out[k] = relu_after ? relu(m) : m;
  }
  reinterpret_cast<float4*>(dst)[qx] = make_float4(out[0], out[1], out[2], out[3]);
}

// y: (batch, 4c, h, w) contiguous, channel 4k + 2a + b holding phase (a, b)
// of channel k; out: (batch, c, 2h, 2w)
__global__ void __launch_bounds__(kThreads)
block_epilogue_shuffle(const float* __restrict__ y, unsigned total, unsigned h, unsigned c,
                       unsigned w, const float* __restrict__ bias, int use_relu,
                       float* __restrict__ out) {
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const unsigned quads = w / 4;
  const unsigned qx = t % quads;
  unsigned r = t / quads;
  const unsigned a = r & 1u;
  r >>= 1;
  const unsigned hy = r % h;
  r /= h;
  const unsigned ch = r % c;
  const unsigned b = r / c;

  const long plane = static_cast<long>(h) * w;
  const float* p0 = y + (static_cast<long>(b) * 4 * c + 4 * ch + 2 * a) * plane +
                    static_cast<long>(hy) * w + 4 * qx;
  const float4 u0 = __ldg(reinterpret_cast<const float4*>(p0));
  const float4 u1 = __ldg(reinterpret_cast<const float4*>(p0 + plane));
  const float bv = __ldg(bias + ch);
  float o[8] = {u0.x, u1.x, u0.y, u1.y, u0.z, u1.z, u0.w, u1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    o[k] = __fadd_rn(o[k], bv);
    if (use_relu) o[k] = relu(o[k]);
  }
  float4* dst = reinterpret_cast<float4*>(
      out + ((static_cast<long>(b) * c + ch) * 2 * h + 2 * hy + a) * 2 * w + 8 * qx);
  dst[0] = make_float4(o[0], o[1], o[2], o[3]);
  dst[1] = make_float4(o[4], o[5], o[6], o[7]);
}

unsigned blocks(unsigned total) { return (total + kThreads - 1) / kThreads; }

}  // namespace

// y: a (batch, c, h, w) float32 conv output, contiguous, 16-byte aligned,
// h even and w a multiple of 8; params, n_norm, relu_norm, out_norm and
// out_relu as block_epilogue_pool's. Returns cudaGetLastError().
extern "C" int cvt_block_epilogue_pool(const void* y, int batch, int c, int h, int w,
                                       const void* params, int n_norm, int relu_norm,
                                       void* out_norm, void* out_relu, void* stream) {
  const unsigned total = static_cast<unsigned>(batch) * c * (h / 2) * (w / 8);
  if (total > 0)
    block_epilogue_pool<<<blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(y), total, w / 8, h / 2, c, n_norm, w,
        static_cast<const float*>(params), relu_norm, static_cast<float*>(out_norm),
        static_cast<float*>(out_relu));
  return static_cast<int>(cudaGetLastError());
}

// y: a (batch, 4c, h, w) float32 phase conv output, contiguous, 16-byte
// aligned, w a multiple of 4; bias: (c); out: (batch, c, 2h, 2w). Returns
// cudaGetLastError().
extern "C" int cvt_block_epilogue_shuffle(const void* y, int batch, int c, int h, int w,
                                          const void* bias, int use_relu, void* out,
                                          void* stream) {
  const unsigned total = static_cast<unsigned>(batch) * c * h * 2 * (w / 4);
  if (total > 0)
    block_epilogue_shuffle<<<blocks(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(y), total, h, c, w, static_cast<const float*>(bias), use_relu,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
