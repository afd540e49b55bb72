// Resident-matrix dense-CRF mean field of the device CRF's vmem build
// (kernel B5).
//
// Replaces critic_vae_tpu/crf/fused_resident.py::mean_field_resident (body
// `_resident_kernel`, called from `_resident_chunk`). Per frame of N pixels
// with P = 2T lanes, T (neg, pos) class pairs that share the frame:
//
//   k[i,j]  = exp(-1/2 |dxy/alpha|^2 - 1/2 |drgb/beta|^2)   i != j, else 0
//   nb_i    = sqrt(w1) * rsqrt(sum_j k[i,j] + 1e-20)          (f32 row sums)
//   ks[i,j] = exp(-1/2 |dxy/gamma|^2)                         i != j, else 0
//   M[i,j]  = bf16((nb_i nb_j) f32(bf16(k[i,j])) + ((sqrt(w2) ns_i)(sqrt(w2) ns_j)) ks[i,j])
//   U       = -log(max(p, 1e-8)),   q0 = pair_softmax(-U)
//   q      <- pair_softmax(M @ bf16(q) - U)                   iters times
//
// with pair_softmax(z)[2t+s] = sigmoid(z[2t+s] - z[2t+1-s]) and ns the
// spatial normalizer rsqrt(conv(1) - 1 + 1e-20) of the truncated separable
// taps, which the caller passes in. The bilateral term is rounded to bf16
// twice, as the TPU kernel rounds it (stored k, then stored M).
//
// What bounds it on Hopper: the TPU kept the 33.5 MB bf16 M of a 64x64 frame
// in 128 MiB of VMEM; a Hopper block has 227 KB of shared memory. Each
// iteration reads M once and does P FMAs per entry of M: at P = 2 that is
// bandwidth-bound, at P = 26 (the 13-threshold sweep) the FMAs, not the
// bytes, set the time.
//
// What the design does about it:
// * M lives in a device workspace of the whole chunk: the C entry runs the
//   build for every frame and then `iters` launches of the iteration
//   kernel, each over all frames, with q double-buffered across launches.
//   A workspace of one frame at a time would keep its M (33.5 MB at 64x64)
//   inside the 50 MB L2 across its iterations, but measured slower at
//   T = 1 (19.2-20.2 against 13.9-14.5 ms for 64 frames on an H100 80GB
//   HBM3, 700 W): 64 times more, 64 times smaller launches cost more than
//   the L2 hits save; at T = 13 the two were equal.
// * The build is B2's: a features pass (xy/alpha, rgb/beta, ns, xy/gamma,
//   as the TPU kernel's feats columns), a row-sum pass with one warp per row
//   (a fixed shuffle order, deterministic; the symmetric K gives the column
//   normalizer from the same sums), and a store pass whose warps write
//   contiguous runs of a row.
// * The iteration kernel gives each warp 4 rows; a lane reads 8 bf16 of
//   each row per 16-byte load, and the block stages bf16-rounded q a tile
//   of 256 pixels at a time in shared memory (padded so the 32 lanes hit 32
//   banks), reused by the block's 32 rows. Lanes of one launch are a
//   template argument up to 32 (16 pairs); wider q runs in groups of 32.
//   The pair softmax is the epilogue, so no separate pass touches q.
// Built without fast math: __expf would change the row sums of isolated
// pixels and the sigmoid of saturated logits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFeat = 8;          // feature planes per frame
constexpr float kEpsNorm = 1e-20f;
constexpr float kEpsProb = 1e-8f;
constexpr int kThreads = 256;     // features, row sums, init, iterations
constexpr int kBuildThreads = 128;
constexpr int kBuildRows = 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRowsPerBlock = kThreads / 32 * kRowsPerWarp;
constexpr int kVec = 8;           // bf16 per 16-byte load
constexpr int kTileJ = 32 * kVec; // pixels per staged tile of q
constexpr int kPad = kVec + 1;
constexpr int kMaxLanes = 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// feats: (C, 8, N) planes x/alpha, y/alpha, r/beta, g/beta, b/beta, ns, x/gamma, y/gamma
__global__ void feats_kernel(const unsigned char* __restrict__ imgs,
                             const float* __restrict__ ns, int frames, int n, int w,
                             float alpha, float beta, float gamma,
                             float* __restrict__ feats) {
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<long>(frames) * n) return;
  const long f = e / n;
  const int p = static_cast<int>(e - f * n);
  const unsigned char* px = imgs + e * 3;
  float* o = feats + f * kFeat * n + p;
  const float x = static_cast<float>(p % w), y = static_cast<float>(p / w);
  o[0 * n] = x / alpha;
  o[1 * n] = y / alpha;
  o[2 * n] = static_cast<float>(px[0]) / beta;
  o[3 * n] = static_cast<float>(px[1]) / beta;
  o[4 * n] = static_cast<float>(px[2]) / beta;
  o[5 * n] = ns[p];
  o[6 * n] = x / gamma;
  o[7 * n] = y / gamma;
}

__device__ __forceinline__ float k_bilateral(const float* fi, const float* fj) {
  const float dp0 = fi[0] - fj[0], dp1 = fi[1] - fj[1];
  const float logp = -0.5f * (dp0 * dp0 + dp1 * dp1);
  const float dc0 = fi[2] - fj[2], dc1 = fi[3] - fj[3], dc2 = fi[4] - fj[4];
  const float logc = -0.5f * (dc0 * dc0 + dc1 * dc1 + dc2 * dc2);
  return logp < 0.0f ? expf(logp + logc) : 0.0f;
}

// grid (ceil(N / 8), C): one warp per row; nb[c, i] = sqrt(w1) * rsqrt(rowsum + eps)
__global__ void __launch_bounds__(kThreads)
rowsum_kernel(const float* __restrict__ feats, int n, float w1, float* __restrict__ nb) {
  const long f = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (i >= n) return;
  const float* fp = feats + f * kFeat * n;
  float fi[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) fi[c] = fp[c * n + i];
  float sum = 0.0f;
  for (int j = lane; j < n; j += 32) {
    float fj[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) fj[c] = fp[c * n + j];
    sum += k_bilateral(fi, fj);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) nb[f * n + i] = sqrtf(w1) * (1.0f / sqrtf(sum + kEpsNorm));
}

// grid (ceil(N / 128), ceil(N / 32), C): one (kBuildRows, kBuildThreads) tile of M
__global__ void __launch_bounds__(kBuildThreads)
build_kernel(const float* __restrict__ feats, const float* __restrict__ nb, int n, float w2,
             __nv_bfloat16* __restrict__ m) {
  __shared__ float srow[kBuildRows][kFeat];
  __shared__ float snb[kBuildRows];
  const long f = blockIdx.z;
  const float* fp = feats + f * kFeat * n;
  const float* nbf = nb + f * n;
  const int j = blockIdx.x * kBuildThreads + threadIdx.x;
  const int i0 = blockIdx.y * kBuildRows;
  for (int e = threadIdx.x; e < kBuildRows * kFeat; e += kBuildThreads) {
    const int t = e / kFeat, c = e % kFeat;
    srow[t][c] = fp[c * n + min(i0 + t, n - 1)];
  }
  for (int t = threadIdx.x; t < kBuildRows; t += kBuildThreads) snb[t] = nbf[min(i0 + t, n - 1)];
  __syncthreads();
  if (j >= n) return;
  float fj[kFeat];
#pragma unroll
  for (int c = 0; c < kFeat; ++c) fj[c] = fp[c * n + j];
  const float sw2 = sqrtf(w2);
  const float gj = sw2 * fj[5];
  const float nbj = nbf[j];
  const int rows = min(kBuildRows, n - i0);
  __nv_bfloat16* o = m + (f * n + i0) * static_cast<long>(n) + j;
  for (int t = 0; t < rows; ++t) {
    const float* fi = srow[t];
    const float kb = bf16_round(k_bilateral(fi, fj));
    const float dg0 = fi[6] - fj[6], dg1 = fi[7] - fj[7];
    const float logs = -0.5f * (dg0 * dg0 + dg1 * dg1);
    const float ks = logs < 0.0f ? expf(logs) : 0.0f;
    const float mb = (snb[t] * nbj) * kb;
    const float ms = ((sw2 * fi[5]) * gj) * ks;
    o[static_cast<long>(t) * n] = __float2bfloat16_rn(mb + ms);
  }
}

// over frames * N * P entries: the unary and q0 = pair_softmax(-U)
__global__ void init_kernel(const float* __restrict__ probs, long count,
                            float* __restrict__ unary, float* __restrict__ q) {
  const long e = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const float u = -logf(fmaxf(probs[e], kEpsProb));
  const float up = -logf(fmaxf(probs[e ^ 1], kEpsProb));  // P even: e ^ 1 is the pair
  unary[e] = u;
  q[e] = sigmoid(-u - -up);
}

// grid (ceil(N / kRowsPerBlock), C): lanes [l0, l0 + PL) of one iteration,
// q_out = pair_softmax(M @ bf16(q_in) - U)
template <int PL>
__global__ void __launch_bounds__(kThreads)
iterate_kernel(const __nv_bfloat16* __restrict__ m, const float* __restrict__ q_in,
               const float* __restrict__ unary, int n, int ldp, int l0,
               float* __restrict__ q_out) {
  __shared__ float qs[PL][kTileJ / kVec * kPad];
  const long f = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kRowsPerBlock + warp * kRowsPerWarp;
  const __nv_bfloat16* mf = m + f * n * static_cast<long>(n);
  const long qoff = f * n * static_cast<long>(ldp) + l0;
  const float* qf = q_in + qoff;
  float acc[kRowsPerWarp][PL];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int l = 0; l < PL; ++l) acc[r][l] = 0.0f;

  for (int j0 = 0; j0 < n; j0 += kTileJ) {
    const int cols = min(kTileJ, n - j0);
    __syncthreads();
    for (int e = threadIdx.x; e < cols * PL; e += kThreads) {
      const int jj = e / PL, l = e - jj * PL;
      qs[l][(jj / kVec) * kPad + jj % kVec] =
          bf16_round(qf[static_cast<long>(j0 + jj) * ldp + l]);
    }
    __syncthreads();
    const int jj = lane * kVec;
    if (jj >= cols) continue;  // N % 8 == 0: a chunk is whole or absent
    uint4 mv[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = row0 + r;
      mv[r] = row < n ? *reinterpret_cast<const uint4*>(mf + static_cast<long>(row) * n + j0 + jj)
                      : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      float qv[PL];
#pragma unroll
      for (int l = 0; l < PL; ++l) qv[l] = qs[l][lane * kPad + u];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const unsigned word = u < 2 ? mv[r].x : u < 4 ? mv[r].y : u < 6 ? mv[r].z : mv[r].w;
        // bf16 -> f32: the low half is the earlier element (little endian)
        const float mval = __uint_as_float((u & 1) ? (word & 0xffff0000u) : (word << 16));
#pragma unroll
        for (int l = 0; l < PL; ++l) acc[r][l] = fmaf(mval, qv[l], acc[r][l]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int l = 0; l < PL; ++l)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r][l] += __shfl_xor_sync(0xffffffffu, acc[r][l], off);
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = row0 + r;
    if (row >= n) continue;
    const long base = qoff + static_cast<long>(row) * ldp;
    float z[PL];
#pragma unroll
    for (int l = 0; l < PL; ++l) z[l] = acc[r][l] - unary[base + l];
#pragma unroll
    for (int l = 0; l < PL; ++l) q_out[base + l] = sigmoid(z[l] - z[l ^ 1]);
  }
}

template <int PL>
void launch_iterate(const __nv_bfloat16* m, const float* q_in, const float* unary, int g,
                    int n, int ldp, int l0, float* q_out, cudaStream_t s) {
  const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, g);
  iterate_kernel<PL><<<grid, kThreads, 0, s>>>(m, q_in, unary, n, ldp, l0, q_out);
}

void iterate(const __nv_bfloat16* m, const float* q_in, const float* unary, int g, int n,
             int p, float* q_out, cudaStream_t s) {
  for (int l0 = 0; l0 < p; l0 += kMaxLanes) {
    switch (min(kMaxLanes, p - l0)) {
      case 2: launch_iterate<2>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 4: launch_iterate<4>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 6: launch_iterate<6>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 8: launch_iterate<8>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 10: launch_iterate<10>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 12: launch_iterate<12>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 14: launch_iterate<14>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 16: launch_iterate<16>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 18: launch_iterate<18>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 20: launch_iterate<20>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 22: launch_iterate<22>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 24: launch_iterate<24>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 26: launch_iterate<26>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 28: launch_iterate<28>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      case 30: launch_iterate<30>(m, q_in, unary, g, n, p, l0, q_out, s); break;
      default: launch_iterate<32>(m, q_in, unary, g, n, p, l0, q_out, s); break;
    }
  }
}

}  // namespace

// imgs: (C, N, 3) uint8; probs: (C, N, P) f32, P even; ns: (N,) f32, N % 8
// == 0. Workspace: feats (C, 8, N) f32, nb (C, N) f32, m (C, N, N) bf16.
// unary, qtmp and out: (C, N, P) f32; out gets the marginals. All
// contiguous, C <= 65535. Frames are h x w with N = h * w, pixel p at
// (x, y) = (p % w, p / w). Returns cudaGetLastError().
extern "C" int cvt_mean_field_resident(const void* imgs, const void* probs, const void* ns,
                                       int frames, int n, int w, int p, float w1, float w2,
                                       float alpha, float beta, float gamma, int iters,
                                       void* feats, void* nb, void* m, void* unary, void* qtmp,
                                       void* out, void* stream) {
  if (frames > 0 && n > 0 && p > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* fe = static_cast<float*>(feats);
    float* nbv = static_cast<float*>(nb);
    __nv_bfloat16* mw = static_cast<__nv_bfloat16*>(m);
    float* u = static_cast<float*>(unary);
    float* bufs[2] = {static_cast<float*>(out), static_cast<float*>(qtmp)};
    const long count = static_cast<long>(frames) * n * p;
    feats_kernel<<<static_cast<unsigned>((static_cast<long>(frames) * n + kThreads - 1) /
                                         kThreads),
                   kThreads, 0, s>>>(static_cast<const unsigned char*>(imgs),
                                     static_cast<const float*>(ns), frames, n, w, alpha, beta,
                                     gamma, fe);
    rowsum_kernel<<<dim3((n + kThreads / 32 - 1) / (kThreads / 32), frames), kThreads, 0, s>>>(
        fe, n, w1, nbv);
    build_kernel<<<dim3((n + kBuildThreads - 1) / kBuildThreads,
                        (n + kBuildRows - 1) / kBuildRows, frames),
                   kBuildThreads, 0, s>>>(fe, nbv, n, w2, mw);
    // the last of iters + 1 writes must land in out
    int cur = iters % 2;
    init_kernel<<<static_cast<unsigned>((count + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        static_cast<const float*>(probs), count, u, bufs[cur]);
    for (int it = 0; it < iters; ++it) {
      iterate(mw, bufs[cur], u, frames, n, p, bufs[1 - cur], s);
      cur = 1 - cur;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
