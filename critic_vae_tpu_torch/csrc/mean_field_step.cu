// One iteration of the device CRF's mean field on a bf16 kernel K and its
// normalizers g (kernel mean_field_step; B2's pair, M = g g^T K): the
// bilateral message, the unaries and the softmax in one launch, which adds
// the spatial message that kernel spatial_message computes before it.
//
// Replaces, for a bf16 K on the card, the library calls of each iteration of
// crf/device.py::_mean_field_q (the JAX package's XLA dot, depthwise conv and
// softmax, critic_vae_tpu/crf/device.py:191 _mean_field_iterate and :225
// _mean_field_iterate_multi; no Pallas kernel): torch.bmm(K, bf16(g q), float32)
// (CUTLASS, a 256-wide tile for 2 lanes), the separable spatial conv in TF32
// on cuDNN with its NCHW permutes, and ~6 elementwise launches. Per frame of
// N = h w pixels with P = T L lanes (T sets of L classes):
//
//   y  = ns * q                                 f32, kept by the caller
//   s  = ns * (conv(y) - y)                     spatial message over j != i,
//                                               spatial_message.cu
//   z  = g * (K @ bf16(g q)) + w2 s - U          g per row, q per column
//   q' = softmax of z over each group of L lanes
//
// where conv is the taps' 1-D Gaussian along H, then along W, zero outside
// the frame (the taps clamp to it), and ns = rsqrt(conv(1) - 1 + 1e-20) of the
// same taps, which the caller passes in. A normalized M (the xla build's)
// runs with g = 1, which leaves every product and rounding as M's own.
//
// What bounds it: K's read. An iteration reads the chunk's C N^2 bf16 entries
// once (C = 64, N = 4096: 2.15 GB, 0.641 ms at 3.35 TB/s) and does 2 P8
// tensor-core operations an entry (P8 = the lanes padded to 8): at most 32 a
// byte against the card's 295. q, y, s, g and the unaries add ~0.4% to the
// bytes at P = 2.
//
// What the design does about it:
// * The product is kernel B5's row-block loop (row_block_product.cuh): a
//   block owns 128 rows of one frame, streams them once through two cp.async
//   stages, and sums K @ bf16(g q) for up to 64 lanes on mma.sync.m16n8k16 in
//   f32 registers. Wider q runs in lane groups on the grid's z axis, each a
//   whole number of softmax groups of L lanes; each group reads K once more.
// * The spatial message s comes from the caller, computed from the same y
//   just before the launch by kernel spatial_message (spatial_message.cu:
//   y read once, s written once). Computed here, in the epilogue, it would
//   stage the taps' halo of y rows for every lane, 32 image rows of 64 for a
//   block's 2 at radius 15: 7 lanes a round, 4 rounds at the threshold
//   sweep's 26 lanes, which the other block's stream does not hide.
// * The epilogue reuses the stages' shared memory once K is read: the sums,
//   times their row's g, go to a (128, lanes) f32 tile; the block's (lanes,
//   128) slab of s comes in at once by 16-byte cp.async and w2 s is added
//   into the tile; the softmax of each group of L lanes then reads the tile.
//   All in f32: no TF32, no permute.
// * It writes the next iteration's bf16 g q and f32 y = ns q, lane-major (C,
//   P, N) as the product's B operand and spatial_message want them, into the
//   other half of the caller's double buffer; on the last iteration only the
//   f32 marginals, (C, N, P).
// * No sum crosses a block and nothing is atomic: launches are bitwise
//   reproducible.
// Built without fast math: expf as torch.softmax's.
//
// Measured (an H100 80GB HBM3 at 700 W, C = 64, N = 4096, device time): an
// iteration, spatial_message and then the step, takes 0.7183-0.7186 ms at P =
// 2 (the step 0.708, spatial_message 0.011; 89% of the bound), 0.722-0.730
// at P = 3, 0.841-0.842 at P = 26 (the step 0.781, spatial_message 0.061).
// With s summed in the epilogue instead, on the same card: 0.7145, 0.725 and
// 1.041-1.042 ms. torch.bmm alone takes 0.795 ms at P = 2 and 0.841 at P =
// 26, the composition's iteration 1.108 and 1.819. Applying g (the step
// alone, in one call with the step before it on a normalized M): P = 2
// 0.6863-0.6867 ms against 0.6851-0.6865, P = 26 0.7627-0.7631 against
// 0.7605-0.7611.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "row_block_product.cuh"

namespace {

namespace rows = cvt::rows;
using rows::kBM;
using rows::kThreads;

constexpr int kGroupLanes = 8 * rows::kMaxTiles;  // the most lanes a block

// the epilogue's (kBM, 8 NT + 1) tile of sums (odd rows: conflict-free
// columns) and, in the rest of the stages' shared memory, the block's slab of
// s: room for 64 lanes at every NT
template <int NT>
__host__ __device__ constexpr int tile_ld() { return 8 * NT + 1; }
template <int NT>
__host__ __device__ constexpr int slab_words() {
  return rows::smem_bytes(NT) / 4 - kBM * tile_ld<NT>();
}
static_assert(slab_words<1>() == slab_words<rows::kMaxTiles>() &&
                  slab_words<1>() >= kGroupLanes * kBM,
              "the slab of s does not fit at every NT");

// grid (ceil(N / kBM), C, lane groups). k: (C, N, N) bf16; g: (C, N) f32;
// qb_in, qb_out: (C, P, N) bf16, g q; s_in: (C, P, N) f32, the spatial
// message of this iteration's y; y_out: (C, P, N) f32; unary, out: (C, N, P)
// f32; ns: (N,) f32.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
mean_field_step_kernel(const __nv_bfloat16* __restrict__ k, const float* __restrict__ g,
                       const __nv_bfloat16* __restrict__ qb_in, const float* __restrict__ s_in,
                       const float* __restrict__ unary, const float* __restrict__ ns, int n,
                       int p, int L, int group_lanes, float w2, int last,
                       __nv_bfloat16* __restrict__ qb_out, float* __restrict__ y_out,
                       float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long f = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int l0 = blockIdx.z * group_lanes;
  const int lanes = min(group_lanes, p - l0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float acc[NT][4];
  rows::product<NT>(k + f * n * n, qb_in + (f * p + l0) * n, n, row0, lanes,
                    reinterpret_cast<__nv_bfloat16*>(smem_raw), acc);
  __syncthreads();  // every warp is done with the stages: the epilogue reuses them

  constexpr int ld = tile_ld<NT>();
  float* z = reinterpret_cast<float*>(smem_raw);  // (kBM, ld): row r, lane l0 + c
  float* slab = z + kBM * ld;                     // (lanes, kBM): s of lane l0 + ls
  const float* gf = g + f * n;
  {
    // acc[t][c]: row 16 warp + gr + 8 (c >> 1), times that row's g
    const int gr = lane >> 2, q = lane & 3;
    float grow[2];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = row0 + warp * 16 + gr + 8 * hr;
      grow[hr] = r < n ? gf[r] : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        z[(warp * 16 + gr + 8 * (c >> 1)) * ld + t * 8 + 2 * q + (c & 1)] =
            grow[c >> 1] * acc[t][c];
  }

  // the block's (lanes, kBM) slab of s into the shared memory at once, 16
  // bytes a copy, then w2 s into the tile
  constexpr int kQuads = kBM / 4;
  const float* sf = s_in + (f * p + l0) * n;
  for (int e = tid; e < lanes * kQuads; e += kThreads) {
    const int ls = e / kQuads, i = 4 * (e - ls * kQuads);
    const bool ok = row0 + i < n;  // n % 8 == 0: a quad is whole or absent
    cvt::cp_async16(slab + ls * kBM + i, ok ? sf + static_cast<long long>(ls) * n + row0 + i : sf,
                    ok);
  }
  cvt::cp_async_commit();
  cvt::cp_async_wait<0>();
  __syncthreads();  // the tile and the slab are in
  for (int e = tid; e < lanes * kBM; e += kThreads) {
    const int ls = e / kBM, r = e - ls * kBM;
    if (row0 + r < n) z[r * ld + ls] += w2 * slab[ls * kBM + r];
  }
  __syncthreads();

  // the softmax of each group of L lanes: max, exp, sum, divide, as torch's
  for (int e = tid; e < (lanes / L) * kBM; e += kThreads) {
    const int gi = e / kBM, r = e - gi * kBM;
    const int pix = row0 + r;
    if (pix >= n) continue;
    float* zr = z + r * ld + gi * L;
    const long long base = (f * n + pix) * p + l0 + gi * L;
    float mx = -INFINITY;
    for (int c = 0; c < L; ++c) {
      zr[c] -= unary[base + c];
      mx = cvt::nan_max(mx, zr[c]);
    }
    float sum = 0.0f;
    for (int c = 0; c < L; ++c) {
      zr[c] = expf(zr[c] - mx);
      sum += zr[c];
    }
    const float nsp = ns[pix], gp = gf[pix];
    for (int c = 0; c < L; ++c) {
      const float qv = zr[c] / sum;
      if (last) {
        out[base + c] = qv;
      } else {
        const long long qi = (f * p + l0 + gi * L + c) * n + pix;
        qb_out[qi] = __float2bfloat16_rn(gp * qv);
        y_out[qi] = nsp * qv;
      }
    }
  }
}

template <int NT>
void launch(dim3 grid, cudaStream_t s, const __nv_bfloat16* k, const float* g,
            const __nv_bfloat16* qb_in, const float* s_in, const float* unary, const float* ns,
            int n, int p, int L, int group_lanes, float w2, int last, __nv_bfloat16* qb_out,
            float* y_out, float* out) {
  constexpr int smem = rows::smem_bytes(NT);
  auto* kernel = mean_field_step_kernel<NT>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, kThreads, smem, s>>>(k, g, qb_in, s_in, unary, ns, n, p, L, group_lanes, w2,
                                      last, qb_out, y_out, out);
}

}  // namespace

// k: (C, N, N) bf16, N % 8 == 0; g: (C, N) f32; qb_in, qb_out: (C, P, N)
// bf16, g q; s_in: (C, P, N) f32, the spatial message of the iteration's y
// (spatial_message.cu); y_out: (C, P, N) f32; unary, out: (C, N, P) f32; ns:
// (N,) f32. P % L == 0 and L <= 64 (a softmax group lies in one block's
// lanes); C <= 65535. last == 0 writes qb_out = bf16(g q') and y_out = ns q',
// last != 0 writes out. All contiguous, s_in 16-byte aligned.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments outside
// these limits.
extern "C" int cvt_mean_field_step(const void* k, const void* g, const void* qb_in,
                                   const void* s_in, const void* unary, const void* ns,
                                   int frames, int n, int p, int L, float w2, int last,
                                   void* qb_out, void* y_out, void* out, void* stream) {
  if (frames <= 0 || n <= 0 || p <= 0) return static_cast<int>(cudaGetLastError());
  if (n % 8 || L <= 0 || L > kGroupLanes || p % L || frames > 65535 ||
      reinterpret_cast<uintptr_t>(s_in) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group_lanes = kGroupLanes / L * L;
  const int tiles = (min(group_lanes, p) + 7) / 8;
  const dim3 grid((n + kBM - 1) / kBM, frames, (p + group_lanes - 1) / group_lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* gv = static_cast<const float*>(g);
  const auto* qi = static_cast<const __nv_bfloat16*>(qb_in);
  const auto* si = static_cast<const float*>(s_in);
  const auto* u = static_cast<const float*>(unary);
  const auto* nsf = static_cast<const float*>(ns);
  auto* qo = static_cast<__nv_bfloat16*>(qb_out);
  auto* yo = static_cast<float*>(y_out);
  auto* o = static_cast<float*>(out);
#define CVT_STEP(NT)                                                                        \
  case NT:                                                                                  \
    launch<NT>(grid, s, kb, gv, qi, si, u, nsf, n, p, L, group_lanes, w2, last, qo, yo, o); \
    break;
  switch (tiles) {
    CVT_STEP(1) CVT_STEP(2) CVT_STEP(3) CVT_STEP(4)
    CVT_STEP(5) CVT_STEP(6) CVT_STEP(7) CVT_STEP(8)
  }
#undef CVT_STEP
  return static_cast<int>(cudaGetLastError());
}
