// One iteration of the device CRF's mean field on a bf16 M (kernel
// mean_field_step): the bilateral message, the spatial message, the unaries
// and the softmax in one launch.
//
// Replaces, for a bf16 M on the card, the library calls of each iteration of
// crf/device.py::_mean_field_q (the JAX package's XLA dot, depthwise conv and
// softmax, critic_vae_tpu/crf/device.py:191 _mean_field_iterate and :225
// _mean_field_iterate_multi; no Pallas kernel): torch.bmm(M, bf16(q), float32)
// (CUTLASS, a 256-wide tile for 2 lanes), the separable spatial conv in TF32
// on cuDNN with its NCHW permutes, and ~6 elementwise launches. Per frame of
// N = h w pixels with P = T L lanes (T sets of L classes):
//
//   y  = ns * q                                 f32, kept by the caller
//   s  = ns * (conv(y) - y)                     spatial message over j != i
//   z  = M @ bf16(q) + w2 s - U
//   q' = softmax of z over each group of L lanes
//
// where conv is the taps' 1-D Gaussian along H, then along W, zero outside
// the frame (the taps clamp to it), and ns = rsqrt(conv(1) - 1 + 1e-20) of the
// same taps, which the caller passes in.
//
// What bounds it: M's read. An iteration reads the chunk's C N^2 bf16 entries
// once (C = 64, N = 4096: 2.15 GB, 0.641 ms at 3.35 TB/s) and does 2 P8
// tensor-core operations an entry (P8 = the lanes padded to 8): at most 32 a
// byte against the card's 295. q, y and the unaries add ~0.3% to the bytes at
// P = 2.
//
// What the design does about it:
// * The product is kernel B5's row-block loop (row_block_product.cuh): a
//   block owns 128 rows of one frame, streams them once through two cp.async
//   stages, and sums M @ bf16(q) for up to 64 lanes on mma.sync.m16n8k16 in
//   f32 registers. Wider q runs in lane groups on the grid's z axis, each a
//   whole number of softmax groups of L lanes; each group reads M once more.
// * The epilogue reuses the stages' shared memory once M is read: the sums
//   go to a (128, lanes) f32 tile; the f32 y of the block's image rows and
//   the taps' radius around them is staged into shared memory (each value
//   read once, lanes in slices that fit), the column pass sums it into the
//   block's rows, the row pass sums those and adds w2 s into the tile; the
//   softmax of each group of L lanes then reads the tile. All in f32 FMAs:
//   no TF32, no permute.
// * It writes the next iteration's bf16 q and f32 y, lane-major (C, P, N) as
//   the product's B operand wants them, into the other half of the caller's
//   double buffer; on the last iteration only the f32 marginals, (C, N, P).
// * No sum crosses a block and nothing is atomic: launches are bitwise
//   reproducible.
// Built without fast math: expf as torch.softmax's.
//
// Measured (an H100 80GB HBM3 at 700 W, C = 64, N = 4096): 0.693 ms a launch
// at P = 2, 92.5% of the bound (torch.bmm alone 0.795 ms, the composition's
// iteration 1.108 ms); 0.698 ms at P = 3; 1.020 ms at P = 26 (bmm alone
// 0.841, the composition 1.819), where the epilogue's shared-memory passes
// over 26 lanes take ~0.26 ms that the other block's stream does not hide.

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
// columns) and, in the rest of the stages' shared memory, the column pass's
// f32 words: the same at every NT
template <int NT>
__host__ __device__ constexpr int tile_ld() { return 8 * NT + 1; }
template <int NT>
__host__ __device__ constexpr int col_words() {
  return rows::smem_bytes(NT) / 4 - kBM * tile_ld<NT>();
}
constexpr int kColWords = col_words<1>();
static_assert(col_words<rows::kMaxTiles>() == kColWords, "the column pass's room varies");

// grid (ceil(N / kBM), C, lane groups). qb_in, qb_out: (C, P, N) bf16; y_in,
// y_out: (C, P, N) f32; unary, out: (C, N, P) f32; ns: (N,) f32; taps: (2
// radius + 1,) f32.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
mean_field_step_kernel(const __nv_bfloat16* __restrict__ m,
                       const __nv_bfloat16* __restrict__ qb_in, const float* __restrict__ y_in,
                       const float* __restrict__ unary, const float* __restrict__ ns,
                       const float* __restrict__ taps, int radius, int n, int w, int p, int L,
                       int group_lanes, float w2, int last, __nv_bfloat16* __restrict__ qb_out,
                       float* __restrict__ y_out, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long f = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int l0 = blockIdx.z * group_lanes;
  const int lanes = min(group_lanes, p - l0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float acc[NT][4];
  rows::product<NT>(m + f * n * n, qb_in + (f * p + l0) * n, n, row0, lanes,
                    reinterpret_cast<__nv_bfloat16*>(smem_raw), acc);
  __syncthreads();  // every warp is done with the stages: the epilogue reuses them

  constexpr int ld = tile_ld<NT>();
  float* z = reinterpret_cast<float*>(smem_raw);  // (kBM, ld): row r, lane l0 + c
  float* col = z + kBM * ld;                      // kColWords
  {
    const int g = lane >> 2, q = lane & 3;
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        z[(warp * 16 + g + 8 * (c >> 1)) * ld + t * 8 + 2 * q + (c & 1)] = acc[t][c];
  }

  // the spatial message. The block's pixels lie in `span` words of whole
  // image rows from row y_lo; their column sums need y's rows r_lo .. r_hi.
  // A pass takes `slice` lanes: it stages their rows into shared memory, a
  // window of `win` rows at a time (each y value read once), and sums the
  // taps in ascending order into col, carried from window to window.
  const int h = n / w;
  const int y_lo = row0 / w, y_hi = (min(row0 + kBM, n) - 1) / w;
  const int span = (y_hi - y_lo + 1) * w;
  const int r_lo = max(0, y_lo - radius), r_hi = min(h - 1, y_hi + radius);
  int slice = min(lanes, kColWords / (span + (r_hi - r_lo + 1) * w));
  int win = r_hi - r_lo + 1;
  if (slice == 0) {  // one lane, its rows in windows (the host keeps span + w in room)
    slice = 1;
    win = (kColWords - span) / w;
  }
  float* rows_s = col + slice * span;  // (slice, win rows, w)
  const float* yf = y_in + (f * p + l0) * n;
  for (int s0 = 0; s0 < lanes; s0 += slice) {
    const int sl = min(slice, lanes - s0);
    for (int a = r_lo; a <= r_hi; a += win) {
      const int nw = min(win, r_hi + 1 - a) * w;  // words a lane in this window
      __syncthreads();  // the tile is in; the last window and pass are done
      for (int e = tid; e < sl * nw; e += kThreads) {  // all in flight at once
        const int ls = e / nw, i = e - ls * nw;
        const long long src = static_cast<long long>(s0 + ls) * n + static_cast<long long>(a) * w;
        cvt::cp_async4(rows_s + ls * win * w + i, yf + src + i);
      }
      cvt::cp_async_commit();
      cvt::cp_async_wait<0>();
      __syncthreads();
      for (int e = tid; e < sl * span; e += kThreads) {
        const int ls = e / span, rem = e - ls * span;
        const int yy = y_lo + rem / w, x = rem % w;
        // taps k whose row yy + k - radius lies in the window [a, a + nw / w)
        const int k0 = max(0, a - yy + radius);
        const int k1 = min(2 * radius, a + nw / w - 1 - yy + radius);
        const float* rl = rows_s + ls * win * w + x;
        float sum = a == r_lo ? 0.0f : col[e];
#pragma unroll 8
        for (int k = k0; k <= k1; ++k)
          sum = fmaf(__ldg(taps + k), rl[(yy + k - radius - a) * w], sum);
        col[e] = sum;
      }
    }
    __syncthreads();
    for (int e = tid; e < sl * kBM; e += kThreads) {
      const int ls = e / kBM, r = e - ls * kBM;
      const int pix = row0 + r;
      if (pix >= n) continue;
      const int yy = pix / w, x = pix - yy * w;
      const float* cl = col + ls * span + (yy - y_lo) * w;
      const int k0 = max(0, radius - x), k1 = min(2 * radius, w - 1 - x + radius);
      float sum = 0.0f;
#pragma unroll 8
      for (int k = k0; k <= k1; ++k) sum = fmaf(__ldg(taps + k), cl[x + k - radius], sum);
      const float sp = ns[pix] * (sum - yf[static_cast<long long>(s0 + ls) * n + pix]);
      z[r * ld + s0 + ls] += w2 * sp;
    }
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
    for (int k = 0; k < L; ++k) {
      zr[k] -= unary[base + k];
      mx = cvt::nan_max(mx, zr[k]);
    }
    float sum = 0.0f;
    for (int k = 0; k < L; ++k) {
      zr[k] = expf(zr[k] - mx);
      sum += zr[k];
    }
    const float nsp = ns[pix];
    for (int k = 0; k < L; ++k) {
      const float qv = zr[k] / sum;
      if (last) {
        out[base + k] = qv;
      } else {
        const long long qi = (f * p + l0 + gi * L + k) * n + pix;
        qb_out[qi] = __float2bfloat16_rn(qv);
        y_out[qi] = nsp * qv;
      }
    }
  }
}

template <int NT>
void launch(dim3 grid, cudaStream_t s, const __nv_bfloat16* m, const __nv_bfloat16* qb_in,
            const float* y_in, const float* unary, const float* ns, const float* taps,
            int radius, int n, int w, int p, int L, int group_lanes, float w2, int last,
            __nv_bfloat16* qb_out, float* y_out, float* out) {
  constexpr int smem = rows::smem_bytes(NT);
  cudaFuncSetAttribute(mean_field_step_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  mean_field_step_kernel<NT><<<grid, kThreads, smem, s>>>(m, qb_in, y_in, unary, ns, taps,
                                                          radius, n, w, p, L, group_lanes, w2,
                                                          last, qb_out, y_out, out);
}

}  // namespace

// m: (C, N, N) bf16, N % 8 == 0, N = h w; qb_in, qb_out: (C, P, N) bf16;
// y_in, y_out: (C, P, N) f32; unary, out: (C, N, P) f32; ns: (N,) f32; taps:
// (2 radius + 1,) f32. P % L == 0 and L <= 64 (a softmax group lies in one
// block's lanes); w <= 5376 (a pass holds, for a lane, the image rows of a
// block's 128 pixels, at most 2 w + 126 words, and a row of y); C <= 65535.
// last == 0 writes qb_out and y_out, last != 0 writes out. All contiguous.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments outside
// these limits.
extern "C" int cvt_mean_field_step(const void* m, const void* qb_in, const void* y_in,
                                   const void* unary, const void* ns, const void* taps,
                                   int radius, int frames, int n, int w, int p, int L, float w2,
                                   int last, void* qb_out, void* y_out, void* out,
                                   void* stream) {
  if (frames <= 0 || n <= 0 || p <= 0) return static_cast<int>(cudaGetLastError());
  if (n % 8 || w <= 0 || n % w || L <= 0 || L > kGroupLanes || p % L || radius < 0 ||
      3 * w + kBM > kColWords || frames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int group_lanes = kGroupLanes / L * L;
  const int tiles = (min(group_lanes, p) + 7) / 8;
  const dim3 grid((n + kBM - 1) / kBM, frames, (p + group_lanes - 1) / group_lanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* mb = static_cast<const __nv_bfloat16*>(m);
  const auto* qi = static_cast<const __nv_bfloat16*>(qb_in);
  const auto* yi = static_cast<const float*>(y_in);
  const auto* u = static_cast<const float*>(unary);
  const auto* nsf = static_cast<const float*>(ns);
  const auto* tp = static_cast<const float*>(taps);
  auto* qo = static_cast<__nv_bfloat16*>(qb_out);
  auto* yo = static_cast<float*>(y_out);
  auto* o = static_cast<float*>(out);
#define CVT_STEP(NT)                                                                         \
  case NT:                                                                                   \
    launch<NT>(grid, s, mb, qi, yi, u, nsf, tp, radius, n, w, p, L, group_lanes, w2, last, qo, \
               yo, o);                                                                       \
    break;
  switch (tiles) {
    CVT_STEP(1) CVT_STEP(2) CVT_STEP(3) CVT_STEP(4)
    CVT_STEP(5) CVT_STEP(6) CVT_STEP(7) CVT_STEP(8)
  }
#undef CVT_STEP
  return static_cast<int>(cudaGetLastError());
}
