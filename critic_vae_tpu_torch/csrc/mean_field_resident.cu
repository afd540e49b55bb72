// Resident-matrix dense-CRF mean field of the device CRF's vmem build
// (kernel B5).
//
// Replaces critic_vae_tpu/crf/fused_resident.py:226 mean_field_resident
// (body `_resident_kernel`, called from `_resident_chunk`). Per frame of N
// pixels with P = 2T lanes, T (neg, pos) class pairs that share the frame:
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
// in 128 MiB of VMEM; a Hopper block has 227 KB of shared memory, so M lives
// in a device workspace of the whole chunk. An iteration then reads M once,
// 2 bytes an entry, and does 2 P8 operations an entry (P8 = P padded to 8
// lanes): at most 32 per byte against the card's 295 bf16 operations a byte,
// so on the tensor cores every iteration is bound by M's read (0.64 ms for
// 64 frames at 3.35 TB/s), the build by its exps and its store of M.
//
// The earlier design (an H100 80GB HBM3 at 700 W, C=64, N=4096, 10
// iterations): 12.1-12.4 ms at T=1 and 66.5-67.6 ms at T=13 a chunk. Its
// iteration multiplied M by q as scalar f32 FMAs on the CUDA cores, P FMAs
// per entry in groups of at most 32 lanes a launch: at T=13 it ran 558
// GFLOP at ~8.7 TFLOP/s, 7.5 times slower than one torch.bmm of the same
// product. Its build copied B2's earlier two passes and took each exp twice.
//
// What the design does about it:
// * The build is the symmetric-tile build of bilateral_tile.cuh (shared with
//   B2): one exp of k per distinct entry a pass, per-tile row partials in
//   fixed slots (deterministic), 16-byte stores of M[I, J] and, through
//   shared memory, M[J, I]. Its entry policy folds in the spatial term with
//   its own expf (no per-|dx|, |dy| table) and rounds twice, as above.
// * q is kept as bf16 in a lane-major (C, P8, N) layout, padded lanes zero,
//   double-buffered across iterations, so it is the B operand of
//   mma.sync.m16n8k16 as it stands.
// * One product kernel for all P8 <= 64 lanes (8 n-tiles; wider q runs in
//   groups of 64): a block owns 128 rows of one frame, 8 warps of 16 rows,
//   and walks all N columns in 128-column stages. M and q stream through two
//   cp.async stages in shared memory (16-byte chunks, XOR-swizzled so
//   ldmatrix is conflict-free; with two blocks an SM, 3-4 stages of 64 or
//   128 columns measured slower); A fragments from ldmatrix, f32 sums in
//   registers, so M is read exactly once an iteration for all T and no sum
//   crosses a block (deterministic).
// * The pair softmax is the epilogue: a (neg, pos) pair sits in one thread's
//   two accumulator columns, so it stays in registers; it writes the next
//   bf16 q and, on the last iteration, the f32 marginals. Padded lanes are
//   never written.
// * The whole-chunk workspace is kept: one frame at a time in the L2
//   measured slower with the earlier design.
// Built without fast math: __expf would change the row sums of isolated
// pixels and the sigmoid of saturated logits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilateral_tile.cuh"  // includes mma_bf16.cuh

namespace {

constexpr float kEpsProb = 1e-8f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // rows a block
constexpr int kBK = 128;          // columns a stage: 256 bytes a row
constexpr int kChunks = kBK / 8;  // 16-byte chunks a row of a stage
constexpr int kStages = 2;
constexpr int kMaxTiles = 8;      // n-tiles of 8 lanes a launch

__device__ __forceinline__ float sigmoid(float x) { return 1.0f / (1.0f + expf(-x)); }

// B5's entry: the bilateral term rounded through bf16, plus the spatial term;
// its planes are sqrt(w2) ns, x/gamma, y/gamma
struct ResidentEntry {
  static constexpr int kExtra = 3;
  const float* ns;
  float sw2, gamma;
  int w;
  __device__ __forceinline__ void load(int p, float* e) const {
    e[0] = sw2 * ns[p];
    e[1] = static_cast<float>(p % w) / gamma;
    e[2] = static_cast<float>(p / w) / gamma;
  }
  // off the diagonal tiles logs < 0; the diagonal's mask as in k_bilateral
  template <bool kDiag>
  __device__ __forceinline__ float value(float nbi, float nbj, float k, const float* ei,
                                         const float* ej) const {
    const float dg0 = ei[1] - ej[1], dg1 = ei[2] - ej[2];
    const float logs = -0.5f * (dg0 * dg0 + dg1 * dg1);
    const float ks = kDiag ? expf(logs) * static_cast<float>(logs < 0.0f) : expf(logs);
    return (nbi * nbj) * cvt::bf16_round(k) + (ei[0] * ej[0]) * ks;
  }
};

// over frames * N * ldq entries, lane fastest: the unary, bf16 q0 =
// pair_softmax(-U) into qb0 (zero in the padded lanes of both buffers), and
// with write_out the f32 q0 as the marginals (iters == 0)
__global__ void init_kernel(const float* __restrict__ probs, int n, int p, int ldq,
                            long long count, int write_out, float* __restrict__ unary,
                            __nv_bfloat16* __restrict__ qb0, __nv_bfloat16* __restrict__ qb1,
                            float* __restrict__ out) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= count) return;
  const long long fi = e / ldq;  // frame * n + pixel
  const int l = static_cast<int>(e - fi * ldq);
  const long long f = fi / n;
  const long long qi = (f * ldq + l) * n + (fi - f * n);
  if (l >= p) {
    qb0[qi] = __float2bfloat16_rn(0.0f);
    qb1[qi] = __float2bfloat16_rn(0.0f);
    return;
  }
  const long long pe = fi * p + l;
  const float u = -logf(fmaxf(probs[pe], kEpsProb));
  const float up = -logf(fmaxf(probs[pe ^ 1], kEpsProb));  // P even: pe ^ 1 is the pair
  unary[pe] = u;
  const float q = sigmoid(-u - -up);
  qb0[qi] = __float2bfloat16_rn(q);
  if (write_out) out[pe] = q;
}

__host__ __device__ constexpr int stage_elems(int nt) { return (kBM + 8 * nt) * kBK; }

// grid (ceil(N / kBM), C): lanes [l0, l0 + 8 NT) of one iteration,
// q = pair_softmax(M @ qb_in - U) -> qb_out (bf16) and, if last, out (f32).
// qb_*: (C, ldq, N) bf16; unary, out: (C, N, p) f32.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
product_kernel(const __nv_bfloat16* __restrict__ m, const __nv_bfloat16* __restrict__ qb_in,
               const float* __restrict__ unary, int n, int p, int ldq, int l0, int last,
               __nv_bfloat16* __restrict__ qb_out, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* smem = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  const long long f = blockIdx.y;
  const int row0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const __nv_bfloat16* mf = m + f * n * n;
  const __nv_bfloat16* qf = qb_in + (f * ldq + l0) * n;
  const int ktiles = (n + kBK - 1) / kBK;

  // stage s <- columns [kt kBK, (kt + 1) kBK) of the block's M rows and of
  // q's lanes; 16-byte chunk c of row r lands at chunk c ^ (r % 8)
  auto load = [&](int s, int kt) {
    __nv_bfloat16* sa = smem + s * stage_elems(NT);
    __nv_bfloat16* sb = sa + kBM * kBK;
    const int j0 = kt * kBK;
    for (int e = tid; e < kBM * kChunks; e += kThreads) {
      const int r = e / kChunks, ch = e % kChunks;
      const int row = row0 + r, col = j0 + ch * 8;
      const bool ok = row < n && col < n;  // N % 8 == 0: a chunk is whole or absent
      cvt::cp_async16(sa + r * kBK + ((ch ^ (r & 7)) * 8),
                      ok ? mf + static_cast<long long>(row) * n + col : mf, ok);
    }
    for (int e = tid; e < 8 * NT * kChunks; e += kThreads) {
      const int l = e / kChunks, ch = e % kChunks;
      const int col = j0 + ch * 8;
      const bool ok = col < n;
      cvt::cp_async16(sb + l * kBK + ((ch ^ (l & 7)) * 8),
                      ok ? qf + static_cast<long long>(l) * n + col : qf, ok);
    }
  };

  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[t][c] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ktiles) load(s, s);
    cvt::cp_async_commit();
  }
  const int ar = warp * 16 + (lane & 15);  // this lane's ldmatrix row of A
  for (int kt = 0; kt < ktiles; ++kt) {
    cvt::cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt is in; every warp is done with stage kt - 1
    if (kt + kStages - 1 < ktiles) load((kt + kStages - 1) % kStages, kt + kStages - 1);
    cvt::cp_async_commit();
    const __nv_bfloat16* sa = smem + (kt % kStages) * stage_elems(NT);
    const __nv_bfloat16* sb = sa + kBM * kBK;
#pragma unroll
    for (int kp = 0; kp < kBK / 32; ++kp) {
      // B fragments of two k-steps: matrices = 16-byte chunks 4 kp .. 4 kp + 3
      uint32_t b[NT][4];
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int br = t * 8 + (lane & 7);
        cvt::ldmatrix_x4(b[t], sb + br * kBK + (((4 * kp + (lane >> 3)) ^ (br & 7)) * 8));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = 2 * kp + h;
        uint32_t a[4];
        cvt::ldmatrix_x4(a, sa + ar * kBK + (((2 * ks + (lane >> 4)) ^ (ar & 7)) * 8));
#pragma unroll
        for (int t = 0; t < NT; ++t)
          cvt::mma_bf16_16816(acc[t], a[0], a[1], a[2], a[3], b[t][2 * h], b[t][2 * h + 1]);
      }
    }
  }
  cvt::cp_async_wait<0>();

  // acc[t]: rows g and g + 8 of the warp's 16, lanes 8t + 2q and 8t + 2q + 1,
  // one (neg, pos) pair
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int l = l0 + t * 8 + 2 * q;
    if (l >= p) continue;  // a padded pair
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = row0 + warp * 16 + g + 8 * hr;
      if (row >= n) continue;
      const long long base = (f * n + row) * p + l;
      const float z0 = acc[t][2 * hr] - unary[base];
      const float z1 = acc[t][2 * hr + 1] - unary[base + 1];
      const float q0 = sigmoid(z0 - z1), q1 = sigmoid(z1 - z0);
      qb_out[(f * ldq + l) * n + row] = __float2bfloat16_rn(q0);
      qb_out[(f * ldq + l + 1) * n + row] = __float2bfloat16_rn(q1);
      if (last) {
        out[base] = q0;
        out[base + 1] = q1;
      }
    }
  }
}

template <int NT>
void launch_product(const __nv_bfloat16* m, const __nv_bfloat16* qb_in, const float* unary,
                    int frames, int n, int p, int ldq, int l0, int last,
                    __nv_bfloat16* qb_out, float* out, cudaStream_t s) {
  constexpr int smem = kStages * stage_elems(NT) * static_cast<int>(sizeof(__nv_bfloat16));
  cudaFuncSetAttribute(product_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  product_kernel<NT><<<dim3((n + kBM - 1) / kBM, frames), kThreads, smem, s>>>(
      m, qb_in, unary, n, p, ldq, l0, last, qb_out, out);
}

void product(const __nv_bfloat16* m, const __nv_bfloat16* qb_in, const float* unary,
             int frames, int n, int p, int ldq, int last, __nv_bfloat16* qb_out, float* out,
             cudaStream_t s) {
  for (int l0 = 0; l0 < p; l0 += 8 * kMaxTiles) {
    const int tiles = (min(8 * kMaxTiles, p - l0) + 7) / 8;
#define CVT_PRODUCT(NT) \
  case NT: launch_product<NT>(m, qb_in, unary, frames, n, p, ldq, l0, last, qb_out, out, s); break;
    switch (tiles) {
      CVT_PRODUCT(1) CVT_PRODUCT(2) CVT_PRODUCT(3) CVT_PRODUCT(4)
      CVT_PRODUCT(5) CVT_PRODUCT(6) CVT_PRODUCT(7) CVT_PRODUCT(8)
    }
#undef CVT_PRODUCT
  }
}

}  // namespace

// imgs: (C, N, 3) uint8; probs: (C, N, P) f32, P even; ns: (N,) f32, N % 8
// == 0. Workspace: feat (C, 9, N rounded up to 64) f32, part (C, ceil(N /
// 64), N) f32, m (C, N, N) bf16, unary (C, N, P) f32, qb (2, C, ldq, N) bf16
// with ldq = P rounded up to a multiple of 8; out (C, N, P) f32 gets the
// marginals. All contiguous,
// C <= 65535. Frames are h x w with N = h * w, pixel p at (x, y) = (p % w,
// p / w). Returns cudaGetLastError().
extern "C" int cvt_mean_field_resident(const void* imgs, const void* probs, const void* ns,
                                       int frames, int n, int w, int p, float w1, float w2,
                                       float alpha, float beta, float gamma, int iters,
                                       void* feat, void* part, void* m, void* unary, void* qb,
                                       void* out, void* stream) {
  if (frames > 0 && n > 0 && p > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int ldq = (p + 7) / 8 * 8;
    __nv_bfloat16* mw = static_cast<__nv_bfloat16*>(m);
    float* u = static_cast<float*>(unary);
    float* o = static_cast<float*>(out);
    __nv_bfloat16* q[2] = {static_cast<__nv_bfloat16*>(qb),
                           static_cast<__nv_bfloat16*>(qb) + static_cast<long long>(frames) *
                                                                 ldq * n};
    const ResidentEntry entry{static_cast<const float*>(ns), sqrtf(w2), gamma, w};
    cvt::tile_build(static_cast<const unsigned char*>(imgs), frames, n, w, w1, alpha, beta,
                    entry, static_cast<float*>(feat), static_cast<float*>(part), mw, s);
    const long long count = static_cast<long long>(frames) * n * ldq;
    init_kernel<<<static_cast<unsigned>((count + kThreads - 1) / kThreads), kThreads, 0, s>>>(
        static_cast<const float*>(probs), n, p, ldq, count, iters == 0, u, q[0], q[1], o);
    for (int it = 0; it < iters; ++it)
      product(mw, q[it % 2], u, frames, n, p, ldq, it == iters - 1, q[1 - it % 2], o, s);
  }
  return static_cast<int>(cudaGetLastError());
}
