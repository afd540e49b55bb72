// Normalized bilateral message matrix of the device CRF (kernel B2).
//
// Replaces critic_vae_tpu/crf/fused_build.py:97 build_bilateral (bodies
// `_k_tile`, `_rowsum_kernel`, `_build_kernel`). Per frame of N pixels:
//
//   K[i,j]   = exp(-1/2 |dxy/alpha|^2 - 1/2 |drgb/beta|^2)   for i != j, 0 on i == j
//   n_i      = sqrt(w1) * rsqrt(sum_j K[i,j] + 1e-20)
//   M[i,j]   = (n_i * n_j) * K[i,j]                          stored f32 or bf16
//
// What bounds it on Hopper: no matrix product is involved, so the tensor
// cores sit idle. The function must store M, 2 or 4 bytes an entry (33.5 MB a
// 64x64 frame in bf16: 0.64 ms for 64 frames at 3.35 TB/s), and needs one
// exp with ~15 f32 operations for each of the N(N-1)/2 distinct entries.
// The earlier design (a row-sum pass with one thread a row, then a store
// pass of 32-row tiles, 2-byte stores) computed every one of the N^2 entries'
// exp twice, once a pass, and was bound by those instructions: 2.904-2.937
// ms for C=64 bf16 on an H100 80GB HBM3 at 700 W, ~22% of the byte bound.
//
// What the design does about it: the symmetric-tile build of
// bilateral_tile.cuh. K is bitwise symmetric, so a block owns a tile pair
// (I, J), I <= J, computes each distinct entry's exp once a pass (half the
// exps of before), and writes M[I, J] and its transpose M[J, I] with 16-byte
// stores; the row sums go through per-tile partials in fixed slots, summed in
// slot order (deterministic, no atomics). Any N, f32 or bf16 output.
// Built without fast math: __expf and flush-to-zero would change the row sums
// of isolated pixels, whose off-diagonal terms underflow towards the 1e-20
// floor.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bilateral_tile.cuh"

// imgs: (C, N, 3) uint8 contiguous; feat: (C, 6, N rounded up to 64) f32
// scratch; part: (C, ceil(N / 64), N) f32 scratch; out: (C, N, N) f32
// (out_bf16 == 0) or bf16. Frames are h x w with N = h * w, pixel p at
// (x, y) = (p % w, p / w). Returns cudaGetLastError().
extern "C" int cvt_bilateral_build(const void* imgs, int frames, int n, int w,
                                   float w1, float alpha, float beta, void* feat,
                                   void* part, void* out, int out_bf16, void* stream) {
  if (frames > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned char* im = static_cast<const unsigned char*>(imgs);
    float* fe = static_cast<float*>(feat);
    float* pt = static_cast<float*>(part);
    if (out_bf16) {
      cvt::tile_build(im, frames, n, w, w1, alpha, beta, cvt::PlainEntry{}, fe, pt,
                      static_cast<__nv_bfloat16*>(out), s);
    } else {
      cvt::tile_build(im, frames, n, w, w1, alpha, beta, cvt::PlainEntry{}, fe, pt,
                      static_cast<float*>(out), s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
