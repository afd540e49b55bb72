// The device CRF's bilateral kernel and its normalizers (kernel B2).
//
// Replaces critic_vae_tpu/crf/fused_build.py:97 build_bilateral (bodies
// `_k_tile`, `_rowsum_kernel`, `_build_kernel`), whose normalized matrix
// M = g g^T K the mean field now applies as g * (K @ (g * q)). Per frame of
// N pixels:
//
//   K[i,j]   = exp(-1/2 |dxy/alpha|^2 - 1/2 |drgb/beta|^2)   for i != j, 0 on i == j
//   g_i      = sqrt(w1) * rsqrt(sum_j K[i,j] + 1e-20)
//
// K stored f32 or bf16, g f32.
//
// What bounds it on Hopper: no matrix product is involved, so the tensor
// cores sit idle. The function must store K, 2 or 4 bytes an entry (33.5 MB a
// 64x64 frame in bf16: 0.64 ms for 64 frames at 3.35 TB/s), and needs one
// exp with ~15 f32 operations for each of the N(N-1)/2 distinct entries.
// Earlier designs stored M normalized, so its store needed g first: a
// row-sum pass with one thread a row, then a store pass of 32-row tiles with
// 2-byte stores, each computing all N^2 exps (2.904-2.937 ms for C=64 bf16
// on an H100 80GB HBM3 at 700 W, ~22% of the byte bound); then the
// symmetric-tile build's row-sum and store passes, each computing the
// N(N-1)/2 distinct exps (1.27-1.32 ms, ~50%), the row-sum pass 0.495 ms of
// it.
//
// What the design does about it: K is stored as it is, so the store need
// not wait for g, and one pass computes each distinct exp once. The
// symmetric-tile build of bilateral_tile.cuh: K is bitwise symmetric, so a
// block owns a tile pair (I, J), I <= J, writes K[I, J] and its transpose
// K[J, I] with 16-byte stores, and adds each entry into its tile's row and
// column partials, which go to fixed slots; a second small kernel sums a
// row's slots in slot order into g (deterministic, no atomics). Three
// launches: the features, the summing store, g. Any N, f32 or bf16 K.
// Built without fast math: __expf and flush-to-zero would change the row sums
// of isolated pixels, whose off-diagonal terms underflow towards the 1e-20
// floor.
//
// The summing store's blocks an SM (bilateral_tile.cuh, kSumsBlocksBf16 and
// kSumsBlocksF32), measured on an H100 80GB HBM3 at 700 W, C = 64, N =
// 4096, device time a launch, registers and spills by ptxas -v: bf16 at 5,
// 96 registers, no spills, 0.880-0.896 ms (72-73% of the byte bound); 4
// blocks take 126 registers and 0.917 ms, and 6 or 7 spill (with the
// entries kept as floats to the end, 8 or 28 bytes and 0.870 or 0.921 ms;
// packed, 48 or 170 bytes and 0.925 or 1.777 ms). f32 at 2, 124 registers,
// no spills, 1.402 ms; 3 and 4 spill and take 1.47 and 1.55 ms. Of a bf16
// launch the features take 0.004 ms and g 0.032. The build before, four
// kernels: 1.287-1.291 ms (bf16) and 1.899 (f32), its row-sum pass
// 0.512-0.516 of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "bilateral_tile.cuh"

// imgs: (C, N, 3) uint8 contiguous; feat: (C, 6, N rounded up to 64) f32
// scratch; part: (C, ceil(N / 64), N) f32 scratch; k: (C, N, N) f32
// (out_bf16 == 0) or bf16; g: (C, N) f32. Frames are h x w with N = h * w,
// pixel p at (x, y) = (p % w, p / w). Returns cudaGetLastError().
extern "C" int cvt_bilateral_build(const void* imgs, int frames, int n, int w,
                                   float w1, float alpha, float beta, void* feat,
                                   void* part, void* k, void* g, int out_bf16, void* stream) {
  if (frames > 0 && n > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const unsigned char* im = static_cast<const unsigned char*>(imgs);
    float* fe = static_cast<float*>(feat);
    float* pt = static_cast<float*>(part);
    float* gv = static_cast<float*>(g);
    if (out_bf16) {
      cvt::tile_build_sums(im, frames, n, w, w1, alpha, beta, fe, pt,
                           static_cast<__nv_bfloat16*>(k), gv, s);
    } else {
      cvt::tile_build_sums(im, frames, n, w, w1, alpha, beta, fe, pt, static_cast<float*>(k),
                           gv, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
