// Symmetric-tile build of the device CRF's bilateral kernel, shared by
// kernels B2 (bilateral_build.cu) and B5 (mean_field_resident.cu); kernel
// B3 (kernel_i8_build.cu) runs its pieces in one pass of its own.
//
//   K[i,j] = exp(-1/2 |dxy/alpha|^2 - 1/2 |drgb/beta|^2)   i != j, 0 on i == j
//   nb_i   = sqrt(w1) * rsqrt(sum_j K[i,j] + 1e-20)
//
// B2 stores K itself (bf16 or f32) and nb as a (C, N) f32 vector g; the mean
// field applies g to its vector (M = g g^T K). B5 stores
// M[i,j] = entry(nb_i, nb_j, K[i,j], i, j) in bf16.
//
// K is bitwise symmetric as computed here: fi - fj is exactly -(fj - fi) in
// IEEE arithmetic, the squares are equal, and their sums run in the same
// order for (i, j) and (j, i); the entry policies only multiply and add
// per-pixel factors, which commute. So every distinct entry needs its exp
// once a pass. The pixels fall into 64-pixel tiles; a block owns a row tile
// I and a strip of up to kStrip column tiles J >= I, and serves [I, J] and
// [J, I] of each pair:
//
// 0. tile_feats_kernel: per pixel the feature planes x/alpha, y/alpha,
//    rgb/beta (IEEE division, as the plain version), the slot of nb, and
//    the entry's own planes, padded to whole tiles. A padded pixel sits at
//    x = 1e30, so its K with any real pixel is exp(-inf) = 0 and with
//    another padded pixel the diagonal's 0: no entry needs a bounds check.
// 1. row partials: a tile pair's row partials (rows of I, summed over J) go
//    to slot J of the rows of I; for I != J its column partials (rows of J,
//    summed over I) go to slot I of the rows of J. The scratch is (C, N/64,
//    N) f32, slot-major so that the writes and the reads of pass 2
//    coalesce; every (slot, row) is written by exactly one block. B5 takes
//    them in a pass of their own (tile_rowsum_kernel); B2 in its store pass
//    (tile_store_kernel<..., kSums>), from the same K in the same order.
// 2. tile_norm_kernel: nb_i from row i's slots, summed in slot order, into
//    B5's nb plane or B2's g. No atomics anywhere: the sums and the stored
//    matrices are bitwise reproducible.
// 3. tile_store_kernel: the block computes its tile pairs' entries (one exp
//    each, for both halves), writes [I, J] with 16-byte stores (8 bf16 or 4
//    f32 a thread, neighbouring threads on neighbouring addresses) and, for
//    I != J, [J, I] from a transposed staging tile in shared memory, with
//    the same 16-byte stores. B5 runs it after pass 2 (its entries need
//    nb); B2 runs it alone, with the row partials, before pass 2.
//
// What bounds it on Hopper: f32 instructions, ~22 an entry with the exp,
// and for the store pass also the matrix's bytes. A block keeps its row
// tile's features in registers and double-buffers the column tiles' planes
// in shared memory with cp.async, so the next tile's load overlaps this
// tile's exps; a thread takes 32 entries of a tile pair in the row sums and
// 32 bf16 or 16 f32 in the store, with register bounds that leave no
// spills. At bf16 the store's threads are the row-sum pass's (128, 8
// columns of 4 rows 16 apart), so B2's summing store adds each entry into
// its row and column partials in tile_rowsum_kernel's order and reduces them
// with its shuffles: B2's g is bitwise the nb of B5's pass 1 and 2.
// Differences are taken per coordinate, never through a Gram product, so
// the i == j exponent is exactly 0 and |dxy|^2 > 0 tells the diagonal apart
// (two distinct pixels are at least 1/alpha apart). Any N: the ragged last
// tile is padded, nothing past N is stored, and where N is not a multiple
// of the vector the rows are not 16-byte aligned and take scalar stores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"

namespace cvt {
namespace {  // each source that includes this gets its own copy of the kernels

constexpr int kTile = 64;            // pixels a side of a tile
constexpr int kRowsumThreads = 128;  // 32 entries of a 64x64 tile a thread
constexpr int kStrip = 8;            // tile pairs a block
constexpr int kBil = 5;              // planes x, y, r, g, b; then nb, then the entry's
constexpr int kNbPlane = kBil;
constexpr float kEpsNorm = 1e-20f;
constexpr float kPadX = 1e30f;       // x of a padded pixel
// B2's summing store: blocks an SM, the most that run without spills and
// the fastest of those (measured: bilateral_build.cu)
constexpr int kSumsBlocksBf16 = 5;
constexpr int kSumsBlocksF32 = 2;

__host__ __device__ inline int num_tiles(int n) { return (n + kTile - 1) / kTile; }

__host__ __device__ inline int num_strips(int n) { return (num_tiles(n) + kStrip - 1) / kStrip; }

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// K[i,j] from the five planes' values. -1/2 |dxy|^2 - 1/2 |drgb|^2 is taken
// as -1/2 (|dxy|^2 + |drgb|^2), the same bits (halving is exact). Only a
// diagonal tile (kDiag) holds i == j, where |dxy|^2 == 0 and the entry must
// be 0; elsewhere |dxy|^2 > 0, and a padded pixel's is inf, so exp gives 0
// by itself. The mask is a product with 0 or 1, not a `?:`, which compiles
// to a branch an entry that costs as much as the exp.
template <bool kDiag>
__device__ __forceinline__ float k_bilateral(const float* fi, const float* fj) {
  const float dp0 = fi[0] - fj[0], dp1 = fi[1] - fj[1];
  const float sp = dp0 * dp0 + dp1 * dp1;
  const float dc0 = fi[2] - fj[2], dc1 = fi[3] - fj[3], dc2 = fi[4] - fj[4];
  const float sc = dc0 * dc0 + dc1 * dc1 + dc2 * dc2;
  const float e = expf(-0.5f * (sp + sc));
  return kDiag ? e * static_cast<float>(sp > 0.0f) : e;
}

// run body(std::true_type) for a diagonal tile pair, body(std::false_type)
// for any other, so the diagonal's mask is compiled into its own copy
template <class Body>
__device__ __forceinline__ void by_diagonal(bool diag, Body&& body) {
  if (diag)
    body(std::true_type{});
  else
    body(std::false_type{});
}

// B2's and B3's planes: the five features and nb's slot, none of their own
// (B2's summing store writes K itself, B3 its own int8 entries)
struct PlainEntry {
  static constexpr int kExtra = 0;
  __device__ __forceinline__ void load(int, float*) const {}
};

// grid (ceil(Npad / 256), C): feat (C, planes, Npad) for planes = 6 + kExtra
template <class Entry>
__global__ void tile_feats_kernel(const unsigned char* __restrict__ imgs, int n, int w,
                                  float alpha, float beta, Entry entry,
                                  float* __restrict__ feat) {
  constexpr int kPlanes = kBil + 1 + Entry::kExtra;
  const int npad = num_tiles(n) * kTile;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= npad) return;
  const long long f = blockIdx.y;
  float v[kPlanes];
#pragma unroll
  for (int c = 0; c < kPlanes; ++c) v[c] = 0.0f;
  if (p < n) {
    const unsigned char* px = imgs + (f * n + p) * 3;
    v[0] = static_cast<float>(p % w) / alpha;
    v[1] = static_cast<float>(p / w) / alpha;
    v[2] = static_cast<float>(px[0]) / beta;
    v[3] = static_cast<float>(px[1]) / beta;
    v[4] = static_cast<float>(px[2]) / beta;
    entry.load(p, v + kBil + 1);
  } else {
    v[0] = kPadX;
  }
  float* o = feat + f * kPlanes * npad + p;
#pragma unroll
  for (int c = 0; c < kPlanes; ++c) o[static_cast<long long>(c) * npad] = v[c];
}

// the strip of block b: row tile ti, column tiles [tj0, tj1); false if empty
__device__ __forceinline__ bool strip_of(int b, int nt, int& ti, int& tj0, int& tj1) {
  const int ns = (nt + kStrip - 1) / kStrip;
  ti = b / ns;
  tj0 = ti + (b % ns) * kStrip;
  tj1 = min(nt, tj0 + kStrip);
  return tj0 < nt;
}

// cp.async the first `planes` planes of tile t (64 pixels) into dst[plane][64]
__device__ __forceinline__ void load_tile(const float* fp, int planes, int npad, int t,
                                          float* dst) {
  for (int e = threadIdx.x; e < planes * (kTile / 4); e += blockDim.x) {
    const int c = e / (kTile / 4), ch = e % (kTile / 4);
    cp_async16(dst + c * kTile + ch * 4,
               fp + static_cast<long long>(c) * npad + t * kTile + ch * 4, true);
  }
  cp_async_commit();
}

// grid (row tiles x strips, C): row and column partials into part (C, N/64, N)
template <int kPlanes>
__global__ void __launch_bounds__(kRowsumThreads, 7)
tile_rowsum_kernel(const float* __restrict__ feat, int n, float* __restrict__ part) {
  // a thread: 8 consecutive columns of 4 rows 16 apart
  constexpr int kVec = 8, kGroups = kTile / kVec, kRpp = kRowsumThreads / kGroups;
  constexpr int kReps = kTile / kRpp;
  __shared__ __align__(16) float si[kBil][kTile];
  __shared__ __align__(16) float sj[2][kBil][kTile];
  __shared__ float scol[kRowsumThreads / 32][kTile];
  const int nt = num_tiles(n), npad = nt * kTile;
  int ti, tj0, tj1;
  if (!strip_of(blockIdx.x, nt, ti, tj0, tj1)) return;
  const long long f = blockIdx.y;
  const float* fp = feat + f * kPlanes * npad;
  const int tid = threadIdx.x, g = tid % kGroups, rr = tid / kGroups, jl = g * kVec;
  load_tile(fp, kBil, npad, ti, &si[0][0]);
  load_tile(fp, kBil, npad, tj0, &sj[0][0][0]);
  float fi[kReps][kBil];
  for (int tj = tj0, buf = 0; tj < tj1; ++tj, buf ^= 1) {
    if (tj + 1 < tj1) {
      load_tile(fp, kBil, npad, tj + 1, &sj[buf ^ 1][0][0]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tj == tj0)
#pragma unroll
      for (int k = 0; k < kReps; ++k)
#pragma unroll
        for (int c = 0; c < kBil; ++c) fi[k][c] = si[c][rr + kRpp * k];
    float row[kReps], col[kVec];
    by_diagonal(tj == ti, [&](auto diag) {
#pragma unroll
      for (int k = 0; k < kReps; ++k) row[k] = 0.0f;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        float fj[kBil];
#pragma unroll
        for (int c = 0; c < kBil; ++c) fj[c] = sj[buf][c][jl + u];
        col[u] = 0.0f;
#pragma unroll
        for (int k = 0; k < kReps; ++k) {
          const float v = k_bilateral<decltype(diag)::value>(fi[k], fj);
          row[k] += v;
          col[u] += v;
        }
      }
    });
#pragma unroll
    for (int k = 0; k < kReps; ++k) {
      // the 8 threads of a row are lanes differing in bits 0-2
      float s = row[k];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      const int i = ti * kTile + rr + kRpp * k;
      if (g == 0 && i < n) part[(f * nt + tj) * n + i] = s;
    }
    if (tj != ti) {  // a diagonal tile's column partials are its row partials
      // the 4 row groups of a warp are lanes differing in bits 3-4; then the warps
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        col[u] += __shfl_xor_sync(0xffffffffu, col[u], 8);
        col[u] += __shfl_xor_sync(0xffffffffu, col[u], 16);
      }
      if ((tid & 31) < kGroups)
#pragma unroll
        for (int u = 0; u < kVec; ++u) scol[tid / 32][jl + u] = col[u];
      __syncthreads();
      if (tid < kTile) {
        float s = 0.0f;
#pragma unroll
        for (int wp = 0; wp < kRowsumThreads / 32; ++wp) s += scol[wp][tid];
        const int j = tj * kTile + tid;
        if (j < n) part[(f * nt + ti) * n + j] = s;
      }
    }
    __syncthreads();  // sj[buf] and scol are free again
  }
}

// grid (ceil(N / 256), C): nb[f * stride + i] = sqrt(w1) * rsqrt(sum of row
// i's slots + eps), into B5's nb plane (stride: a frame's planes) or B2's g
// (stride N)
__global__ void __launch_bounds__(256)
tile_norm_kernel(const float* __restrict__ part, int n, float w1, float* __restrict__ nb,
                 long long stride) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long f = blockIdx.y;
  const int nt = num_tiles(n);
  const float* pp = part + f * nt * n + i;
  float s = 0.0f;
  for (int t = 0; t < nt; ++t) s += pp[static_cast<long long>(t) * n];
  nb[f * stride + i] = sqrtf(w1) * (1.0f / sqrtf(s + kEpsNorm));
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                            pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// one row segment of kVec entries starting at column j of a row of M
template <typename T, int kVec>
__device__ __forceinline__ void store_segment(T* o, int j, int n, bool aligned,
                                              const float (&v)[kVec]) {
  if (aligned) {
    if (j < n) store_vec(o, v);  // n % kVec == 0: a segment is whole or absent
  } else {
#pragma unroll
    for (int u = 0; u < kVec; ++u)
      if (j + u < n) store_one(o + u, v[u]);
  }
}

// a thread's kReps row segments of kVec entries in T's bits, 16 bytes a
// segment: bf16 pairs in 32-bit words, or f32. B2's summing store keeps its
// entries so once its partials are summed, which halves their registers at
// bf16 (the store then runs 5 blocks an SM with no spills).
template <typename T, int kReps, int kVec>
struct Segments {
  static constexpr int kWords = 4;
  static_assert(kVec * sizeof(T) == 4 * kWords, "a segment is one 16-byte store");
  uint32_t w[kReps][kWords];

  __device__ __forceinline__ explicit Segments(const float (&v)[kReps][kVec]) {
#pragma unroll
    for (int k = 0; k < kReps; ++k)
#pragma unroll
      for (int h = 0; h < kWords; ++h)
        w[k][h] = sizeof(T) == 2 ? pack_bf16x2(v[k][2 * h], v[k][2 * h + 1])
                                 : __float_as_uint(v[k][h]);
  }

  // entry u of segment k as a float (a bf16's bits are a float's high half)
  __device__ __forceinline__ float at(int k, int u) const {
    if (sizeof(T) == 4) return __uint_as_float(w[k][u]);
    const uint32_t x = w[k][u / 2];
    return __uint_as_float(u % 2 ? x & 0xffff0000u : x << 16);
  }

  // segment k at column j of a row of the output, as store_segment stores
  __device__ __forceinline__ void store(T* o, int k, int j, int n, bool aligned) const {
    if (aligned) {
      if (j < n) *reinterpret_cast<uint4*>(o) = make_uint4(w[k][0], w[k][1], w[k][2], w[k][3]);
    } else {
#pragma unroll
      for (int u = 0; u < kVec; ++u)
        if (j + u < n) store_one(o + u, at(k, u));
    }
  }
};

// grid (row tiles x strips, C): [I, J] and [J, I] of the block's tile pairs,
// T = float or bf16, kThreads a block and at least kBlocks blocks an SM.
// B5's form stores entry(nb_i, nb_j, K, ...) and reads the nb plane. B2's
// (kSums) stores K itself, reads only the five feature planes, and adds
// each entry into its row and column partials, which go to part (C, N/64,
// N) as tile_rowsum_kernel writes them; at kThreads = 128 (bf16) in its
// order too.
template <typename T, class Entry, int kThreads, int kBlocks, bool kSums = false>
__global__ void __launch_bounds__(kThreads, kBlocks)
tile_store_kernel(const float* __restrict__ feat, int n, Entry entry, T* __restrict__ out,
                  float* __restrict__ part) {
  // a thread: kVec consecutive columns (one 16-byte store) of kReps rows
  constexpr int kVec = 16 / sizeof(T), kGroups = kTile / kVec, kRpp = kThreads / kGroups;
  constexpr int kReps = kTile / kRpp;
  constexpr int kE = Entry::kExtra, kPlanes = kBil + 1 + kE;
  constexpr int kLoad = kSums ? kBil : kPlanes;  // the planes a tile needs
  static_assert(!kSums || kE == 0, "B2's summing store has no entry planes");
  __shared__ __align__(16) float si[kLoad][kTile];
  __shared__ __align__(16) float sj[2][kLoad][kTile];
  __shared__ float stage[kTile][kTile + 1];  // stage[j - J0][i - I0], padded
  __shared__ float scol[kSums ? kThreads / 32 : 1][kTile];
  const int nt = num_tiles(n), npad = nt * kTile;
  int ti, tj0, tj1;
  if (!strip_of(blockIdx.x, nt, ti, tj0, tj1)) return;
  const long long f = blockIdx.y;
  const float* fp = feat + f * kPlanes * npad;
  const int tid = threadIdx.x, g = tid % kGroups, rr = tid / kGroups, jl = g * kVec;
  const bool aligned = n % kVec == 0;
  const int i0 = ti * kTile;
  const long long step = static_cast<long long>(kRpp) * n;  // between a thread's rows
  T* const orow = out + (f * n + i0 + rr) * n + jl;          // + j0: [i0 + rr, j0 + jl]
  T* const ocol = out + (f * n + rr) * n + i0 + jl;          // + j0 n: [j0 + rr, i0 + jl]
  load_tile(fp, kLoad, npad, ti, &si[0][0]);
  load_tile(fp, kLoad, npad, tj0, &sj[0][0][0]);
  float fi[kReps][kBil], ei[kReps][kE + 1], nbi[kReps];  // the thread's rows
  for (int tj = tj0, buf = 0; tj < tj1; ++tj, buf ^= 1) {
    if (tj + 1 < tj1) {
      load_tile(fp, kLoad, npad, tj + 1, &sj[buf ^ 1][0][0]);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tj == tj0)
#pragma unroll
      for (int k = 0; k < kReps; ++k) {
        const int il = rr + kRpp * k;
#pragma unroll
        for (int c = 0; c < kBil; ++c) fi[k][c] = si[c][il];
        if constexpr (!kSums) {
#pragma unroll
          for (int c = 0; c < kE; ++c) ei[k][c] = si[kBil + 1 + c][il];
          nbi[k] = si[kNbPlane][il];
        }
      }
    const int j0 = tj * kTile;
    float v[kReps][kVec];
    by_diagonal(tj == ti, [&](auto diag) {
      constexpr bool kDiag = decltype(diag)::value;
#pragma unroll
      for (int u = 0; u < kVec; ++u) {
        float fj[kBil], ej[kE + 1], nbj = 0.0f;
#pragma unroll
        for (int c = 0; c < kBil; ++c) fj[c] = sj[buf][c][jl + u];
        if constexpr (!kSums) {
#pragma unroll
          for (int c = 0; c < kE; ++c) ej[c] = sj[buf][kBil + 1 + c][jl + u];
          nbj = sj[buf][kNbPlane][jl + u];
        }
#pragma unroll
        for (int k = 0; k < kReps; ++k) {
          const float kv = k_bilateral<kDiag>(fi[k], fj);
          if constexpr (kSums)
            v[k][u] = kv;
          else
            v[k][u] = entry.template value<kDiag>(nbi[k], nbj, kv, ei[k], ej);
        }
      }
    });
    if constexpr (kSums) {
      // the partials, before the stores: a row's is its entries added from 0
      // in column order, as tile_rowsum_kernel adds them; then the kGroups
      // threads of a row, lanes differing in the low bits
#pragma unroll
      for (int k = 0; k < kReps; ++k) {
        float s = 0.0f;
#pragma unroll
        for (int u = 0; u < kVec; ++u) s += v[k][u];
#pragma unroll
        for (int b = 1; b < kGroups; b <<= 1) s += __shfl_xor_sync(0xffffffffu, s, b);
        const int i = i0 + rr + kRpp * k;
        if (g == 0 && i < n) part[(f * nt + tj) * n + i] = s;
      }
      if (tj != ti) {
        // a column's partial (a diagonal tile's are its row partials): the
        // thread's entries added from 0 in row order, as tile_rowsum_kernel
        // adds them; then the row groups of a warp, lanes differing in the
        // high bits; then the warps
#pragma unroll
        for (int u = 0; u < kVec; ++u) {
          float c = 0.0f;
#pragma unroll
          for (int k = 0; k < kReps; ++k) c += v[k][u];
#pragma unroll
          for (int b = kGroups; b < 32; b <<= 1) c += __shfl_xor_sync(0xffffffffu, c, b);
          if ((tid & 31) < kGroups) scol[tid / 32][jl + u] = c;
        }
      }
    }
    const Segments<T, kReps, kVec> seg(v);  // B2's entries in T's bits from here on
    auto entry_at = [&](int k, int u) {
      if constexpr (kSums)
        return seg.at(k, u);
      else
        return v[k][u];
    };
#pragma unroll
    for (int k = 0; k < kReps; ++k)
      if (i0 + rr + kRpp * k < n) {
        if constexpr (kSums)
          seg.store(orow + k * step + j0, k, j0 + jl, n, aligned);
        else
          store_segment<T, kVec>(orow + k * step + j0, j0 + jl, n, aligned, v[k]);
      }
    if (tj != ti) {  // the transposed tile: [j, i] = [i, j]
#pragma unroll
      for (int k = 0; k < kReps; ++k)
#pragma unroll
        for (int u = 0; u < kVec; ++u) stage[jl + u][rr + kRpp * k] = entry_at(k, u);
      __syncthreads();
      if constexpr (kSums) {
        if (tid < kTile) {
          float s = 0.0f;
#pragma unroll
          for (int wp = 0; wp < kThreads / 32; ++wp) s += scol[wp][tid];
          const int j = j0 + tid;
          if (j < n) part[(f * nt + ti) * n + j] = s;
        }
      }
#pragma unroll
      for (int k = 0; k < kReps; ++k) {
        const int jt = rr + kRpp * k;
        if (j0 + jt >= n) continue;
        float t[kVec];
#pragma unroll
        for (int u = 0; u < kVec; ++u) t[u] = stage[jt][jl + u];
        store_segment<T, kVec>(ocol + k * step + static_cast<long long>(j0) * n, i0 + jl, n,
                               aligned, t);
      }
    }
    __syncthreads();  // sj[buf], stage and scol are free again
  }
}

// the store's threads: 32 bf16 or 16 f32 entries a thread
template <typename T>
constexpr int store_threads() { return sizeof(T) == 2 ? 128 : 256; }

// B5's four passes over `frames` frames of n pixels (frames <= 65535);
// feat is (frames, 6 + Entry::kExtra, N rounded up to 64) f32 scratch, part
// (frames, ceil(N / 64), N) f32 scratch, out (frames, N, N)
template <typename T, class Entry>
void tile_build(const unsigned char* imgs, int frames, int n, int w, float w1, float alpha,
                float beta, const Entry& entry, float* feat, float* part, T* out,
                cudaStream_t s) {
  constexpr int kPlanes = kBil + 1 + Entry::kExtra;
  // as many store blocks an SM as the registers allow without spills
  // (measured on H100)
  constexpr int kStoreThreads = store_threads<T>();
  constexpr int kStoreBlocks = sizeof(T) == 2 ? (Entry::kExtra ? 4 : 6) : 3;
  const int npad = num_tiles(n) * kTile;
  const dim3 grid(static_cast<unsigned>(num_tiles(n)) * num_strips(n), frames);
  tile_feats_kernel<Entry><<<dim3((npad + 255) / 256, frames), 256, 0, s>>>(
      imgs, n, w, alpha, beta, entry, feat);
  tile_rowsum_kernel<kPlanes><<<grid, kRowsumThreads, 0, s>>>(feat, n, part);
  tile_norm_kernel<<<dim3((n + 255) / 256, frames), 256, 0, s>>>(
      part, n, w1, feat + kNbPlane * npad, static_cast<long long>(kPlanes) * npad);
  tile_store_kernel<T, Entry, kStoreThreads, kStoreBlocks><<<grid, kStoreThreads, 0, s>>>(
      feat, n, entry, out, nullptr);
}

// B2's three passes over `frames` frames of n pixels (frames <= 65535): the
// features, the summing store of K into out (frames, N, N) with the row
// partials, and g (frames, N) f32 from them. feat is (frames, 6, N rounded
// up to 64) f32 scratch, part (frames, ceil(N / 64), N) f32 scratch.
template <typename T>
void tile_build_sums(const unsigned char* imgs, int frames, int n, int w, float w1,
                     float alpha, float beta, float* feat, float* part, T* out, float* g,
                     cudaStream_t s) {
  constexpr int kStoreThreads = store_threads<T>();
  // as many blocks an SM as the registers allow without spills (measured on
  // H100: see bilateral_build.cu)
  constexpr int kStoreBlocks = sizeof(T) == 2 ? kSumsBlocksBf16 : kSumsBlocksF32;
  const int npad = num_tiles(n) * kTile;
  const dim3 grid(static_cast<unsigned>(num_tiles(n)) * num_strips(n), frames);
  tile_feats_kernel<PlainEntry><<<dim3((npad + 255) / 256, frames), 256, 0, s>>>(
      imgs, n, w, alpha, beta, PlainEntry{}, feat);
  tile_store_kernel<T, PlainEntry, kStoreThreads, kStoreBlocks, true>
      <<<grid, kStoreThreads, 0, s>>>(feat, n, PlainEntry{}, out, part);
  tile_norm_kernel<<<dim3((n + 255) / 256, frames), 256, 0, s>>>(part, n, w1, g, n);
}

}  // namespace
}  // namespace cvt
