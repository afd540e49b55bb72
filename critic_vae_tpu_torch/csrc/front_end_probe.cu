// Probe P2: the fused front-end kernel on Hopper, and its copy floor.
//
// Replaces examples/mosaic_copy_floor_probe.py::main (its Pallas `kernel`).
// The fused front end computes the merged 3->40-channel first conv in its
// four pool phases as one space-to-depth (s2d) 3x3 conv, keeps the phase
// max and the ReLU in the epilogue, and stores only the pooled map. Per
// frame the s2d input is (34, 34, 12) bf16 (x rows 1156f + 34y + z), the
// weights w (128, 160) bf16 are s2d_pool_weights of the merged kernel as
// (108, 160) rows (u, v, (p, q, c)) zero-padded, and the output is
// (1024, 40) bf16 rows 32i + j. Output row i of a frame is
//
//   A_i (32, 108) @ w[:108] (108, 160), A_i[j, 36r + m] = xf[408 (i + r) + 12 j + m]
//
// (xf the frame's 13,872 bf16 as one flat array, r < 3, m < 36): each r is
// a strided window of the frame's own scanlines, strides 12 over j, 408
// over r, 1 over m. No im2col copy is needed.
//
// What bounds it on this card: the product, 2 x (1024 B) x 108 x 160
// flops (36 GFLOP at B = 1024), ~0.037 ms at the dense bf16 peak, against
// ~112 MB of input and output (~0.034 ms at 3.35 TB/s).
//
// What the design does:
// * Whole frames into shared memory by the bulk copy engine: a frame's
//   27,744 bytes are one 1-D cp.async.bulk (16-byte aligned, a multiple of
//   16), completing on an mbarrier. One producer warp fills a ring of up to
//   kRing frame-pair buffers, so the next pair's copy runs under this
//   pair's 32 output rows; a buffer is handed back through a second
//   mbarrier when its consumer is done. The grid is persistent, one block
//   an SM at most; a block walks groups of frames_per_block frames (F / 2
//   pairs), groups b, b + grid, ..., pair after pair through the ring.
// * wgmma m64n160k16 with A from registers: the 64-row tile is two frames'
//   32 output columns j, one warp 16 of them. Each thread reads its A
//   fragment (mma.sync m16n8k16's A layout per warp) straight from the
//   frame's window with 32-bit loads: k = 36r + m is even and 36 is even,
//   so a bf16 pair never straddles two r. K is 108 padded to 112, 7 k-steps
//   of 16; the pad's A registers (k >= 108) are set to zero explicitly,
//   because the window formula there reads the next frame's first row (or
//   past the ring), and NaN or Inf times w's zero rows would be NaN.
// * B = w resident in shared memory once a block, in wgmma's canonical
//   K-major layout without swizzle: 8 x 8 bf16 core matrices of 128
//   contiguous bytes, k-adjacent ones 128 bytes apart (LBO), n-adjacent
//   ones 1,792 (SBO); 112 x 160 bf16, 35,840 bytes.
// * The epilogue in registers: wgmma's accumulators repeat mma.sync's C
//   layout for each 8 columns, so the four phases of output channel c sit in
//   n-tiles c/8 + 5p of the same thread; phase max, ReLU and bf16 need no
//   shared memory, and go out as bf16x2 stores.
// * Two consumer warpgroups take a block's pairs in turn, so one's epilogue
//   and loads run under the other's products.
//
// dot_only (kCopies false) runs the same kernel on a zeroed ring and issues
// no frame copies; the difference of the two is the copy floor: what the
// bulk loads cost beyond what the ring hides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kThreads = 128 * kConsumers + 32;     // + the producer warp
constexpr int kRing = 3;                            // frame-pair buffers
constexpr int kS2dSide = 34, kS2dC = 12;
constexpr int kLine = kS2dSide * kS2dC;             // 408 bf16 a scanline
constexpr int kFrameElems = kS2dSide * kLine;       // 13,872 bf16
constexpr int kFrameBytes = kFrameElems * 2;        // 27,744
constexpr int kPairBytes = 2 * kFrameBytes;         // 55,488
constexpr int kOutSide = 32, kOutRows = kOutSide * kOutSide;
constexpr int kPatch = 108, kKPad = 112, kKSteps = kKPad / 16;
constexpr int kN = 160, kPhaseC = 40, kPhaseTiles = kPhaseC / 8;
constexpr int kCore = 128;                          // bytes of an 8 x 8 bf16 core matrix
constexpr int kSbo = (kKPad / 8) * kCore;           // 1,792: the next 8 n
constexpr int kWBytes = kKPad * kN * 2;             // 35,840

// w, the ring, then a full and an empty mbarrier a stage
constexpr int kSmemBytes = kWBytes + kRing * (kPairBytes + 16);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// wait until the phase of `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// `bytes` global -> shared by the bulk copy engine, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the matrix descriptor of a K-major, unswizzled operand at shared address
// `addr`: LBO between k-adjacent core matrices, SBO between n-adjacent ones
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(kCore >> 4) << 16) | (static_cast<uint64_t>(kSbo >> 4) << 32);
}

// keep the compiler from moving accesses of d across the asynchronous product
__device__ __forceinline__ void fence_operands(float (&d)[80]) {
#pragma unroll
  for (int v = 0; v < 80; ++v) asm volatile("" : "+f"(d[v])::"memory");
}

// D (64 x 160, f32) = A (64 x 16, bf16 registers) @ B (16 x 160, bf16 at
// desc) + (accumulate ? D : 0), one warpgroup
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[80], const uint32_t (&a)[4],
                                                 uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79 "
      "}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// max that propagates NaN, as cvt::nan_max, in one instruction
__device__ __forceinline__ float max_nan(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(m) : "f"(a), "f"(b));
  return m;
}

// output row i's A fragments from the window at `win` (the thread's column
// j of its frame): 32-bit loads at the k offsets `off`, the pad zeroed
__device__ __forceinline__ void load_a(uint32_t (&a)[kKSteps][4], const __nv_bfloat16* win,
                                       int i, const int (&off)[kKSteps][2], bool pad) {
  const __nv_bfloat16* ai = win + kLine * i;
#pragma unroll
  for (int s = 0; s < kKSteps; ++s) {
    a[s][0] = cvt::ld_bf16x2(ai + off[s][0]);
    a[s][1] = cvt::ld_bf16x2(ai + 96 + off[s][0]);  // column j + 8
    a[s][2] = cvt::ld_bf16x2(ai + off[s][1]);
    a[s][3] = cvt::ld_bf16x2(ai + 96 + off[s][1]);
  }
  a[kKSteps - 1][2] = pad ? 0u : a[kKSteps - 1][2];
  a[kKSteps - 1][3] = pad ? 0u : a[kKSteps - 1][3];
}

// issue the 7 k-steps of one output row, one commit group
__device__ __forceinline__ void row_product(float (&d)[80], const uint32_t (&a)[kKSteps][4],
                                            uint64_t desc0) {
  fence_operands(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kKSteps; ++s)  // k-step s: 2 core matrices, 256 bytes on
    wgmma_m64n160k16(d, a[s], desc0 + static_cast<uint64_t>(s * 2 * kCore >> 4), s);
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait for the row's products, then phase max, ReLU, bf16 and the stores;
// d[4nt + 2half + v] = D[16wq + g + 8half][8nt + 2q + v]
__device__ __forceinline__ void row_epilogue(float (&d)[80], __nv_bfloat16* o) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(d);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int ct = 0; ct < kPhaseTiles; ++ct) {
      float v0 = d[4 * ct + 2 * half], v1 = d[4 * ct + 2 * half + 1];
#pragma unroll
      for (int p = 1; p < 4; ++p) {
        v0 = max_nan(v0, d[4 * (ct + kPhaseTiles * p) + 2 * half]);
        v1 = max_nan(v1, d[4 * (ct + kPhaseTiles * p) + 2 * half + 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * half * kPhaseC + 8 * ct) =
          __floats2bfloat162_rn(cvt::nan_max(v0, 0.0f), cvt::nan_max(v1, 0.0f));
    }
  }
}

template <bool kCopies>
__global__ void __launch_bounds__(kThreads, 1)
front_end_probe_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                       int groups, int group_pairs, __nv_bfloat16* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int stages = kRing;
  unsigned char* const ring = smem + kWBytes;
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + stages * kPairBytes);
  uint64_t* const empty = full + stages;
  // the block's t-th pair: pair t % group_pairs of its group t / group_pairs
  const int pairs = (groups - blockIdx.x + gridDim.x - 1) / gridDim.x * group_pairs;
  auto pair_of = [&](int t) {
    return (static_cast<long>(blockIdx.x) + static_cast<long>(t / group_pairs) * gridDim.x) *
               group_pairs + t % group_pairs;
  };

  // w's rows k < 112 (n, k) into the core-matrix layout; the rows past
  // 108 meet only the A pad's zeros
  for (int e = threadIdx.x; e < kKPad * kN; e += kThreads) {
    const int k = e / kN, n = e % kN;
    *reinterpret_cast<__nv_bfloat16*>(smem + (n / 8) * kSbo + (k / 8) * kCore + (n % 8) * 16 +
                                      (k % 8) * 2) = w[e];
  }
  if (!kCopies)
    for (int e = threadIdx.x; e < stages * kPairBytes / 16; e += kThreads)
      reinterpret_cast<uint4*>(ring)[e] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);  // every thread of the consuming warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // w was written by plain stores and is read by wgmma (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {  // the producer warp: one thread issues the copies
    if (kCopies && threadIdx.x == 128 * kConsumers)
      for (int t = 0; t < pairs; ++t) {
        const int s = t % stages;
        if (t >= stages) mbar_wait(&empty[s], (t / stages - 1) & 1);
        mbar_expect_tx(&full[s], kPairBytes);
        const __nv_bfloat16* src = x + pair_of(t) * 2 * kFrameElems;
        unsigned char* dst = ring + s * kPairBytes;
        bulk_load(dst, src, kFrameBytes, &full[s]);
        bulk_load(dst + kFrameBytes, src + kFrameElems, kFrameBytes, &full[s]);
      }
    return;
  }

  // a consumer warpgroup: warp wq holds tile rows 16wq..16wq+15, frame wq / 2
  // of the pair, columns j and j + 8
  const int wq = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const int fr = wq / 2, j = 16 * (wq % 2) + g;
  // the window offset of k = 16s + 8h + 2q: 408r + (k - 36r); the pad's 0
  int off[kKSteps][2];
#pragma unroll
  for (int s = 0; s < kKSteps; ++s)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = 16 * s + 8 * h + 2 * q;
      off[s][h] = k < kPatch ? (kLine - 36) * (k / 36) + k : 0;
    }
  const bool pad = 16 * (kKSteps - 1) + 8 + 2 * q >= kPatch;  // a[6][2..3]
  const uint64_t desc0 = kmajor_desc(smem_u32(smem));
  float d[80];

  for (int t = wg; t < pairs; t += kConsumers) {
    const int s = t % stages;
    if (kCopies) mbar_wait(&full[s], (t / stages) & 1);
    const __nv_bfloat16* win = reinterpret_cast<const __nv_bfloat16*>(ring + s * kPairBytes) +
                               fr * kFrameElems + 12 * j;
    __nv_bfloat16* o = out + ((2 * pair_of(t) + fr) * kOutRows + j) * kPhaseC + 2 * q;
    // two register sets of A: the next row's loads run under this row's
    // products
    uint32_t a0[kKSteps][4], a1[kKSteps][4];
    load_a(a0, win, 0, off, pad);
#pragma unroll 1
    for (int i = 0; i < kOutSide; i += 2) {
      row_product(d, a0, desc0);
      load_a(a1, win, i + 1, off, pad);
      row_epilogue(d, o + kOutSide * i * kPhaseC);
      row_product(d, a1, desc0);
      if (i + 2 < kOutSide) load_a(a0, win, i + 2, off, pad);
      row_epilogue(d, o + kOutSide * (i + 1) * kPhaseC);
    }
    if (kCopies) mbar_arrive(&empty[s]);  // the buffer may take the next pair
  }
}

}  // namespace

// x: (frames * 1156, 12) bf16, 16-byte aligned; w: (128, 160) bf16; out:
// (frames * 1024, 40) bf16; frames_per_block even, frames a multiple of it.
// Returns the first CUDA error.
extern "C" int cvt_front_end_probe(const void* x, const void* w, int frames,
                                   int frames_per_block, int copies, void* out, void* stream) {
  if (frames <= 0) return 0;
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, int, int, __nv_bfloat16*) =
      copies ? front_end_probe_kernel<true> : front_end_probe_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int groups = frames / frames_per_block;
  kernel<<<groups < sms ? groups : sms, kThreads, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), groups,
      frames_per_block / 2, static_cast<__nv_bfloat16*>(out));
  return static_cast<int>(cudaGetLastError());
}
