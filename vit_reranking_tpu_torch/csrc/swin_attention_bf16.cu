// K4's bf16 form: Swin window attention, softmax(q k^T * scale + add) v per
// window, forward and backward, bf16 q, k, v, o and gradients (the additive
// term, its gradient and the partial sums f32), on Hopper (sm_90a) with every
// product on wgmma and every tile load by TMA.
//
// Replaces the TPU kernels of vit_reranking_tpu/ops/swin_attention_pallas.py
// run on bf16 operands (Swin-T's default training precision on its
// accelerator), both contracts, as csrc/swin_attention.cu does in f32:
//   K4b, the batched contract: _fwd_kernel (:77, with _attn_probs :63,
//       launched by _swa_fwd :162) and _bwd_kernel (:88, launched by
//       _swa_bwd :181): additive term bias[h] + mask[w], bias (H, T, T),
//       mask (nW, T, T) or none; the backward returns dbias (H, T, T).
//   K4a, the packed contract: _packed_fwd_kernel (:218, launched by
//       _packed_fwd :323) and _packed_bwd_kernel (:234, launched by
//       _packed_bwd :340): additive term add (H, nblk, P T, P T), -1e9 off
//       its diagonal (T, T) blocks, of which only those are read (the
//       products across windows are exactly zero after the softmax); the
//       backward returns dadd of add's shape, zero off the diagonal blocks.
// The model's qkv entry (ops/swin_attention.py::swin_attention_qkv) calls
// this core with the batched geometry for either contract: the packed
// term's diagonal blocks are bias[h] + mask[w] to the bit.
//
// What it computes: the TPU kernels' rounding points.  Scores, softmax, dp
// and ds in f32 from bf16 products summed in f32; p normalised in f32 and
// rounded to bf16 before P V and P^T dO; ds rounded to bf16 before dS K and
// dS^T Q; each product's f32 sum scaled and rounded to bf16 once; dbias or
// dadd summed from the f32 ds.  No float atomics: each (run of images, head,
// window) writes one partial of its ds, and a second launch sums the
// partials in a fixed order, so the gradients are the same bits run to run.
//
// What bounds it: bytes.  At Swin-T stage 0 and batch 112 (B = 112, nW =
// 64, H = 3, T = 49, D = 32) the forward reads q, k, v and writes o, 4 x 67
// MB of bf16 (0.081 ms at 3.35 TB/s); the backward moves 7 such tensors
// (0.14 ms).  Its products are a few microseconds at the bf16 rate.  A
// window's work is small (12.5 KB in and out forward, 22 KB backward, a few
// dozen wgmma), so what a design must do is keep enough tiles in flight.
//
// Design.
//   Work.  A unit is one (window, head) over a run of `chunk` images; units
//   are ordered head fastest, so the blocks that start together read the
//   heads of the same tokens (neighbouring pieces of one row of the qkv
//   projection) at about the same time.  A persistent grid (as many blocks
//   as the card holds at once) walks the units in a fixed order, block j
//   taking units j, j + grid, ...; the wrapper picks `chunk` so that the
//   units fall evenly on the blocks (ops/swin_attention.py::_persistent_runs).
//   The additive term of a unit is read once into registers (in the order
//   of the score accumulator, log2(e) folded in).
//   Block.  One warpgroup, 3 blocks an SM forward and 2 backward (at most
//   168 and 255 registers a thread), with 2 and 3 images' tiles in flight.
//   What bounds the time at these shapes is how many windows are being
//   worked on at once more than the bytes in flight, so no warp is spent on
//   producing alone; a fourth forward block, or a third backward one with
//   2 stages, was slower on the qkv layout.  Thread 0 issues an image's
//   loads by TMA into a stage as soon as the warpgroup is done with the
//   stage (at a named barrier the stores need anyway), and an mbarrier a
//   stage says "bytes landed".  Each operand has a rank-5 tensor map over
//   its (image, window, head, token, dim) strides, the dimensions sorted by
//   stride, with a box of 64 tokens: rows T..63 land as zeros, which is the
//   padding the products need, and so do the dims D..DP - 1 when D is not
//   16, 32 or 64 (DP, the padded head dim).  A tile row of DP bf16 is one
//   32-, 64- or 128-byte swizzle row, the layout the wgmma descriptors
//   read: K-major for Q K^T and dO V^T, MN-major (transposed) for P V,
//   dS K, dS^T Q and P^T dO.
//   Products.  A window is one m64 tile: S = Q K^T is m64n64 (T padded to 64
//   columns), O = P V takes P from the score registers as its A operand.
//   Backward: S and dP = dO V^T from shared memory, then p and ds in
//   registers; dQ = dS K from registers; p and ds go to shared memory once
//   (bf16, 128-byte swizzled) as the A operands of dK = dS^T Q and dV = P^T
//   dO.  The warpgroup waits for each product before the elementwise work,
//   so no accumulator is in flight across it; the other blocks on the SM
//   keep the tensor cores and the copies busy meanwhile.
//   Stores.  o (dq, dk, dv) go to a staging tile in shared memory, two a
//   kind, and out by TMA store, which clips rows past T and dims past D.
//   dbias / dadd.  The warpgroup sums ds over a unit's images in registers,
//   in order, and writes one partial a unit; the reduce kernels are the f32
//   core's (swin_attention_common.cuh).
// chip_k4_variants.py --section bf16 builds each choice above undone: the
// constants below by their values, and the routes that lost (cp.async tile
// loads, 4-byte stores from registers, a block a unit) by its own edits of
// this text.
//
// Supported: 2 <= T <= 64, D a multiple of 8 up to 64, every stride a
// multiple of 8 elements (16 bytes) and every operand 16-byte aligned.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "swin_attention_common.cuh"  // Layout, layout_at, reduce_grad_add

namespace {

using bf16 = __nv_bfloat16;

// Design choices; chip_k4_variants.py --section bf16 builds each other value.
constexpr int kFwdStages = 2;          // images' tiles in flight a block, forward
constexpr int kBwdStages = 3;          // and backward
// blocks an SM, forward and backward: the registers are budgeted for them
// and the grid is sized by them (fewer where shared memory holds fewer)
constexpr int kFwdBlocksPerSm = 3;
constexpr int kBwdBlocksPerSm = 2;

constexpr int kRows = 64;              // a window's rows, padded: one m64 tile
constexpr int kThreads = 128;          // one warpgroup
constexpr float kLog2e = 1.44269504088896341f;

// A (64, DP) bf16 tile: rows of DP * 2 bytes, one swizzle row each.
template <int DP>
struct Tile {
  static constexpr int kRowBytes = 2 * DP;
  static constexpr int kBytes = kRows * kRowBytes;
  static constexpr uint32_t kMask = DP == 64 ? 7 : DP == 32 ? 3 : 1;    // swizzle's row bits
  static constexpr uint64_t kLayout = DP == 64 ? 1 : DP == 32 ? 2 : 3;  // wgmma layout type
  static constexpr CUtensorMapSwizzle kSwizzle =
      DP == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
               : DP == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
};
// p and ds: (64 q rows, 64 kv columns) bf16, 128-byte rows
using PTile = Tile<64>;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The byte offset of (row-major) offset o in a swizzled tile: the 16-byte
// chunk index XOR the row bits above it (Swizzle<B, 4, 3>, what TMA and
// wgmma use), tiles aligned to 1024 bytes.
template <uint32_t kMask>
__device__ __forceinline__ uint32_t swz(uint32_t o) {
  return o ^ (((o >> 7) & kMask) << 4);
}

// ---- mbarriers, TMA, bulk stores -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Where a tensor map puts each of (token, head, window, image): its
// dimension (1..4; dimension 0 is the head dim).  The host sorts the four by
// stride.
struct Order {
  int t, h, w, b;
};

__device__ __forceinline__ int coord(const Order& o, int dim, int h, int w, int b) {
  return dim == o.h ? h : dim == o.w ? w : dim == o.b ? b : 0;  // token 0: the box is 64 rows
}

// The (T, D) rows of (head h, window w, image b) as a (64, DP) swizzled
// tile, zeros past them; completes on bar.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, const Order& o,
                                         uint64_t* bar, int h, int w, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(coord(o, 1, h, w, b)), "r"(coord(o, 2, h, w, b)), "r"(coord(o, 3, h, w, b)),
      "r"(coord(o, 4, h, w, b))
      : "memory");
}

// A staged (64, DP) tile out to the rows < T and dims < D of (h, w, b).
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const Order& o, const void* src,
                                          int h, int w, int b) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5, %6}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(0), "r"(coord(o, 1, h, w, b)), "r"(coord(o, 2, h, w, b)),
      "r"(coord(o, 3, h, w, b)), "r"(coord(o, 4, h, w, b))
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
// Until at most N committed store groups still read shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Generic-proxy writes to shared memory, before the async proxy (wgmma, TMA
// stores) reads them.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- wgmma -----------------------------------------------------------------------

// Shared-memory descriptor of a swizzled operand tile at addr: 8-row groups
// `sbo` bytes apart (K-major: rows of the operand; MN-major: k rows); the
// leading offset is not read for a K-major operand (16 by convention) and
// is the step between MN atoms for an MN-major one, never taken here (N and
// M are one atom wide); layout type as in Tile.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                         uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}
// K-major: a k step of 16 moves 32 bytes along the row.
template <int DP>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
  return desc(tile + 32 * kk, 16, 8 * Tile<DP>::kRowBytes, Tile<DP>::kLayout);
}
// MN-major: a k step of 16 moves 16 rows.
template <int DP>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int kk) {
  return desc(tile + 16 * kk * Tile<DP>::kRowBytes, 1024, 8 * Tile<DP>::kRowBytes,
              Tile<DP>::kLayout);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products' issue and wait.
template <int N>
__device__ __forceinline__ void pin(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i])::"memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // d (+)= A B, A (64 x 16) and B (16 x 16) in shared memory; TA, TB: MN-major
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // d (+)= A B, A (64 x 16) bf16 in registers, B (16 x 16) in shared memory
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

template <>
struct Wgmma<32> {
  // d (+)= A B, A (64 x 16) and B (16 x 32) in shared memory; TA, TB: MN-major
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // d (+)= A B, A (64 x 16) bf16 in registers, B (16 x 32) in shared memory
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

template <>
struct Wgmma<64> {
  // d (+)= A B, A (64 x 16) and B (16 x 64) in shared memory; TA, TB: MN-major
  template <int TA, int TB>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(acc), "n"(TA), "n"(TB));
  }
  // d (+)= A B, A (64 x 16) bf16 in registers, B (16 x 64) in shared memory
  template <int TB>
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc), "n"(TB));
  }
};

// ---- the window's arithmetic -------------------------------------------------------
//
// A warpgroup accumulator of N columns: thread (g, t) of warp w holds entry
// 4 j + e at row 16 w + g + 8 (e >> 1), column 8 j + 2 t + (e & 1).

// (lo, hi) rounded to bf16 (to nearest even) as one register, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = 0.0f;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Where a call's additive term is: that of head h and window w starts at
// add + h * add_h + (w / P) * add_blk + (w % P) * (T * lda + T), rows lda
// apart, plus mask + w * T * T when a mask is given.
struct Geo {
  int B, H, nW, T, D, P, lda;
  long long add_h, add_blk;
  float scale;
};

// This thread's entries of the additive term of (h, w), times log2(e);
// -inf in the columns past T (and 0 in rows past T, which are zeroed later).
__device__ __forceinline__ void load_add(float (&a)[32], const float* __restrict__ add,
                                         const float* __restrict__ mask, const Geo& geo, int h,
                                         int w, int row, int t) {
  const float* A = add + h * geo.add_h + (long long)(w / geo.P) * geo.add_blk +
                   (long long)(w % geo.P) * ((long long)geo.T * geo.lda + geo.T);
  const float* M = mask != nullptr ? mask + (long long)w * geo.T * geo.T : nullptr;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      float x = c < geo.T ? 0.0f : -INFINITY;
      if (r < geo.T && c < geo.T) {
        x = A[(long long)r * geo.lda + c];
        if (M != nullptr) x += M[r * geo.T + c];
        x *= kLog2e;
      }
      a[4 * j + e] = x;
    }
}

// s (the raw q k^T) -> p = softmax(s scale + add) in f32, normalised, in
// place; 0 in columns and rows past T.
__device__ __forceinline__ void probs(float (&s)[32], const float (&a)[32], float sb, int row,
                                      int T) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = fmaf(s[i], sb, a[i]);
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    s[i] = ex2(s[i] - mx[(i >> 1) & 1]);
    sum[(i >> 1) & 1] += s[i];
  }
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float total = quad_sum(sum[h]);  // every lane shuffles, whatever its row
    inv[h] = row + 8 * h < T ? 1.0f / total : 0.0f;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] *= inv[(i >> 1) & 1];
}

// Accumulator columns 16 kk .. 16 kk + 15 rounded to bf16 as the A operand
// of k step kk (register r: the pair (j, h) = (2 kk + r / 2, r % 2)).
__device__ __forceinline__ void as_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * (2 * kk + r / 2) + 2 * (r % 2);
      a[kk][r] = pack(s[i], s[i + 1]);
    }
}

// An (64, DP) accumulator times mul, rounded to bf16, into a staging tile
// (swizzled as the tensor maps write and read).
template <int DP>
__device__ __forceinline__ void stage(uint8_t* tile, const float (&acc)[DP / 2], float mul,
                                      int row, int t) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(
          tile + swz<Tile<DP>::kMask>((row + 8 * h) * Tile<DP>::kRowBytes + 16 * j + 4 * t)) =
          pack(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
}

// ---- the block ----------------------------------------------------------------------

// The runs of images: unit u is (run z, window w, head h), head fastest.
struct Units {
  int H, nW, B, chunk, count;
  __device__ __forceinline__ void at(int u, int& h, int& w, int& b0, int& b1) const {
    h = u % H;
    w = (u / H) % nW;
    b0 = (u / (H * nW)) * chunk;
    b1 = min(b0 + chunk, B);
  }
};

// Dynamic shared memory from a 1024-byte boundary (the swizzles' period).
__device__ __forceinline__ uint8_t* smem_base() {
  extern __shared__ uint8_t smem_raw[];
  return smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
}

// full[s]: stage s landed (thread 0's expect_tx, completed by the bytes).
__device__ __forceinline__ void init_barriers(uint64_t* full, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The tensor maps of a call's operands.
struct Maps {
  CUtensorMap in[4];   // q, k, v (and dO backward)
  CUtensorMap out[3];  // o (or dq, dk, dv)
};

// The loads of the block's images, kept `S` images ahead of the one being
// worked on: walks the block's units and their images in the order the
// work does.
template <int DP, int kIn>
struct Loads {
  const Maps& maps;
  Order oin, odo;
  const Units& units;
  int u, h, w, b, b1;  // the next image to load

  __device__ __forceinline__ void first() {
    u = blockIdx.x;
    if (u < units.count) units.at(u, h, w, b, b1);
  }

  // The next image's tiles into stage st, completing on full (if any image
  // is left).
  __device__ __forceinline__ void issue(uint8_t* st, uint64_t* full) {
    constexpr int kTile = Tile<DP>::kBytes;
    if (u >= units.count) return;
    if (threadIdx.x == 0) {
      mbar_expect_tx(full, kIn * kTile);
      for (int x = 0; x < kIn; ++x)
        tma_load(st + x * kTile, &maps.in[x], x == 3 ? odo : oin, full, h, w, b);
    }
    if (++b >= b1) {
      u += gridDim.x;
      if (u < units.count) units.at(u, h, w, b, b1);
    }
  }
};

template <int DP>
constexpr size_t fwd_smem() {
  return 1024 + (size_t)kFwdStages * 3 * Tile<DP>::kBytes + 2 * Tile<DP>::kBytes +
         kFwdStages * sizeof(uint64_t);
}

template <int DP>
constexpr size_t bwd_smem() {
  return 1024 + (size_t)kBwdStages * 4 * Tile<DP>::kBytes + 2 * PTile::kBytes +
         6 * Tile<DP>::kBytes + kBwdStages * sizeof(uint64_t);
}

// Forward: o = softmax(q k^T scale + add) v for every unit's images.
template <int DP>
__global__ void __launch_bounds__(kThreads, kFwdBlocksPerSm)
    window_fwd_kernel(const __grid_constant__ Maps maps, Order oin, Order oout,
                      const float* __restrict__ add, const float* __restrict__ mask, Geo geo,
                      Units units) {
  constexpr int S = kFwdStages, kTile = Tile<DP>::kBytes;
  uint8_t* ring = smem_base();                      // stage s: q, k, v tiles
  uint8_t* staging = ring + S * 3 * kTile;          // two o tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * kTile);
  init_barriers(full, S);
  Loads<DP, 3> loads{maps, oin, oin, units};
  loads.first();
  for (int s = 0; s < S; ++s) loads.issue(ring + s * 3 * kTile, full + s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, row = 16 * warp + g;  // and row + 8
  const float sb = geo.scale * kLog2e;
  float a[32];
  int i = 0;
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int h, w, b0, b1;
    units.at(u, h, w, b0, b1);
    load_add(a, add, mask, geo, h, w, row, t);
    for (int b = b0; b < b1; ++b, ++i) {
      const int s = i % S;
      const uint32_t tq = smem_u32(ring + s * 3 * kTile), tk = tq + kTile, tv = tk + kTile;
      mbar_wait(full + s, (i / S) & 1);

      float sc[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        Wgmma<64>::ss<0, 0>(sc, kmajor<DP>(tq, kk), kmajor<DP>(tk, kk), kk);
      wg_commit();
      wg_wait_all();
      pin(sc);
      probs(sc, a, sb, row, geo.T);
      uint32_t pa[4][4];
      as_a(pa, sc);

      // O = P V, P rounded to bf16 from the score registers
      float acc[DP / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<DP>::template rs<1>(acc, pa[kk], mnmajor<DP>(tv, kk), kk);
      wg_commit();
      wg_wait_all();
      pin(acc);
      if (threadIdx.x == 0) bulk_wait_read<1>();  // this tile's store two images ago
      __syncthreads();  // the stage is read (and the staging tile free)
      loads.issue(ring + s * 3 * kTile, full + s);

      uint8_t* tile = staging + (i & 1) * kTile;
      stage<DP>(tile, acc, 1.0f, row, t);
      fence_async();
      __syncthreads();
      if (threadIdx.x == 0) {
        tma_store(&maps.out[0], oout, tile, h, w, b);
        bulk_commit();
      }
    }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// Backward: dq, dk, dv for every unit's images, and part[z][h][w] (runs, H,
// nW, T, T), the sum of the f32 ds over unit (z, w, h)'s images.
template <int DP>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSm)
    window_bwd_kernel(const __grid_constant__ Maps maps, Order oin, Order odo, Order ograd,
                      const float* __restrict__ add, const float* __restrict__ mask,
                      float* __restrict__ part, Geo geo, Units units) {
  constexpr int S = kBwdStages, kTile = Tile<DP>::kBytes;
  uint8_t* ring = smem_base();                     // stage s: q, k, v, dO tiles
  uint8_t* sP = ring + S * 4 * kTile;              // p, then ds: (64, 64) bf16 each
  uint8_t* sdS = sP + PTile::kBytes;
  uint8_t* staging = sdS + PTile::kBytes;          // dq, dk, dv tiles, twice
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 6 * kTile);
  init_barriers(full, S);
  Loads<DP, 4> loads{maps, oin, odo, units};
  loads.first();
  for (int s = 0; s < S; ++s) loads.issue(ring + s * 4 * kTile, full + s);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, row = 16 * warp + g;  // and row + 8
  const float sb = geo.scale * kLog2e;
  const uint32_t pa_tile = smem_u32(sP), ds_tile = smem_u32(sdS);
  float a[32], dsum[32];
  int i = 0;
  for (int u = blockIdx.x; u < units.count; u += gridDim.x) {
    int h, w, b0, b1;
    units.at(u, h, w, b0, b1);
    load_add(a, add, mask, geo, h, w, row, t);
    zero(dsum);
    for (int b = b0; b < b1; ++b, ++i) {
      const int s = i % S;
      const uint32_t tq = smem_u32(ring + s * 4 * kTile), tk = tq + kTile, tv = tk + kTile,
                     tdo = tv + kTile;
      mbar_wait(full + s, (i / S) & 1);

      // S = Q K^T and dP = dO V^T
      float p[32], ds[32];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        Wgmma<64>::ss<0, 0>(p, kmajor<DP>(tq, kk), kmajor<DP>(tk, kk), kk);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        Wgmma<64>::ss<0, 0>(ds, kmajor<DP>(tdo, kk), kmajor<DP>(tv, kk), kk);
      wg_commit();
      wg_wait_all();
      pin(p);
      pin(ds);

      // p, then ds = p (dp - rowsum(dp p)) in f32 (0 outside the T x T square)
      probs(p, a, sb, row, geo.T);
      float dot[2] = {0.0f, 0.0f};
#pragma unroll
      for (int x = 0; x < 32; ++x) dot[(x >> 1) & 1] = fmaf(ds[x], p[x], dot[(x >> 1) & 1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) dot[hh] = quad_sum(dot[hh]);
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        ds[x] = p[x] * (ds[x] - dot[(x >> 1) & 1]);
        dsum[x] += ds[x];
      }
      // p and ds to shared memory in bf16, as the A operands of dV and dK
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const uint32_t off = swz<PTile::kMask>((row + 8 * hh) * PTile::kRowBytes + 16 * j + 4 * t);
          *reinterpret_cast<uint32_t*>(sP + off) = pack(p[4 * j + 2 * hh], p[4 * j + 2 * hh + 1]);
          *reinterpret_cast<uint32_t*>(sdS + off) =
              pack(ds[4 * j + 2 * hh], ds[4 * j + 2 * hh + 1]);
        }
      uint32_t dsa[4][4];
      as_a(dsa, ds);
      fence_async();
      if (threadIdx.x == 0) bulk_wait_read<1>();  // these staging tiles' stores
      __syncthreads();  // p and ds of every row are in, and the staging tiles free

      // dQ = dS K (dS from registers), dK = dS^T Q, dV = P^T dO
      float gq[DP / 2], gk[DP / 2], gv[DP / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) Wgmma<DP>::template rs<1>(gq, dsa[kk], mnmajor<DP>(tk, kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<DP>::template ss<1, 1>(gk, mnmajor<64>(ds_tile, kk), mnmajor<DP>(tq, kk), kk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<DP>::template ss<1, 1>(gv, mnmajor<64>(pa_tile, kk), mnmajor<DP>(tdo, kk), kk);
      wg_commit();
      wg_wait_all();
      pin(gq);
      pin(gk);
      pin(gv);

      uint8_t* tiles = staging + (i & 1) * 3 * kTile;
      stage<DP>(tiles, gq, geo.scale, row, t);
      stage<DP>(tiles + kTile, gk, geo.scale, row, t);
      stage<DP>(tiles + 2 * kTile, gv, 1.0f, row, t);
      fence_async();
      __syncthreads();  // the stage is read (and the staging tiles written)
      loads.issue(ring + s * 4 * kTile, full + s);
      if (threadIdx.x == 0) {
        for (int x = 0; x < 3; ++x) tma_store(&maps.out[x], ograd, tiles + x * kTile, h, w, b);
        bulk_commit();
      }
    }
    const long long TT = (long long)geo.T * geo.T;
    float* dst = part + ((long long)(b0 / units.chunk) * geo.H * geo.nW + (long long)h * geo.nW + w) * TT;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
        if (r < geo.T && c < geo.T) dst[r * geo.T + c] = dsum[4 * j + e];
      }
  }
  if (threadIdx.x == 0) bulk_wait_all();
}

// ---- host ---------------------------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The order of a layout's four outer dimensions in its tensor maps: by
// stride, smallest first (ties: token, head, window, image).
Order order_of(const Layout& l) {
  const long long st[4] = {l.t, l.h, l.w, l.b};
  int dim[4];
  for (int x = 0; x < 4; ++x) {
    dim[x] = 1;
    for (int y = 0; y < 4; ++y)
      if (st[y] < st[x] || (st[y] == st[x] && y < x)) ++dim[x];
  }
  return Order{dim[0], dim[1], dim[2], dim[3]};
}

// A tensor map over the (B, nW, H, T, D) bf16 view at base with strides l
// (elements), its dimensions in the order o, read and written as (64, DP)
// swizzled boxes of one (image, window, head).
template <int DP>
cudaError_t make_map(CUtensorMap* map, const void* base, const Layout& l, const Order& o,
                     const Geo& g) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[5], strides[4];
  cuuint32_t box[5] = {(cuuint32_t)DP, 1, 1, 1, 1}, step[5] = {1, 1, 1, 1, 1};
  dims[0] = g.D;
  const int at[4] = {o.t, o.h, o.w, o.b};
  const long long size[4] = {g.T, g.H, g.nW, g.B}, st[4] = {l.t, l.h, l.w, l.b};
  for (int x = 0; x < 4; ++x) {
    dims[at[x]] = (cuuint64_t)size[x];
    strides[at[x] - 1] = (cuuint64_t)st[x] * sizeof(bf16);
  }
  box[o.t] = kRows;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides,
             box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, Tile<DP>::kSwizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The blocks of kKernel the card holds at once, at most per_sm_max an SM,
// worked out once a device and thread.  The first call on a thread allows
// the kernel's shared memory, a runtime call that also makes the device's
// context current there: the tensor-map encoder needs it, and an autograd
// thread may not have it yet.
template <auto kKernel>
cudaError_t slots_of(size_t smem, int per_sm_max, int* slots) {
  thread_local int known[64] = {};  // by device; 0: not yet asked
  int dev, sms, per_sm;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if (dev < 64 && known[dev] > 0) {
    *slots = known[dev];
    return cudaSuccess;
  }
  if ((err = allow_smem(kKernel, smem)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, smem)) !=
          cudaSuccess)
    return err;
  per_sm = std::min(per_sm, per_sm_max);
  if (per_sm <= 0) return cudaErrorInvalidConfiguration;
  *slots = sms * per_sm;
  if (dev < 64) known[dev] = *slots;
  return cudaSuccess;
}

// Persistent: as many blocks as the card holds at once (fewer if the units
// are fewer), each walking its share of the units.
unsigned grid_of(int units, int slots) { return (unsigned)std::min(units, slots); }

template <int DP>
int fwd(const bf16* q, const bf16* k, const bf16* v, const float* add, const float* mask,
        bf16* o, const Geo& g, const Layout& in, const Layout& out, const Units& units,
        cudaStream_t st) {
  int slots;  // slots_of first: the encoder needs the context it makes current
  cudaError_t err = slots_of<window_fwd_kernel<DP>>(fwd_smem<DP>(), kFwdBlocksPerSm, &slots);
  if (err != cudaSuccess) return err;
  Maps maps;
  const Order oin = order_of(in), oout = order_of(out);
  if ((err = make_map<DP>(&maps.in[0], q, in, oin, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.in[1], k, in, oin, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.in[2], v, in, oin, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.out[0], o, out, oout, g)) != cudaSuccess)
    return err;
  window_fwd_kernel<DP><<<grid_of(units.count, slots), kThreads, fwd_smem<DP>(), st>>>(
      maps, oin, oout, add, mask, g, units);
  return cudaGetLastError();
}

template <int DP>
int bwd(const bf16* q, const bf16* k, const bf16* v, const float* add, const float* mask,
        const bf16* dout, bf16* dq, bf16* dk, bf16* dv, float* part, const Geo& g,
        const Layout& in, const Layout& dol, const Layout& gl, const Units& units,
        cudaStream_t st) {
  int slots;
  cudaError_t err = slots_of<window_bwd_kernel<DP>>(bwd_smem<DP>(), kBwdBlocksPerSm, &slots);
  if (err != cudaSuccess) return err;
  Maps maps;
  const Order oin = order_of(in), odo = order_of(dol), ograd = order_of(gl);
  if ((err = make_map<DP>(&maps.in[0], q, in, oin, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.in[1], k, in, oin, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.in[2], v, in, oin, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.in[3], dout, dol, odo, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.out[0], dq, gl, ograd, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.out[1], dk, gl, ograd, g)) != cudaSuccess ||
      (err = make_map<DP>(&maps.out[2], dv, gl, ograd, g)) != cudaSuccess)
    return err;
  window_bwd_kernel<DP><<<grid_of(units.count, slots), kThreads, bwd_smem<DP>(), st>>>(
      maps, oin, odo, ograd, add, mask, part, g, units);
  return cudaGetLastError();
}

// f(dp) with the padded head dim (16, 32 or 64) as an integral constant.
template <typename F>
int dispatch(int D, F f) {
  if (D <= 16) return f(std::integral_constant<int, 16>{});
  if (D <= 32) return f(std::integral_constant<int, 32>{});
  return f(std::integral_constant<int, 64>{});
}

bool bad_geo(const Geo& g, int chunk, int runs) {
  return g.B <= 0 || g.H <= 0 || g.nW <= 0 || g.T < 2 || g.T > kRows || g.D <= 0 || g.D > 64 ||
         g.D % 8 != 0 || g.P <= 0 || g.nW % g.P != 0 || g.lda < g.T || chunk <= 0 ||
         runs <= 0 || (long long)chunk * runs < g.B || (long long)chunk * (runs - 1) >= g.B ||
         (long long)g.H * g.nW * runs > 0x7fffffff;
}

// TMA moves 16-byte pieces from and to 16-byte aligned addresses: every
// stride a multiple of 8 elements.
bool bad_layout(const Layout& l) {
  return l.b % 8 || l.w % 8 || l.h % 8 || l.t % 8 || l.b <= 0 || l.w <= 0 || l.h <= 0 ||
         l.t <= 0;
}

bool misaligned(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; }

Geo make_geo(int B, int H, int nW, int T, int D, int P, long long add_h, long long add_blk,
             int lda, float scale) {
  Geo g;
  g.B = B;
  g.H = H;
  g.nW = nW;
  g.T = T;
  g.D = D;
  g.P = P;
  g.lda = lda;
  g.add_h = add_h;
  g.add_blk = add_blk;
  g.scale = scale;
  return g;
}

}  // namespace

// Forward.  q, k, v and o bf16, read and written through strides (host
// array of 8: image, window, head and token strides of q, k and v, then of
// o, in elements, multiples of 8; the head dim contiguous).  The additive
// term f32 as in Geo (batched: add = bias (H, T, T), P = 1, add_h = T * T,
// add_blk = 0, lda = T, mask (nW, T, T) or null; packed: add (H, nblk, P T,
// P T), add_h = nblk (P T)^2, add_blk = (P T)^2, lda = P T, mask null),
// contiguous.  Images are taken `chunk` to a unit, runs = ceil(B / chunk).
// Returns a cudaError_t.
extern "C" int swin_attention_fwd_bf16(const void* q, const void* k, const void* v,
                                       const float* add, const float* mask, void* o,
                                       const long long* strides, int B, int H, int nW, int T,
                                       int D, int P, long long add_h, long long add_blk, int lda,
                                       int chunk, int runs, float scale, void* stream) {
  const Geo g = make_geo(B, H, nW, T, D, P, add_h, add_blk, lda, scale);
  const Layout in = layout_at(strides, 0), out = layout_at(strides, 1);
  if (bad_geo(g, chunk, runs) || bad_layout(in) || bad_layout(out) || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(o))
    return cudaErrorInvalidValue;
  const Units units{H, nW, B, chunk, H * nW * runs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(D, [&](auto dp) {
    return fwd<decltype(dp)::value>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                                    static_cast<const bf16*>(v), add, mask, static_cast<bf16*>(o),
                                    g, in, out, units, st);
  });
}

// Backward.  The same geometry as the forward; strides (host array of 12):
// q, k, v, then dout, then dq, dk, dv; part: (runs, H, nW, T, T) f32
// scratch.  grad_add gets dbias (H, T, T) when packed is 0, and dadd (H,
// nW / P, P T, P T) when it is 1.  Returns a cudaError_t.
extern "C" int swin_attention_bwd_bf16(const void* q, const void* k, const void* v,
                                       const float* add, const float* mask, const void* dout,
                                       void* dq, void* dk, void* dv, float* part,
                                       float* grad_add, int packed, const long long* strides,
                                       int B, int H, int nW, int T, int D, int P,
                                       long long add_h, long long add_blk, int lda, int chunk,
                                       int runs, float scale, void* stream) {
  const Geo g = make_geo(B, H, nW, T, D, P, add_h, add_blk, lda, scale);
  const Layout in = layout_at(strides, 0), dol = layout_at(strides, 1);
  const Layout gl = layout_at(strides, 2);
  if (bad_geo(g, chunk, runs) || bad_layout(in) || bad_layout(dol) || bad_layout(gl) ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout) || misaligned(dq) ||
      misaligned(dk) || misaligned(dv))
    return cudaErrorInvalidValue;
  const Units units{H, nW, B, chunk, H * nW * runs};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = dispatch(D, [&](auto dp) {
    return bwd<decltype(dp)::value>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        add, mask, static_cast<const bf16*>(dout), static_cast<bf16*>(dq), static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), part, g, in, dol, gl, units, st);
  });
  if (err != cudaSuccess) return err;
  return reduce_grad_add(part, grad_add, packed, runs, H, nW, P, T, st);
}

// The blocks the forward (backward = 0) or backward kernel for head dim D
// runs at once on the current device, into *slots: the wrapper sizes the
// runs of images by it.  Returns a cudaError_t.
extern "C" int swin_attention_bf16_slots(int D, int backward, int* slots) {
  if (D <= 0 || D > 64 || D % 8) return cudaErrorInvalidValue;
  return dispatch(D, [&](auto dp) {
    constexpr int DP = decltype(dp)::value;
    return (int)(backward
                     ? slots_of<window_bwd_kernel<DP>>(bwd_smem<DP>(), kBwdBlocksPerSm, slots)
                     : slots_of<window_fwd_kernel<DP>>(fwd_smem<DP>(), kFwdBlocksPerSm, slots));
  });
}
