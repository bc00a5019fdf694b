// Swin window attention, softmax(q k^T * scale + add) v per window, forward
// and backward, on Hopper (sm_90a), f32 in and out, products on the tensor
// cores; its bf16 form (q, k, v and their gradients bf16) is
// swin_attention_bf16.cu.
//
// Replaces the TPU kernels of vit_reranking_tpu/ops/swin_attention_pallas.py:
//   K4b, the batched contract: _fwd_kernel (:77, with _attn_probs :63,
//       launched by _swa_fwd :162) and _bwd_kernel (:88, launched by
//       _swa_bwd :181).  q, k, v (G, nW, T, D) with G = H * B, head slowest
//       (g / B is the head); additive term bias[h] + mask[w], bias (H, T, T),
//       mask (nW, T, T) or none.  The backward returns dbias (H, T, T), the
//       sum over the B images and nW windows of each head.
//   K4a, the packed contract: _packed_fwd_kernel (:218, launched by
//       _packed_fwd :323) and _packed_bwd_kernel (:234, launched by
//       _packed_bwd :340).  P windows packed into one (P T, D) operand per
//       block of windows, additive term add (H, nblk, P T, P T): the
//       block-diagonal bias + mask, -1e9 off the diagonal blocks
//       (_packed_add_term :288).  The backward returns dadd of add's shape,
//       summed over the B images of each head.
//
// One window core serves both contracts.  The TPU packs windows only to
// feed its 128-wide matrix unit; the products across windows are thrown
// away, since -1e9 off the diagonal blocks makes exp(s - m) exactly 0 in
// f32, and so are those entries of ds and dadd.  Here each (T, T) window
// problem is solved on its own: for the packed contract the core reads
// only the diagonal (T, T) blocks of add, and writes zeros to dadd's other
// entries, which is the same function without the P-fold waste.
//
// Operands are read and written through strides: element (image b, window
// w, head h, token t, dim d) of q, k, v lies at q + b sb + w sw + h sh +
// t st + d, with one set of strides for q, k, v, one for o, one for dO and
// one for dq, dk, dv.  Contiguous (G, nW, T, D) strides give the two
// contracts; the model's qkv projection (B nW, T, 3 H D) is read in place,
// and o (B nW, T, H D) and dq, dk, dv (slices of one (B nW, T, 3 H D)
// tensor) are written in the layouts its two Linears use, so no copy of q,
// k, v, o or their gradients exists around the kernel.
//
// What bounds it: bytes.  At Swin-T stage 0 and batch 112 (G = 336,
// nW = 64, T = 49, D = 32) the forward reads q, k, v and writes o, 4 x 135
// MB, 0.16 ms at 3.35 TB/s; the backward moves 7 such tensors, 0.28 ms.
// The forward's 6.6 GFLOP (4 T^2 D a window), as three TF32 products on
// padded tiles, is 30 GFLOP of mma.sync, about 0.1 ms at the 300 TFLOP/s
// mma.sync reaches on this card; the backward's 2.5 times that.
//
// Design.
//   Products.  Every product runs on the tensor cores (mma.sync m16n8k8
//   TF32) as three TF32 products, as in kv_attention.cu: hi = tf32(x)
//   (round to nearest, ties away), lo = x - hi, a b ~ hi hi + hi lo + lo hi
//   with the small terms in their own accumulator chain (mma's accumulator
//   does not round to nearest), so f32 accuracy survives.  Every product
//   here is one fresh pair of chains of at most 8 k-steps.
//   Tiles.  A window is padded to 16 W rows (W warps: 4 for T = 49, 64
//   rows) and 8 NC columns (NC n-tiles: 7 for T = 49, 56 columns), not to
//   64 x 64.  Warp i owns q rows 16 i .. 16 i + 15: its scores, softmax
//   and probabilities stay in registers, and P feeds P V (and dS feeds
//   dS K) from the accumulator registers, its columns 2t, 2t + 1 taken as
//   k = t, t + 4 with the B operand's rows read in the same order.
//   Occupancy.  One block of W warps owns one (window, head) and walks a
//   run of images, so its additive term is read once into registers.  In
//   the forward the next image's q, k, v come in by cp.async into a second
//   buffer while this one is computed: 51 KB a block at D = 32, 4 blocks
//   (16 warps) an SM.  The backward would need 104 KB and 240 registers a
//   thread for the same, 2 blocks an SM; with one buffer (69 KB) and 168
//   registers it fits 3, whose warps cover the copies better
//   (kFwdStages, kBwdStages; chip_k4_variants.py times both).  Rows of a
//   tile are D + 4 floats apart, so fragment loads touch 32 distinct banks.
//   Backward.  p is recomputed from q, k and add (nothing is saved but
//   the inputs, as on the TPU); dp = dO v^T, ds = p (dp - rowsum(dp p)),
//   dq = ds k scale from registers; p and ds go to shared memory once, and
//   warp i then owns kv rows 16 i .. of dv = p^T dO and dk = ds^T q scale.
//   The block sums ds over its images in registers, in order, and writes
//   one partial per (run of images, head, window); blocks run in no order,
//   so a second launch sums the partials in a fixed order (no float
//   atomics: the result is the same from run to run) into dbias, or into
//   dadd's diagonal blocks with zeros elsewhere.
//
// Supported: 2 <= T <= 64, D a multiple of 8 up to 64, every stride a
// multiple of 4 floats and every operand 16-byte aligned.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "swin_attention_common.cuh"  // Layout, layout_at, reduce_grad_add

namespace {

// ---- tensor-core products in 3xTF32 (as in kv_attention.cu) ---------------

struct FragA {  // a 16 x 8 A operand, split
  uint32_t hi[4], lo[4];
};
struct FragB {  // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
};

// hi = x rounded to TF32, to nearest with ties away from zero (the rounding
// of cvt.rna.tf32.f32, in two integer instructions); lo = x - hi (exact),
// whose low 13 bits the tensor core drops.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a b as big += hi hi and small += lo hi + hi lo, two chains that the
// caller adds in f32 when the sum is complete.
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(small, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(small, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(big, a.hi, b.hi[0], b.hi[1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
}

// Fragments of shared tiles, row-major with S floats a row; g = lane / 4,
// t = lane % 4.  The A operand at rows r0.., columns c0..: a0 (g, t),
// a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
template <int S>
__device__ __forceinline__ FragA load_a(const float* s, int r0, int c0, int g, int t) {
  const float* p = s + (r0 + g) * S + c0 + t;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8 * S], f.hi[1], f.lo[1]);
  split(p[4], f.hi[2], f.lo[2]);
  split(p[8 * S + 4], f.hi[3], f.lo[3]);
  return f;
}

// The A operand of a product with a transposed tile, A[r][c] = s[c][r],
// with k in the order acc_as_a gives it (k = t is column 2t, k = t + 4
// column 2t + 1): a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8,
// 2t + 1).  With S = 4 (mod 16) the warp touches 32 distinct banks.
template <int S>
__device__ __forceinline__ FragA load_at(const float* s, int r0, int c0, int g, int t) {
  const float* p = s + (c0 + 2 * t) * S + r0 + g;
  FragA f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[8], f.hi[1], f.lo[1]);
  split(p[S], f.hi[2], f.lo[2]);
  split(p[S + 8], f.hi[3], f.lo[3]);
  return f;
}

// The B operand of a product with a transposed tile (x y^T): element (k, n)
// is s[n0 + n][k0 + k], so b0 = s[n0 + g][k0 + t], b1 = s[n0 + g][k0 + t + 4].
template <int S>
__device__ __forceinline__ FragB load_b_nk(const float* s, int n0, int k0, int g, int t) {
  const float* p = s + (n0 + g) * S + k0 + t;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[4], f.hi[1], f.lo[1]);
  return f;
}

// The B operand of a product with a tile as it is (x y), element (k, n) is
// s[k0 + k][n0 + n], with k in the order acc_as_a and load_at give it: b0
// is row k0 + 2t, b1 row k0 + 2t + 1.
template <int S>
__device__ __forceinline__ FragB load_b_kn(const float* s, int k0, int n0, int g, int t) {
  const float* p = s + (k0 + 2 * t) * S + n0 + g;
  FragB f;
  split(p[0], f.hi[0], f.lo[0]);
  split(p[S], f.hi[1], f.lo[1]);
  return f;
}

// An accumulator tile (16 x 8, c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t),
// c3 (g + 8, 2t + 1)) as the A operand of the next product, its columns
// 2t and 2t + 1 taken as k = t and t + 4.
__device__ __forceinline__ FragA acc_as_a(const float (&c)[4]) {
  FragA f;
  split(c[0], f.hi[0], f.lo[0]);
  split(c[2], f.hi[1], f.lo[1]);
  split(c[1], f.hi[2], f.lo[2]);
  split(c[3], f.hi[3], f.lo[3]);
  return f;
}

// big + small = sum over K k-steps of load_a(k) times load_b(k, n), for N
// n-tiles, in fresh chains.
template <int K, int N, typename LoadA, typename LoadB>
__device__ __forceinline__ void product(float (&big)[N][4], float (&small)[N][4], LoadA load_a,
                                        LoadB load_b) {
  zero(big);
  zero(small);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const FragA a = load_a(k);
#pragma unroll
    for (int n = 0; n < N; ++n) mma3(big[n], small[n], a, load_b(k, n));
  }
}

// ---- asynchronous tile copies ---------------------------------------------

// 16 bytes from global to shared memory without passing through registers
// (cp.async); zeros instead when `ok` is false.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Start copying a window's (T, D) rows, `st` floats apart, into an R x
// (DP + 4) shared tile; zeros past row T and column D (D is a multiple of
// 8, so a 4-float group is all in or all out).
template <int DP, int R, int kThreads>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g, long long st,
                                          int T, int D) {
  constexpr int SD = DP + 4, C4 = DP / 4;
  for (int e = threadIdx.x; e < R * C4; e += kThreads) {
    const int r = e / C4, c = (e % C4) * 4;
    const bool ok = r < T && c < D;
    copy16(s + r * SD + c, ok ? g + r * st + c : g, ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---- the window core --------------------------------------------------------

// Where a call's operands are.  The additive term of head h and window w
// starts at add + h * add_h + (w / P) * add_blk + (w % P) * (T * lda + T)
// with row stride lda, plus mask + w * T * T when a mask is given.
struct Geo {
  int B, H, nW, T, D, P, lda;
  long long add_h, add_blk;
  float scale;
};

// Warps a window takes (16 q rows each) for NC n-tiles of 8 columns.
template <int NC>
constexpr int kWarpsOf = (NC + 1) / 2;

// This thread's entries of the additive term of (head h, window w): rows
// r0 + g (+ 8), columns 8 j + 2t (+ 1); 0 outside the T x T square.
template <int NC>
__device__ __forceinline__ void load_add(float (&a)[NC][4], const float* __restrict__ add,
                                         const float* __restrict__ mask, const Geo& geo, int h,
                                         int w, int r0, int g, int t) {
  const float* A = add + h * geo.add_h + (long long)(w / geo.P) * geo.add_blk +
                   (long long)(w % geo.P) * ((long long)geo.T * geo.lda + geo.T);
  const float* M = mask != nullptr ? mask + (long long)w * geo.T * geo.T : nullptr;
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      float x = 0.0f;
      if (r < geo.T && c < geo.T) {
        x = A[(long long)r * geo.lda + c];
        if (M != nullptr) x += M[r * geo.T + c];
      }
      a[j][e] = x;
    }
}

// s + sl (the raw q k^T) -> exp(s * scale + a - rowmax) over the columns
// < T, 0 elsewhere; inv[h] = 1 / rowsum for rows r0 + g + 8 h < T, else 0.
template <int NC>
__device__ __forceinline__ void softmax_rows(float (&s)[NC][4], const float (&sl)[NC][4],
                                             const float (&a)[NC][4], int T, float scale,
                                             int row, int t, float (&inv)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool ok = 8 * j + 2 * t + (e & 1) < T;
      s[j][e] = ok ? (s[j][e] + sl[j][e]) * scale + a[j][e] : -INFINITY;
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = s[j][e] == -INFINITY ? 0.0f : expf(s[j][e] - mx[e >> 1]);
      sum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] = quad_sum(sum[h]);
    inv[h] = row + 8 * h < T && sum[h] > 0.0f ? 1.0f / sum[h] : 0.0f;
  }
}

// Rows row, row + 8 (< T) and columns 8 n + 2t, + 1 (< D) of (big + small)
// times mul[h] into a window whose rows are `st` floats apart.
template <int ND>
__device__ __forceinline__ void store_rows(float* __restrict__ out, long long st,
                                           const float (&big)[ND][4], const float (&small)[ND][4],
                                           const float (&mul)[2], int row, int T, int D, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= T) continue;
    float* p = out + (row + 8 * h) * st + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      if (8 * n < D)
        *reinterpret_cast<float2*>(p + 8 * n) =
            make_float2((big[n][2 * h] + small[n][2 * h]) * mul[h],
                        (big[n][2 * h + 1] + small[n][2 * h + 1]) * mul[h]);
  }
}

// Buffers of tiles a block cycles through: the copies of the next
// kStages - 1 images are in flight while this one is computed.
constexpr int kFwdStages = 2;
constexpr int kBwdStages = 1;

// The next image's copies (if any) are started, then this image's awaited:
// every iteration commits one group, empty or not, so that the group this
// iteration needs is always kStages - 1 groups old.
template <int kStages, typename Fetch>
__device__ __forceinline__ void next_image(int b, int b0, int b1, float* tiles, int buf,
                                           Fetch fetch) {
  const int ahead = b + kStages - 1;
  if (ahead < b1) fetch(ahead, tiles + ((ahead - b0) % kStages) * buf);
  copy_commit();
  copy_wait<kStages - 1>();
  __syncthreads();  // this image's tiles are in, for every thread
}

template <int NC, int DP>
constexpr size_t fwd_smem() {
  constexpr int RQ = 16 * kWarpsOf<NC>, RK = 8 * NC;
  return (size_t)kFwdStages * (RQ + 2 * RK) * (DP + 4) * sizeof(float);
}

template <int NC, int DP>
constexpr size_t bwd_smem() {
  constexpr int RQ = 16 * kWarpsOf<NC>, RK = 8 * NC;
  return ((size_t)kBwdStages * (2 * RQ + 2 * RK) * (DP + 4) + 2 * RQ * (RQ + 4)) * sizeof(float);
}

// grid (nW, H, runs of `chunk` images), 32 W threads
template <int NC, int DP>
__global__ void __launch_bounds__(32 * kWarpsOf<NC>, DP <= 32 ? 4 : 2)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ add,
               const float* __restrict__ mask, float* __restrict__ o, Geo geo, Layout in,
               Layout out, int chunk) {
  constexpr int kThreads = 32 * kWarpsOf<NC>;
  constexpr int RQ = 16 * kWarpsOf<NC>, RK = 8 * NC, S = DP + 4, ND = DP / 8;
  constexpr int kBuf = (RQ + 2 * RK) * S;
  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);

  const int w = blockIdx.x, h = blockIdx.y;
  const int b0 = blockIdx.z * chunk, b1 = min(b0 + chunk, geo.B);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first q row
  const long long at_in = w * in.w + h * in.h, at_out = w * out.w + h * out.h;
  float a[NC][4];
  load_add<NC>(a, add, mask, geo, h, w, r0, g, t);

  auto fetch = [&](int b, float* buf) {
    const long long at = at_in + b * in.b;
    load_tile<DP, RQ, kThreads>(buf, q + at, in.t, geo.T, geo.D);
    load_tile<DP, RK, kThreads>(buf + RQ * S, k + at, in.t, geo.T, geo.D);
    load_tile<DP, RK, kThreads>(buf + (RQ + RK) * S, v + at, in.t, geo.T, geo.D);
  };
  for (int i = 0; i < kFwdStages - 1; ++i) {
    if (b0 + i < b1) fetch(b0 + i, tiles + i * kBuf);
    copy_commit();
  }
  for (int b = b0; b < b1; ++b) {
    next_image<kFwdStages>(b, b0, b1, tiles, kBuf, fetch);
    const float* cur = tiles + ((b - b0) % kFwdStages) * kBuf;
    const float *sQ = cur, *sK = cur + RQ * S, *sV = sK + RK * S;

    // S = q k^T, then the softmax's numerators in place
    float s[NC][4], sl[NC][4], inv[2];
    product<ND, NC>(s, sl, [&](int ks) { return load_a<S>(sQ, r0, 8 * ks, g, t); },
                    [&](int ks, int j) { return load_b_nk<S>(sK, 8 * j, 8 * ks, g, t); });
    softmax_rows<NC>(s, sl, a, geo.T, geo.scale, r0 + g, t, inv);

    // O = P V / rowsum, P straight from the score registers
    float big[ND][4], small[ND][4];
    product<NC, ND>(big, small, [&](int j) { return acc_as_a(s[j]); },
                    [&](int j, int n) { return load_b_kn<S>(sV, 8 * j, 8 * n, g, t); });
    store_rows<ND>(o + at_out + b * out.b, out.t, big, small, inv, r0 + g, geo.T, geo.D, t);
    __syncthreads();  // every read of this buffer is done
  }
}

// grid (nW, H, runs of `chunk` images), 32 W threads; part: (runs, H, nW,
// T, T), the run's sum of ds over its images.
template <int NC, int DP>
__global__ void __launch_bounds__(32 * kWarpsOf<NC>, DP <= 32 ? 3 : 1)
    bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ add,
               const float* __restrict__ mask, const float* __restrict__ dout,
               float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ part, Geo geo, Layout in, Layout dol, Layout gl, int chunk) {
  constexpr int kThreads = 32 * kWarpsOf<NC>;
  constexpr int RQ = 16 * kWarpsOf<NC>, RK = 8 * NC, S = DP + 4, ND = DP / 8;
  constexpr int SP = RQ + 4;  // row stride of p and ds: 4 (mod 16) for load_at
  constexpr int kBuf = (2 * RQ + 2 * RK) * S;
  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);  // q, dO, k, v (twice)
  float* sP = tiles + kBwdStages * kBuf;           // RQ x SP: p[q row][kv column]
  float* sdS = sP + RQ * SP;

  const int w = blockIdx.x, h = blockIdx.y;
  const int b0 = blockIdx.z * chunk, b1 = min(b0 + chunk, geo.B);
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int r0 = (threadIdx.x / 32) * 16;  // the warp's first q row, then kv row
  const long long at_in = w * in.w + h * in.h, at_do = w * dol.w + h * dol.h;
  const long long at_g = w * gl.w + h * gl.h;
  const float ones[2] = {1.0f, 1.0f}, scales[2] = {geo.scale, geo.scale};
  float a[NC][4], dsum[NC][4];
  load_add<NC>(a, add, mask, geo, h, w, r0, g, t);
  zero(dsum);
  // kv columns past 8 NC of p and ds are read (into rows of dk and dv
  // past T, which are not stored) but never written: keep them finite
  for (int e = threadIdx.x; e < 2 * RQ * SP; e += kThreads) sP[e] = 0.0f;

  auto fetch = [&](int b, float* buf) {
    const long long at = at_in + b * in.b;
    load_tile<DP, RQ, kThreads>(buf, q + at, in.t, geo.T, geo.D);
    load_tile<DP, RQ, kThreads>(buf + RQ * S, dout + at_do + b * dol.b, dol.t, geo.T, geo.D);
    load_tile<DP, RK, kThreads>(buf + 2 * RQ * S, k + at, in.t, geo.T, geo.D);
    load_tile<DP, RK, kThreads>(buf + (2 * RQ + RK) * S, v + at, in.t, geo.T, geo.D);
  };
  for (int i = 0; i < kBwdStages - 1; ++i) {
    if (b0 + i < b1) fetch(b0 + i, tiles + i * kBuf);
    copy_commit();
  }
  for (int b = b0; b < b1; ++b) {
    next_image<kBwdStages>(b, b0, b1, tiles, kBuf, fetch);
    const float* cur = tiles + ((b - b0) % kBwdStages) * kBuf;
    const float *sQ = cur, *sdO = cur + RQ * S, *sK = cur + 2 * RQ * S, *sV = sK + RK * S;
    const long long gat = at_g + b * gl.b;

    // p = softmax(q k^T * scale + add), rows past T zero
    float p[NC][4], lo[NC][4], inv[2];
    product<ND, NC>(p, lo, [&](int ks) { return load_a<S>(sQ, r0, 8 * ks, g, t); },
                    [&](int ks, int j) { return load_b_nk<S>(sK, 8 * j, 8 * ks, g, t); });
    softmax_rows<NC>(p, lo, a, geo.T, geo.scale, r0 + g, t, inv);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] *= inv[e >> 1];
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(sP + (r0 + g + 8 * hh) * SP + 8 * j + 2 * t) =
            make_float2(p[j][2 * hh], p[j][2 * hh + 1]);

    // ds = p (dp - rowsum(dp p)), dp = dO v^T
    float ds[NC][4];
    product<ND, NC>(ds, lo, [&](int ks) { return load_a<S>(sdO, r0, 8 * ks, g, t); },
                    [&](int ks, int j) { return load_b_nk<S>(sV, 8 * j, 8 * ks, g, t); });
    float dot[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[j][e] += lo[j][e];
        dot[e >> 1] = fmaf(ds[j][e], p[j][e], dot[e >> 1]);
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) dot[hh] = quad_sum(dot[hh]);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[j][e] = p[j][e] * (ds[j][e] - dot[e >> 1]);  // 0 outside the T x T square
        dsum[j][e] += ds[j][e];
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(sdS + (r0 + g + 8 * hh) * SP + 8 * j + 2 * t) =
            make_float2(ds[j][2 * hh], ds[j][2 * hh + 1]);
    }

    // dq = ds k * scale, ds straight from registers
    float big[ND][4], small[ND][4];
    product<NC, ND>(big, small, [&](int j) { return acc_as_a(ds[j]); },
                    [&](int j, int n) { return load_b_kn<S>(sK, 8 * j, 8 * n, g, t); });
    store_rows<ND>(dq + gat, gl.t, big, small, scales, r0 + g, geo.T, geo.D, t);
    __syncthreads();  // p and ds of every q row are in shared memory

    // this warp's kv rows: dv = p^T dO, dk = ds^T q * scale
    product<NC, ND>(big, small, [&](int j) { return load_at<SP>(sP, r0, 8 * j, g, t); },
                    [&](int j, int n) { return load_b_kn<S>(sdO, 8 * j, 8 * n, g, t); });
    store_rows<ND>(dv + gat, gl.t, big, small, ones, r0 + g, geo.T, geo.D, t);
    product<NC, ND>(big, small, [&](int j) { return load_at<SP>(sdS, r0, 8 * j, g, t); },
                    [&](int j, int n) { return load_b_kn<S>(sQ, 8 * j, 8 * n, g, t); });
    store_rows<ND>(dk + gat, gl.t, big, small, scales, r0 + g, geo.T, geo.D, t);
    __syncthreads();  // every read of this buffer, p and ds is done
  }

  const long long TT = (long long)geo.T * geo.T;
  float* dst = part + (((long long)blockIdx.z * geo.H + h) * geo.nW + w) * TT;
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + g + 8 * (e >> 1), c = 8 * j + 2 * t + (e & 1);
      if (r < geo.T && c < geo.T) dst[r * geo.T + c] = dsum[j][e];
    }
}

// ---- launches ---------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// f(nc, dp) with the instance's n-tiles (2, 4, 7 or 8) and padded head dim
// (16, 32 or 64) as integral constants.
template <typename F>
int dispatch(int T, int D, F f) {
  auto by_dp = [&](auto nc) -> int {
    if (D <= 16) return f(nc, std::integral_constant<int, 16>{});
    if (D <= 32) return f(nc, std::integral_constant<int, 32>{});
    return f(nc, std::integral_constant<int, 64>{});
  };
  if (T <= 16) return by_dp(std::integral_constant<int, 2>{});
  if (T <= 32) return by_dp(std::integral_constant<int, 4>{});
  if (T <= 56) return by_dp(std::integral_constant<int, 7>{});
  return by_dp(std::integral_constant<int, 8>{});
}

template <int NC, int DP>
int fwd(const float* q, const float* k, const float* v, const float* add, const float* mask,
        float* o, const Geo& g, const Layout& in, const Layout& out, int chunk, int runs,
        cudaStream_t st) {
  constexpr size_t smem = fwd_smem<NC, DP>();
  cudaError_t err = allow_smem(fwd_kernel<NC, DP>, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<NC, DP><<<dim3(g.nW, g.H, runs), 32 * kWarpsOf<NC>, smem, st>>>(
      q, k, v, add, mask, o, g, in, out, chunk);
  return cudaGetLastError();
}

template <int NC, int DP>
int bwd(const float* q, const float* k, const float* v, const float* add, const float* mask,
        const float* dout, float* dq, float* dk, float* dv, float* part, const Geo& g,
        const Layout& in, const Layout& dol, const Layout& gl, int chunk, int runs,
        cudaStream_t st) {
  constexpr size_t smem = bwd_smem<NC, DP>();
  cudaError_t err = allow_smem(bwd_kernel<NC, DP>, smem);
  if (err != cudaSuccess) return err;
  bwd_kernel<NC, DP><<<dim3(g.nW, g.H, runs), 32 * kWarpsOf<NC>, smem, st>>>(
      q, k, v, add, mask, dout, dq, dk, dv, part, g, in, dol, gl, chunk);
  return cudaGetLastError();
}

bool bad_geo(const Geo& g, int chunk, int runs) {
  return g.B <= 0 || g.H <= 0 || g.H > 65535 || g.nW <= 0 || g.T < 2 ||
         g.T > 64 || g.D <= 0 || g.D > 64 || g.D % 8 != 0 || g.P <= 0 || g.nW % g.P != 0 ||
         g.lda < g.T || chunk <= 0 || runs <= 0 || runs > 65535 ||
         (long long)chunk * runs < g.B;
}

// cp.async moves 16 bytes from and to 16-byte aligned addresses, and rows
// are stored as float2: every stride a multiple of 4 floats.
bool bad_layout(const Layout& l) { return l.b % 4 || l.w % 4 || l.h % 4 || l.t % 4; }

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

// Forward.  q, k, v and o are read and written through strides (host
// array of 8: image, window, head and token strides of q, k and v, then of
// o; the head dim is contiguous).  The additive term as in Geo (batched:
// add = bias (H, T, T), P = 1, add_h = T * T, add_blk = 0, lda = T, mask
// (nW, T, T) or null; packed: add (H, nblk, P T, P T), add_h = nblk (P T)^2,
// add_blk = (P T)^2, lda = P T, mask null), contiguous.  Images are taken
// `chunk` to a block, runs = ceil(B / chunk).  All f32.  Returns a
// cudaError_t.
extern "C" int swin_attention_fwd(const float* q, const float* k, const float* v,
                                  const float* add, const float* mask, float* o,
                                  const long long* strides, int B, int H, int nW, int T, int D,
                                  int P, long long add_h, long long add_blk, int lda, int chunk,
                                  int runs, float scale, void* stream) {
  const Geo g = make_geo(B, H, nW, T, D, P, add_h, add_blk, lda, scale);
  const Layout in = layout_at(strides, 0), out = layout_at(strides, 1);
  if (bad_geo(g, chunk, runs) || bad_layout(in) || bad_layout(out) || misaligned(q) ||
      misaligned(k) || misaligned(v) || misaligned(o))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dispatch(T, D, [&](auto nc, auto dp) {
    return fwd<decltype(nc)::value, decltype(dp)::value>(q, k, v, add, mask, o, g, in, out,
                                                         chunk, runs, st);
  });
}

// Backward.  The same geometry as the forward; strides (host array of 12):
// q, k, v, then dout, then dq, dk, dv; part: (runs, H, nW, T, T) scratch.
// grad_add gets dbias (H, T, T) when packed is 0, and dadd (H, nW / P, P T,
// P T) when it is 1.  Returns a cudaError_t.
extern "C" int swin_attention_bwd(const float* q, const float* k, const float* v,
                                  const float* add, const float* mask, const float* dout,
                                  float* dq, float* dk, float* dv, float* part, float* grad_add,
                                  int packed, const long long* strides, int B, int H, int nW,
                                  int T, int D, int P, long long add_h, long long add_blk,
                                  int lda, int chunk, int runs, float scale, void* stream) {
  const Geo g = make_geo(B, H, nW, T, D, P, add_h, add_blk, lda, scale);
  const Layout in = layout_at(strides, 0), dol = layout_at(strides, 1);
  const Layout gl = layout_at(strides, 2);
  if (bad_geo(g, chunk, runs) || bad_layout(in) || bad_layout(dol) || bad_layout(gl) ||
      misaligned(q) || misaligned(k) || misaligned(v) || misaligned(dout) || misaligned(dq) ||
      misaligned(dk) || misaligned(dv))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = dispatch(T, D, [&](auto nc, auto dp) {
    return bwd<decltype(nc)::value, decltype(dp)::value>(q, k, v, add, mask, dout, dq, dk, dv,
                                                         part, g, in, dol, gl, chunk, runs, st);
  });
  if (err != cudaSuccess) return err;
  return reduce_grad_add(part, grad_add, packed, runs, H, nW, P, T, st);
}
