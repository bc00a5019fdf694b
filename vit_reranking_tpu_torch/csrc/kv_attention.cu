// KV-resident attention, softmax(q k^T * scale) v, forward and backward, on
// Hopper (sm_90a), f32 in and out, products on the tensor cores; its bf16
// form (bf16 in and out, D = 64) is the section "bf16" below.
//
// Replaces the TPU kernels vit_reranking_tpu/ops/attention_pallas.py::
// _fwd_kernel (:48, launched by _fwd :131) and _bwd_kernel (:66, launched by
// _bwd :152).  q (BH, T, D), k and v (BH, Tkv, D), all row-major f32, D 64,
// 128 or 192, any T and any Tkv.  CvT-13 stage 0 at 224 px: T = 3136,
// Tkv = 784, D = 64.  The largest block (dK/dV at D = 192) takes 197 KB of
// shared memory; D = 256 would not fit a block's 227 KB with the tile rows
// used here, so callers materialise the attention there
// (ops/attention.py::cvt_attention).
//
// What bounds it: operations.  At stage 0 (BH = 112) the forward is
// 4 T Tkv D BH = 7.05e10 flop against 0.23 GB of q, k, v and O, and the
// backward 14 units of T Tkv D BH multiply-adds against 10 in the product
// count; both are far above the card's flop-per-byte line.  Every product
// runs on the tensor cores as three TF32 products (below), so the bound is
// 3 x flop at 495 TFLOP/s.  That rate needs wgmma; mma.sync, used here
// because wgmma takes TF32 operands only K-major (P V, dS^T Q and P^T dO
// would need transposed copies), tops out near two thirds of it on an H100
// (chip_k3_variants.py measures the ceiling beside the kernel).
//
// How f32 accuracy survives TF32.  mma.sync m16n8k8 reads TF32 operands
// (10 mantissa bits; it drops the low 13 bits of each f32 register).  Each
// f32 operand x is split as hi = tf32(x), rounded to nearest with ties away
// (cvt.rna's rounding), and lo = x - hi, which the tensor core truncates to
// TF32, so x = hi + lo to about 2^-21 relative, and a b ~ hi_a hi_b +
// hi_a lo_b + lo_a hi_b, accumulated in f32; the dropped lo_a lo_b is about
// 2^-22 of the product (tests/test_torch_attention.py emulates the split:
// one TF32 product alone would miss the f32 tolerances by an order of
// magnitude).  mma's f32 accumulator does not round to nearest: each
// instruction can lose about 2^-24 of the accumulator's magnitude, so the
// error of a chain grows with its length (a chain over a whole kv row is
// 3 x 98 instructions at stage 0).  So the small terms run in their own
// chain, every product over a streamed tile starts from zero, and its tile
// sum joins the running sum in f32 arithmetic (tile_product); the longest
// chain is then 8-24 instructions.  Softmax statistics, exp, lse, delta and
// dS stay in f32 registers.
//
// The layout (FlashAttention-2).  A block has 4 warps; each warp owns 16
// rows of the block's 64 (q rows in the forward and dQ passes, kv rows in
// the dK/dV pass) and keeps its scores, softmax statistics and accumulators
// in registers.  The streamed operand tiles pass through a two-stage ring of
// cp.async copies (16 bytes a thread, zero-filled past the last row), so
// the next tile's copy overlaps the current tile's products.  A score tile
// leaves mma in the accumulator layout (thread (g, t) of a quad holds
// columns 2t and 2t+1 of rows g and g+8); it feeds the next product as its
// A operand with no shuffle by taking those two columns as k = t and t + 4,
// and reading the B operand's rows in the same order (load_b_kn).  Shared
// rows are padded to D + 4 floats, so every fragment load of a warp touches
// 32 distinct banks.
//
// forward: one block per (64 q rows, head); per kv tile, S = q k^T, an
//   online softmax (running max and sum), O += P V.  It writes O and the
//   row log-sum-exp lse = m + log(l); neither S nor P reaches device memory.
// backward: blocks run in no order, so instead of the TPU kernel's dK/dV
//   carried across a sequential grid, the work is split three ways, with no
//   float atomics, so gradients are the same bits from run to run:
//     delta = rowsum(dO * O), one warp per row;
//     one block per (64 kv rows, head, 64 columns of dK/dV) streams every
//       q tile, recomputes S^T and dP^T = V dO^T, and accumulates
//       dV += P^T dO and dK += dS^T Q, dS = P * (dP - delta) * scale;
//     one block per (64 q rows, head, 64 columns of dQ) streams the kv
//       tiles, recomputes S and dP and accumulates dQ += dS K.
//   Recomputing S and dP in the dQ pass (14 units of work where 10 would
//   do) is the price of a deterministic sum without atomics: a single pass
//   needs the dQ of a q tile reduced over every kv block of its head.  At
//   D = 128 and 192 each 64-column group of dK/dV/dQ is its own block, which
//   recomputes the scores: the accumulators then fit the registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns: q rows (fwd, dQ) or kv rows (dK/dV)
constexpr int kCols = 64;           // dQ, dK, dV columns a backward block accumulates
constexpr float kLog2e = 1.44269504088896341f;
constexpr float kLn2 = 0.693147180559945309f;

// Rows of a streamed tile: kv rows in the forward, q rows in the dK/dV pass
// (fewer at the wider heads, for shared memory and registers), kv rows in
// the dQ pass (32: at D = 64 its block then takes 70 KB and 167 registers a
// thread, so three blocks share an SM).
template <int D>
constexpr int kStreamRows = D == 64 ? 64 : 32;
constexpr int kDqStreamRows = 32;

// ---- tensor-core products in 3xTF32 ---------------------------------------

struct FragA {  // a 16 x 8 A operand, split
  uint32_t hi[4], lo[4];
};
struct FragB {  // an 8 x 8 B operand, split
  uint32_t hi[2], lo[2];
};

// hi = x rounded to TF32, to nearest with ties away from zero: the rounding
// of cvt.rna.tf32.f32, bit for bit, in two integer instructions, which issue
// faster than the conversion; lo = x - hi (exact), whose low 13 bits the
// tensor core drops.
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
// s[k0 + k][n0 + n], with k in the order acc_as_a gives it: b0 is row
// k0 + 2t, b1 row k0 + 2t + 1.
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

// c = c * (a0 rows g, a1 rows g + 8) + sum_j x[j] b(j, n): the product of
// one streamed tile, x (16 x 8 NJ, accumulator layout, see acc_as_a) times
// the tile, in fresh chains (two for each of up to 8 n-tiles at a time, all
// independent) and added to the running sum c in f32.
template <int NJ, int NN, typename LoadB>
__device__ __forceinline__ void tile_product(float (&c)[NN][4], const float (&x)[NJ][4],
                                             LoadB load_b, float a0, float a1) {
  constexpr int NG = NN < 8 ? NN : 8;
  static_assert(NN % NG == 0, "n-tiles come in groups of NG");
#pragma unroll
  for (int n0 = 0; n0 < NN; n0 += NG) {
    float big[NG][4], small[NG][4];
    zero(big);
    zero(small);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const FragA a = acc_as_a(x[j]);
#pragma unroll
      for (int n = 0; n < NG; ++n) mma3(big[n], small[n], a, load_b(j, n0 + n));
    }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        c[n0 + n][e] = fmaf(c[n0 + n][e], e < 2 ? a0 : a1, big[n][e] + small[n][e]);
  }
}

// ---- asynchronous tile copies ---------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// Wait for every copy group but the newest, then for every thread's copies.
__device__ __forceinline__ void cp_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
  __syncthreads();
}

// Rows [row0, row0 + R) of a (rows, D) row-major matrix into an R x (D + 4)
// shared tile, 16 bytes a copy; rows past the end are zero-filled.
template <int D, int R>
__device__ __forceinline__ void copy_tile(float* s, const float* __restrict__ g, int row0,
                                          int rows) {
  constexpr int kChunks = D / 4;
  for (int e = threadIdx.x; e < R * kChunks; e += kThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const int gr = row0 + r;
    const bool ok = gr < rows;
    cp_async16(s + r * (D + 4) + c, g + (long long)(ok ? gr : 0) * D + c, ok);
  }
}

// Entries [row0, row0 + R) of a vector into shared memory, zero past the end.
template <int R>
__device__ __forceinline__ void copy_vec(float* s, const float* __restrict__ g, int row0,
                                         int rows) {
  for (int r = threadIdx.x; r < R; r += kThreads) {
    const bool ok = row0 + r < rows;
    cp_async4(s + r, g + (ok ? row0 + r : 0), ok);
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

// ---- forward ----------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)(kRows + 2 * 2 * kStreamRows<D>) * (D + 4) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int T, int Tkv, float scale) {
  constexpr int S = D + 4;
  constexpr int BC = kStreamRows<D>;
  constexpr int NC = BC / 8;  // score n-tiles, P V k-steps
  constexpr int ND = D / 8;   // q k^T k-steps, O n-tiles
  constexpr bool kQInRegs = D == 64;
  extern __shared__ float smem[];
  float* sQ = smem;              // kRows x S
  float* sKV = sQ + kRows * S;   // two stages of K and V, each BC x S

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;  // the warp's first row in the block
  const float* kb = k + (long long)bh * Tkv * D;
  const float* vb = v + (long long)bh * Tkv * D;
  const int ntiles = (Tkv + BC - 1) / BC;
  const float scale2 = scale * kLog2e;

  copy_tile<D, kRows>(sQ, q + (long long)bh * T * D, q0, T);
  copy_tile<D, BC>(sKV, kb, 0, Tkv);
  copy_tile<D, BC>(sKV + BC * S, vb, 0, Tkv);
  cp_commit();

  FragA qf[kQInRegs ? ND : 1];  // at D = 64, q split once and kept
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[ND][4];
  zero(acc);

  for (int it = 0; it < ntiles; ++it) {
    float* sK = sKV + (it & 1) * 2 * BC * S;
    const float* sV = sK + BC * S;
    if (it + 1 < ntiles) {
      float* nxt = sKV + ((it + 1) & 1) * 2 * BC * S;
      copy_tile<D, BC>(nxt, kb, (it + 1) * BC, Tkv);
      copy_tile<D, BC>(nxt + BC * S, vb, (it + 1) * BC, Tkv);
    }
    cp_commit();
    cp_wait_all_but_newest();
    if constexpr (kQInRegs) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < ND; ++ks) qf[ks] = load_a<S>(sQ, wr, ks * 8, g, t);
      }
    }

    float s[NC][4], sl[NC][4];
    zero(s);
    zero(sl);
#pragma unroll
    for (int ks = 0; ks < ND; ++ks) {
      FragA a;
      if constexpr (kQInRegs) a = qf[ks];
      else a = load_a<S>(sQ, wr, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NC; ++j) mma3(s[j], sl[j], a, load_b_nk<S>(sK, j * 8, ks * 8, g, t));
    }

    // online softmax over rows g (h = 0) and g + 8 (h = 1), in base 2 (the
    // scores carry log2(e), so each exponential is one exp2f); a kv column
    // past Tkv scores -inf.  Every tile starts inside the kv rows, so each
    // row's max is finite from the first tile on.
    const int k0 = it * BC;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + j * 8 + 2 * t + (e & 1) < Tkv;
        s[j][e] = ok ? (s[j][e] + sl[j][e]) * scale2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    float corr[2], rs[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + quad_sum(rs[h]);

    // O = O * corr + P V, P straight from the score registers
    tile_product(acc, s, [&](int j, int n) { return load_b_kn<S>(sV, j * 8, n * 8, g, t); },
                 corr[0], corr[1]);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + wr + g + 8 * h;
    if (r >= T) continue;
    float* orow = o + ((long long)bh * T + r) * D;
    const float inv = 1.0f / l[h];
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(acc[n][2 * h] * inv, acc[n][2 * h + 1] * inv);
    if (t == 0) lse[(long long)bh * T + r] = m[h] * kLn2 + logf(l[h]);
  }
}

// ---- backward -------------------------------------------------------------

// delta[row] = sum_d dO[row][d] * O[row][d], one warp per row.
template <int D>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(dout[row * D + c], o[row * D + c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

template <int D>
constexpr size_t dkdv_smem() {
  constexpr int BQ = kStreamRows<D>;
  return ((size_t)(2 * kRows + 2 * 2 * BQ) * (D + 4) + 2 * 2 * BQ) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int T, int Tkv, float scale) {
  constexpr int S = D + 4;
  constexpr int BQ = kStreamRows<D>;
  constexpr int NQ = BQ / 8;     // score n-tiles over q, dK/dV k-steps
  constexpr int NK = D / 8;      // k-steps over d
  constexpr int NO = kCols / 8;  // dK/dV n-tiles
  constexpr int kStage = 2 * BQ * S + 2 * BQ;  // Q, dO, lse, delta
  extern __shared__ float smem[];
  float* sK = smem;  // the block's kv rows, kRows x S each
  float* sV = sK + kRows * S;
  float* sStages = sV + kRows * S;

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * kRows;
  const int c0 = blockIdx.z * kCols;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const float* qb = q + (long long)bh * T * D;
  const float* dob = dout + (long long)bh * T * D;
  const float* lseb = lse + (long long)bh * T;
  const float* deltab = delta + (long long)bh * T;
  const int ntiles = (T + BQ - 1) / BQ;

  auto copy_stage = [&](int it) {
    float* st = sStages + (it & 1) * kStage;
    copy_tile<D, BQ>(st, qb, it * BQ, T);
    copy_tile<D, BQ>(st + BQ * S, dob, it * BQ, T);
    copy_vec<BQ>(st + 2 * BQ * S, lseb, it * BQ, T);
    copy_vec<BQ>(st + 2 * BQ * S + BQ, deltab, it * BQ, T);
  };
  copy_tile<D, kRows>(sK, k + (long long)bh * Tkv * D, kv0, Tkv);
  copy_tile<D, kRows>(sV, v + (long long)bh * Tkv * D, kv0, Tkv);
  copy_stage(0);
  cp_commit();

  // kv rows kv0 + wr + g (+ 8), columns c0 + 8 n + 2 t (+ 1)
  float dk_acc[NO][4], dv_acc[NO][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < ntiles; ++it) {
    const float* sQ = sStages + (it & 1) * kStage;
    const float* sdO = sQ + BQ * S;
    const float* sL = sdO + BQ * S;
    const float* sDelta = sL + BQ;
    if (it + 1 < ntiles) copy_stage(it + 1);
    cp_commit();
    cp_wait_all_but_newest();
    const int q0 = it * BQ;

    // P^T = exp(K Q^T * scale - lse), zero in q columns past T
    float p[NQ][4], lo[NQ][4];
    zero(p);
    zero(lo);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const FragA a = load_a<S>(sK, wr, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NQ; ++j) mma3(p[j], lo[j], a, load_b_nk<S>(sQ, j * 8, ks * 8, g, t));
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        p[j][e] = q0 + col < T ? expf((p[j][e] + lo[j][e]) * scale - sL[col]) : 0.0f;
      }

    // dV += P^T dO
    tile_product(dv_acc, p,
                 [&](int j, int n) { return load_b_kn<S>(sdO, j * 8, c0 + n * 8, g, t); },
                 1.0f, 1.0f);

    // dS^T = P^T * (V dO^T - delta) * scale
    float ds[NQ][4];
    zero(ds);
    zero(lo);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const FragA a = load_a<S>(sV, wr, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NQ; ++j) mma3(ds[j], lo[j], a, load_b_nk<S>(sdO, j * 8, ks * 8, g, t));
    }
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] + lo[j][e] - sDelta[j * 8 + 2 * t + (e & 1)]) * scale;

    // dK += dS^T Q
    tile_product(dk_acc, ds,
                 [&](int j, int n) { return load_b_kn<S>(sQ, j * 8, c0 + n * 8, g, t); },
                 1.0f, 1.0f);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = kv0 + wr + g + 8 * h;
    if (r >= Tkv) continue;
    const long long at = ((long long)bh * Tkv + r) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(dk + at + n * 8) =
          make_float2(dk_acc[n][2 * h], dk_acc[n][2 * h + 1]);
      *reinterpret_cast<float2*>(dv + at + n * 8) =
          make_float2(dv_acc[n][2 * h], dv_acc[n][2 * h + 1]);
    }
  }
}

template <int D>
constexpr size_t dq_smem() {
  return (size_t)(2 * kRows + 2 * 2 * kDqStreamRows) * (D + 4) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int T, int Tkv, float scale) {
  constexpr int S = D + 4;
  constexpr int BC = kDqStreamRows;
  constexpr int NC = BC / 8;     // score n-tiles over kv, dQ k-steps
  constexpr int NK = D / 8;      // k-steps over d
  constexpr int NO = kCols / 8;  // dQ n-tiles
  extern __shared__ float smem[];
  float* sQ = smem;  // the block's q rows, kRows x S each
  float* sdO = sQ + kRows * S;
  float* sKV = sdO + kRows * S;  // two stages of K and V, each BC x S

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int c0 = blockIdx.z * kCols;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const float* kb = k + (long long)bh * Tkv * D;
  const float* vb = v + (long long)bh * Tkv * D;
  const int ntiles = (Tkv + BC - 1) / BC;

  copy_tile<D, kRows>(sQ, q + (long long)bh * T * D, q0, T);
  copy_tile<D, kRows>(sdO, dout + (long long)bh * T * D, q0, T);
  copy_tile<D, BC>(sKV, kb, 0, Tkv);
  copy_tile<D, BC>(sKV + BC * S, vb, 0, Tkv);
  cp_commit();

  float lse_r[2], delta_r[2];  // rows q0 + wr + g (+ 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + wr + g + 8 * h;
    lse_r[h] = r < T ? lse[(long long)bh * T + r] : 0.0f;
    delta_r[h] = r < T ? delta[(long long)bh * T + r] : 0.0f;
  }
  float acc[NO][4];
  zero(acc);

  for (int it = 0; it < ntiles; ++it) {
    const float* sK = sKV + (it & 1) * 2 * BC * S;
    const float* sV = sK + BC * S;
    if (it + 1 < ntiles) {
      float* nxt = sKV + ((it + 1) & 1) * 2 * BC * S;
      copy_tile<D, BC>(nxt, kb, (it + 1) * BC, Tkv);
      copy_tile<D, BC>(nxt + BC * S, vb, (it + 1) * BC, Tkv);
    }
    cp_commit();
    cp_wait_all_but_newest();
    const int k0 = it * BC;

    // P = exp(S * scale - lse), zero in kv columns past Tkv
    float p[NC][4], lo[NC][4];
    zero(p);
    zero(lo);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const FragA a = load_a<S>(sQ, wr, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NC; ++j) mma3(p[j], lo[j], a, load_b_nk<S>(sK, j * 8, ks * 8, g, t));
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = k0 + j * 8 + 2 * t + (e & 1) < Tkv;
        p[j][e] = ok ? expf((p[j][e] + lo[j][e]) * scale - lse_r[e >> 1]) : 0.0f;
      }

    // dS = P * (dO V^T - delta) * scale
    float ds[NC][4];
    zero(ds);
    zero(lo);
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const FragA a = load_a<S>(sdO, wr, ks * 8, g, t);
#pragma unroll
      for (int j = 0; j < NC; ++j) mma3(ds[j], lo[j], a, load_b_nk<S>(sV, j * 8, ks * 8, g, t));
    }
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[j][e] = p[j][e] * (ds[j][e] + lo[j][e] - delta_r[e >> 1]) * scale;

    // dQ += dS K
    tile_product(acc, ds,
                 [&](int j, int n) { return load_b_kn<S>(sK, j * 8, c0 + n * 8, g, t); },
                 1.0f, 1.0f);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + wr + g + 8 * h;
    if (r >= T) continue;
    float* row = dq + ((long long)bh * T + r) * D + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(row + n * 8) = make_float2(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

// ---- launches ---------------------------------------------------------------

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

unsigned blocks(int rows) { return (unsigned)((rows + kRows - 1) / kRows); }

template <int D>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse, int BH, int T,
        int Tkv, float scale, cudaStream_t st) {
  constexpr size_t smem = fwd_smem<D>();
  cudaError_t err = allow_smem(fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<D><<<dim3(blocks(T), BH), kThreads, smem, st>>>(q, k, v, o, lse, T, Tkv, scale);
  return cudaGetLastError();
}

template <int D>
int bwd(const float* q, const float* k, const float* v, const float* o, const float* dout,
        const float* lse, float* delta, float* dq, float* dk, float* dv, int BH, int T, int Tkv,
        float scale, cudaStream_t st) {
  const long long rows = (long long)BH * T;
  const long long row_blocks = (rows + kWarps - 1) / kWarps;
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_kernel<D><<<(unsigned)row_blocks, kThreads, 0, st>>>(o, dout, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  constexpr size_t smem_kv = dkdv_smem<D>();
  if ((err = allow_smem(dkdv_kernel<D>, smem_kv)) != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3(blocks(Tkv), BH, D / kCols), kThreads, smem_kv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, T, Tkv, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  constexpr size_t smem_q = dq_smem<D>();
  if ((err = allow_smem(dq_kernel<D>, smem_q)) != cudaSuccess) return err;
  dq_kernel<D><<<dim3(blocks(T), BH, D / kCols), kThreads, smem_q, st>>>(
      q, k, v, dout, lse, delta, dq, T, Tkv, scale);
  return cudaGetLastError();
}

bool bad_shape(int BH, int T, int Tkv) { return BH <= 0 || BH > 65535 || T <= 0 || Tkv <= 0; }

// cp.async moves 16 bytes from and to 16-byte aligned addresses.
bool misaligned(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return true;
  return false;
}


// ---- bf16 -------------------------------------------------------------------
//
// The bf16 form of K3 (q, k, v, o, dq, dk, dv bf16; lse and delta f32), at
// D = 64, the head dim of every CvT-13 stage.  The TPU kernel's rounding
// points are kept, not a flash-style online softmax: the scores and the
// softmax are f32 (bf16 products summed in f32), p is normalised in f32 and
// then rounded to bf16 before P V (attention_pallas.py:58-59), and in the
// backward dp is f32, ds = p (dp - rowsum(dp p)) scale is f32 and rounded to
// bf16 before dS K and dS^T Q, p is rounded before P^T dO, and dQ, dK and dV
// are summed in f32 and rounded once (attention_pallas.py:66-111).
//
// Products: mma.sync m16n8k16 with bf16 operands and f32 accumulators, one
// product an operand pair (bf16 needs no hi/lo split).  A score tile leaves
// mma in the accumulator layout (c0 c1: row g, columns 2t, 2t + 1; c2 c3:
// row g + 8), which is the A operand's layout for k = 2t, 2t + 1 (a0, a1)
// and k = 2t + 8, 2t + 9 (a2, a3) once two adjacent n-tiles are packed to
// bf16 pairs, so P and dS feed their products from registers.  Shared rows
// are 64 + 8 bf16 (144 bytes) apart: every fragment load of a warp touches
// 32 distinct banks.
//
// forward: one block per (64 q rows, head), 4 warps of 16 rows; the kv tiles
//   are streamed twice through a two-stage cp.async ring: the first pass
//   takes each row's max and sum (m, l), the second recomputes S, forms
//   p = exp(s - m) / l, rounds it to bf16 and accumulates O += P V.
// backward, with no float atomics (the same bits run to run):
//   one block per (64 q rows, head) streams the kv tiles twice: the first
//     pass sums delta = rowsum(dp p) over the whole row (the TPU kernel's
//     softmax vjp, not dO . O, which would carry O's bf16 rounding), the
//     second forms dS and accumulates dQ += dS K; it writes dq and delta;
//   one block per (64 kv rows, head) streams the q tiles with lse and delta,
//     recomputes S^T and dP^T = V dO^T, and accumulates dV += P^T dO and
//     dK += dS^T Q in f32.
// The work is 3 units of T Tkv D products forward and 9 backward (5 in the
// dQ pass, 4 in the dK/dV pass), against 2 and 4 of a single-pass layout:
// the price of the TPU kernel's rounding points with the kv block streamed.
//
// What bounds it: operations.  At CvT-13 stage 0 (BH = 112) the forward's
// function is 7.05e10 flop against 0.11 GB of bf16 q, k, v and o (0.071 ms
// at 989 TFLOP/s dense bf16, 0.034 ms at 3.35 TB/s), the backward's 1.76e11
// flop (0.178 ms).  mma.sync reaches about two thirds of the dense rate on
// an H100 (wgmma the rest), and the exponentials (one a score a pass, 2 and
// 3 passes) run on the SFU beside the products.

namespace b16 {

using bf16 = __nv_bfloat16;
constexpr int kD = 64;       // the head dim of the bf16 kernels
constexpr int kS = kD + 8;   // shared row stride, in bf16
constexpr int kNK = kD / 16; // k-steps over d
constexpr int kND = kD / 8;  // n-tiles over d

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (to nearest even) as one register, lo in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 of one column, rows p and p + S, as one register
template <int S>
__device__ __forceinline__ uint32_t ld_col2(const bf16* p) {
  const uint32_t lo = *reinterpret_cast<const uint16_t*>(p);
  const uint32_t hi = *reinterpret_cast<const uint16_t*>(p + S);
  return lo | (hi << 16);
}

struct FragA {
  uint32_t r[4];
};

// The A operand at rows r0.., columns c0.. of a row-major shared tile.
template <int S>
__device__ __forceinline__ FragA load_a(const bf16* s, int r0, int c0, int g, int t) {
  const bf16* p = s + (r0 + g) * S + c0 + 2 * t;
  return FragA{{ld32(p), ld32(p + 8 * S), ld32(p + 8), ld32(p + 8 * S + 8)}};
}

// B of x y^T: element (k, n) is s[n0 + n][k0 + k].
template <int S>
__device__ __forceinline__ void load_b_nk(const bf16* s, int n0, int k0, int g, int t,
                                          uint32_t& b0, uint32_t& b1) {
  const bf16* p = s + (n0 + g) * S + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

// B of x y: element (k, n) is s[k0 + k][n0 + n].
template <int S>
__device__ __forceinline__ void load_b_kn(const bf16* s, int k0, int n0, int g, int t,
                                          uint32_t& b0, uint32_t& b1) {
  const bf16* p = s + (k0 + 2 * t) * S + n0 + g;
  b0 = ld_col2<S>(p);
  b1 = ld_col2<S>(p + 8 * S);
}

// Accumulator n-tiles 2 kk and 2 kk + 1 (f32) as a bf16 A operand, each
// value times mul[row half] first.
template <int N>
__device__ __forceinline__ FragA acc_as_a(const float (&c)[N][4], int kk, float m0, float m1) {
  const float* x = c[2 * kk];
  const float* y = c[2 * kk + 1];
  return FragA{{pack(x[0] * m0, x[1] * m0), pack(x[2] * m1, x[3] * m1),
                pack(y[0] * m0, y[1] * m0), pack(y[2] * m1, y[3] * m1)}};
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.0f;
}

// Rows [row0, row0 + R) of a (rows, 64) bf16 matrix into an R x kS shared
// tile; rows past the end zero-filled.  A row of 64 bf16 is 32 floats and
// kS bf16 are 36 floats, so this is copy_tile<32, R> on the same bytes.
template <int R>
__device__ __forceinline__ void copy_rows(bf16* s, const bf16* __restrict__ g, int row0,
                                          int rows) {
  copy_tile<kD / 2, R>(reinterpret_cast<float*>(s), reinterpret_cast<const float*>(g), row0,
                       rows);
}

// S = x y^T over d for NJ n-tiles of 8 streamed rows, x from registers.
template <int NJ>
__device__ __forceinline__ void scores(float (&s)[NJ][4], const FragA (&x)[kNK], const bf16* y,
                                       int g, int t) {
  zero(s);
#pragma unroll
  for (int kk = 0; kk < kNK; ++kk)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      uint32_t b0, b1;
      load_b_nk<kS>(y, 8 * j, 16 * kk, g, t, b0, b1);
      mma(s[j], x[kk].r, b0, b1);
    }
}

// acc += x y: x (16 x 8 NJ, accumulator layout, times m0 / m1 by row half,
// rounded to bf16) times the NJ 8 x 64 shared rows y.
template <int NJ>
__device__ __forceinline__ void accumulate(float (&acc)[kND][4], const float (&x)[NJ][4],
                                           const bf16* y, float m0, float m1, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < NJ / 2; ++kk) {
    const FragA a = acc_as_a(x, kk, m0, m1);
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      uint32_t b0, b1;
      load_b_kn<kS>(y, 16 * kk, 8 * n, g, t, b0, b1);
      mma(acc[n], a.r, b0, b1);
    }
  }
}

// Rows row, row + 8 (< rows) of a (rows, 64) bf16 matrix from acc.
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float (&acc)[kND][4],
                                           int row, int rows, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= rows) continue;
    bf16* p = out + (long long)(row + 8 * h) * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < kND; ++n)
      *reinterpret_cast<uint32_t*>(p + 8 * n) = pack(acc[n][2 * h], acc[n][2 * h + 1]);
  }
}

constexpr int kFwdRows = 64;  // kv rows a streamed tile, forward and dQ pass
constexpr int kDkdvRows = 32; // q rows a streamed tile, dK/dV pass

constexpr size_t fwd_smem() { return (size_t)(kRows + 2 * 2 * kFwdRows) * kS * sizeof(bf16); }

__global__ void __launch_bounds__(kThreads)
    fwd_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int T, int Tkv, float scale) {
  constexpr int BC = kFwdRows, NC = BC / 8;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sKV = sQ + kRows * kS;  // two stages of K and V, each BC x kS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const bf16* kb = k + (long long)bh * Tkv * kD;
  const bf16* vb = v + (long long)bh * Tkv * kD;
  const int ntiles = (Tkv + BC - 1) / BC;
  const int steps = 2 * ntiles;  // pass 1: K tiles; pass 2: K and V tiles
  const float scale_log2 = scale * kLog2e;

  auto fetch = [&](int step) {
    bf16* buf = sKV + (step & 1) * 2 * BC * kS;
    const int i = step % ntiles;
    copy_rows<BC>(buf, kb, i * BC, Tkv);
    if (step >= ntiles) copy_rows<BC>(buf + BC * kS, vb, i * BC, Tkv);
  };
  copy_rows<kRows>(sQ, q + (long long)bh * T * kD, q0, T);
  fetch(0);
  cp_commit();

  FragA qf[kNK];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f}, inv[2] = {0.0f, 0.0f};
  float acc[kND][4];
  zero(acc);

  for (int it = 0; it < steps; ++it) {
    const bf16* sK = sKV + (it & 1) * 2 * BC * kS;
    const bf16* sV = sK + BC * kS;
    if (it + 1 < steps) fetch(it + 1);
    cp_commit();
    cp_wait_all_but_newest();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) qf[kk] = load_a<kS>(sQ, wr, 16 * kk, g, t);
    }
    if (it == ntiles) {
#pragma unroll
      for (int h = 0; h < 2; ++h) inv[h] = 1.0f / l[h];
    }

    // scores in base 2 (scale carries log2(e)); columns past Tkv are -inf
    float s[NC][4];
    scores(s, qf, sK, g, t);
    const int k0 = (it % ntiles) * BC;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = k0 + 8 * j + 2 * t + (e & 1) < Tkv ? s[j][e] * scale_log2 : -INFINITY;

    if (it < ntiles) {
      // pass 1: running max and sum; every tile starts inside the kv rows,
      // so each row's max is finite from the first tile on
      float mx[2] = {m[0], m[1]}, rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) mx[h] = quad_max(mx[h]);
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) rs[e >> 1] += exp2f(s[j][e] - mx[e >> 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] = l[h] * exp2f(m[h] - mx[h]) + quad_sum(rs[h]);
        m[h] = mx[h];
      }
    } else {
      // pass 2: p = exp(s - m) / l in f32, rounded to bf16; O += P V
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float& p = s[j][e];
          p = exp2f(p - m[e >> 1]);
        }
      accumulate(acc, s, sV, inv[0], inv[1], g, t);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int row = q0 + wr + g;
  store_rows(o + (long long)bh * T * kD, acc, row, T, t);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < T) lse[(long long)bh * T + row + 8 * h] = logf(l[h]) + m[h] * kLn2;
}

constexpr size_t dq_smem() { return (size_t)(2 * kRows + 2 * 2 * kFwdRows) * kS * sizeof(bf16); }

// dQ and delta: grid (q tiles, BH).
__global__ void __launch_bounds__(kThreads)
    dq_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ delta,
                   bf16* __restrict__ dq, int T, int Tkv, float scale) {
  constexpr int BC = kFwdRows, NC = BC / 8;
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);
  bf16* sdO = sQ + kRows * kS;
  bf16* sKV = sdO + kRows * kS;  // two stages of K and V, each BC x kS

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const bf16* kb = k + (long long)bh * Tkv * kD;
  const bf16* vb = v + (long long)bh * Tkv * kD;
  const int ntiles = (Tkv + BC - 1) / BC;
  const int steps = 2 * ntiles;  // pass 1: delta; pass 2: dQ

  auto fetch = [&](int step) {
    bf16* buf = sKV + (step & 1) * 2 * BC * kS;
    const int i = step % ntiles;
    copy_rows<BC>(buf, kb, i * BC, Tkv);
    copy_rows<BC>(buf + BC * kS, vb, i * BC, Tkv);
  };
  copy_rows<kRows>(sQ, q + (long long)bh * T * kD, q0, T);
  copy_rows<kRows>(sdO, dout + (long long)bh * T * kD, q0, T);
  fetch(0);
  cp_commit();

  const int row = q0 + wr + g;
  float lse_r[2], dsum[2] = {0.0f, 0.0f}, delta_r[2] = {0.0f, 0.0f};
#pragma unroll
  for (int h = 0; h < 2; ++h) lse_r[h] = row + 8 * h < T ? lse[(long long)bh * T + row + 8 * h] : 0.0f;
  FragA qf[kNK], of[kNK];
  float acc[kND][4];
  zero(acc);

  for (int it = 0; it < steps; ++it) {
    const bf16* sK = sKV + (it & 1) * 2 * BC * kS;
    const bf16* sV = sK + BC * kS;
    if (it + 1 < steps) fetch(it + 1);
    cp_commit();
    cp_wait_all_but_newest();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        qf[kk] = load_a<kS>(sQ, wr, 16 * kk, g, t);
        of[kk] = load_a<kS>(sdO, wr, 16 * kk, g, t);
      }
    }
    if (it == ntiles) {
#pragma unroll
      for (int h = 0; h < 2; ++h) delta_r[h] = quad_sum(dsum[h]);
    }

    // p = exp(s scale - lse), 0 in kv columns past Tkv; dp = dO V^T
    float p[NC][4], dp[NC][4];
    scores(p, qf, sK, g, t);
    scores(dp, of, sV, g, t);
    const int k0 = (it % ntiles) * BC;
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[j][e] = k0 + 8 * j + 2 * t + (e & 1) < Tkv ? expf(p[j][e] * scale - lse_r[e >> 1])
                                                     : 0.0f;
    if (it < ntiles) {
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsum[e >> 1] = fmaf(dp[j][e], p[j][e], dsum[e >> 1]);
    } else {
      // dS = p (dp - delta) scale, rounded to bf16; dQ += dS K
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - delta_r[e >> 1]) * scale;
      accumulate(acc, dp, sK, 1.0f, 1.0f, g, t);
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  store_rows(dq + (long long)bh * T * kD, acc, row, T, t);
  if (t == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (row + 8 * h < T) delta[(long long)bh * T + row + 8 * h] = delta_r[h];
}

// bytes of one stage of the dK/dV pass: Q and dO tiles, then lse and delta
constexpr int kDkdvStage = 2 * kDkdvRows * kS * sizeof(bf16) + 2 * kDkdvRows * sizeof(float);
constexpr size_t dkdv_smem() { return (size_t)2 * kRows * kS * sizeof(bf16) + 2 * kDkdvStage; }

// dK and dV: grid (kv tiles, BH).
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int T, int Tkv, float scale) {
  constexpr int BQ = kDkdvRows, NQ = BQ / 8;
  extern __shared__ float4 smem4[];
  bf16* sK = reinterpret_cast<bf16*>(smem4);
  bf16* sV = sK + kRows * kS;
  unsigned char* stages = reinterpret_cast<unsigned char*>(sV + kRows * kS);

  const int bh = blockIdx.y;
  const int kv0 = blockIdx.x * kRows;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wr = (threadIdx.x / 32) * 16;
  const bf16* qb = q + (long long)bh * T * kD;
  const bf16* dob = dout + (long long)bh * T * kD;
  const float* lseb = lse + (long long)bh * T;
  const float* deltab = delta + (long long)bh * T;
  const int ntiles = (T + BQ - 1) / BQ;

  auto stage = [&](int it) { return stages + (it & 1) * kDkdvStage; };
  auto fetch = [&](int it) {
    bf16* sQ = reinterpret_cast<bf16*>(stage(it));
    float* sL = reinterpret_cast<float*>(sQ + 2 * BQ * kS);
    copy_rows<BQ>(sQ, qb, it * BQ, T);
    copy_rows<BQ>(sQ + BQ * kS, dob, it * BQ, T);
    copy_vec<BQ>(sL, lseb, it * BQ, T);
    copy_vec<BQ>(sL + BQ, deltab, it * BQ, T);
  };
  copy_rows<kRows>(sK, k + (long long)bh * Tkv * kD, kv0, Tkv);
  copy_rows<kRows>(sV, v + (long long)bh * Tkv * kD, kv0, Tkv);
  fetch(0);
  cp_commit();

  FragA kf[kNK], vf[kNK];
  float dk_acc[kND][4], dv_acc[kND][4];
  zero(dk_acc);
  zero(dv_acc);

  for (int it = 0; it < ntiles; ++it) {
    const bf16* sQ = reinterpret_cast<const bf16*>(stage(it));
    const bf16* sdO = sQ + BQ * kS;
    const float* sL = reinterpret_cast<const float*>(sQ + 2 * BQ * kS);
    const float* sDelta = sL + BQ;
    if (it + 1 < ntiles) fetch(it + 1);
    cp_commit();
    cp_wait_all_but_newest();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kNK; ++kk) {
        kf[kk] = load_a<kS>(sK, wr, 16 * kk, g, t);
        vf[kk] = load_a<kS>(sV, wr, 16 * kk, g, t);
      }
    }
    const int q0 = it * BQ;

    // P^T = exp(K Q^T scale - lse), 0 in q columns past T; dP^T = V dO^T
    float p[NQ][4], dp[NQ][4];
    scores(p, kf, sQ, g, t);
    scores(dp, vf, sdO, g, t);
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        p[j][e] = q0 + col < T ? expf(p[j][e] * scale - sL[col]) : 0.0f;
        dp[j][e] = p[j][e] * (dp[j][e] - sDelta[col]) * scale;
      }
    accumulate(dv_acc, p, sdO, 1.0f, 1.0f, g, t);   // dV += P^T dO
    accumulate(dk_acc, dp, sQ, 1.0f, 1.0f, g, t);   // dK += dS^T Q
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int row = kv0 + wr + g;
  store_rows(dk + (long long)bh * Tkv * kD, dk_acc, row, Tkv, t);
  store_rows(dv + (long long)bh * Tkv * kD, dv_acc, row, Tkv, t);
}

int fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int BH, int T,
        int Tkv, float scale, cudaStream_t st) {
  cudaError_t err = allow_smem(fwd_kernel_bf16, fwd_smem());
  if (err != cudaSuccess) return err;
  fwd_kernel_bf16<<<dim3(blocks(T), BH), kThreads, fwd_smem(), st>>>(q, k, v, o, lse, T, Tkv,
                                                                      scale);
  return cudaGetLastError();
}

int bwd(const bf16* q, const bf16* k, const bf16* v, const bf16* dout, const float* lse,
        float* delta, bf16* dq, bf16* dk, bf16* dv, int BH, int T, int Tkv, float scale,
        cudaStream_t st) {
  cudaError_t err = allow_smem(dq_kernel_bf16, dq_smem());
  if (err != cudaSuccess) return err;
  dq_kernel_bf16<<<dim3(blocks(T), BH), kThreads, dq_smem(), st>>>(q, k, v, dout, lse, delta,
                                                                    dq, T, Tkv, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = allow_smem(dkdv_kernel_bf16, dkdv_smem())) != cudaSuccess) return err;
  dkdv_kernel_bf16<<<dim3(blocks(Tkv), BH), kThreads, dkdv_smem(), st>>>(
      q, k, v, dout, lse, delta, dk, dv, T, Tkv, scale);
  return cudaGetLastError();
}

}  // namespace b16

}  // namespace

// q, o: (BH, T, D); k, v: (BH, Tkv, D); lse: (BH, T).  All f32, contiguous,
// q, k, v 16-byte aligned.  Returns a cudaError_t.
extern "C" int kv_attention_fwd(const float* q, const float* k, const float* v, float* o,
                                float* lse, int BH, int T, int Tkv, int D, float scale,
                                void* stream) {
  if (bad_shape(BH, T, Tkv) || misaligned({q, k, v})) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return fwd<64>(q, k, v, o, lse, BH, T, Tkv, scale, st);
    case 128: return fwd<128>(q, k, v, o, lse, BH, T, Tkv, scale, st);
    case 192: return fwd<192>(q, k, v, o, lse, BH, T, Tkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// dout, dq like q; dk, dv like k; lse from the forward; delta: (BH, T)
// scratch.  q, k, v, dout 16-byte aligned.  Returns a cudaError_t.
extern "C" int kv_attention_bwd(const float* q, const float* k, const float* v, const float* o,
                                const float* dout, const float* lse, float* delta, float* dq,
                                float* dk, float* dv, int BH, int T, int Tkv, int D,
                                float scale, void* stream) {
  if (bad_shape(BH, T, Tkv) || misaligned({q, k, v, dout})) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, T, Tkv, scale, st);
    case 128: return bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, T, Tkv, scale, st);
    case 192: return bwd<192>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, T, Tkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 form: q, k, v, o, dout, dq, dk, dv bf16 in the f32 entries'
// layouts, D = 64; lse and delta f32.  q, k, v, dout 16-byte aligned.
// Returns a cudaError_t.
extern "C" int kv_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                     float* lse, int BH, int T, int Tkv, int D, float scale,
                                     void* stream) {
  using b16::bf16;
  if (bad_shape(BH, T, Tkv) || D != b16::kD || misaligned({q, k, v}))
    return cudaErrorInvalidValue;
  return b16::fwd(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, BH, T, Tkv, scale,
                  static_cast<cudaStream_t>(stream));
}

// o is not read: delta is summed from dp and p, as the TPU kernel sums it.
extern "C" int kv_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const float* lse, float* delta, void* dq,
                                     void* dk, void* dv, int BH, int T, int Tkv, int D,
                                     float scale, void* stream) {
  using b16::bf16;
  (void)o;
  if (bad_shape(BH, T, Tkv) || D != b16::kD || misaligned({q, k, v, dout}))
    return cudaErrorInvalidValue;
  return b16::bwd(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse, delta,
                  static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), BH, T,
                  Tkv, scale, static_cast<cudaStream_t>(stream));
}
