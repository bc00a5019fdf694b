// KV-resident attention, softmax(q k^T * scale) v, forward and backward, on
// Hopper (sm_90a), f32 in and out, products on the tensor cores.
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
