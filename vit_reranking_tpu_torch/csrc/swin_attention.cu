// Swin window attention, softmax(q k^T * scale + add) v per window, forward
// and backward, on Hopper (sm_90a), in f32.
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
// entries, which is the same function without the P-fold waste.  The two
// contracts differ only in where the additive term is read and where its
// gradient goes.  The packed layout (G, nblk, P T, D) is the batched one
// (G, nW, T, D) in memory.
//
// Design.  One block of 256 threads (a 16 x 16 grid, tx = tid % 16,
// ty = tid / 16) owns one (window, head) and a run of `chunk` images of that
// head.  Every per-window operand lives in shared memory, rows padded to 64
// with zeros: q, k, v (and dO in the backward) row-major at 64 x (D + 4),
// p (and ds) row-major at 64 x 68; the additive term of the (window, head)
// is read once into registers.  The next image's tiles are copied in
// (cp.async, a second buffer) while the block computes this one.  Thread
// (ty, tx) owns score rows 4 ty + i and
// columns tx + 16 j; a row's 16 owners are one half-warp, so row max and row
// sums are shuffles.  The products are register tiles fed by 16-byte
// shared-memory loads (4 rows or 4 steps of the contraction at a time),
// so that the inner loops are bound by the f32 units rather than by shared
// memory; warps whose rows all lie past T skip the products.
//   forward: s = q k^T * scale + add, softmax, o = p v; scores and
//     probabilities never reach device memory.
//   backward: p is recomputed from q, k and add (nothing is saved but the
//     inputs, as on the TPU); dp = dO v^T, ds = p (dp - rowsum(dp p)),
//     dq = ds k * scale, dk = ds^T q * scale, dv = p^T dO.  The block sums ds
//     over its images in registers, in order, and writes one partial per
//     (run of images, head, window).  The TPU kernel summed dbias/dadd in an
//     output block revisited along its sequential grid; blocks here run in
//     no order, so a second launch sums the partials in a fixed order (no
//     float atomics: the result is the same from run to run) into dbias, or
//     into dadd's diagonal blocks with zeros elsewhere.
//
// What bounds it: bytes.  At Swin-T stage 0 and batch 112 (G = 336,
// nW = 64, T = 49, D = 32) the forward reads q, k, v and writes o, 4 x 135
// MB, 0.16 ms at 3.35 TB/s, against 6.6 GFLOP, 0.10 ms at the f32 rate; the
// backward moves 7 such tensors.  The SIMT f32 products (no tensor cores:
// the f32 path must not round to TF32) run on 64-row padded tiles, up to
// 1.7x the work of T = 49, which keeps the code simple at some cost in
// operations.  Supported: 2 <= T <= 64, D a multiple of 8 up to 64.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads: tx = tid % 16, ty = tid / 16
constexpr int kRows = 64;      // window tokens, padded
constexpr int kSub = 4;        // thread (ty, tx) owns rows 4 ty + i and columns tx + 16 j
constexpr int kPS = kRows + 4; // row stride of the p and ds tiles

// Where a call's operands are: q, k, v (G, nW, T, D) with G = H * B; the
// additive term of head h and window w starts at
//   add + h * add_h + (w / P) * add_blk + (w % P) * (T * lda + T)
// with row stride lda, plus mask + w * T * T when a mask is given.
struct Geo {
  int B, H, nW, T, D, P, lda;
  long long add_h, add_blk;
  float scale;
};

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float lane(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// W consecutive floats from shared memory (16 / 8-byte loads where W is 4 / 2).
template <int W>
__device__ __forceinline__ void load_vec(float (&v)[W], const float* p) {
  if constexpr (W == 4) {
    const float4 t = ld4(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = p[j];
  }
}

// 16 bytes from global to shared memory without passing through registers
// (cp.async); zeros instead when `ok` is false.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a (T, D) row-major window into a 64 x (DP + 4) shared tile;
// zeros past row T and column D (D is a multiple of 8, so a 4-float group is
// all in or all out).
template <int DP>
__device__ __forceinline__ void load_window(float* s, const float* __restrict__ g, int T, int D) {
  constexpr int SD = DP + 4, C4 = DP / 4;
  for (int e = threadIdx.x; e < kRows * C4; e += kThreads) {
    const int r = e / C4, c = (e % C4) * 4;
    const bool ok = r < T && c < D;
    copy16(s + r * SD + c, ok ? g + r * D + c : g, ok);
  }
}

// acc[i][j] += sum_d a[4 ty + i][d] * b[tx + 16 j][d] over 64 x (DP + 4) tiles.
template <int DP>
__device__ __forceinline__ void tile_abt(float (&acc)[kSub][kSub], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int SD = DP + 4;
#pragma unroll 1
  for (int d = 0; d < DP; d += 4) {
    float4 av[kSub], bv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) av[i] = ld4(a + (4 * ty + i) * SD + d);
#pragma unroll
    for (int j = 0; j < kSub; ++j) bv[j] = ld4(b + (tx + 16 * j) * SD + d);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(lane(av[i], k), lane(bv[j], k), acc[i][j]);
  }
}

// acc[i][j] += sum_{c < n4} p[4 ty + i][c] * m[c][W tx + j], p 64 x 68, m
// 64 x (DP + 4); n4 is a multiple of 4 and p's columns past T are zeros.
template <int DP>
__device__ __forceinline__ void tile_pm(float (&acc)[kSub][DP / 16], const float* p,
                                        const float* m, int n4, int ty, int tx) {
  constexpr int SD = DP + 4, W = DP / 16;
  for (int c = 0; c < n4; c += 4) {
    float4 pv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) pv[i] = ld4(p + (4 * ty + i) * kPS + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float mv[W];
      load_vec<W>(mv, m + (c + k) * SD + W * tx);
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < W; ++j) acc[i][j] = fmaf(lane(pv[i], k), mv[j], acc[i][j]);
    }
  }
}

// acc[i][j] += sum_{r < n} p[r][4 ty + i] * m[r][W tx + j]: the product with
// p transposed.
template <int DP>
__device__ __forceinline__ void tile_ptm(float (&acc)[kSub][DP / 16], const float* p,
                                         const float* m, int n, int ty, int tx) {
  constexpr int SD = DP + 4, W = DP / 16;
#pragma unroll 4
  for (int r = 0; r < n; ++r) {
    const float4 pv = ld4(p + r * kPS + 4 * ty);
    float mv[W];
    load_vec<W>(mv, m + r * SD + W * tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) acc[i][j] = fmaf(lane(pv, i), mv[j], acc[i][j]);
  }
}

// The additive term of (head h, window w) at this thread's entries; 0
// outside the T x T square.
__device__ __forceinline__ void load_add(float (&a)[kSub][kSub], const float* __restrict__ add,
                                         const float* __restrict__ mask, const Geo& g, int h,
                                         int w, int ty, int tx) {
  const float* A = add + h * g.add_h + (long long)(w / g.P) * g.add_blk +
                   (long long)(w % g.P) * ((long long)g.T * g.lda + g.T);
  const float* M = mask != nullptr ? mask + (long long)w * g.T * g.T : nullptr;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int r = 4 * ty + i, c = tx + 16 * j;
      float x = 0.0f;
      if (r < g.T && c < g.T) {
        x = A[(long long)r * g.lda + c];
        if (M != nullptr) x += M[r * g.T + c];
      }
      a[i][j] = x;
    }
}

// s (the raw q k^T) -> the probabilities softmax(s * scale + add) over each
// row's T columns; 0 outside the T x T square.
__device__ __forceinline__ void probs(float (&s)[kSub][kSub], const float (&a)[kSub][kSub],
                                      int T, float scale, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const bool row_ok = 4 * ty + i < T;
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const bool ok = row_ok && tx + 16 * j < T;
      s[i][j] = ok ? s[i][j] * scale + a[i][j] : -INFINITY;
      mx = fmaxf(mx, s[i][j]);
    }
    mx = row_max16(mx);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      s[i][j] = s[i][j] == -INFINITY ? 0.0f : expf(s[i][j] - mx);
      sum += s[i][j];
    }
    sum = row_sum16(sum);
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = sum > 0.0f ? s[i][j] / sum : 0.0f;
  }
}

// rows < T, columns < D of acc * mul into a (T, D) row-major window.
template <int DP>
__device__ __forceinline__ void store_window(float* __restrict__ g, const float (&acc)[kSub][DP / 16],
                                             float mul, int T, int D, int ty, int tx) {
  constexpr int W = DP / 16;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = 4 * ty + i;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const int c = W * tx + j;
      if (c < D) g[r * D + c] = acc[i][j] * mul;
    }
  }
}

template <int DP>
__device__ __forceinline__ void zero(float (&acc)[kSub][DP / 16]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) acc[i][j] = 0.0f;
}

__device__ __forceinline__ void zero(float (&s)[kSub][kSub]) {
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) s[i][j] = 0.0f;
}

// grid (nW, H, runs of `chunk` images)
template <int DP>
__global__ void __launch_bounds__(kThreads, 3)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ add,
               const float* __restrict__ mask, float* __restrict__ o, Geo g, int chunk) {
  constexpr int SD = DP + 4, kTile = kRows * SD;
  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);  // two buffers of q, k, v
  float* sP = tiles + 6 * kTile;

  const int w = blockIdx.x, h = blockIdx.y;
  const int b0 = blockIdx.z * chunk, b1 = min(b0 + chunk, g.B);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool live = 4 * ty < g.T;  // this thread's rows reach into the window
  const int n4 = (g.T + 3) & ~3;
  const long long stride = (long long)g.nW * g.T * g.D;  // from one image to the next
  const long long first = ((long long)h * g.B * g.nW + w) * g.T * g.D;
  float a[kSub][kSub];
  load_add(a, add, mask, g, h, w, ty, tx);

  // the next image's q, k, v are copied in while this one is computed
  auto fetch = [&](int b, float* buf) {
    const long long at = first + (long long)b * stride;
    load_window<DP>(buf, q + at, g.T, g.D);
    load_window<DP>(buf + kTile, k + at, g.T, g.D);
    load_window<DP>(buf + 2 * kTile, v + at, g.T, g.D);
    copy_commit();
  };
  if (b0 < b1) fetch(b0, tiles);
  for (int b = b0; b < b1; ++b) {
    float* cur = tiles + ((b - b0) & 1) * 3 * kTile;
    if (b + 1 < b1) {
      fetch(b + 1, tiles + ((b + 1 - b0) & 1) * 3 * kTile);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();  // this image's tiles are in
    const float *sQ = cur, *sK = cur + kTile, *sV = cur + 2 * kTile;
    float s[kSub][kSub];
    zero(s);
    if (live) tile_abt<DP>(s, sQ, sK, ty, tx);
    probs(s, a, g.T, g.scale, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) sP[(4 * ty + i) * kPS + tx + 16 * j] = s[i][j];
    __syncthreads();
    if (live) {
      float acc[kSub][DP / 16];
      zero<DP>(acc);
      tile_pm<DP>(acc, sP, sV, n4, ty, tx);
      store_window<DP>(o + first + (long long)b * stride, acc, 1.0f, g.T, g.D, ty, tx);
    }
    __syncthreads();  // every read of this buffer and of p is done
  }
}

// grid (nW, H, runs of `chunk` images); part: (runs, H, nW, T, T), the
// run's sum of ds over its images.
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ add,
               const float* __restrict__ mask, const float* __restrict__ dout,
               float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
               float* __restrict__ part, Geo g, int chunk) {
  constexpr int SD = DP + 4, kTile = kRows * SD;
  extern __shared__ float4 smem4[];
  float* tiles = reinterpret_cast<float*>(smem4);  // two buffers of q, k, v, dO
  float* sP = tiles + 8 * kTile;
  float* sdS = sP + kRows * kPS;

  const int w = blockIdx.x, h = blockIdx.y;
  const int b0 = blockIdx.z * chunk, b1 = min(b0 + chunk, g.B);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const bool live = 4 * ty < g.T;  // this thread's rows reach into the window
  const int n4 = (g.T + 3) & ~3;
  const long long stride = (long long)g.nW * g.T * g.D;  // from one image to the next
  const long long first = ((long long)h * g.B * g.nW + w) * g.T * g.D;
  float a[kSub][kSub], dsum[kSub][kSub];
  load_add(a, add, mask, g, h, w, ty, tx);
  zero(dsum);

  // the next image's q, k, v, dO are copied in while this one is computed
  auto fetch = [&](int b, float* buf) {
    const long long at = first + (long long)b * stride;
    load_window<DP>(buf, q + at, g.T, g.D);
    load_window<DP>(buf + kTile, k + at, g.T, g.D);
    load_window<DP>(buf + 2 * kTile, v + at, g.T, g.D);
    load_window<DP>(buf + 3 * kTile, dout + at, g.T, g.D);
    copy_commit();
  };
  if (b0 < b1) fetch(b0, tiles);
  for (int b = b0; b < b1; ++b) {
    const long long base = first + (long long)b * stride;
    float* cur = tiles + ((b - b0) & 1) * 4 * kTile;
    if (b + 1 < b1) {
      fetch(b + 1, tiles + ((b + 1 - b0) & 1) * 4 * kTile);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();  // this image's tiles are in
    const float *sQ = cur, *sK = cur + kTile, *sV = cur + 2 * kTile, *sdO = cur + 3 * kTile;
    float s[kSub][kSub], dp[kSub][kSub];
    zero(s);
    zero(dp);
    if (live) {
      tile_abt<DP>(s, sQ, sK, ty, tx);
      tile_abt<DP>(dp, sdO, sV, ty, tx);
    }
    probs(s, a, g.T, g.scale, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      float dot = 0.0f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) dot = fmaf(dp[i][j], s[i][j], dot);
      dot = row_sum16(dot);
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float ds = s[i][j] * (dp[i][j] - dot);  // 0 outside the T x T square
        dsum[i][j] += ds;
        const int at = (4 * ty + i) * kPS + tx + 16 * j;
        sP[at] = s[i][j];
        sdS[at] = ds;
      }
    }
    __syncthreads();
    if (live) {
      float acc[kSub][DP / 16];
      zero<DP>(acc);
      tile_ptm<DP>(acc, sP, sdO, g.T, ty, tx);
      store_window<DP>(dv + base, acc, 1.0f, g.T, g.D, ty, tx);
      zero<DP>(acc);
      tile_ptm<DP>(acc, sdS, sQ, g.T, ty, tx);
      store_window<DP>(dk + base, acc, g.scale, g.T, g.D, ty, tx);
      zero<DP>(acc);
      tile_pm<DP>(acc, sdS, sK, n4, ty, tx);
      store_window<DP>(dq + base, acc, g.scale, g.T, g.D, ty, tx);
    }
    __syncthreads();  // every read of this buffer, p and ds is done
  }

  const long long TT = (long long)g.T * g.T;
  float* out = part + (((long long)blockIdx.z * g.H + h) * g.nW + w) * TT;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int r = 4 * ty + i, c = tx + 16 * j;
      if (r < g.T && c < g.T) out[r * g.T + c] = dsum[i][j];
    }
}

// dbias[h][e] = sum over runs z, then windows w, of part[z][h][w][e]
// (e indexes the T x T entries).
__global__ void __launch_bounds__(kThreads)
    reduce_bias_kernel(const float* __restrict__ part, float* __restrict__ dbias, int runs,
                       int H, int nW, int TT) {
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= H * TT) return;
  const int h = idx / TT, e = idx % TT;
  float acc = 0.0f;
  for (int z = 0; z < runs; ++z)
    for (int w = 0; w < nW; ++w) acc += part[(((long long)z * H + h) * nW + w) * TT + e];
  dbias[idx] = acc;
}

// dadd (H, nblk, PT, PT): on the diagonal (T, T) blocks the sum over runs of
// part[z][h][blk * P + p], zeros everywhere else.
__global__ void __launch_bounds__(kThreads)
    reduce_add_kernel(const float* __restrict__ part, float* __restrict__ dadd, int runs, int H,
                      int nblk, int P, int T) {
  const int PT = P * T;
  const long long total = (long long)H * nblk * PT * PT;
  const long long TT = (long long)T * T;
  const int nW = nblk * P;
  for (long long idx = (long long)blockIdx.x * kThreads + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * kThreads) {
    const int c = (int)(idx % PT);
    const int r = (int)((idx / PT) % PT);
    const long long hb = idx / ((long long)PT * PT);
    const int blk = (int)(hb % nblk), h = (int)(hb / nblk);
    float acc = 0.0f;
    if (r / T == c / T) {
      const int w = blk * P + r / T;
      const long long e = (long long)(r % T) * T + c % T;
      for (int z = 0; z < runs; ++z) acc += part[(((long long)z * H + h) * nW + w) * TT + e];
    }
    dadd[idx] = acc;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DP>
int fwd(const float* q, const float* k, const float* v, const float* add, const float* mask,
        float* o, const Geo& g, int chunk, int runs, cudaStream_t st) {
  const size_t smem = (6 * kRows * (DP + 4) + kRows * kPS) * sizeof(float);
  cudaError_t err = allow_smem(fwd_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  fwd_kernel<DP><<<dim3(g.nW, g.H, runs), kThreads, smem, st>>>(q, k, v, add, mask, o, g, chunk);
  return cudaGetLastError();
}

template <int DP>
int bwd(const float* q, const float* k, const float* v, const float* add, const float* mask,
        const float* dout, float* dq, float* dk, float* dv, float* part, const Geo& g, int chunk,
        int runs, cudaStream_t st) {
  const size_t smem = (8 * kRows * (DP + 4) + 2 * kRows * kPS) * sizeof(float);
  cudaError_t err = allow_smem(bwd_kernel<DP>, smem);
  if (err != cudaSuccess) return err;
  bwd_kernel<DP><<<dim3(g.nW, g.H, runs), kThreads, smem, st>>>(q, k, v, add, mask, dout, dq, dk,
                                                               dv, part, g, chunk);
  return cudaGetLastError();
}

bool bad_geo(const Geo& g, int chunk, int runs) {
  return g.B <= 0 || g.H <= 0 || g.H > 65535 || g.nW <= 0 || g.T < 2 || g.T > kRows ||
         g.D <= 0 || g.D > 64 || g.D % 8 != 0 || g.P <= 0 || g.nW % g.P != 0 || g.lda < g.T ||
         chunk <= 0 || runs <= 0 || runs > 65535 || (long long)chunk * runs < g.B;
}

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

// Forward.  q, k, v, o: (H * B, nW, T, D); the additive term as in Geo
// (batched: add = bias (H, T, T), P = 1, add_h = T * T, add_blk = 0,
// lda = T, mask (nW, T, T) or null; packed: add (H, nblk, P T, P T),
// add_h = nblk (P T)^2, add_blk = (P T)^2, lda = P T, mask null).  Images
// are taken `chunk` to a block, runs = ceil(B / chunk).  All f32,
// contiguous.  Returns a cudaError_t.
extern "C" int swin_attention_fwd(const float* q, const float* k, const float* v,
                                  const float* add, const float* mask, float* o, int B, int H,
                                  int nW, int T, int D, int P, long long add_h, long long add_blk,
                                  int lda, int chunk, int runs, float scale, void* stream) {
  const Geo g = make_geo(B, H, nW, T, D, P, add_h, add_blk, lda, scale);
  if (bad_geo(g, chunk, runs)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16) {
    case 1: return fwd<16>(q, k, v, add, mask, o, g, chunk, runs, st);
    case 2: return fwd<32>(q, k, v, add, mask, o, g, chunk, runs, st);
    case 3: return fwd<48>(q, k, v, add, mask, o, g, chunk, runs, st);
    default: return fwd<64>(q, k, v, add, mask, o, g, chunk, runs, st);
  }
}

// Backward.  The same geometry as the forward; dout, dq, dk, dv like q;
// part: (runs, H, nW, T, T) scratch.  grad_add gets dbias (H, T, T) when
// packed is 0, and dadd (H, nW / P, P T, P T) when it is 1.  Returns a
// cudaError_t.
extern "C" int swin_attention_bwd(const float* q, const float* k, const float* v,
                                  const float* add, const float* mask, const float* dout,
                                  float* dq, float* dk, float* dv, float* part, float* grad_add,
                                  int packed, int B, int H, int nW, int T, int D, int P,
                                  long long add_h, long long add_blk, int lda, int chunk,
                                  int runs, float scale, void* stream) {
  const Geo g = make_geo(B, H, nW, T, D, P, add_h, add_blk, lda, scale);
  if (bad_geo(g, chunk, runs)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch ((D + 15) / 16) {
    case 1: err = bwd<16>(q, k, v, add, mask, dout, dq, dk, dv, part, g, chunk, runs, st); break;
    case 2: err = bwd<32>(q, k, v, add, mask, dout, dq, dk, dv, part, g, chunk, runs, st); break;
    case 3: err = bwd<48>(q, k, v, add, mask, dout, dq, dk, dv, part, g, chunk, runs, st); break;
    default: err = bwd<64>(q, k, v, add, mask, dout, dq, dk, dv, part, g, chunk, runs, st);
  }
  if (err != cudaSuccess) return err;
  if (packed) {
    const long long total = (long long)H * (nW / P) * (P * T) * (P * T);
    const long long blocks = (total + kThreads - 1) / kThreads;
    const int grid = (int)(blocks < 8192 ? blocks : 8192);
    reduce_add_kernel<<<grid, kThreads, 0, st>>>(part, grad_add, runs, H, nW / P, P, T);
  } else {
    const int n = H * T * T;
    reduce_bias_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, st>>>(part, grad_add, runs,
                                                                          H, nW, T * T);
  }
  return cudaGetLastError();
}
