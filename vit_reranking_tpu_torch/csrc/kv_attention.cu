// KV-resident attention, softmax(q k^T * scale) v, forward and backward, on
// Hopper (sm_90a), in f32.
//
// Replaces the TPU kernels vit_reranking_tpu/ops/attention_pallas.py::
// _fwd_kernel (:48, launched by _fwd :131) and _bwd_kernel (:66, launched by
// _bwd :152).  q (BH, T, D), k and v (BH, Tkv, D), all row-major f32, D 64
// or 128.  CvT-13 stage 0 at 224 px: T = 3136, Tkv = 784, D = 64.
//
// What changes from the TPU design.  The TPU kernel keeps the whole k and v
// of a head in VMEM (at stage 0 in f32: 2 x 200 KB) and computes one plain
// softmax per q block.  A Hopper block has at most 227 KB of shared memory,
// so here k and v stream through in 64-row tiles:
//
//   forward: one block per (64 q rows, head).  Per kv tile, S = q k^T in
//     registers, an online softmax (running row max m and sum l, f32), and
//     O += P V with P staged in shared memory.  It writes O and the per-row
//     log-sum-exp lse = m + log(l); neither S nor P reaches device memory.
//   backward: the TPU kernel carries dK/dV across its sequential q-block
//     grid in VMEM scratch.  Blocks here run in no order, so the work is
//     split three ways, with no float atomics (results are the same from run
//     to run):
//       delta = rowsum(dO * O), one warp per row;
//       one block per (64 kv rows, head) loops over every q tile,
//         recomputes P = exp(S * scale - lse), and accumulates
//         dV += P^T dO and dK += dS^T Q in registers,
//         dS = P * (dP - delta) * scale with dP = dO V^T;
//       one block per (64 q rows, head) loops over the kv tiles and
//         accumulates dQ += dS K.
//
// What bounds it: operations.  At stage 0 (BH = 112) the forward is
// 4 T Tkv D BH = 7.05e10 flop against 0.23 GB of q, k, v and O, and the
// backward about 10 T Tkv D BH; both are far above the card's f32
// flop-per-byte line.  This first version uses the f32 SIMT units (no tensor
// cores: the f32 path must not round to TF32) with 4 x 4 register tiles per
// thread fed from shared memory; every tile is row-major with one float of
// padding per row, so the column-strided reads of a warp hit distinct banks.
// Tensor cores (bf16 operands, wgmma) are later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // a 16 x 16 grid of threads: tx = tid % 16, ty = tid / 16
constexpr int kTile = 64;      // q rows and kv rows per tile
constexpr int kSub = 4;        // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j
constexpr int kPStride = kTile + 1;

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

// Rows [row0, row0 + 64) of a (rows, D) row-major matrix into a 64 x (D + 1)
// shared tile; rows past the end are zeros.
template <int D>
__device__ __forceinline__ void load_tile(float* s, const float* __restrict__ g, int row0,
                                          int rows) {
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int gr = row0 + r;
    s[r * (D + 1) + c] = gr < rows ? g[(long long)gr * D + c] : 0.0f;
  }
}

// acc[i][j] += sum_d a[(ty + 16 i)][d] * b[(tx + 16 j)][d] over 64 x (D + 1) tiles.
template <int D>
__device__ __forceinline__ void tile_abt(float (&acc)[kSub][kSub], const float* a,
                                         const float* b, int ty, int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float av[kSub], bv[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) av[i] = a[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < kSub; ++j) bv[j] = b[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r p'[i][r] * m[r][tx + 16 j], where p is 64 x 65, m is
// 64 x (D + 1), and p'[i][r] is p[ty + 16 i][r] when kPByRow, else p[r][ty + 16 i].
template <int D, bool kPByRow>
__device__ __forceinline__ void tile_pm(float (&acc)[kSub][D / 16], const float* p,
                                        const float* m, int ty, int tx) {
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float pv[kSub], mv[D / 16];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
      pv[i] = kPByRow ? p[(ty + 16 * i) * kPStride + r] : p[r * kPStride + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) mv[j] = m[r * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(pv[i], mv[j], acc[i][j]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int T, int Tkv, float scale) {
  constexpr int SD = D + 1;
  constexpr int kO = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kTile * SD;
  float* sV = sK + kTile * SD;
  float* sP = sV + kTile * SD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + (long long)bh * Tkv * D;
  const float* vb = v + (long long)bh * Tkv * D;
  load_tile<D>(sQ, q + (long long)bh * T * D, q0, T);

  float m[kSub], l[kSub], acc[kSub][kO];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kO; ++j) acc[i][j] = 0.0f;
  }

  for (int k0 = 0; k0 < Tkv; k0 += kTile) {
    __syncthreads();  // the previous tile's reads of sK, sV and sP are done
    load_tile<D>(sK, kb, k0, Tkv);
    load_tile<D>(sV, vb, k0, Tkv);
    __syncthreads();
    float s[kSub][kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i)
#pragma unroll
      for (int j = 0; j < kSub; ++j) s[i][j] = 0.0f;
    tile_abt<D>(s, sQ, sK, ty, tx);
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        s[i][j] = (k0 + tx + 16 * j < Tkv) ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // every tile starts inside the kv rows, so each row has a finite max
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kSub; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * corr + row_sum16(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kO; ++j) acc[i][j] *= corr;
    }
    __syncthreads();
    tile_pm<D, true>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= T) continue;
    float* orow = o + ((long long)bh * T + r) * D;
#pragma unroll
    for (int j = 0; j < kO; ++j) orow[tx + 16 * j] = acc[i][j] / l[i];
    if (tx == 0) lse[(long long)bh * T + r] = m[i] + logf(l[i]);
  }
}

// delta[row] = sum_d dO[row][d] * O[row][d], one warp per row.
template <int D>
__global__ void __launch_bounds__(kThreads)
    delta_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                 float* __restrict__ delta, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  float acc = 0.0f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(dout[row * D + c], o[row * D + c], acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// P and dS of one (64 q rows) x (64 kv rows) tile into shared memory, from
// the q-side tiles sQ, sdO and the kv-side tiles sK, sV.
template <int D>
__device__ __forceinline__ void p_ds_tile(float* sP, float* sdS, const float* sQ,
                                          const float* sdO, const float* sK, const float* sV,
                                          const float (&lse)[kSub], const float (&delta)[kSub],
                                          int q0, int k0, int T, int Tkv, float scale, int ty,
                                          int tx) {
  float s[kSub][kSub], dp[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      s[i][j] = 0.0f;
      dp[i][j] = 0.0f;
    }
  tile_abt<D>(s, sQ, sK, ty, tx);
  tile_abt<D>(dp, sdO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const bool row_ok = q0 + ty + 16 * i < T;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const bool ok = row_ok && (k0 + tx + 16 * j < Tkv);
      const float p = ok ? expf(s[i][j] * scale - lse[i]) : 0.0f;
      const int at = (ty + 16 * i) * kPStride + tx + 16 * j;
      if (sP != nullptr) sP[at] = p;
      sdS[at] = p * (dp[i][j] - delta[i]) * scale;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, int T, int Tkv, float scale) {
  constexpr int SD = D + 1;
  constexpr int kO = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kTile * SD;
  float* sQ = sV + kTile * SD;
  float* sdO = sQ + kTile * SD;
  float* sP = sdO + kTile * SD;
  float* sdS = sP + kTile * kPStride;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* qb = q + (long long)bh * T * D;
  const float* dob = dout + (long long)bh * T * D;
  const float* lseb = lse + (long long)bh * T;
  const float* deltab = delta + (long long)bh * T;
  load_tile<D>(sK, k + (long long)bh * Tkv * D, k0, Tkv);
  load_tile<D>(sV, v + (long long)bh * Tkv * D, k0, Tkv);

  // kv rows k0 + ty + 16 i, columns tx + 16 j
  float dk_acc[kSub][kO], dv_acc[kSub][kO];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kO; ++j) {
      dk_acc[i][j] = 0.0f;
      dv_acc[i][j] = 0.0f;
    }

  for (int q0 = 0; q0 < T; q0 += kTile) {
    __syncthreads();  // the previous q tile's reads are done
    load_tile<D>(sQ, qb, q0, T);
    load_tile<D>(sdO, dob, q0, T);
    float lse_r[kSub], delta_r[kSub];
#pragma unroll
    for (int i = 0; i < kSub; ++i) {
      const int r = q0 + ty + 16 * i;
      lse_r[i] = r < T ? lseb[r] : 0.0f;
      delta_r[i] = r < T ? deltab[r] : 0.0f;
    }
    __syncthreads();
    p_ds_tile<D>(sP, sdS, sQ, sdO, sK, sV, lse_r, delta_r, q0, k0, T, Tkv, scale, ty, tx);
    __syncthreads();
    tile_pm<D, false>(dv_acc, sP, sdO, ty, tx);
    tile_pm<D, false>(dk_acc, sdS, sQ, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int c = k0 + ty + 16 * i;
    if (c >= Tkv) continue;
    const long long at = ((long long)bh * Tkv + c) * D;
#pragma unroll
    for (int j = 0; j < kO; ++j) {
      dk[at + tx + 16 * j] = dk_acc[i][j];
      dv[at + tx + 16 * j] = dv_acc[i][j];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, int T, int Tkv, float scale) {
  constexpr int SD = D + 1;
  constexpr int kO = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + kTile * SD;
  float* sK = sdO + kTile * SD;
  float* sV = sK + kTile * SD;
  float* sdS = sV + kTile * SD;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const float* kb = k + (long long)bh * Tkv * D;
  const float* vb = v + (long long)bh * Tkv * D;
  load_tile<D>(sQ, q + (long long)bh * T * D, q0, T);
  load_tile<D>(sdO, dout + (long long)bh * T * D, q0, T);
  float lse_r[kSub], delta_r[kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < T ? lse[(long long)bh * T + r] : 0.0f;
    delta_r[i] = r < T ? delta[(long long)bh * T + r] : 0.0f;
  }

  // q rows q0 + ty + 16 i, columns tx + 16 j
  float acc[kSub][kO];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kO; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < Tkv; k0 += kTile) {
    __syncthreads();  // the previous kv tile's reads are done
    load_tile<D>(sK, kb, k0, Tkv);
    load_tile<D>(sV, vb, k0, Tkv);
    __syncthreads();
    p_ds_tile<D>(nullptr, sdS, sQ, sdO, sK, sV, lse_r, delta_r, q0, k0, T, Tkv, scale, ty, tx);
    __syncthreads();
    tile_pm<D, true>(acc, sdS, sK, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= T) continue;
    float* row = dq + ((long long)bh * T + r) * D;
#pragma unroll
    for (int j = 0; j < kO; ++j) row[tx + 16 * j] = acc[i][j];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int D>
int fwd(const float* q, const float* k, const float* v, float* o, float* lse, int BH, int T,
        int Tkv, float scale, cudaStream_t st) {
  const size_t smem = (3 * kTile * (D + 1) + kTile * kPStride) * sizeof(float);
  cudaError_t err = allow_smem(fwd_kernel<D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTile - 1) / kTile, BH);
  fwd_kernel<D><<<grid, kThreads, smem, st>>>(q, k, v, o, lse, T, Tkv, scale);
  return cudaGetLastError();
}

template <int D>
int bwd(const float* q, const float* k, const float* v, const float* o, const float* dout,
        const float* lse, float* delta, float* dq, float* dk, float* dv, int BH, int T, int Tkv,
        float scale, cudaStream_t st) {
  const long long rows = (long long)BH * T;
  const long long row_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  delta_kernel<D><<<(unsigned)row_blocks, kThreads, 0, st>>>(o, dout, delta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const size_t smem_kv = (4 * kTile * (D + 1) + 2 * kTile * kPStride) * sizeof(float);
  if ((err = allow_smem(dkdv_kernel<D>, smem_kv)) != cudaSuccess) return err;
  dkdv_kernel<D><<<dim3((Tkv + kTile - 1) / kTile, BH), kThreads, smem_kv, st>>>(
      q, k, v, dout, lse, delta, dk, dv, T, Tkv, scale);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const size_t smem_q = (4 * kTile * (D + 1) + kTile * kPStride) * sizeof(float);
  if ((err = allow_smem(dq_kernel<D>, smem_q)) != cudaSuccess) return err;
  dq_kernel<D><<<dim3((T + kTile - 1) / kTile, BH), kThreads, smem_q, st>>>(
      q, k, v, dout, lse, delta, dq, T, Tkv, scale);
  return cudaGetLastError();
}

bool bad_shape(int BH, int T, int Tkv) { return BH <= 0 || BH > 65535 || T <= 0 || Tkv <= 0; }

}  // namespace

// q, o: (BH, T, D); k, v: (BH, Tkv, D); lse: (BH, T).  All f32, contiguous.
// Returns a cudaError_t.
extern "C" int kv_attention_fwd(const float* q, const float* k, const float* v, float* o,
                                float* lse, int BH, int T, int Tkv, int D, float scale,
                                void* stream) {
  if (bad_shape(BH, T, Tkv)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return fwd<64>(q, k, v, o, lse, BH, T, Tkv, scale, st);
    case 128: return fwd<128>(q, k, v, o, lse, BH, T, Tkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

// dout, dq like q; dk, dv like k; lse from the forward; delta: (BH, T)
// scratch.  Returns a cudaError_t.
extern "C" int kv_attention_bwd(const float* q, const float* k, const float* v, const float* o,
                                const float* dout, const float* lse, float* delta, float* dq,
                                float* dk, float* dv, int BH, int T, int Tkv, int D,
                                float scale, void* stream) {
  if (bad_shape(BH, T, Tkv)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return bwd<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, T, Tkv, scale, st);
    case 128: return bwd<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, BH, T, Tkv, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
