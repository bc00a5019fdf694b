// Sinkhorn OT rerank score for (query, candidate) pairs, on Hopper (sm_90a).
//
// Replaces the TPU kernel vit_reranking_tpu/ops/rerank_pallas.py::
// _sinkhorn_score_kernel (:97-234, launched by sinkhorn_scores_packed :294).
// For each pair, from its patch similarity S (R x R, rows = candidate
// patches s, columns = query patches m):
//   Km = exp(-(1 - S) / ot_temp)     (or from a separate cost C, below)
//   up to `iters` scalings  r = u / (Km c),  c = v / (Km^T r)
//   score = sum_sm r_s Km_sm c_m S_sm
// with the early exit of the reference: once the mean |r_new - r| of a pair
// (group == 1) or of a whole group of `group` consecutive pairs (the per-query
// batch-mean rule) drops below `thresh`, its r and c stop changing.  Partial
// OT (`partial`) adds one dustbin row and column of mass `bin_mass` with a 0
// corner; S is 0 there, so the dustbin adds nothing to the score.  S may
// arrive as bf16; every loop value is f32.
//
// Mode (d) of the TPU kernel (`has_cost`, rerank_pallas.py:115-127): when C
// is given (same shape and dtype as S), Km = exp(-(1 - C) / ot_temp) comes
// from C (the qk method's q.k attention map) while the score still
// contracts against S.  Only the source of Km changes, in every layout.
//
// What bounds it: the loop, not the bytes.  S (and C) is read once (9.6 KB a
// pair in f32 at R = 49, 154 KB at R = 196), but each iteration does 2 R^2
// multiply-adds a pair and the exit comes after 2-100 iterations, with a
// serial chain of R dependent adds in every mat-vec.  The design keeps each
// pair's Km where re-reading it is cheap; the launcher picks the layout from
// its shared-memory footprint against the card's per-block limit:
//  * warp (group == 1, while 8 pairs fit a block, R <= 83): one warp owns one
//    pair, Km lives in shared memory with an odd row stride, so the row walk
//    (Km c) and the column walk (Km^T r) are both free of bank conflicts;
//    warps never wait for each other.
//  * block (group == 1, larger R, up to R = 239 on a 227 KB card): one block
//    owns one pair, Km (154 KB at R = 196) with r and c beside it in shared
//    memory.  All the block's threads share each mat-vec (rows across
//    threads for Km c, columns across threads for Km^T r, the same
//    conflict-free walks), with a block barrier between the half-steps.
//    The exit residual and the final score are fixed-order block
//    reductions, so every thread takes the same exit decision.
//  * group (group > 1, partial OT, group exit): the exit needs the residual
//    of all the group's pairs after every iteration, and K = 100 pairs of Km
//    do not fit one SM.  One block owns the group, its warps walk the pairs,
//    Km and its transpose sit in a global scratch buffer (L2-resident for the
//    group's working set as far as it fits), r and c stay in shared memory,
//    and a fixed-order block reduction gives every thread the same exit
//    decision.
// Division is IEEE (no fast math): the exit decisions depend on it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

struct Problem {
  int R;          // real patches on each side
  int RP;         // R, plus the dustbin under partial OT
  int ld;         // row stride of Km in floats (odd)
  float bin;      // dustbin mass, 1 - ot_part
  float ot_temp;  // entropic temperature
};

// One pair as a warp sees it.  Kc[s] = sum_m A[m * a_m + s * a_s] c[m] reads
// Km through A (Km itself in shared memory, its transpose in global memory,
// so the lanes' addresses are conflict free or coalesced either way).
struct PairView {
  const float* Km;
  const float* A;
  int a_m;
  int a_s;
  float* r;
  float* c;
  const float* u;
  const float* v;
};

__device__ __forceinline__ float load_f32(const float* p, long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Km of one pair from its cost source K_p (S itself, or C in mode (d)),
// r = c = 1; the `n` threads `t` = 0..n-1 of a warp or a block share the
// work.  The caller synchronises them before Km is read.
template <typename T>
__device__ void init_pair(const T* K_p, float* Km, float* KmT, float* r, float* c,
                          const Problem& pb, int t, int n) {
  const int R = pb.R, RP = pb.RP, ld = pb.ld;
  for (int i = t; i < RP * RP; i += n) {
    const int s = i / RP;
    const int m = i - s * RP;
    float k;
    if (s < R && m < R) {
      k = expf(-(1.0f - load_f32(K_p, (long)s * R + m)) / pb.ot_temp);
    } else if (s == R && m == R) {
      k = 0.0f;
    } else {
      k = pb.bin;
    }
    Km[s * ld + m] = k;
    if (KmT != nullptr) KmT[m * ld + s] = k;
  }
  for (int i = t; i < RP; i += n) {
    r[i] = 1.0f;
    c[i] = 1.0f;
  }
}

// One scaling iteration of one pair; returns sum_s |r_new - r| (every lane).
__device__ float step_pair(const PairView& p, const Problem& pb, int lane) {
  const int R = pb.R, RP = pb.RP, ld = pb.ld;
  float dr = 0.0f;
  for (int s = lane; s < RP; s += 32) {
    float kc = 0.0f;
    for (int m = 0; m < RP; ++m) kc = fmaf(p.A[m * p.a_m + s * p.a_s], p.c[m], kc);
    const float us = s < R ? p.u[s] : pb.bin;
    const float rn = us / kc;
    dr += fabsf(rn - p.r[s]);
    p.r[s] = rn;  // no other lane reads r before the barrier
  }
  __syncwarp();
  for (int m = lane; m < RP; m += 32) {
    float ktr = 0.0f;
    for (int s = 0; s < RP; ++s) ktr = fmaf(p.Km[s * ld + m], p.r[s], ktr);
    const float vm = m < R ? p.v[m] : pb.bin;
    p.c[m] = vm / ktr;
  }
  __syncwarp();
  return warp_sum(dr);
}

// sum_sm r_s Km_sm S_sm c_m over the real patches (S is 0 on the dustbin).
template <typename T>
__device__ float score_pair(const T* S_p, const PairView& p, const Problem& pb, int lane) {
  const int R = pb.R, ld = pb.ld;
  float part = 0.0f;
  for (int m = lane; m < R; m += 32) {
    float t = 0.0f;
    for (int s = 0; s < R; ++s) {
      t = fmaf(p.r[s] * p.Km[s * ld + m], load_f32(S_p, (long)s * R + m), t);
    }
    part = fmaf(t, p.c[m], part);
  }
  return warp_sum(part);
}

template <typename T>
__global__ void sinkhorn_score_kernel(const T* __restrict__ S, const T* __restrict__ C,
                                      const float* __restrict__ u,
                                      const float* __restrict__ v, float* __restrict__ out,
                                      float* __restrict__ km_global, int n_pairs, int group,
                                      int iters, float thresh, Problem pb) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int R = pb.R, RP = pb.RP, ld = pb.ld;
  const long RR = (long)R * R;

  if (group == 1) {
    // one warp, one pair, its own exit; no block-wide barrier below
    const long p = (long)blockIdx.x * nwarps + warp;
    if (p >= n_pairs) return;
    float* Km = smem + (long)warp * (RP * ld + 2 * RP);
    float* r = Km + RP * ld;
    float* c = r + RP;
    const T* S_p = S + p * RR;
    init_pair(C != nullptr ? C + p * RR : S_p, Km, static_cast<float*>(nullptr), r, c, pb,
              lane, 32);
    __syncwarp();
    const PairView pv{Km, Km, 1, ld, r, c, u + p * R, v + p * R};
    for (int it = 0; it < iters; ++it) {
      const float err = step_pair(pv, pb, lane) / (float)RP;
      if (err < thresh) break;
    }
    const float sc = score_pair(S_p, pv, pb, lane);
    if (lane == 0) out[p] = sc;
    return;
  }

  // one block, one group of pairs sharing the exit decision
  const long p0 = (long)blockIdx.x * group;
  float* r_all = smem;
  float* c_all = smem + group * RP;
  float* red = c_all + group * RP;  // one partial sum per warp
  const long kstride = 2L * RP * ld;
  for (int lp = warp; lp < group; lp += nwarps) {
    const long p = p0 + lp;
    float* Km = km_global + p * kstride;
    init_pair((C != nullptr ? C : S) + p * RR, Km, Km + RP * ld, r_all + lp * RP,
              c_all + lp * RP, pb, lane, 32);
    __syncwarp();
  }
  const float denom = (float)(RP * group);
  for (int it = 0; it < iters; ++it) {
    float dr = 0.0f;
    for (int lp = warp; lp < group; lp += nwarps) {
      const long p = p0 + lp;
      const float* Km = km_global + p * kstride;
      const PairView pv{Km, Km + RP * ld, ld, 1, r_all + lp * RP, c_all + lp * RP,
                        u + p * R, v + p * R};
      dr += step_pair(pv, pb, lane);
    }
    if (lane == 0) red[warp] = dr;
    __syncthreads();
    // every thread sums in the same order, so all take the same decision
    float tot = 0.0f;
    for (int w = 0; w < nwarps; ++w) tot += red[w];
    __syncthreads();  // red is rewritten in the next iteration
    if (tot / denom < thresh) break;
  }
  for (int lp = warp; lp < group; lp += nwarps) {
    const long p = p0 + lp;
    const float* Km = km_global + p * kstride;
    const PairView pv{Km, Km + RP * ld, ld, 1, r_all + lp * RP, c_all + lp * RP,
                      u + p * R, v + p * R};
    const float sc = score_pair(S + p * RR, pv, pb, lane);
    if (lane == 0) out[p] = sc;
  }
}

// One block, one pair (the block layout): Km (RP x ld), r, c and one partial
// sum per warp in shared memory.  Threads own rows for Km c and columns for
// Km^T r; a barrier separates the half-steps, and every thread sums the
// warps' residuals in the same order, so all of them break together.
template <typename T>
__global__ void sinkhorn_score_block_kernel(const T* __restrict__ S, const T* __restrict__ C,
                                            const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            float* __restrict__ out, int iters, float thresh,
                                            Problem pb) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nt >> 5;
  const int R = pb.R, RP = pb.RP, ld = pb.ld;
  const long p = blockIdx.x;
  const long RR = (long)R * R;
  float* Km = smem;
  float* r = Km + RP * ld;
  float* c = r + RP;
  float* red = c + RP;
  const T* S_p = S + p * RR;
  const float* u_p = u + p * R;
  const float* v_p = v + p * R;

  init_pair(C != nullptr ? C + p * RR : S_p, Km, static_cast<float*>(nullptr), r, c, pb, tid,
            nt);
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    float dr = 0.0f;
    for (int s = tid; s < RP; s += nt) {
      float kc = 0.0f;
      for (int m = 0; m < RP; ++m) kc = fmaf(Km[s * ld + m], c[m], kc);
      const float us = s < R ? u_p[s] : pb.bin;
      const float rn = us / kc;
      dr += fabsf(rn - r[s]);
      r[s] = rn;  // only its owner reads r[s] before the barrier
    }
    dr = warp_sum(dr);
    if (lane == 0) red[warp] = dr;
    __syncthreads();  // r and the warps' residuals complete
    for (int m = tid; m < RP; m += nt) {
      float ktr = 0.0f;
      for (int s = 0; s < RP; ++s) ktr = fmaf(Km[s * ld + m], r[s], ktr);
      const float vm = m < R ? v_p[m] : pb.bin;
      c[m] = vm / ktr;
    }
    float tot = 0.0f;
    for (int w = 0; w < nwarps; ++w) tot += red[w];
    __syncthreads();  // c complete; red is rewritten in the next iteration
    if (tot / (float)RP < thresh) break;
  }
  // sum_sm r_s Km_sm S_sm c_m over the real patches, columns across threads
  float part = 0.0f;
  for (int m = tid; m < R; m += nt) {
    float t = 0.0f;
    for (int s = 0; s < R; ++s) t = fmaf(r[s] * Km[s * ld + m], load_f32(S_p, (long)s * R + m), t);
    part = fmaf(t, c[m], part);
  }
  part = warp_sum(part);
  if (lane == 0) red[warp] = part;
  __syncthreads();
  if (tid == 0) {
    float sc = 0.0f;
    for (int w = 0; w < nwarps; ++w) sc += red[w];
    out[p] = sc;
  }
}

enum Layout { kNone = -1, kWarp = 0, kBlock = 1, kGroup = 2 };
constexpr int kWarpLayoutWarps = 8;    // pairs a block in the warp layout
constexpr int kBlockLayoutWarps = 8;   // threads / 32 of the block layout
constexpr int kGroupLayoutWarps = 16;  // threads / 32 of the group layout

// The layout for this problem and its dynamic shared memory in bytes, from
// the footprint against the current card's per-block limit.
cudaError_t plan(int R, int partial, int group, int* layout, size_t* smem, int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t RP = (size_t)R + (partial ? 1 : 0);
  const size_t ld = RP | 1;
  const size_t f = sizeof(float);
  if (group > 1) {
    *layout = kGroup;
    *smem = f * (2 * (size_t)group * RP + kGroupLayoutWarps);
  } else if (f * kWarpLayoutWarps * (RP * ld + 2 * RP) <= (size_t)*limit) {
    *layout = kWarp;
    *smem = f * kWarpLayoutWarps * (RP * ld + 2 * RP);
  } else {
    *layout = kBlock;
    *smem = f * (RP * ld + 2 * RP + kBlockLayoutWarps);
  }
  if (*smem > (size_t)*limit) *layout = kNone;
  return cudaSuccess;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T>
cudaError_t launch(const void* S_, const void* C_, const float* u, const float* v, float* out,
                   float* km, int n_pairs, int group, int iters, float thresh,
                   const Problem& pb, int layout, size_t smem, cudaStream_t stream) {
  const T* S = static_cast<const T*>(S_);
  const T* C = static_cast<const T*>(C_);
  cudaError_t e;
  if (layout == kBlock) {
    e = allow_smem(sinkhorn_score_block_kernel<T>, smem);
    if (e != cudaSuccess) return e;
    sinkhorn_score_block_kernel<T><<<n_pairs, kBlockLayoutWarps * 32, smem, stream>>>(
        S, C, u, v, out, iters, thresh, pb);
    return cudaGetLastError();
  }
  e = allow_smem(sinkhorn_score_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  int warps, blocks;
  if (layout == kWarp) {
    warps = kWarpLayoutWarps;
    blocks = (n_pairs + warps - 1) / warps;
  } else {
    warps = kGroupLayoutWarps;
    blocks = n_pairs / group;
  }
  sinkhorn_score_kernel<T><<<blocks, warps * 32, smem, stream>>>(
      S, C, u, v, out, km, n_pairs, group, iters, thresh, pb);
  return cudaGetLastError();
}

}  // namespace

// The layout sinkhorn_score_launch takes for (R, partial, group) on the
// current card: 0 warp, 1 block, 2 group, -1 none fits; its shared memory
// in bytes and the card's per-block limit.  Returns a cudaError_t.
extern "C" int sinkhorn_score_plan(int R, int partial, int group, int* layout,
                                   long long* smem_bytes, int* limit_bytes) {
  size_t smem = 0;
  cudaError_t e = plan(R, partial, group, layout, &smem, limit_bytes);
  *smem_bytes = (long long)smem;
  return e;
}

// S, and C when not null: (n_pairs, R, R) f32 or bf16 (C has S's dtype);
// u, v: (n_pairs, R) f32; out: (n_pairs,) f32.  km_scratch: n_pairs * 2 * RP
// * (RP | 1) floats when group > 1, else unused.  Returns a cudaError_t
// (cudaErrorInvalidValue when no layout fits the card).
extern "C" int sinkhorn_score_launch(const void* S, const void* C, int s_is_bf16, const float* u,
                                     const float* v, float* out, float* km_scratch, int n_pairs,
                                     int R, int partial, float bin_mass, float ot_temp, int iters,
                                     float thresh, int group, void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (R <= 0 || group <= 0 || n_pairs % group != 0) return cudaErrorInvalidValue;
  if (group > 1 && km_scratch == nullptr) return cudaErrorInvalidValue;
  int layout = kNone, limit = 0;
  size_t smem = 0;
  cudaError_t e = plan(R, partial, group, &layout, &smem, &limit);
  if (e != cudaSuccess) return e;
  if (layout == kNone) return cudaErrorInvalidValue;
  Problem pb;
  pb.R = R;
  pb.RP = R + (partial ? 1 : 0);
  pb.ld = pb.RP | 1;
  pb.bin = bin_mass;
  pb.ot_temp = ot_temp;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_is_bf16) {
    return launch<__nv_bfloat16>(S, C, u, v, out, km_scratch, n_pairs, group, iters, thresh, pb,
                                 layout, smem, st);
  }
  return launch<float>(S, C, u, v, out, km_scratch, n_pairs, group, iters, thresh, pb, layout,
                       smem, st);
}
