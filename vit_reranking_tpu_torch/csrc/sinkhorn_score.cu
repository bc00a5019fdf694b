// Sinkhorn OT rerank score for (query, candidate) pairs, on Hopper (sm_90a).
//
// Replaces the TPU kernel vit_reranking_tpu/ops/rerank_pallas.py::
// _sinkhorn_score_kernel (:97-234, launched by sinkhorn_scores_packed :294).
// For each pair, from its patch similarity S (R x R, rows = candidate
// patches s, columns = query patches m):
//   Km = exp(-(1 - S) / ot_temp)
//   up to `iters` scalings  r = u / (Km c),  c = v / (Km^T r)
//   score = sum_sm r_s Km_sm c_m S_sm
// with the early exit of the reference: once the mean |r_new - r| of a pair
// (group == 1) or of a whole group of `group` consecutive pairs (the per-query
// batch-mean rule) drops below `thresh`, its r and c stop changing.  Partial
// OT (`partial`) adds one dustbin row and column of mass `bin_mass` with a 0
// corner; S is 0 there, so the dustbin adds nothing to the score.  S may
// arrive as bf16; every loop value is f32.
//
// What bounds it: the loop, not the bytes.  S is read once (9.6 KB a pair in
// f32), but each iteration does 2 R^2 multiply-adds a pair and the exit
// comes after 10-100 iterations, with a serial chain of 2 R dependent adds in
// every mat-vec.  The design keeps each pair's Km where re-reading it is
// cheap:
//  * group == 1 (full OT): one warp owns one pair, Km lives in shared memory
//    with an odd row stride, so the row walk (Km c) and the column walk
//    (Km^T r) are both free of bank conflicts; warps never wait for each
//    other.
//  * group > 1 (partial OT, group exit): the exit needs the residual of all
//    the group's pairs after every iteration, and K = 100 pairs of Km do not
//    fit one SM.  One block owns the group, its warps walk the pairs, Km and
//    its transpose sit in a global scratch buffer (L2-resident for the
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

template <typename T>
__device__ void init_pair(const T* S_p, float* Km, float* KmT, float* r, float* c,
                          const Problem& pb, int lane) {
  const int R = pb.R, RP = pb.RP, ld = pb.ld;
  for (int i = lane; i < RP * RP; i += 32) {
    const int s = i / RP;
    const int m = i - s * RP;
    float k;
    if (s < R && m < R) {
      k = expf(-(1.0f - load_f32(S_p, (long)s * R + m)) / pb.ot_temp);
    } else if (s == R && m == R) {
      k = 0.0f;
    } else {
      k = pb.bin;
    }
    Km[s * ld + m] = k;
    if (KmT != nullptr) KmT[m * ld + s] = k;
  }
  for (int i = lane; i < RP; i += 32) {
    r[i] = 1.0f;
    c[i] = 1.0f;
  }
  __syncwarp();
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
__global__ void sinkhorn_score_kernel(const T* __restrict__ S, const float* __restrict__ u,
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
    init_pair(S_p, Km, static_cast<float*>(nullptr), r, c, pb, lane);
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
    init_pair(S + p * RR, Km, Km + RP * ld, r_all + lp * RP, c_all + lp * RP, pb, lane);
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

template <typename T>
cudaError_t launch(const void* S, const float* u, const float* v, float* out, float* km,
                   int n_pairs, int group, int iters, float thresh, const Problem& pb,
                   int blocks, int threads, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(sinkhorn_score_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  sinkhorn_score_kernel<T><<<blocks, threads, smem, stream>>>(
      static_cast<const T*>(S), u, v, out, km, n_pairs, group, iters, thresh, pb);
  return cudaGetLastError();
}

}  // namespace

// S: (n_pairs, R, R) f32 or bf16; u, v: (n_pairs, R) f32; out: (n_pairs,) f32.
// km_scratch: n_pairs * 2 * RP * (RP | 1) floats when group > 1, else unused.
// Returns a cudaError_t.
extern "C" int sinkhorn_score_launch(const void* S, int s_is_bf16, const float* u, const float* v,
                                     float* out, float* km_scratch, int n_pairs, int R,
                                     int partial, float bin_mass, float ot_temp, int iters,
                                     float thresh, int group, void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (R <= 0 || group <= 0 || n_pairs % group != 0) return cudaErrorInvalidValue;
  if (group > 1 && km_scratch == nullptr) return cudaErrorInvalidValue;
  Problem pb;
  pb.R = R;
  pb.RP = R + (partial ? 1 : 0);
  pb.ld = pb.RP | 1;
  pb.bin = bin_mass;
  pb.ot_temp = ot_temp;
  int warps, blocks;
  size_t smem;
  if (group == 1) {
    warps = 8;
    blocks = (n_pairs + warps - 1) / warps;
    smem = sizeof(float) * (size_t)warps * (pb.RP * pb.ld + 2 * pb.RP);
  } else {
    warps = 16;
    blocks = n_pairs / group;
    smem = sizeof(float) * ((size_t)2 * group * pb.RP + warps);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_is_bf16) {
    return launch<__nv_bfloat16>(S, u, v, out, km_scratch, n_pairs, group, iters, thresh, pb,
                                 blocks, warps * 32, smem, st);
  }
  return launch<float>(S, u, v, out, km_scratch, n_pairs, group, iters, thresh, pb, blocks,
                       warps * 32, smem, st);
}
