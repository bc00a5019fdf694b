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
// What bounds it: S (and C) is read once (9.6 KB a pair in f32 at R = 49,
// 154 KB at R = 196), but each iteration does 2 RP^2 multiply-adds a pair
// on Km, which is read again every half-step, and the exit comes after 2-100
// iterations.  So the time goes to latency (dependent sums, divisions,
// barriers) and to reading Km from shared memory, which is where each pair's
// Km stays.  The launcher picks the layout from the footprint:
//  * warp (group == 1, RP <= 83): one warp owns one pair.  Its lanes form a
//    4 x 8 grid: lane (a, b) holds the partial sums of Km rows a + 4i over
//    columns b + 8j, so Km c is NI = ceil(RP / 4) chains of NJ = ceil(RP / 8)
//    terms and Km^T r NJ chains of NI terms, then a reduce-scatter over the 8
//    (or 4) lanes that share the outputs: each lane ends with whole sums of
//    its own slots, so no lane idles and each output is divided once.  Km sits
//    in shared memory, zero-padded to 4 NI rows of stride 8 (NJ | 1), which
//    keeps both walks free of bank conflicts and the loops free of guards;
//    2 pairs a block.  S for the score is read once more from global memory,
//    on the same grid.
//  * block (group == 1, 83 < RP <= 239 on a 227 KB card): one block of 16
//    warps owns one pair, Km with r and c beside it in shared memory.  Both
//    mat-vecs give each warp whole outputs: warp w takes rows (for Km c) or
//    columns (for Km^T r) w + 16i, its lanes the terms k = lane + 32j, so
//    each output is at most 8 terms a lane, then a reduce-scatter over the
//    32 lanes; the row walk reads consecutive words and the column walk
//    words an odd stride apart, both conflict free.  Up to RP = 208, Km is
//    zero-padded to the square both walks cover (224 x 225 floats, 203 KB,
//    at R = 196), so the loops carry no guards; beyond, it is RP rows of
//    stride RP | 1 and the walks are guarded.  One barrier a half-step; the
//    exit residual and the score are fixed-order block reductions, so every
//    thread takes the same exit decision.  S and C are read in coalesced
//    rows, 4 rows of loads in flight a warp.
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

#include <cstdio>

namespace {

struct Problem {
  int R;          // real patches on each side
  int RP;         // R, plus the dustbin under partial OT
  int ld;         // row stride of Km in floats, RP | 1 (group and unpadded block layouts)
  float bin;      // dustbin mass, 1 - ot_part
  float ot_temp;  // entropic temperature
};

// One pair of the group layout as a warp sees it.  Kc[s] = sum_m
// A[m * a_m + s * a_s] c[m] reads Km through A, its transpose, so that both
// walks over the global scratch are coalesced.
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

// ---- the per-pair layouts (group == 1) ----

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Reduce-scatter of N partial sums (N a power of two) over the 2^L lanes
// whose lane bits b0 .. b0 + L - 1 differ, from the top bit down: while a
// lane holds more than one sum it keeps one half and adds the partner's
// copy of it; then the rest of the bits add whole sums (butterfly).  A lane
// ends with max(1, N >> L) consecutive slots of group totals, from the slot
// that rs_slot gives.
template <int N, int L>
struct ReduceScatter {
  __device__ __forceinline__ static void run(float* v, int lane, int b0) {
    if constexpr (L > 0) {
      const int mask = 1 << (b0 + L - 1);
      const bool up = (lane & mask) != 0;
      if constexpr (N > 1) {
        constexpr int H = N / 2;
#pragma unroll
        for (int t = 0; t < H; ++t) {
          const float send = up ? v[t] : v[t + H];
          const float keep = up ? v[t + H] : v[t];
          v[t] = keep + __shfl_xor_sync(0xffffffffu, send, mask);
        }
        ReduceScatter<H, L - 1>::run(v, lane, b0);
      } else {
        v[0] += __shfl_xor_sync(0xffffffffu, v[0], mask);
        ReduceScatter<1, L - 1>::run(v, lane, b0);
      }
    }
  }
};

// The first slot a lane holds after ReduceScatter<N, L> from bit b0, and
// whether it is the first of the lanes that hold the same slots.
template <int N, int L>
__device__ __forceinline__ int rs_slot(int lane, int b0, bool* primary) {
  int base = 0, n = N;
  bool first = true;
#pragma unroll
  for (int s = L - 1; s >= 0; --s) {
    const bool up = (lane >> (b0 + s)) & 1;
    if (n > 1) {
      n >>= 1;
      if (up) base += n;
    } else if (up) {
      first = false;
    }
  }
  *primary = first;
  return base;
}

// A thread's partial sums of y_o = sum_k M(o, k) x_k, M(o, k) = Km[o * ro +
// k * rk], for its outputs o = o0 + os i (i < NO) over its inputs
// k = k0 + ks j (j < NK) with x_k = xk[j]; slots NO .. P - 1 are 0.  With
// GUARD, outputs o >= n and inputs with !okk[j] read nothing (without, okk
// is not read).  A chain holds at most 16 terms.
template <int NO, int NK, int P, bool GUARD>
__device__ __forceinline__ void partial_matvec(float (&acc)[P], const float* Km, int ro, int rk,
                                               const float (&xk)[NK], const bool* okk, int o0,
                                               int os, int k0, int ks, int n) {
  constexpr int kChains = NK > 16 ? 2 : 1;
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    const int o = o0 + os * i;
    if (GUARD && o >= n) continue;
    const float* row = Km + o * ro + k0 * rk;
    float a[kChains];
#pragma unroll
    for (int q = 0; q < kChains; ++q) a[q] = 0.0f;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      const float m = (!GUARD || okk[j]) ? row[j * ks * rk] : 0.0f;
      a[j % kChains] = fmaf(m, xk[j], a[j % kChains]);
    }
    acc[i] = kChains == 2 ? a[0] + a[1] : a[0];
  }
}

// Km at (s, m) from its source entry x (ignored on the dustbin).
__device__ __forceinline__ float km_entry(const Problem& pb, int s, int m, float x) {
  const float k = expf(-(1.0f - x) / pb.ot_temp);
  return s < pb.R && m < pb.R ? k : (s == pb.R && m == pb.R ? 0.0f : pb.bin);
}

constexpr int kRowsInFlight = 4;  // rows of S (or C) whose loads a warp keeps in flight
constexpr int kWarpMaxRP = 83;    // the warp layout's largest RP
constexpr int kWarpPairs = 2;     // pairs (warps) a block in the warp layout

// Shared floats of one pair in the warp layout: Km (4 NI rows of stride
// 8 (NJ | 1), zero outside RP x RP), then r (4 NI) and c (8 NJ).
__host__ __device__ constexpr int warp_ld(int NJ) { return 8 * (NJ | 1); }
__host__ __device__ constexpr int warp_pair_floats(int NI, int NJ) {
  return 4 * NI * warp_ld(NJ) + 4 * NI + 8 * NJ;
}

template <typename T, int NI, int NJ>
__global__ void __launch_bounds__(32 * kWarpPairs)
    sinkhorn_pair_warp_kernel(const T* __restrict__ S, const T* __restrict__ C,
                              const float* __restrict__ u, const float* __restrict__ v,
                              float* __restrict__ out, int n_pairs, int iters, float thresh,
                              Problem pb) {
  constexpr int ld = warp_ld(NJ);
  constexpr int kRows = 4 * NI;
  constexpr int kElems = kRows * ld;
  constexpr int PA = pow2_at_least(NI), PB = pow2_at_least(NJ);
  constexpr int NA = PA > 8 ? PA / 8 : 1;  // slots a lane holds after Km c
  constexpr int NB = PB > 4 ? PB / 4 : 1;  // and after Km^T r
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long p = (long)blockIdx.x * kWarpPairs + warp;
  if (p >= n_pairs) return;
  const int R = pb.R, RP = pb.RP;
  const long RR = (long)R * R;
  float* Km = smem + warp * warp_pair_floats(NI, NJ);
  float* r = Km + kElems;
  float* c = r + kRows;
  const T* S_p = S + p * RR;
  const T* K_p = C != nullptr ? C + p * RR : S_p;
  const int la = lane >> 3, lb = lane & 7;

  // Km from S or C, in batches of loads in flight
  constexpr int kBatch = 8;  // loads a lane keeps in flight
  for (int e0 = 0; e0 < kElems; e0 += 32 * kBatch) {
    float x[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + 32 * q + lane;
      const int s = e / ld, m = e % ld;
      x[q] = load_f32(K_p, e < kElems && s < R && m < R ? (long)s * R + m : 0L);
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = e0 + 32 * q + lane;
      const int s = e / ld, m = e % ld;
      if (e < kElems) Km[e] = (s < RP && m < RP) ? km_entry(pb, s, m, x[q]) : 0.0f;
    }
  }
  for (int i = lane; i < kRows; i += 32) r[i] = i < RP ? 1.0f : 0.0f;
  for (int i = lane; i < 8 * NJ; i += 32) c[i] = i < RP ? 1.0f : 0.0f;

  // the slots this lane divides: rows la + 4 slot after Km c, columns
  // lb + 8 slot after Km^T r
  bool first_a, first_b;
  const int sa = rs_slot<PA, 3>(lane, 0, &first_a);
  const int sb = rs_slot<PB, 2>(lane, 3, &first_b);
  bool oka[NA], okb[NB];
  float ua[NA], ra[NA], vb[NB];
#pragma unroll
  for (int t = 0; t < NA; ++t) {
    const int o = la + 4 * (sa + t);
    oka[t] = first_a && sa + t < NI && o < RP;
    ua[t] = oka[t] ? (o < R ? u[p * R + o] : pb.bin) : 1.0f;
    ra[t] = 1.0f;
  }
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const int o = lb + 8 * (sb + t);
    okb[t] = first_b && sb + t < NJ && o < RP;
    vb[t] = okb[t] ? (o < R ? v[p * R + o] : pb.bin) : 1.0f;
  }
  __syncwarp();

  for (int it = 0; it < iters; ++it) {
    float xa[NJ], acc_a[PA];
#pragma unroll
    for (int j = 0; j < NJ; ++j) xa[j] = c[lb + 8 * j];
    partial_matvec<NI, NJ, PA, false>(acc_a, Km, ld, 1, xa, nullptr, la, 4, lb, 8, RP);
    ReduceScatter<PA, 3>::run(acc_a, lane, 0);
    float dr = 0.0f;
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      if (oka[t]) {
        const float rn = ua[t] / acc_a[t];
        dr += fabsf(rn - ra[t]);
        ra[t] = rn;
        r[la + 4 * (sa + t)] = rn;
      }
    }
    __syncwarp();
    float xb[NI], acc_b[PB];
#pragma unroll
    for (int j = 0; j < NI; ++j) xb[j] = r[la + 4 * j];
    partial_matvec<NJ, NI, PB, false>(acc_b, Km, 1, ld, xb, nullptr, lb, 8, la, 4, RP);
    ReduceScatter<PB, 2>::run(acc_b, lane, 3);
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      if (okb[t]) c[lb + 8 * (sb + t)] = vb[t] / acc_b[t];
    }
    __syncwarp();
    if (warp_sum(dr) / (float)RP < thresh) break;
  }

  // sum_sm r_s Km_sm S_sm c_m over the real patches, on the same grid
  float xc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) xc[j] = lb + 8 * j < R ? c[lb + 8 * j] : 0.0f;
  float part = 0.0f;
  for (int i0 = 0; i0 < NI; i0 += kRowsInFlight) {
    float sv[kRowsInFlight][NJ];
#pragma unroll
    for (int g = 0; g < kRowsInFlight; ++g) {
      const int s = la + 4 * (i0 + g);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int m = lb + 8 * j;
        sv[g][j] = load_f32(S_p, i0 + g < NI && s < R && m < R ? (long)s * R + m : 0L);
      }
    }
#pragma unroll
    for (int g = 0; g < kRowsInFlight; ++g) {
      const int s = la + 4 * (i0 + g);
      if (i0 + g >= NI || s >= R) continue;
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) t = fmaf(Km[s * ld + lb + 8 * j] * sv[g][j], xc[j], t);
      part = fmaf(r[s], t, part);
    }
  }
  part = warp_sum(part);
  if (lane == 0) out[p] = part;
}

constexpr int kBlockWarps = 16;       // warps of the block layout, one pair a block
constexpr int kBlockPadMaxRP = 208;  // the largest RP whose padded Km fits a block

// The side of the block layout's zero-padded Km for shape (NI, NK): every
// row and column that either mat-vec walks, so neither needs a guard.
__host__ __device__ constexpr int block_pad(int NI, int NK) {
  return kBlockWarps * NI > 32 * NK ? kBlockWarps * NI : 32 * NK;
}

// Shared floats of the block layout: Km (n rows of stride ld), r and c (n
// each) and one partial sum a warp; n = RP and ld = RP | 1 unpadded, n =
// block_pad and ld = n + 1 padded.
__host__ __device__ constexpr long block_floats(int n, int ld) {
  return (long)n * ld + 2L * n + kBlockWarps;
}

template <typename T, int NI, int NK, bool PAD>
__global__ void __launch_bounds__(32 * kBlockWarps, 1)
    sinkhorn_pair_block_kernel(const T* __restrict__ S, const T* __restrict__ C,
                               const float* __restrict__ u, const float* __restrict__ v,
                               float* __restrict__ out, int iters, float thresh, Problem pb) {
  constexpr int P = pow2_at_least(NI);
  constexpr int Np = block_pad(NI, NK);
  // the rows a warp fills and the columns a lane fills: the whole padded
  // square, or the RP x RP of the unpadded layout
  constexpr int NIF = PAD ? Np / kBlockWarps : NI;
  constexpr int NKF = PAD ? Np / 32 : NK;
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int w = tid >> 5;
  const int R = pb.R, RP = pb.RP;
  const int ld = PAD ? Np + 1 : pb.ld;
  const int n = PAD ? Np : RP;
  const long p = blockIdx.x;
  const long RR = (long)R * R;
  float* Km = smem;
  float* r = Km + n * ld;
  float* c = r + n;
  float* red = c + n;
  const T* S_p = S + p * RR;
  const T* K_p = C != nullptr ? C + p * RR : S_p;

  bool okk[NK];  // this lane's terms k = lane + 32 j inside Km
#pragma unroll
  for (int j = 0; j < NK; ++j) okk[j] = PAD || lane + 32 * j < RP;
  // Km: warp w fills rows w + 16 i, lanes columns lane + 32 j (coalesced),
  // kRowsInFlight rows of loads at a time; zero outside RP x RP
  for (int i0 = 0; i0 < NIF; i0 += kRowsInFlight) {
    float x[kRowsInFlight][NKF];
#pragma unroll
    for (int g = 0; g < kRowsInFlight; ++g) {
      const int s = w + kBlockWarps * (i0 + g);
#pragma unroll
      for (int j = 0; j < NKF; ++j) {
        const int m = lane + 32 * j;
        x[g][j] = load_f32(K_p, i0 + g < NIF && s < R && m < R ? (long)s * R + m : 0L);
      }
    }
#pragma unroll
    for (int g = 0; g < kRowsInFlight; ++g) {
      const int s = w + kBlockWarps * (i0 + g);
      if (i0 + g >= NIF || (!PAD && s >= RP)) continue;
#pragma unroll
      for (int j = 0; j < NKF; ++j) {
        const int m = lane + 32 * j;
        if (PAD || m < RP) {
          Km[s * ld + m] = s < RP && m < RP ? km_entry(pb, s, m, x[g][j]) : 0.0f;
        }
      }
    }
  }
  for (int i = tid; i < n; i += 32 * kBlockWarps) {
    r[i] = i < RP ? 1.0f : 0.0f;
    c[i] = i < RP ? 1.0f : 0.0f;
  }
  // the output this lane divides after each reduce: row (then column)
  // w + 16 slot
  bool first;
  const int slot = rs_slot<P, 5>(lane, 0, &first);
  const int o = w + kBlockWarps * slot;
  const bool ok = first && slot < NI && o < RP;
  const float uo = ok ? (o < R ? u[p * R + o] : pb.bin) : 1.0f;
  const float vo = ok ? (o < R ? v[p * R + o] : pb.bin) : 1.0f;
  float ro = 1.0f;
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    float xk[NK], acc[P];
#pragma unroll
    for (int j = 0; j < NK; ++j) xk[j] = okk[j] ? c[lane + 32 * j] : 0.0f;
    partial_matvec<NI, NK, P, !PAD>(acc, Km, ld, 1, xk, okk, w, kBlockWarps, lane, 32, RP);
    ReduceScatter<P, 5>::run(acc, lane, 0);
    float dr = 0.0f;
    if (ok) {
      const float rn = uo / acc[0];
      dr = fabsf(rn - ro);
      ro = rn;
      r[o] = rn;
    }
    dr = warp_sum(dr);
    if (lane == 0) red[w] = dr;
    __syncthreads();  // r and the warps' residuals complete
#pragma unroll
    for (int j = 0; j < NK; ++j) xk[j] = okk[j] ? r[lane + 32 * j] : 0.0f;
    partial_matvec<NI, NK, P, !PAD>(acc, Km, 1, ld, xk, okk, w, kBlockWarps, lane, 32, RP);
    ReduceScatter<P, 5>::run(acc, lane, 0);
    if (ok) c[o] = vo / acc[0];
    float tot = 0.0f;
    for (int q = 0; q < kBlockWarps; ++q) tot += red[q];
    __syncthreads();  // c complete; red is rewritten in the next iteration
    if (tot / (float)RP < thresh) break;
  }

  // sum_sm r_s Km_sm S_sm c_m over the real patches: warp w walks rows
  // w + 16 i of S, its lanes coalesced along the row
  float xc[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) xc[j] = lane + 32 * j < R ? c[lane + 32 * j] : 0.0f;
  float part = 0.0f;
  for (int i0 = 0; i0 < NI; i0 += kRowsInFlight) {
    float sv[kRowsInFlight][NK];
#pragma unroll
    for (int g = 0; g < kRowsInFlight; ++g) {
      const int s = w + kBlockWarps * (i0 + g);
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int m = lane + 32 * j;
        sv[g][j] = load_f32(S_p, i0 + g < NI && s < R && m < R ? (long)s * R + m : 0L);
      }
    }
#pragma unroll
    for (int g = 0; g < kRowsInFlight; ++g) {
      const int s = w + kBlockWarps * (i0 + g);
      if (i0 + g >= NI || s >= R) continue;
      float t = 0.0f;
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const float km = okk[j] ? Km[s * ld + lane + 32 * j] : 0.0f;
        t = fmaf(km * sv[g][j], xc[j], t);
      }
      part = fmaf(r[s], t, part);
    }
  }
  part = warp_sum(part);
  if (lane == 0) red[w] = part;
  __syncthreads();
  if (tid == 0) {
    float sc = 0.0f;
    for (int q = 0; q < kBlockWarps; ++q) sc += red[q];
    out[p] = sc;
  }
}

// ---- the group layout (group > 1) ----

template <typename T>
__global__ void sinkhorn_score_group_kernel(const T* __restrict__ S, const T* __restrict__ C,
                                            const float* __restrict__ u,
                                            const float* __restrict__ v,
                                            float* __restrict__ out,
                                            float* __restrict__ km_global, int group, int iters,
                                            float thresh, Problem pb) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int R = pb.R, RP = pb.RP, ld = pb.ld;
  const long RR = (long)R * R;

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

enum Layout { kNone = -1, kWarp = 0, kBlock = 1, kGroup = 2 };
constexpr int kGroupLayoutWarps = 16;  // threads / 32 of the group layout

// The per-pair layouts' compile-time shapes for RP: the warp layout's rows
// and columns a lane (NI = ceil(RP / 4), NJ = ceil(RP / 8), rounded up to a
// few sizes), the block layout's outputs and terms a lane (NI = ceil(RP /
// 16), NK = ceil(RP / 32)).
struct Shape {
  int a;
  int b;
};
Shape warp_shape(int RP) {
  if (RP <= 16) return {4, 2};
  if (RP <= 32) return {8, 4};
  if (RP <= 56) return {14, 7};
  return {21, 11};
}
Shape block_shape(int RP) {
  if (RP <= 128) return {8, 4};
  if (RP <= 160) return {10, 5};
  if (RP <= 208) return {13, 7};
  return {15, 8};
}
constexpr int kBlockMaxRP = 240;  // what block_shape covers

// The layout for this problem and its dynamic shared memory in bytes, from
// the footprint against the current card's per-block limit.
cudaError_t plan(int R, int partial, int group, int* layout, size_t* smem, int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int RP = R + (partial ? 1 : 0);
  const size_t f = sizeof(float);
  if (group > 1) {
    *layout = kGroup;
    *smem = f * (2 * (size_t)group * RP + kGroupLayoutWarps);
  } else if (RP <= kWarpMaxRP) {
    const Shape sh = warp_shape(RP);
    *layout = kWarp;
    *smem = f * kWarpPairs * (size_t)warp_pair_floats(sh.a, sh.b);
  } else if (RP <= kBlockPadMaxRP) {
    const Shape sh = block_shape(RP);
    const int np = block_pad(sh.a, sh.b);
    *layout = kBlock;
    *smem = f * (size_t)block_floats(np, np + 1);
  } else {
    *layout = RP <= kBlockMaxRP ? kBlock : kNone;
    *smem = f * (size_t)block_floats(RP, RP | 1);
  }
  if (*smem > (size_t)*limit) *layout = kNone;
  return cudaSuccess;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

struct Args {
  const void* S;
  const void* C;
  const float* u;
  const float* v;
  float* out;
  float* km;
  int n_pairs;
  int group;
  int iters;
  float thresh;
};

template <typename T, int NI, int NJ>
cudaError_t launch_warp(const Args& a, const Problem& pb, size_t smem, cudaStream_t stream) {
  auto kernel = sinkhorn_pair_warp_kernel<T, NI, NJ>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(a.n_pairs + kWarpPairs - 1) / kWarpPairs, 32 * kWarpPairs, smem, stream>>>(
      static_cast<const T*>(a.S), static_cast<const T*>(a.C), a.u, a.v, a.out, a.n_pairs,
      a.iters, a.thresh, pb);
  return cudaGetLastError();
}

template <typename T, int NI, int NK, bool PAD>
cudaError_t launch_block(const Args& a, const Problem& pb, size_t smem, cudaStream_t stream) {
  auto kernel = sinkhorn_pair_block_kernel<T, NI, NK, PAD>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.n_pairs, 32 * kBlockWarps, smem, stream>>>(
      static_cast<const T*>(a.S), static_cast<const T*>(a.C), a.u, a.v, a.out, a.iters,
      a.thresh, pb);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, const Problem& pb, int layout, size_t smem,
                   cudaStream_t stream) {
  if (layout == kWarp) {
    switch (warp_shape(pb.RP).a) {
      case 4: return launch_warp<T, 4, 2>(a, pb, smem, stream);
      case 8: return launch_warp<T, 8, 4>(a, pb, smem, stream);
      case 14: return launch_warp<T, 14, 7>(a, pb, smem, stream);
      default: return launch_warp<T, 21, 11>(a, pb, smem, stream);
    }
  }
  if (layout == kBlock) {
    switch (block_shape(pb.RP).a) {
      case 8: return launch_block<T, 8, 4, true>(a, pb, smem, stream);
      case 10: return launch_block<T, 10, 5, true>(a, pb, smem, stream);
      case 13: return launch_block<T, 13, 7, true>(a, pb, smem, stream);
      default: return launch_block<T, 15, 8, false>(a, pb, smem, stream);
    }
  }
  cudaError_t e = allow_smem(sinkhorn_score_group_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  sinkhorn_score_group_kernel<T><<<a.n_pairs / a.group, kGroupLayoutWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.S), static_cast<const T*>(a.C), a.u, a.v, a.out, a.km, a.group,
      a.iters, a.thresh, pb);
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

// The kernel instance sinkhorn_score_launch takes for (R, partial, group)
// and S's dtype, written to buf as "name<args>" (bools as 0 and 1), for
// reports that match it against the compiler's.  Returns a cudaError_t.
extern "C" int sinkhorn_score_instance(int R, int partial, int group, int s_is_bf16, char* buf,
                                       int len) {
  if (R <= 0 || group <= 0 || len <= 0) return cudaErrorInvalidValue;
  const int RP = R + (partial ? 1 : 0);
  const char* t = s_is_bf16 ? "__nv_bfloat16" : "float";
  if (group > 1) {
    snprintf(buf, len, "sinkhorn_score_group_kernel<%s>", t);
  } else if (RP <= kWarpMaxRP) {
    const Shape sh = warp_shape(RP);
    snprintf(buf, len, "sinkhorn_pair_warp_kernel<%s, %d, %d>", t, sh.a, sh.b);
  } else {
    const Shape sh = block_shape(RP);
    snprintf(buf, len, "sinkhorn_pair_block_kernel<%s, %d, %d, %d>", t, sh.a, sh.b,
             RP <= kBlockPadMaxRP ? 1 : 0);
  }
  return cudaSuccess;
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
  const Args a{S, C, u, v, out, km_scratch, n_pairs, group, iters, thresh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_is_bf16) return launch<__nv_bfloat16>(a, pb, layout, smem, st);
  return launch<float>(a, pb, layout, smem, st);
}
