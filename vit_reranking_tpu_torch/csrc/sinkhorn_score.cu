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
//  * group-warp (group > 1, RP <= 83) and group-block (group > 1, RP up to
//    240): the group exit.  The exit needs the summed residual of all the
//    group's pairs after every iteration, and K = 100 pairs of Km fit no
//    SM, so a group's pairs are spread over a team of blocks: one warp a
//    pair as in the warp layout, up to 8 pairs a block (group-warp), or one
//    block a pair as in the block layout (group-block; at RP = 240 Km's
//    stride is RP, so it fits).  Every Km stays in its block's shared
//    memory.  A team's blocks must all be resident at once, so the launch is
//    cooperative: the runtime refuses a grid the card cannot hold at once,
//    and the launcher sizes the grid from the occupancy the card reports
//    (as many teams as its resident blocks make).  After each iteration
//    every block stores its residual, summed in a fixed order, into its
//    slot of a small global array, tagged with the barrier's number (two
//    sets of slots, by iteration parity; release), and warp 0 of every
//    block waits until the team's slots carry that number (acquire) and
//    adds them in one fixed order, so every block takes the same exit
//    decision from the same bits.  Teams walk the groups persistently.  No
//    atomic read-modify-write is used.
// Division is IEEE (no fast math): the exit decisions depend on it.

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdio>

namespace {

struct Problem {
  int R;          // real patches on each side
  int RP;         // R, plus the dustbin under partial OT
  int ld;         // row stride of Km in floats in the unpadded block layouts
  float bin;      // dustbin mass, 1 - ot_part
  float ot_temp;  // entropic temperature
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

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// p ? a : b as a select.  Left to itself the compiler may turn the
// reduce-scatter's lane-dependent choices into branches around its
// shuffles, which then run diverged, through the slow collective path.
__device__ __forceinline__ float select(bool p, float a, float b) {
#ifdef __CUDA_ARCH__
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %3, 0;\n\tselp.f32 %0, %1, %2, q;\n\t}"
      : "=f"(r)
      : "f"(a), "f"(b), "r"((int)p));
  return r;
#else
  return p ? a : b;
#endif
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
          const float send = select(up, v[t], v[t + H]);
          const float keep = select(up, v[t + H], v[t]);
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
constexpr int kWarpMaxRP = 83;    // the warp layouts' largest RP
constexpr int kWarpPairs = 2;     // pairs (warps) a block in the warp layout

// Shared floats of one pair in the warp layouts: Km (4 NI rows of stride
// 8 (NJ | 1), zero outside RP x RP), then r (4 NI) and c (8 NJ).
__host__ __device__ constexpr int warp_ld(int NJ) { return 8 * (NJ | 1); }
__host__ __device__ constexpr int warp_pair_floats(int NI, int NJ) {
  return 4 * NI * warp_ld(NJ) + 4 * NI + 8 * NJ;
}

// One pair held by one warp (the warp and group-warp layouts).
template <typename T, int NI, int NJ>
struct WarpPair {
  static constexpr int ld = warp_ld(NJ);
  static constexpr int kRows = 4 * NI;
  static constexpr int kElems = kRows * ld;
  static constexpr int PA = pow2_at_least(NI), PB = pow2_at_least(NJ);
  static constexpr int NA = PA > 8 ? PA / 8 : 1;  // slots a lane holds after Km c
  static constexpr int NB = PB > 4 ? PB / 4 : 1;  // and after Km^T r
  float* Km;
  float* r;
  float* c;
  int lane, la, lb, sa, sb;
  bool oka[NA], okb[NB];
  float ua[NA], ra[NA], vb[NB];

  // Km from K_p (S, or C in mode (d)) into the pair's shared floats sm,
  // r = c = 1, and the marginals of the slots this lane divides: rows
  // la + 4 slot after Km c, columns lb + 8 slot after Km^T r.  The caller
  // synchronises the warp before the first step.
  __device__ void load(float* sm, const T* K_p, const float* u_p, const float* v_p,
                       const Problem& pb, int lane_) {
    lane = lane_;
    la = lane >> 3;
    lb = lane & 7;
    Km = sm;
    r = Km + kElems;
    c = r + kRows;
    const int R = pb.R, RP = pb.RP;
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
    bool first_a, first_b;
    sa = rs_slot<PA, 3>(lane, 0, &first_a);
    sb = rs_slot<PB, 2>(lane, 3, &first_b);
#pragma unroll
    for (int t = 0; t < NA; ++t) {
      const int o = la + 4 * (sa + t);
      oka[t] = first_a && sa + t < NI && o < RP;
      ua[t] = oka[t] ? (o < R ? u_p[o] : pb.bin) : 1.0f;
      ra[t] = 1.0f;
    }
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      const int o = lb + 8 * (sb + t);
      okb[t] = first_b && sb + t < NJ && o < RP;
      vb[t] = okb[t] ? (o < R ? v_p[o] : pb.bin) : 1.0f;
    }
  }

  // One scaling iteration; returns sum_s |r_new - r| in every lane.
  __device__ float step(const Problem& pb) {
    float xa[NJ], acc_a[PA];
#pragma unroll
    for (int j = 0; j < NJ; ++j) xa[j] = c[lb + 8 * j];
    partial_matvec<NI, NJ, PA, false>(acc_a, Km, ld, 1, xa, nullptr, la, 4, lb, 8, pb.RP);
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
    partial_matvec<NJ, NI, PB, false>(acc_b, Km, 1, ld, xb, nullptr, lb, 8, la, 4, pb.RP);
    ReduceScatter<PB, 2>::run(acc_b, lane, 3);
#pragma unroll
    for (int t = 0; t < NB; ++t) {
      if (okb[t]) c[lb + 8 * (sb + t)] = vb[t] / acc_b[t];
    }
    __syncwarp();
    return warp_sum(dr);
  }

  // sum_sm r_s Km_sm S_sm c_m over the real patches, on the same grid, in
  // every lane.
  __device__ float score(const T* S_p, const Problem& pb) const {
    const int R = pb.R;
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
    return warp_sum(part);
  }
};

template <typename T, int NI, int NJ>
__global__ void __launch_bounds__(32 * kWarpPairs)
    sinkhorn_pair_warp_kernel(const T* __restrict__ S, const T* __restrict__ C,
                              const float* __restrict__ u, const float* __restrict__ v,
                              float* __restrict__ out, int* __restrict__ iters_out, int n_pairs,
                              int iters, float thresh, Problem pb) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long p = (long)blockIdx.x * kWarpPairs + warp;
  if (p >= n_pairs) return;
  const long RR = (long)pb.R * pb.R;
  const T* S_p = S + p * RR;
  WarpPair<T, NI, NJ> pair;
  pair.load(smem + warp * warp_pair_floats(NI, NJ), C != nullptr ? C + p * RR : S_p,
            u + p * pb.R, v + p * pb.R, pb, lane);
  __syncwarp();
  int ran = 0;
  while (ran < iters) {
    const float dr = pair.step(pb);
    ++ran;
    if (dr / (float)pb.RP < thresh) break;
  }
  const float sc = pair.score(S_p, pb);
  if (lane == 0) {
    out[p] = sc;
    if (iters_out != nullptr) iters_out[p] = ran;
  }
}

constexpr int kBlockWarps = 16;       // warps of the block layouts, one pair a block
constexpr int kBlockPadMaxRP = 208;  // the largest RP whose padded Km fits a block

// The side of the block layout's zero-padded Km for shape (NI, NK): every
// row and column that either mat-vec walks, so neither needs a guard.
__host__ __device__ constexpr int block_pad(int NI, int NK) {
  return kBlockWarps * NI > 32 * NK ? kBlockWarps * NI : 32 * NK;
}

// Shared floats of the block layout: Km (n rows of stride ld), r and c (n
// each) and one partial sum a warp; n = RP and ld = Problem::ld unpadded,
// n = block_pad and ld = n + 1 padded.
__host__ __device__ constexpr long block_floats(int n, int ld) {
  return (long)n * ld + 2L * n + kBlockWarps;
}

// One pair held by one block of kBlockWarps warps (the block and
// group-block layouts).
template <typename T, int NI, int NK, bool PAD>
struct BlockPair {
  static constexpr int P = pow2_at_least(NI);
  static constexpr int Np = block_pad(NI, NK);
  // the rows a warp fills and the columns a lane fills: the whole padded
  // square, or the RP x RP of the unpadded layout
  static constexpr int NIF = PAD ? Np / kBlockWarps : NI;
  static constexpr int NKF = PAD ? Np / 32 : NK;
  float* Km;
  float* r;
  float* c;
  float* red;  // one partial sum a warp
  int tid, lane, w, o;
  bool ok;
  bool okk[NK];  // this lane's terms k = lane + 32 j inside Km
  float uo, vo, ro;

  // Km's row stride: a constant when padded, so that both walks address
  // shared memory with immediate offsets
  __device__ static int stride(const Problem& pb) { return PAD ? Np + 1 : pb.ld; }

  // Km from K_p (S, or C in mode (d)) into sm (block_floats), r = c = 1,
  // and the marginals of the output this lane divides after each reduce:
  // row (then column) w + 16 slot.  Ends with a barrier.
  __device__ void load(float* sm, const T* K_p, const float* u_p, const float* v_p,
                       const Problem& pb) {
    tid = threadIdx.x;
    lane = tid & 31;
    w = tid >> 5;
    const int R = pb.R, RP = pb.RP;
    const int ld = stride(pb);
    const int n = PAD ? Np : RP;
    Km = sm;
    r = Km + n * ld;
    c = r + n;
    red = c + n;
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
    bool first;
    const int slot = rs_slot<P, 5>(lane, 0, &first);
    o = w + kBlockWarps * slot;
    ok = first && slot < NI && o < RP;
    uo = ok ? (o < R ? u_p[o] : pb.bin) : 1.0f;
    vo = ok ? (o < R ? v_p[o] : pb.bin) : 1.0f;
    ro = 1.0f;
    __syncthreads();
  }

  // One scaling iteration; returns the pair's sum_s |r_new - r|, summed in
  // a fixed order, in every thread.
  __device__ float step(const Problem& pb) {
    const int ld = stride(pb);
    float xk[NK], acc[P];
#pragma unroll
    for (int j = 0; j < NK; ++j) xk[j] = okk[j] ? c[lane + 32 * j] : 0.0f;
    partial_matvec<NI, NK, P, !PAD>(acc, Km, ld, 1, xk, okk, w, kBlockWarps, lane, 32, pb.RP);
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
    partial_matvec<NI, NK, P, !PAD>(acc, Km, 1, ld, xk, okk, w, kBlockWarps, lane, 32, pb.RP);
    ReduceScatter<P, 5>::run(acc, lane, 0);
    if (ok) c[o] = vo / acc[0];
    float tot = 0.0f;
    for (int q = 0; q < kBlockWarps; ++q) tot += red[q];
    __syncthreads();  // c complete; red is rewritten in the next iteration
    return tot;
  }

  // sum_sm r_s Km_sm S_sm c_m over the real patches, in thread 0: warp w
  // walks rows w + 16 i of S, its lanes coalesced along the row.
  __device__ float score(const T* S_p, const Problem& pb) {
    const int R = pb.R, ld = stride(pb);
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
    float sc = 0.0f;
    if (tid == 0) {
      for (int q = 0; q < kBlockWarps; ++q) sc += red[q];
    }
    return sc;
  }
};

template <typename T, int NI, int NK, bool PAD>
__global__ void __launch_bounds__(32 * kBlockWarps, 1)
    sinkhorn_pair_block_kernel(const T* __restrict__ S, const T* __restrict__ C,
                               const float* __restrict__ u, const float* __restrict__ v,
                               float* __restrict__ out, int* __restrict__ iters_out, int iters,
                               float thresh, Problem pb) {
  extern __shared__ float smem[];
  const long p = blockIdx.x;
  const long RR = (long)pb.R * pb.R;
  const T* S_p = S + p * RR;
  BlockPair<T, NI, NK, PAD> pair;
  pair.load(smem, C != nullptr ? C + p * RR : S_p, u + p * pb.R, v + p * pb.R, pb);
  int ran = 0;
  while (ran < iters) {
    const float tot = pair.step(pb);
    ++ran;
    if (tot / (float)pb.RP < thresh) break;
  }
  const float sc = pair.score(S_p, pb);
  if (threadIdx.x == 0) {
    out[p] = sc;
    if (iters_out != nullptr) iters_out[p] = ran;
  }
}

// ---- the group layouts (group > 1) ----

constexpr int kGroupWarpMaxPairs = 8;  // pairs (warps) a block in the group-warp layout
// polls of a team's slot before a block gives up (about 10 s): a team
// that is not resident at once traps instead of hanging the card
constexpr long kSpinLimit = 1L << 24;

// How the groups are dealt to the teams: team t (blocks t * team_size ..
// t * team_size + team_size - 1) takes groups t, t + n_teams, ...
struct GroupGrid {
  int n_groups;
  int group;      // pairs a group
  int team_size;  // blocks a team
  int n_teams;
};

// The blocks that hold one group's pairs, all resident at once.  `work`
// holds each team's 2 x team_size slots (zero at launch), two sets used by
// iteration parity: a block's value in the low word of its slot, the
// number of the barrier it was published for in the high word.
struct Team {
  unsigned long long* slots;
  int id;
  int rank;
  int size;
  unsigned epoch;  // barriers this block has passed

  __device__ Team(unsigned long long* work, const GroupGrid& gg)
      : size(gg.team_size), epoch(0) {
    id = blockIdx.x / size;
    rank = blockIdx.x - id * size;
    slots = work + 2L * id * size;
  }

  // The team's sum of its blocks' values, in every thread of every block
  // of the team; thread 0's `mine` is this block's value and `bcast` one
  // shared float.  A barrier of the team: thread 0 publishes `mine` with
  // this barrier's number (release); lane q of warp 0 waits until the slots
  // of ranks q + 32 i carry that number (acquire) and adds their values in
  // rank order, then a fixed butterfly adds the lanes, so every block gets
  // the same bits.  A block publishes the next barrier's value in the other
  // set of slots, and the one after only when every block has published
  // the next one, so after it has read this one.
  __device__ float total(float mine, float* bcast) {
    if (threadIdx.x < 32) {
      unsigned long long* set = slots + (epoch & 1u) * size;
      const unsigned tag = epoch + 1u;
      if (threadIdx.x == 0) {
        cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> slot(set[rank]);
        slot.store(((unsigned long long)tag << 32) | __float_as_uint(mine),
                   cuda::std::memory_order_release);
      }
      float part = 0.0f;
      for (int q = threadIdx.x; q < size; q += 32) {
        cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> slot(set[q]);
        unsigned long long x = slot.load(cuda::std::memory_order_acquire);
        for (long n = 0; (unsigned)(x >> 32) != tag; ++n) {
          if (n > kSpinLimit) __trap();
          __nanosleep(32);
          x = slot.load(cuda::std::memory_order_acquire);
        }
        part += __uint_as_float((unsigned)x);
      }
      part = warp_sum(part);
      if (threadIdx.x == 0) *bcast = part;
    }
    ++epoch;
    __syncthreads();
    return *bcast;
  }
};

template <typename T, int NI, int NJ>
__global__ void __launch_bounds__(32 * kGroupWarpMaxPairs, 2)
    sinkhorn_group_warp_kernel(const T* S, const T* C, const float* u, const float* v,
                               float* out, int* iters_out, unsigned long long* work, GroupGrid gg,
                               int iters, float thresh, Problem pb) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ppb = blockDim.x >> 5;
  float* red = smem + ppb * warp_pair_floats(NI, NJ);  // a residual a warp, then the team's sum
  Team team(work, gg);
  const long RR = (long)pb.R * pb.R;
  const float denom = (float)(gg.group * pb.RP);
  const int lp = team.rank * ppb + warp;  // this warp's pair in every group
  const bool has = lp < gg.group;
  for (long g = team.id; g < gg.n_groups; g += gg.n_teams) {
    const long p = g * gg.group + lp;
    WarpPair<T, NI, NJ> pair;
    if (has) {
      pair.load(smem + warp * warp_pair_floats(NI, NJ), (C != nullptr ? C : S) + p * RR,
                u + p * pb.R, v + p * pb.R, pb, lane);
    }
    __syncwarp();
    int ran = 0;
    while (ran < iters) {
      const float dr = has ? pair.step(pb) : 0.0f;
      ++ran;
      if (lane == 0) red[warp] = dr;
      __syncthreads();
      float mine = 0.0f;
      if (threadIdx.x == 0) {
        for (int q = 0; q < ppb; ++q) mine += red[q];
      }
      if (team.total(mine, red + ppb) / denom < thresh) break;
    }
    if (has) {
      const float sc = pair.score(S + p * RR, pb);
      if (lane == 0) out[p] = sc;
    }
    if (iters_out != nullptr && team.rank == 0 && threadIdx.x == 0) iters_out[g] = ran;
    __syncthreads();  // the next group's Km overwrites this one's
  }
}

template <typename T, int NI, int NK, bool PAD>
__global__ void __launch_bounds__(32 * kBlockWarps, 1)
    sinkhorn_group_block_kernel(const T* S, const T* C, const float* u, const float* v,
                                float* out, int* iters_out, unsigned long long* work, GroupGrid gg,
                                int iters, float thresh, Problem pb) {
  extern __shared__ float smem[];
  Team team(work, gg);  // one pair a block: team.rank is the pair in its group
  const long RR = (long)pb.R * pb.R;
  const float denom = (float)(gg.group * pb.RP);
  const int n = PAD ? block_pad(NI, NK) : pb.RP;
  float* bcast = smem + block_floats(n, PAD ? n + 1 : pb.ld);
  for (long g = team.id; g < gg.n_groups; g += gg.n_teams) {
    const long p = g * gg.group + team.rank;
    BlockPair<T, NI, NK, PAD> pair;
    pair.load(smem, (C != nullptr ? C : S) + p * RR, u + p * pb.R, v + p * pb.R, pb);
    int ran = 0;
    while (ran < iters) {
      const float tot = pair.step(pb);
      ++ran;
      if (team.total(tot, bcast) / denom < thresh) break;
    }
    const float sc = pair.score(S + p * RR, pb);
    if (threadIdx.x == 0) {
      out[p] = sc;
      if (iters_out != nullptr && team.rank == 0) iters_out[g] = ran;
    }
    __syncthreads();  // the next group's Km overwrites this one's
  }
}

enum Layout { kNone = -1, kWarp = 0, kBlock = 1, kGroupWarp = 2, kGroupBlock = 3 };

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

template <typename T>
using GroupKernel = void (*)(const T*, const T*, const float*, const float*, float*, int*,
                             unsigned long long*, GroupGrid, int, float, Problem);

template <typename T>
GroupKernel<T> group_kernel(int RP) {
  if (RP <= kWarpMaxRP) {
    switch (warp_shape(RP).a) {
      case 4: return sinkhorn_group_warp_kernel<T, 4, 2>;
      case 8: return sinkhorn_group_warp_kernel<T, 8, 4>;
      case 14: return sinkhorn_group_warp_kernel<T, 14, 7>;
      default: return sinkhorn_group_warp_kernel<T, 21, 11>;
    }
  }
  if (RP > kBlockPadMaxRP) return sinkhorn_group_block_kernel<T, 15, 8, false>;
  switch (block_shape(RP).a) {
    case 8: return sinkhorn_group_block_kernel<T, 8, 4, true>;
    case 10: return sinkhorn_group_block_kernel<T, 10, 5, true>;
    default: return sinkhorn_group_block_kernel<T, 13, 7, true>;
  }
}

// A group layout's launch on the current card: pairs a block, threads and
// shared bytes a block, Km's row stride (group-block unpadded), blocks a
// team and teams; max_group is the largest group the layout can hold at
// once (0: not even one pair a block fits).
struct GroupFit {
  int ppb;
  int threads;
  size_t smem;
  int ld;
  int team_size;
  int n_teams;
  long max_group;
};

// The group layout for RP, `group` pairs a group and n_groups groups: as
// many pairs a block (at most kGroupWarpMaxPairs, one in group-block) as
// fit its shared memory, and as many teams as the blocks the card holds at
// once (the occupancy it reports for this kernel) make, at most one a
// group.  fit->ppb = 0 when no team of `group` pairs can be resident.
template <typename T>
cudaError_t group_fit(int RP, int group, long n_groups, int limit, GroupFit* fit) {
  *fit = GroupFit{0, 0, 0, 0, 0, 0, 0};
  if (RP > kBlockMaxRP) return cudaSuccess;
  const size_t f = sizeof(float);
  const bool warp = RP <= kWarpMaxRP;
  int ppb = 1, ld = RP | 1;
  size_t smem;
  if (warp) {  // each pair's floats and its residual, then the team's sum
    const Shape sh = warp_shape(RP);
    const long per_pair = warp_pair_floats(sh.a, sh.b) + 1;
    ppb = (int)((limit / (long)f - 1) / per_pair);
    if (ppb > kGroupWarpMaxPairs) ppb = kGroupWarpMaxPairs;
    smem = f * ((size_t)ppb * per_pair + 1);
  } else if (RP <= kBlockPadMaxRP) {
    const Shape sh = block_shape(RP);
    const int np = block_pad(sh.a, sh.b);
    smem = f * (size_t)(block_floats(np, np + 1) + 1);
  } else {
    if (f * (size_t)(block_floats(RP, ld) + 1) > (size_t)limit) {
      ld = RP;  // an even stride costs bank conflicts, but RP = 240 fits
    }
    smem = f * (size_t)(block_floats(RP, ld) + 1);
  }
  if (ppb < 1 || smem > (size_t)limit) return cudaSuccess;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const GroupKernel<T> kernel = group_kernel<T>(RP);
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const int threads = warp ? 32 * ppb : 32 * kBlockWarps;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e != cudaSuccess) return e;
  const long resident = (long)per_sm * sms;
  fit->max_group = (long)ppb * resident;
  const int team = (group + ppb - 1) / ppb;
  const long teams = resident / team;
  if (teams == 0) return cudaSuccess;
  *fit = GroupFit{ppb, threads, smem, ld, team, (int)(teams < n_groups ? teams : n_groups),
                  fit->max_group};
  return cudaSuccess;
}

// The layout for this problem, its dynamic shared memory in bytes, the
// card's per-block limit and, for group > 1, the largest group the layout
// holds at once.
struct Plan {
  int layout;
  size_t smem;
  int limit;
  long max_group;
};

cudaError_t plan(int R, int partial, int group, Plan* pl) {
  *pl = Plan{kNone, 0, 0, 0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&pl->limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const int RP = R + (partial ? 1 : 0);
  const size_t f = sizeof(float);
  if (group > 1) {
    GroupFit fit;
    e = group_fit<float>(RP, group, 1, pl->limit, &fit);
    if (e != cudaSuccess) return e;
    pl->max_group = fit.max_group;
    if (fit.ppb > 0) {
      pl->layout = RP <= kWarpMaxRP ? kGroupWarp : kGroupBlock;
      pl->smem = fit.smem;
    } else {  // what one pair a block needs, in the tightest block layout
      pl->smem = f * (size_t)(block_floats(RP, RP) + 1);
    }
    return cudaSuccess;
  }
  if (RP <= kWarpMaxRP) {
    const Shape sh = warp_shape(RP);
    pl->layout = kWarp;
    pl->smem = f * kWarpPairs * (size_t)warp_pair_floats(sh.a, sh.b);
  } else if (RP <= kBlockPadMaxRP) {
    const Shape sh = block_shape(RP);
    const int np = block_pad(sh.a, sh.b);
    pl->layout = kBlock;
    pl->smem = f * (size_t)block_floats(np, np + 1);
  } else {
    pl->layout = RP <= kBlockMaxRP ? kBlock : kNone;
    pl->smem = f * (size_t)block_floats(RP, RP | 1);
  }
  if (pl->smem > (size_t)pl->limit) pl->layout = kNone;
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
  int* iters_out;
  unsigned long long* work;
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
      static_cast<const T*>(a.S), static_cast<const T*>(a.C), a.u, a.v, a.out, a.iters_out,
      a.n_pairs, a.iters, a.thresh, pb);
  return cudaGetLastError();
}

template <typename T, int NI, int NK, bool PAD>
cudaError_t launch_block(const Args& a, const Problem& pb, size_t smem, cudaStream_t stream) {
  auto kernel = sinkhorn_pair_block_kernel<T, NI, NK, PAD>;
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<a.n_pairs, 32 * kBlockWarps, smem, stream>>>(
      static_cast<const T*>(a.S), static_cast<const T*>(a.C), a.u, a.v, a.out, a.iters_out,
      a.iters, a.thresh, pb);
  return cudaGetLastError();
}

// The group layouts: one cooperative launch, so that every team's blocks
// are resident at once (the runtime refuses the grid otherwise).
template <typename T>
cudaError_t launch_group(const Args& a, Problem pb, int limit, cudaStream_t stream) {
  const long n_groups = a.n_pairs / a.group;
  GroupFit fit;
  cudaError_t e = group_fit<T>(pb.RP, a.group, n_groups, limit, &fit);
  if (e != cudaSuccess) return e;
  if (fit.ppb == 0) return cudaErrorInvalidValue;
  pb.ld = fit.ld;
  const GroupGrid gg{(int)n_groups, a.group, fit.team_size, fit.n_teams};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(fit.n_teams * fit.team_size);
  cfg.blockDim = dim3(fit.threads);
  cfg.dynamicSmemBytes = fit.smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, group_kernel<T>(pb.RP), static_cast<const T*>(a.S),
                         static_cast<const T*>(a.C), a.u, a.v, a.out, a.iters_out, a.work, gg,
                         a.iters, a.thresh, pb);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, const Problem& pb, const Plan& pl, cudaStream_t stream) {
  if (pl.layout == kWarp) {
    switch (warp_shape(pb.RP).a) {
      case 4: return launch_warp<T, 4, 2>(a, pb, pl.smem, stream);
      case 8: return launch_warp<T, 8, 4>(a, pb, pl.smem, stream);
      case 14: return launch_warp<T, 14, 7>(a, pb, pl.smem, stream);
      default: return launch_warp<T, 21, 11>(a, pb, pl.smem, stream);
    }
  }
  if (pl.layout == kBlock) {
    switch (block_shape(pb.RP).a) {
      case 8: return launch_block<T, 8, 4, true>(a, pb, pl.smem, stream);
      case 10: return launch_block<T, 10, 5, true>(a, pb, pl.smem, stream);
      case 13: return launch_block<T, 13, 7, true>(a, pb, pl.smem, stream);
      default: return launch_block<T, 15, 8, false>(a, pb, pl.smem, stream);
    }
  }
  return launch_group<T>(a, pb, pl.limit, stream);
}

}  // namespace

// The layout sinkhorn_score_launch takes for (R, partial, group) on the
// current card: 0 warp, 1 block, 2 group-warp, 3 group-block, -1 none fits;
// its shared memory in bytes, the card's per-block limit and, for group >
// 1, the largest group the layout holds at once.  Returns a cudaError_t.
extern "C" int sinkhorn_score_plan(int R, int partial, int group, int* layout,
                                   long long* smem_bytes, int* limit_bytes,
                                   long long* max_group) {
  Plan pl;
  cudaError_t e = plan(R, partial, group, &pl);
  *layout = pl.layout;
  *smem_bytes = (long long)pl.smem;
  *limit_bytes = pl.limit;
  *max_group = pl.max_group;
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
  const char* kind = group > 1 ? "group" : "pair";
  if (RP <= kWarpMaxRP) {
    const Shape sh = warp_shape(RP);
    snprintf(buf, len, "sinkhorn_%s_warp_kernel<%s, %d, %d>", kind, t, sh.a, sh.b);
  } else {
    const Shape sh = block_shape(RP);
    snprintf(buf, len, "sinkhorn_%s_block_kernel<%s, %d, %d, %d>", kind, t, sh.a, sh.b,
             RP <= kBlockPadMaxRP ? 1 : 0);
  }
  return cudaSuccess;
}

// S, and C when not null: (n_pairs, R, R) f32 or bf16 (C has S's dtype);
// u, v: (n_pairs, R) f32; out: (n_pairs,) f32.  iters_out, when not null:
// (n_pairs / group,) int32, the scaling iterations each group (each pair
// when group == 1) ran.  work: when group > 1, 2 * n_pairs 64-bit words,
// zero at launch (the teams' residual slots); else unused.  Returns a cudaError_t (cudaErrorInvalidValue when
// no layout fits the card).
extern "C" int sinkhorn_score_launch(const void* S, const void* C, int s_is_bf16, const float* u,
                                     const float* v, float* out, int* iters_out, void* work,
                                     int n_pairs, int R, int partial, float bin_mass,
                                     float ot_temp, int iters, float thresh, int group,
                                     void* stream) {
  if (n_pairs <= 0) return cudaSuccess;
  if (R <= 0 || group <= 0 || n_pairs % group != 0) return cudaErrorInvalidValue;
  if (group > 1 && work == nullptr) return cudaErrorInvalidValue;
  Plan pl;
  cudaError_t e = plan(R, partial, group, &pl);
  if (e != cudaSuccess) return e;
  if (pl.layout == kNone) return cudaErrorInvalidValue;
  Problem pb;
  pb.R = R;
  pb.RP = R + (partial ? 1 : 0);
  pb.ld = pb.RP | 1;
  pb.bin = bin_mass;
  pb.ot_temp = ot_temp;
  const Args a{S, C, u, v, out, iters_out, static_cast<unsigned long long*>(work), n_pairs,
               group, iters, thresh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_is_bf16) return launch<__nv_bfloat16>(a, pb, pl, st);
  return launch<float>(a, pb, pl, st);
}
