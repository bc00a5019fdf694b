// Rollout attention filter: zero the k smallest entries of every row, on
// Hopper (sm_90a).
//
// Replaces the TPU kernel vit_reranking_tpu/ops/rollout.py::
// _filter_threshold_kernel (:29-69, launched by filter_threshold_pallas :87).
// The output is bit-identical to the plain version, which zeroes x <= hi,
// where hi is what `iters` steps of value bisection leave (lo/hi seeded with
// the row's min/max, mid = 0.5f * (lo + hi), and lo = mid while
// count(x <= mid) < k, else hi = mid).
//
// Each step's decision needs no count: count(x <= mid) < k exactly when
// mid < v_k, the row's k-th smallest value (k or more entries are <= mid if
// and only if v_k <= mid).  So the kernel finds v_k, the min and the max
// exactly, and one thread a row replays the bisection on those scalars with
// the same f32 arithmetic (__fadd_rn, __fmul_rn, no contraction).
//
// v_k is an exact radix select on the order-preserving unsigned image of the
// floats, in three digits of 11, 11 and 10 bits.  A counting pass builds the
// histogram of one digit among the entries whose higher digits match the
// prefix found so far: each block counts its slice of the row in shared
// memory and adds its bins to the row's histogram with integer atomics (exact,
// so the order of the additions does not matter); the first pass also takes
// the min and max.  After each pass a one-block-a-row launch walks the
// histogram to the bucket that holds the k-th entry and keeps the rank left
// inside it; after the third it has v_k and replays the bisection.  A last
// pass reads the row and writes the output.  That is one memset and 7
// launches, and 4 reads and 1 write of the rows, where the bisection counted
// 40 times.
//
// What bounds it: bytes.  A CvT-13 stage-0 batch at 224 px is 32 rows of
// 3136 x 784 f32 (315 MB, beyond the 50 MB L2), so each pass is a trip to
// device memory; the bound counts one read and one write.  Rows are read in
// 16-byte vectors from the first 16-byte boundary of each row, with the few
// entries before it and after the last whole vector read one by one.
//
// -0.0 and +0.0 have distinct images but compare equal as floats: the replay
// compares floats, so either is right, as it is for the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // 16-byte vectors a thread has in flight
// digit P of an image: bits_of(P) bits from bit shift_of(P)
__host__ __device__ constexpr int bits_of(int p) { return p == 2 ? 10 : 11; }
__host__ __device__ constexpr int shift_of(int p) { return p == 0 ? 21 : (p == 1 ? 10 : 0); }

// Per-row scratch, in 32-bit words, zeroed before each call: the three
// histograms, then the row's state.
__host__ __device__ constexpr int hist_offset(int p) {
  return p == 0 ? 0 : (p == 1 ? 1 << bits_of(0) : (1 << bits_of(0)) + (1 << bits_of(1)));
}
constexpr int kStateOffset = hist_offset(2) + (1 << bits_of(2));
constexpr int kWordsPerRow = kStateOffset + 8;
struct RowState {
  unsigned nmin;    // ~(the min's image): a zeroed word is the identity of atomicMax
  unsigned max;     // the max's image
  unsigned prefix;  // the digits of v_k's image found so far
  unsigned rank;    // v_k's rank (1-based) among the entries that share the prefix
  float hi;         // the threshold the bisection leaves
};

__device__ __forceinline__ unsigned key_of(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float float_of(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

__device__ __forceinline__ RowState* state_of(unsigned* scratch, int b) {
  return reinterpret_cast<RowState*>(scratch + (long long)b * kWordsPerRow + kStateOffset);
}

// The entries of row b as: `head` leading entries one by one, `nvec` aligned
// 16-byte vectors, then the tail one by one.
struct RowSplit {
  const float* row;
  long long head;
  long long nvec;
  long long tail_start;
};

__device__ __forceinline__ RowSplit split_row(const float* x, long long N, int b) {
  RowSplit r;
  r.row = x + (long long)b * N;
  const long long mis = (long long)((reinterpret_cast<uintptr_t>(r.row) >> 2) & 3);
  r.head = mis ? 4 - mis : 0;
  if (r.head > N) r.head = N;
  r.nvec = (N - r.head) >> 2;
  r.tail_start = r.head + 4 * r.nvec;
  return r;
}

// Pass P (0, 1, 2): histogram of digit P of the entries whose higher digits
// equal the prefix; pass 0 also takes the min and max.
template <int P>
__global__ void __launch_bounds__(kThreads) count_digit_kernel(const float* __restrict__ x,
                                                               long long N,
                                                               unsigned* __restrict__ scratch) {
  constexpr int kBins = 1 << bits_of(P);
  __shared__ unsigned bins[kBins];
  __shared__ unsigned wmin[kThreads / 32], wmax[kThreads / 32];
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i < kBins; i += kThreads) bins[i] = 0u;
  RowState* st = state_of(scratch, b);
  const unsigned prefix = P == 0 ? 0u : st->prefix;
  __syncthreads();

  unsigned kmin = 0xffffffffu, kmax = 0u;
  auto count = [&](float f) {
    const unsigned k = key_of(f);
    if constexpr (P == 0) {
      kmin = min(kmin, k);
      kmax = max(kmax, k);
      atomicAdd(&bins[k >> shift_of(0)], 1u);
    } else if ((k >> (shift_of(P) + bits_of(P))) == prefix) {
      atomicAdd(&bins[(k >> shift_of(P)) & (kBins - 1)], 1u);
    }
  };

  const RowSplit r = split_row(x, N, b);
  if (blockIdx.x == 0) {
    if (tid < r.head) count(r.row[tid]);
    if (tid < N - r.tail_start) count(r.row[r.tail_start + tid]);
  }
  const float4* vec = reinterpret_cast<const float4*>(r.row + r.head);
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long v0 = (long long)blockIdx.x * kThreads * kUnroll + tid; v0 < r.nvec; v0 += step) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      q[u] = v < r.nvec ? __ldg(vec + v) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (v0 + (long long)u * kThreads < r.nvec) {
        count(q[u].x);
        count(q[u].y);
        count(q[u].z);
        count(q[u].w);
      }
    }
  }
  __syncthreads();

  unsigned* hist = scratch + (long long)b * kWordsPerRow + hist_offset(P);
  for (int d = tid; d < kBins; d += kThreads) {
    const unsigned n = bins[d];
    if (n) atomicAdd(hist + d, n);
  }
  if constexpr (P == 0) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
    }
    if (lane == 0) {
      wmin[tid >> 5] = kmin;
      wmax[tid >> 5] = kmax;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kThreads / 32; ++w) {
        kmin = min(kmin, wmin[w]);
        kmax = max(kmax, wmax[w]);
      }
      atomicMax(&st->nmin, ~kmin);
      atomicMax(&st->max, kmax);
    }
  }
}

// One block a row: the bucket of digit P that holds the entry of rank
// `rank` among those sharing the prefix, and the rank left inside it.
// After the last digit the prefix is v_k's image, and thread 0 replays the
// bisection.
template <int P>
__global__ void __launch_bounds__(kThreads) select_digit_kernel(unsigned* __restrict__ scratch,
                                                                long long N, int k, int iters) {
  constexpr int kBins = 1 << bits_of(P);
  constexpr int kPer = kBins / kThreads;
  __shared__ unsigned wsum[kThreads / 32];
  __shared__ unsigned found[2];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  if (tid == 0) found[0] = found[1] = 0u;
  const int lane = tid & 31, warp = tid >> 5;
  RowState* st = state_of(scratch, b);
  const unsigned* hist = scratch + (long long)b * kWordsPerRow + hist_offset(P);
  // the selection runs for a k inside [1, N]; the replay handles the rest
  const long long kc = k < 1 ? 1 : (k > N ? N : k);
  const unsigned rank = P == 0 ? (unsigned)kc : st->rank;

  unsigned mine[kPer];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    mine[i] = hist[tid * kPer + i];
    sum += mine[i];
  }
  // exclusive prefix sum of the threads' sums, in bin order
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  unsigned before = incl - sum;
  for (int w = 0; w < warp; ++w) before += wsum[w];
  if (before < rank && rank <= before + sum) {
    unsigned acc = before;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (acc < rank && rank <= acc + mine[i]) {
        found[0] = (unsigned)(tid * kPer + i);
        found[1] = rank - acc;
      }
      acc += mine[i];
    }
  }
  __syncthreads();
  if (tid != 0) return;
  const unsigned prefix = ((P == 0 ? 0u : st->prefix) << bits_of(P)) | found[0];
  st->prefix = prefix;
  st->rank = found[1];
  if constexpr (P < 2) return;

  const float vk = float_of(prefix);
  float lo = float_of(~st->nmin);
  float hi = float_of(st->max);
  for (int i = 0; i < iters; ++i) {
    const float mid = __fmul_rn(0.5f, __fadd_rn(lo, hi));
    // count(x <= mid) < k, without the count
    const bool below = k > N ? true : (k < 1 ? false : mid < vk);
    if (below) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  st->hi = hi;
}

template <bool kVector>
__global__ void __launch_bounds__(kThreads) apply_kernel(const float* __restrict__ x,
                                                         float* __restrict__ y, long long N,
                                                         const unsigned* __restrict__ scratch) {
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const float hi =
      reinterpret_cast<const RowState*>(scratch + (long long)b * kWordsPerRow + kStateOffset)->hi;
  const RowSplit r = split_row(x, N, b);
  float* orow = y + (long long)b * N;
  if (!kVector) {
    const long long step = (long long)gridDim.x * kThreads;
    for (long long i = (long long)blockIdx.x * kThreads + tid; i < N; i += step) {
      const float v = r.row[i];
      orow[i] = v <= hi ? 0.0f : v;
    }
    return;
  }
  if (blockIdx.x == 0) {
    if (tid < r.head) {
      const float v = r.row[tid];
      orow[tid] = v <= hi ? 0.0f : v;
    }
    const long long t = r.tail_start + tid;
    if (t < N) {
      const float v = r.row[t];
      orow[t] = v <= hi ? 0.0f : v;
    }
  }
  const float4* vin = reinterpret_cast<const float4*>(r.row + r.head);
  float4* vout = reinterpret_cast<float4*>(orow + r.head);
  const long long step = (long long)gridDim.x * kThreads * kUnroll;
  for (long long v0 = (long long)blockIdx.x * kThreads * kUnroll + tid; v0 < r.nvec; v0 += step) {
    float4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < r.nvec) q[u] = __ldg(vin + v);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < r.nvec) {
        float4 o = q[u];
        o.x = o.x <= hi ? 0.0f : o.x;
        o.y = o.y <= hi ? 0.0f : o.y;
        o.z = o.z <= hi ? 0.0f : o.z;
        o.w = o.w <= hi ? 0.0f : o.w;
        vout[v] = o;
      }
    }
  }
}

// Blocks a row for a pass over rows of N entries: enough to fill the card
// once with resident blocks, no more than the row has vectors for.
template <typename K>
cudaError_t blocks_per_row(K kernel, int B, long long N, unsigned* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  if (e != cudaSuccess) return e;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  long long want = (N / 4 + (long long)kThreads * kUnroll - 1) / ((long long)kThreads * kUnroll);
  long long fill = (resident + B - 1) / B;
  long long g = want < fill ? want : fill;
  if (g < 1) g = 1;
  if (g > 65535) g = 65535;
  *out = (unsigned)g;
  return cudaSuccess;
}

}  // namespace

// 32-bit words of scratch each row needs (histograms and state).
extern "C" int filter_threshold_scratch_words() { return kWordsPerRow; }

// x, y: (B, N) f32 row-major; scratch: B * filter_threshold_scratch_words()
// 32-bit words, zeroed here.  Returns a cudaError_t.
extern "C" int filter_threshold_launch(const float* x, float* y, void* scratch, int B,
                                       long long N, int k, int iters, void* stream) {
  if (B <= 0 || N <= 0) return cudaSuccess;
  if (B > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned* s = static_cast<unsigned*>(scratch);
  cudaError_t e = cudaMemsetAsync(s, 0, sizeof(unsigned) * (size_t)B * kWordsPerRow, st);
  if (e != cudaSuccess) return e;
  unsigned gx = 1;
  e = blocks_per_row(count_digit_kernel<0>, B, N, &gx);
  if (e != cudaSuccess) return e;
  const dim3 grid(gx, (unsigned)B);
  count_digit_kernel<0><<<grid, kThreads, 0, st>>>(x, N, s);
  select_digit_kernel<0><<<B, kThreads, 0, st>>>(s, N, k, iters);
  count_digit_kernel<1><<<grid, kThreads, 0, st>>>(x, N, s);
  select_digit_kernel<1><<<B, kThreads, 0, st>>>(s, N, k, iters);
  count_digit_kernel<2><<<grid, kThreads, 0, st>>>(x, N, s);
  select_digit_kernel<2><<<B, kThreads, 0, st>>>(s, N, k, iters);
  // 16-byte vectors where x and y share their alignment
  if (((reinterpret_cast<uintptr_t>(x) ^ reinterpret_cast<uintptr_t>(y)) & 15) == 0) {
    apply_kernel<true><<<grid, kThreads, 0, st>>>(x, y, N, s);
  } else {
    apply_kernel<false><<<grid, kThreads, 0, st>>>(x, y, N, s);
  }
  return cudaGetLastError();
}
