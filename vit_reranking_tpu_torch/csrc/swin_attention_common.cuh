// What K4's two window cores (swin_attention.cu in f32,
// swin_attention_bf16.cu in bf16) share: the stride layout of the C
// entries and the fixed-order f32 reductions of the ds partials into dbias
// or dadd.  Each source includes it into its own library.

#pragma once

#include <cuda_runtime.h>

namespace {

// Strides in elements from one image, window, head and token to the next.
struct Layout {
  long long b, w, h, t;
};

// The i-th group of four strides of a C entry's stride array.
Layout layout_at(const long long* strides, int i) {
  return Layout{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2], strides[4 * i + 3]};
}

// dbias[h][e] = sum over runs z and windows w, in that order, of
// part[z][h][w][e] (e indexes the T x T entries).  A block sums 32 entries
// of one head: each of its kSlices thread rows takes every kSlices-th
// (z, w), and the slices' sums are added in a fixed order.
constexpr int kSlices = 16;

__global__ void __launch_bounds__(32 * kSlices)
    reduce_bias_kernel(const float* __restrict__ part, float* __restrict__ dbias, int runs,
                       int H, int nW, int TT) {
  __shared__ float sums[kSlices][33];
  const int e = blockIdx.x * 32 + threadIdx.x, h = blockIdx.y;
  float acc = 0.0f;
  if (e < TT)
    for (int i = threadIdx.y; i < runs * nW; i += kSlices) {
      const int z = i / nW, w = i % nW;
      acc += part[(((long long)z * H + h) * nW + w) * TT + e];
    }
  sums[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && e < TT) {
    float total = 0.0f;
#pragma unroll
    for (int s = 0; s < kSlices; ++s) total += sums[s][threadIdx.x];
    dbias[(long long)h * TT + e] = total;
  }
}

// dadd (H, nblk, PT, PT): on the diagonal (T, T) blocks the sum over runs of
// part[z][h][blk * P + p], zeros everywhere else.
__global__ void __launch_bounds__(256)
    reduce_add_kernel(const float* __restrict__ part, float* __restrict__ dadd, int runs, int H,
                      int nblk, int P, int T) {
  const int PT = P * T;
  const long long total = (long long)H * nblk * PT * PT;
  const long long TT = (long long)T * T;
  const int nW = nblk * P;
  for (long long idx = (long long)blockIdx.x * 256 + threadIdx.x; idx < total;
       idx += (long long)gridDim.x * 256) {
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

// dbias (packed = 0) or dadd (packed = 1) from the partials, in a fixed order.
int reduce_grad_add(const float* part, float* grad_add, int packed, int runs, int H, int nW,
                    int P, int T, cudaStream_t st) {
  if (packed) {
    const long long total = (long long)H * (nW / P) * (P * T) * (P * T);
    const long long blocks = (total + 255) / 256;
    const int grid = (int)(blocks < 8192 ? blocks : 8192);
    reduce_add_kernel<<<grid, 256, 0, st>>>(part, grad_add, runs, H, nW / P, P, T);
  } else {
    const int TT = T * T;
    reduce_bias_kernel<<<dim3((TT + 31) / 32, H), dim3(32, kSlices), 0, st>>>(part, grad_add,
                                                                            runs, H, nW, TT);
  }
  return cudaGetLastError();
}

}  // namespace
