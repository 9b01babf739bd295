// Block-level sums of scalar-field values and the second pass that sums
// per-block partials. Device code only: the reductions of K1 (dot), K3
// (sparse_eval) and K4 (round evaluations) all end here. Field addition is
// exact, so the order of the sum does not change the result.
#pragma once
#include "fq.cuh"

#define REDUCE_THREADS 256

// Sum of one value per thread over the block; the result lands in thread 0's
// v. sh holds blockDim.x * 8 words; blockDim.x is a power of two.
__device__ void block_sum(uint32_t* v, uint32_t* sh) {
  const int t = threadIdx.x;
  copy8(sh + 8 * t, v);
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if (t < s) fq_add(sh + 8 * t, sh + 8 * t, sh + 8 * (t + s));
    __syncthreads();
  }
  if (t == 0) copy8(v, sh);
  __syncthreads();
}

// out[j] = sum over i < n of part[j * n + i] (8-word values), written as 16
// limbs. One block of REDUCE_THREADS threads per j.
__global__ void reduce_partials(const uint32_t* __restrict__ part, long long n,
                                int32_t* __restrict__ out) {
  __shared__ uint32_t sh[REDUCE_THREADS * 8];
  const long long j = blockIdx.x;
  uint32_t acc[8];
  zero8(acc);
  for (long long i = threadIdx.x; i < n; i += blockDim.x)
    fq_add(acc, acc, part + 8 * (j * n + i));
  block_sum(acc, sh);
  if (threadIdx.x == 0) store16(out + 16 * j, acc);
}
