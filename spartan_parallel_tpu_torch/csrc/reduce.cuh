// Block-level sums of scalar-field values, the ticketed end of a sum split
// over blocks, and the second pass that sums per-block partials. Device
// code only: the reductions of K1 (dot), K3 (sparse_eval), K4 (round
// evaluations) and K7 (uni_eval_many) all end here. Field addition is
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

// An 8-word partial read past L1 (written by another block of the launch).
__device__ __forceinline__ void ld_partial(uint32_t* v, const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  const uint4 lo = __ldcg(q), hi = __ldcg(q + 1);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// The end of a sum split over nc blocks, called by every thread of block y
// < nc with its share in acc: with nc == 1 the block sum is the total.
// Else each block stores its sum at part + 8 (first + y), and the last
// block to take the ticket (atomicInc after __threadfence, which wraps it
// back to 0) sums the nc partials. The total goes to out as 16 limbs.
__device__ void ticket_sum(uint32_t* acc, uint32_t* sh, uint32_t* part,
                           long long first, unsigned y, unsigned nc,
                           unsigned* ticket, int32_t* out) {
  __shared__ bool last;
  block_sum(acc, sh);
  if (nc == 1) {
    if (threadIdx.x == 0) store16(out, acc);
    return;
  }
  if (threadIdx.x == 0) {
    copy8(part + 8 * (first + y), acc);
    __threadfence();
    last = atomicInc(ticket, nc - 1) == nc - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  zero8(acc);
  for (unsigned i = threadIdx.x; i < nc; i += blockDim.x) {
    uint32_t x[8];
    ld_partial(x, part + 8 * (first + i));
    fq_add(acc, acc, x);
  }
  block_sum(acc, sh);
  if (threadIdx.x == 0) store16(out, acc);
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
