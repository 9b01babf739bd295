// A measurement kernel, on no path: one warp runs a dependent chain of
// `steps` field products, so its time over the steps is one product's
// latency on a lone thread (chip_smoke.py phase 2 `fp_chain`, which builds
// it). It chose the products of the chains (csrc/fe.cuh, csrc/fp10.cuh).
// Variants:
//   0 fp_mul as K9-K11 called it before: a __noinline__ call on arrays
//     passed by pointer (fp.cuh, row-by-row carries);
//   1 (a) the same product inlined, operands in registers;
//   2 (b) fe_mul: ten unsaturated limbs, ten independent column sums;
//   3 (b) fe_sqr, the squaring of the (p - 5) / 8 power;
//   4 fq_mul (Montgomery mod l) as K11's scalar steps call it;
//   5 (b + c) G10::mul (fp10.cuh): ten lanes share one product, a limb of
//     (b)'s form each, a column sum each and two carry passes by shuffles
//     (three chains a warp);
//   6 (b + c) G10::sqr, the ENCODE's squaring.
// Lane i's chain starts at x[i] (16-bit limbs) and runs y = y * b
// (variants 3 and 6: y = y^2; variant 4: y = y * b / 2^256 mod l); out[i]
// gets y, fully reduced. Variants 5 and 6 run one chain a group, from the
// x of the group's first lane; every lane of the group stores it.
#include <cuda_runtime.h>

#include "fe.cuh"
#include "fp.cuh"
#include "fp10.cuh"
#include "fq.cuh"

#define FULL 0xffffffffu

__device__ __noinline__ void fp_mul_call(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b) {
  fp_mul(r, a, b);
}

__device__ __noinline__ void fq_mul_call(uint32_t* r, const uint32_t* a,
                                         const uint32_t* b) {
  fq_mul(r, a, b);
}

__global__ void fp_chain_kernel(int variant, const int32_t* __restrict__ x,
                                const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, int steps) {
  const int lane = threadIdx.x;
  uint32_t y[8], bb[8];
  load16(x + 16 * lane, y);
  load16(b, bb);
  if (variant == 0) {
    for (int s = 0; s < steps; ++s) fp_mul_call(y, y, bb);
  } else if (variant == 1) {
#pragma unroll 1
    for (int s = 0; s < steps; ++s) fp_mul(y, y, bb);
  } else if (variant == 2 || variant == 3) {
    Fe f = fe_from_words(y);
    const Fe g = fe_from_words(bb);
    if (variant == 2) {
#pragma unroll 1
      for (int s = 0; s < steps; ++s) f = fe_mul(f, g);
    } else {
      f = fe_nsqr(f, steps);
    }
    fe_to_words(y, f);
  } else if (variant == 5 || variant == 6) {
    const G10 f(lane);
    uint32_t xw[8];
    for (int j = 0; j < 8; ++j) xw[j] = __shfl_sync(FULL, y[j], f.base);
    uint32_t w = f.constant(xw);
    const uint32_t bw = f.constant(bb);
    if (variant == 5) {
#pragma unroll 1
      for (int s = 0; s < steps; ++s) w = f.mul(w, bw);
    } else {
#pragma unroll 1
      for (int s = 0; s < steps; ++s) w = f.sqr(w);
    }
    f.words(y, w);
  } else {
    for (int s = 0; s < steps; ++s) fq_mul_call(y, y, bb);
  }
  store16(out + 16 * lane, y);
}

extern "C" {

// x (32, 16), b (16,), out (32, 16) int32 limbs; one warp.
int fp_chain_launch(int variant, const int32_t* x, const int32_t* b,
                    int32_t* out, int steps, void* stream) {
  if (variant < 0 || variant > 6) return (int)cudaErrorInvalidValue;
  fp_chain_kernel<<<1, 32, 0, (cudaStream_t)stream>>>(variant, x, b, out,
                                                      steps);
  return (int)cudaGetLastError();
}

}  // extern "C"
