// 256-bit integers as 8 little-endian 32-bit words, shared by fq.cuh and
// fp.cuh. Host tensors keep the JAX package's layout: 16 little-endian
// 16-bit limbs per element, one limb per int32 lane. load16/store16 pack and
// unpack between the two at the kernel boundary.
//
// Every function here is __host__ __device__ so that g++ builds the same
// arithmetic into a host library for the CPU tests (csrc/host_check.cpp).
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define HD __host__ __device__ __forceinline__
#else
#define HD static inline
#endif

HD void load16(const int32_t* p, uint32_t* r) {
  for (int k = 0; k < 8; ++k)
    r[k] = (uint32_t)p[2 * k] | ((uint32_t)p[2 * k + 1] << 16);
}

HD void store16(int32_t* p, const uint32_t* r) {
  for (int k = 0; k < 8; ++k) {
    p[2 * k] = (int32_t)(r[k] & 0xffffu);
    p[2 * k + 1] = (int32_t)(r[k] >> 16);
  }
}

HD void copy8(uint32_t* r, const uint32_t* a) {
  for (int k = 0; k < 8; ++k) r[k] = a[k];
}

HD void zero8(uint32_t* r) {
  for (int k = 0; k < 8; ++k) r[k] = 0;
}

// r = a + b mod 2^256; returns the carry out.
HD uint32_t add8(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t c = 0;
  for (int k = 0; k < 8; ++k) {
    c += (uint64_t)a[k] + b[k];
    r[k] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// r = a - b mod 2^256; returns 1 if a < b (the borrow out).
HD uint32_t sub8(uint32_t* r, const uint32_t* a, const uint32_t* b) {
  uint64_t br = 0;
  for (int k = 0; k < 8; ++k) {
    uint64_t d = (uint64_t)a[k] - b[k] - br;
    r[k] = (uint32_t)d;
    br = d >> 63;
  }
  return (uint32_t)br;
}

// a = a - m if a >= m (with an optional carry word above a).
HD void csub8(uint32_t* a, const uint32_t* m, uint32_t hi = 0) {
  uint32_t t[8];
  uint32_t br = sub8(t, a, m);
  if (hi || !br) copy8(a, t);
}
