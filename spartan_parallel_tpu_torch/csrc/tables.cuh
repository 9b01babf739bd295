// Table entries on the card, shared by the round kernels of K4
// (sumcheck.cu) and K6 (product.cu): 16-byte loads and stores of one
// element, the pair (lo, hi) of a table optionally bound to the previous
// round's challenge on the way, and a warp's sum. Device code only.
#pragma once
#include "fq.cuh"

// a table read (src) and, when a kernel binds it, its new table (dst)
struct Tab {
  const int32_t* src;
  int32_t* dst;
};

// one element, 16 bytes at a time (4 limbs a load); the tables are 16-byte
// aligned (the wrappers check)
__device__ __forceinline__ void ld_el(uint32_t* v, const int32_t* p) {
  const int4* q = reinterpret_cast<const int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int4 x = __ldg(q + k);
    v[2 * k] = (uint32_t)x.x | ((uint32_t)x.y << 16);
    v[2 * k + 1] = (uint32_t)x.z | ((uint32_t)x.w << 16);
  }
}

__device__ __forceinline__ void st_el(int32_t* p, const uint32_t* v) {
  int4* q = reinterpret_cast<int4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = make_int4((int)(v[2 * k] & 0xffffu), (int)(v[2 * k] >> 16),
                     (int)(v[2 * k + 1] & 0xffffu),
                     (int)(v[2 * k + 1] >> 16));
}

// A warp's 32 elements, one a lane at any per-lane address, moved through
// shared memory so that every global access is 16 bytes a lane with
// neighbouring lanes on neighbouring 16 bytes wherever the elements are
// contiguous: in access k, lane l moves quarter l & 3 of the element of
// lane 8 k + l / 4 (whose address it takes by a shuffle). The tile is the
// warp's 32 x 64 bytes; quarter q of element e sits at 4 e + (q ^ (e / 2
// & 3)), which keeps both the staging and a lane's reads of its own
// element free of bank conflicts. Every lane of the warp takes part;
// `ok` says whether the lane's element exists.
__device__ __forceinline__ int tile_at(int e, int q) {
  return 4 * e + (q ^ ((e >> 1) & 3));
}

__device__ __forceinline__ void warp_ld_el(int4* tile, const int32_t* p,
                                           bool ok, uint32_t* v) {
  const int lane = threadIdx.x & 31;
  const unsigned live = __ballot_sync(0xffffffffu, ok);
  const unsigned long long mine = (unsigned long long)p;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = 8 * k + (lane >> 2), q = lane & 3;
    const unsigned long long at = __shfl_sync(0xffffffffu, mine, e);
    if ((live >> e) & 1)
      tile[tile_at(e, q)] = __ldg(reinterpret_cast<const int4*>(at) + q);
  }
  __syncwarp();
  if (ok) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int4 x = tile[tile_at(lane, q)];
      v[2 * q] = (uint32_t)x.x | ((uint32_t)x.y << 16);
      v[2 * q + 1] = (uint32_t)x.z | ((uint32_t)x.w << 16);
    }
  }
  __syncwarp();
}

__device__ __forceinline__ void warp_st_el(int4* tile, int32_t* p, bool ok,
                                           const uint32_t* v) {
  const int lane = threadIdx.x & 31;
  const unsigned live = __ballot_sync(0xffffffffu, ok);
  const unsigned long long mine = (unsigned long long)p;
  if (ok) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      tile[tile_at(lane, q)] =
          make_int4((int)(v[2 * q] & 0xffffu), (int)(v[2 * q] >> 16),
                    (int)(v[2 * q + 1] & 0xffffu), (int)(v[2 * q + 1] >> 16));
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int e = 8 * k + (lane >> 2), q = lane & 3;
    const unsigned long long at = __shfl_sync(0xffffffffu, mine, e);
    if ((live >> e) & 1)
      reinterpret_cast<int4*>(at)[q] = tile[tile_at(e, q)];
  }
  __syncwarp();
}

// entry idx of T; with BIND, bound to r: T[idx] + r (T[idx + step] - T[idx])
template <bool BIND>
__device__ __forceinline__ void tab_val(uint32_t* v, const int32_t* T,
                                        size_t idx, size_t step,
                                        const uint32_t* r) {
  ld_el(v, T + 16 * idx);
  if (BIND) {
    uint32_t h[8];
    ld_el(h, T + 16 * (idx + step));
    fq_bind(v, v, h, r);
  }
}

// the pair (lo, lo + half) of T.src; with BIND, bound to r from the pairs
// (lo, lo + 2 half) and (lo + half, lo + 3 half) and stored to T.dst at
// (out, out + half)
template <bool BIND>
__device__ __forceinline__ void tab_pair(uint32_t* vl, uint32_t* vh, Tab T,
                                         size_t lo, size_t half, size_t out,
                                         const uint32_t* r, bool store) {
  tab_val<BIND>(vl, T.src, lo, 2 * half, r);
  tab_val<BIND>(vh, T.src, lo + half, 2 * half, r);
  if (BIND && store) {
    st_el(T.dst + 16 * out, vl);
    st_el(T.dst + 16 * (out + half), vh);
  }
}

// v summed over the warp's lanes into lane 0
__device__ __forceinline__ void warp_sum8(uint32_t* v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    uint32_t t[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) t[k] = __shfl_down_sync(0xffffffffu, v[k], off);
    fq_add(v, v, t);
  }
}
