// K2: Pippenger multi-scalar multiplication and the bullet generator fold.
//
// Replaces the JAX package's ops/msm.py (_msm_sorted, _window_sum_flat,
// _hs_scan, _fold_sum) and ops/curve.py (_fold_scan / fold_points). The TPU
// design sorted digits and ran prefix point scans because its vector unit
// has no scatter; a GPU block can bucket points directly, so the design is
// the textbook one:
//
//   msm_window: one block per (row, 8-bit window). The block counting-sorts
//     the window's digits in shared memory (tiles of TILE points), then
//     thread d walks the points of digit d and sums them into bucket d in
//     registers. The weighted bucket sum sum_d d * bucket_d is a running sum
//     in two levels: 16 threads each reduce 16 consecutive buckets, and
//     thread 0 combines the 16 segment results.
//   msm_horner: one thread per row combines the 32 window sums from the top
//     window down with 8 doublings between windows.
//   fold_points: one thread per point pair computes k_l * L_i + k_r * R_i
//     by a joint double-and-add over the 253 bits of the shared scalars.
//   point_sum (K12): one thread per column b sums D points (D, B) -> (B)
//     by the halving tree of ops/curve.py tree_sum (identity-padded, the
//     same pairs in the same order, so the coordinates equal the plain
//     version's). It adds up the per-rank MSM partials of the sharded MSM
//     (parallel/msm_sharded.py); replaces the JAX package's ops/curve.py
//     tree_reduce as parallel/msm_sharded.py msm_sharded_dev uses it.
//   scale_points (K13): one thread per point computes k * P by the JAX
//     package's 253-step scan (ops/curve.py _scale_scan / scale_points):
//     bit i from the bottom adds the running 2^i P, then doubles it.
//
// Bound on the card: operations. Each point addition is 9 products of
// 256-bit numbers mod p (~64 32x32-bit multiply-adds each plus reduction);
// an MSM of B rows of N points needs about 32 (B N + 2 * 256 B) additions
// here. The serial bucket reduction (~80 dependent point operations per
// block) and register pressure are what a later tuning pass should attack.
// K12 adds D - 1 points a column and reads D B points, so at the few ranks
// of a mesh it is bound by bytes; its columns are independent threads.
// K13 is bound by operations: 253 doublings and popcount(k) additions a
// point, a dependent chain per thread, so it needs thousands of points to
// fill the card.
#include <cuda_runtime.h>

#include "curve.cuh"

#define WBITS 8
#define NWIN 32
#define NBUCKET 256
#define MSM_THREADS 256
#define TILE 1024
#define SEGS 16

__device__ __forceinline__ uint32_t digit_of(const int32_t* s, int w) {
  return ((uint32_t)s[w >> 1] >> ((w & 1) * 8)) & 0xffu;
}

// win[(b * NWIN + w)] = sum_n digit_w(scalars[b, n]) * points[n]
__global__ void __launch_bounds__(MSM_THREADS)
    k_msm_window(const int32_t* __restrict__ points,
                 const int32_t* __restrict__ scalars, Point* __restrict__ win,
                 long long N) {
  __shared__ uint32_t cnt[NBUCKET], start[NBUCKET + 1], fill[NBUCKET];
  __shared__ uint16_t order[TILE];
  __shared__ uint8_t dig[TILE];
  __shared__ Point seg_w[SEGS], seg_s[SEGS];
  __shared__ Point bucket[NBUCKET];

  const int w = blockIdx.x;
  const long long b = blockIdx.y;
  const int t = threadIdx.x;
  const int32_t* srow = scalars + 16 * N * b;

  Point acc;
  pt_identity(acc);
  for (long long base = 0; base < N; base += TILE) {
    const int n = (int)(N - base < TILE ? N - base : TILE);
    cnt[t] = 0;
    fill[t] = 0;
    __syncthreads();
    for (int j = t; j < n; j += MSM_THREADS) {
      const uint32_t d = digit_of(srow + 16 * (base + j), w);
      dig[j] = (uint8_t)d;
      atomicAdd(&cnt[d], 1u);
    }
    __syncthreads();
    if (t == 0) {
      uint32_t s = 0;
      for (int d = 0; d < NBUCKET; ++d) {
        start[d] = s;
        s += cnt[d];
      }
      start[NBUCKET] = s;
    }
    __syncthreads();
    for (int j = t; j < n; j += MSM_THREADS) {
      const uint32_t d = dig[j];
      order[start[d] + atomicAdd(&fill[d], 1u)] = (uint16_t)j;
    }
    __syncthreads();
    if (t > 0) {
      for (uint32_t k = start[t]; k < start[t + 1]; ++k) {
        Point p;
        pt_load(p, points + 64 * (base + order[k]));
        pt_add(acc, acc, p);
      }
    }
    __syncthreads();
  }
  bucket[t] = acc;
  __syncthreads();

  // segment s covers buckets [16 s, 16 s + 16): W_s = sum_j j * B_{16s+j},
  // S_s = sum_j B_{16s+j}
  if (t < SEGS) {
    Point run, tot;
    pt_identity(run);
    pt_identity(tot);
    for (int j = 15; j >= 1; --j) {
      pt_add(run, run, bucket[16 * t + j]);
      pt_add(tot, tot, run);
    }
    pt_add(run, run, bucket[16 * t]);
    seg_w[t] = tot;
    seg_s[t] = run;
  }
  __syncthreads();
  // sum_d d B_d = sum_s W_s + 16 * sum_s s * S_s
  if (t == 0) {
    Point run, tot, res;
    pt_identity(run);
    pt_identity(tot);
    for (int s = SEGS - 1; s >= 1; --s) {
      pt_add(run, run, seg_s[s]);
      pt_add(tot, tot, run);
    }
    for (int k = 0; k < 4; ++k) pt_double(tot, tot);
    res = tot;
    for (int s = 0; s < SEGS; ++s) pt_add(res, res, seg_w[s]);
    win[b * NWIN + w] = res;
  }
}

__global__ void k_msm_horner(const Point* __restrict__ win,
                             int32_t* __restrict__ out, long long B) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  Point acc = win[b * NWIN + NWIN - 1];
  for (int w = NWIN - 2; w >= 0; --w) {
    for (int k = 0; k < WBITS; ++k) pt_double(acc, acc);
    pt_add(acc, acc, win[b * NWIN + w]);
  }
  pt_store(out + 64 * b, acc);
}

// out[i] = k_l * L[i] + k_r * R[i]; k holds k_l then k_r as 16-bit limbs.
__global__ void k_fold(const int32_t* __restrict__ L,
                       const int32_t* __restrict__ R,
                       const int32_t* __restrict__ k,
                       int32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t kl[8], kr[8];
  load16(k, kl);
  load16(k + 16, kr);
  Point pl, pr, plr, acc;
  pt_load(pl, L + 64 * i);
  pt_load(pr, R + 64 * i);
  pt_add(plr, pl, pr);
  pt_identity(acc);
  for (int bit = 252; bit >= 0; --bit) {
    pt_double(acc, acc);
    const uint32_t bl = (kl[bit >> 5] >> (bit & 31)) & 1u;
    const uint32_t br = (kr[bit >> 5] >> (bit & 31)) & 1u;
    if (bl && br)
      pt_add(acc, acc, plr);
    else if (bl)
      pt_add(acc, acc, pl);
    else if (br)
      pt_add(acc, acc, pr);
  }
  pt_store(out + 64 * i, acc);
}

// out[b] = sum_d in[d, b], the halving tree of tree_sum; scratch holds
// (D + 1) / 2 points per column for the levels after the first.
__global__ void k_point_sum(const int32_t* __restrict__ in,
                            int32_t* __restrict__ scratch,
                            int32_t* __restrict__ out, long long D,
                            long long B) {
  const long long b = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int32_t* src = in;
  long long n = D;
  while (n > 1) {
    const long long h = (n + 1) / 2;  // odd n: the identity pads the top
    for (long long i = 0; i < h; ++i) {
      Point p, q;
      pt_load(p, src + 64 * (i * B + b));
      if (i + h < n)
        pt_load(q, src + 64 * ((i + h) * B + b));
      else
        pt_identity(q);
      pt_add(p, p, q);
      pt_store(scratch + 64 * (i * B + b), p);
    }
    src = scratch;
    n = h;
  }
  for (int k = 0; k < 64; ++k) out[64 * b + k] = src[64 * b + k];
}

// out[i] = k * P[i]; k as 16-bit limbs (canonical, < l).
__global__ void k_scale(const int32_t* __restrict__ P,
                        const int32_t* __restrict__ k,
                        int32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t kk[8];
  load16(k, kk);
  Point add, acc;
  pt_load(add, P + 64 * i);
  pt_identity(acc);
  for (int bit = 0; bit < 253; ++bit) {
    if ((kk[bit >> 5] >> (bit & 31)) & 1u) pt_add(acc, acc, add);
    pt_double(add, add);
  }
  pt_store(out + 64 * i, acc);
}

extern "C" {

// points (N, 4, 16); scalars (B, N, 16) canonical limbs; win: B * NWIN
// scratch points (128 B each); out (B, 4, 16).
int msm_launch(const int32_t* points, const int32_t* scalars, void* win,
               int32_t* out, long long B, long long N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  dim3 grid(NWIN, (unsigned)B);
  k_msm_window<<<grid, MSM_THREADS, 0, s>>>(points, scalars, (Point*)win, N);
  k_msm_horner<<<(unsigned)((B + 63) / 64), 64, 0, s>>>((const Point*)win,
                                                        out, B);
  return (int)cudaGetLastError();
}

int fold_points_launch(const int32_t* L, const int32_t* R, const int32_t* k,
                       int32_t* out, long long n, void* stream) {
  if (n > 0)
    k_fold<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        L, R, k, out, n);
  return (int)cudaGetLastError();
}

// in (D, B, 4, 16); scratch ((D + 1) / 2, B, 4, 16); out (B, 4, 16).
int point_sum_launch(const int32_t* in, int32_t* scratch, int32_t* out,
                     long long D, long long B, void* stream) {
  if (B > 0)
    k_point_sum<<<(unsigned)((B + 127) / 128), 128, 0,
                  (cudaStream_t)stream>>>(in, scratch, out, D, B);
  return (int)cudaGetLastError();
}

// P (n, 4, 16); k (16,) canonical limbs; out (n, 4, 16).
int scale_points_launch(const int32_t* P, const int32_t* k, int32_t* out,
                        long long n, void* stream) {
  if (n > 0)
    k_scale<<<(unsigned)((n + 127) / 128), 128, 0, (cudaStream_t)stream>>>(
        P, k, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
