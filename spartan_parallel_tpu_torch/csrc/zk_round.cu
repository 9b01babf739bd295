// K8-K11: the device-resident ZK sumcheck round of the JAX package's
// ops/transcript_dev.py, ops/ristretto_dev.py and ops/zk_round.py.
//
// K8 keccak_kernel: replaces transcript_dev.py _f1600/permute. N
//   independent 200-byte states, a warp each: the permutation K11 runs
//   (csrc/keccak.cuh keccak_lanes, 25 lanes a state). The path runs this
//   code inside K11; K8 alone is the kernel-level check of it. Bound by
//   operations (24 rounds of ~155 64-bit logic operations a state).
// K9 compress_kernel: replaces ristretto_dev.py compress (with pow_p58 and
//   sqrt_ratio_m1). A group of ten lanes a point, three a warp: ~285
//   field products in a row, most of them the squarings of the (p - 5) / 8
//   power, each spread over the group (csrc/fp10.cuh), so the batch needs
//   many points to fill the card. Bound by operations.
// K10 comb_kernel: replaces ristretto_dev.py comb_commit, zk_round.py
//   comb_commit and the point sum of curve.py tree_reduce. One block of
//   256 threads per commitment: group w of four lanes adds the n table
//   entries of nibble w (n - 1 lane-split additions, csrc/lanes.cuh, three
//   products deep each), then the 64 sums add up by halving through
//   shared memory. Bound by operations (about 64 n + 63 additions); a
//   commitment reads 64 n table entries of 256 bytes.
// K11 zk_round_tail_kernel: replaces zk_round.py _zk_round_tail (with
//   _coeffs_from_evals and _poly_eval). One block of 256 threads per
//   round, a dependent chain on one SM: warp 0 runs the transcript (its
//   Keccak on 25 lanes) and the scalar steps, each independent product
//   mod l on a lane of its own (csrc/zk_round.cuh); all 256 threads run
//   the comb sums (4 G + h, then G + h), then Cy's and beta's side by side
//   on the block's two halves; ten lanes of warp 1 encode each point
//   (lanes 0-9 Cy and 10-19 beta at once, csrc/fp10.cuh) while warp 0 runs
//   the transcript steps that do not wait for it. The comb sum and the
//   encoding have one call site each, in the loop over the three stages.
//   Its bound is one SM's share of the card, not the card's.
//
// Each entry returns cudaGetLastError().
#include <cuda_runtime.h>

#include "zk_round.cuh"

#define COMB_MAX_GENS 8
#define ZK_THREADS 256

__global__ void keccak_kernel(const int32_t* __restrict__ in,
                              int32_t* __restrict__ out, long long n) {
  __shared__ __align__(8) uint8_t st[4][200];
  const int lane = threadIdx.x & 31, wi = threadIdx.x >> 5;
  const long long i = blockIdx.x * 4LL + wi;
  if (i >= n) return;  // the whole warp
  for (int k = lane; k < 200; k += 32) st[wi][k] = (uint8_t)in[200 * i + k];
  keccak_lanes(st[wi], lane);
  for (int k = lane; k < 200; k += 32) out[200 * i + k] = st[wi][k];
}

// The ENCODE of the point whose canonical words are w (X, Y, Z, T, in
// shared memory) by a warp, three groups of ten lanes (csrc/fp10.cuh; each
// group its own w). K9 and K11 run this code.
__device__ __forceinline__ void encode_words(uint8_t* dst,
                                             const uint32_t (*w)[8]) {
  const G10 f(threadIdx.x & 31);
  ristretto_encode(f, dst, f.load(w[0]), f.load(w[1]), f.load(w[2]),
                   f.load(w[3]));
}

// a group of ten lanes a point (lane k: limb k of each coordinate), three
// groups a warp; groups past n repeat the last point and store nothing
__global__ void compress_kernel(const int32_t* __restrict__ pts,
                                int32_t* __restrict__ out, long long n) {
  __shared__ uint32_t w[4][3][4][8];
  __shared__ uint8_t b[4][3][32];
  const int wi = threadIdx.x >> 5;
  const G10 f(threadIdx.x & 31);
  const long long first = (blockIdx.x * 4LL + wi) * 3;
  if (first >= n) return;  // the whole warp
  const long long i0 = first + f.grp, i = i0 < n ? i0 : n - 1;
  if (f.live && f.k < 8)  // lane k: word k of each coordinate
    for (int c = 0; c < 4; ++c) {
      const int32_t* p = pts + 64 * i + 16 * c + 2 * f.k;
      w[wi][f.grp][c][f.k] = (uint32_t)p[0] | ((uint32_t)p[1] << 16);
    }
  __syncwarp();
  uint8_t* o = b[wi][f.grp];
  encode_words(o, w[wi][f.grp]);
  if (i0 < n && f.live && f.k < 8)
    for (int j = 0; j < 4; ++j) out[32 * i + 4 * f.k + j] = o[4 * f.k + j];
}

// The comb sum of one commitment on 4 ngrp threads (t: the thread's index
// among them; groups of four neighbouring lanes, ngrp = 64 or 32, see
// ristretto.cuh); the point's canonical words land in pw (X, Y, Z, T),
// visible to every thread of the block on return. Every thread of the
// block calls it (two halves of 128 may run one each).
__device__ void comb_lanes(int t, int ngrp, const int32_t* tab, int n,
                           const uint32_t (*canon)[8], Fe (*slot)[4],
                           uint32_t (*pw)[8]) {
  const int g = t >> 2, c = t & 3, base = threadIdx.x & 28;
  auto window = [&](int w) {
    Fe acc = fe_load16(comb_entry(tab, canon, 0, w) + 16 * c);
    for (int gi = 1; gi < n; ++gi) {
      const int32_t* e = comb_entry(tab, canon, gi, w);
      q_add(acc, c, base, [&](int k) { return fe_load16(e + 16 * k); });
    }
    return acc;
  };
  Fe acc;
  if (ngrp == 32) {  // windows g + 32 and g: the halving's first level
    slot[g][c] = window(g + 32);
    __syncwarp();
    acc = window(g);
    q_add(acc, c, base, [&](int k) { return slot[g][k]; });
  } else {
    acc = window(g);
  }
  const int first = (t & ~31) >> 2;  // the warp's first group
  for (int off = ngrp >> 1; off > 0; off >>= 1) {
    __syncthreads();
    if (g >= off && g < 2 * off) slot[g][c] = acc;
    __syncthreads();
    if (first < off) {  // the whole warp; groups past off compute unused
      const int src = g + off < ngrp ? g + off : g;
      Fe r = acc;
      q_add(r, c, base, [&](int k) { return slot[src][k]; });
      if (g < off) acc = r;
    }
  }
  if (g == 0) fe_to_words(pw[c], acc);
  __syncthreads();
}

__global__ void __launch_bounds__(ZK_THREADS)
    comb_kernel(const int32_t* __restrict__ tab, int n,
                const int32_t* __restrict__ scal, int32_t* __restrict__ out) {
  __shared__ uint32_t canon[COMB_MAX_GENS][8];
  __shared__ Fe slot[COMB_WINDOWS][4];
  __shared__ uint32_t pw[4][8];
  const int t = threadIdx.x;
  if (t < n) {
    load16(scal + (blockIdx.x * (long long)n + t) * 16, canon[t]);
    fq_canon(canon[t], canon[t]);
  }
  __syncthreads();
  comb_lanes(t, COMB_WINDOWS, tab, n, canon, slot, pw);
  if (t < 4) store16(out + 64 * (long long)blockIdx.x + 16 * t, pw[t]);
}

// Three stages, each a comb sum, its encoding (warp 1) beside the
// transcript steps that do not need it (warp 0), then warp 0's transcript
// and scalar steps: (4 G + h -> comm_poly), (G + h -> comm_eval), (Cy and
// beta on the two halves -> both encodings, then the DotProductProof).
__global__ void __launch_bounds__(ZK_THREADS)
    zk_round_tail_kernel(const int32_t* __restrict__ evs, int k,
                         int32_t* st_io, int32_t* carry,
                         const int32_t* __restrict__ tape,
                         int32_t* __restrict__ out,
                         const int32_t* __restrict__ tab_n, int n_n,
                         const int32_t* __restrict__ tab_1) {
  __shared__ ZkTail z;
  __shared__ Fe slot[COMB_WINDOWS][4];
  const int t = threadIdx.x;
  WarpX x{t & 31};
  Strobe s{z.st, 0, 0};
  if (t < 32) zk_tail_load(x, s, z, evs, k, st_io, carry, tape);
#pragma unroll 1  // one copy of the comb sum and of the encoding
  for (int stage = 0; stage < 3; ++stage) {
    __syncthreads();
    const int h = stage == 2 ? t >> 7 : 0;
    comb_lanes(stage == 2 ? t & 127 : t, stage == 2 ? 32 : COMB_WINDOWS,
               stage ? tab_1 : tab_n, stage ? 2 : n_n, z.sc[h],
               slot + 32 * h, z.pw[h]);
    if (t >= 32 && t < 64) {  // warp 1: group 0 encodes the point, group
      const int g = G10(t & 31).grp;  // 1 beta's beside Cy; the other
      const int e = stage == 2 && g == 1;  // groups repeat a point unkept
      uint8_t* dst = g > (stage == 2 ? 1 : 0) ? z.spare[g - 1]
                     : stage == 0              ? z.comm_poly
                     : stage == 1              ? z.comm_eval
                     : e                       ? z.beta
                                               : z.cy;
      encode_words(dst, z.pw[e]);
    } else if (t < 32 && stage == 1) {  // meanwhile, what does not wait
      zk_tail_claim(x, s, z);           // for the encoding
    } else if (t < 32 && stage == 2) {
      zk_tail_dpp(x, s, z);
    }
    __syncthreads();
    if (t < 32) {
      if (stage == 0)
        zk_tail_poly(x, s, z);
      else if (stage == 1)
        zk_tail_eval(x, s, z);
      else
        zk_tail_finish(x, s, z, st_io, carry, out);
    }
  }
}

extern "C" {

int keccak_launch(const int32_t* in, int32_t* out, long long n,
                  cudaStream_t stream) {
  keccak_kernel<<<(unsigned)((n + 3) / 4), 128, 0, stream>>>(in, out, n);
  return (int)cudaGetLastError();
}

int compress_launch(const int32_t* pts, int32_t* out, long long n,
                    cudaStream_t stream) {
  compress_kernel<<<(unsigned)((n + 11) / 12), 128, 0, stream>>>(pts, out,
                                                                 n);
  return (int)cudaGetLastError();
}

int comb_launch(const int32_t* tab, int n, const int32_t* scal,
                int32_t* out, long long batch, cudaStream_t stream) {
  if (n < 1 || n > COMB_MAX_GENS) return (int)cudaErrorInvalidValue;
  comb_kernel<<<(unsigned)batch, ZK_THREADS, 0, stream>>>(tab, n, scal, out);
  return (int)cudaGetLastError();
}

int zk_round_tail_launch(const int32_t* evs, int k, int32_t* st_io,
                         int32_t* carry, const int32_t* tape, int32_t* out,
                         const int32_t* tab_n, int n_n,
                         const int32_t* tab_1, cudaStream_t stream) {
  if (n_n != 5) return (int)cudaErrorInvalidValue;
  zk_round_tail_kernel<<<1, ZK_THREADS, 0, stream>>>(
      evs, k, st_io, carry, tape, out, tab_n, n_n, tab_1);
  return (int)cudaGetLastError();
}

}  // extern "C"
