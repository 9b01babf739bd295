// K2: Pippenger multi-scalar multiplication and the bullet generator fold.
//
// Replaces the JAX package's ops/msm.py (_msm_sorted, _window_sum_flat,
// _hs_scan, _fold_sum, _pick_wbits) and ops/curve.py (_fold_scan /
// fold_points). The TPU design sorted digits and ran prefix point scans
// because its vector unit has no scatter; a GPU warp can bucket points
// directly. out[b] = sum_n s[b, n] P[n] for B rows of N shared points.
//
// Bound on the card: operations. A bucket addition is 8 products of
// 256-bit numbers mod p (~64 32x32-bit multiply-adds each plus the
// fold), and there are ~32 B N of them; the rest is kept to a small share
// of that and off long chains:
//
//   msm_prep (one thread a point and a scalar): each point once into
//     cached form (Y - X, Y + X, 2 Z, 2 d T; csrc/msm.cuh) as 32-bit words
//     that load as 16-byte vectors, so a bucket addition costs 8 products,
//     not pt_add's 9, and repacks no limbs; each scalar once into signed
//     8-bit digits in [-128, 128) (byte + carry in >= 128 gives byte - 256
//     and a carry out; canonical scalars leave no carry out of window 31)
//     laid out (B, 32, N), so a window reads its digits as one run. 128
//     buckets |d| = 1..128, half the unsigned digits' 256; a negative
//     digit adds the negated cached point (Y -+ X swapped, 2 d T negated).
//   msm_window (one warp, a block of its own, per row, window and chunk
//     of <= TILE points: the whole row at more than SPLIT_ROWS rows, else
//     a quarter): the warp counting-sorts its chunk by |digit| in shared
//     memory so that lane l owns buckets l + 97, l + 65, l + 33, l + 1 as
//     one run (interleaved, so a top window's digits, below 17 for a
//     canonical scalar, spread over 16 lanes), then walks the runs: each
//     step adds a point into the running sum r, or at a bucket's end r
//     into w, so that r = sum_i B_{l+1+32i} and w = sum_i i B_{l+1+32i}.
//     The warp runs the lanes' longest run plus 3, not a sum of per-bucket
//     maxima. Then sum_m m B_m = 32 A + B, A = sum_l w_l, B = sum_l Q_l
//     (Q: the suffix sums of r over the lanes): 5 scan levels, then the
//     two halving trees side by side, 5 levels on all 32 lanes (modelled
//     on the host by csrc/host_check.cpp bucket_combine); no lane runs a
//     serial bucket sum. r and w sit in shared memory, word-major; every
//     point operation of the warp is one step of a single loop (x = x +
//     cached q), so the kernel's code is one cached addition and one
//     conversion: the SM's instruction cache holds it whatever step its
//     warps are at (inlined as separate point operations, the reduction
//     and the combine made the kernel several times slower at the commit
//     shape: its warps, in different phases, evicted each other's code).
//   the row combine, in the same launch: the last warp of a row to finish
//     (a counter per row) forms each window's 32 A + B from its chunks,
//     lane w doubles window w 8 w times, then a 5-level tree: 248
//     doublings and 5 additions deep past the windows' 32 A + B, the
//     least variable-base points allow (Horner's chain: 279).
// A single-row MSM (the bullet rounds, N = 34 to 514) is latency-bound:
// its chain is a chunk's walk (~N / 128 + 3 steps), 10 reduction steps,
// the 12-step 32 A + B of 4 chunks, the 248 doublings (there as pt_double
// in registers, 8 products) and 5 additions; each step's products run one
// after another.
//
//   fold_points (k_fold): k_l * L_i + k_r * R_i by a joint double-and-add
//     over the shared scalars from their top set bit, with L, R and L + R
//     in cached form. A chain of doublings and additions whatever the
//     pair count, so each point operation's independent products run on
//     four lanes (csrc/lanes.cuh: two products deep a doubling or an
//     addition, against 8 and 9 on one thread) on the chains' product
//     (csrc/fe.cuh), and one-warp blocks of eight pairs spread 512 pairs
//     over 64 SMs. Dependent products: 4 to form the cached addends, then
//     2 a bit below the top and 2 a bit set in k_l | k_r.
//   point_sum (K12): the sum of D points a column, (D, B) -> (B), by the
//     halving tree of ops/curve.py tree_sum (pairs (i, i + h), h = ceil(n
//     / 2), the identity padding an odd level: the same pairs in the same
//     order, so the coordinates equal the plain version's). It adds up the
//     per-rank MSM partials of the sharded MSM (parallel/msm_sharded.py)
//     and msm_dev's chunk sums; replaces the JAX package's ops/curve.py
//     tree_reduce. A column on four lanes (one-warp blocks of eight
//     columns, 128 blocks at B = 1024), lane c loading coordinate c of
//     each point as four 16-byte loads; each addition is q_add_pt, three
//     products deep (one thread's pt_add: 9). Levels of more than 4 points
//     go through scratch, each lane reading back only the coordinate it
//     wrote; the last two levels stay in registers, their first two
//     additions side by side.
//   scale_points (K13): k * P for every point by the JAX package's scan
//     (ops/curve.py _scale_scan / scale_points): bit i from the bottom adds
//     the running 2^i P, then doubles it. A point on four lanes, one-warp
//     blocks of eight points; a set bit is one step q_add_dbl (the
//     addition's products and the doubling's side by side: 3 products
//     deep), a clear bit a q_double (2). k is shared, so every lane of a
//     warp takes the same branch. About 2 * 253 + popcount(k) products
//     deep, against one thread's 253 * 8 + popcount(k) * 9.
//
// K12 adds D - 1 points a column and reads D B points, so at the few ranks
// of a mesh it is bound by bytes (in practice by its few dependent
// products and the launch). K13 is bound by operations: 8 field products
// a doubling up to k's top bit and 9 a set bit, a point.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "msm.cuh"

#define TILE 2048       // most points of one warp's chunk
#define SPLIT_ROWS 64   // up to this many rows a window splits over 4 warps
#define SPLIT 4
#define FULL 0xffffffffu
#define REDUCE_STEPS 10  // 5 scan levels, 5 levels of two trees

// A warp's shared memory (12.5 KB): the running sums r and w of its 32
// lanes, word-major (conflict-free; r takes the chunk's digits' place once
// they are sorted), the sorted point indices (bit 15: a negative digit)
// and the bucket counts, then cursors.
struct WarpSmem {
  union {
    int8_t dig[TILE];
    uint32_t r[32][32];
  } a;
  uint32_t w[32][32];
  uint16_t order[TILE];
  uint32_t cur[MSM_NBUCKET];
};

__device__ __forceinline__ void slot_store(uint32_t (*s)[32], int lane,
                                           const Point& p) {
  for (int k = 0; k < 8; ++k) {
    s[k][lane] = p.X[k];
    s[8 + k][lane] = p.Y[k];
    s[16 + k][lane] = p.Z[k];
    s[24 + k][lane] = p.T[k];
  }
}

__device__ __forceinline__ void slot_load(Point& p, uint32_t (*s)[32],
                                          int lane) {
  for (int k = 0; k < 8; ++k) {
    p.X[k] = s[k][lane];
    p.Y[k] = s[8 + k][lane];
    p.Z[k] = s[16 + k][lane];
    p.T[k] = s[24 + k][lane];
  }
}

// a point another block wrote (read through L2)
__device__ __forceinline__ void point_ldcg(Point& p, const Point* src) {
  const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
  for (int k = 0; k < 8; ++k) {
    p.X[k] = __ldcg(s + k);
    p.Y[k] = __ldcg(s + 8 + k);
    p.Z[k] = __ldcg(s + 16 + k);
    p.T[k] = __ldcg(s + 24 + k);
  }
}

__device__ __forceinline__ void cached_ldg(Cached& c, const Cached* p) {
  const uint4* s = reinterpret_cast<const uint4*>(p);
  for (int k = 0; k < 2; ++k) {
    uint4 v = __ldg(s + k);
    c.ymx[4 * k] = v.x, c.ymx[4 * k + 1] = v.y;
    c.ymx[4 * k + 2] = v.z, c.ymx[4 * k + 3] = v.w;
    v = __ldg(s + 2 + k);
    c.ypx[4 * k] = v.x, c.ypx[4 * k + 1] = v.y;
    c.ypx[4 * k + 2] = v.z, c.ypx[4 * k + 3] = v.w;
    v = __ldg(s + 4 + k);
    c.z2[4 * k] = v.x, c.z2[4 * k + 1] = v.y;
    c.z2[4 * k + 2] = v.z, c.z2[4 * k + 3] = v.w;
    v = __ldg(s + 6 + k);
    c.t2d[4 * k] = v.x, c.t2d[4 * k + 1] = v.y;
    c.t2d[4 * k + 2] = v.z, c.t2d[4 * k + 3] = v.w;
  }
}

// points (N, 4, 16) -> cached (N); scalars (B, N, 16) -> dig (B, 32, N);
// done (B) zeroed.
__global__ void k_msm_prep(const int32_t* __restrict__ points,
                           const int32_t* __restrict__ scalars,
                           Cached* __restrict__ cached,
                           int8_t* __restrict__ dig, int* __restrict__ done,
                           long long B, long long N) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < N) {
    Point p;
    Cached c;
    pt_load(p, points + 64 * i);
    pt_to_cached(c, p);
    cached[i] = c;
  }
  if (i < B) done[i] = 0;
  if (i < B * N) {
    uint32_t s[8];
    int8_t d[MSM_NWIN];
    load16(scalars + 16 * i, s);
    signed_digits(d, s);
    const long long b = i / N;
    int8_t* o = dig + b * MSM_NWIN * N + (i - b * N);
    for (int w = 0; w < MSM_NWIN; ++w) o[w * N] = d[w];
  }
}

// One warp (a block) per (row b, window w, chunk c), which writes
// part[2 g] = A and part[2 g + 1] = B of its chunk (g = (b * 32 + w) *
// split + c; the chunk's sum of d_w(s[b, n]) P[n] is 32 A + B); the last
// warp of row b to finish writes out[b] = sum_w 2^(8 w) sum_c (32 A + B).
// Every point operation is one step of a single loop, x = x + q with q in
// cached form (a doubling is x + x): the loop body holds the kernel's one
// cached addition and one conversion, so its code stays in the
// instruction cache whatever step each warp on the SM is at. Blocks of one
// warp: a warp that walks long or combines holds no idle warps' slots.
__global__ void __launch_bounds__(32, 16)
    k_msm_window(const Cached* __restrict__ cached,
                 const int8_t* __restrict__ dig, Point* __restrict__ part,
                 int* __restrict__ done, int32_t* __restrict__ out,
                 long long N, int split) {
  __shared__ WarpSmem s;
  const int lane = threadIdx.x;
  const long long g = blockIdx.x;
  const long long row = g / (MSM_NWIN * split);
  const int w = (int)(g % (MSM_NWIN * split)) / split;
  const long long clen = (N + split - 1) / split;
  const long long lo = min(N, (g % split) * clen);
  const int n = (int)(min(N, lo + clen) - lo);
  const int8_t* drow = dig + (row * MSM_NWIN + w) * N + lo;
  const Cached* pts = cached + lo;

  // counting sort by |digit|: lane l's buckets l + 97, l + 65, l + 33,
  // l + 1 in a run
  for (int m = lane; m < MSM_NBUCKET; m += 32) s.cur[m] = 0;
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    const int d = drow[j];
    s.a.dig[j] = (int8_t)d;
    if (d) atomicAdd(&s.cur[abs(d) - 1], 1u);
  }
  __syncwarp();
  const uint32_t c0 = s.cur[lane], c1 = s.cur[lane + 32],
                 c2 = s.cur[lane + 64], c3 = s.cur[lane + 96];
  const uint32_t tot = c0 + c1 + c2 + c3;
  uint32_t incl = tot;
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  uint32_t k = incl - tot;  // the lane's run
  s.cur[lane + 96] = k;
  s.cur[lane + 64] = k + c3;
  s.cur[lane + 32] = k + c3 + c2;
  s.cur[lane] = k + c3 + c2 + c1;
  __syncwarp();
  for (int j = lane; j < n; j += 32) {
    const int d = s.a.dig[j];
    if (d)
      s.order[atomicAdd(&s.cur[abs(d) - 1], 1u)] =
          (uint16_t)(j | (d < 0 ? 0x8000 : 0));
  }
  __syncwarp();
  Point id;
  pt_identity(id);
  slot_store(s.w, lane, id);
  slot_store(s.a.r, lane, id);

  // The steps, in three stages. Walk (each lane its run from the top
  // bucket, `trips` steps, the warp the lanes' most): a point into r, or
  // at the end of each bucket but the last r into w, so that r = S_l and
  // w = W_l. Reduce (10 steps): r's suffix sums over the lanes (5), then
  // the halving trees of w (lanes 0-15) and r (lanes 16-31) side by side
  // (5): A = w[0], B = r[0]. The chunk's A and B are then published, and
  // the row's last warp combines (in r) for window `lane`: its chunks' A
  // (split - 1 steps), 5 doublings, its chunks' B (split steps), 8 lane
  // doublings (248 steps, or at split rows one pt_double loop in
  // registers: a shorter chain for the latency-bound single rows), then
  // the halving tree over the windows (5).
  uint64_t left = c3 | (uint64_t)c2 << 16 | (uint64_t)c1 << 32 |
                  (uint64_t)c0 << 48;  // counts still to walk, top first
  const uint32_t trips = tot + 3;
  const uint32_t walk = __reduce_max_sync(FULL, trips);
  const int sums = split - 1, pre = sums + 5 + split;
  const int dbl = 8 * (MSM_NWIN - 1);
  const Point* rowpart = part + 2 * row * MSM_NWIN * split;
  int stage = 0;
  uint32_t j = 0;
#pragma unroll 1
  for (;; ++j) {
    if (stage == 0 && j == walk) {
      stage = 1;
      j = 0;
    }
    if (stage == 1 && j == REDUCE_STEPS) {  // publish the chunk's A, B
      int last = 0;
      if (lane == 0) {
        Point p;
        slot_load(p, s.w, 0);
        part[2 * g] = p;
        slot_load(p, s.a.r, 0);
        part[2 * g + 1] = p;
        __threadfence();
        last = atomicAdd(&done[row], 1) == MSM_NWIN * split - 1;
      }
      if (!__shfl_sync(FULL, last, 0)) return;
      __threadfence();
      Point p;
      point_ldcg(p, rowpart + 2 * lane * split);
      slot_store(s.a.r, lane, p);
      __syncwarp();
      stage = 2;
      j = 0;
    }
    if (stage == 2 && split > 1 && j == (uint32_t)pre) {
      Point p;
      slot_load(p, s.a.r, lane);
      for (int t = 0; t < 8 * lane; ++t) pt_double(p, p);
      slot_store(s.a.r, lane, p);
      __syncwarp();
      j += dbl;
    }
    if (stage == 2 && j == (uint32_t)(pre + dbl + 5)) {
      if (lane == 0) {
        Point p;
        slot_load(p, s.a.r, 0);
        pt_store(out + 64 * row, p);
      }
      return;
    }
    Point x;
    Cached q;
    bool act = true, conv = true, to_w = false;
    uint32_t(*xs)[32] = s.a.r;  // x's slot and lane
    int xl = lane;
    uint32_t(*qs)[32] = s.a.r;  // q's slot and lane (converted), or the
    int ql = -1;                // identity
    const Point* qg = nullptr;  // or q's point in global memory
    if (stage == 0) {
      act = j < trips;
      if (act && (left & 0xffffu) == 0) {  // a bucket's end: w += r
        xs = s.w;
        to_w = true;
        ql = lane;
        left >>= 16;
      } else if (act) {  // a point into r
        const uint32_t o = s.order[k++];
        cached_ldg(q, pts + (o & 0x7fffu));
        if (o >> 15) cached_neg(q);
        conv = false;
        --left;
      }
    } else if (stage == 1) {
      if (j < 5) {  // suffix scan of r
        if (lane + (1 << j) < 32) ql = lane + (1 << j);
      } else {  // the trees of w and r
        const int off = 16 >> (j - 5);
        xl = lane & 15;
        act = xl < off;
        ql = xl + off;
        if (lane < 16) {
          xs = qs = s.w;
          to_w = true;
        }
      }
    } else if (j < (uint32_t)sums) {  // the window's next chunk's A
      qg = rowpart + 2 * (lane * split + 1 + j);
    } else if (j < (uint32_t)sums + 5) {  // 32 A
      ql = lane;
    } else if (j < (uint32_t)pre) {  // a chunk's B
      qg = rowpart + 2 * (lane * split + j - sums - 5) + 1;
    } else if (j < (uint32_t)(pre + dbl)) {  // window `lane`: 8 lane
      act = j - pre < 8u * lane;              // doublings
      ql = lane;
    } else {  // halving tree over the windows
      const int off = 16 >> (j - pre - dbl);
      if (lane + off < 32) ql = lane + off;
    }
    if (conv) {
      Point p;
      if (qg)
        point_ldcg(p, qg);
      else if (ql >= 0)
        slot_load(p, qs, ql);
      else
        p = id;
      pt_to_cached(q, p);
    }
    slot_load(x, xs, xl);
    __syncwarp();  // every lane has read before any writes
    if (act) {
      pt_add_cached(x, x, q);
      slot_store(to_w ? s.w : s.a.r, xl, x);
    }
    __syncwarp();
  }
}

// out[i] = k_l * L[i] + k_r * R[i]; k holds k_l then k_r as 16-bit limbs.
// One warp a block, eight pairs a warp, a pair's point on four lanes
// (csrc/lanes.cuh): lane c of group p holds coordinate c of pair p's
// accumulator and component c of its three cached addends.
__global__ void __launch_bounds__(32)
    k_fold(const int32_t* __restrict__ L, const int32_t* __restrict__ R,
           const int32_t* __restrict__ k, int32_t* __restrict__ out,
           long long n) {
  const int lane = threadIdx.x, c = lane & 3, base = lane & ~3;
  const long long i0 = blockIdx.x * 8LL + (lane >> 2);
  const long long i = i0 < n ? i0 : n - 1;  // idle groups repeat a pair
  __shared__ uint32_t ks[16];  // k_l, k_r words (indexed by the bit)
  if (lane < 16)
    ks[lane] = (uint32_t)k[2 * lane] | ((uint32_t)k[2 * lane + 1] << 16);
  __syncwarp();
  const uint32_t *kl = ks, *kr = ks + 8;
  const Fe l = fe_load16(L + 64 * i + 16 * c);
  const Fe r = fe_load16(R + 64 * i + 16 * c);
  const Fe cr = q_cached(r, c, base);
  Fe lr = l;
  q_add_cached(lr, cr, c, base);
  const Fe cl = q_cached(l, c, base), clr = q_cached(lr, c, base);
  const int top = fold_top(kl, kr);
  Fe acc = fold_pick(fold_bits(kl, kr, top), c, l, r, lr);
#pragma unroll 1
  for (int bit = top - 1; bit >= 0; --bit) {
    q_double(acc, c, base);
    const int sel = fold_bits(kl, kr, bit);  // the same on every lane
    if (sel)
      q_add_cached(acc, fe_select(sel == 3, clr, fe_select(sel == 1, cl, cr)),
                   c, base);
  }
  if (i0 < n) fe_store16(out + 64 * i0 + 16 * c, acc);
}

// coordinate c of a point (its 16 limbs at p, 16-byte aligned) as four
// 16-byte loads through L2: scratch is read back in the kernel that wrote it
__device__ __forceinline__ Fe fe_ld4(const int32_t* p) {
  const int4* s = reinterpret_cast<const int4*>(p);
  int32_t l[16];
  for (int k = 0; k < 4; ++k) {
    const int4 v = __ldcg(s + k);
    l[4 * k] = v.x, l[4 * k + 1] = v.y, l[4 * k + 2] = v.z, l[4 * k + 3] = v.w;
  }
  return fe_load16(l);
}

__device__ __forceinline__ void fe_st4(int32_t* p, const Fe& a) {
  int32_t l[16];
  fe_store16(l, a);
  int4* d = reinterpret_cast<int4*>(p);
  for (int k = 0; k < 4; ++k)
    d[k] = make_int4(l[4 * k], l[4 * k + 1], l[4 * k + 2], l[4 * k + 3]);
}

// out[b] = sum_d in[d, b], the halving tree of tree_sum. One warp a block,
// eight columns a warp, a column's points on four lanes (lane c holds
// coordinate c). Levels of more than POINT_SUM_REGS points write their
// sums to scratch ((D + 1) / 2 points a column), in place from the
// second; a lane reads and writes only its own coordinate there. Idle
// groups repeat the last column and store nothing.
__global__ void __launch_bounds__(32)
    k_point_sum(const int32_t* __restrict__ in, int32_t* scratch,
                int32_t* __restrict__ out, long long D, long long B) {
  const int lane = threadIdx.x, c = lane & 3, base = lane & ~3;
  const long long b0 = blockIdx.x * 8LL + (lane >> 2);
  const long long b = b0 < B ? b0 : B - 1;
  const bool mine = b0 < B;
  const auto at = [&](const int32_t* src, long long i) {
    return src + 64 * (i * B + b) + 16 * c;
  };
  if (D == 1) {  // the sum is the point, limb for limb
    if (mine)
      for (int k = 0; k < 4; ++k)
        reinterpret_cast<int4*>(out + 64 * b + 16 * c)[k] =
            __ldg(reinterpret_cast<const int4*>(at(in, 0)) + k);
    return;
  }
  const Fe id = fe_coord_identity(c);
  const int32_t* src = in;
  long long n = D;
#pragma unroll 1
  while (n > POINT_SUM_REGS) {
    const long long h = (n + 1) / 2;
#pragma unroll 1
    for (long long i = 0; i < h; ++i) {
      Fe p = fe_ld4(at(src, i));
      q_add_pt(p, i + h < n ? fe_ld4(at(src, i + h)) : id, c, base);
      if (mine) fe_st4(scratch + 64 * (i * B + b) + 16 * c, p);
    }
    src = scratch;
    n = h;
  }
  // n = 2, 3 or 4: one pair (n = 2) or two, then their sum
  const bool two = n > 2;
  Fe s0 = fe_ld4(at(src, 0)), s1 = two ? fe_ld4(at(src, 1)) : id;
  const Fe q0 = fe_ld4(at(src, two ? 2 : 1)),
           q1 = n == 4 ? fe_ld4(at(src, 3)) : id;
  q_add_pt(s0, q0, c, base);
  q_add_pt(s1, q1, c, base);
  if (two) q_add_pt(s0, s1, c, base);
  if (mine) fe_st4(out + 64 * b + 16 * c, s0);
}

// out[i] = k * P[i]; k as 16-bit limbs (canonical, < l). One warp a block,
// eight points a warp, a point on four lanes.
__global__ void __launch_bounds__(32)
    k_scale(const int32_t* __restrict__ P, const int32_t* __restrict__ k,
            int32_t* __restrict__ out, long long n) {
  const int lane = threadIdx.x, c = lane & 3, base = lane & ~3;
  const long long i0 = blockIdx.x * 8LL + (lane >> 2);
  const long long i = i0 < n ? i0 : n - 1;  // idle groups repeat a point
  __shared__ uint32_t ks[8];  // k's words (indexed by the bit)
  if (lane < 8)
    ks[lane] = (uint32_t)k[2 * lane] | ((uint32_t)k[2 * lane + 1] << 16);
  __syncwarp();
  const int len = scale_len(ks);
  Fe add = fe_ld4(P + 64 * i + 16 * c), acc = fe_coord_identity(c);
#pragma unroll 1
  for (int bit = 0; bit < len; ++bit) {
    if (scale_bit(ks, bit))  // the same on every lane
      q_add_dbl(acc, add, c, base);
    else
      q_double(add, c, base);
  }
  if (i0 < n) fe_st4(out + 64 * i0 + 16 * c, acc);
}

extern "C" {

// at B rows: the chunks a window splits into (its warps) and the most
// points one launch takes
int msm_chunking(long long B, int* split, long long* most) {
  *split = B <= SPLIT_ROWS ? SPLIT : 1;
  *most = (long long)TILE * *split;
  return 0;
}

// points (N, 4, 16); scalars (B, N, 16) canonical limbs (< l); scratch:
// cached N x 128 B, dig B x 32 x N bytes, part B x 32 x split x 256 B
// (split from msm_chunking), done B int32; out (B, 4, 16). N <= the
// chunking's most points.
int msm_launch(const int32_t* points, const int32_t* scalars, void* cached,
               void* dig, void* part, int* done, int32_t* out, long long B,
               long long N, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  int split;
  long long most;
  msm_chunking(B, &split, &most);
  if (N > most) return (int)cudaErrorInvalidValue;
  const long long m = B * N > N ? B * N : (N > B ? N : B);
  if (m > 0)
    k_msm_prep<<<(unsigned)((m + 255) / 256), 256, 0, s>>>(
        points, scalars, (Cached*)cached, (int8_t*)dig, done, B, N);
  if (B > 0)
    k_msm_window<<<(unsigned)(B * MSM_NWIN * split), 32, 0, s>>>(
        (const Cached*)cached, (const int8_t*)dig, (Point*)part, done, out,
        N, split);
  return (int)cudaGetLastError();
}

// blocks (warps) of k_msm_window that fit on one SM (the occupancy
// calculator)
int msm_window_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, k_msm_window, 32, 0);
}

int fold_points_launch(const int32_t* L, const int32_t* R, const int32_t* k,
                       int32_t* out, long long n, void* stream) {
  if (n > 0)
    k_fold<<<(unsigned)((n + 7) / 8), 32, 0, (cudaStream_t)stream>>>(
        L, R, k, out, n);
  return (int)cudaGetLastError();
}

// in (D, B, 4, 16), D >= 1; scratch ((D + 1) / 2, B, 4, 16), used where
// D > POINT_SUM_REGS; out (B, 4, 16); all 16-byte aligned.
int point_sum_launch(const int32_t* in, int32_t* scratch, int32_t* out,
                     long long D, long long B, void* stream) {
  if (B > 0)
    k_point_sum<<<(unsigned)((B + 7) / 8), 32, 0, (cudaStream_t)stream>>>(
        in, scratch, out, D, B);
  return (int)cudaGetLastError();
}

// P (n, 4, 16), 16-byte aligned; k (16,) canonical limbs; out (n, 4, 16).
int scale_points_launch(const int32_t* P, const int32_t* k, int32_t* out,
                        long long n, void* stream) {
  if (n > 0)
    k_scale<<<(unsigned)((n + 7) / 8), 32, 0, (cudaStream_t)stream>>>(
        P, k, out, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
