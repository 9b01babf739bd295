#!/usr/bin/env python3
"""Drive spartan_parallel_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # the full run (a few minutes)
    python3 chip_smoke.py --log-cons 16   # a smaller NIZK in phase 4

Phases, each printing one JSON line:
  1. the card (nvidia-smi name and power limit) and the build of the
     seven CUDA kernel sources and the fp_chain measurement kernel
     (csrc/*.cu, one nvcc per source, in parallel);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes its path gives it (exact equality; points after ristretto
     compression), with the kernel's time (`ms`, a call on CUDA events,
     and `launch_ms`, its launches' device time alone), the plain
     version's time and the least time the card could take (bound_ms):
     the NIZK's kernels at
     2^20 (K1's elementwise kernels, bind and dot, the dot one launch a
     call; K1's eq table, one launch a call, also at 2^10 and 2^14; K4's
     fused rounds, and K4 across a whole 2^20 sumcheck of each phase: `sc_p1_rounds`,
     `sc_p2_rounds`), and the data-parallel proof's (K4's x, q, w and p
     rounds, K5 for one class in each of its forms and for every class
     of a round in one launch, eq_fold, pc_bind, the ABC combination) at
     the shapes of the runs of phases 5 and 6, and SPARK's (K6's tree
     kernel over the whole stack of ops trees and its first launch alone,
     its round kernel as a layer's first round, a bound round and a
     layer's last bind, with and without the dot-product stack, the hash
     layer, one launch a call, also as the read and write hash of three
     matrices) at the shapes of the 2^20 SNARK of phase 7; after phase 8,
     K1's dot of a list of tables (`fq_dot_many`), K5's round of every
     class, K3's batched products (every matrix of a call in one launch:
     the largest Az/Bz/Cz call, phase-2 table call and multi_evaluate)
     and K7's evaluation of ShiftProofs' tables (one launch), at the
     largest shapes find_min's run gave them, on its inputs;
  3. fixed tapes, proved on the card and on the CPU, whose serialized
     proofs must be identical and verify: the NIZK at 2^10 constraints x
     2^10 variables x 10 inputs (a tampered proof must fail), and the
     data-parallel R1CSProof at 16 x 16 x 4 with P = 3 instances executed
     [8, 2, 1] times (the classed layout) and P = 4 executed [2, 2, 2, 2]
     times (the dense layout), and the SpartanSNARK (SPARK) at 16 x 16 x 4;
  4. the NIZK at 2^20 x 2^20 x 10 inputs (the upstream README instance)
     on the card, under a fixed tape (phase 9 proves the same bytes on
     two ranks): prove, verify, reject a tampered proof, per-stage times,
     proof bytes, peak memory and each kernel's launches;
  5. the data-parallel R1CSProof of BASELINE config 4 (bench.py bench_dp
     at 2^20 sigma work): P = 4 blocks of 2^10 constraints x 2^10
     variables x 10 inputs, executed [512, 128, 32, 32] times (the
     q-size-classed prover), on the card: witness commits, prove, verify,
     reject a tampered proof, with the same report;
  6. the same with uniform counts [256] x 4 (the dense prover);
  7. the upstream single-instance SNARK with SPARK on the card, encode ->
     prove -> verify under a fixed tape, at BASELINE config 2 (2^16 x 2^16
     x 10 inputs) and at the upstream README instance (2^20 x 2^20 x 10
     inputs, 2^20 non-zeros per matrix): upstream's stage Timers, the SAT
     and eval proof bytes beside upstream's, the proof's sha256, peak
     memory, launches, and a proof with one claimed evaluation changed
     must be rejected; the 2^20 SNARK is proved a second time, traced,
     and its launches must show K6 as designed (`product_layers`: one
     pt_round launch a product-layer round, one pt_fold a layer with
     rounds, no launch under a circuit's evaluate, at most 3 for the
     dot-product circuits' evaluations);
  8. the 9-stage data-parallel SNARK at the find_min shape of BASELINE.md
     section B (examples.build_synthetic_zkvm: 9 blocks of 8,192
     constraints executed 64/16/16/16/4/4/4/2/2 times), not cut: set-up
     with encode, prove, verify, and a wrong output must be rejected; the
     stage Timers under upstream's names beside upstream's prove and
     verify, proof bytes, peak memory and launches;
  9. the prover split over ranks (spartan_parallel_tpu_torch
     _dryrun_stages.launch: spawned processes in one torch.distributed
     group, each running p9_rank): two ranks sharing the card over gloo
     run the q-sharded phase-1 round at the dryrun tables (2, 8, 8), the
     sharded MSM at 1024 points x 1024 rows, the NIZK 2^20 (phase 4's
     tape; its first split round is the (1, 1, 2^20) round), config 4
     skewed (phase 5's) and the counter SNARK (phase 3's); four ranks as
     a 2 x 2 mesh the 2_nizk stage's NIZK (64 x 64 x 4); one rank over
     NCCL the round and the 2^10 NIZK (phase 3's), with every
     device-round loop under set_sync_debug_mode("error"). Every rank's
     proof must equal the single-rank proof byte for byte (rounds and
     MSM: the single-rank results computed here), and each sumcheck of a
     proof must have run its expected number of rounds on split tables;
     each line gives the per-rank prove seconds, K2/K4/K5/K11/K12
     launches, split rounds, collectives and their seconds, and the
     backend;
 10. the last modules: `bullet_verify_cells` (every bullet verify of
     phases 3-8 kept the host branch: no K2 launch inside one); the
     bullet verifier at n = 2^14 (DotProductProofLog proved on the card,
     verified through the device branch, whose G_hat is K2 on the
     generators' copy on the card with K12 summing msm_dev's chunks, and
     through the host branch: equal G_hat, a tampered proof rejected, K2
     launched, both verifies' ms and G_hat's alone), then the K2 row at
     that shape (`msm_verify_16384`); `entry` (dryrun.entry() on the card
     equal to the CPU's plain versions, K4 and K1 launched); `dryrun`
     (dryrun.dryrun_multichip(2): the four stages, each a subprocess of
     two gloo ranks on the card under its cap, the ranks agreeing and
     launching each stage's kernels; a line a stage with its seconds).
Phase 2 holds K2 (the MSM) at every shape its paths launch: 1024 x 1024,
the NIZK 2^20's witness commit (1024 rows x 1025 points), the bullet
rounds' single rows of 514 ... 34 points (also at scalars of all-0x80
bytes) and, after phase 8, find_min's largest block commit (its shape
read from that run), each with its bound from the redesign's operations
and the first design's beside it; a line before phase 2 gives msm.cu's
ptxas registers, spills and shared memory and the window kernel's blocks
an SM, `ptxas_zk` the same for K8-K11 and k_fold with the stack
frames of the functions they call (K11 may keep at most K11_STACK_MAX
bytes), `ptxas_k4` for K4's twelve instances and K5's two, `ptxas_k1`
for K1's kernels, and `ptxas_k6` for K6's round, bind and tree kernels.
Phases 5, 7 and 8 count the calls of K5's round of every class
(pc_round), of _evaluate_many, of _hash_poly and of the four K3 methods
of R1CSInstance (multiply_vec_block, _classed,
compute_eval_table_sparse_disjoint_rounds, multi_evaluate), phase 8 also
of ShiftProofs.prove, and fail unless each took one launch (a classed
round also one eq_fold; a ShiftProofs.prove one K7 launch):
`launch_structure`.
Phases 4, 5, 6, 7 (2^20) and 8 time their proves untraced, then prove the same
tape once more under kernel_trace, whose CUDA events time every launch:
the lines give that run's prove seconds (`traced_prove_s`, the events'
cost beside `prove_s`), K2's, K11's and fold_points' launches and ms
inside its witness commits and proves (`k2`, `k11`, `fold`), every
kernel's, summed over its launches (`by_kernel`), and every caller's
(`by_caller`: a launch under the counter its wrapper counted it under
too, K1's eq_fold, pc_bind, hash_poly, abc_comb, dotp_eval, or else
under the first function outside ops/ that made it), K1's, K3's, K5's
and K7's sums (`groups`), and the launches that found the card idle
(`starved`: their ms hold the host's time up to the launch).
Phase 2 starts with `fp_chain`: csrc/fp_chain.cu runs a 4096-step
dependent chain of field products on one warp for fp.cuh's product as
K9-K11 called it, inlined, fe.cuh's product and squaring, fp10.cuh's
ten-lane product and squaring (the ENCODE's) and fq.cuh's Montgomery
product, checks each chain against Python's pow and prints ns per
product. fold_points is held at every pair count the bullet rounds
launch (512 ... 32) and at 8; a `chain_products` line gives the
dependent products on the critical path of K11, the fold, K12 (a column,
at each phase-2 D) and K13 (a point, at the timed k) in the one-thread
designs and in these, counted from the code.
Phase 2 also holds K7's powers (fq_powers, on no main path) and the rlc
dot K1 ran before at the find_min path's shape and the powers at 2^20,
and the device-resident ZK sumcheck round's kernels: K8 (Keccak-f[1600], 4096
states; a check kernel, its code runs on the path inside K11), K9
(ristretto ENCODE) and K10 (comb commitments) at the NIZK 2^20's shapes
(a sumcheck's 20 deltas of 4 G + h and its claim of G + h) and at 4096
points and 1024 commitments, K11 (one round tail), K12 (the sum of
the sharded MSM's per-rank partials, at two and four ranks) and K13
(k * P at 32 and 4096 points; no path calls it). Phase 3 also
proves the 9-stage SNARK of the counter program, and the memory fixture
tests/fixtures/counter_mem_bin.{ctk,rtk} read by the port's driver (as it
is, and with its inputs widened to 5, which its virtual memory needs to
verify), on the card and on the CPU, with identical bytes. In phase 3 the
card proves with device-resident rounds and the CPU with the host loop,
and each card proof must have launched K11 once per ZK sumcheck round;
from phase 3 on every device-round loop runs under
torch.cuda.set_sync_debug_mode("error") (a host sync inside a sumcheck
fails the run). Phases 5 (config 4 skewed) and 8 (find_min) prove under a
fixed tape and again with the host loop on the card (`host_loop`): the
bytes must be equal; both prove times are printed. Phase 8 proves with
device rounds again after the host loop (the first prove of a call is
slower), then once more in each form with each stage's SAT and eval
proofs timed.
Each of phases 4-8 and 10 sets the launch counts to 0 before each run
and reads them after (phase 9's and the dry run's ranks before and after
each job); every kernel row
but the NO_PATH ones must have been launched on its path (`launches`;
`launches_by_path`: its counter's launches on every path that made
some). Then the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero before that.

Needs a CUDA card and the repository beside this script; imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Peak rates of one H100 SXM (NVIDIA data sheet): 3.35 TB/s of HBM, and
# 32-bit integer multiply-adds at 64 lanes per SM (half the 128 fp32
# lanes behind the 67 TFLOP/s fp32 figure): 132 SMs x 64 x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
# 32-bit multiply instructions per 256-bit product (a 32x32->64 product is
# a mul.lo and a mul.hi): mod p, 64 partial products and the fold by 38;
# mod l (Montgomery), 64 for the product and 64 for the reduction.
IMAD_FP_MUL = 2 * 64 + 2 * 8
IMAD_FQ_MUL = 2 * 128
FP_MUL_PER_ADD = 9
FP_MUL_PER_DOUBLE = 8
# phase 2: log2 of the K1/K3/K4 tables (the NIZK's 2^20), timing repeats
LOG_KERNEL = 20
REPS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, imads: float):
    """(bound_ms, bound_by) from the bytes moved and the multiplies."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = imads / IMAD_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def p1_muls(pairs: int, lines: int) -> int:
    """Field products a phase-1 round's evaluations need: e (B C - D) at
    t = 0, 2, 3 for each pair (6), and for each line along the bound axis
    the product of the other two axes' eq factors and the scale of the
    line's three sums by it (4)."""
    return 6 * pairs + 4 * lines


def p2_muls(pairs: int, lines: int, p_axis: bool = False) -> int:
    """Phase 2: A Z at t = 0, 2, 3 for each pair (3) and the scale of each
    line's three sums by its eq_p (3); e A Z for each pair (6) when the
    bound axis is p, along which eq_p varies."""
    return 6 * pairs if p_axis else 3 * pairs + 3 * lines


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def wall_ms(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# --------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# --------------------------------------------------------------------------
def rand_field(shape, gen, dev):
    """Random canonical field limbs (< 2^252 < l) as Montgomery values."""
    import torch

    t = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=gen,
                      device=dev, dtype=torch.int32)
    t[..., 15] &= 0x0FFF
    return t


def field_err(a, b) -> int:
    return int((a.long() - b.long()).abs().max())


def point_err(a, b) -> int:
    """max |byte difference| of the ristretto encodings (0 = same points)."""
    from spartan_parallel_tpu_torch.ops import curve

    ea = [p.compress() for p in curve.decode_points(a)]
    eb = [p.compress() for p in curve.decode_points(b)]
    return max(max(abs(x - y) for x, y in zip(p, q)) for p, q in zip(ea, eb))


# --------------------------------------------------------------------------
# K2 (csrc/msm.cu): its shapes, its bound and the trace of its launches
# --------------------------------------------------------------------------
def digit_counts(scal):
    """(nonzero signed 8-bit digits, the sum over rows and windows of the
    largest |digit|, nonzero bytes) of (B, N, 16) canonical limbs (the
    signed recoding: ops/msm.py signed_digits)."""
    import torch

    from spartan_parallel_tpu_torch.ops import msm

    dig = msm.signed_digits(scal)
    by = torch.stack([scal & 0xFF, scal >> 8], -1)
    return (int((dig != 0).sum()), int(dig.abs().amax(1).sum()),
            int((by != 0).sum()))


def k2_work(scal, n: int):
    """(bytes, 32-bit multiplies, extra) of K2 on (B, N, 16) scalars.
    Bytes: the points, the scalars and the sums, once each. Multiplies:
    the least a signed 8-bit Pippenger MSM does on these inputs, 8 field
    products a point operation (a cached addition or a doubling): one
    addition a nonzero digit, the running sum's 2 m additions a row and
    window whose largest |digit| is m, and 248 doublings and 31 additions
    a row to combine the windows. extra: design_ms, the same bound for
    the operations csrc/msm.cu does (one product a point for its cached
    form; 8 a digit; per window and chunk (msm.chunking) the walk's 96
    running-sum additions (3 a lane) and the reduction's 191 (a
    129-addition suffix scan over the lanes, two 31-addition trees); per
    window of a row the combine's 2 chunks - 1 additions and 5
    doublings; sum_w 8 w = 3968 doublings a row and a 31-addition tree;
    those steps at 9 products, a cached addition and a conversion, but
    the doublings at 8 at split rows), and bound_ms_prev, the first
    design's formula (every nonzero byte digit's addition and a running
    sum of 2 x 256 additions a window at 9 products, Horner's 248
    doublings at 8 and 31 additions a row)."""
    from spartan_parallel_tpu_torch.ops import msm

    b = scal.shape[0]
    nz_signed, runs, nz_bytes = digit_counts(scal)
    nbytes = n * 256 + b * n * E_SCALAR + b * 256
    least = 8 * (nz_signed + 2 * runs + b * (248 + 31))
    split = msm.chunking(b)[0]
    steps = b * 32 * (split * (96 + 191) + 2 * split - 1 + 5) + b * 31
    design = n + 8 * nz_signed + 9 * steps \
        + (8 if split > 1 else 9) * b * 3968
    prev_adds = nz_bytes + b * 32 * 2 * 256 + b * 31
    prev = (prev_adds * FP_MUL_PER_ADD + b * 31 * 8 * FP_MUL_PER_DOUBLE)
    return nbytes, least * IMAD_FP_MUL, {
        "design_ms": bound(nbytes, design * IMAD_FP_MUL)[0],
        "bound_ms_prev": bound(nbytes, prev * IMAD_FP_MUL)[0]}


def edge_scalars(b: int, n: int, dev):
    """(b, n, 16) limbs whose bytes 0-30 are all 0x80 (each recodes to
    -128 or -127 with a carry) under a top byte of 0x0F (< l)."""
    import torch

    t = torch.full((b, n, 16), 0x8080, dtype=torch.int32, device=dev)
    t[..., 15] = 0x0F80
    return t


def record_msm(record, name, pts, scal, path, extra=None,
               replaces="spartan_parallel_tpu/ops/msm.py:189", edge=True):
    """One K2 row: msm_dev against msm_plain on (pts, scal), exact; at
    rows whose windows split into chunks also on edge_scalars, unless
    `edge` is false. The plain version takes seconds at every K2 shape:
    its time is that of the compared call (plain_once)."""
    from spartan_parallel_tpu_torch.ops import msm

    b, n = scal.shape[0], pts.shape[0]
    single = msm.chunking(b)[0] > 1
    if single and edge:
        e = edge_scalars(b, n, pts.device)
        err = point_err(msm.msm_dev(pts, e), msm.msm_plain(pts, e))
        if err:
            raise AssertionError(f"{name}: K2 disagrees with msm_plain at "
                                 f"all-0x80 bytes ({err})")
        extra = dict(extra or {}, also_exact_for="bytes 0-30 all 0x80")
    nbytes, imads, bounds = k2_work(scal, n)
    record(name, "msm.cu", replaces,
           lambda: msm.msm_dev(pts, scal), lambda: msm.msm_plain(pts, scal),
           point_err, nbytes, imads, reps_k=20 if single else 5,
           counter="msm_batched", path=path, plain_once=True,
           extra={"rows": b, "points": n, **bounds, **(extra or {})})


def check_msm_kernels(dev, gen, record, points):
    """K2 at the shapes of the NIZK 2^20: 1024 rows x 1024 points
    (msm_batched), its witness commit of 1024 rows x 1025 points (the
    blind's h column; msm_commit), the bullet rounds' single rows of
    n/2 + 2 = 514, 258, 130, 66 and 34 points (msm_bullet_N); and
    1024 rows of 33 and of 1 point (msm_rows_N: the part of a row's time
    that does not grow with N); random canonical scalars."""
    for name, b, n in [("msm_batched", 1024, 1024),
                       ("msm_commit", 1024, 1025)] + \
            [(f"msm_bullet_{n}", 1, n) for n in (514, 258, 130, 66, 34)] + \
            [(f"msm_rows_{n}", 1024, n) for n in (33, 1)]:
        record_msm(record, name, points[:n], rand_field((b, n), gen, dev),
                   "nizk")


def ptxas_kernels(log: str) -> dict:
    """Each kernel of one `nvcc -Xptxas -v` log: registers, spill bytes,
    stack frame, cumulative stack (with its callees) and static shared
    memory; the __noinline__ device functions' frames under
    "functions"."""
    out, cur, funcs = {}, None, {}

    def short(name):
        z = re.match(r"_Z(\d+)", name)  # a C++ name: _Z<len><name>...
        if not z:
            return name
        base = name[z.end():z.end() + int(z.group(1))]
        # template arguments: I L<type><value>E ... E
        t = re.match(r"I((?:L[a-z]+\d+E)+)E", name[z.end() + int(z.group(1)):])
        if t:
            base += "<" + ",".join(re.findall(r"L[a-z]+(\d+)E",
                                              t.group(1))) + ">"
        return base

    entry = None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            entry = m.group(1)
            cur = out.setdefault(short(entry), {})
            continue
        m = re.search(r"Function properties for (\w+)", ln)
        if m:
            cur = (out.setdefault(short(entry), {}) if m.group(1) == entry
                   else funcs.setdefault(short(m.group(1)), {}))
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack_bytes=int(m.group(1)),
                       spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and entry is not None:
            k = out.setdefault(short(entry), {})
            k["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            k["smem_bytes"] = int(sm.group(1)) if sm else 0
            cs = re.search(r"(\d+) bytes cumulative stack size", ln)
            k["cumulative_stack_bytes"] = int(cs.group(1)) if cs else 0
    if funcs:
        out["functions"] = funcs
    return out


# the kernels whose launches traced() sums by name (their counters), and
# the launch arguments that give a launch's shape
TRACED = {"k2": "msm_batched", "k11": "zk_round_tail", "fold": "fold_points"}
SHAPE_ARGS = {"msm_launch": (7, 8), "zk_round_tail_launch": (1,),
              "fold_points_launch": (4,)}


class KernelTrace:
    """Every kernel launch (ops/kernels.py launch, by its counter), timed
    by CUDA events, with the stage Timers (utils/timer.py) open around it;
    K2's (rows, points), K11's table sets and fold_points' pairs as its
    shape; and its caller: the counter its wrapper counted it under too
    (K1's callers eq_fold, pc_bind, hash_poly, dotp_eval,
    abc_comb, ...: the `counter=` of ops/fq.py) or, with none, the first
    function outside ops/ on the stack ("@file:function"). The events
    cost each launch two records on the stream: time the path in a run
    without a trace."""

    def __init__(self):
        self.launches, self.open = [], []
        self.in_launch = False

    def summary(self, stage=None, kernel="k2") -> dict:
        """Launches, ms and ms by shape of `kernel`'s launches under
        `stage` (None: all)."""
        import torch

        torch.cuda.synchronize()
        out = {"launches": 0, "ms": 0.0, "by_shape": {}}
        for c in self.launches:
            if c["counter"] != TRACED[kernel] or (
                    stage is not None and stage not in c["stages"]):
                continue
            ms = c["ev"][0].elapsed_time(c["ev"][1])
            key = "x".join(str(d) for d in c["shape"])
            n, t = out["by_shape"].get(key, (0, 0.0))
            out["by_shape"][key] = (n + 1, t + ms)
            out["launches"] += 1
            out["ms"] += ms
        return out

    def by_kernel(self, stage=None) -> dict:
        """(launches, ms) of each kernel counter under `stage`, the most
        time first: the time each kernel spends on the path, summed over
        its launches."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for c in self.launches:
            if stage is None or stage in c["stages"]:
                n, t = out.get(c["counter"], (0, 0.0))
                out[c["counter"]] = (n + 1,
                                     t + c["ev"][0].elapsed_time(c["ev"][1]))
        return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))

    def by_caller(self, stage=None) -> dict:
        """{caller: {kernel counter: (launches, ms)}} under `stage`, the
        callers by most time first: each launch's time under the caller
        that made it (see the class)."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for c in self.launches:
            if stage is None or stage in c["stages"]:
                k = out.setdefault(c["caller"] or c["site"], {})
                n, t = k.get(c["counter"], (0, 0.0))
                k[c["counter"]] = (n + 1,
                                   t + c["ev"][0].elapsed_time(c["ev"][1]))
        return dict(sorted(out.items(),
                           key=lambda kv: -sum(t for _, t in kv[1].values())))

    def starved(self, stage=None) -> dict:
        """{kernel counter: [launches, ms, host ms]} of the launches under
        `stage` whose start event the card had passed before the host
        enqueued the kernel: their ms hold the host's time from the start
        event to the launch (host ms) beside the kernel's."""
        import torch

        torch.cuda.synchronize()
        out = {}
        for c in self.launches:
            if c["starved"] and (stage is None or stage in c["stages"]):
                n, t, h = out.get(c["counter"], (0, 0.0, 0.0))
                out[c["counter"]] = (n + 1, t + c["ev"][0].elapsed_time(
                    c["ev"][1]), h + c["host_ms"])
        return out

    def largest(self, stage):
        """(rows, points) of the largest K2 launch under `stage`."""
        return max((c["shape"] for c in self.launches
                    if c["counter"] == TRACED["k2"] and stage in c["stages"]),
                   key=lambda s: s[0] * s[1])


@contextlib.contextmanager
def kernel_trace():
    import torch

    from spartan_parallel_tpu_torch.ops import kernels
    from spartan_parallel_tpu_torch.utils import timer

    tr = KernelTrace()
    init, stop = timer.Timer.__init__, timer.Timer.stop
    launch, count = kernels.launch, kernels.count
    ops_dir = os.sep + "ops" + os.sep

    def traced_init(self, label):
        init(self, label)
        tr.open.append(label)

    def traced_stop(self, sync=None):
        if self.label in tr.open:
            del tr.open[len(tr.open) - 1 - tr.open[::-1].index(self.label)]
        return stop(self, sync)

    def traced_launch(counter, entry, *args):
        f = sys._getframe(1)
        while f is not None and ops_dir in f.f_code.co_filename:
            f = f.f_back
        site = "@?" if f is None else \
            f"@{os.path.basename(f.f_code.co_filename)}:{f.f_code.co_name}"
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        starved = ev[0].query()  # the card is idle: it waits for the host
        tr.in_launch = True
        try:
            launch(counter, entry, *args)
        finally:
            tr.in_launch = False
        ev[1].record()
        tr.launches.append({
            "counter": counter, "ev": ev, "stages": tuple(tr.open),
            "shape": tuple(args[i] for i in SHAPE_ARGS.get(entry, ())),
            "caller": None, "site": site, "starved": starved,
            "host_ms": (time.perf_counter() - t0) * 1e3})

    def traced_count(name):
        # a wrapper's count of its caller follows its launch
        count(name)
        if not tr.in_launch and tr.launches and \
                tr.launches[-1]["caller"] is None:
            tr.launches[-1]["caller"] = name

    timer.Timer.__init__, timer.Timer.stop = traced_init, traced_stop
    kernels.launch, kernels.count = traced_launch, traced_count
    try:
        yield tr
    finally:
        timer.Timer.__init__, timer.Timer.stop = init, stop
        kernels.launch, kernels.count = launch, count


# the kernels whose counters kernel_groups sums: K1 (csrc/fq.cu), K3
# (csrc/spmv.cu), K5 (csrc/sumcheck.cu k_pc_round), K7 (csrc/uni.cu)
KERNEL_GROUPS = {
    "k1": lambda k: (k.startswith("fq_") and k != "fq_powers")
    or k in ("hash_poly", "eq_evals"),
    "k3": lambda k: k in ("spmv_batched", "eval_table", "sparse_eval"),
    "k5": lambda k: k.startswith("sc_pc_round"),
    "k7": lambda k: k in ("uni_evaluate", "fq_powers")}


def kernel_groups(by_kernel: dict) -> dict:
    """[launches, ms] of K1, K3, K5 and K7 from a by_kernel dict."""
    out = {}
    for key, mine in KERNEL_GROUPS.items():
        picked = [v for k, v in by_kernel.items() if mine(k)]
        out[key] = [sum(n for n, _ in picked), sum(t for _, t in picked)]
    return out


def traced(tr, stages) -> dict:
    """K2's, K11's and fold_points' summaries under each (key, stage),
    every kernel's launches and ms (`by_kernel`), K1's, K3's, K5's and
    K7's sums (`groups`), each caller's (`by_caller`) and the launches
    that found the card idle (`starved`)."""
    out = {kernel: {key: tr.summary(stage, kernel) for key, stage in stages}
           for kernel in TRACED}
    out["by_kernel"] = {key: tr.by_kernel(stage) for key, stage in stages}
    out["groups"] = {key: kernel_groups(bk)
                     for key, bk in out["by_kernel"].items()}
    out["by_caller"] = {key: tr.by_caller(stage) for key, stage in stages}
    out["starved"] = {key: tr.starved(stage) for key, stage in stages}
    return out


def check_kernels(log_n: int, dev, reps: int):
    import torch

    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.ops import curve, fq, kernels, spmv
    from spartan_parallel_tpu_torch.ops import limbs as lb
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    n = 1 << log_n
    E = 64  # bytes of one field element (16 int32 limbs)
    rows, paths = [], {}

    def record(name, source, replaces, kern, plain, err_fn, nbytes, imads,
               reps_k=reps, path="nizk", counter=None, extra=None,
               plain_once=False):
        """Time one kernel against its plain version (`ms`: a call on
        CUDA events; `launch_ms`: its launches' device time alone). Its
        launches are read later from `counter` (default: its name) in the
        run of `path`. plain_once: the plain version's time is that of the call
        whose result is compared (for plain versions that take seconds).
        nbytes and imads may be lists, one entry a launch of a sequence:
        bound_ms is then the sum of the launches' bounds."""
        got = kern()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = plain()
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        err = err_fn(got, want)
        ms = cuda_ms(kern, reps_k)
        # the device time of a call's launches alone (CUDA events right
        # around each launch, as kernel_trace takes them): ms also holds
        # the host's time between launches where the host is slower
        with kernel_trace() as tr:
            for _ in range(reps_k):
                kern()
        launch_ms = sum(t for _, t in tr.by_kernel().values()) / reps_k
        plain_ms = first_ms if plain_once else wall_ms(plain)
        if isinstance(nbytes, list):
            parts = [bound(b, o) for b, o in zip(nbytes, imads)]
            b_ms = sum(t for t, _ in parts)
            b_by = max(("bytes", "operations"), key=lambda k: sum(
                t for t, by in parts if by == k))
        else:
            b_ms, b_by = bound(nbytes, imads)
        row = {"name": name, "route": "cuda",
               "source": "spartan_parallel_tpu_torch/csrc/" + source,
               "replaces": replaces, "max_abs_err": err, "ms": ms,
               "launch_ms": launch_ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None, **(extra or {})}
        rows.append(row)
        paths[name] = (path, counter or name)
        emit({"phase": "kernel", **row})
        if err != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max_abs_err {err})")

    a = rand_field((n,), gen, dev)
    b = rand_field((n,), gen, dev)
    r = rand_field((), gen, dev)
    # fq_sub is on no main path (NO_PATH)
    for name, op, plain, line in (
            ("fq_mul", fq.mul, fq.mul_plain, 79),
            ("fq_add", fq.add, fq.add_plain, 83),
            ("fq_sub", fq.sub, fq.sub_plain, 88)):
        imads = n * IMAD_FQ_MUL if name == "fq_mul" else 0
        record(name, "fq.cu", f"spartan_parallel_tpu/ops/fq.py:{line}",
               lambda op=op: op(a, b), lambda plain=plain: plain(a, b),
               field_err, 3 * n * E, imads,
               extra={"off_path": NO_PATH[name]} if name in NO_PATH
               else None)
    record("fq_bind", "fq.cu", "spartan_parallel_tpu/ops/sumcheck.py:122",
           lambda: fq.bind(a, r, 0, n // 2),
           lambda: fq.bind_plain(a, r, 0, n // 2), field_err,
           2 * n * E, n // 2 * IMAD_FQ_MUL)
    before = kernels.launches.get("fq_dot", 0)
    fq.dot(a, b)
    per_call = kernels.launches.get("fq_dot", 0) - before
    if per_call != 1:
        raise AssertionError(f"fq_dot: {per_call} launches a call")
    record("fq_dot", "fq.cu", "spartan_parallel_tpu/ops/fq.py:193",
           lambda: fq.dot(a, b), lambda: fq.dot_plain(a, b), field_err,
           2 * n * E, n * IMAD_FQ_MUL, extra={"launches_a_call": per_call})

    # the eq table (one K1 launch a call): the NIZK's tau_x and rx tables
    # at 2^log_n, and 2^10 (its Hyrax openings' factored tables) and 2^14;
    # bytes: the table written and the challenges read; operations: one
    # product a doubled entry and the high factors' products
    from spartan_parallel_tpu_torch.models.dense_mlpoly import (
        eq_evals, eq_evals_plain,
    )

    for ell in (10, 14, log_n):
        rs = rand_field((ell,), gen, dev)
        before = kernels.launches.get("eq_evals", 0)
        eq_evals(rs, ell)
        per_call = kernels.launches.get("eq_evals", 0) - before
        if per_call != 1:
            raise AssertionError(f"eq_evals at 2^{ell}: {per_call} launches "
                                 f"a call")
        k = min(ell, 10)
        chunks = 1 << (ell - k)
        prods = chunks * ((1 << k) - 1 + max(ell - k - 1, 0))
        record("eq_evals" if ell == log_n else f"eq_evals_2_{ell}", "fq.cu",
               "spartan_parallel_tpu/models/dense_mlpoly.py:89",
               lambda rs=rs, ell=ell: eq_evals(rs, ell),
               lambda rs=rs, ell=ell: eq_evals_plain(rs, ell), field_err,
               ((1 << ell) + ell) * E, prods * IMAD_FQ_MUL,
               counter="eq_evals",
               extra={"ell": ell, "launches_a_call": per_call})

    # K2 at every shape its paths launch (check_msm_kernels)
    side = 1 << (log_n // 2)
    gens = MultiCommitGens(side, b"chip_smoke")
    pts = gens.device_points(dev)[:side]
    check_msm_kernels(dev, gen, record, gens.device_points(dev))
    # the bullet rounds fold with a full-width challenge and its inverse:
    # two random field elements below l, at every pair count the path
    # launches (512 down to 32 for a side of 1024) and at 8. k_fold forms
    # L + R and the three cached addends (11 products), then from the top
    # set bit doubles once a bit and adds once a bit set in kl | kr (8
    # products each): the least work of a joint double-and-add.
    kl, kr = fq.decode(rand_field((2,), gen, dev).cpu())
    top = max(kl, kr).bit_length() - 1
    adds = bin(kl | kr).count("1") - 1
    for half in (512, 256, 128, 64, 32, 8):
        pl, pr = pts[:half], pts[half:2 * half]
        fold_imads = half * (11 + (top + adds) * FP_MUL_PER_DOUBLE) \
            * IMAD_FP_MUL
        record("fold_points" + ("" if half == 512 else f"_{half}"),
               "msm.cu", "spartan_parallel_tpu/ops/curve.py:159",
               lambda pl=pl, pr=pr: curve.fold_points(pl, pr, kl, kr),
               lambda pl=pl, pr=pr: curve.fold_points_plain(
                   pl, pr, curve.scalar_limbs([kl, kr], dev)),
               point_err, 3 * half * 256, fold_imads, counter="fold_points",
               plain_once=True, extra={"pairs": half})
    # counted, not measured: the dependent products on the critical path
    # of K11, of one fold, of a K12 column and of a K13 point, in the
    # one-thread designs these replaced (old) and in these (new; a
    # four-lane addition 3 deep, a doubling 2, K13's set bit 3); the
    # fold's at this run's scalars, K13's at its timed k
    k13 = k13_scalar()
    k13_len, k13_adds = k13.bit_length(), bin(k13).count("1")
    emit({"phase": "chain_products", "counted_from": "the kernels' code",
          "zk_round_tail": K11_CHAIN,
          "fold_points": {"old": 253 * FP_MUL_PER_DOUBLE
                          + (adds + 2) * FP_MUL_PER_ADD,
                          "new": 4 + 2 * (top + adds),
                          "top_bit": top, "additions": adds},
          "point_sum": {f"D={d}": {"old": FP_MUL_PER_ADD * levels(d),
                                   "new": 3 * levels(d)}
                        for d, _ in K12_SHAPES},
          "scale_points": {"old": 253 * FP_MUL_PER_DOUBLE
                           + k13_adds * FP_MUL_PER_ADD,
                           "new": 2 * k13_len + k13_adds,
                           "bits": k13_len, "additions": k13_adds}})

    # K3 on the synthetic instance of 2^log_n constraints, one matrix a
    # call (a one-matrix stack: the NIZK's calls take its three at once);
    # bounds count the operand elements the entries gather, each once
    inst, _, _ = produce_synthetic_r1cs(1, [1], n, n, 10, device=dev)
    A = inst.A_list[0]
    csr, csc = A.stacks(dev)
    nnz = A.get_num_nz_entries()
    z = rand_field((1, 2 * n), gen, dev)
    rx = rand_field((n,), gen, dev)
    ry = rand_field((2 * n,), gen, dev)
    n_cols, n_rows = (spmv_operand(st, [1], [0], 1, (0, 0))
                      for st in (csr, csc))
    record("spmv_batched", "spmv.cu", "spartan_parallel_tpu/ops/spmv.py:52",
           lambda: spmv.spmv_batched(csr, z),
           lambda: spmv.spmv_plain(csr, z), field_err,
           4 * (nnz + n + 1) + nnz * E + n_cols * E + n * E,
           nnz * IMAD_FQ_MUL, extra={"operand_elements": n_cols})
    record("eval_table", "spmv.cu", "spartan_parallel_tpu/ops/spmv.py:71",
           lambda: spmv.eval_table(csc, rx),
           lambda: spmv.eval_table_plain(csc, rx), field_err,
           4 * (nnz + 2 * n + 1) + nnz * E + n_rows * E + 2 * n * E,
           nnz * IMAD_FQ_MUL, extra={"operand_elements": n_rows})
    record("sparse_eval", "spmv.cu", "spartan_parallel_tpu/ops/spmv.py:87",
           lambda: spmv.sparse_eval(csr, rx, ry),
           lambda: spmv.sparse_eval_plain(csr, rx, ry), field_err,
           8 * nnz + nnz * E + (n_rows + n_cols) * E + E,
           2 * nnz * IMAD_FQ_MUL, extra={"operand_elements": n_rows + n_cols})
    del inst, A, csr, csc

    # K4: phase 1 at X = n, phase 2 at W * Y = 2 n; a fused step (bind of
    # the previous round's challenge, then this round's evaluations): the
    # old tables' live entries read once, the new ones (half as long along
    # the axis) written once
    one = lb.to_device(fq.ONE_MONT, dev)[None]
    tx = rand_field((n,), gen, dev)
    B, C, D = (rand_field((1, 1, n), gen, dev) for _ in range(3))
    X = sck.MODE_X

    def p1(step):
        return step(one, one, tx, B, C, D, r, n // 2, n // 4,
                    mode_prev=X, mode=X)

    def cmp_step(got, want):
        return max(field_err(got[0], want[0]),
                   *(field_err(g, w) for g, w in zip(got[1], want[1])))

    record("sc_p1_round", "sumcheck.cu",
           "spartan_parallel_tpu/ops/sumcheck.py:260",
           lambda: p1(sck.p1_step), lambda: p1(sck.p1_step_plain), cmp_step,
           6 * n * E, (2 * n + p1_muls(n // 4, 1)) * IMAD_FQ_MUL)
    ABC = rand_field((1, 2, n), gen, dev)
    Z = rand_field((1, 2, n), gen, dev)

    def p2(step):
        return step(one, ABC, Z, r, n // 2, n // 4, mode_prev=X, mode=X,
                    single_inst=True)

    record("sc_p2_round", "sumcheck.cu",
           "spartan_parallel_tpu/ops/sumcheck.py:427",
           lambda: p2(sck.p2_step), lambda: p2(sck.p2_step_plain), cmp_step,
           6 * n * E, (2 * n + p2_muls(n // 2, 2)) * IMAD_FQ_MUL)

    # K4 across a whole 2^log_n sumcheck at these shapes: from the fused
    # round of the rows above (n_half 2^(log_n-1) bound, 2^(log_n-2)
    # pairs evaluated) every fused round down to n_half = 1, then the
    # final bind (K1); bound_ms sums the launches' bounds. The first
    # round's evaluations (no bind) come before these and are timed
    # beside them (`evals_round_ms`).
    rs = rand_field((log_n,), gen, dev)

    def whole(step, final, tabs):
        nh, evs = n // 2, []
        for j in range(log_n - 1):
            ev, tabs = step(tabs, rs[j], nh, nh // 2)
            evs.append(ev)
            nh //= 2
        return torch.stack(evs), final(tabs, rs[log_n - 1])

    def cmp_whole(got, want):
        return max(field_err(got[0], want[0]),
                   *(field_err(g, w) for g, w in zip(got[1], want[1])))

    def step_times(step, tabs):
        """One run of the fused rounds with CUDA events around each step
        (ms a step: the card's time while the host is ahead, the host's
        once the card waits for it) and the host's seconds to queue them
        all."""
        ev = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
              for _ in range(log_n - 1)]
        nh = n // 2
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for j in range(log_n - 1):
            ev[j][0].record()
            _, tabs = step(tabs, rs[j], nh, nh // 2)
            ev[j][1].record()
            nh //= 2
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        return {"step_ms": [a.elapsed_time(b) for a, b in ev],
                "host_enqueue_ms": host_ms}

    def rounds_bounds(tables, muls):
        """(bytes, multiplies) of each launch: a fused round reads the
        old live entries of `tables` tables and writes half as many; the
        final bind reads two entries of each and writes one."""
        nb, ni, live = [], [], n
        for _ in range(log_n - 1):
            nb.append(tables * (live + live // 2) * E)
            ni.append(tables * live // 2 + muls(live // 4))
            live //= 2
        nb.append(tables * 3 * E)
        ni.append(tables)
        return nb, [m * IMAD_FQ_MUL for m in ni]

    def p1_whole(plain):
        bind = fq.bind_plain if plain else fq.bind
        return whole(
            lambda t, r_, nh_prev, nh: (
                sck.p1_step_plain if plain else sck.p1_step)(
                    *t, r_, nh_prev, nh, X, X),
            lambda t, r_: t[:2] + tuple(
                bind(u, r_, 0 if i == 0 else 2, 1, 1)
                for i, u in enumerate(t[2:])),
            (one, one, tx, B, C, D))

    nb1, ni1 = rounds_bounds(4, lambda pairs: p1_muls(pairs, 1))
    record("sc_p1_rounds", "sumcheck.cu",
           "spartan_parallel_tpu/ops/sumcheck.py:260",
           lambda: p1_whole(False), lambda: p1_whole(True), cmp_whole,
           nb1, ni1, reps_k=5, counter="sc_p1_round",
           extra={"fused_rounds": log_n - 1, "final_bind": True,
                  "shape": [1, 1, n], "evals_round_ms": cuda_ms(
                      lambda: sck.p1_evals(one, one, tx, B, C, D, n // 2,
                                           X), reps),
                  **step_times(lambda t, r_, nh_prev, nh: sck.p1_step(
                      *t, r_, nh_prev, nh, X, X), (one, one, tx, B, C, D))})

    def p2_whole(plain):
        bind = fq.bind_plain if plain else fq.bind
        return whole(
            lambda t, r_, nh_prev, nh: (
                sck.p2_step_plain if plain else sck.p2_step)(
                    *t, r_, nh_prev, nh, X, X, True),
            lambda t, r_: (t[0],) + tuple(bind(u, r_, 2, 1, 1)
                                          for u in t[1:]),
            (one, ABC, Z))

    # Z and ABC: two lines of n entries each, 4 tables' worth of n
    nb2, ni2 = rounds_bounds(4, lambda pairs: p2_muls(2 * pairs, 2))
    record("sc_p2_rounds", "sumcheck.cu",
           "spartan_parallel_tpu/ops/sumcheck.py:427",
           lambda: p2_whole(False), lambda: p2_whole(True), cmp_whole,
           nb2, ni2, reps_k=5, counter="sc_p2_round",
           extra={"fused_rounds": log_n - 1, "final_bind": True,
                  "shape": [1, 2, n], "evals_round_ms": cuda_ms(
                      lambda: sck.p2_evals(one, ABC, Z, n // 2, X, True),
                      reps),
                  **step_times(lambda t, r_, nh_prev, nh: sck.p2_step(
                      *t, r_, nh_prev, nh, X, X, True), (one, ABC, Z))})
    check_dp_kernels(dev, gen, record, cmp_step, E)
    check_spark_kernels(log_n, dev, gen, record, E)
    check_uni_kernels(dev, gen, record, E)
    check_zk_kernels(dev, gen, record)
    check_parallel_kernels(dev, record, pts)
    return rows, paths, record


# K12's (D, B) rows
K12_SHAPES = ((2, 1024), (3, 1024), (4, 1024), (2, 512))


def k13_scalar() -> int:
    """K13's timed scalar: a seeded random k below l."""
    import numpy as np

    from spartan_parallel_tpu_torch.core.consts import L

    return int.from_bytes(np.random.default_rng(13).bytes(40), "little") % L


def levels(d: int) -> int:
    """The levels of tree_sum's halving tree over d points."""
    return (d - 1).bit_length()


# kernels that no main path launches: held against their plain versions
NO_PATH = {"scale_points": "no caller in the JAX package "
                           "(spartan_parallel_tpu/ops/curve.py:178)",
           "fq_sub": "its path launches were SPARK's hash layer, now "
                     "a kernel of its own (k_hash); fq.sub and fq.neg "
                     "still launch it",
           "fq_powers": "ShiftProofs evaluates its tables in one K7 launch "
                        "(uni_evaluate), which makes the powers in "
                        "registers",
           "rlc_eval": "its dot is fused into K7's uni_evaluate"}


def check_parallel_kernels(dev, record, pts):
    """The per-rank kernels of the sharded round and MSM at the shares
    their phase-9 runs give a rank; K12 (point_sum: the sum of the
    sharded MSM's per-rank partials) at (D, B) = (2, 1024) (the NIZK
    2^20's witness commit on two ranks),
    (3, 1024) (an odd level, the identity pad), (4, 1024) and (2, 512)
    (config 4's largest block commit on two ranks); K13 (scale_points)
    at 32 and 4096 points, held for k = 0, 1, l - 1 and timed at
    k13_scalar().
    Exact limbs: both follow the plain versions' order of additions.
    Bytes: the points read and written; operations: the additions
    (K12's halving tree, identity pads included) and K13's doublings up
    to k's top bit and popcount(k) additions."""
    import torch

    from spartan_parallel_tpu_torch.core.consts import L
    from spartan_parallel_tpu_torch.ops import curve

    from spartan_parallel_tpu_torch.ops import fq
    from spartan_parallel_tpu_torch.ops import limbs as lb
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    # the work of one of two ranks in the sharded round at the NIZK
    # 2^20's first phase-1 round, (1, 1, 2^20) split along x: K4's
    # evaluations on the rank's (1, 1, 2^19) share, and the exact sum of
    # the two ranks' (3, 16) evaluations (K1 fq_dot, mesh.sum_partials)
    E = 64  # bytes of one field element (16 int32 limbs)
    g = torch.Generator(device=dev)
    g.manual_seed(17)
    n = 1 << (LOG_KERNEL - 1)
    one = lb.to_device(fq.ONE_MONT, dev)[None]
    tx = rand_field((n,), g, dev)
    B, C, D = (rand_field((1, 1, n), g, dev) for _ in range(3))
    record("sc_p1_round_share", "sumcheck.cu",
           "spartan_parallel_tpu/parallel/mesh.py:68",
           lambda: sck.p1_evals(one, one, tx, B, C, D, n // 2, sck.MODE_X),
           lambda: sck.p1_evals_plain(one, one, tx, B, C, D, n // 2,
                                      sck.MODE_X), field_err,
           4 * n * E + 3 * E, p1_muls(n // 2, 1) * IMAD_FQ_MUL,
           counter="sc_p1_round", path="multi_device",
           extra={"share_of": [1, 1, 2 * n], "ranks": 2})
    parts = rand_field((2, 3), g, dev)
    record("sum_partials", "fq.cu", "spartan_parallel_tpu/parallel/mesh.py:68",
           lambda: fq.sum_reduce(parts, 0), lambda: fq.sum_plain(parts, 0),
           field_err, 9 * E, 6 * IMAD_FQ_MUL, counter="fq_dot",
           path="multi_device", extra={"ranks": 2})
    # one of two ranks' block of the sharded MSM at 1024 points x 1024
    # rows (the NIZK 2^20's witness commit): K2 on 512 points
    half = pts.shape[0] // 2
    record_msm(record, "msm_share", pts[:half],
               rand_field((2 * half, half), g, dev), "multi_device",
               extra={"share_of": [2 * half, 2 * half], "ranks": 2},
               replaces="spartan_parallel_tpu/parallel/msm_sharded.py:40")

    jax_curve = "spartan_parallel_tpu/ops/curve.py"
    for d, b in K12_SHAPES:
        name = "point_sum" if (d, b) == (2, 1024) else f"point_sum_{d}x{b}"
        parts = torch.stack([torch.roll(pts[:b], k, 0) for k in range(d)])
        adds, n = 0, d
        while n > 1:
            adds, n = adds + (n + 1) // 2, (n + 1) // 2
        record(name, "msm.cu", jax_curve + ":109",
               lambda parts=parts: curve.point_sum(parts),
               lambda parts=parts: curve.tree_sum(parts, 0), field_err,
               (d + 1) * b * 256, b * adds * FP_MUL_PER_ADD * IMAD_FP_MUL,
               counter="point_sum", path="multi_device",
               extra={"parts": d, "batch": b})
    k_rand = k13_scalar()
    for name, n in (("scale_points", 32), ("scale_points_4096", 4096)):
        p = torch.cat([torch.roll(pts, k, 0) for k in range(4)])[:n]
        p = p.contiguous()
        for k in (0, 1, L - 1):
            err = field_err(curve.scale_points(p, k), curve.scale_points_plain(
                p, curve.scalar_limbs([k], dev)[0]))
            if err:
                raise AssertionError(f"{name} at k = {k}: kernel disagrees "
                                     f"with its plain version ({err})")
        kl = curve.scalar_limbs([k_rand], dev)[0]
        ops = n * (k_rand.bit_length() * FP_MUL_PER_DOUBLE
                   + bin(k_rand).count("1") * FP_MUL_PER_ADD) * IMAD_FP_MUL
        record(name, "msm.cu", jax_curve + ":144",
               lambda p=p: curve.scale_points(p, k_rand),
               lambda p=p, kl=kl: curve.scale_points_plain(p, kl),
               field_err, 2 * n * 256 + E_SCALAR, ops, reps_k=5,
               counter="scale_points", plain_once=True,
               extra={"batch": n, "also_exact_for_k": ["0", "1", "l - 1"],
                      "off_path": NO_PATH["scale_points"]})


def classes_row(record, name, tp, tq, tx, classes, p0s, Ss, n_half, mode,
                prev, path, extra=None):
    """K5's round of every class in one launch (ops/sumcheck.py pc_round,
    a fused round: prev is the previous round's (r, mode, n_halves,
    activities)) against pc_round_plain. Bytes: each class's live entries
    read (two a new entry for a bind along an axis, one for the inactive
    scale) and its new tables written; operations: one product a bound
    entry and p1_muls for the evaluations."""
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    E = 64
    args = (tp, tq, tx, classes, p0s, Ss, n_half, mode, prev)
    want = sck.pc_round_plain(*args)
    nbytes = muls = 0
    for i, (T, active) in enumerate(zip(want[1], want[3])):
        m = T[0].numel() // 16
        scale = prev[1] == sck.MODE_Q and not prev[3][i]
        nbytes += 3 * ((1 if scale else 2) * m + m) * E
        pairs = m // 2 if active else m
        lines = m // T[0].shape[2] if mode == sck.MODE_X else \
            (T[0].shape[0] * T[0].shape[2] if active else T[0].shape[0])
        muls += 3 * m + p1_muls(pairs, lines)

    def same(got, w):
        err = field_err(got[0], w[0])
        if got[2:] != w[2:]:
            return 1 << 16
        for g, t in zip(got[1], w[1]):
            err = max([err] + [field_err(a, b) if a.shape == b.shape
                               else 1 << 16 for a, b in zip(g, t)])
        return err

    record(name, "sumcheck.cu", "spartan_parallel_tpu/ops/sumcheck.py:399",
           lambda: sck.pc_round(*args), lambda: sck.pc_round_plain(*args),
           same, nbytes,
           muls * IMAD_FQ_MUL, path=path, counter="sc_pc_round",
           plain_once=True,
           extra={"classes": [list(c[0].shape[:3]) for c in classes],
                  "n_half": n_half, "mode": "x" if mode == sck.MODE_X
                  else "q", "active": want[3], **(extra or {})})


def check_dp_kernels(dev, gen, record, cmp_step, E):
    """The data-parallel proof's kernels at the shapes of phases 5 and 6:
    P = 4 blocks, Q = 512 (skewed) or 256 (uniform) executions,
    X = Y = 2^10, W = 2. Bytes: each live table entry read once and each
    written entry written once (K4's and K5's fused steps write tables of
    the new live length); operations: the field products (one per bound
    entry, p1_muls / p2_muls for the evaluations)."""
    import torch

    from spartan_parallel_tpu_torch.models import r1csproof as rp
    from spartan_parallel_tpu_torch.ops import fq
    from spartan_parallel_tpu_torch.ops import limbs as lb
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    X, Q, P_, W = sck.MODE_X, sck.MODE_Q, sck.MODE_P, sck.MODE_W
    one = lb.to_device(fq.ONE_MONT, dev)[None]
    r = rand_field((), gen, dev)
    tp = rand_field((4,), gen, dev)
    src = "spartan_parallel_tpu/ops/sumcheck.py"

    def tabs(*shape):
        return tuple(rand_field(shape, gen, dev) for _ in range(3))

    # K4, phase 1 of the uniform run: a fused x round at (P, Q, X) =
    # (4, 256, 1024) (eq_p and eq_q read per row), then a fused q round
    # and the p evaluations at (4, 256, 1)
    tq = rand_field((256,), gen, dev)
    tx = rand_field((1024,), gen, dev)
    Bx = tabs(4, 256, 1024)
    n = 4 * 256 * 1024
    record("sc_p1_round_dp", "sumcheck.cu", f"{src}:260",
           lambda: sck.p1_step(tp, tq, tx, *Bx, r, 512, 256, X, X),
           lambda: sck.p1_step_plain(tp, tq, tx, *Bx, r, 512, 256, X, X),
           cmp_step, (3 * n + 3 * n // 2) * E + (4 + 256 + 1024 + 512) * E,
           (3 * n // 2 + 512 + p1_muls(n // 4, 1024)) * IMAD_FQ_MUL,
           path="dp_uniform",           counter="sc_p1_round")
    del Bx
    Bq = tabs(4, 256, 1)
    n = 4 * 256
    record("sc_p1_round_q", "sumcheck.cu", f"{src}:260",
           lambda: sck.p1_step(tp, tq, one, *Bq, r, 128, 64, Q, Q),
           lambda: sck.p1_step_plain(tp, tq, one, *Bq, r, 128, 64, Q, Q),
           cmp_step, (3 * n + 3 * n // 2) * E + (256 + 128 + 4 + 1) * E,
           (3 * n // 2 + 128 + p1_muls(n // 4, 4)) * IMAD_FQ_MUL,
           path="dp_uniform")
    record("sc_p1_round_p", "sumcheck.cu", f"{src}:250",
           lambda: sck.p1_evals(tp, tq, one, *Bq, 2, P_),
           lambda: sck.p1_evals_plain(tp, tq, one, *Bq, 2, P_),
           field_err, 3 * n * E + 260 * E, p1_muls(n // 2, 256) * IMAD_FQ_MUL,
           path="dp_uniform")
    # K4, phase 2 at (P, W, Y) = (4, 2, 1024), one ABC table per instance
    ABC, Z, _ = tabs(4, 2, 1024)
    n = 4 * 2 * 1024
    record("sc_p2_round_dp", "sumcheck.cu", f"{src}:427",
           lambda: sck.p2_step(tp, ABC, Z, r, 512, 256, X, X, False),
           lambda: sck.p2_step_plain(tp, ABC, Z, r, 512, 256, X, X, False),
           cmp_step, 3 * n * E + 4 * E,
           (n + p2_muls(n // 4, 8)) * IMAD_FQ_MUL, path="dp_uniform",
           counter="sc_p2_round")
    for name, mode in (("sc_p2_round_w", W), ("sc_p2_round_p", P_)):
        nh = 1 if mode == W else 2
        muls = p2_muls(n // 2, n // 2, mode == P_)
        record(name, "sumcheck.cu", f"{src}:270",
               lambda mode=mode, nh=nh: sck.p2_evals(tp, ABC, Z, nh, mode,
                                                     False),
               lambda mode=mode, nh=nh: sck.p2_evals_plain(tp, ABC, Z, nh,
                                                           mode, False),
               field_err, 2 * n * E + 4 * E, muls * IMAD_FQ_MUL,
               path="dp_uniform")

    # K5: the class rounds of the skewed run [512, 128, 32, 32], one class
    # a launch. Active x: the class (P_c, Q_c, X) = (1, 512, 1024) at p0 =
    # 0, S = 1, and the class of two blocks executed 32 times, (2, 32,
    # 1024) at p0 = 2, S = 16 (eq_q read at a stride); active q: the first
    # class after its x rounds, (1, 512, 1), and the block executed 128
    # times, (1, 128, 1) at p0 = 1, S = 4; inactive q: the last class,
    # (2, 1, 1) at p0 = 2. A fused step reads the live entries and writes
    # the new tables of the live length (half of them; the inactive
    # scale: all)
    tq = rand_field((512,), gen, dev)
    forms = (("x", X, True, tabs(1, 512, 1024), 0, 1, 512),
             ("xs", X, True, tabs(2, 32, 1024), 2, 16, 512),
             ("q", Q, True, tabs(1, 512, 1), 0, 1, 256),
             ("qs", Q, True, tabs(1, 128, 1), 1, 4, 64),
             ("qi", Q, False, tabs(2, 1, 1), 2, 16, 64))
    for form, mode, active, T, p0, S, nh in forms:
        n = T[0].shape[0] * T[0].shape[1] * T[0].shape[2]
        kw = dict(p0=p0, S=S, active=active)
        step = dict(mode_prev=mode, mode=mode, p0=p0, S=S,
                    active_prev=active, active=active)
        pairs = n // 2 if active else n  # evaluated pairs, unfused
        lines = n // T[0].shape[2 if mode == X else 1]
        written = n // 2 if active else n
        record(f"sc_pc_round_{form}", "sumcheck.cu", f"{src}:392",
               lambda T=T, nh=nh, mode=mode, kw=kw: sck.pc_evals(
                   tp, tq, tx, *T, nh, mode, **kw),
               lambda T=T, nh=nh, mode=mode, kw=kw: sck.pc_evals_plain(
                   tp, tq, tx, *T, nh, mode, **kw),
               field_err, 3 * n * E, p1_muls(pairs, lines) * IMAD_FQ_MUL,
               path="dp_skewed", counter="sc_pc_round")
        record(f"sc_pc_round_{form}_fused", "sumcheck.cu", f"{src}:399",
               lambda T=T, nh=nh, step=step: sck.pc_step(
                   tp, tq, tx, *T, r, nh, nh // 2, **step),
               lambda T=T, nh=nh, step=step: sck.pc_step_plain(
                   tp, tq, tx, *T, r, nh, nh // 2, **step),
               cmp_step, 3 * (n + written) * E,
               (3 * written
                + p1_muls(pairs // 2 if active else pairs, lines))
               * IMAD_FQ_MUL, path="dp_skewed", counter="sc_pc_round")
    # every class of a round in one launch: config 4's three classes in a
    # fused x round at the full x (live 1024 -> 512), and a q round of
    # the global n_half 2 in which the first class binds and evaluates q,
    # the second changes to inactive and the third scales
    classes = [tabs(1, 512, 1024), tabs(1, 128, 1024), tabs(2, 32, 1024)]
    classes_row(record, "sc_pc_round_classes", tp, tq, tx, classes,
                [0, 1, 2], [1, 4, 16], 256, X,
                (r, X, [512] * 3, [True] * 3), "dp_skewed")
    del classes
    classes = [tabs(1, 8, 1), tabs(1, 2, 1), tabs(2, 1, 1)]
    classes_row(record, "sc_pc_round_classes_q", tp, tq, tx, classes,
                [0, 1, 2], [1, 4, 16], 2, Q,
                (r, Q, [4, 1, 4], [True, True, False]), "dp_skewed")
    record("eq_fold", "fq.cu", f"{src}:302",
           lambda: sck.eq_fold(tx, r, 512),
           lambda: fq.bind_plain(tx, r, 0, 512), field_err,
           2 * 1024 * E, 512 * IMAD_FQ_MUL, path="dp_skewed")
    # the classes' last bind before the p rounds (models/sumcheck.py
    # merge): the first class's q pair, and an inactive class's scale
    Tm = tabs(1, 2, 1)
    record("pc_bind", "fq.cu", f"{src}:414",
           lambda: sck.pc_bind(*Tm, r, 1, Q, True),
           lambda: sck.pc_bind_plain(*Tm, r, 1, Q, True),
           lambda got, want: max(field_err(g, w) for g, w in zip(got, want)),
           3 * (2 + 2) * E, 3 * IMAD_FQ_MUL, path="dp_skewed")
    Ti = forms[-1][3]
    record("pc_bind_inactive", "fq.cu", f"{src}:414",
           lambda: sck.pc_bind(*Ti, r, 1, Q, False),
           lambda: sck.pc_bind_plain(*Ti, r, 1, Q, False),
           lambda got, want: max(field_err(g, w) for g, w in zip(got, want)),
           2 * 3 * 2 * E + E, 3 * 2 * IMAD_FQ_MUL, path="dp_skewed")

    # the phase-2 ABC table of P = 4 blocks: three (P, W, Y) eval tables;
    # the last block masked past 10 live inputs
    abc = tabs(4, 2, 1024)
    rabc = rand_field((3,), gen, dev)
    yperm = torch.as_tensor(sck.rev_perm(1024), device=dev)
    live = [1024, 1024, 1024, 10]
    n = 4 * 2 * 1024
    record("abc_comb", "fq.cu", "spartan_parallel_tpu/models/r1csproof.py:227",
           lambda: rp._abc_comb_dev(abc, rabc, live, yperm),
           lambda: abc_comb_plain(abc, rabc, live, yperm),
           field_err, 4 * n * E, 3 * n * IMAD_FQ_MUL, path="dp_uniform")


def check_spark_kernels(log_n: int, dev, gen, record, E):
    """SPARK's kernels at the shapes of the 2^log_n SNARK of phase 7 (the
    upstream instance at log_n = 20): 12 ops circuits of 2^log_n leaves
    (their first layer's tables (12, 2^(log_n - 1)) with one shared eq
    table, and the 6 dot-product circuits' (6, 2^(log_n - 1)) beside them)
    and 4 memory circuits of 2^(log_n + 1) cells (tables (4, 2^log_n)).
    K6's round kernel as the path launches it: a layer's first round
    (evaluations only: pt_cubic_round*), a bound round (pt_round*) and a
    layer's last bind (pt_fold, tables of 2); its tree kernel over the
    whole stack of ops trees (pt_tree) and its first launch alone
    (pt_layer_mul: the first layers of the stack). Bytes: each input read
    once, each output written once; operations: the field products (6 a
    pair and instance for a round's e0, e2, e3, one a bound entry, one a
    tree node)."""
    import torch

    from spartan_parallel_tpu_torch.models import sparse_mlpoly as sp
    from spartan_parallel_tpu_torch.ops import kernels
    from spartan_parallel_tpu_torch.ops import product as pk

    src = "spartan_parallel_tpu/models/product_tree.py"
    n = 1 << (log_n - 1)

    def tab_err(got, want):
        if got is None or want is None:
            return 0 if got is want else 1 << 16
        if not isinstance(got, (list, tuple)):
            return field_err(got, want)
        return max(tab_err(g, w) for g, w in zip(got, want))

    leaves = rand_field((12, 2 * n), gen, dev)
    plan = pk.tree_plan(2 * n)
    record("pt_tree", "product.cu", f"{src}:42",
           lambda: pk.pt_tree(leaves), lambda: pk.pt_tree_plain(leaves),
           tab_err, (12 * 2 * n + 12 * (2 * n - 1)) * E,
           12 * (2 * n - 1) * IMAD_FQ_MUL, path="snark",
           extra={"leaves": [12, 2 * n], "layers_a_launch": plan,
                  "launches_a_call": len(plan)})
    m = plan[0]
    written = 12 * (2 * n - (2 * n >> m))
    out = torch.empty((written, 16), dtype=torch.int32, device=dev)

    def first_layers_plain():
        layers = [leaves]
        for _ in range(m):
            layers.append(torch.cat(pk.layer_mul_plain(
                *torch.chunk(layers[-1], 2, 1)), 1))
        return torch.cat([t.reshape(-1, 16) for t in layers[1:]])

    def first_layers():
        pk.tree_step(leaves, out, m)
        return out

    record("pt_layer_mul", "product.cu", f"{src}:42", first_layers,
           first_layers_plain, field_err, (12 * 2 * n + written) * E,
           written * IMAD_FQ_MUL, path="snark", counter="pt_tree",
           extra={"leaves": [12, 2 * n], "layers": m})
    del out
    check_k6_choices(n, dev, gen, leaves)
    del leaves

    def rows(name, rows_, len_, seq_rows, bind, replaces):
        """A round (bind: a bound round) at (rows_, len_) with one shared
        C and seq_rows dot-product rows."""
        A, B = (rand_field((rows_, len_), gen, dev) for _ in range(2))
        C = rand_field((len_,), gen, dev)
        seq = tuple(rand_field((seq_rows, len_), gen, dev)
                    for _ in range(3)) if seq_rows else None
        coef = rand_field((rows_ + seq_rows,), gen, dev)
        r = rand_field((), gen, dev) if bind else None
        tables = 2 * rows_ + 1 + 3 * seq_rows
        pairs = (rows_ + seq_rows) * len_ // (4 if bind else 2)
        nbytes = (tables * len_ + (rows_ + seq_rows) + 3) * E
        muls = 6 * pairs
        if bind:
            nbytes += tables * len_ // 2 * E
            muls += tables * len_ // 2
        record(name, "product.cu", replaces,
               lambda: pk.pt_round(A, B, C, coef, r, seq),
               lambda: pk.pt_round_plain(A, B, C, coef, r, seq), tab_err,
               nbytes, muls * IMAD_FQ_MUL, path="snark", counter="pt_round",
               extra={"shape": [rows_, len_], "dot_product_rows": seq_rows,
                      "bound_first": bind})

    rows("pt_cubic_round", 12, n, 0, False, f"{src}:102")
    rows("pt_cubic_round_seq", 12, n, 6, False, f"{src}:119")
    rows("pt_cubic_round_mem", 4, 2 * n, 0, False, f"{src}:102")
    rows("pt_round", 12, n, 0, True, f"{src}:141")
    rows("pt_round_seq", 12, n, 6, True, f"{src}:141")
    rows("pt_round_mem", 4, 2 * n, 0, True, f"{src}:141")
    # the last bind of the ops proof's first layer: tables of 2
    A, B = (rand_field((12, 2), gen, dev) for _ in range(2))
    C = rand_field((2,), gen, dev)
    seq = tuple(rand_field((6, 2), gen, dev) for _ in range(3))
    r = rand_field((), gen, dev)
    tables = 2 * 12 + 1 + 3 * 6
    record("pt_fold", "product.cu", f"{src}:136",
           lambda: pk.pt_fold(A, B, C, r, seq),
           lambda: pk.pt_fold_plain(A, B, C, r, seq), field_err,
           (3 * tables + 1) * E, tables * IMAD_FQ_MUL, path="snark",
           extra={"shape": [12, 2], "dot_product_rows": 6})
    # the hash layer of 2^20 read timestamps: ts r^2 + val r + addr - rm,
    # one launch; then the read and the write hash of the three matrices'
    # (3, 2^20) read timestamps together, as Layers.hash_tables makes them
    addr, val, ts = (rand_field((2 * n,), gen, dev) for _ in range(3))
    ch = rand_field((3,), gen, dev)
    before = kernels.launches.get("hash_poly", 0)
    sp._hash_poly(addr, val, ts, *ch)
    per_call = kernels.launches.get("hash_poly", 0) - before
    if per_call != 1:
        raise AssertionError(f"hash_poly: {per_call} launches a call")
    record("hash_poly", "fq.cu",
           "spartan_parallel_tpu/models/sparse_mlpoly.py:289",
           lambda: sp._hash_poly(addr, val, ts, *ch),
           lambda: sp.hash_poly_plain(addr, val, ts, *ch), field_err,
           (4 * 2 * n + 3) * E, 2 * 2 * n * IMAD_FQ_MUL, path="snark",
           extra={"launches_a_call": per_call})
    del addr, val, ts
    addr, val, ts = (rand_field((3, 2 * n), gen, dev) for _ in range(3))
    record("hash_poly_rw", "fq.cu",
           "spartan_parallel_tpu/models/sparse_mlpoly.py:289",
           lambda: sp._hash_poly(addr, val, ts, *ch, write=True),
           lambda: sp.hash_poly_plain(addr, val, ts, *ch, write=True),
           lambda got, want: max(field_err(g, w) for g, w in zip(got, want)),
           (5 * 3 * 2 * n + 3) * E, 2 * 3 * 2 * n * IMAD_FQ_MUL,
           path="snark", counter="hash_poly",
           extra={"shape": [3, 2 * n], "write_hash": True})
    del addr, val, ts


def check_k6_choices(n: int, dev, gen, leaves):
    """The measurements behind two of K6's fixed choices, on the card:
    a first tree launch building 1 ... 4 layers of the 12 x 2n leaves
    (ms, and ms a layer: ops/product.py _PT_MAX_PASS), and a bound round
    at (12, n) and at (12, 2^10) with one shared C, with the product rows
    a work item takes (G) at 1 and at all 12 (ops/product.py _PT_ITEMS).
    Each launch held exactly against its plain version."""
    import torch

    from spartan_parallel_tpu_torch.ops import product as pk

    out = {"phase": "k6_choices", "tree_first_launch": {},
           "bound_round": {}}
    plain = [leaves]
    for m in range(1, pk._PT_MAX_PASS + 1):
        plain.append(torch.cat(pk.layer_mul_plain(
            *torch.chunk(plain[-1], 2, 1)), 1))
        buf = torch.empty((12 * (2 * n - (2 * n >> m)), 16),
                          dtype=torch.int32, device=dev)
        pk.tree_step(leaves, buf, m)
        if not torch.equal(buf, torch.cat([t.reshape(-1, 16)
                                           for t in plain[1:]])):
            raise AssertionError(f"tree launch of {m} layers disagrees")
        ms = cuda_ms(lambda: pk.tree_step(leaves, buf, m), REPS)
        out["tree_first_launch"][m] = {"ms": ms, "ms_a_layer": ms / m}
    del plain, buf
    items = pk._PT_ITEMS
    try:
        for length in (n, 1 << 10):
            A, B = (rand_field((12, length), gen, dev) for _ in range(2))
            C = rand_field((length,), gen, dev)
            coef = rand_field((12,), gen, dev)
            r = rand_field((), gen, dev)
            want = pk.pt_round_plain(A, B, C, coef, r)
            row = out["bound_round"][f"12x{length}"] = {}
            for G, target in ((1, 1 << 62), (12, 1)):
                pk._PT_ITEMS = target
                got = pk.pt_round(A, B, C, coef, r)
                if field_err(got[0], want[0]) or any(
                        field_err(g, w) for g, w in zip(got[1][:3],
                                                        want[1][:3])):
                    raise AssertionError(f"pt_round at G = {G} disagrees")
                row[f"G{G}_ms"] = cuda_ms(
                    lambda: pk.pt_round(A, B, C, coef, r), REPS)
    finally:
        pk._PT_ITEMS = items
    emit(out)


def check_uni_kernels(dev, gen, record, E):
    """K7's powers of one scalar (fq_powers, on no main path since
    ShiftProofs evaluates its tables in one launch) at find_min's largest
    shift table (the perm-exec w3 table of 8 x 128 = 1024 entries) and
    at 2^20, and the rlc dot on K1 that uni_evaluate ran before. Bytes:
    the table written once (the dot: both tables read once); operations:
    n - 1 field products (the dot: n)."""
    from spartan_parallel_tpu_torch.ops import fq, uni

    src = "spartan_parallel_tpu/models/dense_mlpoly.py"
    c = rand_field((), gen, dev)
    for name, n in (("fq_powers", 1024), ("fq_powers_2_20", 1 << 20)):
        record(name, "uni.cu", f"{src}:200",
               lambda n=n: uni.fq_powers(c, n),
               lambda n=n: uni.fq_powers_plain(c, n), field_err, n * E,
               (n - 1) * IMAD_FQ_MUL, path="findmin", counter="fq_powers",
               extra={"off_path": NO_PATH["fq_powers"]})
    n = 1024
    z = rand_field((n,), gen, dev)
    pw = uni.fq_powers(c, n)
    record("rlc_eval", "fq.cu", f"{src}:211",
           lambda: fq.dot(z, pw, 0, counter="rlc_eval"),
           lambda: fq.dot_plain(z, pw, 0), field_err, (2 * n + 1) * E,
           n * IMAD_FQ_MUL, path="findmin",
           extra={"off_path": NO_PATH["rlc_eval"]})


def spmv_operand(st, counts, mats, kk: int, x_strides) -> int:
    """The operand elements a spmv_many call reads: for each instance i
    and right-hand side q < counts[i], the distinct operand indices of
    its kk matrices' entries (offsets i xis + q xqs + idx, counted once
    where instances share them)."""
    import torch

    from spartan_parallel_tpu_torch.ops import spmv

    xis, xqs = x_strides
    offs = []
    for i, (c, m) in enumerate(zip(counts, mats)):
        cols = torch.unique(torch.cat([spmv.matrix(st, kk * m + k)[2]
                                       for k in range(kk)])).to(torch.int64)
        q = torch.arange(c, device=cols.device)
        offs.append((i * xis + q[:, None] * xqs + cols).reshape(-1))
    return int(torch.unique(torch.cat(offs)).numel())


def sparse_eval_operand(st) -> int:
    """The eq_rx and eq_ry elements a sparse_eval_many call reads: the
    distinct rows and the distinct columns of its stack's entries."""
    import torch

    return int(torch.unique(st.seg).numel() + torch.unique(st.idx).numel())


def spmv_work(st, counts, mats, kk: int, operand: int):
    """(bytes, 32-bit multiplies) the least a K3 call needs: each matrix
    it reads (pointer, indices, values) and the operand elements it
    gathers read once, each output written once, a product for each
    entry and right-hand side (spmv_many) or two for each entry
    (sparse_eval_many, mats None); operand: the distinct operand
    elements the call reads (spmv_operand, sparse_eval_operand)."""
    E = 64
    used = range(len(st.host)) if mats is None else sorted(
        {kk * m + k for m in mats for k in range(kk)})
    nnz = sum(int(st.host[m, 2]) for m in used)
    nbytes = 4 * (st.nseg + 1) * len(used) + nnz * (8 + E) + operand * E
    if mats is None:
        return nbytes + len(used) * E, 2 * nnz * IMAD_FQ_MUL
    prods = sum(c * int(st.host[kk * m + k, 2])
                for c, m in zip(counts, mats) for k in range(kk))
    return nbytes + kk * sum(counts) * st.nseg * E, prods * IMAD_FQ_MUL


def check_findmin_k3_k7(dev, record, largest):
    """K3's and K7's batched entries at the largest calls of find_min's
    run (phase 8), on the inputs that run gave them: spmv_many of the
    largest Az/Bz/Cz call (every matrix and right-hand side of it, counted
    as spmv_batched) and of the largest phase-2 table call (eval_table),
    sparse_eval_many of the largest multi_evaluate, and uni_eval_many of
    ShiftProofs' tables, each in one launch against its plain version."""
    import torch

    from spartan_parallel_tpu_torch.ops import spmv, uni

    jax_r1cs = "spartan_parallel_tpu/models/r1csinstance.py"
    for name, counter, line, caller in (
            ("spmv_many_findmin", "spmv_batched", 52,
             f"{jax_r1cs}:222/253 multiply_vec_block(_classed)"),
            ("eval_table_many_findmin", "eval_table", 71,
             f"{jax_r1cs}:280 compute_eval_table_sparse_disjoint_rounds")):
        st, x, out, counts, mats, kk, xs, os_, bits = largest[counter]
        got, want = torch.zeros_like(out), torch.zeros_like(out)
        nbytes, imads = spmv_work(st, counts, mats, kk, spmv_operand(
            st, counts, mats, kk, xs))
        record(name, "spmv.cu", f"spartan_parallel_tpu/ops/spmv.py:{line}",
               lambda: spmv.spmv_many(st, x, got, counts, mats, kk, xs, os_,
                                      bits, counter=counter),
               lambda: spmv.spmv_many_plain(st, x, want, counts, mats, kk,
                                            xs, os_, bits),
               field_err, nbytes, imads, path="findmin", counter=counter,
               extra={"caller": caller, "instances": len(counts),
                      "right_hand_sides": counts, "segments": st.nseg,
                      "entries": int(sum(st.host[kk * m + k, 2]
                                         for m in mats for k in range(kk))),
                      "shape_from": "the largest call of phase 8"})
    st, rx, ry = largest["sparse_eval"]
    nbytes, imads = spmv_work(st, None, None, 0, sparse_eval_operand(st))
    record("sparse_eval_many_findmin", "spmv.cu",
           "spartan_parallel_tpu/ops/spmv.py:87",
           lambda: spmv.sparse_eval_many(st, rx, ry),
           lambda: spmv.sparse_eval_many_plain(st, rx, ry), field_err,
           nbytes, imads, path="findmin", counter="sparse_eval",
           extra={"caller": f"{jax_r1cs}:302 multi_evaluate",
                  "matrices": len(st.host),
                  "entries": int(st.host[:, 2].sum()),
                  "shape_from": "the largest call of phase 8"})
    tabs, c = largest["uni_evaluate"]
    n_all = sum(int(t.shape[0]) for t in tabs)
    record("uni_evaluate_many_findmin", "uni.cu",
           "spartan_parallel_tpu/models/dense_mlpoly.py:200",
           lambda: uni.uni_eval_many(tabs, c),
           lambda: uni.uni_eval_many_plain(tabs, c), field_err,
           (n_all + len(tabs)) * 64, (2 * n_all - len(tabs)) * IMAD_FQ_MUL,
           path="findmin", counter="uni_evaluate",
           extra={"caller": "spartan_parallel_tpu/models/snark.py "
                            "ShiftProofs.prove (+ dense_mlpoly.py:211)",
                  "tables": [int(t.shape[0]) for t in tabs],
                  "shape_from": "ShiftProofs.prove of phase 8"})


# 32-bit integer instructions of the device round's pieces: a Keccak-f
# round is ~155 64-bit logic operations (theta 55, rho-pi 24 rotations,
# chi 75, iota 1), two 32-bit ones each; ENCODE is ~285 products mod p
# (254 squarings and 11 products of the (p - 5) / 8 power, ~20 more).
INT_KECCAK = 24 * 155 * 2
FP_MUL_PER_ENCODE = 285
# STROBE permutations of one round (measured from the host transcript's
# bytes: ~15) and its scalar products mod l (interpolation, evaluation,
# weights, a, responses, canonical forms and challenge reductions: ~50)
KECCAK_PER_ROUND = 15
FQ_MUL_PER_ROUND = 50
E_SCALAR = 64  # bytes of one scalar (16 int32 limbs)
# the check kernel whose code the path runs inside another kernel
CHECK_ONLY = {"keccak_f1600": "zk_round_tail"}


COMB_WINDOWS = 64
# bytes of one comb table entry (a point: 4 coordinates x 16 int32 limbs)
COMB_ENTRY = 256


def comb_ops(n: int) -> int:
    """32-bit multiplies of one comb commitment of n generators: 64 (n - 1)
    window additions, 63 in the halving sum, n canonical forms."""
    adds = COMB_WINDOWS * (n - 1) + COMB_WINDOWS - 1
    return adds * FP_MUL_PER_ADD * IMAD_FP_MUL + n * IMAD_FQ_MUL


def comb_bytes(scalars) -> int:
    """Bytes a batch of comb commitments (scalars (B, n, 16) Montgomery)
    must move: each distinct table entry its nibbles pick once (a nibble
    0 picks the identity, which needs no read), the scalars and the
    points out."""
    import torch

    from spartan_parallel_tpu_torch.ops import ristretto_dev as rdev

    b, n = scalars.shape[:2]
    d = rdev._digits(scalars).long()  # (B, n, 64)
    gw = torch.arange(n * COMB_WINDOWS, device=d.device).view(n, -1)
    picked = (gw * 16 + d)[d != 0].unique().numel()
    return picked * COMB_ENTRY + b * n * 64 + b * COMB_ENTRY


def round_ops() -> int:
    """32-bit instructions of one round tail: four ENCODEs, the comb
    commitments of 4 G + h and three of G + h, the Keccak permutations and
    the scalar products."""
    return (4 * FP_MUL_PER_ENCODE * IMAD_FP_MUL + comb_ops(5)
            + 3 * comb_ops(2) + KECCAK_PER_ROUND * INT_KECCAK
            + FQ_MUL_PER_ROUND * IMAD_FQ_MUL)


def check_zk_kernels(dev, gen, record):
    """The device-resident ZK sumcheck round's kernels (K8-K11), at the
    NIZK 2^20's shapes: a sumcheck commits its claim (one commitment of
    G + h, one point compressed) and its rounds' deltas (LOG_KERNEL
    commitments of 4 G + h for phase 1's rounds, LOG_KERNEL points
    compressed) before its rounds, and K11 runs each round. K9 and K10
    are also timed at 4096 points and 1024 commitments, where the batch
    fills the card. K8 runs at 4096 states (a check kernel: its code runs
    inside K11); K11 for one round at the NIZK 2^20's first phase-1
    round (one table set, a transcript after an instance digest). Bytes:
    each tensor read or written once, and of a comb table the entries
    picked (comb_bytes; K11: 64 n entries for each of its four
    commitments, n = 5, 2, 2, 2); operations: 32-bit instructions, see
    the constants above. K11 runs on one block, so its row also gives
    one SM's share of the card's rate (bound_ms_one_sm)."""
    import torch

    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.ops import ristretto_dev as rdev
    from spartan_parallel_tpu_torch.ops import transcript_dev as tdev
    from spartan_parallel_tpu_torch.ops import zk_round as zkr
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    jax_ops = "spartan_parallel_tpu/ops/"
    n = 4096
    st = torch.randint(0, 256, (n, 200), generator=gen, device=dev,
                       dtype=torch.int32)
    record("keccak_f1600", "zk_round.cu", jax_ops + "transcript_dev.py:124",
           lambda: tdev.permute(st), lambda: tdev.permute_plain(st),
           field_err, 2 * n * 200 * 4, n * INT_KECCAK,
           extra={"runs_inside": CHECK_ONLY["keccak_f1600"]})
    tab_n = MultiCommitGens(4, b"gens_r1cs_sat").comb_tables(dev)
    tab_1 = MultiCommitGens(1, b"gens_r1cs_sat").comb_tables(dev)
    rounds = LOG_KERNEL
    # (name, table, batch): the path's two shapes, then the wide batch
    for name, tab, b in (("comb_commit", tab_n, rounds),
                         ("comb_commit_2", tab_1, 1),
                         ("comb_commit_1024x5", tab_n, 1024),
                         ("comb_commit_1024x2", tab_1, 1024)):
        k = tab.shape[0]
        sk = rand_field((b, k), gen, dev)
        if b > 1:
            sk[0] = 0  # a zero scalar picks only identity entries
        record(name, "zk_round.cu", jax_ops + "ristretto_dev.py:158",
               lambda tab=tab, sk=sk: rdev.comb_commit(tab, sk),
               lambda tab=tab, sk=sk: rdev.comb_commit_plain(tab, sk),
               point_err, comb_bytes(sk), b * comb_ops(k),
               counter="comb_commit", extra={"batch": b})
    sc = rand_field((n // 4, 5), gen, dev)
    pts = torch.cat([rdev.comb_commit(tab_n, sc)] * 4)
    for name, b in (("ristretto_compress", rounds),
                    ("ristretto_compress_1", 1),
                    ("ristretto_compress_4096", n)):
        p = pts[:b].contiguous()
        record(name, "zk_round.cu", jax_ops + "ristretto_dev.py:101",
               lambda p=p: rdev.compress(p),
               lambda p=p: rdev.compress_plain(p), field_err,
               b * (256 + 128), b * FP_MUL_PER_ENCODE * IMAD_FP_MUL,
               counter="ristretto_compress", extra={"batch": b})
    t = Transcript(b"nizk_example")
    t.append_message(b"R1CSInstanceDigest", b"\x07" * 64)
    evs = rand_field((1, 3), gen, dev)
    carry = torch.cat([rand_field((1,), gen, dev), torch.randint(
        0, 256, (2, 16), generator=gen, device=dev, dtype=torch.int32)])
    tape = torch.cat([rand_field((9,), gen, dev), torch.randint(
        0, 256, (2, 16), generator=gen, device=dev, dtype=torch.int32)])
    st0 = tdev.from_host(t, dev)

    def tail(fn):
        bufs = [st0.clone(), carry.clone(),
                torch.zeros((zkr.OUT_ROWS, 16), dtype=torch.int32,
                            device=dev)]
        fn(evs, bufs[0], bufs[1], tape, bufs[2], tab_n, tab_1)
        return torch.cat([b.flatten() for b in bufs])

    ops = round_ops()
    one_sm_ms = ops / (IMAD_PER_S / 132) * 1e3
    picked = COMB_WINDOWS * (5 + 2 + 2 + 2) * COMB_ENTRY
    record("zk_round_tail", "zk_round.cu", jax_ops + "zk_round.py:108",
           lambda: tail(zkr.zk_round_tail),
           lambda: tail(zkr.zk_round_tail_plain), field_err,
           (48 + 2 * 202 + 2 * 48 + 176 + 208) * 4 + picked, ops,
           extra={"bound_ms_one_sm": one_sm_ms,
                  "note": "one block: a round is a dependent chain on one "
                          "SM; bound_ms is the card's, bound_ms_one_sm one "
                          "SM's share"})


# The dependent products mod p and mod l on K11's critical path, counted
# from the code (the `chain_products` line). Before (one thread; its
# scalar steps' ~50 an estimate, FQ_MUL_PER_ROUND): four ENCODEs, and the
# comb sums' point additions at 9 products each: 4 G + h's 4 window
# additions and 6 halving levels, three of G + h at 1 + 6. After: Cy's
# and beta's ENCODEs side by side (three on the path); an addition on four
# lanes is 3 products deep; Cy's and beta's combs on 32 groups each (two
# windows, their sum, 5 levels); the scalar steps' independent products on
# separate lanes (csrc/zk_round.cuh): load 2 (interpolation, canonical
# form), poly 6 (a challenge's two halves side by side, 2; Horner 3;
# canonical 1), eval 9 (two challenges 4; target and r^3 2; a_i and
# a_i d_i 2; canonical 1), finish 3 (the challenge 2, z 1); the
# DotProductProof's canonical a_i run beside Cy's ENCODE.
# the most stack frame K11 may keep: its products and permutations run in
# registers, not through arrays in local memory
K11_STACK_MAX = 64
K11_CHAIN = {
    "old": {"fp": 4 * FP_MUL_PER_ENCODE + (4 + 6 + 3 * (1 + 6)) * 9,
            "fq": FQ_MUL_PER_ROUND},
    "new": {"fp": 3 * FP_MUL_PER_ENCODE + 3 * ((4 + 6) + (1 + 6) + 8),
            "fq": 2 + 6 + 9 + 3}}

# the chain variants of csrc/fp_chain.cu, in its order
FP_CHAIN_VARIANTS = ("fp_mul_noinline", "a_fp_mul_inline", "b_fe_mul",
                     "b_fe_sqr", "fq_mul_noinline", "bc_fp10_mul_lanes",
                     "bc_fp10_sqr_lanes")
FP_CHAIN_STEPS = 4096


def check_fp_chain(dev, card) -> dict:
    """The product of the chains (csrc/fp_chain.cu, on no path): each
    variant runs a 4096-step dependent chain of products on one warp (32
    chains; the ten-lane variants three, ten lanes each) and its result is
    checked against Python's pow; ns per product = time / steps, CUDA
    events over 3 launches after one warm-up. The product's second factor
    is the same at every step, so a compiler may read it once: the
    squarings (b_fe_sqr, bc_fp10_sqr_lanes) are the chain an ENCODE
    runs."""
    import random

    import torch

    from spartan_parallel_tpu_torch.core.consts import L, P
    from spartan_parallel_tpu_torch.ops import kernels
    from spartan_parallel_tpu_torch.ops import limbs as lb

    fn = kernels._lib("fp_chain").fp_chain_launch
    rng = random.Random(11)
    stream = torch.cuda.current_stream().cuda_stream
    ns = {}
    for v, name in enumerate(FP_CHAIN_VARIANTS):
        mod = L if name.startswith("fq") else P
        xs = [rng.randrange(mod) for _ in range(32)]
        b = rng.randrange(mod)
        x = torch.as_tensor(lb.ints_to_limbs(xs), device=dev)
        bt = torch.as_tensor(lb.ints_to_limbs([b])[0], device=dev)
        out = torch.empty_like(x)

        def run(v=v, x=x, bt=bt, out=out):
            rc = fn(v, x.data_ptr(), bt.data_ptr(), out.data_ptr(),
                    FP_CHAIN_STEPS, stream)
            if rc:
                raise RuntimeError(f"fp_chain_launch: CUDA error {rc}")

        ms = cuda_ms(run, 3)
        got = [int(sum(int(w) << (16 * k) for k, w in enumerate(row)))
               for row in out.cpu().numpy()]
        if name.endswith("_lanes"):  # a chain a group, from its first x
            xs = [xs[min(i - i % 10, 20)] for i in range(32)]
        if name.startswith("fq"):
            step = b * pow(1 << 256, -1, L) % L
            want = [y * pow(step, FP_CHAIN_STEPS, L) % L for y in xs]
        elif "sqr" in name:
            want = [pow(y, 1 << FP_CHAIN_STEPS, P) for y in xs]
        else:
            want = [y * pow(b, FP_CHAIN_STEPS, P) % P for y in xs]
        if got != want:
            raise AssertionError(f"fp_chain variant {name} is wrong")
        ns[name] = ms * 1e6 / FP_CHAIN_STEPS
    row = {"phase": "fp_chain", "card": card, "steps": FP_CHAIN_STEPS,
           "ns_per_product": ns}
    emit(row)
    return row


def abc_comb_plain(tabs, rabc, num_inputs, yperm):
    """models/r1csproof.py _abc_comb_dev from K1's plain versions."""
    from spartan_parallel_tpu_torch.ops import fq

    comb = fq.add_plain(fq.add_plain(fq.mul_plain(tabs[0], rabc[0]),
                                     fq.mul_plain(tabs[1], rabc[1])),
                        fq.mul_plain(tabs[2], rabc[2]))
    for p, ni in enumerate(num_inputs):
        comb[p, :, ni:] = 0
    return comb.index_select(2, yperm)


def warm_comb_tables(sat_gens, device) -> float:
    """Build the comb tables of the SAT proofs' sumcheck generators on the
    card (_dryrun_stages.warm_comb_tables: set-up, once per generator
    set). Returns its seconds."""
    from spartan_parallel_tpu_torch import _dryrun_stages as ds

    t0 = time.perf_counter()
    ds.warm_comb_tables(sat_gens, device)
    return time.perf_counter() - t0


# --------------------------------------------------------------------------
# Phases 3 and 4: the NIZK
# --------------------------------------------------------------------------
def nizk_run(log_cons: int, num_inputs: int, device, seed_tape: bool):
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.models.nizk import NIZK, NIZKGens
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.utils import timer
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    n = 1 << log_cons
    t0 = time.perf_counter()
    inst, vars_mat, inputs_mat = produce_synthetic_r1cs(
        1, [1], n, n, num_inputs, device=device)
    gens = NIZKGens(n, n, device=device)
    tables_s = warm_comb_tables([gens.gens_r1cs_sat], device)
    setup_s = time.perf_counter() - t0
    tape = RandomTape(b"proof", seed=b"\x05" * 32) if seed_tape else None
    timer.records.clear()
    t0 = time.perf_counter()
    proof = NIZK.prove(inst, vars_mat[0][0], inputs_mat[0][0], gens,
                       Transcript(b"nizk_example"), tape, device=device)
    prove_s = time.perf_counter() - t0
    stages = {k: timer.records.get(k) for k in (
        "instance_digest", "witness_commit", "prove_vec_mult",
        "prove_sc_phase_one", "prove_abc_gen", "prove_sc_phase_two",
        "polyeval")}
    t0 = time.perf_counter()
    proof.verify(inst, inputs_mat[0][0], gens, Transcript(b"nizk_example"),
                 device=device)
    verify_s = time.perf_counter() - t0
    return {"inst": inst, "gens": gens, "inputs": inputs_mat[0][0],
            "proof": proof, "bytes": ser.serialize(proof, "NIZK"),
            "compressed": ser.compressed_size(proof, "NIZK"),
            "setup_s": setup_s, "comb_tables_s": tables_s,
            "prove_s": prove_s, "verify_s": verify_s, "stages": stages}


def dp_run(num_proofs, log_cons: int, num_inputs: int, device,
           seed_tape: bool, around_prove=None):
    """The data-parallel R1CSProof of bench.py bench_dp: P blocks of
    2^log_cons constraints x 2^log_cons variables per witness section
    (vars and io), block p executed num_proofs[p] times. Commits the
    witness, proves (through around_prove(prove) when given) and
    verifies."""
    import torch

    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.models import r1csproof as rp
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.utils import timer
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    P, qmax, n = len(num_proofs), max(num_proofs), 1 << log_cons
    t0 = time.perf_counter()
    inst, vars_mat, inputs_mat = produce_synthetic_r1cs(
        P, num_proofs, n, n, num_inputs, seed=2, device=device)
    io_mat = [[[1] + list(io) + [0] * (n - 1 - len(io))
               for io in inputs_mat[p]] for p in range(P)]
    secs = [rp.ProverWitnessSecInfo.from_scalars([n] * P, m, device)
            for m in (vars_mat, io_mat)]
    del vars_mat, io_mat
    # gens cover the largest committed witness poly: Q_max * n
    gens = rp.R1CSGens(b"gens_r1cs_sat", n, qmax * n)
    tables_s = warm_comb_tables([gens], device)
    setup_s = time.perf_counter() - t0
    tape = RandomTape(b"proof", seed=b"\x0b" * 32) if seed_tape else \
        RandomTape(b"proof")
    timer.records.clear()

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    t0 = time.perf_counter()
    t_commit = timer.Timer("witness_commit")
    comms = [[s.poly_w[p].commit(gens.gens_pc, None)[0] for p in range(P)]
             for s in secs]
    t_commit.stop(device)
    commit_s = time.perf_counter() - t0
    def prove():
        return rp.R1CSProof.prove(P, qmax, num_proofs, n, [n] * P, secs,
                                  inst, gens, Transcript(b"dp_bench"), tape,
                                  device)

    t0 = time.perf_counter()
    proof, r = prove() if around_prove is None else around_prove(prove)
    sync()
    prove_s = time.perf_counter() - t0
    stages = {k: timer.records.get(k) for k in (
        "prove_z_mat_gen", "prove_vec_mult", "prove_sc_phase_one",
        "prove_abc_gen", "prove_z_gen", "prove_z_bind",
        "prove_sc_phase_two", "polyeval")}
    views = [rp.VerifierWitnessSecInfo(num_proofs, [n] * P, c)
             for c in comms]

    def verify(prf):
        _, bound = inst.multi_evaluate_bound_rp(r[0], r[2], r[3],
                                                device=device)
        return prf.verify(P, qmax, num_proofs, n, views, n, gens, bound,
                          Transcript(b"dp_bench"), device)

    t0 = time.perf_counter()
    if verify(proof) != r:
        raise AssertionError("the verifier returned another point")
    verify_s = time.perf_counter() - t0
    stages.update({k: timer.records.get(k) for k in (
        "verify_sc1", "verify_sc2", "verify_sc_commitment_opening")})
    raw = ser.serialize(proof, "R1CSProof")
    return {"bytes": raw, "verify": verify, "setup_s": setup_s,
            "comb_tables_s": tables_s, "commit_s": commit_s,
            "prove_s": prove_s, "verify_s": verify_s,
            "stages_s": stages,
            "compressed": ser.compressed_size(proof, "R1CSProof")}


def snark_run(log_cons: int, num_inputs: int, device, seed_tape: bool):
    """The upstream SNARK (models/snark_single.py) on the synthetic
    instance of 2^log_cons constraints x 2^log_cons variables per witness
    section (nnz = 2^log_cons per matrix): set-up, encode, prove,
    verify."""
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.models.snark_single import (
        SpartanSNARK,
        SpartanSNARKGens,
    )
    from spartan_parallel_tpu_torch.utils import timer
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    n = 1 << log_cons
    t0 = time.perf_counter()
    inst, vars_mat, inputs_mat = produce_synthetic_r1cs(
        1, [1], n, n, num_inputs, device=device)
    nnz = max(m.get_num_nz_entries()
              for m in inst.A_list + inst.B_list + inst.C_list)
    gens = SpartanSNARKGens(n, n, nnz)
    tables_s = warm_comb_tables([gens.gens_r1cs_sat], device)
    setup_s = time.perf_counter() - t0
    timer.records.clear()
    t0 = time.perf_counter()
    comm, decomm = SpartanSNARK.encode(inst, gens, device=device)
    encode_s = time.perf_counter() - t0
    tape = RandomTape(b"proof", seed=b"\x09" * 32) if seed_tape else None
    t0 = time.perf_counter()
    proof = SpartanSNARK.prove(inst, comm, decomm, vars_mat[0][0],
                               inputs_mat[0][0], gens,
                               Transcript(b"snark_example"), tape,
                               device=device)
    prove_s = time.perf_counter() - t0
    del decomm
    t0 = time.perf_counter()
    proof.verify(comm, inputs_mat[0][0], gens, Transcript(b"snark_example"),
                 device=device)
    verify_s = time.perf_counter() - t0
    stages = {k: timer.records.get(k) for k in (
        "SNARK::encode", "SNARK::prove", "R1CSProof::prove",
        "prove_vec_mult",
        "prove_sc_phase_one", "prove_abc_gen", "prove_sc_phase_two",
        "polyeval", "eval_sparse_polys",
        "R1CSEvalProof::prove", "commit_nondet_witness",
        "build_layered_network", "evalproof_layered_network",
        "SNARK::verify", "verify_sat_proof", "verify_eval_proof",
        "verify_prod_proof", "verify_hash_proof")}
    raw = ser.serialize(proof, "SpartanSNARK")
    return {"comm": comm, "gens": gens, "inputs": inputs_mat[0][0],
            "bytes": raw,
            "comm_bytes": ser.serialize(comm, "R1CSCommitment"),
            "proof_bytes": {
                "sat": len(ser.serialize(proof.r1cs_sat_proof, "R1CSProof")),
                "eval": len(ser.serialize(proof.r1cs_eval_proof,
                                          "R1CSEvalProof")),
                "total": len(raw)},
            "proof_bytes_compressed": {
                "sat": ser.compressed_size(proof.r1cs_sat_proof,
                                           "R1CSProof"),
                "eval": ser.compressed_size(proof.r1cs_eval_proof,
                                            "R1CSEvalProof"),
                "total": ser.compressed_size(proof, "SpartanSNARK")},
            "setup_s": setup_s, "comb_tables_s": tables_s,
            "encode_s": encode_s, "prove_s": prove_s,
            "verify_s": verify_s, "stages_s": stages}


# --------------------------------------------------------------------------
# Phases 3 and 8: the 9-stage SNARK
# --------------------------------------------------------------------------
FINDMIN_EXECS = (64, 16, 16, 16, 4, 4, 4, 2, 2)
# upstream's find_min run, single core, hardware unstated (BASELINE.md:49)
UPSTREAM_FINDMIN = {"prove_s": 67.508, "verify_s": 0.318}
FINDMIN_STAGES = ("SNARK::encode", "SNARK::prove", "inst_commit",
                  "block_sort", "witness_gen", "input_commit",
                  "Block Correctness Extract", "eval_sparse_polys",
                  "Pairwise Check", "Perm Root", "Perm Product",
                  "Shift Proofs", "IO Proofs", "R1CSProof::prove",
                  "R1CSEvalProof::prove", "SNARK::verify")


def zkvm_run(args, pa, device, tape_seed):
    """The 9-stage SNARK of one program: set-up with encode, prove under
    tape_seed (None: a fresh tape), verify, and a wrong output must be
    rejected."""
    from spartan_parallel_tpu_torch import examples as ex
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.core.consts import L
    from spartan_parallel_tpu_torch.utils import timer
    from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError

    timer.totals.clear()
    t0 = time.perf_counter()
    ctx = ex.setup_program_instances(args, pa, device=device)
    tables_s = warm_comb_tables(
        [ctx[k].gens_r1cs_sat for k in ("block_gens", "pairwise_gens",
                                        "perm_root_gens")], device)
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof = ex.prove_program(pa, ctx, tape_seed=tape_seed, device=device)
    prove_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex.verify_program(proof, pa, ctx, device=device)
    verify_s = time.perf_counter() - t0
    stages = {k: timer.totals.get(k) for k in FINDMIN_STAGES}
    try:
        ex.verify_program(proof, dict(pa, output=(pa["output"] + 1) % L),
                          ctx, device=device)
    except ProofVerifyError:
        pass
    else:
        raise AssertionError("a SNARK with a wrong output verified")
    raw = ser.serialize(proof, "SNARK")
    return {"bytes": raw, "compressed": ser.compressed_size(proof, "SNARK"),
            "setup_s": setup_s, "comb_tables_s": tables_s,
            "prove_s": prove_s, "verify_s": verify_s, "stages_s": stages,
            "ctx": ctx}


@contextlib.contextmanager
def host_loop():
    """Prove with the host round loop on the card inside: the reference
    the device-resident rounds are held against (the tables' device
    otherwise picks the form, models/sumcheck.py _device_rounds_on)."""
    from spartan_parallel_tpu_torch.models import sumcheck as msum

    pick = msum._device_rounds_on
    msum._device_rounds_on = lambda device: False
    try:
        yield
    finally:
        msum._device_rounds_on = pick


def zk_rounds(obj, seen=None) -> int:
    """The ZK sumcheck rounds of a proof: the round commitments of every
    ZKSumcheckInstanceProof inside it."""
    from spartan_parallel_tpu_torch.models.sumcheck import (
        ZKSumcheckInstanceProof,
    )

    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (bytes, bytearray, str, int)):
        return 0
    seen.add(id(obj))
    if isinstance(obj, ZKSumcheckInstanceProof):
        return len(obj.comm_polys)
    if isinstance(obj, (list, tuple)):
        return sum(zk_rounds(x, seen) for x in obj)
    if isinstance(obj, dict):
        return sum(zk_rounds(x, seen) for x in obj.values())
    names = list(getattr(obj, "__dict__", {}))
    for cls in type(obj).__mro__:
        names += list(getattr(cls, "__slots__", ()))
    return sum(zk_rounds(getattr(obj, n), seen) for n in names
               if hasattr(obj, n))


def product_proofs(obj, seen=None) -> list:
    """The rounds of each layer of every batched product proof
    (ProductCircuitEvalProofBatched) inside a proof, a list a proof."""
    from spartan_parallel_tpu_torch.models.product_tree import (
        ProductCircuitEvalProofBatched,
    )

    seen = set() if seen is None else seen
    if id(obj) in seen or isinstance(obj, (bytes, bytearray, str, int)):
        return []
    seen.add(id(obj))
    if isinstance(obj, ProductCircuitEvalProofBatched):
        return [[len(layer.proof.compressed_polys) for layer in obj.proof]]
    if isinstance(obj, (list, tuple)):
        return [p for x in obj for p in product_proofs(x, seen)]
    if isinstance(obj, dict):
        return [p for x in obj.values() for p in product_proofs(x, seen)]
    names = list(getattr(obj, "__dict__", {}))
    for cls in type(obj).__mro__:
        names += list(getattr(cls, "__slots__", ()))
    return [p for name in names if hasattr(obj, name)
            for p in product_proofs(getattr(obj, name), seen)]


# where a launch made by a circuit's evaluation would be traced from
EVALUATE_SITES = ("@product_tree.py:evaluate", "@product_tree.py:value",
                  "@product_tree.py:<lambda>")


def spark_k6_launches(proof, counts: dict, tr) -> dict:
    """K6 on a SPARK proof's path, from the launch counts: one pt_round
    launch a product-layer round, one pt_fold a layer with rounds, no
    launch under ProductCircuit.evaluate (the roots come from the tree
    kernel) and at most 3 for the dot-product circuits' evaluations of
    each SPARK proof (two batched product proofs: ops and memory)."""
    proofs = product_proofs(proof)
    layers = [n for p in proofs for n in p]
    want = {"pt_round": sum(layers),
            "pt_fold": sum(1 for n in layers if n)}
    got = {k: counts.get(k, 0) for k in want}
    evaluate = {c: v for c, v in tr.by_caller().items()
                if c in EVALUATE_SITES}
    dotp = counts.get("dotp_eval", 0)
    if got != want or evaluate or dotp > 3 * (len(proofs) // 2):
        raise AssertionError(f"K6 on the SPARK path: launches {got} for "
                             f"{want}, under evaluate {evaluate}, "
                             f"dot-product evaluations {dotp}")
    return {"product_proofs": len(proofs), "layers": len(layers),
            "rounds": sum(layers), **got, "dotp_eval": dotp,
            "pt_tree": counts.get("pt_tree", 0)}


@contextlib.contextmanager
def path_calls():
    """Counts the calls of the functions whose launches phases 5, 7 and 8
    hold to one a call (K5's round of every class, ops/sumcheck.py
    pc_round; SPARK's _evaluate_many and _hash_poly, K1; the four K3
    methods of R1CSInstance; ShiftProofs.prove, K7), and keeps the
    largest fused pc_round's and the largest _evaluate_many's arguments'
    shapes and the largest K3 and K7 calls' arguments (`largest`), for
    the rows phase 8 adds at find_min's shapes."""
    from spartan_parallel_tpu_torch.models import dense_mlpoly as dm
    from spartan_parallel_tpu_torch.models import r1csinstance as ri
    from spartan_parallel_tpu_torch.models import snark as sn
    from spartan_parallel_tpu_torch.models import sparse_mlpoly as sp
    from spartan_parallel_tpu_torch.ops import spmv
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    K3_METHODS = ("multiply_vec_block", "multiply_vec_block_classed",
                  "compute_eval_table_sparse_disjoint_rounds",
                  "multi_evaluate")
    calls = {"pc_round": 0, "evaluate_many": 0, "hash_poly": 0,
             "shift_proofs": 0, "largest": {}, "work": {},
             **{m: 0 for m in K3_METHODS}}
    saved = [(sck, "pc_round"), (sp, "_evaluate_many"), (sp, "_hash_poly"),
             (spmv, "spmv_many"), (spmv, "sparse_eval_many"),
             (dm, "uni_eval_many")] + [(ri.R1CSInstance, m)
                                       for m in K3_METHODS]
    before = [getattr(obj, name) for obj, name in saved]
    pc_round, evaluate_many, hash_poly, spmv_many, sparse_eval_many, \
        uni_eval_many = before[:6]
    shift_prove = sn.ShiftProofs.prove

    def keep(key, work, value):
        if work > calls["work"].get(key, -1):
            calls["work"][key] = work
            calls["largest"][key] = value

    def counted_pc_round(tp, tq, tx, tabs, p0s, Ss, n_half, mode,
                         prev=None):
        calls["pc_round"] += 1
        size = sum(T[0].numel() for T in tabs)
        big = calls["largest"].get("pc_round")
        if prev is not None and (big is None or size > big["entries"]):
            calls["largest"]["pc_round"] = {
                "entries": size, "eq_lens": [tp.shape[0], tq.shape[0],
                                             tx.shape[0]],
                "classes": [list(T[0].shape[:3]) for T in tabs],
                "p0s": list(p0s), "Ss": list(Ss), "n_half": int(n_half),
                "mode": mode, "prev": [prev[1], list(prev[2]),
                                       list(prev[3])]}
        return pc_round(tp, tq, tx, tabs, p0s, Ss, n_half, mode, prev)

    def counted_evaluate_many(polys, r):
        calls["evaluate_many"] += 1
        shape = [len(polys), int(polys[0].Zm.shape[0])]
        big = calls["largest"].get("evaluate_many")
        if big is None or shape[0] * shape[1] > big[0] * big[1]:
            calls["largest"]["evaluate_many"] = shape
        return evaluate_many(polys, r)

    def counted_hash_poly(*args, **kw):
        calls["hash_poly"] += 1
        return hash_poly(*args, **kw)

    def kept_spmv_many(st, x, out, counts, mats, kk, xs, os_, bits=(0, 0),
                       counter="spmv_batched"):
        keep(counter, sum(c * int(st.host[kk * m + k, 2] + st.nseg)
                          for c, m in zip(counts, mats) for k in range(kk)),
             (st, x, out, list(counts), list(mats), kk, xs, os_, bits))
        return spmv_many(st, x, out, counts, mats, kk, xs, os_, bits,
                         counter)

    def kept_sparse_eval_many(st, rx_tab, ry_tab):
        keep("sparse_eval", int(st.host[:, 2].sum()), (st, rx_tab, ry_tab))
        return sparse_eval_many(st, rx_tab, ry_tab)

    def kept_uni_eval_many(tables, c):
        keep("uni_evaluate", sum(int(t.shape[0]) for t in tables),
             (list(tables), c))
        return uni_eval_many(tables, c)

    def counted_method(name, fn):
        def method(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return method

    def counted_shift_prove(*args, **kw):
        calls["shift_proofs"] += 1
        return shift_prove(*args, **kw)

    for (obj, name), fn in zip(saved, [
            counted_pc_round, counted_evaluate_many, counted_hash_poly,
            kept_spmv_many, kept_sparse_eval_many, kept_uni_eval_many] + [
            counted_method(m, f) for m, f in zip(K3_METHODS, before[6:])]):
        setattr(obj, name, fn)
    sn.ShiftProofs.prove = staticmethod(counted_shift_prove)
    try:
        yield calls
    finally:
        for (obj, name), fn in zip(saved, before):
            setattr(obj, name, fn)
        sn.ShiftProofs.prove = staticmethod(shift_prove)


def launch_structure(calls, counts, classed: bool, spark: bool,
                     shift: bool = False) -> dict:
    """The launches a call of the redesigned pieces must take, against
    the calls counted by path_calls: a classed round is one K5 launch for
    all its classes and one eq_fold; _evaluate_many and _hash_poly are one
    launch a call; each of the four K3 methods one K3 launch a call
    (multiply_vec_block and _classed under spmv_batched,
    compute_eval_table_sparse_disjoint_rounds under eval_table,
    multi_evaluate under sparse_eval); with shift, a ShiftProofs.prove one
    K7 launch (uni_evaluate) and no fq_powers or rlc_eval. Raises when the
    run disagrees."""
    out = {}
    if classed:
        out["pc_round_calls"] = calls["pc_round"]
        out["sc_pc_round"] = counts.get("sc_pc_round", 0)
        out["eq_fold"] = counts.get("eq_fold", 0)
        if calls["pc_round"] == 0 or \
                out["sc_pc_round"] != calls["pc_round"] or \
                out["eq_fold"] != calls["pc_round"]:
            raise AssertionError(f"classed rounds: {out}")
    if spark:
        out["evaluate_many_calls"] = calls["evaluate_many"]
        out["evaluate_many"] = counts.get("evaluate_many", 0)
        out["fq_dot_many"] = counts.get("fq_dot_many", 0)
        out["hash_poly_calls"] = calls["hash_poly"]
        out["hash_poly"] = counts.get("hash_poly", 0)
        if calls["evaluate_many"] == 0 or calls["hash_poly"] == 0 or \
                out["evaluate_many"] != calls["evaluate_many"] or \
                out["fq_dot_many"] != calls["evaluate_many"] or \
                out["hash_poly"] != calls["hash_poly"]:
            raise AssertionError(f"SPARK's K1 calls: {out}")
    k3 = {"spmv_batched": calls["multiply_vec_block"]
          + calls["multiply_vec_block_classed"],
          "eval_table": calls["compute_eval_table_sparse_disjoint_rounds"],
          "sparse_eval": calls["multi_evaluate"]}
    out["k3_calls"] = k3
    out["k3"] = {k: counts.get(k, 0) for k in k3}
    if 0 in k3.values() or out["k3"] != k3:
        raise AssertionError(f"K3 calls: {out}")
    if shift:
        out["shift_proofs_calls"] = calls["shift_proofs"]
        out["k7"] = {k: counts.get(k, 0)
                     for k in ("uni_evaluate", "fq_powers", "rlc_eval")}
        if calls["shift_proofs"] == 0 or out["k7"] != {
                "uni_evaluate": calls["shift_proofs"], "fq_powers": 0,
                "rlc_eval": 0}:
            raise AssertionError(f"K7 calls: {out}")
    return out


def strict_round_loops(torch, stats):
    """Run every device-round loop (models/sumcheck.py _queue_rounds) on
    the card under torch.cuda.set_sync_debug_mode("error"): an operation
    inside a sumcheck's rounds that waits for the card raises."""
    from spartan_parallel_tpu_torch.models import sumcheck as msum

    queue = msum._queue_rounds

    def strict(modes, live, first, step, st, *rest):
        if st.device.type != "cuda":
            return queue(modes, live, first, step, st, *rest)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = queue(modes, live, first, step, st, *rest)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        stats["sumchecks"] += 1
        stats["rounds"] += len(modes)
        return out

    msum._queue_rounds = strict


SPLIT_STAGES = ("Block Correctness Extract", "Pairwise Check", "Perm Root")


@contextlib.contextmanager
def time_calls(torch):
    """Inside the block, time each R1CSProof.prove and R1CSEvalProof.prove
    call with the card synchronized around it, and place it in the 9-stage
    SNARK's stage whose Timer (models/snark.py) was opened last. Yields
    {stage: {"sat": [s, ...], "eval": [s, ...]}}; the original methods
    and Timer are put back on leaving."""
    from spartan_parallel_tpu_torch.models import snark
    from spartan_parallel_tpu_torch.models.r1csinstance import R1CSEvalProof
    from spartan_parallel_tpu_torch.models.r1csproof import R1CSProof

    log = {k: {"sat": [], "eval": []} for k in SPLIT_STAGES}
    stage = [None]
    timer_cls = snark.Timer

    class StageTimer(timer_cls):
        __slots__ = ()

        def __init__(self, label):
            super().__init__(label)
            if label in log:
                stage[0] = label

    def timed(cls, key):
        fn = cls.__dict__["prove"]

        def call(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn.__func__(*a, **k)
            torch.cuda.synchronize()
            log[stage[0]][key].append(time.perf_counter() - t0)
            return out
        cls.prove = staticmethod(call)
        return fn

    snark.Timer = StageTimer
    saved = [(cls, timed(cls, key)) for cls, key in (
        (R1CSProof, "sat"), (R1CSEvalProof, "eval"))]
    try:
        yield log
    finally:
        snark.Timer = timer_cls
        for cls, fn in saved:
            cls.prove = fn
    if any(len(v["sat"]) != 1 or not v["eval"] for v in log.values()):
        raise AssertionError(f"not one SAT proof and its eval proofs in "
                             f"each stage: {log}")


def profile_call(torch, fn, stats: dict):
    """fn() under torch.profiler; returns its result and puts into `stats`
    its wall time, the card's busy time (the sum of its kernels and
    copies), the idle share, and the eight kernels with the most device
    time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if us:
            dev_ms[e.key] = dev_ms.get(e.key, 0.0) + us / 1e3
    busy = sum(dev_ms.values()) / 1e3
    top = sorted(dev_ms.items(), key=lambda kv: -kv[1])[:8]
    stats.update({"wall_s": wall, "device_busy_s": busy,
                  "device_idle_share": 1 - busy / wall,
                  "top_kernels_ms": dict(top)})
    return out


def widen_inputs(ctk, rtk, niu):
    """The same program with niu unpadded inputs: the added inputs and
    outputs are always 0; every column past the old inputs moves up. The
    perm-root circuit reads a virtual-memory record's (data, ls, ts) as
    inputs, which needs niu >= 5."""
    import copy

    old = ctk.num_inputs_unpadded
    k = niu - old

    def col(c):
        return c if c <= old else (c + k if c < 2 * old else c + 2 * k)

    def row(r, width):
        out = [0] * width
        for c, v in enumerate(r):
            if v:
                out[col(c)] = v
        return out

    num_ios = 1 << (2 * niu - 1).bit_length()
    ctk, rtk = copy.deepcopy(ctk), copy.deepcopy(rtk)
    ctk.num_inputs_unpadded = niu
    ctk.args = [[tuple([(col(c), v) for c, v in side] for side in con)
                 for con in blk] for blk in ctk.args]
    ctk.input_liveness = list(ctk.input_liveness) + [False] * k
    rtk.input = list(rtk.input) + [0] * k
    rtk.exec_inputs = [row(r, num_ios) for r in rtk.exec_inputs]
    rtk.block_vars_matrix = [[row(r, len(r)) for r in blk]
                             for blk in rtk.block_vars_matrix]
    return ctk, rtk


def mem_fixture_run(niu, device):
    """tests/fixtures/counter_mem_bin.{ctk,rtk} read by the port's driver
    (widened to niu inputs unless None), set up and proved under a fixed
    tape; the widened program's proof must verify and reject a tampered
    witness commitment."""
    from spartan_parallel_tpu_torch import driver
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.core.edwards import RistrettoPoint
    from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape

    base = os.path.join(HERE, "tests", "fixtures", "counter_mem_bin")
    ctk = driver.CompileTimeKnowledge.from_file(base + ".ctk")
    rtk = driver.RunTimeKnowledge.from_file(base + ".rtk")
    if niu is not None:
        ctk, rtk = widen_inputs(ctk, rtk, niu)
    s = driver._setup(ctk, rtk, vars_bound=64, device=device)
    proof = driver._prove(ctk, rtk, s, RandomTape(b"proof",
                                                  seed=b"\x0d" * 32),
                          device)
    raw = ser.serialize(proof, "SNARK")
    if niu is not None:
        driver._verify(proof, ctk, rtk, s, device)
        proof.block_comm_vars_list[0].C[0] = \
            RistrettoPoint.basepoint().compress()
        try:
            driver._verify(proof, ctk, rtk, s, device)
        except ProofVerifyError:
            pass
        else:
            raise AssertionError("a tampered memory SNARK verified")
    return raw


def expect_reject_snark(run, device) -> None:
    """A SNARK whose first claimed evaluation (A at (rx, ry)) is off by
    one must be rejected."""
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.core.field import Scalar
    from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    bad = ser.deserialize(run["bytes"], "SpartanSNARK")
    bad.inst_evals[0] = bad.inst_evals[0] + Scalar(1)
    try:
        bad.verify(run["comm"], run["inputs"], run["gens"],
                   Transcript(b"snark_example"), device=device)
    except ProofVerifyError:
        return
    raise AssertionError("a SNARK with a wrong claimed evaluation verified")


def expect_reject(run, device=None) -> None:
    """Swap two round commitments of a proof's phase-1 sumcheck: its
    verifier must reject it. `run` is a NIZK run (device given) or a
    data-parallel one."""
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    nizk = device is not None
    bad = ser.deserialize(run["bytes"], "NIZK" if nizk else "R1CSProof")
    sc = (bad.r1cs_sat_proof if nizk else bad).sc_proof_phase1
    sc.comm_evals[0], sc.comm_evals[1] = sc.comm_evals[1], sc.comm_evals[0]
    try:
        if nizk:
            bad.verify(run["inst"], run["inputs"], run["gens"],
                       Transcript(b"nizk_example"), device=device)
        else:
            run["verify"](bad)
    except (ProofVerifyError, AssertionError):
        return
    raise AssertionError("a tampered proof verified")


# --------------------------------------------------------------------------
# Phase 9: the prover on several ranks (spartan_parallel_tpu_torch
# _dryrun_stages.launch; each rank a spawned process running p9_rank)
# --------------------------------------------------------------------------
# the kernels whose per-rank launches each phase-9 line reports
P9_KERNELS = {
    "K2": ("msm_batched",),
    "K4": ("sc_p1_round", "sc_p1_round_q", "sc_p1_round_p", "sc_p2_round",
           "sc_p2_round_w", "sc_p2_round_p"),
    "K5": ("sc_pc_round",),
    "K11": ("zk_round_tail",),
    "K12": ("point_sum",),
}
NIZK_TAPE, DP_TAPE, COUNTER_TAPE = b"\x05" * 32, b"\x0b" * 32, b"\x07" * 32


def rand_limbs(shape, seed: int):
    """Random field limbs (< 2^252, Montgomery values) from a seeded CPU
    generator: the same tensor in every process."""
    import torch

    g = torch.Generator().manual_seed(seed)
    t = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=g,
                      dtype=torch.int32)
    t[..., 15] &= 0x0FFF
    return t


def p9_tables():
    """The JAX dryrun_step's seed-0 tables (2, 8, 8), n_half 4."""
    from spartan_parallel_tpu_torch.parallel.mesh import dryrun_tables

    return {k: v.numpy() for k, v in dryrun_tables(2, 8, 8).items()}, 4


def p9_round(mesh, device):
    """One q-sharded phase-1 round; the evaluations and a sha256 of each
    of this rank's bound tables."""
    import hashlib

    from spartan_parallel_tpu_torch import _dryrun_stages as ds
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    tables, n_half = p9_tables()
    out = ds.sharded_round(mesh, device, tables, n_half, sck.MODE_X)
    return {"evals": out["evals"],
            "bound": [hashlib.sha256(b.tobytes()).hexdigest()
                      for b in out["bound"]]}


def p9_round_ref(dev, world):
    """p9_round's single-rank result, cut into each rank's share (tq
    along its only axis, B/C/D along q)."""
    import hashlib

    from spartan_parallel_tpu_torch import _dryrun_stages as ds
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    tables, n_half = p9_tables()
    out = ds.sharded_round(None, dev, tables, n_half, sck.MODE_X)
    refs = []
    for k in range(world):
        bound = []
        for i, b in enumerate(out["bound"]):
            if i in (1, 3, 4, 5):
                ax = 0 if i < 3 else 1
                b = b.take(range(k, b.shape[ax], world), axis=ax)
            bound.append(hashlib.sha256(b.tobytes()).hexdigest())
        refs.append({"evals": out["evals"], "bound": bound})
    return refs


def p9_msm_inputs(device, n: int, rows: int):
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens

    pts = MultiCommitGens(n, b"chip_smoke").device_points(device)[:n]
    return pts, rand_limbs((rows, n), 11).to(device)


def p9_msm(mesh, device, n, rows):
    """The sharded MSM of n points x rows rows; compressed points."""
    from spartan_parallel_tpu_torch.parallel.msm_sharded import msm_sharded

    return [p.compress() for p in msm_sharded(
        mesh, *p9_msm_inputs(device, n, rows))]


def p9_rank(mesh, device, jobs, strict):
    """One rank of a phase-9 launch: each job (name, kwargs), a
    p9_* function here or a stage of _dryrun_stages, with the launch
    counts set to 0 just before it and read just after. One cross-rank
    sum first sets up the card, the communicator and sum_reduce's
    constant. strict: every device-round loop under
    set_sync_debug_mode("error") (NCCL)."""
    import torch

    from spartan_parallel_tpu_torch import _dryrun_stages as ds
    from spartan_parallel_tpu_torch.ops import kernels
    from spartan_parallel_tpu_torch.parallel.mesh import sum_partials

    stats = {"sumchecks": 0, "rounds": 0}
    sum_partials(mesh, torch.zeros((3, 16), dtype=torch.int32,
                                   device=device))
    if strict:
        strict_round_loops(torch, stats)
    out = []
    for name, kw in jobs:
        fn = globals()[name] if name.startswith("p9_") else \
            getattr(ds, name)
        kernels.reset_counts()
        c0, s0 = mesh.collectives, mesh.collective_s
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(mesh, device, **kw)
        torch.cuda.synchronize()
        out.append({"job": name, "result": res,
                    "wall_s": time.perf_counter() - t0,
                    "launches": {k: v for k, v in kernels.launches.items()
                                 if v},
                    "collectives": mesh.collectives - c0,
                    "collective_s": mesh.collective_s - s0})
    return {"jobs": out, "no_host_sync": stats}


def p9_launch(dev, card, label, world, jobs, refs, needs, splits,
              shape=None, strict=False):
    """Run the jobs on `world` ranks, check every rank's result against
    its single-rank reference, emit one line per job, and return rank
    0's launch counts summed over the jobs. needs: the kernels each job
    must launch on every rank; splits: for each job, the rounds each of
    its sumchecks must run on split tables (one cross-rank sum a round),
    "each" (at least one round in every sumcheck, at least one
    sumcheck), or None (a job with no sumcheck)."""
    from spartan_parallel_tpu_torch import _dryrun_stages as ds

    t0 = time.perf_counter()
    reps = ds.launch(p9_rank, world, args=(jobs, strict), device=dev,
                     shape=shape, timeout=600)
    wall = time.perf_counter() - t0
    total = {}
    for j, (name, kw) in enumerate(jobs):
        per = [r["result"]["jobs"][j] for r in reps]
        same = all(_p9_same(p["result"], refs[j], k)
                   for k, p in enumerate(per))
        kern = [{kk: sum(p["launches"].get(c, 0) for c in cs)
                 for kk, cs in P9_KERNELS.items()} for p in per]
        missing = [kk for kk in needs[j] if not all(k[kk] for k in kern)]
        split = [p["result"].get("split_rounds")
                 if isinstance(p["result"], dict) else None for p in per]
        split_ok = splits[j] is None or all(
            s_ == splits[j] if splits[j] != "each" else
            (s_ and all(s_)) for s_ in split)
        emit({"phase": "multi_device", "launch": label, "job": name,
              "args": {k: (v.hex() if isinstance(v, bytes) else v)
                       for k, v in kw.items()},
              "world": world, "mesh": list(shape or (world,)),
              "backend": reps[0]["backend"], "card": card,
              "identical_to_single_rank": same,
              "prove_s_per_rank": [p["result"].get("prove_s")
                                   if isinstance(p["result"], dict) else None
                                   for p in per],
              "wall_s_per_rank": [p["wall_s"] for p in per],
              "kernel_launches_per_rank": kern,
              "split_rounds_per_rank": split,
              "collectives_per_rank": [p["collectives"] for p in per],
              "collective_s_per_rank": [p["collective_s"] for p in per]})
        if not same:
            raise AssertionError(f"{label} {name}: a rank's result differs "
                                 "from the single-rank one")
        if missing:
            raise AssertionError(f"{label} {name}: {missing} not launched "
                                 "on every rank")
        if not split_ok:
            raise AssertionError(f"{label} {name}: split rounds {split}, "
                                 f"expected {splits[j]}")
        for k, v in per[0]["launches"].items():
            total[k] = total.get(k, 0) + v
    emit({"phase": "multi_device_launch", "launch": label, "world": world,
          "backend": reps[0]["backend"], "launch_wall_s": wall,
          "rank_s": [r["seconds"] for r in reps],
          "no_host_sync": ([r["result"]["no_host_sync"] for r in reps]
                           if strict else "not checked: gloo carries the "
                           "collectives through host memory")})
    if strict and not all(r["result"]["no_host_sync"]["sumchecks"]
                          for r in reps):
        raise AssertionError(f"{label}: no device-round sumcheck ran")
    return total


def _p9_same(got, ref, rank: int) -> bool:
    import numpy as np

    if isinstance(ref, list) and ref and isinstance(ref[0], dict):
        ref = ref[rank]
    if isinstance(got, dict) and "bytes" in got:
        return got["bytes"] == ref
    if isinstance(got, dict):
        return np.array_equal(got["evals"], ref["evals"]) and \
            got["bound"] == ref["bound"]
    return got == ref


def phase9(dev, card, refs, log_cons: int) -> dict:
    """The sharded prover on ranks that share the card: D = 2 over gloo
    (the rounds, the MSM, the NIZK 2^20, config 4 skewed, the counter
    SNARK), a 2 x 2 mesh over gloo (the 2_nizk stage's shape), and one
    rank over NCCL (the round and the 2^10 NIZK). Every result must equal
    the single-rank one: the proofs of phases 3-5 under the same tapes,
    and the round and the MSM computed here on one rank."""
    from spartan_parallel_tpu_torch import _dryrun_stages as ds
    from spartan_parallel_tpu_torch.ops import msm

    t_phase = time.perf_counter()
    pts, scal = p9_msm_inputs(dev, 1024, 1024)
    msm_ref = [p.compress() for p in msm.msm(pts, scal)]
    del pts, scal
    nizk64 = ds.stage_2_nizk(None, dev, n=64, tape_seed=COUNTER_TAPE)
    nizk_args = {"n": 1 << log_cons, "num_inputs": 10, "seed": 0,
                 "tape_seed": NIZK_TAPE, "label": b"nizk_example"}
    dp_args = {"num_proofs": (512, 128, 32, 32), "ncons": 1024,
               "num_inputs": 10, "seed": 2, "tape_seed": DP_TAPE,
               "label": b"dp_bench"}
    jobs = [("p9_round", {}),
            ("p9_msm", {"n": 1024, "rows": 1024}),
            ("stage_2_nizk", nizk_args),
            ("stage_4_dp_r1cs", dp_args),
            ("stage_3_snark", {"tape_seed": COUNTER_TAPE})]
    counts = p9_launch(
        dev, card, "gloo_2", 2, jobs,
        [p9_round_ref(dev, 2), msm_ref, refs["nizk"], refs["dp_skewed"],
         refs["counter"]],
        [("K4",), ("K2", "K12"), ("K2", "K4", "K11", "K12"),
         ("K2", "K5", "K11", "K12"), ("K11",)],
        # the x (phase 1) and y (phase 2) rounds while the half length
        # is at least the number of ranks: log2 of the axis, less log2 D
        [None, None, [log_cons - 1] * 2, [9, 9], "each"])
    p9_launch(dev, card, "gloo_2x2", 4,
              [("stage_2_nizk", {"n": 64, "tape_seed": COUNTER_TAPE})],
              [nizk64["bytes"]], [("K4", "K11")], [[4, 4]], shape=(2, 2))
    p9_launch(dev, card, "nccl_1", 1,
              [("p9_round", {}),
               ("stage_2_nizk", dict(nizk_args, n=1 << 10))],
              [p9_round_ref(dev, 1), refs["nizk_2_10"]],
              [("K4",), ("K4", "K11")], [None, [10, 10]], strict=True)
    emit({"phase": "multi_device_total", "card": card,
          "seconds": time.perf_counter() - t_phase})
    return counts


# --------------------------------------------------------------------------
# Phase 10: the bullet verifier's G_hat on K2, the entry step, the dry run
# (spartan_parallel_tpu_torch/dryrun.py)
# --------------------------------------------------------------------------
BULLET_N = 1 << 14  # above host_msm_max on the card (8192): G_hat on K2
# the kernels (P9_KERNELS' keys) each dry-run stage must launch on every
# rank, at the stages' own shapes
DRYRUN_NEEDS = {"1_sharded_round": ("K4",), "2_nizk": ("K4", "K11"),
                "4_dp_r1cs": ("K5", "K11"), "3_snark": ("K11",)}


def log_bullet_verifies(log: list) -> None:
    """Record every bullet verifier call (models/sigma.py
    BulletReductionProof.verify) from here on: its n, its G_hat and the
    K2 launches made inside it."""
    from spartan_parallel_tpu_torch.models import sigma
    from spartan_parallel_tpu_torch.ops import kernels

    verify = sigma.BulletReductionProof.verify

    def logged(self, n, *args, **kw):
        k0 = kernels.launches.get("msm_batched", 0)
        out = verify(self, n, *args, **kw)
        log.append({"n": n, "g_hat": out[0].compress(),
                    "k2": kernels.launches.get("msm_batched", 0) - k0})
        return out

    sigma.BulletReductionProof.verify = logged


def bullet_verify_run(dev, card, record, log: list) -> dict:
    """The verifies of phases 3-8 (`log`) launched no K2: each n is at
    most the card's threshold. Then DotProductProofLog at n = 2^14,
    proved on the card and verified through the device branch (K2 on the
    generators' copy on the card; K12 sums msm_dev's two chunks) and the
    host branch: equal G_hat, a tampered proof rejected. Returns the
    device branch's launch counts."""
    import numpy as np
    import torch

    from spartan_parallel_tpu_torch.core.consts import L
    from spartan_parallel_tpu_torch.core.edwards import (
        RistrettoPoint,
        multiscalar_mul,
    )
    from spartan_parallel_tpu_torch.core.field import Scalar
    from spartan_parallel_tpu_torch.models import sigma
    from spartan_parallel_tpu_torch.ops import kernels, msm
    from spartan_parallel_tpu_torch.ops import limbs as lb
    from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    cells = {"verifies": len(log), "largest_n": max(e["n"] for e in log),
             "k2_launches": sum(e["k2"] for e in log)}
    emit({"phase": "bullet_verify_cells", **cells})
    if cells["k2_launches"]:
        raise AssertionError("a verify of phases 3-8 took K2")
    n = BULLET_N
    rng = np.random.default_rng(14)

    def draw():
        return Scalar(int.from_bytes(rng.bytes(40), "little") % L)

    x = [draw() for _ in range(n)]
    a = [draw() for _ in range(n)]
    y = Scalar(sum(int(u) * int(v) for u, v in zip(x, a)))
    t0 = time.perf_counter()
    gens = sigma.DotProductProofGens(n, b"chip_smoke_bullet")
    G_dev = gens.gens_n.device_points(dev)[:n]
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, Cx, Cy = sigma.DotProductProofLog.prove(
        gens, Transcript(b"bullet_verify"),
        RandomTape(b"proof", seed=b"\x0e" * 32), x, draw(), a, y, draw(),
        device=dev)
    prove_s = time.perf_counter() - t0

    def verify(device, p=proof):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p.verify(n, gens, Transcript(b"bullet_verify"), a, Cx, Cy, device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3, log[-1]

    kernels.reset_counts()
    dev_ms, on_dev = verify(dev)
    counts = dict(kernels.launches)
    host_ms, on_host = verify(None)
    brp = proof.bullet_reduction_proof
    bad = sigma.DotProductProofLog(
        sigma.BulletReductionProof(
            [RistrettoPoint.basepoint().compress()] + brp.L_vec[1:],
            brp.R_vec), proof.delta, proof.beta, proof.z1, proof.z2)
    try:
        verify(dev, bad)
        rejected = False
    except ProofVerifyError:
        rejected = True
    # G_hat alone at this shape: K2 (msm_single: the launches and the
    # decode to the host) against the host's multiscalar_mul
    s = [draw() for _ in range(n)]
    s_dev = lb.to_device(lb.ints_to_limbs([int(v) for v in s]), dev)
    k2_ms = wall_ms(lambda: msm.msm_single(G_dev, s_dev))
    host_g_ms = wall_ms(lambda: multiscalar_mul(s, gens.gens_n.G))
    emit({"phase": "bullet_verify", "n": n, "card": card,
          "gens_setup_s": setup_s, "prove_s": prove_s,
          "verify_ms_device_branch": dev_ms, "verify_ms_host_branch": host_ms,
          "g_hat_ms_k2": k2_ms, "g_hat_ms_host": host_g_ms,
          "k2_launches": on_dev["k2"], "launches": counts,
          "g_hat_identical": on_dev["g_hat"] == on_host["g_hat"],
          "host_branch_k2_launches": on_host["k2"],
          "tamper_rejected": rejected})
    if not on_dev["k2"] or on_host["k2"] or not counts.get("point_sum"):
        raise AssertionError("the verify at 2^14 did not take K2 (and K12) "
                             "on the device branch alone")
    if on_dev["g_hat"] != on_host["g_hat"] or not rejected:
        raise AssertionError("the device branch's G_hat differs, or a "
                             "tampered proof was accepted")
    # the bullet rows of phase 2 hold the split windows at edge_scalars;
    # here msm_plain takes ~23 s a call
    record_msm(record, f"msm_verify_{n}", G_dev, s_dev[None],
               "bullet_verify", edge=False, extra={
                   "caller": "spartan_parallel_tpu/models/sigma.py:338",
                   "shape_from": "the bullet verifier's G_hat at 2^14"})
    return counts


def entry_run(dev, card) -> dict:
    """dryrun.entry() on the card against the CPU's plain versions,
    exact; returns the card's launch counts."""
    import torch

    from spartan_parallel_tpu_torch import dryrun
    from spartan_parallel_tpu_torch.ops import kernels

    kernels.reset_counts()
    fn, args = dryrun.entry(dev)
    got = fn(*args)
    torch.cuda.synchronize()
    counts = dict(kernels.launches)
    fn, args = dryrun.entry("cpu")
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, fn(*args)))
    emit({"phase": "entry", "shape": list(dryrun.ENTRY_SHAPE), "card": card,
          "identical_to_cpu": same, "launches": counts})
    if not same or not counts.get("sc_p1_round") or \
            not counts.get("fq_bind"):
        raise AssertionError("entry(): the card differs from the CPU or "
                             "did not launch K4 and K1")
    return counts


def dryrun_run(card) -> dict:
    """dryrun_multichip(2) on the card: the four stages, each a
    subprocess of two gloo ranks under its cap; every stage's ranks must
    agree and launch the stage's kernels. Returns rank 0's launch counts
    summed over the stages."""
    from spartan_parallel_tpu_torch import dryrun

    t0 = time.perf_counter()
    recs = dryrun.dryrun_multichip(2)
    total = {}
    for rec in recs:
        kern = [{kk: sum(r.get(c, 0) for c in cs)
                 for kk, cs in P9_KERNELS.items()} for r in rec["launches"]]
        emit({"phase": "dryrun", "card": card, **rec,
              "kernel_launches_per_rank": kern})
        missing = [kk for kk in DRYRUN_NEEDS[rec["dryrun_stage"]]
                   if not all(k[kk] for k in kern)]
        if missing or not rec["ranks_agree"]:
            raise AssertionError(f"dryrun {rec['dryrun_stage']}: ranks "
                                 f"disagree or {missing} not launched")
        for k, v in rec["launches"][0].items():
            total[k] = total.get(k, 0) + v
    emit({"phase": "dryrun_total", "card": card, "world": 2,
          "stages": [r["dryrun_stage"] for r in recs],
          "seconds": time.perf_counter() - t0})
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-cons", type=int, default=20,
                    help="log2 of the phase-4 NIZK's constraints/variables "
                         "(18 if 2^20 does not fit a run's time limit)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from spartan_parallel_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]

    t0 = time.perf_counter()
    built = kernels.build(kernels.SOURCES + ("fp_chain",))
    emit({"phase": "build", "card": card,
          "seconds": time.perf_counter() - t0,
          "sources": {k: round(v[0], 2) for k, v in built.items()},
          "ptxas": {k: [ln.split("ptxas info    : ")[-1]
                        for ln in v[1].splitlines() if "registers" in ln
                        or "spill" in ln]
                    for k, v in built.items()}})

    if "msm" in built:
        from spartan_parallel_tpu_torch.ops import msm

        emit({"phase": "ptxas_msm", "card": card,
              "kernels": ptxas_kernels(built["msm"][1]),
              "k_msm_window_blocks_per_sm": msm.window_occupancy()})

    if "zk_round" in built and "msm" in built:
        pz = ptxas_kernels(built["zk_round"][1])
        pm = ptxas_kernels(built["msm"][1])
        emit({"phase": "ptxas_zk", "card": card,
              "kernels": {"zk_round_tail_kernel": pz["zk_round_tail_kernel"],
                          "comb_kernel": pz["comb_kernel"],
                          "compress_kernel": pz["compress_kernel"],
                          "keccak_kernel": pz["keccak_kernel"],
                          "k_fold": pm["k_fold"]},
              "functions": pz.get("functions", {})})
        stack = pz["zk_round_tail_kernel"]["stack_bytes"]
        if stack > K11_STACK_MAX:
            raise AssertionError(f"zk_round_tail_kernel keeps {stack} bytes "
                                 f"of stack (at most {K11_STACK_MAX})")

    if "sumcheck" in built and "fq" in built:
        ps = ptxas_kernels(built["sumcheck"][1])
        emit({"phase": "ptxas_k4", "card": card,
              "kernels": {k: v for k, v in ps.items()
                          if k.startswith(("k_p1_round", "k_p2_round",
                                           "k_pc_round"))}})
        emit({"phase": "ptxas_k1", "card": card,
              "kernels": ptxas_kernels(built["fq"][1])})

    if "product" in built:
        emit({"phase": "ptxas_k6", "card": card,
              "kernels": ptxas_kernels(built["product"][1])})

    check_fp_chain(dev, card)
    rows, paths, record = check_kernels(LOG_KERNEL, dev, REPS)

    # Phase 3: the card proves with device-resident rounds, the CPU with
    # the host loop; the bytes must agree, and the card must have run one
    # round tail (K11) per ZK sumcheck round of its proof, every round
    # loop without a host sync.
    from spartan_parallel_tpu_torch import serialization as ser

    no_sync = {"sumchecks": 0, "rounds": 0}
    strict_round_loops(torch, no_sync)
    bullet_log = []
    log_bullet_verifies(bullet_log)

    def tails(proof):
        """(ZK rounds of the card's proof, K11 launches since the reset)."""
        n = zk_rounds(proof)
        k = kernels.launches.get("zk_round_tail", 0)
        if n == 0 or k != n:
            raise AssertionError(f"{k} round tails for {n} ZK rounds")
        return {"zk_rounds": n, "zk_round_tail_launches": k}

    refs = {}
    kernels.reset_counts()
    on_card = nizk_run(10, 10, dev, seed_tape=True)
    refs["nizk_2_10"] = on_card["bytes"]
    zk = tails(on_card["proof"])
    on_cpu = nizk_run(10, 10, "cpu", seed_tape=True)
    same = on_card["bytes"] == on_cpu["bytes"]
    expect_reject(on_card, dev)
    emit({"phase": "nizk_fixed_tape", "log_cons": 10,
          "bytes_identical": same, "proof_bytes": len(on_card["bytes"]),
          "prove_s_cuda": on_card["prove_s"],
          "prove_s_cpu": on_cpu["prove_s"], "tamper_rejected": True, **zk})
    if not same:
        raise AssertionError("card and CPU proofs differ")
    # skewed counts take the classed layout, uniform ones the dense one
    for num_proofs in ([8, 2, 1], [2, 2, 2, 2]):
        kernels.reset_counts()
        dp_card = dp_run(num_proofs, 4, 4, dev, seed_tape=True)
        zk = tails(ser.deserialize(dp_card["bytes"], "R1CSProof"))
        dp_cpu = dp_run(num_proofs, 4, 4, "cpu", seed_tape=True)
        same = dp_card["bytes"] == dp_cpu["bytes"]
        emit({"phase": "dp_fixed_tape", "num_proofs": num_proofs,
              "log_cons": 4, "bytes_identical": same,
              "proof_bytes": len(dp_card["bytes"]), "verified": True, **zk})
        if not same:
            raise AssertionError("card and CPU data-parallel proofs differ")
    kernels.reset_counts()
    sn_card = snark_run(4, 4, dev, seed_tape=True)
    zk = tails(ser.deserialize(sn_card["bytes"], "SpartanSNARK"))
    sn_cpu = snark_run(4, 4, "cpu", seed_tape=True)
    same = (sn_card["comm_bytes"], sn_card["bytes"]) == \
        (sn_cpu["comm_bytes"], sn_cpu["bytes"])
    expect_reject_snark(sn_card, dev)
    emit({"phase": "snark_fixed_tape", "log_cons": 4, "num_inputs": 4,
          "bytes_identical": same, "proof_bytes": len(sn_card["bytes"]),
          "verified": True, "tamper_rejected": True, **zk})
    if not same:
        raise AssertionError("card and CPU SNARKs differ")
    from spartan_parallel_tpu_torch import examples as ex

    kernels.reset_counts()
    cn = {dev: zkvm_run(*ex.build_counter_program(), dev, b"\x07" * 32)}
    zk = tails(ser.deserialize(cn[dev]["bytes"], "SNARK"))
    cn["cpu"] = zkvm_run(*ex.build_counter_program(), "cpu", b"\x07" * 32)
    refs["counter"] = cn[dev]["bytes"]
    same = cn[dev]["bytes"] == cn["cpu"]["bytes"]
    emit({"phase": "zkvm_counter_fixed_tape", "bytes_identical": same,
          "proof_bytes": len(cn[dev]["bytes"]), "verified": True,
          "tamper_rejected": True, "prove_s_cuda": cn[dev]["prove_s"],
          "prove_s_cpu": cn["cpu"]["prove_s"], **zk})
    if not same:
        raise AssertionError("card and CPU 9-stage SNARKs differ")
    for niu in (None, 5):
        kernels.reset_counts()
        raw = {dev: mem_fixture_run(niu, dev)}
        zk = tails(ser.deserialize(raw[dev], "SNARK"))
        raw["cpu"] = mem_fixture_run(niu, "cpu")
        same = raw[dev] == raw["cpu"]
        emit({"phase": "zkvm_memory_fixture",
              "num_inputs_unpadded": niu or 3, "bytes_identical": same,
              "proof_bytes": len(raw[dev]),
              "verified": niu is not None,
              "tamper_rejected": niu is not None, **zk})
        if not same:
            raise AssertionError("card and CPU memory SNARKs differ")

    counts = {}
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    run = nizk_run(args.log_cons, 10, dev, seed_tape=True)
    counts["nizk"] = dict(kernels.launches)
    refs["nizk"] = run["bytes"]
    expect_reject(run, dev)
    row = {"phase": "nizk", "log_cons": args.log_cons, "card": card,
           "setup_s": run["setup_s"], "comb_tables_s": run["comb_tables_s"],
           "prove_s": run["prove_s"],
           "verify_s": run["verify_s"],
           "proof_bytes": len(run["bytes"]),
           "proof_bytes_compressed": run["compressed"],
           "upstream_compressed_bytes": 48134,
           "stages_s": run["stages"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "launches": counts["nizk"], "tamper_rejected": True}
    del run
    # the kernels' times from a second, traced run of the same proof
    with kernel_trace() as tr:
        again = nizk_run(args.log_cons, 10, dev, seed_tape=True)
    if again["bytes"] != refs["nizk"]:
        raise AssertionError("the traced NIZK differs")
    emit({**row, "traced_prove_s": again["prove_s"],
          **traced(tr, (("witness_commit", "witness_commit"),
                        ("prove", "NIZK::prove"),
                        ("verify", "NIZK::verify")))})
    del again

    # BASELINE config 4 at 2^20 sigma work: skewed counts take the
    # q-size-classed prover (K5), uniform ones the dense prover (K4's q,
    # w and p rounds)
    for path, num_proofs in (("dp_skewed", [512, 128, 32, 32]),
                             ("dp_uniform", [256] * 4)):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        with path_calls() as calls:
            run = dp_run(num_proofs, 10, 10, dev, seed_tape=True)
        counts[path] = dict(kernels.launches)
        structure = launch_structure(calls, counts[path],
                                     path == "dp_skewed", False)
        if path == "dp_skewed":
            refs["dp_skewed"] = run["bytes"]
        expect_reject(run)
        if path == "dp_skewed":
            # the same proof with the host round loop on the card; then
            # one profiled run of each form
            with host_loop():
                base = dp_run(num_proofs, 10, 10, dev, seed_tape=True)
            prof = {"device_rounds": {}, "host_loop": {}}
            dp_run(num_proofs, 10, 10, dev, True, lambda f: profile_call(
                torch, f, prof["device_rounds"]))
            with host_loop():
                dp_run(num_proofs, 10, 10, dev, True, lambda f: profile_call(
                    torch, f, prof["host_loop"]))
            emit({"phase": "dp_skewed_host_loop", "card": card,
                  "bytes_identical": base["bytes"] == run["bytes"],
                  "prove_s_device_rounds": run["prove_s"],
                  "prove_s_host_loop": base["prove_s"],
                  "stages_s_device_rounds": run["stages_s"],
                  "stages_s_host_loop": base["stages_s"],
                  "profiled_prove": prof})
            if base["bytes"] != run["bytes"]:
                raise AssertionError("device rounds and host loop differ")
        mem = torch.cuda.max_memory_allocated()
        # the kernels' times from a second, traced run of the same proof
        with kernel_trace() as tr:
            again = dp_run(num_proofs, 10, 10, dev, seed_tape=True)
        if again["bytes"] != run["bytes"]:
            raise AssertionError("the traced data-parallel proof differs")
        sigma = sum(num_proofs) << 10
        emit({"phase": path, "num_proofs": num_proofs, "log_cons": 10,
              "num_inputs": 10, "sigma_work": sigma, "card": card,
              "setup_s": run["setup_s"],
              "comb_tables_s": run["comb_tables_s"],
              "commit_s": run["commit_s"],
              "prove_s": run["prove_s"], "verify_s": run["verify_s"],
              "upstream_single_core_cpu_prove_s": 4.442 * sigma / (1 << 20),
              "proof_bytes": len(run["bytes"]),
              "proof_bytes_compressed": run["compressed"],
              "stages_s": run["stages_s"], "max_memory_allocated": mem,
              "launches": counts[path], "launch_structure": structure,
              "tamper_rejected": True,
              "traced_prove_s": again["prove_s"],
              **traced(tr, (("witness_commit", "witness_commit"),
                            ("prove", "R1CSProof::prove"),
                            ("prove_sc_phase_one", "prove_sc_phase_one")))})
        del run, again
    # the upstream SNARK with SPARK under a fixed tape: BASELINE config 2,
    # then the upstream README instance, whose launches the K6 rows report
    # and whose second, traced run gives the kernels' times
    import hashlib

    for path, log_cons in (("snark16", 16), ("snark", 20)):
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        with path_calls() as calls:
            run = snark_run(log_cons, 10, dev, seed_tape=True)
        counts[path] = dict(kernels.launches)
        structure = launch_structure(calls, counts[path], False, True)
        mem = torch.cuda.max_memory_allocated()
        expect_reject_snark(run, dev)
        row = {"phase": "snark", "log_cons": log_cons, "num_inputs": 10,
               "nnz_per_matrix": 1 << log_cons, "card": card,
               "setup_s": run["setup_s"],
               "comb_tables_s": run["comb_tables_s"],
               "encode_s": run["encode_s"],
               "prove_s": run["prove_s"], "verify_s": run["verify_s"],
               "stages_s": run["stages_s"],
               "proof_bytes": run["proof_bytes"],
               "proof_bytes_compressed": run["proof_bytes_compressed"],
               "upstream_compressed_bytes_2_20": {
                   "sat": 47024, "eval": 133720, "total": 141768},
               "proof_sha256": hashlib.sha256(run["bytes"]).hexdigest(),
               "max_memory_allocated": mem,
               "launches": counts[path], "launch_structure": structure,
               "tamper_rejected": True}
        if path == "snark":
            raw = run["bytes"]
            del run
            with kernel_trace() as tr:
                run = snark_run(log_cons, 10, dev, seed_tape=True)
            if run["bytes"] != raw:
                raise AssertionError("the traced SNARK differs")
            row.update(traced_prove_s=run["prove_s"],
                       product_layers=spark_k6_launches(
                           ser.deserialize(raw, "SpartanSNARK"),
                           counts[path], tr),
                       **traced(tr, (("prove", "SNARK::prove"),
                                     ("eval_proof", "R1CSEvalProof::prove"))))
        emit(row)
        del run
    # the 9-stage SNARK at the find_min shape (BASELINE.md section B)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    zk_args, zk_pa = ex.build_synthetic_zkvm(
        num_blocks=9, block_cons=8192, num_execs=FINDMIN_EXECS)
    build_s = time.perf_counter() - t0
    kernels.reset_counts()
    tape = b"\x0f" * 32
    with path_calls() as calls:
        run = zkvm_run(zk_args, zk_pa, dev, tape)
    counts["findmin"] = dict(kernels.launches)
    findmin_structure = launch_structure(calls, counts["findmin"], True,
                                         True, shift=True)
    findmin_largest = calls["largest"]
    mem = torch.cuda.max_memory_allocated()
    # the same proof with the host round loop on the card
    from spartan_parallel_tpu_torch.utils import timer

    timer.totals.clear()
    with host_loop():
        t0 = time.perf_counter()
        base = ex.prove_program(zk_pa, run["ctx"], tape_seed=tape,
                                device=dev)
        base_s = time.perf_counter() - t0
    same = ser.serialize(base, "SNARK") == run["bytes"]
    keys = ("SNARK::prove", "R1CSProof::prove", "Block Correctness Extract",
            "Pairwise Check", "Perm Root", "R1CSEvalProof::prove")
    host_stages = {k: timer.totals.get(k) for k in keys}
    # device rounds once more, after the host loop: the call's first
    # prove of this shape also pays for what a first prove pays for
    timer.totals.clear()
    t0 = time.perf_counter()
    again = ex.prove_program(zk_pa, run["ctx"], tape_seed=tape, device=dev)
    again_s = time.perf_counter() - t0
    same = same and ser.serialize(again, "SNARK") == run["bytes"]
    again_stages = {k: timer.totals.get(k) for k in keys}
    # the stages' SAT and eval proofs, from one more prove in each form
    # (synchronized around each proof, so not the prove times above)
    split = {}
    for form in ("device_rounds", "host_loop"):
        with (host_loop() if form == "host_loop" else
              contextlib.nullcontext()), time_calls(torch) as calls:
            ex.prove_program(zk_pa, run["ctx"], tape_seed=tape, device=dev)
        split[form] = {k: {"sat": sum(v["sat"]), "eval": sum(v["eval"])}
                       for k, v in calls.items()}
    emit({"phase": "zkvm_findmin_host_loop", "card": card,
          "bytes_identical": same, "prove_s_device_rounds": run["prove_s"],
          "prove_s_host_loop": base_s,
          "prove_s_device_rounds_after_host_loop": again_s,
          "stages_s_device_rounds": {k: run["stages_s"][k] for k in keys},
          "stages_s_host_loop": host_stages,
          "stages_s_device_rounds_after_host_loop": again_stages,
          "sat_and_eval_proof_s": split})
    if not same:
        raise AssertionError("device rounds and host loop differ")
    del base, again
    # the kernels' times from one more run of the same proof, traced
    with kernel_trace() as tr:
        traced_run = zkvm_run(zk_args, zk_pa, dev, tape)
    if traced_run["bytes"] != run["bytes"]:
        raise AssertionError("the traced 9-stage SNARK differs")
    emit({"phase": "zkvm_findmin", "num_blocks": 9, "block_cons": 8192,
          "num_execs": list(FINDMIN_EXECS),
          "num_vars": zk_pa["num_vars"], "card": card,
          "program_build_s": build_s, "setup_s": run["setup_s"],
          "comb_tables_s": run["comb_tables_s"],
          "prove_s": run["prove_s"], "verify_s": run["verify_s"],
          "upstream_single_core_cpu": UPSTREAM_FINDMIN,
          "stages_s": run["stages_s"], "proof_bytes": len(run["bytes"]),
          "proof_bytes_compressed": run["compressed"],
          "max_memory_allocated": mem,
          "launches": counts["findmin"],
          "launch_structure": findmin_structure, "tamper_rejected": True,
          "traced_prove_s": traced_run["prove_s"],
          **traced(tr, (("input_commit", "input_commit"),
                        ("prove", "SNARK::prove"), ("all", None)))})
    del run, traced_run, zk_args, zk_pa
    # K2 at find_min's largest block commit, the shape read from the run
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens

    fb, fn = tr.largest("input_commit")
    g8 = torch.Generator(device=dev)
    g8.manual_seed(8)
    record_msm(record, "msm_findmin_block0", MultiCommitGens(
        fn, b"chip_smoke_findmin").device_points(dev)[:fn],
        rand_field((fb, fn), g8, dev), "findmin",
        extra={"shape_from": "the largest K2 launch of phase 8's "
                              "input_commit"})
    # K1's dot of a list of tables and K5's round of every class at
    # find_min's largest shapes, read from phase 8's run
    from spartan_parallel_tpu_torch.ops import fq

    nt, K = findmin_largest["evaluate_many"]
    many = rand_field((nt, K), g8, dev)
    chis = rand_field((K,), g8, dev)
    record("fq_dot_many", "fq.cu",
           "spartan_parallel_tpu/models/sparse_mlpoly.py:364",
           lambda: fq.dot_many(list(many), chis),
           lambda: fq.dot_many_plain(list(many), chis), field_err,
           ((nt + 1) * K + nt) * 64, nt * K * IMAD_FQ_MUL, path="findmin",
           extra={"shape": [nt, K], "shape_from": "the largest "
                  "_evaluate_many of phase 8"})
    del many, chis
    big = findmin_largest["pc_round"]
    eqs = [rand_field((n,), g8, dev) for n in big["eq_lens"]]
    classes = [tuple(rand_field(shape, g8, dev) for _ in range(3))
               for shape in big["classes"]]
    classes_row(record, "sc_pc_round_classes_findmin", *eqs, classes,
                big["p0s"], big["Ss"], big["n_half"], big["mode"],
                (rand_field((), g8, dev), *big["prev"]), "findmin",
                extra={"shape_from": "the largest fused classed round of "
                       "phase 8"})
    del classes, eqs
    check_findmin_k3_k7(dev, record, findmin_largest)
    del findmin_largest
    dp_modes = ("sc_p1_round_q", "sc_p1_round_p", "sc_p2_round_w",
                "sc_p2_round_p")
    if not all(counts["dp_uniform"].get(k) for k in dp_modes):
        raise AssertionError("K4's data-parallel rounds not launched")

    counts["multi_device"] = phase9(dev, card, refs, args.log_cons)
    counts["bullet_verify"] = bullet_verify_run(dev, card, record,
                                                bullet_log)
    counts["entry"] = entry_run(dev, card)
    counts["dryrun"] = dryrun_run(card)

    emit({"phase": "no_host_sync", "check": "torch.cuda.set_sync_debug_mode"
          "('error') around every device-round loop on the card, phases "
          "3-8", **no_sync})
    if no_sync["sumchecks"] == 0:
        raise AssertionError("no device-round sumcheck ran")

    for row in rows:
        path, counter = paths[row["name"]]
        row["launches"] = counts[path].get(counter, 0)
        row["launches_by_path"] = {p: c[counter] for p, c in counts.items()
                                   if c.get(counter)}
    # a check kernel's code runs on the path inside another kernel
    for name, host in CHECK_ONLY.items():
        row = next(r for r in rows if r["name"] == name)
        row["launches_of_" + host] = counts[paths[name][0]].get(host, 0)
    missing = [r["name"] for r in rows if r["launches"] == 0 and not
               r.get("launches_of_" + CHECK_ONLY.get(r["name"], ""))
               and not r.get("off_path")]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")

    emit({"kernels": rows})
    print(card)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
