#!/usr/bin/env python3
"""Drive spartan_parallel_tpu_torch on one NVIDIA GPU and check it.

    python3 chip_smoke.py                 # the full run (a few minutes)
    python3 chip_smoke.py --log-cons 16   # a smaller NIZK in phase 4

Phases, each printing one JSON line:
  1. the card (nvidia-smi name and power limit) and the build of the four
     CUDA kernel sources (csrc/*.cu, one nvcc per source, in parallel);
  2. every kernel against its plain PyTorch version on the card, at the
     shapes of the NIZK at 2^20 (exact equality; points after ristretto
     compression), with the kernel's time, the plain version's time and
     the least time the card could take (bound_ms);
  3. a fixed-tape NIZK at 2^10 constraints x 2^10 variables x 10 inputs,
     proved on the card and on the CPU: the serialized proofs must be
     identical, the proof must verify, and a tampered one must not;
  4. the NIZK at 2^20 x 2^20 x 10 inputs (the upstream README instance)
     on the card: prove, verify, reject a tampered proof, per-stage times,
     proof bytes, peak memory and each kernel's launches, which must all
     be > 0.
Then the kernel table as one JSON line, the card line, and last
{"ok": true, "device": {...}}. Any failure exits non-zero before that.

Needs a CUDA card and the repository beside this script; imports nothing
of JAX or of the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
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


def check_kernels(log_n: int, dev, reps: int):
    import torch

    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.ops import curve, fq, msm, spmv
    from spartan_parallel_tpu_torch.ops import limbs as lb
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    n = 1 << log_n
    E = 64  # bytes of one field element (16 int32 limbs)
    rows = []

    def record(name, source, replaces, kern, plain, err_fn, nbytes, imads,
               reps_k=reps):
        got = kern()
        want = plain()
        torch.cuda.synchronize()
        err = err_fn(got, want)
        ms = cuda_ms(kern, reps_k)
        plain_ms = wall_ms(plain)
        b_ms, b_by = bound(nbytes, imads)
        row = {"name": name, "route": "cuda",
               "source": "spartan_parallel_tpu_torch/csrc/" + source,
               "replaces": replaces, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": None}
        rows.append(row)
        emit({"phase": "kernel", **row})
        if err != 0:
            raise AssertionError(f"{name}: kernel disagrees with its plain "
                                 f"version (max_abs_err {err})")

    a = rand_field((n,), gen, dev)
    b = rand_field((n,), gen, dev)
    r = rand_field((), gen, dev)
    for name, op, plain, line in (
            ("fq_mul", fq.mul, fq.mul_plain, 79),
            ("fq_add", fq.add, fq.add_plain, 83),
            ("fq_sub", fq.sub, fq.sub_plain, 88)):
        imads = n * IMAD_FQ_MUL if name == "fq_mul" else 0
        record(name, "fq.cu", f"spartan_parallel_tpu/ops/fq.py:{line}",
               lambda op=op: op(a, b), lambda plain=plain: plain(a, b),
               field_err, 3 * n * E, imads)
    record("fq_bind", "fq.cu", "spartan_parallel_tpu/ops/sumcheck.py:122",
           lambda: fq.bind(a, r, 0, n // 2),
           lambda: fq.bind_plain(a, r, 0, n // 2), field_err,
           2 * n * E, n // 2 * IMAD_FQ_MUL)
    record("fq_dot", "fq.cu", "spartan_parallel_tpu/ops/fq.py:193",
           lambda: fq.dot(a, b), lambda: fq.dot_plain(a, b), field_err,
           2 * n * E, n * IMAD_FQ_MUL)

    # K2 at the Hyrax commit shape: B = N = sqrt(n) rows and points
    side = 1 << (log_n // 2)
    gens = MultiCommitGens(side, b"chip_smoke")
    pts = gens.device_points(dev)[:side]
    scal = rand_field((side, side), gen, dev)
    nz = sum(int((((scal[..., w >> 1] >> ((w & 1) * 8)) & 0xFF) != 0).sum())
             for w in range(32))
    adds = nz + side * 32 * 2 * 256 + side * 31
    dbls = side * 31 * 8
    msm_imads = (adds * FP_MUL_PER_ADD + dbls * FP_MUL_PER_DOUBLE) \
        * IMAD_FP_MUL
    record("msm_batched", "msm.cu", "spartan_parallel_tpu/ops/msm.py:189",
           lambda: msm.msm_dev(pts, scal), lambda: msm.msm_plain(pts, scal),
           point_err, side * 256 + side * side * E + side * 256, msm_imads,
           reps_k=max(1, reps // 4))
    # the bullet rounds fold with a full-width challenge and its inverse:
    # two random field elements below l. k_fold doubles 253 times, adds
    # L + R once up front, then adds one point per bit set in kl | kr.
    half = side // 2
    kl, kr = fq.decode(rand_field((2,), gen, dev).cpu())
    pl, pr = pts[:half], pts[half:]
    adds = bin(kl | kr).count("1") + 1
    fold_imads = half * (253 * FP_MUL_PER_DOUBLE + adds * FP_MUL_PER_ADD) \
        * IMAD_FP_MUL
    record("fold_points", "msm.cu", "spartan_parallel_tpu/ops/curve.py:159",
           lambda: curve.fold_points(pl, pr, kl, kr),
           lambda: curve.fold_points_plain(
               pl, pr, curve.scalar_limbs([kl, kr], dev)),
           point_err, 3 * half * 256, fold_imads)

    # K3 on the synthetic instance of 2^log_n constraints
    inst, _, _ = produce_synthetic_r1cs(1, [1], n, n, 10, device=dev)
    A = inst.A_list[0]
    csr, csc, coo = A._tensors(dev)
    nnz = A.get_num_nz_entries()
    z = rand_field((1, 2 * n), gen, dev)
    rx = rand_field((n,), gen, dev)
    ry = rand_field((2 * n,), gen, dev)
    idx_bytes = 4 * (nnz + n + 1)
    record("spmv_batched", "spmv.cu", "spartan_parallel_tpu/ops/spmv.py:52",
           lambda: spmv.spmv_batched(*csr, z),
           lambda: spmv.spmv_plain(*csr, z), field_err,
           idx_bytes + nnz * E + 2 * n * E + n * E, nnz * IMAD_FQ_MUL)
    record("eval_table", "spmv.cu", "spartan_parallel_tpu/ops/spmv.py:71",
           lambda: spmv.eval_table(*csc, rx),
           lambda: spmv.eval_table_plain(*csc, rx), field_err,
           4 * (nnz + 2 * n + 1) + nnz * E + n * E + 2 * n * E,
           nnz * IMAD_FQ_MUL)
    record("sparse_eval", "spmv.cu", "spartan_parallel_tpu/ops/spmv.py:87",
           lambda: spmv.sparse_eval(*coo, rx, ry),
           lambda: spmv.sparse_eval_plain(*coo, rx, ry), field_err,
           8 * nnz + nnz * E + 3 * n * E + E, 2 * nnz * IMAD_FQ_MUL)

    # K4: phase 1 at X = n, phase 2 at W * Y = 2 n; a fused step (bind of
    # the previous round's challenge, then this round's evaluations)
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
           8 * n * E, n // 2 * 4 * IMAD_FQ_MUL + n // 4 * 12 * IMAD_FQ_MUL)
    ABC = rand_field((1, 2, n), gen, dev)
    Z = rand_field((1, 2, n), gen, dev)

    def p2(step):
        return step(one, ABC, Z, r, n // 2, n // 4, mode_prev=X, mode=X,
                    single_inst=True)

    record("sc_p2_round", "sumcheck.cu",
           "spartan_parallel_tpu/ops/sumcheck.py:427",
           lambda: p2(sck.p2_step), lambda: p2(sck.p2_step_plain), cmp_step,
           8 * n * E, n * 2 * IMAD_FQ_MUL + n // 2 * 9 * IMAD_FQ_MUL)
    return rows


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
            "setup_s": setup_s, "prove_s": prove_s, "verify_s": verify_s,
            "stages": stages}


def expect_reject(run, device) -> None:
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    bad = ser.deserialize(run["bytes"], "NIZK")
    sc = bad.r1cs_sat_proof.sc_proof_phase1
    sc.comm_evals[0], sc.comm_evals[1] = sc.comm_evals[1], sc.comm_evals[0]
    try:
        bad.verify(run["inst"], run["inputs"], run["gens"],
                   Transcript(b"nizk_example"), device=device)
    except (ProofVerifyError, AssertionError):
        return
    raise AssertionError("a tampered proof verified")


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
    built = kernels.build()
    emit({"phase": "build", "card": card,
          "seconds": time.perf_counter() - t0,
          "sources": {k: round(v[0], 2) for k, v in built.items()},
          "ptxas": {k: [ln.split("ptxas info    : ")[-1]
                        for ln in v[1].splitlines() if "registers" in ln
                        or "spill" in ln]
                    for k, v in built.items()}})

    rows = check_kernels(LOG_KERNEL, dev, REPS)

    on_card = nizk_run(10, 10, dev, seed_tape=True)
    on_cpu = nizk_run(10, 10, "cpu", seed_tape=True)
    same = on_card["bytes"] == on_cpu["bytes"]
    expect_reject(on_card, dev)
    emit({"phase": "nizk_fixed_tape", "log_cons": 10,
          "bytes_identical": same, "proof_bytes": len(on_card["bytes"]),
          "prove_s_cuda": on_card["prove_s"],
          "prove_s_cpu": on_cpu["prove_s"], "tamper_rejected": True})
    if not same:
        raise AssertionError("card and CPU proofs differ")

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_counts()
    run = nizk_run(args.log_cons, 10, dev, seed_tape=False)
    counts = dict(kernels.launches)
    expect_reject(run, dev)
    emit({"phase": "nizk", "log_cons": args.log_cons, "card": card,
          "setup_s": run["setup_s"], "prove_s": run["prove_s"],
          "verify_s": run["verify_s"],
          "proof_bytes": len(run["bytes"]),
          "proof_bytes_compressed": run["compressed"],
          "upstream_compressed_bytes": 48134,
          "stages_s": run["stages"],
          "max_memory_allocated": torch.cuda.max_memory_allocated(),
          "launches": counts, "tamper_rejected": True})
    for row in rows:
        row["launches"] = counts.get(row["name"], 0)
    missing = [r["name"] for r in rows if r["launches"] == 0]
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
