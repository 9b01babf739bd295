#!/usr/bin/env python3
"""The redesigned kernels end to end, one tree at a time: K2 (the batched
MSM, csrc/msm.cu), K11 (the ZK round tail, csrc/zk_round.cu),
fold_points (csrc/msm.cu k_fold), and every other kernel by name and by
caller (K1's eq table, K4's sumcheck rounds, ...).

    python3 k2_turns.py --root DIR  # the port under DIR (another checkout)
    python3 k2_turns.py --root DIR --points  # K12 and K13 alone

Proves with the port found under --root (another checkout, e.g. a parent
commit unpacked by `git archive`, or this one) on one CUDA card: the NIZK
at 2^20 x 2^20 x 10 inputs (chip_smoke.py phase 4), the data-parallel
R1CSProof of BASELINE config 4 with skewed counts [512, 128, 32, 32]
(phase 5: witness commit, then prove with device-resident rounds, then the
same tape with the host round loop) and with uniform counts [256] x 4
(phase 6, the dense prover, device rounds), the 9-stage SNARK at the
find_min shape (phase 8) and the SNARK with SPARK at 2^20 x 2^20 x 10
inputs (phase 7), each under its fixed tape, with every kernel launch
timed by CUDA events (chip_smoke.kernel_trace), after one untraced
prove of the counter program has loaded every kernel library. Every
prove here is traced, in both trees and both forms alike, so its
seconds carry the events' cost and compare only with each other
(chip_smoke.py's
`prove_s` are untraced). Prints one JSON line: the card, the tree, each
prove's seconds and kernel launches, K2's, K11's and fold_points'
launches and ms inside the prove, K1's, K3's, K5's and K7's ([launches,
ms]: `k1`, `k3`, `k5`, `k7`) and every kernel's (`by_kernel`,
summed over its launches; K2 also inside the witness commits: NIZK
`witness_commit`, config 4's commit, find_min `input_commit`; the
SNARK's eval proof, `R1CSEvalProof::prove`, apart) and every caller's
(`by_caller`: each launch under the counter its wrapper counted it
under too, e.g. K1's eq_fold, hash_poly, dotp_eval, or else the first
function outside ops/ that made it), the launches whose start event
the card had passed before the host enqueued them (`starved`: their
traced ms hold host time), config 4's phase-1 sumcheck
seconds in both forms, each proof's sha256, and K2's bullet rows alone
(1 x 514 ... 1 x 34, 50 launches each: chip_smoke.py phase 2 times them
too, but in one tree a call, and a comparison of two trees needs both
on one card in one call).
With --points it times only K12 (point_sum) and K13 (scale_points) at
chip_smoke.py phase 2's shapes and scalar: a call on CUDA events (`ms`,
the wrapper's host time included) and its launches' device time alone
(`launch_ms`), the device time of a call's kernels queued back to back
behind a spin of the card (`queued_ms`: the host's time is hidden), and
each output's sha256 (equal across trees; chip_smoke holds them against
the plain versions).
Run two trees in turns (A, B, B, A) back to back on one card to compare
them; the helpers come from this checkout's chip_smoke.py. Needs a CUDA
card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose spartan_parallel_tpu_torch to run")
    ap.add_argument("--points", action="store_true",
                    help="time K12 and K13 alone")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_turns: no CUDA device", file=sys.stderr)
        return 2
    import importlib.util

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from spartan_parallel_tpu_torch import examples as ex
    from spartan_parallel_tpu_torch.ops import kernels

    if not kernels.__file__.startswith(root):
        raise RuntimeError(f"the port came from {kernels.__file__}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    h = hashlib.sha256()
    csrc = os.path.join(root, "spartan_parallel_tpu_torch", "csrc")
    for f in sorted(os.listdir(csrc)):
        if f.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, f), "rb") as fh:
                h.update(fh.read())
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    if args.points:
        print(json.dumps({"card": card, "root": root,
                          "kernel_source_sha256": h.hexdigest()[:16],
                          **point_rows(cs, dev)}), flush=True)
        return 0
    # a kernel library loads at its first launch (ctypes opens it and its
    # CUDA runtime starts, milliseconds inside that launch's events): one
    # small prove first, untraced, launches them all
    cs.zkvm_run(*ex.build_counter_program(), dev, b"\x07" * 32)
    out = {"card": card, "root": root,
           "kernel_source_sha256": h.hexdigest()[:16],
           "build_s": build_s}
    with cs.kernel_trace() as tr:
        run = cs.nizk_run(20, 10, dev, seed_tape=True)
    out["nizk"] = {"prove_s": run["prove_s"],
                   "witness_commit_s": run["stages"]["witness_commit"],
                   **cs.traced(tr, (("witness_commit", "witness_commit"),
                                    ("prove", "NIZK::prove"))),
                   "proof_sha256": hashlib.sha256(run["bytes"]).hexdigest()}
    del run
    skewed = [512, 128, 32, 32]
    with cs.kernel_trace() as tr:
        run = cs.dp_run(skewed, 10, 10, dev, seed_tape=True)
    with cs.host_loop(), cs.kernel_trace() as tr_host:
        base = cs.dp_run(skewed, 10, 10, dev, seed_tape=True)
    out["dp_skewed"] = {
        "commit_s": run["commit_s"], "prove_s": run["prove_s"],
        "prove_sc_phase_one_s": run["stages_s"]["prove_sc_phase_one"],
        **cs.traced(tr, (("witness_commit", "witness_commit"),
                         ("prove", "R1CSProof::prove"))),
        "proof_sha256": hashlib.sha256(run["bytes"]).hexdigest(),
        "host_loop": {
            "prove_s": base["prove_s"],
            "prove_sc_phase_one_s": base["stages_s"]["prove_sc_phase_one"],
            **cs.traced(tr_host, (("prove", "R1CSProof::prove"),)),
            "proof_sha256": hashlib.sha256(base["bytes"]).hexdigest()}}
    del run, base
    with cs.kernel_trace() as tr:
        run = cs.dp_run([256] * 4, 10, 10, dev, seed_tape=True)
    out["dp_uniform"] = {
        "prove_s": run["prove_s"],
        **cs.traced(tr, (("prove", "R1CSProof::prove"),)),
        "proof_sha256": hashlib.sha256(run["bytes"]).hexdigest()}
    del run
    zk_args, zk_pa = ex.build_synthetic_zkvm(
        num_blocks=9, block_cons=8192, num_execs=cs.FINDMIN_EXECS)
    with cs.kernel_trace() as tr:
        run = cs.zkvm_run(zk_args, zk_pa, dev, b"\x0f" * 32)
    out["findmin"] = {"prove_s": run["prove_s"],
                      "input_commit_s": run["stages_s"]["input_commit"],
                      **cs.traced(tr, (("input_commit", "input_commit"),
                                       ("prove", "SNARK::prove"))),
                      "proof_sha256": hashlib.sha256(
                          run["bytes"]).hexdigest()}
    del run
    with cs.kernel_trace() as tr:
        run = cs.snark_run(20, 10, dev, seed_tape=True)
    out["snark"] = {"prove_s": run["prove_s"],
                    "eval_proof_s": run["stages_s"]["R1CSEvalProof::prove"],
                    **cs.traced(tr, (("prove", "SNARK::prove"),
                                     ("eval_proof", "R1CSEvalProof::prove"))),
                    "proof_sha256": hashlib.sha256(run["bytes"]).hexdigest()}
    del run
    for cell in ("nizk", "dp_skewed", "dp_uniform", "findmin", "snark"):
        bk = out[cell]["by_kernel"]["prove"]
        out[cell]["launches"] = sum(n for n, _ in bk.values())
        # K1, K3, K5 and K7 summed (chip_smoke.KERNEL_GROUPS)
        out[cell].update(cs.kernel_groups(bk))
    # K2's bullet rows alone, at chip_smoke.py phase 2's shapes and points
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.ops import msm

    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    pts = MultiCommitGens(1024, b"chip_smoke").device_points(dev)
    out["k2_bullet_rows_ms"] = {}
    for n in (514, 258, 130, 66, 34):
        sc = cs.rand_field((1, n), gen, dev)
        out["k2_bullet_rows_ms"][n] = cs.cuda_ms(
            lambda: msm.msm_dev(pts[:n], sc), 50)
    print(json.dumps(out), flush=True)
    return 0


def point_rows(cs, dev) -> dict:
    """K12 at chip_smoke.K12_SHAPES and K13 at 32 and 4096 points and
    chip_smoke.k13_scalar(), on chip_smoke.py phase 2's points: ms,
    launch_ms and the output's sha256 a row."""
    import torch

    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.ops import curve

    pts = MultiCommitGens(1024, b"chip_smoke").device_points(dev)
    rows = {}

    def row(name, fn, reps):
        ms = cs.cuda_ms(fn, reps)
        with cs.kernel_trace() as tr:
            for _ in range(reps):
                fn()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        torch.cuda._sleep(50_000_000)  # ~25 ms: the calls queue behind it
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        out = fn().cpu().numpy()
        rows[name] = {"ms": ms, "launch_ms": sum(
            t for _, t in tr.by_kernel().values()) / reps,
            "queued_ms": start.elapsed_time(end) / reps,
            "out_sha256": hashlib.sha256(out.tobytes()).hexdigest()[:16]}

    for d, b in cs.K12_SHAPES:
        parts = torch.stack([torch.roll(pts[:b], k, 0) for k in range(d)])
        row(f"point_sum_{d}x{b}", lambda p=parts: curve.point_sum(p), 20)
    k = cs.k13_scalar()
    for n in (32, 4096):
        p = torch.cat([torch.roll(pts, j, 0) for j in range(4)])[:n]
        row(f"scale_points_{n}", lambda p=p.contiguous(): curve.scale_points(
            p, k), 5)
    return rows


if __name__ == "__main__":
    sys.exit(main())
