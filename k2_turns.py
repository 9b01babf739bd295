#!/usr/bin/env python3
"""The chain kernels end to end, one tree at a time: K2 (the batched MSM,
csrc/msm.cu), K11 (the ZK round tail, csrc/zk_round.cu) and fold_points
(csrc/msm.cu k_fold).

    python3 k2_turns.py --root DIR  # the port under DIR (another checkout)

Proves with the port found under --root (another checkout, e.g. a parent
commit unpacked by `git archive`, or this one) on one CUDA card: the NIZK
at 2^20 x 2^20 x 10 inputs (chip_smoke.py phase 4), the data-parallel
R1CSProof of BASELINE config 4 with skewed counts [512, 128, 32, 32]
(phase 5: witness commit, then prove with device-resident rounds, then the
same tape with the host round loop) and the 9-stage SNARK at the find_min
shape (phase 8), each under its fixed tape, with every kernel launch timed
by CUDA events (chip_smoke.kernel_trace). Every prove here is traced, in
both trees and both forms alike, so its seconds carry the events' cost
and compare only with each other (chip_smoke.py's `prove_s` are
untraced). Prints one JSON line: the card, the tree, each prove's
seconds, K2's, K11's and fold_points' launches and ms inside the prove
and every kernel's (`by_kernel`, summed over its launches; K2 also inside
the witness commits: NIZK `witness_commit`, config 4's commit, find_min
`input_commit`), config 4's phase-1 sumcheck seconds in both forms, each
proof's sha256, and K2's bullet rows alone (1 x 514 ... 1 x 34, 50
launches each: chip_smoke.py phase 2 times them too, but in one tree a
call, and a comparison of two trees needs both on one card in one call).
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


if __name__ == "__main__":
    sys.exit(main())
