#!/usr/bin/env python3
"""K2 (the batched MSM, csrc/msm.cu) end to end, one tree at a time.

    python3 k2_turns.py --root DIR  # the port under DIR (another checkout)

Proves with the port found under --root (another checkout, e.g. a parent
commit unpacked by `git archive`, or this one) on one CUDA card: the NIZK
at 2^20 x 2^20 x 10 inputs (chip_smoke.py phase 4), the data-parallel
R1CSProof of BASELINE config 4 with skewed counts [512, 128, 32, 32]
(phase 5: witness commit, then prove) and the 9-stage SNARK at the
find_min shape (phase 8), each under its fixed tape, with every K2 launch
timed by CUDA events (chip_smoke.K2Trace). Prints one JSON line: the card,
the tree, each prove's seconds, its K2 launches and ms, and K2's ms inside
the witness commits (NIZK `witness_commit`, config 4's commit, find_min
`input_commit`). Run two trees in turns (A, B, B, A) in one session on one
card to compare them; the helpers come from this checkout's chip_smoke.py.
Needs a CUDA card; imports nothing of JAX.
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
    for f in ("msm.cu", "msm.cuh"):
        path = os.path.join(root, "spartan_parallel_tpu_torch", "csrc", f)
        if os.path.exists(path):
            with open(path, "rb") as fh:
                h.update(fh.read())
    t0 = time.perf_counter()
    kernels.build()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda")
    out = {"card": card, "root": root, "msm_source_sha256": h.hexdigest()[:16],
           "build_s": build_s}
    with cs.k2_trace() as k2:
        run = cs.nizk_run(20, 10, dev, seed_tape=True)
    out["nizk"] = {"prove_s": run["prove_s"],
                   "witness_commit_s": run["stages"]["witness_commit"],
                   "k2_witness_commit": k2.summary("witness_commit"),
                   "k2_prove": k2.summary("NIZK::prove"),
                   "proof_sha256": hashlib.sha256(run["bytes"]).hexdigest()}
    del run
    with cs.k2_trace() as k2:
        run = cs.dp_run([512, 128, 32, 32], 10, 10, dev, seed_tape=True)
    out["dp_skewed"] = {"commit_s": run["commit_s"],
                        "prove_s": run["prove_s"],
                        "k2_witness_commit": k2.summary("witness_commit"),
                        "k2_prove": k2.summary("R1CSProof::prove"),
                        "proof_sha256": hashlib.sha256(
                            run["bytes"]).hexdigest()}
    del run
    zk_args, zk_pa = ex.build_synthetic_zkvm(
        num_blocks=9, block_cons=8192, num_execs=cs.FINDMIN_EXECS)
    with cs.k2_trace() as k2:
        run = cs.zkvm_run(zk_args, zk_pa, dev, b"\x0f" * 32)
    out["findmin"] = {"prove_s": run["prove_s"],
                      "input_commit_s": run["stages_s"]["input_commit"],
                      "k2_input_commit": k2.summary("input_commit"),
                      "k2_prove": k2.summary("SNARK::prove"),
                      "proof_sha256": hashlib.sha256(
                          run["bytes"]).hexdigest()}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
