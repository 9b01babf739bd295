"""The single-chip entry step and the multi-device dry run.

Counterpart of the JAX package's __graft_entry__.py:

    python -m spartan_parallel_tpu_torch.dryrun <D> [--device cpu]
        [--budget SECONDS]

`entry(device)` gives (fn, args): one phase-1 sumcheck round of the
data-parallel prover in x mode at (P_i, Q, X) = (2, 4, 16), on the tables
the JAX entry() draws (numpy's default_rng(42), 40 random bytes mod l an
element, in the order tp, tq, tx, B, C, D, r). fn runs K4's evaluations
(ops/sumcheck.py p1_evals) and then the bind (p1_bind, K1) and returns
(evals, B2); on CPU tensors the kernels' plain versions run.

`dryrun_multichip(D)` runs the stages of _dryrun_stages.py on D ranks in
the JAX plan's order, cheapest first, each as its own

    python -m spartan_parallel_tpu_torch._dryrun_stages <stage> <D>

under its own cap (the process group is killed at the cap), within a
total budget, and prints one line a stage on stderr: its seconds,
whether the ranks agree, and the proof's sha256. On the card it builds
the kernels first, so no stage pays for nvcc under its cap. It is
stricter than the JAX dryrun_multichip, which notes a stage that hits
its cap and goes on: here a stage that exits non-zero, outlasts its
cap, reports ranks that disagree, or finds no budget left fails the
run, with an error that names the stage.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import time

ENTRY_SHAPE = (2, 4, 16)  # (P_i, Q, X) of the JAX entry()
ENTRY_SEED = 42

# The JAX plan's stages in its order. Caps in seconds, from each stage's
# seconds at D = 2 with a margin for a slower or busier host: on an H100
# 27-36 s, most of it the spawn of two ranks that reach the card (PERF.md
# section 5), capped at ~3x; on the CPU 9-20 s on an idle 8-core host,
# capped at ~6-12x (the test suite runs beside six busy workers).
PLAN = ("1_sharded_round", "2_nizk", "4_dp_r1cs", "3_snark")
CAPS = {
    "cuda": {"1_sharded_round": 90.0, "2_nizk": 90.0, "4_dp_r1cs": 90.0,
             "3_snark": 120.0},
    "cpu": {"1_sharded_round": 120.0, "2_nizk": 120.0, "4_dp_r1cs": 120.0,
            "3_snark": 240.0},
}
MIN_STAGE_S = 20.0  # a stage with less budget left than this is not run
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def entry(device=None):
    """(fn, args): the phase-1 round of the JAX entry() on `device` (the
    card unless the caller names the CPU)."""
    from .core import device as _device
    from .ops import sumcheck as sck
    from .parallel.mesh import dryrun_tables

    dev = _device.resolve(device)
    t = dryrun_tables(*ENTRY_SHAPE, seed=ENTRY_SEED)
    args = tuple(t[k].to(dev) for k in ("tp", "tq", "tx", "B", "C", "D",
                                        "r"))
    n_half = ENTRY_SHAPE[2] // 2

    def forward(tp, tq, tx, B, C, D, r):
        evals = sck.p1_evals(tp, tq, tx, B, C, D, n_half, sck.MODE_X)
        B2 = sck.p1_bind(tp, tq, tx, B, C, D, r, n_half, sck.MODE_X)[3]
        return evals, B2

    return forward, args


def _say(obj) -> None:
    print(json.dumps(obj), file=sys.stderr, flush=True)


def _kill_group(proc) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


def _run_stage(stage: str, n_devices: int, device, cap: float) -> dict:
    """One stage in a process group of its own, killed at `cap` seconds.
    Returns the stage's JSON line; raises, naming the stage, when it
    fails, outlasts its cap or its ranks disagree."""
    cmd = [sys.executable, "-m", "spartan_parallel_tpu_torch._dryrun_stages",
           stage, str(n_devices), "--timeout", str(cap)]
    if device.type == "cpu":
        cmd += ["--device", "cpu"]
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=cap)
    except BaseException as e:
        _kill_group(proc)
        proc.communicate()
        if isinstance(e, subprocess.TimeoutExpired):
            raise RuntimeError(f"dryrun stage {stage} outlasted its cap "
                               f"of {cap:.1f} s") from None
        raise
    _kill_group(proc)  # any rank or helper that outlived the stage
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    report = json.loads(lines[-1]) if lines else None
    if report is not None and not report.get("ranks_agree"):
        raise RuntimeError(f"dryrun stage {stage}: the ranks' results "
                           f"disagree")
    if proc.returncode != 0 or report is None:
        raise RuntimeError(f"dryrun stage {stage} failed (exit code "
                           f"{proc.returncode}):\n{err[-4000:]}")
    return report


def dryrun_multichip(n_devices: int, device=None, stages=None,
                     budget_s: float = 420.0) -> list:
    """Run `stages` (default: the JAX plan's four, in its order) on
    `n_devices` ranks, each under its cap (CAPS for the device), within
    `budget_s` seconds. Returns one record a stage:
    its seconds, ranks_agree, sha256, and each rank's prove seconds and
    kernel launches. Raises on the first stage that does not complete."""
    from .core import device as _device

    dev = _device.resolve(device)
    if dev.type == "cuda":
        from .ops import kernels

        t_build = time.monotonic()
        kernels.build()
        _say({"dryrun_build_s": time.monotonic() - t_build})
    caps = CAPS[dev.type]
    t0 = time.monotonic()
    done = []
    for stage in PLAN if stages is None else stages:
        left = budget_s - (time.monotonic() - t0)
        if left < MIN_STAGE_S:
            raise RuntimeError(f"dryrun stage {stage}: {left:.1f} s of the "
                               f"{budget_s} s budget left")
        cap = min(caps.get(stage, left), left)
        t_stage = time.monotonic()
        report = _run_stage(stage, n_devices, dev, cap)
        rec = {"dryrun_stage": stage, "world": n_devices,
               "seconds": time.monotonic() - t_stage, "cap_s": cap,
               "ranks_agree": report["ranks_agree"],
               "sha256": report["sha256"],
               "prove_s": [r.get("prove_s") for r in report["ranks"]],
               "launches": [r["launches"] for r in report["ranks"]],
               "t_s": time.monotonic() - t0}
        _say(rec)
        done.append(rec)
    return done


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int, help="the number of ranks, D")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (the default)")
    ap.add_argument("--budget", type=float, default=420.0,
                    help="seconds for all the stages")
    a = ap.parse_args(argv)
    try:
        dryrun_multichip(a.n_devices, a.device, budget_s=a.budget)
    except RuntimeError as e:
        print(f"dryrun: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
