"""The port's entry step and multi-device dry run
(spartan_parallel_tpu_torch/dryrun.py) on the CPU: entry("cpu") against
the JAX package's __graft_entry__.entry() (run jitted in one fresh
process), exact; the dry run's first two stages on two gloo ranks, each
stage a subprocess under its cap; and the ways a run fails: a stage that
_dryrun_stages rejects, a stage over its cap, a budget too small for the
first stage (the command's exit code)."""

import json
import subprocess
import sys
import time

import numpy as np
import pytest

from spartan_parallel_tpu_torch import dryrun

from .torch_shared import in_fresh_process, shared_result

JAX_S = 600
ARGS = ("tp", "tq", "tx", "B", "C", "D", "r")


def jax_entry():
    """__graft_entry__.entry()'s tables and its forward's (evals, B2),
    jitted as tests/test_sharding.py runs it, as numpy arrays."""
    import importlib.util
    import pathlib

    import jax

    spec = importlib.util.spec_from_file_location(
        "__graft_entry__",
        pathlib.Path(dryrun.ROOT) / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    evals, B2 = jax.jit(fn)(*args)
    return {"args": [np.asarray(a) for a in args],
            "evals": np.asarray(evals), "B2": np.asarray(B2)}


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return shared_result(tmp_path_factory, "jax_entry", lambda:
                         in_fresh_process(jax_entry, timeout=JAX_S))


def same(port, ref) -> bool:
    return port.shape == ref.shape and np.array_equal(
        port.numpy().astype(np.int64), ref.astype(np.int64))


def test_entry_matches_jax(jax_ref):
    """entry("cpu") draws the JAX entry()'s tables (parallel/mesh.py
    dryrun_tables at (2, 4, 16), seed 42) and its round gives the same
    evaluations and bound B table, limb for limb."""
    fn, args = dryrun.entry("cpu")
    for name, a, ref in zip(ARGS, args, jax_ref["args"]):
        assert same(a, ref), name
    evals, B2 = fn(*args)
    assert same(evals, jax_ref["evals"])
    assert same(B2, jax_ref["B2"])


def test_dryrun_first_stages_pass(capsys):
    """Stages 1_sharded_round and 2_nizk on two ranks: both complete
    under their caps, and each stage's line says the ranks agree."""
    stages = ("1_sharded_round", "2_nizk")
    recs = dryrun.dryrun_multichip(2, device="cpu", stages=stages)
    assert [r["dryrun_stage"] for r in recs] == list(stages)
    lines = [json.loads(ln) for ln in capsys.readouterr().err.splitlines()
             if ln.startswith('{"dryrun_stage"')]
    assert lines == recs
    for rec in recs:
        assert rec["ranks_agree"] is True
        assert len(rec["sha256"]) == 64


def test_rejected_stage_fails_the_run():
    with pytest.raises(RuntimeError, match="no_such_stage failed"):
        dryrun.dryrun_multichip(2, device="cpu", stages=("no_such_stage",))


def test_stage_over_its_cap_fails_the_run(monkeypatch):
    """A cap far below the stage's time: the stage's process group is
    killed at the cap and the run fails, naming the stage."""
    monkeypatch.setitem(dryrun.CAPS["cpu"], "1_sharded_round", 1.0)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError,
                       match="1_sharded_round outlasted its cap"):
        dryrun.dryrun_multichip(2, device="cpu",
                                stages=("1_sharded_round",))
    assert time.monotonic() - t0 < 30


def test_no_budget_fails_the_command():
    """A budget below a stage's minimum: the command runs no stage and
    exits non-zero, naming the first stage."""
    r = subprocess.run(
        [sys.executable, "-m", "spartan_parallel_tpu_torch.dryrun", "2",
         "--device", "cpu", "--budget", "1"], cwd=dryrun.ROOT,
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 1
    assert "dryrun stage 1_sharded_round" in r.stderr
    assert '"dryrun_stage"' not in r.stderr
