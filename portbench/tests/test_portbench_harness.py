"""CPU tests of the benchmark's harness: files found by name, traffic from
the seed, the roofline counts, the window and idle arithmetic, the result
line, the JAX check and the refusal without a card.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness, tracer, work, workload  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec(ROOT)


def test_every_cell_finds_its_files(spec):
    for w in spec["workloads"]:
        cell, cfg, traffic = harness.cell_files(spec, w["name"], ROOT)
        assert cfg["name"] == cell["config"]
        system = harness.system_module(cfg).System
        assert traffic["loop"] == "closed"
        for step in traffic.get("prepare", []) + traffic["steps"]:
            assert callable(getattr(system, step))
        for trace in (False, True):
            for m in harness.cell_metrics(spec, w["name"], trace):
                assert callable(harness.metric_module(m["name"]).read)


def test_contract_shapes(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["source"]) <= 200
        assert c["file"].startswith("portbench/")
        with open(os.path.join(ROOT, c["file"]), encoding="utf-8") as fh:
            body = json.load(fh)
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert body["assumed"] and body["setup_convention"]
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    for m in spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.setdefault(m["layer"], 0)
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert harness.cell_metrics(spec, w["name"], True)


def test_traffic_is_a_function_of_the_seed():
    t = {"loop": "closed", "steps": ["prove"]}
    for seed in (0, 7, 2**31 + 5, 2**33 + 1, -3):
        a = [next(s) for s in [workload.requests(t, seed, 2)] for _ in
             range(6)]
        b = [next(s) for s in [workload.requests(t, seed, 2)] for _ in
             range(6)]
        assert a == b
        assert [r["input"] for r in a[:2]] == [r["input"] for r in a[2:4]]
        assert sorted(r["input"] for r in a[:2]) == [0, 1]
        assert len({r["tape_seed"] for r in a}) == 6
    x = [next(workload.requests(t, 1, 2))["tape_seed"]]
    y = [next(workload.requests(t, 2, 2))["tape_seed"]]
    assert x != y
    r1 = workload.random_scalars(workload.rng_for(5, "r1cs"), 4)
    r2 = workload.random_scalars(workload.rng_for(5, "r1cs"), 4)
    assert r1 == r2 and r1 != workload.random_scalars(
        workload.rng_for(6, "r1cs"), 4)
    with pytest.raises(ValueError):
        next(workload.requests({"loop": "open", "steps": ["prove"]}, 1, 2))
    with pytest.raises(ValueError):
        next(workload.requests({"loop": "closed"}, 1, 2))
    p = workload.prepared(3, 2)
    assert [r["input"] for r in p] == [0, 1] and p == workload.prepared(3, 2)
    assert {r["tape_seed"] for r in p}.isdisjoint(
        r["tape_seed"] for r in a)


def test_statement_is_upstreams_synthetic_r1cs():
    """Row i: A[i, i] = 1, B[i, i + 2] = 1, C[i, i + 3] =
    z_i z_(i+2) / z_(i+3), columns mod |z|, z = [vars | 1, inputs]
    uniform; every row holds; the same seed gives the same statement."""
    L = workload.L
    (A, B, C), w, inp = workload.synthetic_r1cs(
        64, 64, 3, workload.rng_for(1, "x"))
    assert len(w) == 64 and len(inp) == 3
    z = w + [1] + inp
    for i in range(64):
        assert (A[0][i], A[1][i], A[2][i]) == (i, i, 1)
        assert (B[0][i], B[1][i], B[2][i]) == (i, (i + 2) % 68, 1)
        assert (C[0][i], C[1][i]) == (i, (i + 3) % 68)
        assert C[2][i] * z[C[1][i]] % L == z[i] * z[(i + 2) % 68] % L
    again = workload.synthetic_r1cs(64, 64, 3, workload.rng_for(1, "x"))
    assert again[1] == w and again[0][2][2] == C[2]
    assert workload.synthetic_r1cs(
        64, 64, 3, workload.rng_for(2, "x"))[1] != w
    assert workload._batch_inverse([3, 0, 5]) == [
        pow(3, -1, L), 0, pow(5, -1, L)]


def test_msm_work_at_known_shapes():
    # one row of 1024 full-width scalars
    adds, dbls = work.pippenger_least(1024, 253)
    a8, d8 = work.pippenger_8bit(1024)
    assert adds <= a8 and dbls <= d8
    # at c = 8: 32 windows of (1024 (1 - 1/256) + 2 * 128) additions
    assert adds <= 32 * (1024 * (1 - 1 / 256) + 256)
    nbytes, muls = work.msm_work(1024, [(1024, 253)] * 512)
    assert nbytes == 1024 * 64 + 512 * (1024 * 32 + 32)
    assert muls == 512 * (adds * work.ADD_MULS + dbls * work.DBL_MULS)
    # never above the 8-bit design's count, at any width or count
    for n in (1, 2, 33, 257, 1024, 1 << 16):
        for bits in (1, 8, 64, 253):
            a, d = work.pippenger_least(n, bits)
            a8, d8 = work.pippenger_8bit(n, bits)
            assert a * work.ADD_MULS + d * work.DBL_MULS <= \
                a8 * work.ADD_MULS + max(d8, 0) * work.DBL_MULS + 1e-6
    assert work.pippenger_least(0, 253) == (0.0, 0.0)
    # a single small scalar costs less than a full-width one
    assert work.pippenger_least(1, 4)[0] < work.pippenger_least(1, 253)[0]


def test_product_work_at_known_shapes():
    nb, m = work.tree_work(12, 1 << 20)
    assert m == 12 * ((1 << 20) - 1) * work.FMUL
    assert nb == (12 * (1 << 20) + 12 * ((1 << 20) - 1)) * 32
    nb, m = work.round_work(12, 1 << 19, 0, False)
    assert m == (6 * (1 << 18) * 12 + 36) * work.FMUL
    assert nb == 25 * (1 << 19) * 32 + 96
    nb, m = work.round_work(12, 1 << 19, 6, True)
    tables = 25 + 18
    assert m == (tables * (1 << 18) + 6 * (1 << 17) * 18 + 54) * work.FMUL
    assert nb == tables * (1 << 19) * 32 + tables * (1 << 18) * 32 + 96
    assert work.fold_work(12, 6) == (43 * 96, 43 * work.FMUL)
    rate = work.int32_rate(132, 1.98e9)
    assert rate == pytest.approx(1.6727e13, rel=1e-4)
    assert work.least_seconds(3.35e12, 0, rate) == pytest.approx(1.0)
    assert work.least_seconds(0, rate * 2, rate) == pytest.approx(2.0)


def test_idle_and_window_arithmetic():
    merged = tracer._union([(0, 1), (0.5, 2), (5, 6), (3, 4)])
    assert merged == [[0, 2], [3, 4], [5, 6]]
    assert tracer.covered(merged, 1, 5.5) == pytest.approx(2.5)
    assert tracer.idle_share(merged, [(0, 10)]) == pytest.approx(60.0)
    assert tracer.idle_share(merged, [(0, 2), (2, 3)]) == \
        pytest.approx(100 / 3)
    assert tracer.idle_share(merged, []) is None
    ev = {"nonzero": _T([1024]), "bits": _T([253]), "n": 1024}
    k2 = [dict(ev, step="prove", req=0, device_s=1.0),
          dict(ev, step="prove", req=9, device_s=5.0),  # outside the window
          dict(ev, step="verify", req=0, device_s=5.0)]
    rate = 1e12
    ctx = {"times": {"prove": [2.0, 4.0], "verify": [1.0]},
           "setup_s": 12.5, "ids": {"prove": [0, 1], "verify": [0]},
           "stages": {"prove": [
               {"R1CSProof::prove": 1.0, "R1CSEvalProof::prove": 0.5},
               {"R1CSProof::prove": 3.0}],
               "verify": [{"verify_eval_proof": 0.25}]},
           "counts": {"host.launches_per_proof": {
               ("prove", 0): 100, ("prove", 1): 300, ("verify", 0): 7,
               ("prove", 9): 50}},
           "calls": {"kernel.k2_roofline": k2}, "int32_rate": rate,
           "trace": {"device": merged},
           "spans": {"prove": [(0, 10)], "verify": [(0, 2)]}}
    least = work.least_seconds(*work.msm_work(1024, [(1024, 253)]), rate)
    want = {"prove_s": 3.0, "verify_s": 1.0, "setup_s": 12.5,
            "stage.sat_proof_s": 2.0, "stage.eval_proof_s": 0.5,
            "stage.verify_eval_s": 0.25, "host.launches_per_proof": 200.0,
            "kernel.k2_roofline": 100.0 * least,
            "kernel.k6_roofline": None,
            "device.idle_prove": 60.0, "device.idle_verify": 0.0}
    for name, v in want.items():
        got = harness.metric_module(name).read(ctx)
        assert got == (pytest.approx(v) if v is not None else None), name
    assert harness.metric_module("prove_s").read(dict(ctx, times={})) is None


class _T(list):
    """A list that answers .tolist(), as the tensors of a call do."""

    def tolist(self):
        return list(self)


def test_a_metric_file_names_what_it_wraps():
    """The tracer installs what a metric's WRAPS names, ties each call to
    its step and request, and puts the original back."""
    import types

    seen = types.SimpleNamespace(WRAPS={
        "portbench.work:int32_rate": lambda sms, hz: {"sms": sms},
        "portbench.work:least_seconds": None})
    orig = work.int32_rate, work.least_seconds
    t = tracer.Tracer("unused.json")
    t.install({"m.calls": seen})
    t.at("prove", 4)
    assert work.int32_rate(2, 1.0) == 128.0
    work.least_seconds(1.0, 1.0, 1.0)
    work.least_seconds(1.0, 1.0, 1.0)
    t.at(None, None)
    t.uninstall()
    assert (work.int32_rate, work.least_seconds) == orig
    assert [(c["sms"], c["step"], c["req"]) for c in t.calls["m.calls"]] \
        == [(2, "prove", 4)]
    assert t.counts["m.calls"] == {("prove", 4): 2}
    for m in harness.load_spec(ROOT)["per_layer"]:
        for target in getattr(harness.metric_module(m["name"]), "WRAPS", {}):
            mod, attr = target.split(":")
            assert mod.startswith("spartan_parallel_tpu_torch."), target
            assert callable(getattr(__import__(mod, fromlist=[attr]), attr))


def test_call_device_seconds_from_correlation():
    parsed = tracer.parse([
        {"ph": "X", "cat": "user_annotation", "name": "c:k2#0",
         "ts": 10, "dur": 10},
        {"ph": "X", "cat": "user_annotation", "name": "c:k2#1",
         "ts": 30, "dur": 10},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 12, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_driver", "name": "cuLaunchKernel",
         "ts": 31, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k_msm", "ts": 14, "dur": 5,
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k_msm", "ts": 33, "dur": 2,
         "args": {"correlation": 8}},
    ])
    assert tracer.call_device_seconds(parsed, "k2", 2) == \
        pytest.approx([5e-6, 2e-6])
    assert tracer.call_device_seconds(parsed, "k6", 1) is None
    assert parsed["ops"]["k_msm"] == pytest.approx(7e-6)


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["spartan_parallel_tpu_torch.x", "spartan_parallel_tpu_torch",
         "jaxtyping", "numpy"]) == []
    assert harness.forbidden_modules(
        ["spartan_parallel_tpu.x", "jax.numpy", "jaxlib", "flax.linen",
         "spartan_parallel_tpu"]) == sorted(
        ["spartan_parallel_tpu.x", "jax.numpy", "jaxlib", "flax.linen",
         "spartan_parallel_tpu"])


def test_the_harness_imports_no_jax():
    code = ("import sys; sys.path.insert(0, %r); "
            "import portbench.harness, portbench.tracer, "
            "portbench.tracedata, portbench.reference.checks, "
            "portbench.systems.spartan_snark, "
            "spartan_parallel_tpu_torch.models.snark_single; "
            "from portbench.harness import forbidden_modules as f; "
            "print(f())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=dict(
                             os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(ROOT, "portbench", "reference")
    for f in os.listdir(ref):
        if f.endswith(".py"):
            with open(os.path.join(ref, f), encoding="utf-8") as fh:
                src = fh.read()
            assert "spartan_parallel_tpu" not in src, f
            assert "import jax" not in src and "torch" not in src, f


def test_measurement_path_refuses_without_a_card(spec):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(harness.NoCard):
        harness.run_cell(spec, spec["workloads"][0]["name"], 1, 1.0, False,
                         torch.device("cpu"))
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "portbench", "run.py"),
         "--workload", spec["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        timeout=300, cwd=ROOT)
    assert out.returncode == 2
    assert out.stdout.strip() == ""


def test_result_line_keys_on_the_cpu(spec, tmp_path):
    """A whole run at a tiny size on the CPU (the card's look skipped):
    the result line's keys, the compared numbers last."""
    import torch

    cell = "snark_2p20.prove_verify"
    _, cfg, _ = harness.cell_files(spec, cell, ROOT)
    cfg = dict(cfg, num_cons=64, num_vars=64, num_inputs=3)
    res, lines = harness.run_cell(
        spec, cell, 2**31 + 99, 0.01, True, torch.device("cpu"), cfg=cfg,
        require_card=False, trace_path=str(tmp_path / "t.json"))
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    assert set(res["checks"]) == {"failed.prove", "failed.verify",
                                  "unchecked", "commit", "claims",
                                  "sections", "evals"}
    assert all(v == {"value": 0, "limit": 0}
               for v in res["checks"].values())
    assert lines[-1].startswith("check evals: 0 (limit 0)")
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes", "busy_s",
                                  "window_s"}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(res)


def test_a_mix_is_data_alone(spec):
    """A mix that only verifies proofs made in set-up runs from its data
    file's steps, with no code of its own: the verifies are timed, the
    set-up proof is judged."""
    import torch

    cell = "snark_2p20.prove_verify"
    _, cfg, _ = harness.cell_files(spec, cell, ROOT)
    cfg = dict(cfg, num_cons=64, num_vars=64, num_inputs=3)
    mix = {"loop": "closed", "prepare": ["prove"], "steps": ["verify"]}
    res, lines = harness.run_cell(
        spec, cell, 2**31 + 98, 0.5, False, torch.device("cpu"), cfg=cfg,
        require_card=False, traffic=mix)
    assert res["correct"] is True, lines
    assert set(res["metrics"]) == {"verify_s", "setup_s"}
    assert set(res["checks"]) >= {"failed.verify", "commit"}
    assert "failed.prove" not in res["checks"]
