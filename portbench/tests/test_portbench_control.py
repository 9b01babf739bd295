"""The control of the correctness check, on the card: the port proves a
witness with one entry changed (the statement's guarantee that every
proof is of the benchmark's own witness is broken), and the run must come
out `correct: false`.

Marked `gpu`: skips on a host without a CUDA card. By default at a tiny
size; at the cells' own sizes with PORTBENCH_CONTROL=cell:

    PORTBENCH_CONTROL=cell python -m pytest portbench/tests/test_portbench_control.py -q -s
"""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

pytestmark = pytest.mark.gpu

TINY = {
    "snark_2p20.prove_verify": dict(num_cons=1024, num_vars=1024),
}
SEEDS = (3100000001, 3100000002, 3100000003)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _corrupt(system) -> None:
    """One entry of the witness the prover is handed, changed; the
    reference builds the statement again from the seed."""
    system.vars = list(system.vars)
    system.vars[1] = (system.vars[1] + 1) % harness.workload.L


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", sorted(TINY))
def test_the_control_is_not_correct(card, monkeypatch, cell, seed):
    full = os.environ.get("PORTBENCH_CONTROL") == "cell"
    spec = harness.load_spec(ROOT)
    _, cfg, _ = harness.cell_files(spec, cell, ROOT)
    if not full:
        cfg = dict(cfg, **TINY[cell])
    orig = harness.system_module

    def control(c):
        mod = orig(c)

        class Control(mod.System):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self._armed = False

            def verify(self, req, rec):
                # the warm-up request stays sound; every timed one is not
                rec = super().verify(req, rec)
                if not self._armed:
                    self._armed = True
                    _corrupt(self)
                return rec

        return type("M", (), {"System": Control})

    monkeypatch.setattr(harness, "system_module", control)
    res, lines = harness.run_cell(spec, cell, seed, 12.0 if full else 2.0,
                                  False, card, cfg=cfg)
    print(json.dumps({"cell": cell, "seed": seed, "full": full,
                      "correct": res["correct"], "checks": res["checks"]}))
    assert res["correct"] is False, lines
