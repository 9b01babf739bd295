"""The harness against a broken program: whole runs on the CPU at a tiny
size (the look for a card skipped), with a fault planted in the port's
timed path underneath, must come out `correct: false`.

The faults a cell can have: a step that returns its state unchanged (a
sumcheck bind, or the eq table's fold, that does not bind); half of the
batch left out (a row commit that commits only its first half of rows);
an answer altered where it is produced (an evaluation, or a commitment
row). Both cells run on one chip, so no exchange between chips can be
left out.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402

TINY = {
    "snark_2p20.prove_verify": dict(num_cons=64, num_vars=64, num_inputs=3),
}


def _same_state(outs, ins):
    """outs with each tensor replaced by the input it came from, cut to
    its shape: the step ran, but its state did not move."""
    import torch

    tens = [t for t in ins if isinstance(t, torch.Tensor)]
    out = []
    for o in outs:
        if isinstance(o, torch.Tensor):
            src = next((t for t in tens if t.dim() == o.dim() and all(
                a >= b for a, b in zip(t.shape, o.shape))), None)
            if src is not None:
                o = src[tuple(slice(0, s) for s in o.shape)].clone()
        out.append(o)
    return out


def _unchanged_bind(monkeypatch):
    from spartan_parallel_tpu_torch.ops import sumcheck as sck

    p1_bind, p1_step, eq_fold = sck.p1_bind, sck.p1_step, sck.eq_fold

    def bind(*a, **kw):
        new = p1_bind(*a, **kw)
        return type(new)(_same_state(new, a))

    def step(*a, **kw):
        evd, new = p1_step(*a, **kw)
        return evd, type(new)(_same_state(new, a))

    def fold(t, r, n_half):
        return _same_state([eq_fold(t, r, n_half)], [t])[0]

    monkeypatch.setattr(sck, "p1_bind", bind)
    monkeypatch.setattr(sck, "p1_step", step)
    monkeypatch.setattr(sck, "eq_fold", fold)


def _half_batch(monkeypatch):
    from spartan_parallel_tpu_torch.models import dense_mlpoly

    orig = dense_mlpoly.commit_rows_device

    def commit(rows, blinds, gens):
        pts = orig(rows, blinds, gens)
        half = max(1, len(pts) // 2)
        zero = orig(rows[:1] * 0, blinds[:1], gens)[0]
        return pts[:half] + [zero] * (len(pts) - half)

    monkeypatch.setattr(dense_mlpoly, "commit_rows_device", commit)


def _altered_answer(monkeypatch):
    from spartan_parallel_tpu_torch.core.field import Scalar
    from spartan_parallel_tpu_torch.models import dense_mlpoly
    from spartan_parallel_tpu_torch.models.r1csinstance import R1CSInstance

    orig_eval = R1CSInstance.multi_evaluate

    def multi_evaluate(self, rx, ry, device=None):
        out = list(orig_eval(self, rx, ry, device))
        out[0] = out[0] + Scalar(1)
        return out

    orig_commit = dense_mlpoly.commit_rows_device

    def commit(rows, blinds, gens):
        pts = orig_commit(rows, blinds, gens)
        if len(pts) > 1:
            pts = [pts[0] + pts[1]] + pts[1:]
        return pts

    monkeypatch.setattr(R1CSInstance, "multi_evaluate", multi_evaluate)
    monkeypatch.setattr(dense_mlpoly, "commit_rows_device", commit)


FAULTS = {"unchanged_state": _unchanged_bind, "half_batch": _half_batch,
          "altered_answer": _altered_answer}


def _run(cell, seed=2**31 + 7):
    import torch

    spec = harness.load_spec(ROOT)
    _, cfg, _ = harness.cell_files(spec, cell, ROOT)
    return harness.run_cell(spec, cell, seed, 0.01, False,
                            torch.device("cpu"), cfg=dict(cfg, **TINY[cell]),
                            require_card=False)


@pytest.mark.parametrize("cell", sorted(TINY))
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_program_is_not_correct(monkeypatch, cell, fault):
    # the warm-up request is outside the window: plant the fault after it
    orig = harness.system_module

    def planted(cfg):
        mod = orig(cfg)

        class Broken(mod.System):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self._armed = False

            def verify(self, req, rec):
                rec = super().verify(req, rec)
                if not self._armed:
                    self._armed = True
                    FAULTS[fault](monkeypatch)
                return rec

        return type("M", (), {"System": Broken})

    monkeypatch.setattr(harness, "system_module", planted)
    res, lines = _run(cell)
    assert res["correct"] is False, lines
