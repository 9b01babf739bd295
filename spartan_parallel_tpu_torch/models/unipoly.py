"""Univariate round polynomials for sumcheck (reference: src/unipoly.rs).

Degree-2/3 polynomials interpolated from evaluations at 0..3; the compressed
form omits the linear coefficient, which the verifier reconstructs from the
round claim (unipoly.rs:95-110). Host-side: these are 4-element objects."""

from __future__ import annotations

from ..core.field import Scalar
from .commitments import MultiCommitGens, commit

_TWO_INV = Scalar(2).invert()
_SIX_INV = Scalar(6).invert()


class UniPoly:
    __slots__ = ("coeffs",)

    def __init__(self, coeffs):
        self.coeffs = coeffs  # [c0, c1, ...] low-to-high

    @staticmethod
    def from_evals(evals) -> "UniPoly":
        assert len(evals) in (3, 4)
        if len(evals) == 3:
            c = evals[0]
            a = _TWO_INV * (evals[2] - evals[1] - evals[1] + c)
            b = evals[1] - c - a
            return UniPoly([c, b, a])
        e0, e1, e2, e3 = evals
        d = e0
        a = _SIX_INV * (e3 - e2 - e2 - e2 + e1 + e1 + e1 - e0)
        b = _TWO_INV * (e0 + e0 - e1 - e1 - e1 - e1 - e1 + e2 + e2 + e2 + e2 - e3)
        c = e1 - d - a - b
        return UniPoly([d, c, b, a])

    def degree(self) -> int:
        return len(self.coeffs) - 1

    def as_vec(self):
        return list(self.coeffs)

    def eval_at_zero(self) -> Scalar:
        return self.coeffs[0]

    def eval_at_one(self) -> Scalar:
        s = Scalar.zero()
        for c in self.coeffs:
            s = s + c
        return s

    def evaluate(self, r: Scalar) -> Scalar:
        acc = self.coeffs[-1]
        for c in reversed(self.coeffs[:-1]):
            acc = acc * r + c
        return acc

    def commit(self, gens: MultiCommitGens, blind: Scalar):
        return commit(self.coeffs, blind, gens)

    def compress(self) -> "CompressedUniPoly":
        return CompressedUniPoly([self.coeffs[0]] + self.coeffs[2:])

    def append_to_transcript(self, label: bytes, transcript) -> None:
        transcript.append_message(label, b"UniPoly_begin")
        for c in self.coeffs:
            transcript.append_scalar(b"coeff", c)
        transcript.append_message(label, b"UniPoly_end")


class CompressedUniPoly:
    __slots__ = ("coeffs_except_linear_term",)

    def __init__(self, coeffs_except_linear_term):
        self.coeffs_except_linear_term = coeffs_except_linear_term

    def decompress(self, hint: Scalar) -> UniPoly:
        rest = self.coeffs_except_linear_term
        linear = hint - rest[0] - rest[0]
        for c in rest[1:]:
            linear = linear - c
        return UniPoly([rest[0], linear] + list(rest[1:]))
