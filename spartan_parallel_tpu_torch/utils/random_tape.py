"""Prover-private blinding randomness (reference: src/random.rs:7-29).

A private merlin transcript seeded with one OS-random scalar; every blind is
a challenge drawn from it. A fixed seed may be injected for reproducible
tests (the reference uses OsRng unconditionally)."""

from __future__ import annotations

import os

from ..core.field import Scalar
from .transcript import Transcript


class RandomTape:
    __slots__ = ("tape",)

    def __init__(self, name: bytes, seed: bytes | None = None):
        if seed is None:
            seed = os.urandom(32)
        init = Scalar.from_bytes_mod_order(seed[:32])
        self.tape = Transcript(name)
        self.tape.append_scalar(b"init_randomness", init)

    def random_scalar(self, label: bytes) -> Scalar:
        return self.tape.challenge_scalar(label)

    def random_vector(self, label: bytes, n: int):
        return self.tape.challenge_vector(label, n)
