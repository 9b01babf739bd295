"""A random tape that keeps the blinds the reference needs.

The prover's blinding randomness is an input the benchmark hands it: a
RandomTape seeded from (--seed, request index). This subclass records the
scalars drawn under the labels of the SAT proof's committed claims, so
that the reference can open those commitments.
"""

from __future__ import annotations

KEPT = ("Az_blind", "Bz_blind", "Cz_blind", "prod_Az_Bz_blind")


def recording_tape(seed: bytes):
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape

    class RecordingTape(RandomTape):
        __slots__ = ("drawn",)

        def __init__(self):
            super().__init__(b"proof", seed=seed)
            self.drawn = {}

        def random_scalar(self, label: bytes):
            s = super().random_scalar(label)
            name = label.decode(errors="replace")
            if name in KEPT:
                self.drawn[name] = s
            return s

    return RecordingTape()
