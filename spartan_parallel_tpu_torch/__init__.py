"""spartan_parallel_tpu_torch: the PyTorch/CUDA port of spartan_parallel_tpu.

The first slice of the port: the NIZK prove -> verify path (R1CSProof with
P = Q = 1, the host-loop ZK sumcheck, Hyrax openings with the bullet
reduction) on an NVIDIA H100, through four CUDA kernels written by hand
(csrc/: K1 scalar field, K2 MSM and point fold, K3 sparse R1CS products,
K4 sumcheck rounds). It imports torch, numpy and the standard library
only; the JAX package is its reference in the tests, never a dependency.

Entry points run on the card unless the caller passes device="cpu", where
every kernel's plain PyTorch version runs instead.
"""

from .core.consts import L
from .core.field import Scalar
from .models.nizk import NIZK, NIZKGens
from .models.r1csinstance import R1CSInstance, produce_synthetic_r1cs
from .utils.errors import ProofVerifyError, R1CSError
from .utils.random_tape import RandomTape
from .utils.transcript import Transcript

__all__ = [
    "NIZK", "NIZKGens", "R1CSInstance", "produce_synthetic_r1cs", "Scalar",
    "Transcript", "RandomTape", "ProofVerifyError", "R1CSError", "L",
]
