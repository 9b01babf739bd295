"""spartan_parallel_tpu_torch: the PyTorch/CUDA port of spartan_parallel_tpu.

The port so far: the data-parallel R1CSProof (P instances, each executed
Q_p times, 1-16 witness sections; dense or q-size-classed z layout), the
NIZK built on it, and the upstream single-instance SNARK with SPARK
(encode -> prove -> verify), with the host-loop ZK sumcheck and Hyrax
openings with the bullet reduction, on an NVIDIA H100 through CUDA kernels
written by hand (csrc/: K1 scalar field, K2 MSM and point fold, K3 sparse
R1CS products, K4 sumcheck rounds, K5 q-size-classed phase-1 rounds, K6
SPARK's grand-product circuits). It
imports torch, numpy and the standard library only; the JAX package is
its reference in the tests, never a dependency.

Entry points run on the card unless the caller passes device="cpu", where
every kernel's plain PyTorch version runs instead.
"""

from .core.consts import L
from .core.field import Scalar
from .models.nizk import NIZK, NIZKGens
from .models.r1csinstance import (
    R1CSCommitment,
    R1CSCommitmentGens,
    R1CSEvalProof,
    R1CSInstance,
    produce_synthetic_r1cs,
    r1cs_commit,
)
from .models.r1csproof import (
    ProverWitnessSecInfo,
    R1CSGens,
    R1CSProof,
    VerifierWitnessSecInfo,
)
from .models.snark_single import SpartanSNARK, SpartanSNARKGens
from .utils.errors import ProofVerifyError, R1CSError
from .utils.random_tape import RandomTape
from .utils.transcript import Transcript

__all__ = [
    "NIZK", "NIZKGens", "SpartanSNARK", "SpartanSNARKGens",
    "R1CSCommitment", "R1CSCommitmentGens", "R1CSEvalProof", "r1cs_commit",
    "R1CSInstance", "produce_synthetic_r1cs",
    "R1CSProof", "R1CSGens", "ProverWitnessSecInfo",
    "VerifierWitnessSecInfo", "Scalar", "Transcript", "RandomTape",
    "ProofVerifyError", "R1CSError", "L",
]
