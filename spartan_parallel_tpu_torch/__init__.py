"""spartan_parallel_tpu_torch: the PyTorch/CUDA port of spartan_parallel_tpu.

The port so far: the 9-stage data-parallel SNARK of the zkVM backend
(instances -> encode -> prove -> verify, and the .ctk/.rtk driver), the
data-parallel R1CSProof under it (P instances, each executed Q_p times,
1-16 witness sections; dense or q-size-classed z layout), the NIZK built
on it, and the upstream single-instance SNARK with SPARK, with
device-resident ZK sumcheck rounds (the host loop for CPU tables) and
Hyrax openings with the bullet reduction, on an NVIDIA H100 through CUDA
kernels written by hand (csrc/: K1 scalar field, K2 MSM and point fold,
K3 sparse R1CS products, K4 sumcheck rounds, K5 q-size-classed phase-1
rounds, K6 SPARK's grand-product circuits, K7 the powers of a scalar for
ShiftProofs, K8-K11 the device round: Keccak-f[1600], ristretto
compression, comb commitments and the round tail with its transcript),
and the entry step and multi-device dry run (dryrun.py). It imports torch, numpy and the standard library only; the JAX package
is its reference in the tests, never a dependency.

Entry points run on the card unless the caller passes device="cpu", where
every kernel's plain PyTorch version runs instead.
"""

from .core.consts import L
from .core.field import Scalar
from .models.instance import (
    Instance,
    gen_block_inst,
    gen_pairwise_check_inst,
    gen_perm_root_inst,
)
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
from .models.snark import (
    SNARK,
    SNARKGens,
    ComputationCommitment,
    ComputationDecommitment,
)
from .models.snark_single import SpartanSNARK, SpartanSNARKGens
from .utils.errors import ProofVerifyError, R1CSError
from .utils.random_tape import RandomTape
from .utils.transcript import Transcript


class Assignment:
    """Assignment of field values to inputs/variables (lib.rs:89-151)."""

    __slots__ = ("assignment",)

    def __init__(self, assignment):
        """assignment: list of ints/Scalars (canonical field values) or
        32-byte little-endian encodings."""
        out = []
        for v in assignment:
            if isinstance(v, (bytes, bytearray)):
                x = int.from_bytes(v, "little")
                if x >= L:
                    raise R1CSError("invalid scalar encoding")
            else:
                x = int(v)
                if not 0 <= x < L:
                    raise R1CSError("scalar out of range")
            out.append(x)
        self.assignment = out

    def write(self, f):
        """Text dump, one row per value (lib.rs:123-142)."""
        for v in self.assignment:
            b = v.to_bytes(32, "little")
            size = 32
            while size > 0 and b[size - 1] == 0:
                size -= 1
            f.write(" ".join(str(x) for x in b[:size]) + " \n")


VarsAssignment = Assignment
InputsAssignment = Assignment
MemsAssignment = Assignment

__all__ = [
    "SNARK", "SNARKGens", "ComputationCommitment",
    "ComputationDecommitment", "Instance", "gen_block_inst",
    "gen_pairwise_check_inst", "gen_perm_root_inst", "Assignment",
    "VarsAssignment", "InputsAssignment", "MemsAssignment",
    "NIZK", "NIZKGens", "SpartanSNARK", "SpartanSNARKGens",
    "R1CSCommitment", "R1CSCommitmentGens", "R1CSEvalProof", "r1cs_commit",
    "R1CSInstance", "produce_synthetic_r1cs",
    "R1CSProof", "R1CSGens", "ProverWitnessSecInfo",
    "VerifierWitnessSecInfo", "Scalar", "Transcript", "RandomTape",
    "ProofVerifyError", "R1CSError", "L",
]
