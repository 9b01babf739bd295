"""Carry an R1CS statement into the port from plain arrays.

The system's "parameters" are the R1CS instance, the witness and the
witness commitments. A matrix arrives as a (rows, cols, vals) triple: int32
row and column indices and values as ints mod l, the form in which the JAX
package's SparseMatPolynomial holds it (models/r1csinstance.py). A witness
section arrives as the JAX package's ProverWitnessSecInfo.w_mat: per
instance a (Q_p, num_inputs_p, 16) array of 16-bit Montgomery limbs. A
commitment arrives as its list of compressed row points (32 bytes each).
Generators need no carrying: both packages derive them from labels.
"""

from __future__ import annotations

import numpy as np

from .models.dense_mlpoly import PolyCommitment, log2
from .models.r1csinstance import R1CSInstance, SparseMatPolynomial
from .models.r1csproof import ProverWitnessSecInfo, VerifierWitnessSecInfo
from .ops import limbs as lb


def instance_from_numpy(num_cons: int, num_vars: int, num_inputs: int, A, B,
                        C, device=None) -> R1CSInstance:
    """A one-instance NIZK R1CS over the column space [vars | 1, inputs,
    0...] of 2 * num_vars columns (num_vars per witness section)."""
    if not 0 <= num_inputs < num_vars:
        raise ValueError("a NIZK needs fewer inputs than variables")
    return instances_from_numpy(1, num_cons, [num_cons], 2 * num_vars, [A],
                                [B], [C], device)


def instances_from_numpy(num_instances: int, max_num_cons: int, num_cons,
                         num_vars: int, A_list, B_list, C_list,
                         device=None) -> R1CSInstance:
    """A P-instance R1CS: one (rows, cols, vals) triple per matrix and
    instance (or a single one shared by every instance)."""
    nx, ny = log2(max_num_cons), log2(num_vars)
    mats = [[SparseMatPolynomial(nx, ny, arrays=m) for m in lst]
            for lst in (A_list, B_list, C_list)]
    return R1CSInstance(num_instances, max_num_cons, num_cons, num_vars,
                        *mats, device=device)


def witness_sec_from_numpy(num_inputs, w_mat, device) -> ProverWitnessSecInfo:
    """A prover's witness section from per-instance (Q_p, num_inputs_p, 16)
    Montgomery limb arrays."""
    return ProverWitnessSecInfo.from_tensors(
        num_inputs, [lb.to_device(np.asarray(m), device) for m in w_mat])


def verifier_sec_from_points(num_proofs, num_inputs,
                             comm_w) -> VerifierWitnessSecInfo:
    """A verifier's witness section from per-instance lists of compressed
    row commitments."""
    return VerifierWitnessSecInfo(num_proofs, num_inputs,
                                  [PolyCommitment(c) for c in comm_w])
