"""Carry an R1CS instance into the port from plain arrays.

The system's "parameters" are the R1CS instance and the witness. A matrix
arrives as a (rows, cols, vals) triple: int32 row and column indices and
values as ints mod l, the form in which the JAX package's
SparseMatPolynomial holds it (models/r1csinstance.py). Generators need no
carrying: both packages derive them from labels.
"""

from __future__ import annotations

from .models.r1csinstance import R1CSInstance, SparseMatPolynomial
from .models.dense_mlpoly import log2


def instance_from_numpy(num_cons: int, num_vars: int, num_inputs: int, A, B,
                        C, device=None) -> R1CSInstance:
    """A one-instance NIZK R1CS over the column space [vars | 1, inputs,
    0...] of 2 * num_vars columns (num_vars per witness section)."""
    if not 0 <= num_inputs < num_vars:
        raise ValueError("a NIZK needs fewer inputs than variables")
    nx, ny = log2(num_cons), log2(2 * num_vars)
    mats = [SparseMatPolynomial(nx, ny, arrays=m) for m in (A, B, C)]
    return R1CSInstance(1, num_cons, [num_cons], 2 * num_vars, [mats[0]],
                        [mats[1]], [mats[2]], device=device)
