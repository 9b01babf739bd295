"""DensePolynomialPqx: the fork's data-parallel hypermatrix polynomial.

Reference: src/custom_dense_mlpoly.rs:22. As in the JAX package, one dense
zero-padded (P, Q, W, Y, 16) Montgomery tensor with the q and y axes in
bit-reversed order; entries outside each instance's live region are the
field zero. The NIZK (P = Q = 1) only reads the table; the binds of the
q axis come with the multi-proof prover.
"""

from __future__ import annotations

import torch


class DensePolynomialPqx:
    __slots__ = ("Zm", "num_proofs", "num_inputs")

    def __init__(self, Zm: torch.Tensor, num_proofs, num_inputs):
        assert Zm.dim() == 5
        self.Zm = Zm
        self.num_proofs = list(num_proofs)
        self.num_inputs = list(num_inputs)
