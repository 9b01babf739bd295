"""DensePolynomialPqx: the fork's data-parallel hypermatrix polynomial.

Reference: src/custom_dense_mlpoly.rs:22 (ragged (p, q_rev, w, x_rev)
storage with zero-skipping binds). As in the JAX package, one dense
zero-padded (P, Q, W, Y, 16) Montgomery tensor with the q and y axes in
bit-reversed order; entries outside each instance's (num_proofs[p],
num_inputs[p]) live region are the field zero, so every bind rule of the
reference is an ordinary half-table fold:

  * the compacted fold Z[q] += r (Z[q + Q_i/2] - Z[q]) touches the dense
    positions q step and q step + Q_max/2: the MSB fold;
  * the Q_i == 1 rule Z *= (1 - r) is the MSB fold with a zero high half.

The binds are K1 fq_bind launches (ops/sumcheck.py fold_chain).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.field import Scalar
from ..ops import fq
from ..ops import limbs as lb
from ..ops.sumcheck import MODE_P, MODE_Q, MODE_W, MODE_X, fold_chain, \
    rev_perm
from .dense_mlpoly import DensePolynomial, mont_to_scalar, next_pow2, \
    scalars_to_mont

_AXIS = {MODE_P: 0, MODE_Q: 1, MODE_W: 2, MODE_X: 3}


class DensePolynomialPqx:
    __slots__ = ("Zm", "num_proofs", "num_inputs")

    def __init__(self, Zm: torch.Tensor, num_proofs, num_inputs):
        assert Zm.dim() == 5
        self.Zm = Zm
        self.num_proofs = list(num_proofs)
        self.num_inputs = list(num_inputs)

    @property
    def num_instances(self) -> int:
        return self.Zm.shape[0]

    @property
    def max_num_proofs(self) -> int:
        return self.Zm.shape[1]

    @property
    def num_witness_secs(self) -> int:
        return self.Zm.shape[2]

    @property
    def max_num_inputs(self) -> int:
        return self.Zm.shape[3]

    def __len__(self) -> int:
        return self.num_instances * self.max_num_proofs * self.max_num_inputs

    @staticmethod
    def new_rev(z_mat, num_proofs, max_num_proofs, num_inputs,
                max_num_inputs, device) -> "DensePolynomialPqx":
        """Host nested lists (p, q, w, y) in natural q/y order -> Pqx on
        `device`: value (p, q, w, y) lands at (p, rev(q), w, rev(y))
        (custom_dense_mlpoly.rs:67-113)."""
        P = len(z_mat)
        W = next_pow2(max(len(z_mat[p][0]) for p in range(P)))
        arr = np.zeros((next_pow2(P), max_num_proofs, W, max_num_inputs, 16),
                       np.int32)
        qp = rev_perm(max_num_proofs)
        yp = rev_perm(max_num_inputs)
        for p in range(P):
            vals, idx = [], []
            for q, row_q in enumerate(z_mat[p]):
                for w, row in enumerate(row_q):
                    for y, v in enumerate(row):
                        vals.append(int(v))
                        idx.append((qp[q], w, yp[y]))
            if vals:
                ii = np.array(idx)
                arr[p, ii[:, 0], ii[:, 1], ii[:, 2]] = lb.ints_to_limbs(vals)
        # canonical limbs -> Montgomery form: one product by R^2 (zeros
        # stay zero)
        return DensePolynomialPqx(
            fq.from_canonical(lb.to_device(arr, device)), num_proofs,
            num_inputs)

    @staticmethod
    def from_dense(Zm, num_proofs, num_inputs) -> "DensePolynomialPqx":
        return DensePolynomialPqx(Zm, num_proofs, num_inputs)

    def index(self, p: int, q_rev: int, w: int, x_rev: int) -> Scalar:
        """Storage-order indexing (custom_dense_mlpoly.rs:118-131): q_rev
        and x_rev are the reference's compacted coordinates; the dense
        position is q_rev * step."""
        step_q = self.max_num_proofs // self.num_proofs[p] if p < len(
            self.num_proofs) else 1
        step_x = self.max_num_inputs // self.num_inputs[p] if p < len(
            self.num_inputs) else 1
        return mont_to_scalar(self.Zm[p, q_rev * step_q, w, x_rev * step_x])

    def _bound_vars(self, rs, mode: int) -> None:
        """Bind a list of variables along one axis, then keep the live
        prefix."""
        if not rs:
            return
        axis = _AXIS[mode]
        k = len(rs)
        full = fold_chain(self.Zm, scalars_to_mont(rs, self.Zm.device),
                          axis)
        keep = max(1, self.Zm.shape[axis] >> k)
        self.Zm = full.narrow(axis, 0, keep).contiguous()
        if mode == MODE_Q:
            self.num_proofs = [max(1, q >> k) for q in self.num_proofs]
        elif mode == MODE_X:
            self.num_inputs = [max(1, x >> k) for x in self.num_inputs]

    def bound_poly(self, r: Scalar, mode: int) -> None:
        self._bound_vars([r], mode)

    def bound_poly_vars_rp(self, r_p) -> None:
        self._bound_vars(list(r_p), MODE_P)

    def bound_poly_vars_rq(self, r_q) -> None:
        self._bound_vars(list(r_q), MODE_Q)

    def bound_poly_vars_rw(self, r_w) -> None:
        self._bound_vars(list(r_w), MODE_W)

    def bound_poly_vars_rx(self, r_x) -> None:
        self._bound_vars(list(r_x), MODE_X)

    def evaluate(self, r_p, r_q, r_w, r_x) -> Scalar:
        cl = DensePolynomialPqx(self.Zm, self.num_proofs, self.num_inputs)
        cl.bound_poly_vars_rx(r_x)
        cl.bound_poly_vars_rw(r_w)
        cl.bound_poly_vars_rq(r_q)
        cl.bound_poly_vars_rp(r_p)
        return mont_to_scalar(cl.Zm[0, 0, 0, 0])

    def to_dense_poly(self) -> DensePolynomial:
        """Flatten to natural (p, q, w, x) order
        (custom_dense_mlpoly.rs:336)."""
        dev = self.Zm.device
        qp = torch.as_tensor(rev_perm(self.max_num_proofs), device=dev)
        yp = torch.as_tensor(rev_perm(self.max_num_inputs), device=dev)
        nat = self.Zm.index_select(1, qp).index_select(3, yp)
        return DensePolynomial(nat.reshape(-1, 16))
