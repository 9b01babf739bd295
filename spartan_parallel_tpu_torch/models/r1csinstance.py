"""R1CS instance container: P instances' sparse A/B/C matrices.

Reference: src/r1csinstance.rs:20 (R1CSInstance), src/sparse_mlpoly.rs:33
(SparseMatPolynomial). The matrices live on the host as COO arrays and, per
device, stacked by rows and by columns for the sparse kernels of
ops/spmv.py (K3), one launch a call over every matrix: Az/Bz/Cz
(multiply_vec_block, r1csinstance.rs:363), the phase-2 ABC tables
(compute_eval_table_sparse_disjoint_rounds, r1csinstance.rs:484) and the
verifier's A/B/C evaluations (multi_evaluate). The SPARK
commitment to the matrices and its eval proof (R1CSCommitment,
R1CSEvalProof) wrap models/sparse_mlpoly.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import device as _device
from ..core.consts import L
from ..ops import fq, spmv
from ..utils.timer import Timer
from . import sparse_mlpoly as sp
from .custom_mlpoly import DensePolynomialPqx
from .dense_mlpoly import DensePolynomial, EqPolynomial, log2, \
    mont_to_scalars, next_pow2


def _deflate_digest(raw: bytes) -> bytes:
    """Level-6 zlib stream for the instance digest: the native tdefl port
    (native/tdefl.c, the miniz/miniz_oxide algorithm the reference uses
    through flate2) when available, else CPython zlib, as in the JAX
    package. PARITY.md D1."""
    import ctypes
    import zlib

    from ..core import native

    lib = native.get()
    if lib is not None:
        cap = len(raw) + (len(raw) >> 6) + 1024
        out = ctypes.create_string_buffer(cap)
        n = lib.spartan_tdefl_zlib(raw, len(raw), out, cap, 6)
        if n > 0:
            return bytes(out.raw[:n])
    return zlib.compress(raw, 6)


class SparseMatPolynomial:
    """COO sparse multilinear matrix polynomial (sparse_mlpoly.rs:33)."""

    __slots__ = ("num_vars_x", "num_vars_y", "rows", "cols", "vals",
                 "_mont", "_dev")

    def __init__(self, num_vars_x: int, num_vars_y: int, entries=None,
                 arrays=None):
        """entries: list of (row, col, value); or arrays: (rows, cols,
        vals) with int32 rows and cols and vals as ints mod l."""
        self.num_vars_x = num_vars_x
        self.num_vars_y = num_vars_y
        if arrays is None:
            arrays = ([e[0] for e in entries], [e[1] for e in entries],
                      [e[2] for e in entries])
        rows, cols, vals = arrays
        self.rows = np.asarray(rows, dtype=np.int32)
        self.cols = np.asarray(cols, dtype=np.int32)
        self.vals = [int(v) % L for v in vals]
        # the kernels index tables with these: reject what would read
        # outside them
        if not len(self.rows) == len(self.cols) == len(self.vals):
            raise ValueError("rows, cols and vals differ in length")
        for idx, nv in ((self.rows, num_vars_x), (self.cols, num_vars_y)):
            if len(idx) and (idx.min() < 0 or idx.max() >= 1 << nv):
                raise ValueError("matrix index out of range")
        self._mont = None
        self._dev = {}

    def get_num_nz_entries(self) -> int:
        return len(self.vals)

    def vals_mont(self) -> np.ndarray:
        """(nnz, 16) int32 Montgomery limbs of the values, encoded once
        per distinct value (R1CS coefficients repeat: the digest and the
        device tensors both need them)."""
        if self._mont is None:
            uniq = {}
            idx = np.fromiter((uniq.setdefault(v, len(uniq))
                               for v in self.vals), dtype=np.int64,
                              count=len(self.vals))
            self._mont = fq.encode(list(uniq)).reshape(-1, 16)[idx]
        return self._mont

    def stacks(self, device):
        """(csr, csc) on `device`: the matrix as a one-matrix K3 stack by
        rows and by columns (ops/spmv.py Stack), values in Montgomery
        form, built once (the matrix is static)."""
        key = _device.indexed(device)
        if key not in self._dev:
            vm = self.vals_mont()
            self._dev[key] = (
                spmv.stack([(self.rows, self.cols, vm)],
                           1 << self.num_vars_x, device),
                spmv.stack([(self.cols, self.rows, vm)],
                           1 << self.num_vars_y, device))
        return self._dev[key]

    def multiply_vec_batched(self, z: torch.Tensor) -> torch.Tensor:
        """z: (Q, ncols, 16) Montgomery -> (Q, num_rows, 16)."""
        return spmv.spmv_batched(self.stacks(z.device)[0], z)

    def eval_table(self, rx_tab: torch.Tensor) -> torch.Tensor:
        """(num_cols, 16) table M^T eq(rx) (sparse_mlpoly.rs:505,524)."""
        return spmv.eval_table(self.stacks(rx_tab.device)[1], rx_tab)

    def evaluate_with_tables(self, rx_tab, ry_tab) -> torch.Tensor:
        return spmv.sparse_eval(self.stacks(rx_tab.device)[0], rx_tab,
                                ry_tab)


class R1CSInstance:
    """P instances of ragged-size R1CS (r1csinstance.rs:20-31). `device`
    (default: the card) is where its products run unless a caller's
    tensors say otherwise."""

    def __init__(self, num_instances: int, max_num_cons: int, num_cons,
                 num_vars: int, A_list, B_list, C_list, device=None):
        assert max_num_cons == next_pow2(max_num_cons)
        for c in num_cons:
            assert c == next_pow2(c) and c <= max_num_cons
        assert num_vars == next_pow2(num_vars)
        assert len(A_list) == len(B_list) == len(C_list)
        self.device = _device.resolve(device)
        self.num_instances = num_instances
        self.max_num_cons = max_num_cons
        self.num_cons = list(num_cons)
        self.num_vars = num_vars
        nx, ny = log2(max_num_cons), log2(num_vars)

        def mat(m):
            if isinstance(m, SparseMatPolynomial):
                return m
            return SparseMatPolynomial(nx, ny, m)

        self.A_list = [mat(a) for a in A_list]
        self.B_list = [mat(b) for b in B_list]
        self.C_list = [mat(c) for c in C_list]
        self._digest = None
        self._stacks = {}

    def get_num_instances(self) -> int:
        return self.num_instances

    def get_num_cons(self) -> int:
        return self.max_num_cons

    def get_inst_num_cons(self):
        return self.num_cons

    def get_num_vars(self) -> int:
        return self.num_vars

    def get_digest(self) -> bytes:
        """zlib(bincode(self)): the byte layout of r1csinstance.rs:218-222
        (bincode 1.x: usize as u64 LE, Vec with a u64 length, Scalar as the
        32 raw bytes of its Montgomery limbs), compressed at level 6 by
        native/tdefl.c (PARITY.md D1)."""
        import struct

        if self._digest is not None:
            return self._digest
        parts = []

        def u64(v):
            parts.append(struct.pack("<Q", v))

        u64(self.num_instances)
        u64(self.max_num_cons)
        u64(len(self.num_cons))
        for c in self.num_cons:
            u64(c)
        u64(self.num_vars)
        for mats in (self.A_list, self.B_list, self.C_list):
            u64(len(mats))
            for m in mats:
                u64(m.num_vars_x)
                u64(m.num_vars_y)
                u64(len(m.vals))
                # each entry: (u64 row, u64 col, 32 B Montgomery limbs)
                n = len(m.vals)
                ent = np.zeros((n, 48), dtype=np.uint8)
                ent[:, 0:8] = m.rows.astype("<u8").view(np.uint8) \
                    .reshape(n, 8)
                ent[:, 8:16] = m.cols.astype("<u8").view(np.uint8) \
                    .reshape(n, 8)
                ent[:, 16:48] = m.vals_mont().astype("<u2") \
                    .view(np.uint8).reshape(n, 32)
                parts.append(ent.tobytes())
        self._digest = _deflate_digest(b"".join(parts))
        return self._digest

    def _stack(self, device, by_cols: bool) -> spmv.Stack:
        """Every instance's A, B and C (matrix 3 p + k) as one K3 stack on
        `device`, by rows (Az/Bz/Cz, the verifier's evaluations) or by
        columns (the phase-2 tables), built once for the matrices the
        instance holds (a sorted copy holds them in another order)."""
        mats = tuple(m for p in range(self.num_instances)
                     for m in (self.A_list[p], self.B_list[p],
                               self.C_list[p]))
        device = _device.indexed(device)
        key = (device, by_cols, tuple(map(id, mats)))
        hit = self._stacks.get(key)
        if hit is None:
            st = spmv.stack(
                [(m.cols, m.rows, m.vals_mont()) if by_cols else
                 (m.rows, m.cols, m.vals_mont()) for m in mats],
                self.num_vars if by_cols else self.max_num_cons, device)
            # the matrices stay referenced, so their ids stay theirs
            hit = self._stacks[key] = (mats, st)
        return hit[1]

    # --- Az/Bz/Cz (r1csinstance.rs:363-438) -------------------------------
    def multiply_vec_block(self, num_instances, num_proofs, max_num_proofs,
                           num_inputs, max_num_inputs, max_num_cons,
                           num_cons, z_nat):
        """z_nat: (P, Q_max, W, Y_max, 16) Montgomery, natural q/y order.
        Returns (Az, Bz, Cz) as DensePolynomialPqx with W = 1, q and x
        bit-reversed: one K3 launch writes every instance's products in
        place (counted as spmv_batched)."""
        assert self.num_instances in (1, num_instances)
        assert max_num_cons == self.max_num_cons
        P = next_pow2(num_instances)
        dev = z_nat.device
        counts = [int(q) for q in num_proofs[:num_instances]]
        full = P == num_instances and all(q == max_num_proofs
                                          for q in counts)
        out = (torch.empty if full else torch.zeros)(
            (3, P, max_num_proofs, 1, max_num_cons, 16), dtype=torch.int32,
            device=dev)
        z = z_nat.contiguous()
        mats = [0 if self.num_instances == 1 else p
                for p in range(num_instances)]
        spmv.spmv_many(self._stack(dev, False), z, out, counts, mats, 3,
                       (z.stride(0) // 16, z.stride(1) // 16),
                       (P * max_num_proofs * max_num_cons,
                        max_num_proofs * max_num_cons, max_num_cons),
                       (log2(max_num_proofs), log2(max_num_cons)))
        return tuple(DensePolynomialPqx(out[k], list(num_proofs),
                                        list(num_cons)) for k in range(3))

    def multiply_vec_block_classed(self, p0: int, num_proofs_c: int,
                                   max_num_cons: int, z_nat_c):
        """Az/Bz/Cz of one q-size class of instances.

        z_nat_c: (P_c, Q_c, W, Y, 16) natural-order slice of z. Returns
        three (P_c, Q_c, X, 16) tensors with q bit-reversed within the
        class and x bit-reversed (the class layout of ops/sumcheck.py
        pc_*), from one K3 launch (counted as spmv_batched). No p
        padding: classes never bind p before they merge."""
        P_c, Q_c = int(z_nat_c.shape[0]), int(z_nat_c.shape[1])
        assert num_proofs_c == Q_c and max_num_cons == self.max_num_cons
        dev = z_nat_c.device
        out = torch.empty((3, P_c, Q_c, max_num_cons, 16), dtype=torch.int32,
                          device=dev)
        z = z_nat_c.contiguous()
        mats = [0 if self.num_instances == 1 else p0 + i
                for i in range(P_c)]
        spmv.spmv_many(self._stack(dev, False), z, out, [Q_c] * P_c, mats,
                       3, (z.stride(0) // 16, z.stride(1) // 16),
                       (P_c * Q_c * max_num_cons, Q_c * max_num_cons,
                        max_num_cons), (log2(Q_c), log2(max_num_cons)))
        return out[0], out[1], out[2]

    # --- phase-2 ABC tables (r1csinstance.rs:484-540) ----------------------
    def compute_eval_table_sparse_disjoint_rounds(
            self, num_instances, num_rows, num_segs, max_num_cols, num_cols,
            rx_tab):
        """rx_tab: (max_num_cons, 16) eq table over natural rows. Returns
        per-instance (A_tab, B_tab, C_tab) of shape (num_segs_pad,
        max_num_cols, 16) in natural y order, from one K3 launch (counted
        as eval_table)."""
        assert self.num_instances in (1, num_instances)
        assert next_pow2(num_segs) * max_num_cols == self.num_vars
        P, ncols = self.num_instances, self.num_vars
        out = torch.empty((3, P, ncols, 16), dtype=torch.int32,
                          device=rx_tab.device)
        spmv.spmv_many(self._stack(rx_tab.device, True), rx_tab.contiguous(),
                       out, [1] * P, list(range(P)), 3, (0, 0),
                       (P * ncols, ncols, 0), counter="eval_table")
        shape = (next_pow2(num_segs), max_num_cols, 16)
        return [tuple(out[k, p].reshape(shape) for k in range(3))
                for p in range(P)]

    # --- verifier-side matrix evaluations (r1csinstance.rs:583-652) -------
    def multi_evaluate(self, rx, ry, device=None):
        """Every instance's (A, B, C) at (rx, ry), as a list of Scalars:
        one K3 launch (counted as sparse_eval) and one read to the
        host."""
        dev = self.device if device is None else _device.resolve(device)
        rx_tab = EqPolynomial(list(rx)).evals_dev(dev)
        ry_tab = EqPolynomial(list(ry)).evals_dev(dev)
        return mont_to_scalars(spmv.sparse_eval_many(
            self._stack(dev, False), rx_tab, ry_tab))

    def multi_evaluate_bound_rp(self, rp, rx, ry, device=None):
        """Every instance's (A, B, C) at (rx, ry), and each of the three
        lists bound to rp as a multilinear polynomial over p."""
        dev = self.device if device is None else _device.resolve(device)
        eval_list = self.multi_evaluate(rx, ry, dev)
        bound = tuple(
            DensePolynomial.from_scalars(eval_list[k::3], dev).evaluate(rp)
            for k in range(3))
        return eval_list, bound

    def evaluate(self, rx, ry, device=None):
        assert self.num_instances == 1
        e = self.multi_evaluate(rx, ry, device)
        return e[0], e[1], e[2]


# --------------------------------------------------------------------------
# SPARK commitment to the matrices (r1csinstance.rs:34-57, 717-780)
# --------------------------------------------------------------------------
class R1CSCommitmentGens:
    """SPARK gens sized to the instance set (r1csinstance.rs:34-57)."""

    __slots__ = ("gens",)

    def __init__(self, label: bytes, num_instances: int, num_cons: int,
                 num_vars: int, num_nz_entries: int):
        # reference: num_instances.log_2() + num_cons.log_2()
        # (Math::log_2 is ceil for non-powers of two, math.rs:13-21)
        num_poly_vars_x = log2(next_pow2(num_instances)) + \
            log2(next_pow2(num_cons))
        num_poly_vars_y = log2(num_vars)
        self.gens = sp.SparseMatPolyCommitmentGens(
            label, num_poly_vars_x, num_poly_vars_y,
            num_instances * num_nz_entries, 3)


class R1CSCommitment:
    __slots__ = ("num_cons", "num_vars", "comm")

    def __init__(self, num_cons, num_vars, comm):
        self.num_cons = num_cons
        self.num_vars = num_vars
        self.comm = comm

    def get_num_cons(self):
        return self.num_cons

    def get_num_vars(self):
        return self.num_vars

    def append_to_transcript(self, _label: bytes, transcript):
        transcript.append_u64(b"num_cons", self.num_cons)
        transcript.append_u64(b"num_vars", self.num_vars)
        self.comm.append_to_transcript(b"comm", transcript)


class R1CSDecommitment:
    __slots__ = ("dense",)

    def __init__(self, dense):
        self.dense = dense


def next_power_of_eight(val: int) -> int:
    base = 1
    while base < val:
        base *= 8
    return base


def _multi_commit_group(inst: R1CSInstance, gens: R1CSCommitmentGens,
                        device=None):
    """One SPARK commitment per group of the instances' A, B and C
    matrices, grouped by the next power of eight of their padded nnz
    (r1csinstance.rs:646-714). Returns (label_map, comm_list,
    decomm_list): label_map[g] lists 3 * instance + (0, 1, 2) for A, B, C
    of group g."""
    nnz_size = {}
    label_map = []
    sparse_polys_list = []
    for i in range(inst.num_instances):
        for k, mats in enumerate((inst.A_list, inst.B_list, inst.C_list)):
            m = mats[i]
            length = next_power_of_eight(next_pow2(max(
                1, m.get_num_nz_entries())))
            if length in nnz_size:
                idx = nnz_size[length]
                label_map[idx].append(3 * i + k)
                sparse_polys_list[idx].append(m)
            else:
                nnz_size[length] = len(sparse_polys_list)
                label_map.append([3 * i + k])
                sparse_polys_list.append([m])

    comm_list, decomm_list = [], []
    for polys in sparse_polys_list:
        comm, dense = sp.multi_commit(polys, gens.gens, device)
        comm_list.append(R1CSCommitment(
            inst.num_instances * inst.max_num_cons, inst.num_vars, comm))
        decomm_list.append(R1CSDecommitment(dense))
    return label_map, comm_list, decomm_list


def r1cs_multi_commit(inst: R1CSInstance, gens: R1CSCommitmentGens,
                      device=None):
    return _multi_commit_group(inst, gens, device)


def r1cs_commit(inst: R1CSInstance, gens: R1CSCommitmentGens, device=None):
    """One joint commitment to every instance's A, B and C
    (r1csinstance.rs:717-736); the dense representation stays on
    `device` for the eval proof."""
    polys = []
    for i in range(inst.num_instances):
        polys += [inst.A_list[i], inst.B_list[i], inst.C_list[i]]
    comm, dense = sp.multi_commit(polys, gens.gens, device)
    return (R1CSCommitment(inst.num_instances * inst.max_num_cons,
                           inst.num_vars, comm),
            R1CSDecommitment(dense))


class R1CSEvalProof:
    """Wraps SPARK's SparseMatPolyEvalProof (r1csinstance.rs:738-780)."""

    __slots__ = ("proof",)

    def __init__(self, proof):
        self.proof = proof

    @staticmethod
    def prove(decomm: R1CSDecommitment, rx, ry, evals, gens, transcript,
              random_tape):
        """Runs on the device of the decommitment."""
        timer = Timer("R1CSEvalProof::prove")
        proof = sp.SparseMatPolyEvalProof.prove(
            decomm.dense, rx, ry, evals, gens.gens, transcript, random_tape)
        timer.stop(decomm.dense.comb_ops.Zm.device)
        return R1CSEvalProof(proof)

    def verify(self, comm: R1CSCommitment, rx, ry, evals, gens, transcript,
               device=None):
        self.proof.verify(comm.comm, rx, ry, evals, gens.gens, transcript,
                          device)


def produce_synthetic_r1cs(num_instances: int, num_proofs, num_cons: int,
                           num_vars: int, num_inputs: int, seed: int = 0,
                           device=None):
    """Random satisfiable data-parallel R1CS for tests and benches: the JAX
    package's generator, row for row. Column space is [vars | 1, inputs,
    0...] (two witness sections of num_vars columns each). Row i with
    k = i % (num_vars/2) is u_k * u_{k+1} = v_k, or u_k * 1 = input_k on
    every third row while k < num_inputs.

    Returns (inst, vars_mat, inputs_mat) with host-int witnesses
    vars_mat[p][q] (len num_vars) and inputs_mat[p][q] (len num_inputs)."""
    rng = np.random.default_rng(seed)
    h = num_vars // 2
    one_col = num_vars
    i = np.arange(num_cons, dtype=np.int64)
    k = i % h
    io = (i % 3 == 2) & (k < num_inputs)
    ones = [1] * num_cons
    A = (i, k, ones)
    B = (i, np.where(io, one_col, (k + 1) % h), ones)
    C = (i, np.where(io, one_col + 1 + k, h + k), ones)
    nx, ny = log2(num_cons), log2(2 * num_vars)
    mats = [[SparseMatPolynomial(nx, ny, arrays=m)]
            for m in (A, B, C)]
    inst = R1CSInstance(num_instances, num_cons, [num_cons] * num_instances,
                        2 * num_vars, mats[0] * num_instances,
                        mats[1] * num_instances, mats[2] * num_instances,
                        device=device)

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % L

    vars_mat, inputs_mat = [], []
    for p in range(num_instances):
        vars_mat.append([])
        inputs_mat.append([])
        for _ in range(num_proofs[p]):
            u = [rand_scalar() for _ in range(h)]
            v = [u[k] * u[(k + 1) % h] % L for k in range(h)]
            io_vals = [u[k] for k in range(num_inputs)]
            vars_mat[p].append(u + v)
            inputs_mat[p].append(io_vals)
    return inst, vars_mat, inputs_mat
