"""SPARK: commitment and evaluation argument for the sparse R1CS matrices.

Reference: src/sparse_mlpoly.rs (offline memory checking over the COO
representation: AddrTimestamps :212, Derefs :39, hash layer :560, batched
grand products ProductLayerProof :1105, HashLayerProof :766, top level
SparseMatPolyEvalProof :1469); the JAX package's models/sparse_mlpoly.py,
byte for byte.

  * the timestamps are a vectorized numpy group rank on the host (the
    reference's sequential address walk, sparse_mlpoly.rs:225-244, is a
    per-address occurrence count); the dense representation is built from
    whole numpy arrays, then R-scaled on the device (one K1 product);
  * a deref is a torch.index_select of the eq table on the device;
  * the hash layer is one K1 launch over stacked (B, n, 16) tables
    (csrc/fq.cu k_hash, counted as hash_poly), the write timestamps' hash
    written from the read timestamps' read (h + r^2);
  * a list of polynomials is evaluated at one point in one K1 launch
    (fq.dot_many, counted as evaluate_many);
  * the product circuits of a network grow all their layers in one K6
    launch per layer (models/product_tree.py): 4 * batch_size ops
    circuits, 4 memory circuits;
  * the openings are the Hyrax PCS of models/dense_mlpoly.py (K1, K2).

Prover entry points run on the device of the dense representation (the
card unless `multi_commit` was given device="cpu"); verifiers take
`device` for their eq tables.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core import device as _device
from ..core.field import Scalar
from ..ops import fq, kernels
from ..ops import limbs as lb
from ..utils.errors import ProofVerifyError
from ..utils.timer import Timer
from .dense_mlpoly import (
    DensePolynomial,
    EqPolynomial,
    IdentityPolynomial,
    PolyCommitmentGens,
    PolyEvalProof,
    log2,
    mont_to_scalars,
    next_pow2,
    scalars_to_mont,
)
from .product_tree import (
    DotProductCircuit,
    ProductCircuit,
    ProductCircuitEvalProofBatched,
)

_ZERO = Scalar.zero()
_ONE = Scalar.one()


def _u64s_to_mont(arr: np.ndarray, device) -> torch.Tensor:
    """numpy array of non-negative integers < 2^63 -> (..., 16) Montgomery
    limbs on `device`: the limbs are cut on the device, then R-scaled."""
    v = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.int64)).to(device)
    limbs = torch.zeros(v.shape + (16,), dtype=torch.int32, device=device)
    for i in range(4):
        limbs[..., i] = ((v >> (16 * i)) & 0xFFFF).to(torch.int32)
    return fq.from_canonical(limbs)


def _cumcount(addr: np.ndarray, base: np.ndarray) -> np.ndarray:
    """read_ts[i] = base[addr[i]] + (# of j < i with addr[j] == addr[i])."""
    n = len(addr)
    order = np.argsort(addr, kind="stable")
    sa = addr[order]
    idx = np.arange(n)
    starts = np.ones(n, bool)
    starts[1:] = sa[1:] != sa[:-1]
    group_start = np.maximum.accumulate(np.where(starts, idx, 0))
    out = np.empty(n, np.int64)
    out[order] = idx - group_start
    return out + base[addr]


def _evaluate_many(polys, r) -> list:
    """Each poly's evaluation at r, from one eq table: one K1 launch for
    the lot (fq.dot_many, counted as evaluate_many), read back in one
    copy."""
    chis = EqPolynomial(list(r)).evals_dev(polys[0].Zm.device)
    return mont_to_scalars(fq.dot_many([p.Zm for p in polys], chis,
                                       counter="evaluate_many"))


class AddrTimestamps:
    """Read/audit timestamps for offline memory checking
    (sparse_mlpoly.rs:212-271)."""

    __slots__ = ("ops_addr", "read_ts", "audit_ts", "_addr_dev")

    def __init__(self, num_cells: int, num_ops: int, ops_addr, device):
        base = np.zeros(num_cells, np.int64)
        addrs, rts = [], []
        for inst in ops_addr:
            a = np.asarray(inst, np.int64)
            assert len(a) == num_ops and a.max(initial=0) < num_cells
            rts.append(_cumcount(a, base))
            base += np.bincount(a, minlength=num_cells)
            addrs.append(a)
        k = len(rts)
        # addresses and read timestamps of every instance in one transfer
        m = _u64s_to_mont(np.concatenate(addrs + rts), device).reshape(
            2 * k, num_ops, 16)
        self.ops_addr = [DensePolynomial(m[i]) for i in range(k)]
        self.read_ts = [DensePolynomial(m[k + i]) for i in range(k)]
        self.audit_ts = DensePolynomial(_u64s_to_mont(base, device))
        self._addr_dev = torch.from_numpy(np.concatenate(addrs)).to(device)

    def deref(self, mem_val_dev: torch.Tensor):
        """mem_val_dev: (num_cells, 16) Montgomery eq table. One gather
        for every instance."""
        vals = mem_val_dev.index_select(0, self._addr_dev).reshape(
            len(self.ops_addr), -1, 16)
        return [DensePolynomial(vals[i]) for i in range(len(self.ops_addr))]


class Derefs:
    __slots__ = ("row_ops_val", "col_ops_val", "comb")

    def __init__(self, row_ops_val, col_ops_val):
        assert len(row_ops_val) == len(col_ops_val)
        self.row_ops_val = row_ops_val
        self.col_ops_val = col_ops_val
        self.comb = DensePolynomial.merge(row_ops_val + col_ops_val)

    def commit(self, gens: PolyCommitmentGens) -> "DerefsCommitment":
        comm, _ = self.comb.commit(gens, None)
        return DerefsCommitment(comm)


class DerefsCommitment:
    __slots__ = ("comm_ops_val",)

    def __init__(self, comm_ops_val):
        self.comm_ops_val = comm_ops_val

    def append_to_transcript(self, label: bytes, transcript):
        transcript.append_message(b"derefs_commitment",
                                  b"begin_derefs_commitment")
        self.comm_ops_val.append_to_transcript(label, transcript)
        transcript.append_message(b"derefs_commitment",
                                  b"end_derefs_commitment")


def _n_to_1_reduce(evals, r, transcript, label_evals: bytes,
                   label_eval: bytes, device):
    """Common n-to-1 RLC reduction (sparse_mlpoly.rs:91-110)."""
    transcript.append_scalar_vector(label_evals, evals)
    challenges = transcript.challenge_vector(
        b"challenge_combine_n_to_one", log2(len(evals)))
    poly_evals = DensePolynomial.from_scalars(evals, device)
    for c in reversed(challenges):
        poly_evals.bound_poly_var_bot(c)
    joint = poly_evals[0]
    r_joint = challenges + list(r)
    transcript.append_scalar(label_eval, joint)
    return r_joint, joint


def _pad_evals(evals) -> list:
    evals = list(evals)
    return evals + [_ZERO] * (next_pow2(len(evals)) - len(evals))


class DerefsEvalProof:
    __slots__ = ("proof_derefs",)

    def __init__(self, proof_derefs):
        self.proof_derefs = proof_derefs

    @staticmethod
    def protocol_name() -> bytes:
        return b"Derefs evaluation proof"

    @staticmethod
    def _prove_single(joint_poly, r, evals, gens, transcript, random_tape):
        assert joint_poly.get_num_vars() == len(r) + log2(len(evals))
        r_joint, joint = _n_to_1_reduce(
            evals, r, transcript, b"evals_ops_val", b"joint_claim_eval",
            joint_poly.Zm.device)
        proof, _ = PolyEvalProof.prove(joint_poly, None, r_joint, joint,
                                       None, gens, transcript, random_tape)
        return proof

    @staticmethod
    def prove(derefs: Derefs, eval_row_ops_val, eval_col_ops_val, r, gens,
              transcript, random_tape):
        transcript.append_protocol_name(DerefsEvalProof.protocol_name())
        evals = _pad_evals(list(eval_row_ops_val) + list(eval_col_ops_val))
        return DerefsEvalProof(DerefsEvalProof._prove_single(
            derefs.comb, r, evals, gens, transcript, random_tape))

    @staticmethod
    def _verify_single(proof, comm, r, evals, gens, transcript, device):
        r_joint, joint = _n_to_1_reduce(
            evals, r, transcript, b"evals_ops_val", b"joint_claim_eval",
            device)
        proof.verify_plain(gens, transcript, r_joint, joint, comm, device)

    def verify(self, r, eval_row_ops_val, eval_col_ops_val, gens,
               comm: DerefsCommitment, transcript, device):
        transcript.append_protocol_name(DerefsEvalProof.protocol_name())
        evals = _pad_evals(list(eval_row_ops_val) + list(eval_col_ops_val))
        DerefsEvalProof._verify_single(
            self.proof_derefs, comm.comm_ops_val, r, evals, gens, transcript,
            device)


class MultiSparseMatPolynomialAsDense:
    __slots__ = ("batch_size", "val", "row", "col", "comb_ops", "comb_mem")

    def __init__(self, batch_size, val, row, col, comb_ops, comb_mem):
        self.batch_size = batch_size
        self.val = val
        self.row = row
        self.col = col
        self.comb_ops = comb_ops
        self.comb_mem = comb_mem

    def deref(self, row_mem_val, col_mem_val) -> Derefs:
        return Derefs(self.row.deref(row_mem_val),
                      self.col.deref(col_mem_val))


class SparseMatPolyCommitmentGens:
    __slots__ = ("gens_ops", "gens_mem", "gens_derefs")

    def __init__(self, label: bytes, num_vars_x: int, num_vars_y: int,
                 num_nz_entries: int, batch_size: int):
        num_vars_ops = log2(next_pow2(num_nz_entries)) + \
            log2(next_pow2(batch_size * 5))
        num_vars_mem = max(num_vars_x, num_vars_y) + 1
        num_vars_derefs = log2(next_pow2(num_nz_entries)) + \
            log2(next_pow2(batch_size * 2))
        self.gens_ops = PolyCommitmentGens(num_vars_ops, label)
        self.gens_mem = PolyCommitmentGens(num_vars_mem, label)
        self.gens_derefs = PolyCommitmentGens(num_vars_derefs, label)


class SparseMatPolyCommitment:
    __slots__ = ("batch_size", "num_ops", "num_mem_cells", "comm_comb_ops",
                 "comm_comb_mem")

    def __init__(self, batch_size, num_ops, num_mem_cells, comm_comb_ops,
                 comm_comb_mem):
        self.batch_size = batch_size
        self.num_ops = num_ops
        self.num_mem_cells = num_mem_cells
        self.comm_comb_ops = comm_comb_ops
        self.comm_comb_mem = comm_comb_mem

    def append_to_transcript(self, _label: bytes, transcript):
        transcript.append_u64(b"batch_size", self.batch_size)
        transcript.append_u64(b"num_ops", self.num_ops)
        transcript.append_u64(b"num_mem_cells", self.num_mem_cells)
        self.comm_comb_ops.append_to_transcript(b"comm_comb_ops", transcript)
        self.comm_comb_mem.append_to_transcript(b"comm_comb_mem", transcript)


def multi_sparse_to_dense_rep(sparse_polys, device=None):
    """sparse_polys: list of models.r1csinstance.SparseMatPolynomial. The
    COO arrays are padded to the next power of two as whole numpy arrays
    (row and column 0, value 0) and moved to `device` once."""
    dev = _device.resolve(device)
    assert sparse_polys
    nvx = sparse_polys[0].num_vars_x
    nvy = sparse_polys[0].num_vars_y
    for p in sparse_polys[1:]:
        assert p.num_vars_x == nvx and p.num_vars_y == nvy
    N = max(next_pow2(max(1, p.get_num_nz_entries())) for p in sparse_polys)

    k = len(sparse_polys)
    ops_row = np.zeros((k, N), np.int64)
    ops_col = np.zeros((k, N), np.int64)
    vals = np.zeros((k, N, 16), np.int32)
    for i, p in enumerate(sparse_polys):
        nnz = p.get_num_nz_entries()
        ops_row[i, :nnz] = p.rows
        ops_col[i, :nnz] = p.cols
        vals[i, :nnz] = p.vals_mont()
    vals_dev = lb.to_device(vals, dev)
    val_vec = [DensePolynomial(vals_dev[i]) for i in range(k)]

    num_mem_cells = 1 << max(nvx, nvy)
    row = AddrTimestamps(num_mem_cells, N, list(ops_row), dev)
    col = AddrTimestamps(num_mem_cells, N, list(ops_col), dev)

    comb_ops = DensePolynomial.merge(
        row.ops_addr + row.read_ts + col.ops_addr + col.read_ts + val_vec)
    comb_mem = DensePolynomial.merge([row.audit_ts, col.audit_ts])
    return MultiSparseMatPolynomialAsDense(k, val_vec, row, col, comb_ops,
                                           comb_mem)


def multi_commit(sparse_polys, gens: SparseMatPolyCommitmentGens,
                 device=None):
    dense = multi_sparse_to_dense_rep(sparse_polys, device)
    comm_comb_ops, _ = dense.comb_ops.commit(gens.gens_ops, None)
    comm_comb_mem, _ = dense.comb_mem.commit(gens.gens_mem, None)
    return (
        SparseMatPolyCommitment(
            dense.batch_size, len(dense.row.read_ts[0]),
            len(dense.row.audit_ts), comm_comb_ops, comm_comb_mem),
        dense,
    )


# --------------------------------------------------------------------------
# Hash layer: hash(addr, val, ts) = ts r^2 + val r + addr - rm (K1)
# --------------------------------------------------------------------------
def hash_poly_plain(addr_m, val_m, ts_m, r_hash_sqr_m, r_hash_m, rm_m,
                    write: bool = False):
    """_hash_poly from K1's plain versions (any device)."""
    h = fq.add_plain(fq.mul_plain(ts_m, r_hash_sqr_m),
                     fq.mul_plain(val_m, r_hash_m))
    h = fq.sub_plain(fq.add_plain(h, addr_m), rm_m)
    return (h, fq.add_plain(h, r_hash_sqr_m)) if write else h


def _hash_poly(addr_m, val_m, ts_m, r_hash_sqr_m, r_hash_m, rm_m,
               write: bool = False):
    """hash(addr, val, ts) = ts r^2 + val r + addr - rm elementwise over
    (..., n, 16) tables that broadcast against each other; the three
    challenges are single (16,) elements. With `write`, also hash(addr,
    val, ts + 1) = h + r^2 (the write timestamps' hash), from the same
    read. On the card one K1 launch a call (csrc/fq.cu k_hash, counted as
    hash_poly), each operand read where it lies through its strides."""
    if addr_m.device.type == "cpu":
        return hash_poly_plain(addr_m, val_m, ts_m, r_hash_sqr_m, r_hash_m,
                               rm_m, write)
    return _hash_launch(addr_m, val_m, ts_m, r_hash_sqr_m, r_hash_m, rm_m,
                        write)


def _hash_launch(addr_m, val_m, ts_m, r_hash_sqr_m, r_hash_m, rm_m, write):
    full = torch.broadcast_shapes(addr_m.shape, val_m.shape, ts_m.shape)
    n, outer = full[-2], math.prod(full[:-2])
    h = torch.empty(full, dtype=torch.int32, device=addr_m.device)
    hw = torch.empty_like(h) if write else None
    ops, strides = [], []
    for t in (addr_m, val_m, ts_m):
        if t.stride(-1) != 1 or any(x % 16 for x in t.stride()[:-1]):
            t = t.contiguous()
        v = t.expand(full).reshape(outer, n, 16)  # a view, or a copy
        if v.device != h.device or v.dtype != torch.int32 or \
                v.data_ptr() % 16:
            raise ValueError("the hash takes int32 tables on one card")
        ops.append(v)
        strides += [v.stride(0) // 16, v.stride(1) // 16]
    chs = [c.reshape(16).contiguous() for c in (r_hash_sqr_m, r_hash_m, rm_m)]
    kernels.require_cuda(*chs)
    st = (ctypes.c_longlong * 6)(*strides)
    kernels.launch("hash_poly", "hash_poly_launch",
                   *(t.data_ptr() for t in ops), ctypes.addressof(st),
                   *(c.data_ptr() for c in chs), h.data_ptr(),
                   hw.data_ptr() if write else None, outer, n,
                   kernels.stream(h))
    return (h, hw) if write else h


class ProductLayer:
    __slots__ = ("init", "read_vec", "write_vec", "audit")

    def __init__(self, init, read_vec, write_vec, audit):
        self.init = init
        self.read_vec = read_vec
        self.write_vec = write_vec
        self.audit = audit


class Layers:
    """One side's (row or column) memory-checking circuits: init, read,
    write and audit (sparse_mlpoly.rs:560-690)."""

    __slots__ = ("prod_layer",)

    def __init__(self, prod_layer: ProductLayer):
        self.prod_layer = prod_layer

    @staticmethod
    def hash_tables(eval_table_dev, addr_timestamps: AddrTimestamps,
                    poly_ops_val, r_mem_check):
        """The leaves of the side's circuits: (init and audit, (2, cells,
        16); read, (B, ops, 16); write, (B, ops, 16))."""
        r_hash, r_multiset_check = r_mem_check
        dev = eval_table_dev.device
        rh, rh2, rm = scalars_to_mont(
            [r_hash, r_hash * r_hash, r_multiset_check], dev)

        num_mem_cells = eval_table_dev.shape[0]
        ident = _u64s_to_mont(np.arange(num_mem_cells, dtype=np.int64), dev)
        ts_mem = torch.stack([torch.zeros_like(ident),
                              addr_timestamps.audit_ts.Zm])
        mem_h = _hash_poly(ident, eval_table_dev, ts_mem, rh2, rh, rm)

        addr = torch.stack([p.Zm for p in addr_timestamps.ops_addr])
        dref = torch.stack([p.Zm for p in poly_ops_val])
        rts = torch.stack([p.Zm for p in addr_timestamps.read_ts])
        # the write timestamps are rts + 1: their hash is the read hash +
        # r^2, written from the same read
        read_h, write_h = _hash_poly(addr, dref, rts, rh2, rh, rm,
                                     write=True)
        return mem_h, read_h, write_h


class PolyEvalNetwork:
    """The row and column circuits. All 4 B ops circuits grow together,
    and so do the 4 memory circuits: one K6 launch per layer each."""

    __slots__ = ("row_layers", "col_layers")

    def __init__(self, dense, derefs, mem_rx_dev, mem_ry_dev, r_mem_check):
        row = Layers.hash_tables(mem_rx_dev, dense.row, derefs.row_ops_val,
                                 r_mem_check)
        col = Layers.hash_tables(mem_ry_dev, dense.col, derefs.col_ops_val,
                                 r_mem_check)
        k = len(derefs.row_ops_val)
        ops = ProductCircuit.batch(torch.cat([row[1], row[2], col[1],
                                              col[2]]))
        mem = ProductCircuit.batch(torch.cat([row[0], col[0]]))
        self.row_layers = Layers(ProductLayer(mem[0], ops[:k], ops[k:2 * k],
                                              mem[1]))
        self.col_layers = Layers(ProductLayer(mem[2], ops[2 * k:3 * k],
                                              ops[3 * k:], mem[3]))


class HashLayerProof:
    __slots__ = ("eval_row", "eval_col", "eval_val", "eval_derefs",
                 "proof_ops", "proof_mem", "proof_derefs")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @staticmethod
    def protocol_name() -> bytes:
        return b"Sparse polynomial hash layer proof"

    @staticmethod
    def _prove_helper(rand_mem, rand_ops, at: AddrTimestamps):
        evals = _evaluate_many(at.ops_addr + at.read_ts, rand_ops)
        k = len(at.ops_addr)
        eval_audit = _evaluate_many([at.audit_ts], rand_mem)[0]
        return evals[:k], evals[k:], eval_audit

    @staticmethod
    def prove(rand, dense, derefs, gens, transcript, random_tape):
        transcript.append_protocol_name(HashLayerProof.protocol_name())
        rand_mem, rand_ops = rand

        k = len(derefs.row_ops_val)
        ev = _evaluate_many(derefs.row_ops_val + derefs.col_ops_val,
                            rand_ops)
        eval_row_ops_val, eval_col_ops_val = ev[:k], ev[k:]
        proof_derefs = DerefsEvalProof.prove(
            derefs, eval_row_ops_val, eval_col_ops_val, rand_ops,
            gens.gens_derefs, transcript, random_tape)
        eval_derefs = (eval_row_ops_val, eval_col_ops_val)

        (eval_row_addr, eval_row_read_ts,
         eval_row_audit_ts) = HashLayerProof._prove_helper(
            rand_mem, rand_ops, dense.row)
        (eval_col_addr, eval_col_read_ts,
         eval_col_audit_ts) = HashLayerProof._prove_helper(
            rand_mem, rand_ops, dense.col)
        eval_val_vec = _evaluate_many(dense.val, rand_ops)

        dev = dense.comb_ops.Zm.device
        evals_ops = _pad_evals(eval_row_addr + eval_row_read_ts +
                               eval_col_addr + eval_col_read_ts +
                               eval_val_vec)
        r_joint_ops, joint_ops = _n_to_1_reduce(
            evals_ops, rand_ops, transcript, b"claim_evals_ops",
            b"joint_claim_eval_ops", dev)
        proof_ops, _ = PolyEvalProof.prove(
            dense.comb_ops, None, r_joint_ops, joint_ops, None,
            gens.gens_ops, transcript, random_tape)

        r_joint_mem, joint_mem = HashLayerProof._two_to_one(
            eval_row_audit_ts, eval_col_audit_ts, rand_mem, transcript, dev)
        proof_mem, _ = PolyEvalProof.prove(
            dense.comb_mem, None, r_joint_mem, joint_mem, None,
            gens.gens_mem, transcript, random_tape)

        return HashLayerProof(
            eval_row=(eval_row_addr, eval_row_read_ts, eval_row_audit_ts),
            eval_col=(eval_col_addr, eval_col_read_ts, eval_col_audit_ts),
            eval_val=eval_val_vec,
            eval_derefs=eval_derefs,
            proof_ops=proof_ops,
            proof_mem=proof_mem,
            proof_derefs=proof_derefs,
        )

    @staticmethod
    def _two_to_one(eval_row_audit_ts, eval_col_audit_ts, rand_mem,
                    transcript, device):
        """The two audit evaluations combined by one challenge."""
        evals_mem = [eval_row_audit_ts, eval_col_audit_ts]
        transcript.append_scalar_vector(b"claim_evals_mem", evals_mem)
        challenges_mem = transcript.challenge_vector(
            b"challenge_combine_two_to_one", 1)
        poly_evals_mem = DensePolynomial.from_scalars(evals_mem, device)
        poly_evals_mem.bound_poly_var_bot(challenges_mem[0])
        joint_mem = poly_evals_mem[0]
        transcript.append_scalar(b"joint_claim_eval_mem", joint_mem)
        return challenges_mem + list(rand_mem), joint_mem

    @staticmethod
    def _verify_helper(rand_mem, claims, eval_ops_val, eval_ops_addr,
                       eval_read_ts, eval_audit_ts, r, r_hash,
                       r_multiset_check):
        def hash_func(addr, val, ts):
            return ts * (r_hash * r_hash) + val * r_hash + addr

        claim_init, claim_read, claim_write, claim_audit = claims
        if not len(eval_ops_addr) == len(eval_ops_val) == \
                len(eval_read_ts) == len(claim_read) == len(claim_write):
            raise ProofVerifyError("hash layer claim count")
        eval_init_addr = IdentityPolynomial(len(rand_mem)).evaluate(rand_mem)
        eval_init_val = EqPolynomial(list(r)).evaluate(rand_mem)
        if not (hash_func(eval_init_addr, eval_init_val, _ZERO) -
                r_multiset_check == claim_init):
            raise ProofVerifyError("hash layer init claim")
        for i in range(len(eval_ops_addr)):
            if not (hash_func(eval_ops_addr[i], eval_ops_val[i],
                              eval_read_ts[i]) - r_multiset_check ==
                    claim_read[i]):
                raise ProofVerifyError("hash layer read claim")
            if not (hash_func(eval_ops_addr[i], eval_ops_val[i],
                              eval_read_ts[i] + _ONE) - r_multiset_check ==
                    claim_write[i]):
                raise ProofVerifyError("hash layer write claim")
        if not (hash_func(eval_init_addr, eval_init_val, eval_audit_ts) -
                r_multiset_check == claim_audit):
            raise ProofVerifyError("hash layer audit claim")

    def verify(self, rand, claims_row, claims_col, claims_dotp, comm, gens,
               comm_derefs, rx, ry, r_hash, r_multiset_check, transcript,
               device):
        timer = Timer("verify_hash_proof")
        transcript.append_protocol_name(HashLayerProof.protocol_name())
        rand_mem, rand_ops = rand

        eval_row_ops_val, eval_col_ops_val = self.eval_derefs
        if len(eval_row_ops_val) != len(eval_col_ops_val):
            raise ProofVerifyError("deref evaluation count")
        self.proof_derefs.verify(rand_ops, eval_row_ops_val,
                                 eval_col_ops_val, gens.gens_derefs,
                                 comm_derefs, transcript, device)

        eval_val_vec = self.eval_val
        if len(claims_dotp) != 3 * len(eval_row_ops_val) or \
                len(eval_val_vec) != len(eval_row_ops_val):
            raise ProofVerifyError("dotp claim count")
        for i in range(len(claims_dotp) // 3):
            if not (claims_dotp[3 * i] == eval_row_ops_val[i] and
                    claims_dotp[3 * i + 1] == eval_col_ops_val[i] and
                    claims_dotp[3 * i + 2] == eval_val_vec[i]):
                raise ProofVerifyError("dotp claims mismatch")

        eval_row_addr, eval_row_read_ts, eval_row_audit_ts = self.eval_row
        eval_col_addr, eval_col_read_ts, eval_col_audit_ts = self.eval_col

        evals_ops = _pad_evals(list(eval_row_addr) + list(eval_row_read_ts) +
                               list(eval_col_addr) + list(eval_col_read_ts) +
                               list(eval_val_vec))
        r_joint_ops, joint_ops = _n_to_1_reduce(
            evals_ops, rand_ops, transcript, b"claim_evals_ops",
            b"joint_claim_eval_ops", device)
        self.proof_ops.verify_plain(gens.gens_ops, transcript, r_joint_ops,
                                    joint_ops, comm.comm_comb_ops, device)

        r_joint_mem, joint_mem = HashLayerProof._two_to_one(
            eval_row_audit_ts, eval_col_audit_ts, rand_mem, transcript,
            device)
        self.proof_mem.verify_plain(gens.gens_mem, transcript, r_joint_mem,
                                    joint_mem, comm.comm_comb_mem, device)

        HashLayerProof._verify_helper(
            rand_mem, claims_row, eval_row_ops_val, eval_row_addr,
            eval_row_read_ts, eval_row_audit_ts, rx, r_hash,
            r_multiset_check)
        HashLayerProof._verify_helper(
            rand_mem, claims_col, eval_col_ops_val, eval_col_addr,
            eval_col_read_ts, eval_col_audit_ts, ry, r_hash,
            r_multiset_check)
        timer.stop()


def _product(xs) -> Scalar:
    acc = _ONE
    for x in xs:
        acc = acc * x
    return acc


class ProductLayerProof:
    __slots__ = ("eval_row", "eval_col", "eval_val", "proof_mem",
                 "proof_ops")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @staticmethod
    def protocol_name() -> bytes:
        return b"Sparse polynomial product layer proof"

    @staticmethod
    def _append_side(side: bytes, init, read, write, audit, transcript):
        transcript.append_scalar(b"claim_" + side + b"_eval_init", init)
        transcript.append_scalar_vector(b"claim_" + side + b"_eval_read",
                                        read)
        transcript.append_scalar_vector(b"claim_" + side + b"_eval_write",
                                        write)
        transcript.append_scalar(b"claim_" + side + b"_eval_audit", audit)

    @staticmethod
    def prove(row_prod_layer, col_prod_layer, dense, derefs, evals,
              transcript):
        transcript.append_protocol_name(ProductLayerProof.protocol_name())

        def layer_evals(layer):
            init = layer.init.evaluate()
            audit = layer.audit.evaluate()
            read = [c.evaluate() for c in layer.read_vec]
            write = [c.evaluate() for c in layer.write_vec]
            return init, read, write, audit

        row_init, row_read, row_write, row_audit = layer_evals(
            row_prod_layer)
        assert row_init * _product(row_write) == \
            _product(row_read) * row_audit
        ProductLayerProof._append_side(b"row", row_init, row_read, row_write,
                                       row_audit, transcript)

        col_init, col_read, col_write, col_audit = layer_evals(
            col_prod_layer)
        assert col_init * _product(col_write) == \
            _product(col_read) * col_audit
        ProductLayerProof._append_side(b"col", col_init, col_read, col_write,
                                       col_audit, transcript)

        assert len(evals) == len(derefs.row_ops_val) == len(dense.val)
        # the dot-product circuits' halves as one stack (row 2i the left
        # half of circuit i, 2i + 1 its right half), evaluated once
        k = len(evals)
        dotp_list = DotProductCircuit.batch(*(
            torch.stack([p.Zm for p in polys]).reshape(2 * k, -1, 16)
            for polys in (derefs.row_ops_val, derefs.col_ops_val,
                          dense.val)))
        eval_dotp_left_vec, eval_dotp_right_vec = [], []
        for i in range(k):
            el = dotp_list[2 * i].evaluate()
            er = dotp_list[2 * i + 1].evaluate()
            transcript.append_scalar(b"claim_eval_dotp_left", el)
            transcript.append_scalar(b"claim_eval_dotp_right", er)
            assert el + er == evals[i]
            eval_dotp_left_vec.append(el)
            eval_dotp_right_vec.append(er)

        prod_list = list(row_prod_layer.read_vec)
        prod_list += row_prod_layer.write_vec
        prod_list += col_prod_layer.read_vec
        prod_list += col_prod_layer.write_vec

        proof_ops, rand_ops = ProductCircuitEvalProofBatched.prove(
            prod_list, dotp_list, transcript)
        proof_mem, rand_mem = ProductCircuitEvalProofBatched.prove(
            [row_prod_layer.init, row_prod_layer.audit,
             col_prod_layer.init, col_prod_layer.audit], [], transcript)

        return (ProductLayerProof(
            eval_row=(row_init, row_read, row_write, row_audit),
            eval_col=(col_init, col_read, col_write, col_audit),
            eval_val=(eval_dotp_left_vec, eval_dotp_right_vec),
            proof_mem=proof_mem,
            proof_ops=proof_ops,
        ), rand_mem, rand_ops)

    def verify(self, num_ops, num_cells, evals, transcript):
        transcript.append_protocol_name(ProductLayerProof.protocol_name())
        timer = Timer("verify_prod_proof")
        num_instances = len(evals)

        for side, (init, read, write, audit) in (
                (b"row", self.eval_row), (b"col", self.eval_col)):
            if not len(read) == len(write) == num_instances:
                raise ProofVerifyError("multiset claim count")
            if not (init * _product(write) == _product(read) * audit):
                raise ProofVerifyError(side.decode() + " multiset check")
            ProductLayerProof._append_side(side, init, read, write, audit,
                                           transcript)
        row_init, row_read, row_write, row_audit = self.eval_row
        col_init, col_read, col_write, col_audit = self.eval_col

        eval_dotp_left, eval_dotp_right = self.eval_val
        if not len(eval_dotp_left) == len(eval_dotp_right) == num_instances:
            raise ProofVerifyError("dotp claim count")
        claims_dotp_circuit = []
        for i in range(num_instances):
            if not (eval_dotp_left[i] + eval_dotp_right[i] == evals[i]):
                raise ProofVerifyError("dotp split claim")
            transcript.append_scalar(b"claim_eval_dotp_left",
                                     eval_dotp_left[i])
            transcript.append_scalar(b"claim_eval_dotp_right",
                                     eval_dotp_right[i])
            claims_dotp_circuit.append(eval_dotp_left[i])
            claims_dotp_circuit.append(eval_dotp_right[i])

        claims_prod_circuit = (list(row_read) + list(row_write) +
                               list(col_read) + list(col_write))
        claims_ops, claims_dotp, rand_ops = self.proof_ops.verify(
            claims_prod_circuit, claims_dotp_circuit, num_ops, transcript)
        claims_mem, _dp, rand_mem = self.proof_mem.verify(
            [row_init, row_audit, col_init, col_audit], [], num_cells,
            transcript)
        timer.stop()
        return claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops


class PolyEvalNetworkProof:
    __slots__ = ("proof_prod_layer", "proof_hash_layer")

    def __init__(self, proof_prod_layer, proof_hash_layer):
        self.proof_prod_layer = proof_prod_layer
        self.proof_hash_layer = proof_hash_layer

    @staticmethod
    def protocol_name() -> bytes:
        return b"Sparse polynomial evaluation proof"

    @staticmethod
    def prove(network, dense, derefs, evals, gens, transcript, random_tape):
        transcript.append_protocol_name(
            PolyEvalNetworkProof.protocol_name())
        proof_prod_layer, rand_mem, rand_ops = ProductLayerProof.prove(
            network.row_layers.prod_layer, network.col_layers.prod_layer,
            dense, derefs, evals, transcript)
        proof_hash_layer = HashLayerProof.prove(
            (rand_mem, rand_ops), dense, derefs, gens, transcript,
            random_tape)
        return PolyEvalNetworkProof(proof_prod_layer, proof_hash_layer)

    def verify(self, comm, comm_derefs, evals, gens, rx, ry, r_mem_check,
               nz, transcript, device):
        timer = Timer("verify_polyeval_proof")
        transcript.append_protocol_name(
            PolyEvalNetworkProof.protocol_name())
        num_instances = len(evals)
        r_hash, r_multiset_check = r_mem_check
        num_ops = next_pow2(nz)
        num_cells = 1 << len(rx)
        assert len(rx) == len(ry)

        claims_mem, rand_mem, claims_ops, claims_dotp, rand_ops = \
            self.proof_prod_layer.verify(num_ops, num_cells, evals,
                                         transcript)
        assert len(claims_mem) == 4
        assert len(claims_ops) == 4 * num_instances
        assert len(claims_dotp) == 3 * num_instances

        n = num_instances
        self.proof_hash_layer.verify(
            (rand_mem, rand_ops),
            (claims_mem[0], claims_ops[:n], claims_ops[n:2 * n],
             claims_mem[1]),
            (claims_mem[2], claims_ops[2 * n:3 * n], claims_ops[3 * n:],
             claims_mem[3]),
            claims_dotp, comm, gens, comm_derefs, rx, ry, r_hash,
            r_multiset_check, transcript, device)
        timer.stop()


class SparseMatPolyEvalProof:
    __slots__ = ("comm_derefs", "poly_eval_network_proof")

    def __init__(self, comm_derefs, poly_eval_network_proof):
        self.comm_derefs = comm_derefs
        self.poly_eval_network_proof = poly_eval_network_proof

    @staticmethod
    def protocol_name() -> bytes:
        return b"Sparse polynomial evaluation proof"

    @staticmethod
    def _equalize(rx, ry):
        if len(rx) < len(ry):
            return [_ZERO] * (len(ry) - len(rx)) + list(rx), list(ry)
        if len(rx) > len(ry):
            return list(rx), [_ZERO] * (len(rx) - len(ry)) + list(ry)
        return list(rx), list(ry)

    @staticmethod
    def prove(dense, rx, ry, evals, gens, transcript, random_tape):
        """Runs on the device of the dense representation."""
        transcript.append_protocol_name(
            SparseMatPolyEvalProof.protocol_name())
        assert len(evals) == dense.batch_size
        dev = dense.comb_ops.Zm.device

        rx_ext, ry_ext = SparseMatPolyEvalProof._equalize(rx, ry)
        mem_rx = EqPolynomial(rx_ext).evals_dev(dev)
        mem_ry = EqPolynomial(ry_ext).evals_dev(dev)
        derefs = dense.deref(mem_rx, mem_ry)

        timer_commit = Timer("commit_nondet_witness")
        comm_derefs = derefs.commit(gens.gens_derefs)
        comm_derefs.append_to_transcript(b"comm_poly_row_col_ops_val",
                                         transcript)
        timer_commit.stop(dev)

        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        timer_build = Timer("build_layered_network")
        net = PolyEvalNetwork(dense, derefs, mem_rx, mem_ry,
                              (r_mem_check[0], r_mem_check[1]))
        timer_build.stop(dev)

        timer_eval = Timer("evalproof_layered_network")
        proof = PolyEvalNetworkProof.prove(net, dense, derefs, evals, gens,
                                           transcript, random_tape)
        timer_eval.stop(dev)
        return SparseMatPolyEvalProof(comm_derefs, proof)

    def verify(self, comm, rx, ry, evals, gens, transcript, device=None):
        dev = _device.resolve(device)
        transcript.append_protocol_name(
            SparseMatPolyEvalProof.protocol_name())
        rx_ext, ry_ext = SparseMatPolyEvalProof._equalize(rx, ry)
        nz, num_mem_cells = comm.num_ops, comm.num_mem_cells
        if (1 << len(rx_ext)) != num_mem_cells:
            raise ProofVerifyError("evaluation point and memory size differ")
        self.comm_derefs.append_to_transcript(b"comm_poly_row_col_ops_val",
                                              transcript)
        r_mem_check = transcript.challenge_vector(b"challenge_r_hash", 2)
        self.poly_eval_network_proof.verify(
            comm, self.comm_derefs, evals, gens, rx_ext, ry_ext,
            (r_mem_check[0], r_mem_check[1]), nz, transcript, dev)
