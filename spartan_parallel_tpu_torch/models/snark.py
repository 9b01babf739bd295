"""SNARK orchestration: the 9-stage spartan_parallel prove/verify pipeline.

Reference: src/lib.rs (SNARKGens :155, SNARK::{multi_encode :793, encode
:818, prove :971, verify :2750}, IOProofs :189, ShiftProofs :361, mem_gen
:832, InstanceSortHelper :759), as the JAX package's models/snark.py
schedules it, transcript byte for transcript byte: instance commitments ->
block sort -> padding -> pairwise sort -> permutation witnesses -> witness
commitments -> the block, pairwise-check and perm-root R1CS SAT proofs
with their SPARK eval proofs -> perm-product openings -> shift proofs ->
IO proofs.

The witnesses live on the caller's device: every witness section is one
(rows, width, 16) Montgomery tensor, encoded from the host lists in one
transfer, its shifted copy a slice of it; padding rows are zeros appended
on the device, so the caller's lists are never changed. The sequential
pi-recursions (lib.rs:1379-1399) stay host loops over exact ints, as in
the JAX package. The Timers carry upstream's stage names (SNARK::prove,
inst_commit, block_sort, witness_gen, input_commit, Block Correctness
Extract, eval_sparse_polys, Pairwise Check, Perm Root, Perm Product, Shift
Proofs, IO Proofs, SNARK::verify). Every entry point takes `device`; the
default is the card, and the CPU is used only when the caller names it.
"""

from __future__ import annotations

import copy
import os

import torch

from ..core import device as _device
from ..core.consts import L
from ..core.edwards import RistrettoPoint
from ..core.field import Scalar
from ..utils.errors import ProofVerifyError
from ..utils.random_tape import RandomTape
from ..utils.timer import Timer
from .commitments import commit_scalar
from .dense_mlpoly import (
    DensePolynomial,
    PolyCommitment,
    PolyEvalProof,
    log2,
    mont_to_scalars,
    next_pow2,
    scalars_to_mont,
    uni_evaluate_many,
)
from .r1csinstance import (
    R1CSCommitmentGens,
    R1CSEvalProof,
    r1cs_commit,
    r1cs_multi_commit,
)
from .r1csproof import (
    ProverWitnessSecInfo,
    R1CSGens,
    R1CSProof,
    VerifierWitnessSecInfo,
)

_ZERO = Scalar.zero()
_ONE = Scalar.one()

INIT_PHY_MEM_WIDTH = 4
INIT_VIR_MEM_WIDTH = 4
PHY_MEM_WIDTH = 4
VIR_MEM_WIDTH = 8
W3_WIDTH = 8


class ComputationCommitment:
    __slots__ = ("comm",)

    def __init__(self, comm):
        self.comm = comm


class ComputationDecommitment:
    __slots__ = ("decomm",)

    def __init__(self, decomm):
        self.decomm = decomm


class SNARKGens:
    """lib.rs:155-187."""

    __slots__ = ("gens_r1cs_sat", "gens_r1cs_eval")

    def __init__(self, num_cons: int, num_vars: int, num_instances: int,
                 num_nz_entries: int):
        num_vars_padded = next_pow2(num_vars)
        num_instances_padded = next_pow2(num_instances)
        self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons,
                                      num_vars_padded)
        self.gens_r1cs_eval = R1CSCommitmentGens(
            b"gens_r1cs_eval", num_instances_padded, num_cons,
            num_vars_padded, num_nz_entries)


# --------------------------------------------------------------------------
# IOProofs (lib.rs:189-359)
# --------------------------------------------------------------------------
class IOProofs:
    __slots__ = ("proofs",)

    def __init__(self, proofs):
        self.proofs = proofs

    @staticmethod
    def _points_and_evals(num_ios, num_inputs_unpadded, num_proofs,
                          input_block_num, output_block_num, input_liveness,
                          input_offset, output_offset, input_, output,
                          output_exec_num):
        r_len = log2(num_proofs * num_ios)

        def to_bin(x):
            return [Scalar((x >> (r_len - 1 - n)) & 1) for n in range(r_len)]

        input_indices = [2 + input_offset + i
                         for i in range(len(input_liveness) - 2)]
        if input_liveness[1]:
            input_indices.insert(0, 5)
        if input_liveness[0]:
            input_indices.insert(0, 6)
        assert len(input_liveness) == len(input_)
        live_input = [v for lv, v in zip(input_liveness, input_) if lv]
        input_indices = input_indices[: len(live_input)]

        indices = [
            0,
            output_exec_num * num_ios,
            2,
            output_exec_num * num_ios + 2 + (num_inputs_unpadded - 1),
            output_exec_num * num_ios + 2 + (num_inputs_unpadded - 1) +
            output_offset - 1,
        ] + input_indices
        evals = [_ONE, _ONE, input_block_num, output_block_num,
                 output] + live_input
        return [to_bin(i) for i in indices], evals

    @staticmethod
    def prove(exec_poly_inputs, num_ios, num_inputs_unpadded, num_proofs,
              input_block_num, output_block_num, input_liveness,
              input_offset, output_offset, input_, output, output_exec_num,
              vars_gens, transcript, random_tape):
        points, evals = IOProofs._points_and_evals(
            num_ios, num_inputs_unpadded, num_proofs, input_block_num,
            output_block_num, input_liveness, input_offset, output_offset,
            input_, output, output_exec_num)
        proofs = PolyEvalProof.prove_batched_points(
            exec_poly_inputs, None, points, evals, None, vars_gens.gens_pc,
            transcript, random_tape)
        return IOProofs(proofs)

    def verify(self, comm_poly_inputs, num_ios, num_inputs_unpadded,
               num_proofs, input_block_num, output_block_num,
               input_liveness, input_offset, output_offset, input_, output,
               output_exec_num, vars_gens, transcript, device):
        points, evals = IOProofs._points_and_evals(
            num_ios, num_inputs_unpadded, num_proofs, input_block_num,
            output_block_num, input_liveness, input_offset, output_offset,
            input_, output, output_exec_num)
        PolyEvalProof.verify_plain_batched_points(
            self.proofs, vars_gens.gens_pc, transcript, points, evals,
            comm_poly_inputs, device)


# --------------------------------------------------------------------------
# ShiftProofs (lib.rs:361-506)
# --------------------------------------------------------------------------
class ShiftProofs:
    __slots__ = ("proof", "C_orig_evals", "C_shifted_evals", "openings")

    def __init__(self, proof, C_orig_evals, C_shifted_evals, openings):
        self.proof = proof
        self.C_orig_evals = C_orig_evals
        self.C_shifted_evals = C_shifted_evals
        self.openings = openings

    @staticmethod
    def prove(orig_polys, shifted_polys, header_len_list, vars_gens,
              transcript, random_tape):
        num_instances = len(orig_polys)
        assert num_instances == len(shifted_polys)
        gens_1 = vars_gens.gens_pc.gens.gens_1

        openings = [[] for _ in range(num_instances)]
        for p in range(num_instances):
            hl = header_len_list[p]
            head = mont_to_scalars(orig_polys[p].Zm[:hl]) if hl else []
            for v in head:
                entry = commit_scalar(v, _ZERO, gens_1).compress()
                transcript.append_point(b"shift_header_entry", entry)
                openings[p].append(entry)

        c = transcript.challenge_scalar(b"challenge_c")
        # every polynomial evaluated at c as a univariate: one K7 launch
        # (uni_evaluate_many); no transcript append falls between them
        evals = uni_evaluate_many(list(orig_polys) + list(shifted_polys), c)
        orig_evals = evals[:num_instances]
        shifted_evals = evals[num_instances:]
        C_orig_evals = [commit_scalar(e, _ZERO, gens_1).compress()
                        for e in orig_evals]
        C_shifted_evals = [commit_scalar(e, _ZERO, gens_1).compress()
                           for e in shifted_evals]

        proof, _eval = PolyEvalProof.prove_uni_batched_instances(
            list(orig_polys) + list(shifted_polys), c,
            orig_evals + shifted_evals, vars_gens.gens_pc, transcript,
            random_tape)
        return ShiftProofs(proof, C_orig_evals, C_shifted_evals, openings)

    def verify(self, orig_comms, shifted_comms, poly_size_list,
               shift_size_list, header_len_list, vars_gens, transcript,
               device=None):
        """The homomorphic shift relation

            orig(c) == shifted(c) * c^shift_size + sum_i header_i * c^i

        is checked on the commitments (all carry zero blinds), as in the
        JAX package; the reference leaves it commented out (lib.rs:480-505,
        PARITY.md D5), and SPARTAN_LAX_SHIFT=1 restores that unchecked
        behaviour. The check touches no transcript bytes. The opening's
        G_hat may run on `device` (None: the host)."""
        for p, header_len in enumerate(header_len_list):
            for i in range(header_len):
                transcript.append_point(b"shift_header_entry",
                                        self.openings[p][i])
        c = transcript.challenge_scalar(b"challenge_c")
        C_orig = [RistrettoPoint.decompress(x) for x in self.C_orig_evals]
        C_shift = [RistrettoPoint.decompress(x)
                   for x in self.C_shifted_evals]
        if not os.environ.get("SPARTAN_LAX_SHIFT"):
            for p in range(len(orig_comms)):
                cpow = _ONE
                for _ in range(shift_size_list[p]):
                    cpow = cpow * c
                rhs = C_shift[p] * cpow
                ci = _ONE
                for i in range(header_len_list[p]):
                    rhs = rhs + RistrettoPoint.decompress(
                        self.openings[p][i]) * ci
                    ci = ci * c
                if rhs != C_orig[p]:
                    raise ProofVerifyError(
                        "shift relation mismatch (instance %d)" % p)
        self.proof.verify_uni_batched_instances(
            vars_gens.gens_pc, transcript, c, C_orig + C_shift,
            list(orig_comms) + list(shifted_comms),
            list(poly_size_list) + list(poly_size_list), device)


# --------------------------------------------------------------------------
# Witness tensors
# --------------------------------------------------------------------------
def _encode_rows(rows, width: int, device, num_rows: int | None = None):
    """Host rows of ints -> (num_rows, width, 16) Montgomery tensor on
    `device`: each row zero-padded to `width`, then zero rows appended up
    to num_rows (default: as many as given). One transfer."""
    num_rows = len(rows) if num_rows is None else num_rows
    assert all(len(r) <= width for r in rows), \
        f"witness row wider than section width {width}"
    flat = [int(v) for r in rows for v in list(r) + [0] * (width - len(r))]
    out = torch.zeros((num_rows, width, 16), dtype=torch.int32,
                      device=device)
    if flat:
        out[:len(rows)] = scalars_to_mont(flat, device).reshape(
            len(rows), width, 16)
    return out


def _shifted_rows(mat: torch.Tensor) -> torch.Tensor:
    """Rows 1.. of a witness tensor, then one zero row."""
    return torch.cat([mat[1:], torch.zeros_like(mat[:1])])


def _flat_poly_commit(mat: torch.Tensor, vars_gens, transcript):
    """(rows, width, 16) tensor -> (DensePolynomial, PolyCommitment):
    commits the flattened rows with zero blinds and appends the commitment
    to the transcript (the lib.rs witness commit idiom)."""
    poly = DensePolynomial(mat.reshape(-1, 16))
    comm, _ = poly.commit(vars_gens.gens_pc, None)
    comm.append_to_transcript(b"poly_commitment", transcript)
    return poly, comm


def _sec_from_rows(mat: torch.Tensor, vars_gens, transcript):
    """A single-instance ProverWitnessSecInfo from a (rows, width, 16)
    tensor, committed: (section, PolyCommitment)."""
    poly, comm = _flat_poly_commit(mat, vars_gens, transcript)
    return ProverWitnessSecInfo([int(mat.shape[1])], [mat], [poly]), comm


def _empty_mem():
    return (ProverWitnessSecInfo.dummy(), PolyCommitment.empty()) * 3


def mem_gen(mem_width, total_num_mem_accesses, mems_list, comb_r, comb_tau,
            vars_gens, transcript, device):
    """lib.rs:832-967: (w2, comm_w2, w3, comm_w3, w3_shifted, comm) of one
    memory's accesses; the pi-recursion runs back to front on the host."""
    if total_num_mem_accesses == 0:
        return _empty_mem()

    r, tau = int(comb_r), int(comb_tau)
    n = total_num_mem_accesses
    mem_w2 = [[0] * mem_width for _ in range(n)]
    for q in range(n):
        mem_w2[q][3] = r * int(mems_list[q][3]) % L
    mem_w3 = [[0] * W3_WIDTH for _ in range(n)]
    for q in range(n - 1, -1, -1):
        v = int(mems_list[q][0])
        addr = int(mems_list[q][2])
        mem_w3[q][0] = v
        mem_w3[q][1] = v * (tau - addr - mem_w2[q][3]) % L
        if q != n - 1:
            mem_w3[q][3] = mem_w3[q][1] * (
                mem_w3[q + 1][2] + 1 - mem_w3[q + 1][0]) % L
        else:
            mem_w3[q][3] = mem_w3[q][1]
        mem_w3[q][2] = mem_w3[q][0] * mem_w3[q][3] % L
        mem_w3[q][4] = v * (v + addr + mem_w2[q][3]) % L
        mem_w3[q][5] = v

    w3 = _encode_rows(mem_w3, W3_WIDTH, device)
    w2_sec, comm_w2 = _sec_from_rows(
        _encode_rows(mem_w2, mem_width, device), vars_gens, transcript)
    w3_sec, comm_w3 = _sec_from_rows(w3, vars_gens, transcript)
    w3s_sec, comm_w3s = _sec_from_rows(_shifted_rows(w3), vars_gens,
                                       transcript)
    return w2_sec, comm_w2, w3_sec, comm_w3, w3s_sec, comm_w3s


class InstanceSortHelper:
    """lib.rs:759-785: stable descending sort of (num_exec, index)."""

    @staticmethod
    def sort_desc(num_execs):
        return sorted(range(len(num_execs)),
                      key=lambda i: (-num_execs[i], i))


def _pad_count(total: int) -> int:
    return 0 if total == 0 else next_pow2(total)


def _sorted_copy(instance, num_instances, index):
    """A shallow copy of an Instance whose R1CSInstance lists are
    reordered; the original keeps its order."""
    out = copy.copy(instance)
    out.inst = copy.copy(instance.inst)
    out.sort(num_instances, index)
    return out


class SNARK:
    __slots__ = (
        "block_comm_vars_list", "exec_comm_inputs", "addr_comm_phy_mems",
        "addr_comm_phy_mems_shifted", "addr_comm_vir_mems",
        "addr_comm_vir_mems_shifted", "addr_comm_ts_bits",
        "perm_exec_comm_w2_list", "perm_exec_comm_w3_list",
        "perm_exec_comm_w3_shifted", "block_comm_w2_list",
        "block_comm_w3_list", "block_comm_w3_list_shifted",
        "init_phy_mem_comm_w2", "init_phy_mem_comm_w3",
        "init_phy_mem_comm_w3_shifted", "init_vir_mem_comm_w2",
        "init_vir_mem_comm_w3", "init_vir_mem_comm_w3_shifted",
        "phy_mem_addr_comm_w2", "phy_mem_addr_comm_w3",
        "phy_mem_addr_comm_w3_shifted", "vir_mem_addr_comm_w2",
        "vir_mem_addr_comm_w3", "vir_mem_addr_comm_w3_shifted",
        "block_r1cs_sat_proof", "block_inst_evals_bound_rp",
        "block_inst_evals_list", "block_r1cs_eval_proof_list",
        "pairwise_check_r1cs_sat_proof",
        "pairwise_check_inst_evals_bound_rp",
        "pairwise_check_inst_evals_list", "pairwise_check_r1cs_eval_proof",
        "perm_root_r1cs_sat_proof", "perm_root_inst_evals",
        "perm_root_r1cs_eval_proof", "perm_poly_poly_list",
        "proof_eval_perm_poly_prod_list", "shift_proof", "io_proof",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @staticmethod
    def protocol_name() -> bytes:
        return b"Spartan SNARK proof"

    @staticmethod
    def multi_encode(inst, gens: SNARKGens, device=None):
        """One SPARK commitment per nnz group of the instances' matrices;
        the decommitments stay on `device` for the prover."""
        dev = _device.resolve(device)
        timer = Timer("SNARK::encode")
        label_map, comm_list, decomm_list = r1cs_multi_commit(
            inst.inst, gens.gens_r1cs_eval, dev)
        timer.stop(dev)
        return (label_map,
                [ComputationCommitment(c) for c in comm_list],
                [ComputationDecommitment(d) for d in decomm_list])

    @staticmethod
    def encode(inst, gens: SNARKGens, device=None):
        dev = _device.resolve(device)
        timer = Timer("SNARK::encode")
        comm, decomm = r1cs_commit(inst.inst, gens.gens_r1cs_eval, dev)
        timer.stop(dev)
        return ComputationCommitment(comm), ComputationDecommitment(decomm)

    # ------------------------------------------------------------------
    @staticmethod
    def _commit_public_params(transcript, func_input_width, input_offset,
                              output_offset, output_exec_num, num_ios,
                              block_num_vars, mem_addr_ts_bits_size,
                              num_inputs_unpadded,
                              block_num_instances_bound,
                              block_max_num_proofs, block_num_phy_ops,
                              block_num_vir_ops,
                              total_num_init_phy_mem_accesses,
                              total_num_init_vir_mem_accesses,
                              total_num_phy_mem_accesses,
                              total_num_vir_mem_accesses, block_num_proofs,
                              block_comm_map, block_comm_list,
                              pairwise_check_comm, perm_root_comm,
                              input_block_num, output_block_num, input_,
                              output):
        t = transcript
        t.append_scalar(b"func_input_width", Scalar(func_input_width))
        t.append_scalar(b"input_offset", Scalar(input_offset))
        t.append_scalar(b"output_offset", Scalar(output_offset))
        t.append_scalar(b"output_exec_num", Scalar(output_exec_num))
        t.append_scalar(b"num_ios", Scalar(num_ios))
        for n in block_num_vars:
            t.append_scalar(b"block_num_vars", Scalar(n))
        t.append_scalar(b"mem_addr_ts_bits_size",
                        Scalar(mem_addr_ts_bits_size))
        t.append_scalar(b"num_inputs_unpadded", Scalar(num_inputs_unpadded))
        t.append_scalar(b"block_num_instances_bound",
                        Scalar(block_num_instances_bound))
        t.append_scalar(b"block_max_num_proofs",
                        Scalar(block_max_num_proofs))
        for p in block_num_phy_ops:
            t.append_scalar(b"block_num_phy_ops", Scalar(p))
        for v in block_num_vir_ops:
            t.append_scalar(b"block_num_vir_ops", Scalar(v))
        t.append_scalar(b"total_num_init_phy_mem_accesses",
                        Scalar(total_num_init_phy_mem_accesses))
        t.append_scalar(b"total_num_init_vir_mem_accesses",
                        Scalar(total_num_init_vir_mem_accesses))
        t.append_scalar(b"total_num_phy_mem_accesses",
                        Scalar(total_num_phy_mem_accesses))
        t.append_scalar(b"total_num_vir_mem_accesses",
                        Scalar(total_num_vir_mem_accesses))
        t.append_scalar(b"block_max_num_proofs",
                        Scalar(block_max_num_proofs))
        for n in block_num_proofs:
            t.append_scalar(b"block_num_proofs", Scalar(n))
        for b in block_comm_map:
            for lbl in b:
                t.append_scalar(b"block_comm_map", Scalar(lbl))
        for c in block_comm_list:
            c.comm.append_to_transcript(b"block_comm", t)
        pairwise_check_comm.comm.append_to_transcript(b"pairwise_comm", t)
        perm_root_comm.comm.append_to_transcript(b"perm_comm", t)
        t.append_scalar(b"input_block_num", input_block_num)
        t.append_scalar(b"output_block_num", output_block_num)
        t.append_scalar_vector(b"input_list", input_)
        t.append_scalar(b"output_list", output)

    # ------------------------------------------------------------------
    @staticmethod
    def prove(input_block_num, output_block_num, input_liveness,
              func_input_width, input_offset, output_offset, input_, output,
              output_exec_num,
              num_vars, num_ios, max_block_num_phy_ops, block_num_phy_ops,
              max_block_num_vir_ops, block_num_vir_ops,
              mem_addr_ts_bits_size, num_inputs_unpadded, block_num_vars,
              block_num_instances_bound, block_max_num_proofs,
              block_num_proofs, block_inst, block_comm_map, block_comm_list,
              block_decomm_list, block_gens,
              consis_num_proofs, total_num_init_phy_mem_accesses,
              total_num_init_vir_mem_accesses, total_num_phy_mem_accesses,
              total_num_vir_mem_accesses, pairwise_check_inst,
              pairwise_check_comm, pairwise_check_decomm,
              pairwise_check_gens,
              block_vars_mat, exec_inputs_list, init_phy_mems_list,
              init_vir_mems_list, addr_phy_mems_list, addr_vir_mems_list,
              addr_ts_bits_list,
              perm_root_inst, perm_root_comm, perm_root_decomm,
              perm_root_gens, vars_gens, transcript, random_tape=None,
              device=None):
        """All witness matrices are nested lists of ints; none of them is
        changed. The instances are sorted in shallow copies (lib.rs:971-
        2746). `random_tape` may be injected for reproducible proofs; the
        default is a fresh OS-seeded tape as in the reference. The
        decommitments must lie on `device`."""
        dev = _device.resolve(device)
        for d in [c.decomm for c in block_decomm_list] + [
                pairwise_check_decomm.decomm, perm_root_decomm.decomm]:
            if d.dense.comb_ops.Zm.device.type != dev.type:
                raise ValueError("a decommitment lies on another device")
        timer_prove = Timer("SNARK::prove")
        if random_tape is None:
            random_tape = RandomTape(b"proof")
        transcript.append_protocol_name(SNARK.protocol_name())

        assert 0 < consis_num_proofs
        for p in block_num_proofs[:block_num_instances_bound]:
            assert p <= block_max_num_proofs
        io_width = 2 * num_inputs_unpadded

        input_block_num_s = Scalar(input_block_num)
        output_block_num_s = Scalar(output_block_num)
        input_s = [Scalar(int(i)) for i in input_]
        output_s = Scalar(int(output))

        timer_commit = Timer("inst_commit")
        SNARK._commit_public_params(
            transcript, func_input_width, input_offset, output_offset,
            output_exec_num, num_ios, block_num_vars, mem_addr_ts_bits_size,
            num_inputs_unpadded, block_num_instances_bound,
            block_max_num_proofs, block_num_phy_ops, block_num_vir_ops,
            total_num_init_phy_mem_accesses,
            total_num_init_vir_mem_accesses, total_num_phy_mem_accesses,
            total_num_vir_mem_accesses, block_num_proofs, block_comm_map,
            block_comm_list, pairwise_check_comm, perm_root_comm,
            input_block_num_s, output_block_num_s, input_s, output_s)
        timer_commit.stop()

        # BLOCK SORT ------------------------------------------------------
        timer_sort = Timer("block_sort")
        block_num_instances = sum(1 for j in block_num_proofs if j > 0)
        order = InstanceSortHelper.sort_desc(
            list(block_num_proofs[:block_num_instances_bound]))
        index = order[:block_num_instances]
        block_num_proofs = [block_num_proofs[i] for i in index]
        block_inst_unsorted = block_inst.inst
        block_inst_sorted = _sorted_copy(block_inst, block_num_instances,
                                         index)
        block_num_vars = [block_num_vars[i] for i in index]
        block_num_phy_ops = [block_num_phy_ops[i] for i in index]
        block_num_vir_ops = [block_num_vir_ops[i] for i in index]
        block_vars_rows = [block_vars_mat[i] for i in index]

        # PADDING (the zero rows are appended on the device below) ---------
        block_max_num_proofs = next_pow2(block_max_num_proofs)
        block_num_proofs = [next_pow2(q) for q in block_num_proofs]
        exec_rows = [list(map(int, q)) for q in exec_inputs_list]
        exec_rows += [[0] * num_ios for _ in range(
            next_pow2(consis_num_proofs) - consis_num_proofs)]
        consis_num_proofs = next_pow2(consis_num_proofs)

        def pad_mems(lst, total, width):
            rows = [list(map(int, q)) for q in lst]
            if total > 0:
                rows += [[0] * width for _ in range(next_pow2(total) - total)]
            return rows, _pad_count(total)

        init_phy_rows, total_num_init_phy_mem_accesses = pad_mems(
            init_phy_mems_list, total_num_init_phy_mem_accesses,
            INIT_PHY_MEM_WIDTH)
        init_vir_rows, total_num_init_vir_mem_accesses = pad_mems(
            init_vir_mems_list, total_num_init_vir_mem_accesses,
            INIT_VIR_MEM_WIDTH)
        addr_phy_rows, total_num_phy_mem_accesses = pad_mems(
            addr_phy_mems_list, total_num_phy_mem_accesses, PHY_MEM_WIDTH)
        addr_vir_rows, n_vir = pad_mems(
            addr_vir_mems_list, total_num_vir_mem_accesses, VIR_MEM_WIDTH)
        addr_ts_rows, _ = pad_mems(addr_ts_bits_list,
                                   total_num_vir_mem_accesses,
                                   mem_addr_ts_bits_size)
        total_num_vir_mem_accesses = n_vir

        # PAIRWISE SORT ----------------------------------------------------
        sizes = [consis_num_proofs, total_num_phy_mem_accesses,
                 total_num_vir_mem_accesses]
        pairwise_order = InstanceSortHelper.sort_desc(sizes)
        pairwise_num_instances = 1 + \
            (1 if total_num_phy_mem_accesses > 0 else 0) + \
            (1 if total_num_vir_mem_accesses > 0 else 0)
        pairwise_index = pairwise_order[:pairwise_num_instances]
        pairwise_check_inst_unsorted = pairwise_check_inst.inst
        pairwise_check_inst_sorted = _sorted_copy(
            pairwise_check_inst, pairwise_num_instances, pairwise_index)
        timer_sort.stop()

        # CHALLENGES AND WITNESSES FOR PERMUTATION --------------------------
        timer_gen = Timer("witness_gen")
        comb_tau = transcript.challenge_scalar(b"challenge_tau")
        comb_r = transcript.challenge_scalar(b"challenge_r")
        tau, r = int(comb_tau), int(comb_r)

        # PERM_W0 = (tau, r, r^2, ...)
        perm_w0 = [tau]
        r_tmp = r
        for _ in range(1, io_width):
            perm_w0.append(r_tmp)
            r_tmp = r_tmp * r % L
        perm_w0 += [0] * (num_ios - io_width)
        perm_w0_sec, _perm_comm_w0 = _sec_from_rows(
            _encode_rows([perm_w0], num_ios, dev), vars_gens, transcript)

        # PERM_EXEC w2/w3 (lib.rs:1345-1473)
        niu = num_inputs_unpadded
        perm_exec_w2 = []
        for inp in exec_rows:
            row = [0, 0, 0] + [perm_w0[j] * inp[j + 2] % L
                               for j in range(1, io_width - 2)]
            row += [0] * (num_ios - len(row))
            perm_exec_w2.append(row)
        for q in range(consis_num_proofs):
            inp = exec_rows[q]
            w2 = perm_exec_w2[q]
            w2[0] = inp[0]
            w2[1] = inp[0]
            for i in range(niu - 1):
                perm = 1 if i == 0 else perm_w0[i]
                w2[0] = (w2[0] + perm * inp[2 + i]) % L
                w2[2] = (w2[2] + perm * inp[2 + (niu - 1) + i]) % L
            w2[0] = w2[0] * inp[0] % L
            ZO = w2[2]
            w2[1] = (w2[1] + ZO) * inp[0] % L
        perm_exec_w3 = [[0] * 8 for _ in range(consis_num_proofs)]
        for q in range(consis_num_proofs - 1, -1, -1):
            inp = exec_rows[q]
            w3 = perm_exec_w3[q]
            w3[0] = inp[0]
            w3[1] = w3[0] * (tau - sum(perm_exec_w2[q][3:]) - inp[2]) % L
            w3[4] = perm_exec_w2[q][0]
            w3[5] = perm_exec_w2[q][1]
            if q != consis_num_proofs - 1:
                w3[3] = w3[1] * (perm_exec_w3[q + 1][2] + 1 -
                                 perm_exec_w3[q + 1][0]) % L
            else:
                w3[3] = w3[1]
            w3[2] = w3[0] * w3[3] % L
        perm_exec_w3_mat = _encode_rows(perm_exec_w3, W3_WIDTH, dev)
        perm_exec_w2_sec, perm_exec_comm_w2 = _sec_from_rows(
            _encode_rows(perm_exec_w2, num_ios, dev), vars_gens, transcript)
        perm_exec_w3_sec, perm_exec_comm_w3 = _sec_from_rows(
            perm_exec_w3_mat, vars_gens, transcript)
        perm_exec_w3s_sec, perm_exec_comm_w3_shifted = _sec_from_rows(
            _shifted_rows(perm_exec_w3_mat), vars_gens, transcript)

        # BLOCK W2 / W3 (lib.rs:1476-1741); padding executions are zero rows
        block_w2_size_list = [
            next_pow2(io_width + 2 * block_num_phy_ops[i] +
                      4 * block_num_vir_ops[i])
            for i in range(block_num_instances)
        ]
        block_w2 = []
        block_w3 = []
        for p in range(block_num_instances):
            npo = block_num_phy_ops[p]
            nvo = block_num_vir_ops[p]
            nq = block_num_proofs[p]
            need = io_width + 2 * npo + 4 * nvo  # the columns read below

            def V_PMR(i):
                return io_width + 2 * i

            def V_PMC(i):
                return io_width + 2 * i + 1

            def V_VMR1(i):
                return io_width + 2 * npo + 4 * i

            def V_VMC(i):
                return io_width + 2 * npo + 4 * i + 3

            block_w2.append([None] * nq)
            block_w3.append([None] * nq)
            for q in range(nq - 1, -1, -1):
                vars_q = [int(v) for v in block_vars_rows[p][q][:need]] \
                    if q < len(block_vars_rows[p]) else []
                vars_q += [0] * (need - len(vars_q))
                V_CNST = vars_q[0]
                w2 = [0] * block_w2_size_list[p]
                w2[0] = vars_q[0]
                w2[1] = vars_q[0]
                for i in range(1, 2 * (niu - 1)):
                    w2[2 + i] = (w2[2 + i] + perm_w0[i] * vars_q[i + 2]) % L
                for i in range(niu - 1):
                    perm = 1 if i == 0 else perm_w0[i]
                    w2[0] = (w2[0] + perm * vars_q[2 + i]) % L
                    w2[2] = (w2[2] + perm * vars_q[2 + (niu - 1) + i]) % L
                w2[0] = w2[0] * vars_q[0] % L
                ZO = w2[2]
                w2[1] = (w2[1] + ZO) * vars_q[0] % L
                w3 = [0] * 8
                w3[0] = vars_q[0]
                w3[1] = w3[0] * (tau - sum(w2[3:]) - vars_q[2]) % L
                if q != nq - 1:
                    w3[3] = w3[1] * (block_w3[p][q + 1][2] + 1 -
                                     block_w3[p][q + 1][0]) % L
                else:
                    w3[3] = w3[1]
                w3[2] = w3[0] * w3[3] % L

                # PHY
                for i in range(npo):
                    w2[V_PMR(i)] = r * vars_q[io_width + 2 * i + 1] % L
                    t_ = V_CNST if i == 0 else w2[V_PMC(i - 1)]
                    w2[V_PMC(i)] = t_ * (
                        tau - vars_q[io_width + 2 * i] - w2[V_PMR(i)]) % L
                px = V_CNST if npo == 0 else w2[V_PMC(npo - 1)]
                if q != nq - 1:
                    w3[5] = px * (block_w3[p][q + 1][4] + 1 -
                                  block_w3[p][q + 1][0]) % L
                else:
                    w3[5] = px
                w3[4] = V_CNST * w3[5] % L

                # VIR
                for i in range(nvo):
                    base = io_width + 2 * npo + 4 * i
                    w2[V_VMR1(i)] = r * vars_q[base + 1] % L
                    w2[V_VMR1(i) + 1] = r * r * vars_q[base + 2] % L
                    w2[V_VMR1(i) + 2] = r * r * r % L * vars_q[base + 3] % L
                    t_ = V_CNST if i == 0 else w2[V_VMC(i - 1)]
                    w2[V_VMC(i)] = t_ * (
                        tau - vars_q[base] - w2[V_VMR1(i)] -
                        w2[V_VMR1(i) + 1] - w2[V_VMR1(i) + 2]) % L
                vx = V_CNST if nvo == 0 else w2[V_VMC(nvo - 1)]
                if q != nq - 1:
                    w3[7] = vx * (block_w3[p][q + 1][6] + 1 -
                                  block_w3[p][q + 1][0]) % L
                else:
                    w3[7] = vx
                w3[6] = V_CNST * w3[7] % L

                block_w2[p][q] = w2
                block_w3[p][q] = w3

        block_w2_mats, block_poly_w2_list, block_comm_w2_list = [], [], []
        for p in range(block_num_instances):
            mat = _encode_rows(block_w2[p], block_w2_size_list[p], dev)
            poly, comm = _flat_poly_commit(mat, vars_gens, transcript)
            block_w2_mats.append(mat)
            block_poly_w2_list.append(poly)
            block_comm_w2_list.append(comm)
        block_w2_sec = ProverWitnessSecInfo(
            block_w2_size_list, block_w2_mats, block_poly_w2_list)

        w3_mats, w3s_mats = [], []
        block_poly_w3_list, block_comm_w3_list = [], []
        block_poly_w3s_list, block_comm_w3s_list = [], []
        for p in range(block_num_instances):
            mat = _encode_rows(block_w3[p], W3_WIDTH, dev)
            mats = _shifted_rows(mat)
            poly, comm = _flat_poly_commit(mat, vars_gens, transcript)
            polys, comms = _flat_poly_commit(mats, vars_gens, transcript)
            w3_mats.append(mat)
            w3s_mats.append(mats)
            block_poly_w3_list.append(poly)
            block_comm_w3_list.append(comm)
            block_poly_w3s_list.append(polys)
            block_comm_w3s_list.append(comms)
        block_w3_sec = ProverWitnessSecInfo(
            [W3_WIDTH] * block_num_instances, w3_mats, block_poly_w3_list)
        block_w3s_sec = ProverWitnessSecInfo(
            [W3_WIDTH] * block_num_instances, w3s_mats, block_poly_w3s_list)

        # INIT/ADDR MEM witness gens ----------------------------------------
        (init_phy_mem_w2_sec, init_phy_mem_comm_w2, init_phy_mem_w3_sec,
         init_phy_mem_comm_w3, init_phy_mem_w3s_sec,
         init_phy_mem_comm_w3_shifted) = mem_gen(
            INIT_PHY_MEM_WIDTH, total_num_init_phy_mem_accesses,
            init_phy_rows, comb_r, comb_tau, vars_gens, transcript, dev)
        (init_vir_mem_w2_sec, init_vir_mem_comm_w2, init_vir_mem_w3_sec,
         init_vir_mem_comm_w3, init_vir_mem_w3s_sec,
         init_vir_mem_comm_w3_shifted) = mem_gen(
            INIT_VIR_MEM_WIDTH, total_num_init_vir_mem_accesses,
            init_vir_rows, comb_r, comb_tau, vars_gens, transcript, dev)
        (phy_mem_addr_w2_sec, phy_mem_addr_comm_w2, phy_mem_addr_w3_sec,
         phy_mem_addr_comm_w3, phy_mem_addr_w3s_sec,
         phy_mem_addr_comm_w3_shifted) = mem_gen(
            PHY_MEM_WIDTH, total_num_phy_mem_accesses, addr_phy_rows,
            comb_r, comb_tau, vars_gens, transcript, dev)

        # VIR_MEM_ADDR (lib.rs:1743-1955)
        if total_num_vir_mem_accesses > 0:
            n = total_num_vir_mem_accesses
            vm = addr_vir_rows
            vm_w2 = [[0] * VIR_MEM_WIDTH for _ in range(n)]
            for q in range(n):
                vm_w2[q][3] = r * vm[q][3] % L
                vm_w2[q][4] = r * r % L * vm[q][4] % L
                vm_w2[q][5] = r * r * r % L * vm[q][5] % L
            vm_w3 = [[0] * W3_WIDTH for _ in range(n)]
            for q in range(n - 1, -1, -1):
                v = vm[q][0]
                addr = vm[q][2]
                vm_w3[q][0] = v
                vm_w3[q][1] = v * (tau - addr - vm_w2[q][3] - vm_w2[q][4] -
                                   vm_w2[q][5]) % L
                if q != n - 1:
                    vm_w3[q][3] = vm_w3[q][1] * (
                        vm_w3[q + 1][2] + 1 - vm_w3[q + 1][0]) % L
                else:
                    vm_w3[q][3] = vm_w3[q][1]
                vm_w3[q][2] = vm_w3[q][0] * vm_w3[q][3] % L
                vm_w3[q][4] = v * (v + addr + vm_w2[q][3] + vm_w2[q][4] +
                                   vm_w2[q][5]) % L
                vm_w3[q][5] = v
            vm_w3_mat = _encode_rows(vm_w3, W3_WIDTH, dev)
            vir_mem_addr_w2_sec, vir_mem_addr_comm_w2 = _sec_from_rows(
                _encode_rows(vm_w2, VIR_MEM_WIDTH, dev), vars_gens,
                transcript)
            vir_mem_addr_w3_sec, vir_mem_addr_comm_w3 = _sec_from_rows(
                vm_w3_mat, vars_gens, transcript)
            vir_mem_addr_w3s_sec, vir_mem_addr_comm_w3_shifted = \
                _sec_from_rows(_shifted_rows(vm_w3_mat), vars_gens,
                               transcript)
        else:
            (vir_mem_addr_w2_sec, vir_mem_addr_comm_w2, vir_mem_addr_w3_sec,
             vir_mem_addr_comm_w3, vir_mem_addr_w3s_sec,
             vir_mem_addr_comm_w3_shifted) = _empty_mem()
        timer_gen.stop(dev)

        # WITNESS COMMITMENTS ------------------------------------------------
        timer_commit = Timer("input_commit")
        block_vars_mats, block_poly_vars_list, block_comm_vars_list = \
            [], [], []
        for p in range(block_num_instances):
            mat = _encode_rows(block_vars_rows[p], block_num_vars[p], dev,
                               num_rows=block_num_proofs[p])
            poly, comm = _flat_poly_commit(mat, vars_gens, transcript)
            block_vars_mats.append(mat)
            block_poly_vars_list.append(poly)
            block_comm_vars_list.append(comm)
        exec_inputs_sec, exec_comm_inputs = _sec_from_rows(
            _encode_rows(exec_rows, num_ios, dev), vars_gens, transcript)

        def mem_sec(total, rows, width):
            if total > 0:
                return _sec_from_rows(_encode_rows(rows, width, dev),
                                      vars_gens, transcript)[0]
            return ProverWitnessSecInfo.dummy()

        init_phy_mems_sec = mem_sec(total_num_init_phy_mem_accesses,
                                    init_phy_rows, INIT_PHY_MEM_WIDTH)
        init_vir_mems_sec = mem_sec(total_num_init_vir_mem_accesses,
                                    init_vir_rows, INIT_VIR_MEM_WIDTH)

        if total_num_phy_mem_accesses > 0:
            mat = _encode_rows(addr_phy_rows, PHY_MEM_WIDTH, dev)
            addr_phy_mems_sec, addr_comm_phy_mems = _sec_from_rows(
                mat, vars_gens, transcript)
            addr_phy_mems_shifted_sec, addr_comm_phy_mems_shifted = \
                _sec_from_rows(_shifted_rows(mat), vars_gens, transcript)
        else:
            addr_comm_phy_mems = PolyCommitment.empty()
            addr_comm_phy_mems_shifted = PolyCommitment.empty()
            addr_phy_mems_sec = ProverWitnessSecInfo.dummy()
            addr_phy_mems_shifted_sec = ProverWitnessSecInfo.dummy()

        if total_num_vir_mem_accesses > 0:
            mat = _encode_rows(addr_vir_rows, VIR_MEM_WIDTH, dev)
            addr_vir_mems_sec, addr_comm_vir_mems = _sec_from_rows(
                mat, vars_gens, transcript)
            addr_vir_mems_shifted_sec, addr_comm_vir_mems_shifted = \
                _sec_from_rows(_shifted_rows(mat), vars_gens, transcript)
            addr_ts_bits_sec, addr_comm_ts_bits = _sec_from_rows(
                _encode_rows(addr_ts_rows, mem_addr_ts_bits_size, dev),
                vars_gens, transcript)
        else:
            addr_comm_vir_mems = PolyCommitment.empty()
            addr_comm_vir_mems_shifted = PolyCommitment.empty()
            addr_comm_ts_bits = PolyCommitment.empty()
            addr_vir_mems_sec = ProverWitnessSecInfo.dummy()
            addr_vir_mems_shifted_sec = ProverWitnessSecInfo.dummy()
            addr_ts_bits_sec = ProverWitnessSecInfo.dummy()

        block_vars_sec = ProverWitnessSecInfo(
            block_num_vars, block_vars_mats, block_poly_vars_list)
        timer_commit.stop(dev)

        # BLOCK_CORRECTNESS_EXTRACT ------------------------------------------
        timer_proof = Timer("Block Correctness Extract")
        block_wit_secs = [block_vars_sec, perm_w0_sec, block_w2_sec,
                          block_w3_sec, block_w3s_sec]
        block_r1cs_sat_proof, block_challenges = R1CSProof.prove(
            block_num_instances, block_max_num_proofs, block_num_proofs,
            num_vars, block_num_vars, block_wit_secs,
            block_inst_sorted.inst, vars_gens, transcript, random_tape, dev)

        rp, _, rx, ry = block_challenges
        timer_eval = Timer("eval_sparse_polys")
        block_inst_evals_list = block_inst_unsorted.multi_evaluate(
            rx, ry, dev)
        _, block_evals_bound_rp = \
            block_inst_sorted.inst.multi_evaluate_bound_rp(rp, rx, ry, dev)
        timer_eval.stop(dev)
        for e in block_inst_evals_list:
            transcript.append_scalar(b"ABCr_claim", e)
        transcript.challenge_scalar(b"challenge_c0")
        transcript.challenge_scalar(b"challenge_c1")
        transcript.challenge_scalar(b"challenge_c2")
        block_r1cs_eval_proof_list = []
        for i in range(len(block_comm_list)):
            proof = R1CSEvalProof.prove(
                block_decomm_list[i].decomm, rx, ry,
                [block_inst_evals_list[j] for j in block_comm_map[i]],
                block_gens.gens_r1cs_eval, transcript, random_tape)
            block_r1cs_eval_proof_list.append(proof)
        timer_proof.stop(dev)

        # PAIRWISE_CHECK ------------------------------------------------------
        timer_proof = Timer("Pairwise Check")
        pairwise_size = max(consis_num_proofs, total_num_phy_mem_accesses,
                            total_num_vir_mem_accesses)
        pairwise_sec, inst_map = ProverWitnessSecInfo.merge(
            [perm_exec_w3_sec, addr_phy_mems_sec, addr_vir_mems_sec])
        pairwise_shifted_sec, _ = ProverWitnessSecInfo.merge(
            [perm_exec_w3s_sec, addr_phy_mems_shifted_sec,
             addr_vir_mems_shifted_sec])
        ts_components = [
            addr_ts_bits_sec if inst_map[i] == 2 else perm_w0_sec
            for i in range(len(inst_map))
        ]
        pairwise_ts_bits_sec = ProverWitnessSecInfo.concat(ts_components)
        pairwise_num_proofs = [int(m.shape[0]) for m in pairwise_sec.w_mat]
        pw_num_inputs = max(8, mem_addr_ts_bits_size)

        (pairwise_check_r1cs_sat_proof,
         pairwise_check_challenges) = R1CSProof.prove(
            pairwise_num_instances, pairwise_size, pairwise_num_proofs,
            pw_num_inputs, [pw_num_inputs] * pairwise_num_instances,
            [pairwise_sec, pairwise_shifted_sec, pairwise_ts_bits_sec],
            pairwise_check_inst_sorted.inst, vars_gens, transcript,
            random_tape, dev)

        rp, _, rx, ry = pairwise_check_challenges
        pairwise_check_inst_evals_list = \
            pairwise_check_inst_unsorted.multi_evaluate(rx, ry, dev)
        _, pairwise_evals_bound_rp = \
            pairwise_check_inst_sorted.inst.multi_evaluate_bound_rp(
                rp, rx, ry, dev)
        for e in pairwise_check_inst_evals_list:
            transcript.append_scalar(b"ABCr_claim", e)
        transcript.challenge_scalar(b"challenge_c0")
        transcript.challenge_scalar(b"challenge_c1")
        transcript.challenge_scalar(b"challenge_c2")
        pairwise_check_r1cs_eval_proof = R1CSEvalProof.prove(
            pairwise_check_decomm.decomm, rx, ry,
            pairwise_check_inst_evals_list,
            pairwise_check_gens.gens_r1cs_eval, transcript, random_tape)
        timer_proof.stop(dev)

        # PERM_ROOT -----------------------------------------------------------
        timer_proof = Timer("Perm Root")
        perm_size = max(consis_num_proofs, total_num_init_phy_mem_accesses,
                        total_num_init_vir_mem_accesses,
                        total_num_phy_mem_accesses,
                        total_num_vir_mem_accesses)
        perm_root_w1_sec, _ = ProverWitnessSecInfo.merge(
            [exec_inputs_sec, init_phy_mems_sec, init_vir_mems_sec,
             addr_phy_mems_sec, addr_vir_mems_sec])
        perm_root_w2_sec, _ = ProverWitnessSecInfo.merge(
            [perm_exec_w2_sec, init_phy_mem_w2_sec, init_vir_mem_w2_sec,
             phy_mem_addr_w2_sec, vir_mem_addr_w2_sec])
        perm_root_w3_sec, _ = ProverWitnessSecInfo.merge(
            [perm_exec_w3_sec, init_phy_mem_w3_sec, init_vir_mem_w3_sec,
             phy_mem_addr_w3_sec, vir_mem_addr_w3_sec])
        perm_root_w3s_sec, _ = ProverWitnessSecInfo.merge(
            [perm_exec_w3s_sec, init_phy_mem_w3s_sec, init_vir_mem_w3s_sec,
             phy_mem_addr_w3s_sec, vir_mem_addr_w3s_sec])
        perm_root_num_instances = len(perm_root_w1_sec.w_mat)
        perm_root_num_proofs = [int(m.shape[0])
                                for m in perm_root_w1_sec.w_mat]
        perm_root_r1cs_sat_proof, perm_root_challenges = R1CSProof.prove(
            perm_root_num_instances, perm_size, perm_root_num_proofs,
            num_ios, [num_ios] * perm_root_num_instances,
            [perm_w0_sec, perm_root_w1_sec, perm_root_w2_sec,
             perm_root_w3_sec, perm_root_w3s_sec],
            perm_root_inst.inst, vars_gens, transcript, random_tape, dev)

        _, _, rx, ry = perm_root_challenges
        Ar, Br, Cr = perm_root_inst.inst.evaluate(rx, ry, dev)
        transcript.append_scalar(b"Ar_claim", Ar)
        transcript.append_scalar(b"Br_claim", Br)
        transcript.append_scalar(b"Cr_claim", Cr)
        perm_root_inst_evals = [Ar, Br, Cr]
        perm_root_r1cs_eval_proof = R1CSEvalProof.prove(
            perm_root_decomm.decomm, rx, ry, perm_root_inst_evals,
            perm_root_gens.gens_r1cs_eval, transcript, random_tape)
        timer_proof.stop(dev)

        # PERM_PRODUCT ---------------------------------------------------------
        timer_proof = Timer("Perm Product")
        components = [perm_exec_w3_sec, init_phy_mem_w3_sec,
                      init_vir_mem_w3_sec, phy_mem_addr_w3_sec,
                      vir_mem_addr_w3_sec, block_w3_sec]
        if max_block_num_phy_ops > 0:
            components.append(block_w3_sec)
        if max_block_num_vir_ops > 0:
            components.append(block_w3_sec)
        perm_poly_w3_sec, pp_inst_map = ProverWitnessSecInfo.merge(
            components)
        pm_bl_id = 6
        vm_bl_id = 7 if max_block_num_phy_ops > 0 else 6
        idx = [6 if m == vm_bl_id else (4 if m == pm_bl_id else 2)
               for m in pp_inst_map]
        # every instance's product entry in one transfer
        perm_poly_poly_list = mont_to_scalars(torch.stack(
            [p.Zm[i] for p, i in zip(perm_poly_w3_sec.poly_w, idx)]))
        two_b = [_ONE, _ZERO]
        four_b = [_ONE, _ZERO, _ZERO]
        six_b = [_ONE, _ONE, _ZERO]
        r_list = [six_b if m == vm_bl_id else
                  (four_b if m == pm_bl_id else two_b)
                  for m in pp_inst_map]
        proof_eval_perm_poly_prod_list = PolyEvalProof.prove_batched_instances(
            perm_poly_w3_sec.poly_w, None, r_list, perm_poly_poly_list,
            None, vars_gens.gens_pc, transcript, random_tape)
        timer_proof.stop(dev)

        # SHIFT_PROOFS ----------------------------------------------------------
        timer_proof = Timer("Shift Proofs")
        orig_polys = [perm_exec_w3_sec.poly_w[0]]
        shifted_polys = [perm_exec_w3s_sec.poly_w[0]]
        header_len_list = [6]
        orig_polys += list(block_w3_sec.poly_w)
        shifted_polys += list(block_w3s_sec.poly_w)
        header_len_list += [8] * block_num_instances
        if total_num_init_phy_mem_accesses > 0:
            orig_polys.append(init_phy_mem_w3_sec.poly_w[0])
            shifted_polys.append(init_phy_mem_w3s_sec.poly_w[0])
            header_len_list.append(6)
        if total_num_init_vir_mem_accesses > 0:
            orig_polys.append(init_vir_mem_w3_sec.poly_w[0])
            shifted_polys.append(init_vir_mem_w3s_sec.poly_w[0])
            header_len_list.append(6)
        if total_num_phy_mem_accesses > 0:
            orig_polys.append(addr_phy_mems_sec.poly_w[0])
            shifted_polys.append(addr_phy_mems_shifted_sec.poly_w[0])
            header_len_list.append(4)
            orig_polys.append(phy_mem_addr_w3_sec.poly_w[0])
            shifted_polys.append(phy_mem_addr_w3s_sec.poly_w[0])
            header_len_list.append(6)
        if total_num_vir_mem_accesses > 0:
            orig_polys.append(addr_vir_mems_sec.poly_w[0])
            shifted_polys.append(addr_vir_mems_shifted_sec.poly_w[0])
            header_len_list.append(6)
            orig_polys.append(vir_mem_addr_w3_sec.poly_w[0])
            shifted_polys.append(vir_mem_addr_w3s_sec.poly_w[0])
            header_len_list.append(6)
        shift_proof = ShiftProofs.prove(
            orig_polys, shifted_polys, header_len_list, vars_gens,
            transcript, random_tape)
        timer_proof.stop(dev)

        # IO_PROOFS -------------------------------------------------------------
        timer_proof = Timer("IO Proofs")
        io_proof = IOProofs.prove(
            exec_inputs_sec.poly_w[0], num_ios, num_inputs_unpadded,
            consis_num_proofs, input_block_num_s, output_block_num_s,
            input_liveness, input_offset, output_offset, input_s, output_s,
            output_exec_num, vars_gens, transcript, random_tape)
        timer_proof.stop(dev)
        timer_prove.stop(dev)

        return SNARK(
            block_comm_vars_list=block_comm_vars_list,
            exec_comm_inputs=[exec_comm_inputs],
            addr_comm_phy_mems=addr_comm_phy_mems,
            addr_comm_phy_mems_shifted=addr_comm_phy_mems_shifted,
            addr_comm_vir_mems=addr_comm_vir_mems,
            addr_comm_vir_mems_shifted=addr_comm_vir_mems_shifted,
            addr_comm_ts_bits=addr_comm_ts_bits,
            perm_exec_comm_w2_list=perm_exec_comm_w2,
            perm_exec_comm_w3_list=perm_exec_comm_w3,
            perm_exec_comm_w3_shifted=perm_exec_comm_w3_shifted,
            block_comm_w2_list=block_comm_w2_list,
            block_comm_w3_list=block_comm_w3_list,
            block_comm_w3_list_shifted=block_comm_w3s_list,
            init_phy_mem_comm_w2=init_phy_mem_comm_w2,
            init_phy_mem_comm_w3=init_phy_mem_comm_w3,
            init_phy_mem_comm_w3_shifted=init_phy_mem_comm_w3_shifted,
            init_vir_mem_comm_w2=init_vir_mem_comm_w2,
            init_vir_mem_comm_w3=init_vir_mem_comm_w3,
            init_vir_mem_comm_w3_shifted=init_vir_mem_comm_w3_shifted,
            phy_mem_addr_comm_w2=phy_mem_addr_comm_w2,
            phy_mem_addr_comm_w3=phy_mem_addr_comm_w3,
            phy_mem_addr_comm_w3_shifted=phy_mem_addr_comm_w3_shifted,
            vir_mem_addr_comm_w2=vir_mem_addr_comm_w2,
            vir_mem_addr_comm_w3=vir_mem_addr_comm_w3,
            vir_mem_addr_comm_w3_shifted=vir_mem_addr_comm_w3_shifted,
            block_r1cs_sat_proof=block_r1cs_sat_proof,
            block_inst_evals_bound_rp=list(block_evals_bound_rp),
            block_inst_evals_list=block_inst_evals_list,
            block_r1cs_eval_proof_list=block_r1cs_eval_proof_list,
            pairwise_check_r1cs_sat_proof=pairwise_check_r1cs_sat_proof,
            pairwise_check_inst_evals_bound_rp=list(
                pairwise_evals_bound_rp),
            pairwise_check_inst_evals_list=pairwise_check_inst_evals_list,
            pairwise_check_r1cs_eval_proof=pairwise_check_r1cs_eval_proof,
            perm_root_r1cs_sat_proof=perm_root_r1cs_sat_proof,
            perm_root_inst_evals=perm_root_inst_evals,
            perm_root_r1cs_eval_proof=perm_root_r1cs_eval_proof,
            perm_poly_poly_list=perm_poly_poly_list,
            proof_eval_perm_poly_prod_list=proof_eval_perm_poly_prod_list,
            shift_proof=shift_proof,
            io_proof=io_proof,
        )

    # ------------------------------------------------------------------
    def verify(self, input_block_num, output_block_num, input_liveness,
               func_input_width, input_offset, output_offset, input_,
               input_stack, input_mem, output, output_exec_num,
               num_vars, num_ios, max_block_num_phy_ops, block_num_phy_ops,
               max_block_num_vir_ops, block_num_vir_ops,
               mem_addr_ts_bits_size, num_inputs_unpadded, block_num_vars,
               block_num_instances_bound, block_max_num_proofs,
               block_num_proofs, block_num_cons, block_comm_map,
               block_comm_list, block_gens,
               consis_num_proofs, total_num_init_phy_mem_accesses,
               total_num_init_vir_mem_accesses, total_num_phy_mem_accesses,
               total_num_vir_mem_accesses, pairwise_check_num_cons,
               pairwise_check_comm, pairwise_check_gens,
               perm_root_num_cons, perm_root_comm, perm_root_gens,
               vars_gens, transcript, device=None):
        """lib.rs:2750-3881. The eq tables and the verifier's own
        commitments are built on `device`."""
        dev = _device.resolve(device)
        timer_verify = Timer("SNARK::verify")
        transcript.append_protocol_name(SNARK.protocol_name())

        assert 0 < consis_num_proofs
        for p in range(block_num_instances_bound):
            assert block_num_proofs[p] <= block_max_num_proofs

        input_block_num_s = Scalar(input_block_num)
        output_block_num_s = Scalar(output_block_num)
        input_s = [Scalar(int(i)) for i in input_]
        input_stack_s = [int(i) for i in input_stack]
        input_mem_s = [int(i) for i in input_mem]
        output_s = Scalar(int(output))

        SNARK._commit_public_params(
            transcript, func_input_width, input_offset, output_offset,
            output_exec_num, num_ios, block_num_vars, mem_addr_ts_bits_size,
            num_inputs_unpadded, block_num_instances_bound,
            block_max_num_proofs, block_num_phy_ops, block_num_vir_ops,
            total_num_init_phy_mem_accesses,
            total_num_init_vir_mem_accesses, total_num_phy_mem_accesses,
            total_num_vir_mem_accesses, block_num_proofs, block_comm_map,
            block_comm_list, pairwise_check_comm, perm_root_comm,
            input_block_num_s, output_block_num_s, input_s, output_s)

        # BLOCK SORT
        block_num_instances = sum(1 for j in block_num_proofs if j > 0)
        order = InstanceSortHelper.sort_desc(
            list(block_num_proofs[:block_num_instances_bound]))
        block_index = order[:block_num_instances]
        block_num_proofs = [block_num_proofs[i] for i in block_index]
        block_num_vars = [block_num_vars[i] for i in block_index]
        block_num_phy_ops_s = [block_num_phy_ops[i] for i in block_index]
        block_num_vir_ops_s = [block_num_vir_ops[i] for i in block_index]

        # PADDING
        block_max_num_proofs = next_pow2(block_max_num_proofs)
        block_num_proofs = [next_pow2(p) for p in block_num_proofs]
        consis_num_proofs = next_pow2(consis_num_proofs)
        total_num_init_phy_mem_accesses = _pad_count(
            total_num_init_phy_mem_accesses)
        total_num_init_vir_mem_accesses = _pad_count(
            total_num_init_vir_mem_accesses)
        total_num_phy_mem_accesses = _pad_count(total_num_phy_mem_accesses)
        total_num_vir_mem_accesses = _pad_count(total_num_vir_mem_accesses)
        block_num_proofs_pad = block_num_proofs + [1] * (
            next_pow2(block_num_instances) - block_num_instances)

        # PAIRWISE SORT
        sizes = [consis_num_proofs, total_num_phy_mem_accesses,
                 total_num_vir_mem_accesses]
        pairwise_order = InstanceSortHelper.sort_desc(sizes)
        pairwise_num_instances = 1 + \
            (1 if total_num_phy_mem_accesses > 0 else 0) + \
            (1 if total_num_vir_mem_accesses > 0 else 0)
        pairwise_index = pairwise_order[:pairwise_num_instances]

        # CHALLENGES + WITNESS COMMITMENT REPLAY
        comb_tau = transcript.challenge_scalar(b"challenge_tau")
        comb_r = transcript.challenge_scalar(b"challenge_r")
        tau, r = int(comb_tau), int(comb_r)
        io_width = 2 * num_inputs_unpadded

        perm_w0 = [tau]
        r_tmp = r
        for _ in range(1, io_width):
            perm_w0.append(r_tmp)
            r_tmp = r_tmp * r % L
        perm_w0 += [0] * (num_ios - io_width)
        perm_comm_w0, _ = DensePolynomial.from_scalars(perm_w0, dev).commit(
            vars_gens.gens_pc, None)
        perm_comm_w0.append_to_transcript(b"poly_commitment", transcript)

        self.perm_exec_comm_w2_list.append_to_transcript(
            b"poly_commitment", transcript)
        self.perm_exec_comm_w3_list.append_to_transcript(
            b"poly_commitment", transcript)
        self.perm_exec_comm_w3_shifted.append_to_transcript(
            b"poly_commitment", transcript)

        block_w2_size_list = [
            next_pow2(io_width + 2 * block_num_phy_ops_s[i] +
                      4 * block_num_vir_ops_s[i])
            for i in range(block_num_instances)]
        for p in range(block_num_instances):
            self.block_comm_w2_list[p].append_to_transcript(
                b"poly_commitment", transcript)
        block_w2_view = VerifierWitnessSecInfo(
            block_num_proofs_pad, block_w2_size_list,
            self.block_comm_w2_list)
        for p in range(block_num_instances):
            self.block_comm_w3_list[p].append_to_transcript(
                b"poly_commitment", transcript)
            self.block_comm_w3_list_shifted[p].append_to_transcript(
                b"poly_commitment", transcript)

        perm_w0_view = VerifierWitnessSecInfo([1], [num_ios],
                                              [perm_comm_w0])
        perm_exec_w2_view = VerifierWitnessSecInfo(
            [consis_num_proofs], [num_ios], [self.perm_exec_comm_w2_list])
        perm_exec_w3_view = VerifierWitnessSecInfo(
            [consis_num_proofs], [W3_WIDTH], [self.perm_exec_comm_w3_list])
        perm_exec_w3s_view = VerifierWitnessSecInfo(
            [consis_num_proofs], [W3_WIDTH],
            [self.perm_exec_comm_w3_shifted])
        block_w3_view = VerifierWitnessSecInfo(
            block_num_proofs_pad, [W3_WIDTH] * block_num_instances,
            self.block_comm_w3_list)
        block_w3s_view = VerifierWitnessSecInfo(
            block_num_proofs_pad, [W3_WIDTH] * block_num_instances,
            self.block_comm_w3_list_shifted)

        def mem_views(total, comm_w2, comm_w3, comm_w3s, w2_width):
            if total > 0:
                comm_w2.append_to_transcript(b"poly_commitment", transcript)
                comm_w3.append_to_transcript(b"poly_commitment", transcript)
                comm_w3s.append_to_transcript(b"poly_commitment",
                                              transcript)
                return (VerifierWitnessSecInfo([total], [w2_width],
                                               [comm_w2]),
                        VerifierWitnessSecInfo([total], [W3_WIDTH],
                                               [comm_w3]),
                        VerifierWitnessSecInfo([total], [W3_WIDTH],
                                               [comm_w3s]))
            return (VerifierWitnessSecInfo.dummy(),
                    VerifierWitnessSecInfo.dummy(),
                    VerifierWitnessSecInfo.dummy())

        (init_phy_mem_w2_view, init_phy_mem_w3_view,
         init_phy_mem_w3s_view) = mem_views(
            total_num_init_phy_mem_accesses, self.init_phy_mem_comm_w2,
            self.init_phy_mem_comm_w3, self.init_phy_mem_comm_w3_shifted,
            INIT_PHY_MEM_WIDTH)
        (init_vir_mem_w2_view, init_vir_mem_w3_view,
         init_vir_mem_w3s_view) = mem_views(
            total_num_init_vir_mem_accesses, self.init_vir_mem_comm_w2,
            self.init_vir_mem_comm_w3, self.init_vir_mem_comm_w3_shifted,
            INIT_VIR_MEM_WIDTH)
        (phy_mem_addr_w2_view, phy_mem_addr_w3_view,
         phy_mem_addr_w3s_view) = mem_views(
            total_num_phy_mem_accesses, self.phy_mem_addr_comm_w2,
            self.phy_mem_addr_comm_w3, self.phy_mem_addr_comm_w3_shifted,
            PHY_MEM_WIDTH)
        (vir_mem_addr_w2_view, vir_mem_addr_w3_view,
         vir_mem_addr_w3s_view) = mem_views(
            total_num_vir_mem_accesses, self.vir_mem_addr_comm_w2,
            self.vir_mem_addr_comm_w3, self.vir_mem_addr_comm_w3_shifted,
            VIR_MEM_WIDTH)

        for p in range(block_num_instances):
            self.block_comm_vars_list[p].append_to_transcript(
                b"poly_commitment", transcript)
        self.exec_comm_inputs[0].append_to_transcript(
            b"poly_commitment", transcript)
        block_vars_view = VerifierWitnessSecInfo(
            block_num_proofs_pad, block_num_vars,
            self.block_comm_vars_list)
        exec_inputs_view = VerifierWitnessSecInfo(
            [consis_num_proofs], [num_ios], self.exec_comm_inputs)

        # the verifier regenerates the initial memories
        def init_mems_view(vals, total, width):
            if vals:
                assert total == next_pow2(len(vals))
                rows = [[1, 0, i, int(v)] for i, v in enumerate(vals)]
                comm, _ = DensePolynomial(
                    _encode_rows(rows, width, dev, num_rows=total)
                    .reshape(-1, 16)).commit(vars_gens.gens_pc, None)
                comm.append_to_transcript(b"poly_commitment", transcript)
                return VerifierWitnessSecInfo([total], [width], [comm])
            return VerifierWitnessSecInfo.dummy()

        init_phy_mems_view = init_mems_view(
            input_stack_s, total_num_init_phy_mem_accesses,
            INIT_PHY_MEM_WIDTH)
        init_vir_mems_view = init_mems_view(
            input_mem_s, total_num_init_vir_mem_accesses,
            INIT_VIR_MEM_WIDTH)

        if total_num_phy_mem_accesses > 0:
            self.addr_comm_phy_mems.append_to_transcript(
                b"poly_commitment", transcript)
            self.addr_comm_phy_mems_shifted.append_to_transcript(
                b"poly_commitment", transcript)
            addr_phy_mems_view = VerifierWitnessSecInfo(
                [total_num_phy_mem_accesses], [PHY_MEM_WIDTH],
                [self.addr_comm_phy_mems])
            addr_phy_mems_shifted_view = VerifierWitnessSecInfo(
                [total_num_phy_mem_accesses], [PHY_MEM_WIDTH],
                [self.addr_comm_phy_mems_shifted])
        else:
            addr_phy_mems_view = VerifierWitnessSecInfo.dummy()
            addr_phy_mems_shifted_view = VerifierWitnessSecInfo.dummy()
        if total_num_vir_mem_accesses > 0:
            self.addr_comm_vir_mems.append_to_transcript(
                b"poly_commitment", transcript)
            self.addr_comm_vir_mems_shifted.append_to_transcript(
                b"poly_commitment", transcript)
            self.addr_comm_ts_bits.append_to_transcript(
                b"poly_commitment", transcript)
            addr_vir_mems_view = VerifierWitnessSecInfo(
                [total_num_vir_mem_accesses], [VIR_MEM_WIDTH],
                [self.addr_comm_vir_mems])
            addr_vir_mems_shifted_view = VerifierWitnessSecInfo(
                [total_num_vir_mem_accesses], [VIR_MEM_WIDTH],
                [self.addr_comm_vir_mems_shifted])
            addr_ts_bits_view = VerifierWitnessSecInfo(
                [total_num_vir_mem_accesses], [mem_addr_ts_bits_size],
                [self.addr_comm_ts_bits])
        else:
            addr_vir_mems_view = VerifierWitnessSecInfo.dummy()
            addr_vir_mems_shifted_view = VerifierWitnessSecInfo.dummy()
            addr_ts_bits_view = VerifierWitnessSecInfo.dummy()

        # BLOCK_CORRECTNESS_EXTRACT
        block_challenges = self.block_r1cs_sat_proof.verify(
            block_num_instances, block_max_num_proofs, block_num_proofs,
            num_vars,
            [block_vars_view, perm_w0_view, block_w2_view, block_w3_view,
             block_w3s_view],
            block_num_cons, vars_gens, self.block_inst_evals_bound_rp,
            transcript, dev)
        rp, _, rx, ry = block_challenges
        for e in self.block_inst_evals_list:
            transcript.append_scalar(b"ABCr_claim", e)
        c0 = transcript.challenge_scalar(b"challenge_c0")
        c1 = transcript.challenge_scalar(b"challenge_c1")
        c2 = transcript.challenge_scalar(b"challenge_c2")
        ABC_evals = [
            c0 * self.block_inst_evals_list[3 * i] +
            c1 * self.block_inst_evals_list[3 * i + 1] +
            c2 * self.block_inst_evals_list[3 * i + 2]
            for i in range(block_num_instances_bound)]
        for i in range(len(block_comm_list)):
            self.block_r1cs_eval_proof_list[i].verify(
                block_comm_list[i].comm, rx, ry,
                [self.block_inst_evals_list[j] for j in block_comm_map[i]],
                block_gens.gens_r1cs_eval, transcript, dev)
        ABC_evals_sorted = [ABC_evals[block_index[i]]
                            for i in range(block_num_instances)]
        lhs = DensePolynomial.from_scalars(ABC_evals_sorted, dev).evaluate(
            rp)
        rhs = (c0 * self.block_inst_evals_bound_rp[0] +
               c1 * self.block_inst_evals_bound_rp[1] +
               c2 * self.block_inst_evals_bound_rp[2])
        if not (lhs == rhs):
            raise ProofVerifyError("block rp-binding mismatch")

        # PAIRWISE_CHECK
        pairwise_size = max(consis_num_proofs, total_num_phy_mem_accesses,
                            total_num_vir_mem_accesses)
        pairwise_view, inst_map = VerifierWitnessSecInfo.merge(
            [perm_exec_w3_view, addr_phy_mems_view, addr_vir_mems_view])
        pairwise_shifted_view, _ = VerifierWitnessSecInfo.merge(
            [perm_exec_w3s_view, addr_phy_mems_shifted_view,
             addr_vir_mems_shifted_view])
        ts_components = [
            addr_ts_bits_view if inst_map[i] == 2 else perm_w0_view
            for i in range(len(inst_map))]
        pairwise_ts_bits_view = VerifierWitnessSecInfo.concat(ts_components)
        pairwise_num_proofs = list(pairwise_view.num_proofs)
        pw_num_inputs = max(8, mem_addr_ts_bits_size)

        pairwise_check_challenges = \
            self.pairwise_check_r1cs_sat_proof.verify(
                pairwise_num_instances, pairwise_size, pairwise_num_proofs,
                pw_num_inputs,
                [pairwise_view, pairwise_shifted_view,
                 pairwise_ts_bits_view],
                pairwise_check_num_cons, vars_gens,
                self.pairwise_check_inst_evals_bound_rp, transcript, dev)
        rp, _, rx, ry = pairwise_check_challenges
        for e in self.pairwise_check_inst_evals_list:
            transcript.append_scalar(b"ABCr_claim", e)
        c0 = transcript.challenge_scalar(b"challenge_c0")
        c1 = transcript.challenge_scalar(b"challenge_c1")
        c2 = transcript.challenge_scalar(b"challenge_c2")
        ABC_evals = [
            c0 * self.pairwise_check_inst_evals_list[3 * i] +
            c1 * self.pairwise_check_inst_evals_list[3 * i + 1] +
            c2 * self.pairwise_check_inst_evals_list[3 * i + 2]
            for i in range(3)]
        self.pairwise_check_r1cs_eval_proof.verify(
            pairwise_check_comm.comm, rx, ry,
            self.pairwise_check_inst_evals_list,
            pairwise_check_gens.gens_r1cs_eval, transcript, dev)
        ABC_evals_sorted = [ABC_evals[pairwise_index[i]]
                            for i in range(pairwise_num_instances)]
        lhs = DensePolynomial.from_scalars(ABC_evals_sorted, dev).evaluate(
            rp)
        rhs = (c0 * self.pairwise_check_inst_evals_bound_rp[0] +
               c1 * self.pairwise_check_inst_evals_bound_rp[1] +
               c2 * self.pairwise_check_inst_evals_bound_rp[2])
        if not (lhs == rhs):
            raise ProofVerifyError("pairwise rp-binding mismatch")

        # PERM_ROOT
        perm_size = max(consis_num_proofs, total_num_init_phy_mem_accesses,
                        total_num_init_vir_mem_accesses,
                        total_num_phy_mem_accesses,
                        total_num_vir_mem_accesses)
        perm_root_w1_view, _ = VerifierWitnessSecInfo.merge(
            [exec_inputs_view, init_phy_mems_view, init_vir_mems_view,
             addr_phy_mems_view, addr_vir_mems_view])
        perm_root_w2_view, _ = VerifierWitnessSecInfo.merge(
            [perm_exec_w2_view, init_phy_mem_w2_view, init_vir_mem_w2_view,
             phy_mem_addr_w2_view, vir_mem_addr_w2_view])
        perm_root_w3_view, _ = VerifierWitnessSecInfo.merge(
            [perm_exec_w3_view, init_phy_mem_w3_view, init_vir_mem_w3_view,
             phy_mem_addr_w3_view, vir_mem_addr_w3_view])
        perm_root_w3s_view, _ = VerifierWitnessSecInfo.merge(
            [perm_exec_w3s_view, init_phy_mem_w3s_view,
             init_vir_mem_w3s_view, phy_mem_addr_w3s_view,
             vir_mem_addr_w3s_view])
        perm_root_num_instances = len(perm_root_w1_view.num_proofs)
        perm_root_num_proofs = list(perm_root_w1_view.num_proofs)
        perm_root_challenges = self.perm_root_r1cs_sat_proof.verify(
            perm_root_num_instances, perm_size, perm_root_num_proofs,
            num_ios,
            [perm_w0_view, perm_root_w1_view, perm_root_w2_view,
             perm_root_w3_view, perm_root_w3s_view],
            perm_root_num_cons, vars_gens, self.perm_root_inst_evals,
            transcript, dev)
        Ar, Br, Cr = self.perm_root_inst_evals
        transcript.append_scalar(b"Ar_claim", Ar)
        transcript.append_scalar(b"Br_claim", Br)
        transcript.append_scalar(b"Cr_claim", Cr)
        _, _, rx, ry = perm_root_challenges
        self.perm_root_r1cs_eval_proof.verify(
            perm_root_comm.comm, rx, ry, self.perm_root_inst_evals,
            perm_root_gens.gens_r1cs_eval, transcript, dev)

        # PERM_PRODUCT
        components = [perm_exec_w3_view, init_phy_mem_w3_view,
                      init_vir_mem_w3_view, phy_mem_addr_w3_view,
                      vir_mem_addr_w3_view, block_w3_view]
        if max_block_num_phy_ops > 0:
            components.append(block_w3_view)
        if max_block_num_vir_ops > 0:
            components.append(block_w3_view)
        perm_poly_w3_view, pp_inst_map = VerifierWitnessSecInfo.merge(
            components)
        pm_bl_id = 6
        vm_bl_id = 7 if max_block_num_phy_ops > 0 else 6
        perm_poly_num_instances = len(perm_poly_w3_view.num_proofs)
        perm_poly_num_proofs = list(perm_poly_w3_view.num_proofs)
        num_vars_list = [log2(perm_poly_num_proofs[i] * 8)
                         for i in range(perm_poly_num_instances)]
        two_b = [_ONE, _ZERO]
        four_b = [_ONE, _ZERO, _ZERO]
        six_b = [_ONE, _ONE, _ZERO]
        r_list = [six_b if m == vm_bl_id else
                  (four_b if m == pm_bl_id else two_b)
                  for m in pp_inst_map]
        if len(self.perm_poly_poly_list) != perm_poly_num_instances:
            raise ProofVerifyError("expected one product per instance")
        PolyEvalProof.verify_plain_batched_instances(
            self.proof_eval_perm_poly_prod_list, vars_gens.gens_pc,
            transcript, r_list, self.perm_poly_poly_list,
            perm_poly_w3_view.comm_w, num_vars_list, dev)

        # the products of each kind of tau (m: the merged component)
        tau_of = {0: "perm_exec", 1: "phy_mem_block", 2: "vir_mem_block",
                  3: "phy_mem_addr", 4: "vir_mem_addr", 5: "perm_block",
                  6: "phy_mem_block" if max_block_num_phy_ops > 0 else
                  "vir_mem_block", 7: "vir_mem_block"}
        taus = dict.fromkeys(tau_of.values(), _ONE)
        for m, v in zip(pp_inst_map, self.perm_poly_poly_list):
            taus[tau_of[m]] = taus[tau_of[m]] * v
        if not (taus["perm_block"] == taus["perm_exec"]):
            raise ProofVerifyError("permutation product mismatch")
        if not (taus["phy_mem_block"] == taus["phy_mem_addr"]):
            raise ProofVerifyError("phy mem product mismatch")
        if not (taus["vir_mem_block"] == taus["vir_mem_addr"]):
            raise ProofVerifyError("vir mem product mismatch")

        # SHIFT_PROOFS
        orig_comms = [perm_exec_w3_view.comm_w[0]]
        shifted_comms = [perm_exec_w3s_view.comm_w[0]]
        orig_comms += list(block_w3_view.comm_w)
        shifted_comms += list(block_w3s_view.comm_w)
        poly_size_list = [8 * consis_num_proofs] + [
            8 * block_num_proofs[i] for i in range(block_num_instances)]
        shift_size_list = [8] + [8] * block_num_instances
        header_len_list = [6] + [8] * block_num_instances
        if total_num_init_phy_mem_accesses > 0:
            orig_comms.append(init_phy_mem_w3_view.comm_w[0])
            shifted_comms.append(init_phy_mem_w3s_view.comm_w[0])
            poly_size_list.append(8 * total_num_init_phy_mem_accesses)
            shift_size_list.append(8)
            header_len_list.append(6)
        if total_num_init_vir_mem_accesses > 0:
            orig_comms.append(init_vir_mem_w3_view.comm_w[0])
            shifted_comms.append(init_vir_mem_w3s_view.comm_w[0])
            poly_size_list.append(8 * total_num_init_vir_mem_accesses)
            shift_size_list.append(8)
            header_len_list.append(6)
        if total_num_phy_mem_accesses > 0:
            orig_comms.append(addr_phy_mems_view.comm_w[0])
            shifted_comms.append(addr_phy_mems_shifted_view.comm_w[0])
            poly_size_list.append(4 * total_num_phy_mem_accesses)
            shift_size_list.append(4)
            header_len_list.append(4)
            orig_comms.append(phy_mem_addr_w3_view.comm_w[0])
            shifted_comms.append(phy_mem_addr_w3s_view.comm_w[0])
            poly_size_list.append(8 * total_num_phy_mem_accesses)
            shift_size_list.append(8)
            header_len_list.append(6)
        if total_num_vir_mem_accesses > 0:
            orig_comms.append(addr_vir_mems_view.comm_w[0])
            shifted_comms.append(addr_vir_mems_shifted_view.comm_w[0])
            poly_size_list.append(8 * total_num_vir_mem_accesses)
            shift_size_list.append(8)
            header_len_list.append(6)
            orig_comms.append(vir_mem_addr_w3_view.comm_w[0])
            shifted_comms.append(vir_mem_addr_w3s_view.comm_w[0])
            poly_size_list.append(8 * total_num_vir_mem_accesses)
            shift_size_list.append(8)
            header_len_list.append(6)
        self.shift_proof.verify(
            orig_comms, shifted_comms, poly_size_list, shift_size_list,
            header_len_list, vars_gens, transcript, dev)

        # IO_PROOFS
        self.io_proof.verify(
            self.exec_comm_inputs[0], num_ios, num_inputs_unpadded,
            consis_num_proofs, input_block_num_s, output_block_num_s,
            input_liveness, input_offset, output_offset, input_s, output_s,
            output_exec_num, vars_gens, transcript, dev)
        timer_verify.stop(dev)
