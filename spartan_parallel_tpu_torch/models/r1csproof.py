"""Data-parallel R1CS satisfiability proof: one proof that P instances,
each executed Q_p times, are satisfied.

Reference: src/r1csproof.rs:210 (prove), :687 (verify); witness-section
descriptors from src/lib.rs:510 (ProverWitnessSecInfo), :602
(VerifierWitnessSecInfo). The transcript schedule is the JAX package's,
byte for byte; the tensors are PyTorch on the caller's device:

  * z is assembled on the device by slice assignment: one dense
    (P, Q_max, W, Y, 16) tensor for uniform execution counts, or one
    (P_c, Q_c, W, Y, 16) tensor per q-size class when the counts differ
    (sorted in decreasing order), O(sum_p Q_p) instead of O(P Q_max);
  * Az/Bz/Cz are K3 SpMV launches per instance, the phase-1 sumcheck runs
    K4 (dense) or K5 (classed), phase 2 runs K4, each round followed on
    the card by K11's round tail (models/sumcheck.py; the host loop for
    CPU tables);
  * the witness openings group the sections' polynomials by size into
    batched Hyrax openings;
  * under a prover mesh (parallel/context.py) the tables of each
    sumcheck's first axis are this rank's share (`shard_big`, at the JAX
    package's sites: the tau_x eq table and Az/Bz/Cz along x, the ABC
    table and the bound z along y). z stays whole on every rank: each
    rank's SpMV reads all of it.

The NIZK (models/nizk.py) is this proof with P = Q = 1 and two sections.
"""

from __future__ import annotations

import torch

from ..core import device as _device
from ..core.edwards import RistrettoPoint, multiscalar_mul
from ..core.field import Scalar
from ..ops import fq
from ..ops.sumcheck import fold_chain, rev_perm
from ..parallel.context import shard_big
from ..utils.errors import ProofVerifyError
from ..utils.timer import Timer
from .commitments import MultiCommitGens, commit_scalar
from .custom_mlpoly import DensePolynomialPqx
from .dense_mlpoly import (
    DensePolynomial,
    EqPolynomial,
    PolyCommitmentGens,
    PolyEvalProof,
    next_pow2,
    scalars_to_mont,
)
from .sigma import EqualityProof, KnowledgeProof, ProductProof
from .sumcheck import ZKSumcheckInstanceProof

_ZERO = Scalar.zero()
_ONE = Scalar.one()


def ceil_log2(n: int) -> int:
    """Reference Math::log_2 semantics (src/math.rs:13-21)."""
    assert n > 0
    return (n - 1).bit_length() if n > 1 else 0


class ProverWitnessSecInfo:
    """One witness section (lib.rs:510-557).

    w_mat: list over instances of (Q_p, num_inputs_p, 16) Montgomery
    tensors (a one-entry list means the section is shared by every
    instance); poly_w: the same values flattened q-major as one
    DensePolynomial per instance, for commitments and openings."""

    __slots__ = ("num_inputs", "w_mat", "poly_w")

    def __init__(self, num_inputs, w_mat, poly_w):
        self.num_inputs = list(num_inputs)
        self.w_mat = w_mat
        self.poly_w = poly_w

    @staticmethod
    def from_scalars(num_inputs, w_mat_host, device=None):
        """w_mat_host: nested [p][q][i] ints/Scalars. Rows shorter than
        the section's width num_inputs[p] are zero-padded to it: the
        committed polynomial's row stride is the declared width, which the
        verifier assumes. device: the card unless the caller names the
        CPU."""
        device = _device.resolve(device)
        mats, polys = [], []
        for p, rows in enumerate(w_mat_host):
            ni = num_inputs[p]
            assert all(len(q) <= ni for q in rows), \
                f"witness row wider than section width {ni}"
            flat = [int(v) for q in rows
                    for v in (list(q) + [0] * (ni - len(q)))]
            dev = scalars_to_mont(flat, device).reshape(len(rows), ni, 16)
            mats.append(dev)
            polys.append(DensePolynomial(dev.reshape(-1, 16)))
        return ProverWitnessSecInfo(num_inputs, mats, polys)

    @staticmethod
    def from_tensors(num_inputs, w_mat):
        """w_mat: list of (Q_p, num_inputs_p, 16) Montgomery tensors."""
        return ProverWitnessSecInfo(
            num_inputs, list(w_mat),
            [DensePolynomial(m.reshape(-1, 16)) for m in w_mat])

    @staticmethod
    def dummy():
        return ProverWitnessSecInfo([], [], [])

    @staticmethod
    def concat(components):
        """lib.rs:537-553."""
        num_inputs, w_mat, poly_w = [], [], []
        for c in components:
            num_inputs += c.num_inputs
            w_mat += list(c.w_mat)
            poly_w += list(c.poly_w)
        return ProverWitnessSecInfo(num_inputs, w_mat, poly_w)

    @staticmethod
    def merge(components):
        """Merge components sorted by decreasing num_proofs
        (lib.rs:558-597). Returns (merged, inst_map)."""
        pointers = [0] * len(components)
        merged_size = sum(len(c.num_inputs) for c in components)
        inst_map, num_inputs, w_mat, poly_w = [], [], [], []
        while len(inst_map) < merged_size:
            nxt_max, nxt = 0, 0
            for i, c in enumerate(components):
                if pointers[i] < len(c.w_mat):
                    np_ = int(c.w_mat[pointers[i]].shape[0])
                    if np_ > nxt_max:
                        nxt_max, nxt = np_, i
            c = components[nxt]
            inst_map.append(nxt)
            num_inputs.append(c.num_inputs[pointers[nxt]])
            w_mat.append(c.w_mat[pointers[nxt]])
            poly_w.append(c.poly_w[pointers[nxt]])
            pointers[nxt] += 1
        return ProverWitnessSecInfo(num_inputs, w_mat, poly_w), inst_map


class VerifierWitnessSecInfo:
    """Verifier view: per-instance sizes and commitments (lib.rs:602-650)."""

    __slots__ = ("num_proofs", "num_inputs", "comm_w")

    def __init__(self, num_proofs, num_inputs, comm_w):
        self.num_proofs = list(num_proofs)[: len(comm_w)]
        self.num_inputs = list(num_inputs)
        self.comm_w = comm_w

    @staticmethod
    def dummy():
        return VerifierWitnessSecInfo([], [], [])

    @staticmethod
    def concat(components):
        num_inputs, num_proofs, comm_w = [], [], []
        for c in components:
            num_inputs += c.num_inputs
            num_proofs += c.num_proofs
            comm_w += list(c.comm_w)
        return VerifierWitnessSecInfo(num_proofs, num_inputs, comm_w)

    @staticmethod
    def merge(components):
        """lib.rs:655-695. Returns (merged, inst_map)."""
        pointers = [0] * len(components)
        merged_size = sum(len(c.num_inputs) for c in components)
        inst_map, num_inputs, num_proofs, comm_w = [], [], [], []
        while len(inst_map) < merged_size:
            nxt_max, nxt = 0, 0
            for i, c in enumerate(components):
                if pointers[i] < len(c.num_proofs):
                    if c.num_proofs[pointers[i]] > nxt_max:
                        nxt_max, nxt = c.num_proofs[pointers[i]], i
            c = components[nxt]
            inst_map.append(nxt)
            num_inputs.append(c.num_inputs[pointers[nxt]])
            num_proofs.append(c.num_proofs[pointers[nxt]])
            comm_w.append(c.comm_w[pointers[nxt]])
            pointers[nxt] += 1
        return VerifierWitnessSecInfo(num_proofs, num_inputs, comm_w), \
            inst_map


class R1CSSumcheckGens:
    """gens_1/gens_3/gens_4 (r1csproof.rs:45-66)."""

    __slots__ = ("gens_1", "gens_3", "gens_4")

    def __init__(self, label: bytes, gens_1_ref: MultiCommitGens):
        self.gens_1 = gens_1_ref
        self.gens_3 = MultiCommitGens(3, label)
        self.gens_4 = MultiCommitGens(4, label)


class R1CSGens:
    __slots__ = ("gens_sc", "gens_pc")

    def __init__(self, label: bytes, _num_cons: int, num_vars: int):
        # Math::log_2 rounds non-powers of two UP (src/math.rs:13-21), so a
        # bound like interface.rs's TOTAL_NUM_VARS_BOUND = 10^7 must work.
        num_poly_vars = ceil_log2(next_pow2(num_vars))
        self.gens_pc = PolyCommitmentGens(num_poly_vars, label)
        self.gens_sc = R1CSSumcheckGens(label, self.gens_pc.gens.gens_1)


def _prefix_list(rw, num_witness_secs: int):
    """The witness sections' mixing weights eq(rw, w) for w < W, with
    W = next_pow2(num_witness_secs) up to 16 (r1csproof.rs:602-632 spells
    out 1, 2, 4 and 8; the table is the same for 16)."""
    k = ceil_log2(next_pow2(num_witness_secs))
    if k > 4:
        raise ValueError(f"unsupported num_witness_secs: {num_witness_secs}")
    out = [_ONE]
    for j in range(k):
        out = [t * f for t in out for f in (_ONE - rw[j], rw[j])]
    return out


def _abc_comb_dev(tabs, rabc, num_inputs, yperm):
    """The phase-2 ABC table: r_A A + r_B B + r_C C, zero past each
    instance's num_inputs on the y axis, y bit-reversed
    (r1csproof.rs:430-465).

    tabs: the A, B and C tables, each (P, W, Y, 16); rabc: (3, 16);
    num_inputs: P live widths; yperm: (Y,) int64. Returns (P, W, Y, 16).
    The products and sums are K1 launches counted as abc_comb; the mask
    and the permutation move data."""
    def mul(a, b):
        return fq.mul(a, b, counter="abc_comb")

    def add(a, b):
        return fq.add(a, b, counter="abc_comb")

    comb = add(add(mul(tabs[0], rabc[0]), mul(tabs[1], rabc[1])),
               mul(tabs[2], rabc[2]))
    Y = comb.shape[2]
    for p, ni in enumerate(num_inputs):
        if ni < Y:
            comb[p, :, ni:] = 0
    return comb.index_select(2, yperm)


def _permute_qy_dev(z, qperm, yperm):
    """(P, Q, W, Y, 16) natural order -> bit-reversed q and y axes."""
    return z.index_select(1, qperm).index_select(3, yperm)


def q_classes(num_proofs):
    """Partition instances (sorted by decreasing num_proofs) into
    contiguous q-size classes [(p0, P_c, Q_c)]. None when unsorted (the
    caller takes the dense layout)."""
    for i in range(len(num_proofs) - 1):
        if num_proofs[i] < num_proofs[i + 1]:
            return None
    classes = []
    p0 = 0
    while p0 < len(num_proofs):
        q = num_proofs[p0]
        p1 = p0
        while p1 < len(num_proofs) and num_proofs[p1] == q:
            p1 += 1
        classes.append((p0, p1 - p0, q))
        p0 = p1
    return classes


def _z_place(z, mat, p: int, q_count: int, w: int, ni: int) -> None:
    """Write one witness block into z[p, :q_count, w, :ni] in place; a
    one-row block (one copy per instance) broadcasts over the proofs."""
    if mat.shape[0] == 1 and q_count > 1:
        z[p, :q_count, w, :ni] = mat[0, :ni]
    else:
        z[p, :q_count, w, :ni] = mat[:q_count, :ni]


def assemble_z_classed(classes, num_inputs, max_num_inputs, witness_secs,
                       device):
    """One natural-order z tensor (P_c, Q_c, W, Y_max, 16) per class."""
    W = next_pow2(len(witness_secs))
    outs = []
    for (p0, P_c, Q_c) in classes:
        z = torch.zeros((P_c, Q_c, W, max_num_inputs, 16), dtype=torch.int32,
                        device=device)
        for w, ws in enumerate(witness_secs):
            for i in range(P_c):
                p_w = 0 if len(ws.w_mat) == 1 else p0 + i
                ni = min(ws.num_inputs[p_w], num_inputs[p0 + i])
                _z_place(z, ws.w_mat[p_w], i, Q_c, w, ni)
        outs.append(z)
    return outs


def assemble_z(num_instances, num_proofs, max_num_proofs, num_inputs,
               max_num_inputs, witness_secs, device):
    """The dense natural-order z tensor (P_pad, Q_max, W_pad, Y_max, 16)
    (r1csproof.rs:277-294)."""
    W = next_pow2(len(witness_secs))
    P = next_pow2(num_instances)
    z = torch.zeros((P, max_num_proofs, W, max_num_inputs, 16),
                    dtype=torch.int32, device=device)
    for w, ws in enumerate(witness_secs):
        for p in range(num_instances):
            p_w = 0 if len(ws.w_mat) == 1 else p
            ni = min(ws.num_inputs[p_w], num_inputs[p])
            _z_place(z, ws.w_mat[p_w], p, num_proofs[p], w, ni)
    return z


def _eq_prod(rs, taus) -> Scalar:
    acc = _ONE
    for a, b in zip(rs, taus):
        acc = acc * (a * b + (_ONE - a) * (_ONE - b))
    return acc


class R1CSProof:
    __slots__ = ("sc_proof_phase1", "claims_phase2", "pok_claims_phase2",
                 "proof_eq_sc_phase1", "sc_proof_phase2",
                 "comm_vars_at_ry_list", "comm_vars_at_ry",
                 "proof_eval_vars_at_ry_list", "proof_eq_sc_phase2")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])

    @staticmethod
    def protocol_name() -> bytes:
        return b"R1CS proof"

    # ------------------------------------------------------------------
    @staticmethod
    def prove(num_instances: int, max_num_proofs: int, num_proofs,
              max_num_inputs: int, num_inputs, witness_secs, inst, gens,
              transcript, random_tape, device=None):
        """witness_secs: list of ProverWitnessSecInfo with tensors on
        `device` (the card unless the caller names the CPU). Returns the
        proof and the challenge vectors [rp, rq_rev, rx, rw + ry]."""
        dev = _device.resolve(device)
        timer_prove = Timer("R1CSProof::prove")
        transcript.append_protocol_name(R1CSProof.protocol_name())

        num_witness_secs = len(witness_secs)
        assert max_num_proofs == next_pow2(max_num_proofs)
        for p in num_proofs:
            assert p == next_pow2(p) and p <= max_num_proofs
        for i in num_inputs:
            assert i == next_pow2(i) and i <= max_num_inputs
        assert inst.get_num_instances() in (1, num_instances)
        assert 1 <= num_witness_secs <= 16

        num_cons = inst.get_num_cons()
        if inst.get_num_instances() == 1:
            block_num_cons = [inst.get_inst_num_cons()[0]] * num_instances
        else:
            block_num_cons = list(inst.get_inst_num_cons())

        # z assembly (natural order): skewed execution counts take the
        # q-size-classed layout, uniform counts the single dense tensor
        classes = q_classes(list(num_proofs)) if \
            len(set(num_proofs)) > 1 else None
        timer = Timer("prove_z_mat_gen")
        if classes is not None:
            z_class = assemble_z_classed(classes, num_inputs, max_num_inputs,
                                         witness_secs, dev)
        else:
            z_nat = assemble_z(num_instances, num_proofs, max_num_proofs,
                               num_inputs, max_num_inputs, witness_secs, dev)
        timer.stop(dev)

        nrp = ceil_log2(next_pow2(num_instances))
        nrq = ceil_log2(max_num_proofs)
        nrx = ceil_log2(num_cons)
        nrw = ceil_log2(num_witness_secs)
        nry = ceil_log2(max_num_inputs)

        tau_p = transcript.challenge_vector(b"challenge_tau_p", nrp)
        tau_q = transcript.challenge_vector(b"challenge_tau_q", nrq)
        tau_x = transcript.challenge_vector(b"challenge_tau_x", nrx)

        timer = Timer("prove_vec_mult")
        poly_tau_p = EqPolynomial(tau_p).evals_dev(dev)
        poly_tau_q = EqPolynomial(tau_q).evals_dev(dev)
        poly_tau_x = shard_big(EqPolynomial(tau_x).evals_dev(dev), 0)
        if classes is not None:
            class_tensors = []
            for (p0, P_c, Q_c), znc in zip(classes, z_class):
                class_tensors.append((p0,) + tuple(
                    shard_big(t, 2) for t in inst.multiply_vec_block_classed(
                        p0, Q_c, num_cons, znc)))
        else:
            poly_Az, poly_Bz, poly_Cz = inst.multiply_vec_block(
                num_instances, list(num_proofs), max_num_proofs,
                list(num_inputs), max_num_inputs, num_cons, block_num_cons,
                z_nat)
        timer.stop(dev)

        # Sumcheck 1: eq(p,q,x) * (Az*Bz - Cz) == 0 ------------------------
        timer_sc1 = Timer("prove_sc_phase_one")
        if classes is not None:
            (sc_proof_phase1, rx_all, claims_phase1, blind_claim_postsc1) = \
                ZKSumcheckInstanceProof.prove_phase1_classed(
                    _ZERO, _ZERO, nrx + nrq + nrp, nrx, nrq, nrp,
                    poly_tau_p, poly_tau_q, poly_tau_x, class_tensors,
                    gens.gens_sc.gens_1, gens.gens_sc.gens_4,
                    transcript, random_tape)
            del class_tensors
        else:
            (sc_proof_phase1, rx_all, claims_phase1, blind_claim_postsc1) = \
                ZKSumcheckInstanceProof.prove_cubic_with_additive_term_disjoint_rounds(
                    _ZERO, _ZERO, nrx + nrq + nrp, nrx, nrq, nrp,
                    poly_tau_p, poly_tau_q, poly_tau_x,
                    shard_big(poly_Az.Zm[:, :, 0], 2),
                    shard_big(poly_Bz.Zm[:, :, 0], 2),
                    shard_big(poly_Cz.Zm[:, :, 0], 2),
                    gens.gens_sc.gens_1, gens.gens_sc.gens_4,
                    transcript, random_tape)
            del poly_Az, poly_Bz, poly_Cz
        timer_sc1.stop(dev)

        tau_claim = claims_phase1[0]
        Az_claim, Bz_claim, Cz_claim = claims_phase1[1:4]
        Az_blind = random_tape.random_scalar(b"Az_blind")
        Bz_blind = random_tape.random_scalar(b"Bz_blind")
        Cz_blind = random_tape.random_scalar(b"Cz_blind")
        prod_Az_Bz_blind = random_tape.random_scalar(b"prod_Az_Bz_blind")

        pok_Cz_claim, comm_Cz_claim = KnowledgeProof.prove(
            gens.gens_sc.gens_1, transcript, random_tape, Cz_claim, Cz_blind)
        prod = Az_claim * Bz_claim
        (proof_prod, comm_Az_claim, comm_Bz_claim,
         comm_prod_Az_Bz_claims) = ProductProof.prove(
            gens.gens_sc.gens_1, transcript, random_tape, Az_claim, Az_blind,
            Bz_claim, Bz_blind, prod, prod_Az_Bz_blind)

        transcript.append_point(b"comm_Az_claim", comm_Az_claim)
        transcript.append_point(b"comm_Bz_claim", comm_Bz_claim)
        transcript.append_point(b"comm_Cz_claim", comm_Cz_claim)
        transcript.append_point(b"comm_prod_Az_Bz_claims",
                                comm_prod_Az_Bz_claims)

        blind_expected_claim_postsc1 = tau_claim * (
            prod_Az_Bz_blind - Cz_blind)
        claim_post_phase1 = (Az_claim * Bz_claim - Cz_claim) * tau_claim
        proof_eq_sc_phase1, _c1, _c2 = EqualityProof.prove(
            gens.gens_sc.gens_1, transcript, random_tape, claim_post_phase1,
            blind_expected_claim_postsc1, claim_post_phase1,
            blind_claim_postsc1)

        # split rx -> (rx, rq, rp) (r1csproof.rs:410-416)
        rx_rev = rx_all[:nrx]
        rq_rev = rx_all[nrx:nrx + nrq]
        rp_round1 = rx_all[nrx + nrq:]
        rx = list(reversed(rx_rev))
        rq = list(reversed(rq_rev))

        # PHASE 2 -----------------------------------------------------------
        timer_sc2 = Timer("prove_sc_phase_two")
        r_A = transcript.challenge_scalar(b"challenge_Az")
        r_B = transcript.challenge_scalar(b"challenge_Bz")
        r_C = transcript.challenge_scalar(b"challenge_Cz")
        claim_phase2 = r_A * Az_claim + r_B * Bz_claim + r_C * Cz_claim
        blind_claim_phase2 = r_A * Az_blind + r_B * Bz_blind + r_C * Cz_blind

        timer = Timer("prove_abc_gen")
        rx_tab = EqPolynomial(rx).evals_dev(dev)
        tabs = inst.compute_eval_table_sparse_disjoint_rounds(
            num_instances, inst.get_inst_num_cons(), num_witness_secs,
            max_num_inputs, list(num_inputs), rx_tab)
        # RLC by (rA, rB, rC), zero past each instance's live y, y reversed
        P_inst = inst.get_num_instances()
        yperm = torch.as_tensor(rev_perm(max_num_inputs), device=dev)
        ABC_dense = _abc_comb_dev(
            [torch.stack([t[k] for t in tabs]) for k in range(3)],
            scalars_to_mont([r_A, r_B, r_C], dev), num_inputs[:P_inst],
            yperm)  # (P_inst, W, Y, 16)
        del tabs
        if P_inst < next_pow2(num_instances) and P_inst != 1:
            ABC_dense = torch.cat([ABC_dense, ABC_dense.new_zeros(
                (next_pow2(num_instances) - P_inst,) + ABC_dense.shape[1:])])
        ABC_dense = shard_big(ABC_dense, 2)
        timer.stop(dev)

        timer = Timer("prove_z_gen")
        if classes is not None:
            # per-class q bind: fold the class's own log2(Q_c) challenges,
            # scale by prod(1 - rq_rev[i]) for the rounds it skipped (the
            # zero-padded dense fold's degenerate form; the verifier's
            # mirror is the (1 - rq) product at r1csproof.rs:836-839), then
            # concatenate along p
            zparts = []
            for (p0, P_c, Q_c), znc in zip(classes, z_class):
                qperm_c = torch.as_tensor(rev_perm(Q_c), device=dev)
                Zc = _permute_qy_dev(znc, qperm_c, yperm)
                lq = ceil_log2(Q_c)
                if lq:
                    Zc = fold_chain(Zc, scalars_to_mont(rq_rev[:lq], dev), 1)
                Zc = Zc[:, :1]
                u_c = _ONE
                for i in range(lq, nrq):
                    u_c = u_c * (_ONE - rq_rev[i])
                if u_c != _ONE:
                    Zc = fq.mul(Zc, scalars_to_mont([u_c], dev)[0])
                zparts.append(Zc)
            del z_class
            Zcat = torch.cat(zparts, 0)
            P_pad = next_pow2(num_instances)
            if Zcat.shape[0] < P_pad:
                Zcat = torch.cat([Zcat, Zcat.new_zeros(
                    (P_pad - Zcat.shape[0],) + Zcat.shape[1:])])
            Z_bound = Zcat[:, 0]
        else:
            qperm = torch.as_tensor(rev_perm(max_num_proofs), device=dev)
            Z_poly = DensePolynomialPqx(_permute_qy_dev(z_nat, qperm, yperm),
                                        list(num_proofs), list(num_inputs))
            del z_nat
        timer.stop(dev)
        timer = Timer("prove_z_bind")
        if classes is None:
            Z_poly.bound_poly_vars_rq(rq_rev)
            Z_bound = Z_poly.Zm[:, 0]
        timer.stop(dev)

        eq_p_rp = EqPolynomial(list(rp_round1)).evals_dev(dev)
        single_inst = inst.get_num_instances() == 1

        (sc_proof_phase2, ry_all, claims_phase2_v, blind_claim_postsc2) = \
            ZKSumcheckInstanceProof.prove_cubic_disjoint_rounds(
                claim_phase2, blind_claim_phase2, nry + nrw + nrp,
                nry, nrw, nrp, single_inst, eq_p_rp, ABC_dense,
                shard_big(Z_bound.contiguous(), 2),
                gens.gens_sc.gens_1, gens.gens_sc.gens_4,
                transcript, random_tape)
        timer_sc2.stop(dev)

        # split ry -> (ry, rw, rp) (r1csproof.rs:504-510)
        ry_rev = ry_all[:nry]
        rw = ry_all[nry:nry + nrw]
        rp = ry_all[nry + nrw:]
        ry = list(reversed(ry_rev))

        # POLY COMMIT: per-witness-sec openings (r1csproof.rs:515-645) ------
        timer_polyeval = Timer("polyeval")
        ry_factors = [_ONE] * (nry + 1)
        for i in range(nry):
            ry_factors[i + 1] = ry_factors[i] * (_ONE - ry[i])

        poly_list, num_proofs_list, num_inputs_list, Zr_list = [], [], [], []
        eval_vars_at_ry_list = [[] for _ in range(num_witness_secs)]
        comm_vars_at_ry_list = [[] for _ in range(num_witness_secs)]
        for i, w in enumerate(witness_secs):
            for p in range(len(w.w_mat)):
                poly_list.append(w.poly_w[p])
                n_pf = int(w.w_mat[p].shape[0])
                num_proofs_list.append(n_pf)
                num_inputs_list.append(w.num_inputs[p])
                ny_w = ceil_log2(w.num_inputs[p])
                if w.num_inputs[p] >= max_num_inputs:
                    ry_short = [_ZERO] * (ny_w - nry) + ry
                else:
                    ry_short = ry[nry - ny_w:]
                rq_short = rq[len(rq) - ceil_log2(n_pf):] if \
                    ceil_log2(n_pf) else []
                r_pt = rq_short + ry_short
                assert len(r_pt) == w.poly_w[p].num_vars, (
                    f"witness sec {i} inst {p}: committed poly has "
                    f"{w.poly_w[p].num_vars} vars but n_pf={n_pf}, "
                    f"num_inputs={w.num_inputs[p]} imply {len(r_pt)}")
                ev = w.poly_w[p].evaluate(r_pt)
                Zr_list.append(ev)
                if w.num_inputs[p] >= max_num_inputs:
                    eval_vars_at_ry_list[i].append(ev)
                else:
                    eval_vars_at_ry_list[i].append(
                        ev * ry_factors[nry - ny_w])
                comm_vars_at_ry_list[i].append(
                    commit_scalar(ev, _ZERO,
                                  gens.gens_pc.gens.gens_1).compress())

        proof_eval_vars_at_ry_list = \
            PolyEvalProof.prove_batched_instances_disjoint_rounds(
                poly_list, num_proofs_list, num_inputs_list, None, rq, ry,
                Zr_list, None, gens.gens_pc, transcript, random_tape)

        # bind the witness list to rp
        eval_vars_comb_list = []
        prefix_list = _prefix_list(rw, num_witness_secs)
        for p in range(num_instances):
            comb = _ZERO
            for i in range(num_witness_secs):
                p_w = 0 if len(witness_secs[i].w_mat) == 1 else p
                comb = comb + prefix_list[i] * eval_vars_at_ry_list[i][p_w]
            for q in range(nrq - ceil_log2(num_proofs[p])):
                comb = comb * (_ONE - rq[q])
            eval_vars_comb_list.append(comb)
        timer_polyeval.stop(dev)

        # one instance: no rp variable, the list is the value
        eval_vars_at_ry = DensePolynomial.from_scalars(
            eval_vars_comb_list, dev).evaluate(rp) if rp else \
            eval_vars_comb_list[0]
        comm_vars_at_ry = commit_scalar(
            eval_vars_at_ry, _ZERO, gens.gens_pc.gens.gens_1).compress()

        claim_post_phase2 = (claims_phase2_v[0] * claims_phase2_v[1] *
                             claims_phase2_v[2])
        proof_eq_sc_phase2, _c1, _c2 = EqualityProof.prove(
            gens.gens_pc.gens.gens_1, transcript, random_tape,
            claim_post_phase2, _ZERO, claim_post_phase2, blind_claim_postsc2)
        timer_prove.stop(dev)

        proof = R1CSProof(
            sc_proof_phase1=sc_proof_phase1,
            claims_phase2=(comm_Az_claim, comm_Bz_claim, comm_Cz_claim,
                           comm_prod_Az_Bz_claims),
            pok_claims_phase2=(pok_Cz_claim, proof_prod),
            proof_eq_sc_phase1=proof_eq_sc_phase1,
            sc_proof_phase2=sc_proof_phase2,
            comm_vars_at_ry_list=comm_vars_at_ry_list,
            comm_vars_at_ry=comm_vars_at_ry,
            proof_eval_vars_at_ry_list=proof_eval_vars_at_ry_list,
            proof_eq_sc_phase2=proof_eq_sc_phase2,
        )
        return proof, [list(rp), list(rq_rev), rx, list(rw) + ry]

    # ------------------------------------------------------------------
    def verify(self, num_instances: int, max_num_proofs: int, num_proofs,
               max_num_inputs: int, witness_secs, num_cons: int, gens,
               evals, transcript, device=None):
        """witness_secs: list of VerifierWitnessSecInfo; evals: (eA, eB,
        eC) bound to rp (r1csproof.rs:687-946). The eq tables of the
        openings are built on `device` (the card unless the caller names
        the CPU)."""
        device = _device.resolve(device)
        transcript.append_protocol_name(R1CSProof.protocol_name())
        num_witness_secs = len(witness_secs)
        assert 1 <= num_witness_secs <= 16
        if len(self.comm_vars_at_ry_list) != num_witness_secs or any(
                len(c) != len(w.num_proofs)
                for c, w in zip(self.comm_vars_at_ry_list, witness_secs)):
            raise ProofVerifyError("expected one opening per witness "
                                   "section and instance")

        nrp = ceil_log2(next_pow2(num_instances))
        nrq = ceil_log2(max_num_proofs)
        nrx = ceil_log2(num_cons)
        nrw = ceil_log2(num_witness_secs)
        nry = ceil_log2(max_num_inputs)

        tau_p = transcript.challenge_vector(b"challenge_tau_p", nrp)
        tau_q = transcript.challenge_vector(b"challenge_tau_q", nrq)
        tau_x = transcript.challenge_vector(b"challenge_tau_x", nrx)

        claim_phase1 = commit_scalar(
            _ZERO, _ZERO, gens.gens_sc.gens_1).compress()
        t_sc1 = Timer("verify_sc1")
        comm_claim_post_phase1, rx_all = self.sc_proof_phase1.verify(
            claim_phase1, nrx + nrq + nrp, 3, gens.gens_sc.gens_1,
            gens.gens_sc.gens_4, transcript)
        t_sc1.stop()

        (comm_Az_claim, comm_Bz_claim, comm_Cz_claim,
         comm_prod_Az_Bz_claims) = self.claims_phase2
        pok_Cz_claim, proof_prod = self.pok_claims_phase2
        pok_Cz_claim.verify(gens.gens_sc.gens_1, transcript, comm_Cz_claim)
        proof_prod.verify(gens.gens_sc.gens_1, transcript, comm_Az_claim,
                          comm_Bz_claim, comm_prod_Az_Bz_claims)

        transcript.append_point(b"comm_Az_claim", comm_Az_claim)
        transcript.append_point(b"comm_Bz_claim", comm_Bz_claim)
        transcript.append_point(b"comm_Cz_claim", comm_Cz_claim)
        transcript.append_point(b"comm_prod_Az_Bz_claims",
                                comm_prod_Az_Bz_claims)

        rx_rev = rx_all[:nrx]
        rq_rev = rx_all[nrx:nrx + nrq]
        rp_round1 = rx_all[nrx + nrq:]
        rx = list(reversed(rx_rev))
        rq = list(reversed(rq_rev))

        taus_bound_rx = (_eq_prod(rp_round1, tau_p) *
                         _eq_prod(rq_rev, tau_q) * _eq_prod(rx_rev, tau_x))
        expected_claim_post_phase1 = (
            (RistrettoPoint.decompress(comm_prod_Az_Bz_claims) -
             RistrettoPoint.decompress(comm_Cz_claim)) * taus_bound_rx
        ).compress()
        self.proof_eq_sc_phase1.verify(
            gens.gens_sc.gens_1, transcript, expected_claim_post_phase1,
            comm_claim_post_phase1)

        r_A = transcript.challenge_scalar(b"challenge_Az")
        r_B = transcript.challenge_scalar(b"challenge_Bz")
        r_C = transcript.challenge_scalar(b"challenge_Cz")
        comm_claim_phase2 = multiscalar_mul(
            [r_A, r_B, r_C],
            [RistrettoPoint.decompress(c) for c in
             (comm_Az_claim, comm_Bz_claim, comm_Cz_claim)]).compress()

        t_sc2 = Timer("verify_sc2")
        comm_claim_post_phase2, ry_all = self.sc_proof_phase2.verify(
            comm_claim_phase2, nry + nrw + nrp, 3, gens.gens_sc.gens_1,
            gens.gens_sc.gens_4, transcript)
        t_sc2.stop()

        ry_rev = ry_all[:nry]
        rw = ry_all[nry:nry + nrw]
        rp = ry_all[nry + nrw:]
        ry = list(reversed(ry_rev))

        p_rp_poly_bound_ry = _eq_prod(rp, rp_round1)

        ry_factors = [_ONE] * (nry + 1)
        for i in range(nry):
            ry_factors[i + 1] = ry_factors[i] * (_ONE - ry[i])

        timer_commit_opening = Timer("verify_sc_commitment_opening")
        comm_list, num_proofs_list, num_inputs_list, comm_Zr_list = \
            [], [], [], []
        for i, w in enumerate(witness_secs):
            for p in range(len(w.num_proofs)):
                comm_list.append(w.comm_w[p])
                num_proofs_list.append(w.num_proofs[p])
                num_inputs_list.append(w.num_inputs[p])
                comm_Zr_list.append(RistrettoPoint.decompress(
                    self.comm_vars_at_ry_list[i][p]))
        PolyEvalProof.verify_batched_instances_disjoint_rounds(
            self.proof_eval_vars_at_ry_list, num_proofs_list,
            num_inputs_list, gens.gens_pc, transcript, rq, ry, comm_Zr_list,
            comm_list, device)

        expected_comm_vars_list = []
        prefix_list = _prefix_list(rw, num_witness_secs)
        for p in range(num_instances):
            def c_of(i):
                pw = 0 if len(witness_secs[i].num_proofs) == 1 else p
                pt = RistrettoPoint.decompress(
                    self.comm_vars_at_ry_list[i][pw])
                if witness_secs[i].num_inputs[pw] >= max_num_inputs:
                    return pt
                ny_w = ceil_log2(witness_secs[i].num_inputs[pw])
                return pt * ry_factors[nry - ny_w]

            comb = c_of(0) * prefix_list[0]
            for i in range(1, num_witness_secs):
                comb = comb + c_of(i) * prefix_list[i]
            scale = _ONE
            for q in range(nrq - ceil_log2(num_proofs[p])):
                scale = scale * (_ONE - rq[q])
            expected_comm_vars_list.append(comb * scale)

        EQ_p = EqPolynomial(list(rp)).evals(device)[:num_instances]
        expected_comm_vars_at_ry = multiscalar_mul(
            EQ_p, expected_comm_vars_list).compress()
        if expected_comm_vars_at_ry != self.comm_vars_at_ry:
            raise ProofVerifyError("witness rp binding mismatch")
        timer_commit_opening.stop()

        comm_eval_Z_at_ry = RistrettoPoint.decompress(self.comm_vars_at_ry)
        eval_A_r, eval_B_r, eval_C_r = evals
        expected_claim_post_phase2 = (
            comm_eval_Z_at_ry *
            ((r_A * eval_A_r + r_B * eval_B_r + r_C * eval_C_r) *
             p_rp_poly_bound_ry)).compress()
        self.proof_eq_sc_phase2.verify(
            gens.gens_sc.gens_1, transcript, expected_claim_post_phase2,
            comm_claim_post_phase2)

        return [list(rp), list(rq_rev), rx, list(rw) + ry]
