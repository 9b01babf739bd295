"""R1CS satisfiability proof of the NIZK: one instance, one proof, two
witness sections.

Reference: src/r1csproof.rs:210 (prove), :687 (verify). The transcript
schedule is the JAX package's data-parallel R1CSProof with P = Q = 1 and
two witness sections (private vars, public io), byte for byte. With no
instance or proof variables, tau_p/tau_q/rp/rq are empty and the only
section variable is rw[0]:

  * z = [vars | io] and Az/Bz/Cz (K3 SpMV) are dense Montgomery tensors
    on the device, x and y bit-reversed;
  * both disjoint-rounds sumchecks run the host round loop over those
    tensors with the K4 round kernels (models/sumcheck.py);
  * the two sections' openings share one batched Hyrax opening.

The multi-instance, multi-proof prover is a later slice.
"""

from __future__ import annotations

import torch

from ..core.edwards import RistrettoPoint, multiscalar_mul
from ..core.field import Scalar
from ..ops import fq
from ..ops.sumcheck import rev_perm
from ..utils.errors import ProofVerifyError
from ..utils.timer import Timer
from .commitments import MultiCommitGens, commit_scalar
from .dense_mlpoly import (
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


def _abc_comb_dev(tabs, rabc, yperm):
    """RLC of the phase-2 ABC eval tables, then y bit-reversal.

    tabs: (3, W, Y, 16); rabc: (3, 16); yperm: (Y,) int64. Returns
    (W, Y, 16) (r1csproof.rs:430-465). The products and sums are K1; the
    permutation moves data."""
    comb = fq.mul(tabs[0], rabc[0])
    comb = fq.add(comb, fq.mul(tabs[1], rabc[1]))
    comb = fq.add(comb, fq.mul(tabs[2], rabc[2]))
    return comb.index_select(1, yperm)


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
    def prove(witness_polys, inst, gens, transcript, random_tape, device):
        """witness_polys: the two sections (vars, io) as DensePolynomials
        of num_vars entries each, on `device`. Returns the proof and the
        challenge vectors [rp, rq_rev, rx, rw + ry] (rp, rq_rev empty)."""
        dev = torch.device(device)
        timer_prove = Timer("R1CSProof::prove")
        transcript.append_protocol_name(R1CSProof.protocol_name())
        assert inst.get_num_instances() == 1 and len(witness_polys) == 2
        num_vars = len(witness_polys[0])
        assert len(witness_polys[1]) == num_vars
        num_cons = inst.get_num_cons()
        nrx = ceil_log2(num_cons)
        nry = ceil_log2(num_vars)
        one = EqPolynomial([]).evals_dev(dev)  # eq table of no variables

        # z in natural order: (P = 1, Q = 1, W = 2, Y, 16)
        z_nat = torch.stack([w.Zm for w in witness_polys])
        tau_x = transcript.challenge_vector(b"challenge_tau_x", nrx)

        timer = Timer("prove_vec_mult")
        poly_tau_x = EqPolynomial(tau_x).evals_dev(dev)
        poly_Az, poly_Bz, poly_Cz = inst.multiply_vec_block(
            1, [1], 1, [num_vars], num_vars, num_cons, [num_cons],
            z_nat[None, None])
        timer.stop(dev)

        # Sumcheck 1: eq(x) * (Az*Bz - Cz) == 0 ----------------------------
        timer_sc1 = Timer("prove_sc_phase_one")
        (sc_proof_phase1, rx_rev, claims_phase1, blind_claim_postsc1) = \
            ZKSumcheckInstanceProof.prove_cubic_with_additive_term_disjoint_rounds(
                _ZERO, _ZERO, nrx, nrx, 0, 0, one, one, poly_tau_x,
                poly_Az.Zm[:, :, 0], poly_Bz.Zm[:, :, 0],
                poly_Cz.Zm[:, :, 0],
                gens.gens_sc.gens_1, gens.gens_sc.gens_4,
                transcript, random_tape)
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
        rx = list(reversed(rx_rev))

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
            1, inst.get_inst_num_cons(), 2, num_vars, [num_vars], rx_tab)[0]
        yperm = torch.as_tensor(rev_perm(num_vars), device=dev)
        ABC_dense = _abc_comb_dev(
            torch.stack(tabs), scalars_to_mont([r_A, r_B, r_C], dev),
            yperm)[None]  # (1, W, Y, 16)
        timer.stop(dev)
        Z_dense = z_nat.index_select(1, yperm)[None]  # (1, W, Y, 16)

        (sc_proof_phase2, ry_all, claims_phase2_v, blind_claim_postsc2) = \
            ZKSumcheckInstanceProof.prove_cubic_disjoint_rounds(
                claim_phase2, blind_claim_phase2, nry + 1, nry, 1, 0, True,
                one, ABC_dense, Z_dense,
                gens.gens_sc.gens_1, gens.gens_sc.gens_4,
                transcript, random_tape)
        timer_sc2.stop(dev)
        rw = ry_all[nry:]
        ry = list(reversed(ry_all[:nry]))

        # POLY COMMIT: the two sections' openings (r1csproof.rs:515-645) ----
        timer_polyeval = Timer("polyeval")
        evals = [w.evaluate(ry) for w in witness_polys]
        comm_vars_at_ry_list = [
            [commit_scalar(ev, _ZERO, gens.gens_pc.gens.gens_1).compress()]
            for ev in evals]
        proof_eval_vars_at_ry_list = \
            PolyEvalProof.prove_batched_instances_disjoint_rounds(
                witness_polys, [1, 1], [num_vars, num_vars], None, [], ry,
                evals, None, gens.gens_pc, transcript, random_tape)
        # bind the two sections to rw[0]
        eval_vars_at_ry = (_ONE - rw[0]) * evals[0] + rw[0] * evals[1]
        timer_polyeval.stop(dev)
        comm_vars_at_ry = commit_scalar(
            eval_vars_at_ry, _ZERO, gens.gens_pc.gens.gens_1).compress()

        claim_post_phase2 = (claims_phase2_v[0] * claims_phase2_v[1] *
                             claims_phase2_v[2])
        proof_eq_sc_phase2, _c1, _c2 = EqualityProof.prove(
            gens.gens_pc.gens.gens_1, transcript, random_tape,
            claim_post_phase2, _ZERO, claim_post_phase2, blind_claim_postsc2)
        timer_prove.stop()

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
        return proof, [[], [], rx, list(rw) + ry]

    # ------------------------------------------------------------------
    def verify(self, num_vars: int, num_cons: int, comm_list, gens, evals,
               transcript, device):
        """comm_list: the two sections' PolyCommitments; evals: (eA, eB,
        eC) at (rx, ry) (r1csproof.rs:687-946). The eq tables of the
        openings are built on `device`."""
        transcript.append_protocol_name(R1CSProof.protocol_name())
        if len(self.comm_vars_at_ry_list) != 2 or \
                any(len(c) != 1 for c in self.comm_vars_at_ry_list):
            raise ProofVerifyError("expected one opening per witness section")
        nrx = ceil_log2(num_cons)
        nry = ceil_log2(num_vars)
        tau_x = transcript.challenge_vector(b"challenge_tau_x", nrx)

        claim_phase1 = commit_scalar(
            _ZERO, _ZERO, gens.gens_sc.gens_1).compress()
        t_sc1 = Timer("verify_sc1")
        comm_claim_post_phase1, rx_rev = self.sc_proof_phase1.verify(
            claim_phase1, nrx, 3, gens.gens_sc.gens_1,
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
        rx = list(reversed(rx_rev))

        expected_claim_post_phase1 = (
            (RistrettoPoint.decompress(comm_prod_Az_Bz_claims) -
             RistrettoPoint.decompress(comm_Cz_claim)) *
            _eq_prod(rx_rev, tau_x)).compress()
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
            comm_claim_phase2, nry + 1, 3, gens.gens_sc.gens_1,
            gens.gens_sc.gens_4, transcript)
        t_sc2.stop()
        rw = ry_all[nry:]
        ry = list(reversed(ry_all[:nry]))

        timer_commit_opening = Timer("verify_sc_commitment_opening")
        comm_Zr = [RistrettoPoint.decompress(c[0])
                   for c in self.comm_vars_at_ry_list]
        PolyEvalProof.verify_batched_instances_disjoint_rounds(
            self.proof_eval_vars_at_ry_list, [1, 1], [num_vars, num_vars],
            gens.gens_pc, transcript, [], ry, comm_Zr, comm_list, device)

        # the two sections bound to rw[0]
        expected_comm_vars_at_ry = (comm_Zr[0] * (_ONE - rw[0]) +
                                    comm_Zr[1] * rw[0]).compress()
        if expected_comm_vars_at_ry != self.comm_vars_at_ry:
            raise ProofVerifyError("witness rw binding mismatch")
        timer_commit_opening.stop()

        comm_eval_Z_at_ry = RistrettoPoint.decompress(self.comm_vars_at_ry)
        eval_A_r, eval_B_r, eval_C_r = evals
        expected_claim_post_phase2 = (
            comm_eval_Z_at_ry *
            (r_A * eval_A_r + r_B * eval_B_r + r_C * eval_C_r)).compress()
        self.proof_eq_sc_phase2.verify(
            gens.gens_sc.gens_1, transcript, expected_claim_post_phase2,
            comm_claim_post_phase2)

        return [[], [], rx, list(rw) + ry]
