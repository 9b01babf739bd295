"""ZK sumcheck provers/verifier (reference: src/sumcheck.rs).

`ZKSumcheckInstanceProof` (sumcheck.rs:75) carries one committed round
polynomial, a claim commitment and a dot-product proof per round; the
verifier (sumcheck.rs:94-186) never sees plaintext round polynomials. The
two provers are the fork's disjoint-rounds variants that drive both R1CS
sumchecks (sumcheck.rs:788, :1067), run as the JAX package's host loop:
each round's evaluations and table binds are one device call
(ops/sumcheck.py, K4 fused with K1 binds), and the host holds the merlin
transcript, the degree-3 UniPoly and the small Pedersen/sigma work. One
device-to-host copy of three field elements per round.
"""

from __future__ import annotations

from ..core.edwards import RistrettoPoint, multiscalar_mul
from ..core.field import Scalar
from ..ops import sumcheck as sck
from ..ops.sumcheck import MODE_P, MODE_Q, MODE_W, MODE_X
from .commitments import MultiCommitGens, commit_scalar
from .dense_mlpoly import mont_to_scalar, mont_to_scalars, scalars_to_mont
from .sigma import DotProductProof
from .unipoly import UniPoly

_ZERO = Scalar.zero()
_ONE = Scalar.one()


class ZKSumcheckInstanceProof:
    __slots__ = ("comm_polys", "comm_evals", "proofs")

    def __init__(self, comm_polys, comm_evals, proofs):
        self.comm_polys = comm_polys
        self.comm_evals = comm_evals
        self.proofs = proofs

    # --- verifier (sumcheck.rs:94-186) ------------------------------------
    def verify(self, comm_claim: bytes, num_rounds: int, degree_bound: int,
               gens_1: MultiCommitGens, gens_n: MultiCommitGens, transcript):
        assert gens_n.n == degree_bound + 1
        assert len(self.comm_polys) == num_rounds
        assert len(self.comm_evals) == num_rounds

        r = []
        for i in range(num_rounds):
            comm_poly = self.comm_polys[i]
            transcript.append_point(b"comm_poly", comm_poly)
            r_i = transcript.challenge_scalar(b"challenge_nextround")

            comm_claim_per_round = comm_claim if i == 0 else \
                self.comm_evals[i - 1]
            comm_eval = self.comm_evals[i]
            transcript.append_point(b"comm_claim_per_round",
                                    comm_claim_per_round)
            transcript.append_point(b"comm_eval", comm_eval)
            w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)
            comm_target = multiscalar_mul(w, [
                RistrettoPoint.decompress(comm_claim_per_round),
                RistrettoPoint.decompress(comm_eval),
            ]).compress()

            a_sc = [_ONE] * (degree_bound + 1)
            a_sc[0] = a_sc[0] + _ONE
            a_eval = [_ONE]
            for _ in range(degree_bound):
                a_eval.append(a_eval[-1] * r_i)
            a = [w[0] * x + w[1] * y for x, y in zip(a_sc, a_eval)]

            self.proofs[i].verify(gens_1, gens_n, transcript, a,
                                  self.comm_polys[i], comm_target)
            r.append(r_i)
        return self.comm_evals[-1], r

    # --- shared per-round ZK tail (sumcheck.rs:973-1048, 1282-1361) -------
    @staticmethod
    def _zk_round_tail(poly: UniPoly, r_j: Scalar, j: int,
                       claim_per_round: Scalar, comm_claim_per_round: bytes,
                       blind_claim: Scalar, blinds_poly, blinds_evals,
                       gens_1, gens_n, transcript, random_tape):
        eval_ = poly.evaluate(r_j)
        comm_eval = commit_scalar(eval_, blinds_evals[j], gens_1).compress()
        transcript.append_point(b"comm_claim_per_round", comm_claim_per_round)
        transcript.append_point(b"comm_eval", comm_eval)
        w = transcript.challenge_vector(b"combine_two_claims_to_one", 2)
        target = w[0] * claim_per_round + w[1] * eval_
        blind_sc = blind_claim if j == 0 else blinds_evals[j - 1]
        blind = w[0] * blind_sc + w[1] * blinds_evals[j]

        deg = poly.degree()
        a_sc = [_ONE] * (deg + 1)
        a_sc[0] = a_sc[0] + _ONE
        a_eval = [_ONE]
        for _ in range(deg):
            a_eval.append(a_eval[-1] * r_j)
        a = [w[0] * x + w[1] * y for x, y in zip(a_sc, a_eval)]

        proof, _cx, _cy = DotProductProof.prove(
            gens_1, gens_n, transcript, random_tape, poly.as_vec(),
            blinds_poly[j], a, target, blind)
        return proof, eval_, comm_eval

    @staticmethod
    def _rounds(claim, blind_claim, num_rounds, modes, live, first, step,
                gens_1, gens_n, transcript, random_tape):
        """The host round loop shared by both phases. modes[j] is round j's
        axis; first(n_half, mode) and step(rm_prev, n_half_prev, mode_prev,
        n_half, mode) return the round's (3, 16) evaluations. Returns the
        proof, the challenges, the last round's pending bind and the final
        claim blind."""
        blinds_poly = random_tape.random_vector(b"blinds_poly", num_rounds)
        blinds_evals = random_tape.random_vector(b"blinds_evals", num_rounds)
        claim_per_round = claim
        comm_claim_per_round = commit_scalar(
            claim_per_round, blind_claim, gens_1).compress()
        r, comm_polys, comm_evals, proofs = [], [], [], []
        pending = None  # (r_mont, n_half, mode) of the previous round
        for j in range(num_rounds):
            mode = modes[j]
            n_half = live[mode] // 2
            if pending is None:
                evd = first(n_half, mode)
            else:
                evd = step(*pending, n_half, mode)
            e0, e2, e3 = mont_to_scalars(evd)
            poly = UniPoly.from_evals([e0, claim_per_round - e0, e2, e3])
            comm_poly = poly.commit(gens_n, blinds_poly[j]).compress()
            transcript.append_point(b"comm_poly", comm_poly)
            comm_polys.append(comm_poly)

            r_j = transcript.challenge_scalar(b"challenge_nextround")
            pending = (scalars_to_mont([r_j], evd.device)[0], n_half, mode)
            live[mode] //= 2

            proof, eval_, comm_eval = ZKSumcheckInstanceProof._zk_round_tail(
                poly, r_j, j, claim_per_round, comm_claim_per_round,
                blind_claim, blinds_poly, blinds_evals, gens_1, gens_n,
                transcript, random_tape)
            proofs.append(proof)
            claim_per_round = eval_
            comm_claim_per_round = comm_eval
            r.append(r_j)
            comm_evals.append(comm_eval)
        return (ZKSumcheckInstanceProof(comm_polys, comm_evals, proofs), r,
                pending, blinds_evals[num_rounds - 1])

    # --- phase-1 prover (sumcheck.rs:1067-1381) ----------------------------
    @staticmethod
    def prove_cubic_with_additive_term_disjoint_rounds(
            claim: Scalar, blind_claim: Scalar, num_rounds: int,
            num_rounds_x_max: int, num_rounds_q_max: int, num_rounds_p: int,
            tp, tq, tx, B, C, D, gens_1: MultiCommitGens,
            gens_n: MultiCommitGens, transcript, random_tape):
        """tp/tq/tx: (P,16)/(Q,16)/(X,16) eq tables; B,C,D: (P,Q,X,16)
        Az/Bz/Cz tensors (bit-reversed q,x). comb = eq * (B*C - D)."""
        assert num_rounds == num_rounds_x_max + num_rounds_q_max + num_rounds_p
        modes = ([MODE_X] * num_rounds_x_max + [MODE_Q] * num_rounds_q_max
                 + [MODE_P] * num_rounds_p)
        live = {MODE_P: int(tp.shape[0]), MODE_Q: int(tq.shape[0]),
                MODE_X: int(tx.shape[0])}
        tabs = [tp, tq, tx, B, C, D]

        def first(n_half, mode):
            return sck.p1_evals(*tabs, n_half, mode=mode)

        def step(rm_p, nh_p, mode_p, n_half, mode):
            evd, new = sck.p1_step(*tabs, rm_p, nh_p, n_half,
                                   mode_prev=mode_p, mode=mode)
            tabs[:] = new
            return evd

        proof, r, pending, blind_last = ZKSumcheckInstanceProof._rounds(
            claim, blind_claim, num_rounds, modes, live, first, step,
            gens_1, gens_n, transcript, random_tape)
        if pending is not None:  # final bind for the last round
            rm_p, nh_p, mode_p = pending
            tabs[:] = sck.p1_bind(*tabs, rm_p, nh_p, mode=mode_p)
        tp, tq, tx, B, C, D = tabs
        tpv, tqv, txv = (mont_to_scalar(t[0]) for t in (tp, tq, tx))
        claims = [
            tpv * tqv * txv,
            mont_to_scalar(B[0, 0, 0]),
            mont_to_scalar(C[0, 0, 0]),
            mont_to_scalar(D[0, 0, 0]),
        ]
        return proof, r, claims, blind_last

    # --- phase-2 prover (sumcheck.rs:788-1065) ------------------------------
    @staticmethod
    def prove_cubic_disjoint_rounds(
            claim: Scalar, blind_claim: Scalar, num_rounds: int,
            num_rounds_y_max: int, num_rounds_w: int, num_rounds_p: int,
            single_inst: bool, ep, ABC, Z, gens_1: MultiCommitGens,
            gens_n: MultiCommitGens, transcript, random_tape):
        """ep: (P,16) eq table; ABC: (P_B,W,Y,16) (P_B may be 1);
        Z: (P,W,Y,16). comb = A*B*C."""
        assert num_rounds == num_rounds_y_max + num_rounds_w + num_rounds_p
        modes = ([MODE_X] * num_rounds_y_max + [MODE_W] * num_rounds_w
                 + [MODE_P] * num_rounds_p)
        live = {MODE_P: int(Z.shape[0]), MODE_W: int(Z.shape[1]),
                MODE_X: int(Z.shape[2])}
        tabs = [ep, ABC, Z]

        def first(n_half, mode):
            return sck.p2_evals(*tabs, n_half, mode=mode,
                                single_inst=single_inst)

        def step(rm_p, nh_p, mode_p, n_half, mode):
            evd, new = sck.p2_step(*tabs, rm_p, nh_p, n_half,
                                   mode_prev=mode_p, mode=mode,
                                   single_inst=single_inst)
            tabs[:] = new
            return evd

        proof, r, pending, blind_last = ZKSumcheckInstanceProof._rounds(
            claim, blind_claim, num_rounds, modes, live, first, step,
            gens_1, gens_n, transcript, random_tape)
        if pending is not None:  # final bind for the last round
            rm_p, nh_p, mode_p = pending
            tabs[:] = sck.p2_bind(*tabs, rm_p, nh_p, mode=mode_p,
                                  single_inst=single_inst)
        ep, ABC, Z = tabs
        claims = [
            mont_to_scalar(ep[0]),
            mont_to_scalar(ABC[0, 0, 0]),
            mont_to_scalar(Z[0, 0, 0]),
        ]
        return proof, r, claims, blind_last
