"""ZK sumcheck provers/verifier (reference: src/sumcheck.rs).

`ZKSumcheckInstanceProof` (sumcheck.rs:75) carries one committed round
polynomial, a claim commitment and a dot-product proof per round; the
verifier (sumcheck.rs:94-186) never sees plaintext round polynomials. The
provers are the fork's disjoint-rounds variants that drive both R1CS
sumchecks (sumcheck.rs:788, :1067), and phase 1's q-size-classed form.
Each round's evaluations and table binds are one device call per table set
(ops/sumcheck.py: K4, or K5 per class, fused with the previous round's
bind). The rest of the round runs in one of two forms, with the same
bytes:

- device-resident rounds (`_rounds_dev`, the default for tables on the
  card, as the JAX package's default off its CPU backend): K11
  (ops/zk_round.py) runs each round's tail on the card after the round
  kernel, with the transcript on the card; the challenge goes straight to
  the next round's bind. One upload before a sumcheck, one download after
  it, no host sync in between;
- the host loop (`_rounds`, the default for CPU tables): the host holds
  the merlin transcript, the degree-3 UniPoly and the small Pedersen and
  sigma work, with one device-to-host copy of the evaluations per round.

The tables' device picks the form (`_device_rounds_on`).

Under a prover mesh (parallel/context.py) the tables of the first rounds'
axis (x in phase 1, y in phase 2) arrive as this rank's share, split by
the low bits of the index (`_split_x`): each round evaluates the share and
adds the ranks' evaluations exactly before the transcript, or K11, reads
them; when the live length reaches the number of ranks the last entries
are gathered and the remaining rounds run on every rank.

`SumcheckInstanceProof` (non-ZK, sumcheck.rs:28) carries SPARK's product
layer rounds; its prover is models/product_tree.py prove_cubic_batched.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.edwards import RistrettoPoint, multiscalar_mul
from ..core.field import Scalar
from ..ops import fq
from ..ops import ristretto_dev as rdev
from ..ops import sumcheck as sck
from ..ops import transcript_dev as tdev
from ..ops import zk_round as zkr
from ..ops.sumcheck import MODE_P, MODE_Q, MODE_W, MODE_X
from ..parallel import mesh as pmesh
from ..parallel.context import current_mesh
from ..utils.errors import ProofVerifyError
from .commitments import MultiCommitGens, commit_scalar
from .dense_mlpoly import mont_to_scalar, mont_to_scalars, scalars_to_mont
from .sigma import DotProductProof
from .unipoly import UniPoly

_ZERO = Scalar.zero()
_ONE = Scalar.one()


def _device_rounds_on(device) -> bool:
    """Device-resident rounds for tables on the card, the host loop for
    CPU tables (the JAX package: device rounds off its CPU backend)."""
    return torch.device(device).type == "cuda"


def _x_split(global_len: int, local_len: int):
    """(mesh, d): the active mesh and the d ranks the first rounds' axis
    is split over, or (None, 1) when the tables are whole on every rank
    (no mesh, or an axis that shard_big left whole)."""
    mesh = current_mesh()
    if mesh is None:
        return None, 1
    d = global_len // local_len
    if d == mesh.size:
        return mesh, d
    if d == 1:
        return None, 1
    raise ValueError(f"tables split {d} ways on a mesh of {mesh.size}")


def _split_x(mesh, d: int, first, step, settle, gather):
    """first/step of a prover whose x tables hold this rank's share: rank
    k of d holds entries k, k + d, ... of the axis (parallel/context.py
    shard_big). The x rounds come first and bind the top bit first, so
    while the round's n_half is at least d, entry i and entry i + n_half
    lie on one rank: the round runs on the share with n_half / d and the
    ranks' evaluations are added exactly (parallel/mesh.py sum_partials).
    At the first round with n_half < d, settle(r, n_half, mode) binds the
    previous round on the share, gather() collects the one live entry of
    every rank (rank k's at index k), and the rounds from there on run on
    the whole tables on every rank. The number of split rounds of the
    sumcheck is mesh.split_rounds[-1] from its first split round on."""
    split = [0]  # rounds run split so far; None once gathered

    def count():
        if split[0] == 0:
            mesh.split_rounds.append(0)
        split[0] += 1
        mesh.split_rounds[-1] = split[0]

    def first_s(n_half, mode):
        if split[0] is not None:
            if mode == MODE_X and n_half >= d:
                count()
                return pmesh.sum_partials(mesh, first(n_half // d, mode))
            split[0] = None
            gather()
        return first(n_half, mode)

    def step_s(rm_p, nh_p, mode_p, n_half, mode):
        if split[0] is not None:
            if mode == MODE_X and n_half >= d:
                count()
                return pmesh.sum_partials(
                    mesh, step(rm_p, nh_p // d, mode_p, n_half // d, mode))
            split[0] = None
            settle(rm_p, nh_p // d, mode_p)
            gather()
            return first(n_half, mode)
        return step(rm_p, nh_p, mode_p, n_half, mode)

    return first_s, step_s


def _scan_prep(num_rounds: int, blinds_poly, blinds_evals, blind_claim,
               random_tape) -> np.ndarray:
    """The rounds' tape values as (num_rounds, 11, 16) int32 (the layout of
    ops/zk_round.py; delta's two rows are left zero for the card to fill).
    Each round's d_vec, r_delta and r_beta are drawn in the order the host
    loop's DotProductProofs draw them, which keeps the bytes equal."""
    rows = []
    for j in range(num_rounds):
        dv = random_tape.random_vector(b"d_vec", 4)
        rd = random_tape.random_scalar(b"r_delta")
        rb = random_tape.random_scalar(b"r_beta")
        blind_sc = blind_claim if j == 0 else blinds_evals[j - 1]
        rows += [blinds_poly[j], blinds_evals[j], blind_sc, *dv, rd, rb, 0, 0]
    return fq.encode(rows).reshape(num_rounds, zkr.TAPE_ROWS, 16)


def _queue_rounds(modes, live, first, step, st, carry, tape, out, tab_n,
                  tab_1):
    """Queue every round: the round kernel, then the tail (K11), which
    writes r into out[j], the row the next round's bind reads. Nothing
    here waits for the card. Returns the last round's pending bind."""
    pending = None
    for j, mode in enumerate(modes):
        n_half = live[mode] // 2
        evd = first(n_half, mode) if pending is None else \
            step(*pending, n_half, mode)
        zkr.zk_round_tail(evd, st, carry, tape[j], out[j], tab_n, tab_1)
        pending = (out[j, zkr.OUT_R], n_half, mode)
        live[mode] //= 2
    return pending


def _scan_finish(transcript, host: np.ndarray, num_rounds: int):
    """Decode the one download of a device-round sumcheck (transcript
    state, the rounds' messages, the deltas) into the proof and the
    challenges, and resync the host transcript to the card's state."""
    tdev.set_host_state(transcript, host[:tdev.STATE_LEN])
    n_out = num_rounds * zkr.OUT_ROWS * 16
    out = host[tdev.STATE_LEN:tdev.STATE_LEN + n_out].reshape(
        num_rounds, zkr.OUT_ROWS, 16)
    deltas = host[tdev.STATE_LEN + n_out:].reshape(num_rounds, 32)

    def encodings(rows):
        return [bytes(e.astype(np.uint8)) for e in rows.reshape(-1, 32)]

    z = mont_to_scalars(out[:, 6:10])
    z_delta = mont_to_scalars(out[:, 10])
    z_beta = mont_to_scalars(out[:, 11])
    betas = encodings(out[:, 4:6])
    proofs = [DotProductProof(d, b, z[4 * j:4 * j + 4], z_delta[j],
                              z_beta[j])
              for j, (d, b) in enumerate(zip(encodings(deltas), betas))]
    proof = ZKSumcheckInstanceProof(encodings(out[:, 0:2]),
                                    encodings(out[:, 2:4]), proofs)
    return proof, mont_to_scalars(out[:, zkr.OUT_R])


class SumcheckInstanceProof:
    """Non-ZK sumcheck: plaintext compressed round polys (sumcheck.rs:28)."""

    __slots__ = ("compressed_polys",)

    def __init__(self, compressed_polys):
        self.compressed_polys = compressed_polys

    def verify(self, claim: Scalar, num_rounds: int, degree_bound: int,
               transcript):
        e = claim
        r = []
        if len(self.compressed_polys) != num_rounds:
            raise ProofVerifyError("sumcheck round count")
        for cp in self.compressed_polys:
            poly = cp.decompress(e)
            if poly.degree() != degree_bound:
                raise ProofVerifyError("sumcheck degree bound")
            if not (poly.eval_at_zero() + poly.eval_at_one() == e):
                raise ProofVerifyError("sumcheck round claim")
            poly.append_to_transcript(b"poly", transcript)
            r_i = transcript.challenge_scalar(b"challenge_nextround")
            r.append(r_i)
            e = poly.evaluate(r_i)
        return e, r


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
                gens_1, gens_n, transcript, random_tape, device):
        """The round loop shared by the provers. modes[j] is round j's
        axis; first(n_half, mode) and step(rm_prev, n_half_prev, mode_prev,
        n_half, mode) return the round's evaluations as (..., 3, 16): one
        (e0, e2, e3) per part (a q-size class), summed over the parts.
        Returns the proof, the challenges, the last round's pending bind
        and the final claim blind. The device-resident form when
        `_device_rounds_on(device)`, else the host loop."""
        if _device_rounds_on(device):
            return ZKSumcheckInstanceProof._rounds_dev(
                claim, blind_claim, num_rounds, modes, live, first, step,
                gens_1, gens_n, transcript, random_tape, device)
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
            ev = mont_to_scalars(evd)
            e0, e2, e3 = (sum(ev[k::3], _ZERO) for k in range(3))
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

    @staticmethod
    def _rounds_dev(claim, blind_claim, num_rounds, modes, live, first, step,
                    gens_1, gens_n, transcript, random_tape, device):
        """The device-resident rounds (ops/zk_round.py): the tape values,
        the transcript state and the claim go up in one copy; the deltas
        and the claim's commitment are committed on the card (K10, K9);
        every round is queued with no host sync (`_queue_rounds`); the
        messages, deltas and transcript state come back in one copy."""
        blinds_poly = random_tape.random_vector(b"blinds_poly", num_rounds)
        blinds_evals = random_tape.random_vector(b"blinds_evals", num_rounds)
        tape_np = _scan_prep(num_rounds, blinds_poly, blinds_evals,
                             blind_claim, random_tape)
        buf = torch.from_numpy(np.concatenate([
            tdev.host_state(transcript),
            fq.encode([claim, blind_claim]).ravel(),
            tape_np.ravel()])).to(device)
        st = buf[:tdev.STATE_LEN]
        claim_blind = buf[tdev.STATE_LEN:tdev.STATE_LEN + 32].view(1, 2, 16)
        tape = buf[tdev.STATE_LEN + 32:].view(num_rounds, zkr.TAPE_ROWS, 16)
        tab_n, tab_1 = gens_n.comb_tables(device), gens_1.comb_tables(device)
        carry = torch.empty((3, 16), dtype=torch.int32, device=device)
        carry[0] = claim_blind[0, 0]
        carry[1:] = rdev.compress(rdev.comb_commit(tab_1, claim_blind)) \
            .view(2, 16)
        tape[:, 9:11] = rdev.compress(rdev.comb_commit(
            tab_n, tape[:, 3:8])).view(num_rounds, 2, 16)
        out = torch.empty((num_rounds, zkr.OUT_ROWS, 16), dtype=torch.int32,
                          device=device)
        pending = _queue_rounds(modes, live, first, step, st, carry, tape,
                                out, tab_n, tab_1)
        host = torch.cat([st, out.flatten(),
                          tape[:, 9:11].flatten()]).cpu().numpy()
        proof, r = _scan_finish(transcript, host, num_rounds)
        return proof, r, pending, blinds_evals[num_rounds - 1]

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
        mesh, d = _x_split(1 << num_rounds_x_max, int(tx.shape[0]))
        live = {MODE_P: int(tp.shape[0]), MODE_Q: int(tq.shape[0]),
                MODE_X: int(tx.shape[0]) * d}
        tabs = [tp, tq, tx, B, C, D]

        def first(n_half, mode):
            return sck.p1_evals(*tabs, n_half, mode=mode)

        def step(rm_p, nh_p, mode_p, n_half, mode):
            evd, new = sck.p1_step(*tabs, rm_p, nh_p, n_half,
                                   mode_prev=mode_p, mode=mode)
            tabs[:] = new
            return evd

        def settle(rm_p, nh_p, mode_p):
            tabs[:] = sck.p1_bind(*tabs, rm_p, nh_p, mode=mode_p,
                                  out_len=nh_p)

        def gather():
            tabs[2:] = pmesh.gather_axis(
                mesh, [(tabs[2], 0)] + [(t, 2) for t in tabs[3:]])

        if mesh is not None:
            first, step = _split_x(mesh, d, first, step, settle, gather)

        proof, r, pending, blind_last = ZKSumcheckInstanceProof._rounds(
            claim, blind_claim, num_rounds, modes, live, first, step,
            gens_1, gens_n, transcript, random_tape, B.device)
        if pending is not None:  # final bind for the last round
            rm_p, nh_p, mode_p = pending
            tabs[:] = sck.p1_bind(*tabs, rm_p, nh_p, mode=mode_p,
                                  out_len=nh_p)
        tp, tq, tx, B, C, D = tabs
        tpv, tqv, txv = (mont_to_scalar(t[0]) for t in (tp, tq, tx))
        claims = [
            tpv * tqv * txv,
            mont_to_scalar(B[0, 0, 0]),
            mont_to_scalar(C[0, 0, 0]),
            mont_to_scalar(D[0, 0, 0]),
        ]
        return proof, r, claims, blind_last

    # --- phase-1 prover, q-size classed (O(sum Q_p) tables) ----------------
    @staticmethod
    def prove_phase1_classed(
            claim: Scalar, blind_claim: Scalar, num_rounds: int,
            num_rounds_x_max: int, num_rounds_q_max: int, num_rounds_p: int,
            tp, tq, tx, classes, gens_1: MultiCommitGens,
            gens_n: MultiCommitGens, transcript, random_tape):
        """Transcript-identical to the dense phase-1 prover, but Az/Bz/Cz
        live as one table per q-size class, so the prover holds
        O(sum_p Q_p X) entries like the reference's ragged Pqx storage
        (custom_dense_mlpoly.rs:16-32), not O(P Q_max X).

        classes: list of (p0, B_c, C_c, D_c) with B_c (P_c, Q_c, X, 16), q
        bit-reversed within the class, instances sorted by decreasing Q_c
        so that the classes cover the p axis contiguously from p0. The
        shared eq tables fold once per round (eq_fold) before the class
        kernel (K5, one launch a round for every class, each class's bind
        fused in) reads them; the p rounds run K4 on the classes merged
        to one entry per instance. Which classes are active in a round is
        decided on the host from the round's n_half alone, so the rounds
        run in either form of `_rounds`: on the card every round, x, q and
        p, is device-resident (K11 after the class kernels, the classes'
        evaluations summed inside K11)."""
        assert num_rounds == num_rounds_x_max + num_rounds_q_max + \
            num_rounds_p
        modes = ([MODE_X] * num_rounds_x_max + [MODE_Q] * num_rounds_q_max
                 + [MODE_P] * num_rounds_p)
        q_max = int(tq.shape[0])
        mesh, d = _x_split(1 << num_rounds_x_max, int(tx.shape[0]))
        live = {MODE_P: int(tp.shape[0]), MODE_Q: q_max,
                MODE_X: int(tx.shape[0]) * d}
        eq = {MODE_P: tp, MODE_Q: tq, MODE_X: tx}
        cls = [{"p0": p0, "S": q_max // int(B.shape[1]), "T": (B, C, D),
                "nh": None, "active": None} for (p0, B, C, D) in classes]
        merged = []  # (B, C, D) with one entry per instance, p padded

        def tables():
            return eq[MODE_P], eq[MODE_Q], eq[MODE_X]

        def class_round(n_half, mode, prev):
            """Every class's round (K5, one launch): with prev = (r,
            mode_prev) each class's previous-round bind first."""
            if prev is not None:
                prev = (*prev, [c["nh"] for c in cls],
                        [c["active"] for c in cls])
            evs, tabs, nhs, acts = sck.pc_round(
                *tables(), [c["T"] for c in cls], [c["p0"] for c in cls],
                [c["S"] for c in cls], n_half, mode, prev)
            for c, T, nh, active in zip(cls, tabs, nhs, acts):
                c["T"], c["nh"], c["active"] = T, nh, active
            return evs

        def merge(rm, mode_prev):
            """The classes' last bind, then one entry per instance."""
            parts = []
            for c in cls:
                B, C, D = c["T"]
                if rm is not None:
                    B, C, D = sck.pc_bind(B, C, D, rm, c["nh"], mode_prev,
                                          c["active"])
                parts.append(torch.stack([t[:, :1, :1] for t in (B, C, D)]))
            cat = torch.cat(parts, 1)  # (3, P_real, 1, 1, 16)
            pad = live[MODE_P] - cat.shape[1]
            if pad > 0:
                cat = torch.cat([cat, cat.new_zeros(
                    (3, pad) + cat.shape[2:])], 1)
            merged[:] = [t.contiguous() for t in cat]
            eq[MODE_Q], eq[MODE_X] = eq[MODE_Q][:1], eq[MODE_X][:1]

        def first(n_half, mode):
            if mode != MODE_P:
                return class_round(n_half, mode, None)
            merge(None, None)
            return sck.p1_evals(*tables(), *merged, n_half, MODE_P)

        def step(rm_p, nh_p, mode_p, n_half, mode):
            if mode_p != MODE_P:
                eq[mode_p] = sck.eq_fold(eq[mode_p], rm_p, nh_p)
            if mode != MODE_P:
                return class_round(n_half, mode, (rm_p, mode_p))
            if not merged:
                merge(rm_p, mode_p)
                return sck.p1_evals(*tables(), *merged, n_half, MODE_P)
            evd, tabs = sck.p1_step(*tables(), *merged, rm_p, nh_p, n_half,
                                    mode_prev=MODE_P, mode=MODE_P)
            eq[MODE_P], eq[MODE_Q], eq[MODE_X] = tabs[:3]
            merged[:] = tabs[3:]
            return evd

        def settle(rm_p, nh_p, mode_p):
            eq[mode_p] = sck.eq_fold(eq[mode_p], rm_p, nh_p)
            for c in cls:
                c["T"] = sck.pc_bind(*c["T"], rm_p, c["nh"], mode_p,
                                     c["active"])

        def gather():
            items = [(eq[MODE_X], 0)] + [(t, 2) for c in cls for t in c["T"]]
            out = pmesh.gather_axis(mesh, items)
            eq[MODE_X] = out[0]
            for i, c in enumerate(cls):
                c["T"] = tuple(out[1 + 3 * i:4 + 3 * i])

        if mesh is not None:
            first, step = _split_x(mesh, d, first, step, settle, gather)

        proof, r, pending, blind_last = ZKSumcheckInstanceProof._rounds(
            claim, blind_claim, num_rounds, modes, live, first, step,
            gens_1, gens_n, transcript, random_tape, tp.device)
        if pending is None:
            merge(None, None)
        elif pending[2] == MODE_P:  # final bind for the last round
            tabs = sck.p1_bind(*tables(), *merged, pending[0], pending[1],
                               mode=MODE_P, out_len=pending[1])
            eq[MODE_P], eq[MODE_Q], eq[MODE_X] = tabs[:3]
            merged[:] = tabs[3:]
        else:
            rm_p, nh_p, mode_p = pending
            eq[mode_p] = sck.eq_fold(eq[mode_p], rm_p, nh_p)
            merge(rm_p, mode_p)
        tpv, tqv, txv = (mont_to_scalar(t[0]) for t in tables())
        claims = [tpv * tqv * txv] + [mont_to_scalar(t[0, 0, 0])
                                      for t in merged]
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
        mesh, d = _x_split(1 << num_rounds_y_max, int(Z.shape[2]))
        live = {MODE_P: int(Z.shape[0]), MODE_W: int(Z.shape[1]),
                MODE_X: int(Z.shape[2]) * d}
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

        def settle(rm_p, nh_p, mode_p):
            tabs[:] = sck.p2_bind(*tabs, rm_p, nh_p, mode=mode_p,
                                  single_inst=single_inst, out_len=nh_p)

        def gather():
            tabs[1:] = pmesh.gather_axis(mesh, [(tabs[1], 2), (tabs[2], 2)])

        if mesh is not None:
            first, step = _split_x(mesh, d, first, step, settle, gather)

        proof, r, pending, blind_last = ZKSumcheckInstanceProof._rounds(
            claim, blind_claim, num_rounds, modes, live, first, step,
            gens_1, gens_n, transcript, random_tape, Z.device)
        if pending is not None:  # final bind for the last round
            rm_p, nh_p, mode_p = pending
            tabs[:] = sck.p2_bind(*tabs, rm_p, nh_p, mode=mode_p,
                                  single_inst=single_inst, out_len=nh_p)
        ep, ABC, Z = tabs
        claims = [
            mont_to_scalar(ep[0]),
            mont_to_scalar(ABC[0, 0, 0]),
            mont_to_scalar(Z[0, 0, 0]),
        ]
        return proof, r, claims, blind_last
