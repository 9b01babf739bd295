"""Grand-product circuits and the batched layered sumcheck proof.

Reference: src/product_tree.rs (ProductCircuit:12, DotProductCircuit:67,
ProductCircuitEvalProofBatched:260,386) and the non-ZK batched cubic
sumcheck it drives (src/sumcheck.rs:264 prove_cubic_batched); the JAX
package's models/product_tree.py, byte for byte.

A layer of a product tree is one field product of two half tables; trees
built together (`ProductCircuit.batch`) grow every layer of the stack in
one K6 launch. The batched layer sumcheck stacks the circuits of a layer
into (B, n, 16) tensors, so that each round is one K6 launch for all
product circuits (C, the eq table, shared) and one for the dot-product
circuits (C per circuit), followed by K1 folds (ops/product.py). The host
holds the transcript and one (B, 3) copy of the round's evaluations.
"""

from __future__ import annotations

import torch

from ..core.field import Scalar
from ..ops import fq
from ..ops import product as pk
from ..utils.errors import ProofVerifyError
from .dense_mlpoly import (
    DensePolynomial,
    EqPolynomial,
    log2,
    mont_to_scalar,
    mont_to_scalars,
    scalars_to_mont,
)
from .sumcheck import SumcheckInstanceProof
from .unipoly import UniPoly

_ZERO = Scalar.zero()
_ONE = Scalar.one()


class ProductCircuit:
    """Binary product tree; layer k holds 2^(L-k) values as (left, right)
    halves (product_tree.rs:12-63)."""

    __slots__ = ("left_vec", "right_vec")

    def __init__(self, poly: DensePolynomial):
        c = ProductCircuit.batch(poly.Zm[None])[0]
        self.left_vec, self.right_vec = c.left_vec, c.right_vec

    @staticmethod
    def batch(leaves: torch.Tensor) -> list:
        """B trees over the rows of a (B, n, 16) tensor, every layer of the
        stack in one launch; each circuit's layers are views of the
        stacked ones."""
        n = leaves.shape[1]
        left, right = leaves[:, :n // 2], leaves[:, n // 2:]
        lefts, rights = [left], [right]
        for _ in range(log2(n) - 1):
            left, right = pk.layer_mul(left, right)
            lefts.append(left)
            rights.append(right)
        out = []
        for b in range(leaves.shape[0]):
            c = object.__new__(ProductCircuit)
            c.left_vec = [t[b] for t in lefts]
            c.right_vec = [t[b] for t in rights]
            out.append(c)
        return out

    def num_layers(self) -> int:
        return len(self.left_vec)

    def evaluate(self) -> Scalar:
        top = fq.mul(self.left_vec[-1], self.right_vec[-1])
        return mont_to_scalar(top[0])


class DotProductCircuit:
    """sum_i left_i right_i weight_i (product_tree.rs:67-110)."""

    __slots__ = ("left", "right", "weight")

    def __init__(self, left, right, weight):
        # (n, 16) Montgomery tensors on one device
        assert left.shape == right.shape == weight.shape
        self.left, self.right, self.weight = left, right, weight

    def evaluate(self) -> Scalar:
        return mont_to_scalar(fq.sum_reduce(
            fq.mul(fq.mul(self.left, self.right), self.weight), 0))

    def split(self):
        h = self.left.shape[0] // 2
        return (
            DotProductCircuit(self.left[:h], self.right[:h], self.weight[:h]),
            DotProductCircuit(self.left[h:], self.right[h:], self.weight[h:]),
        )


def prove_cubic_batched(claim, num_rounds, A_par, B_par, C_par, A_seq,
                        B_seq, C_seq, coeffs, transcript):
    """Non-ZK batched cubic sumcheck (sumcheck.rs:264-434).

    A_par/B_par: (B, n, 16) stacked circuit-layer tensors sharing C_par
    (n, 16); A_seq/B_seq/C_seq: (S, n, 16) stacked dot-product tensors (or
    None). Returns (proof, r, claims_prod, claims_dotp)."""
    e = claim
    r = []
    cubic_polys = []
    have_seq = A_seq is not None and A_seq.shape[0] > 0
    for _ in range(num_rounds):
        evs = pk.cubic_evals(A_par, B_par, C_par)
        if have_seq:
            evs = torch.cat([evs, pk.cubic_evals(A_seq, B_seq, C_seq)])
        evs = mont_to_scalars(evs)
        c0 = c2 = c3 = _ZERO
        for i, co in enumerate(coeffs):
            c0 = c0 + evs[3 * i] * co
            c2 = c2 + evs[3 * i + 1] * co
            c3 = c3 + evs[3 * i + 2] * co
        poly = UniPoly.from_evals([c0, e - c0, c2, c3])
        poly.append_to_transcript(b"poly", transcript)
        r_j = transcript.challenge_scalar(b"challenge_nextround")
        r.append(r_j)
        rm = scalars_to_mont([r_j], A_par.device)[0]
        A_par, B_par, C_par = (pk.fold(t, rm) for t in (A_par, B_par, C_par))
        if have_seq:
            A_seq, B_seq, C_seq = (pk.fold(t, rm)
                                   for t in (A_seq, B_seq, C_seq))
        e = poly.evaluate(r_j)
        cubic_polys.append(poly.compress())

    claims_prod = (mont_to_scalars(A_par[:, 0]), mont_to_scalars(B_par[:, 0]),
                   mont_to_scalar(C_par[0]))
    if have_seq:
        claims_dotp = tuple(mont_to_scalars(t[:, 0])
                            for t in (A_seq, B_seq, C_seq))
    else:
        claims_dotp = ([], [], [])
    return SumcheckInstanceProof(cubic_polys), r, claims_prod, claims_dotp


class LayerProofBatched:
    __slots__ = ("proof", "claims_prod_left", "claims_prod_right")

    def __init__(self, proof, claims_prod_left, claims_prod_right):
        self.proof = proof
        self.claims_prod_left = claims_prod_left
        self.claims_prod_right = claims_prod_right

    def verify(self, claim, num_rounds, degree_bound, transcript):
        return self.proof.verify(claim, num_rounds, degree_bound, transcript)


class ProductCircuitEvalProofBatched:
    """Layered GKR-style batched product/dot-product argument
    (product_tree.rs:260-487)."""

    __slots__ = ("proof", "claims_dotp")

    def __init__(self, proof, claims_dotp):
        self.proof = proof
        self.claims_dotp = claims_dotp

    @staticmethod
    def prove(prod_circuits, dotp_circuits, transcript):
        assert prod_circuits
        dev = prod_circuits[0].left_vec[0].device
        claims_dotp_final = ([], [], [])
        proof_layers = []
        num_layers = prod_circuits[0].num_layers()
        claims_to_verify = [c.evaluate() for c in prod_circuits]
        rand = []
        for layer_id in range(num_layers - 1, -1, -1):
            # stacked layer tensors (each circuit's left/right at this layer)
            A_par = torch.stack([c.left_vec[layer_id] for c in prod_circuits])
            B_par = torch.stack([c.right_vec[layer_id]
                                 for c in prod_circuits])
            C_par = EqPolynomial(rand).evals_dev(dev)
            assert C_par.shape[0] == A_par.shape[1]
            num_rounds_prod = log2(C_par.shape[0])

            A_seq = B_seq = C_seq = None
            if layer_id == 0 and dotp_circuits:
                claims_to_verify = claims_to_verify + [
                    d.evaluate() for d in dotp_circuits]
                A_seq = torch.stack([d.left for d in dotp_circuits])
                B_seq = torch.stack([d.right for d in dotp_circuits])
                C_seq = torch.stack([d.weight for d in dotp_circuits])

            coeffs = transcript.challenge_vector(
                b"rand_coeffs_next_layer", len(claims_to_verify))
            claim = _ZERO
            for c, co in zip(claims_to_verify, coeffs):
                claim = claim + c * co

            proof, rand_prod, claims_prod, claims_dotp = prove_cubic_batched(
                claim, num_rounds_prod, A_par, B_par, C_par, A_seq, B_seq,
                C_seq, coeffs, transcript)

            claims_prod_left, claims_prod_right, _claims_eq = claims_prod
            for i in range(len(prod_circuits)):
                transcript.append_scalar(b"claim_prod_left",
                                         claims_prod_left[i])
                transcript.append_scalar(b"claim_prod_right",
                                         claims_prod_right[i])

            if layer_id == 0 and dotp_circuits:
                dl, dr, dw = claims_dotp
                for i in range(len(dotp_circuits)):
                    transcript.append_scalar(b"claim_dotp_left", dl[i])
                    transcript.append_scalar(b"claim_dotp_right", dr[i])
                    transcript.append_scalar(b"claim_dotp_weight", dw[i])
                claims_dotp_final = claims_dotp

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                claims_prod_left[i] + r_layer *
                (claims_prod_right[i] - claims_prod_left[i])
                for i in range(len(prod_circuits))
            ]
            rand = [r_layer] + rand_prod
            proof_layers.append(LayerProofBatched(
                proof, claims_prod_left, claims_prod_right))

        return (ProductCircuitEvalProofBatched(proof_layers,
                                               claims_dotp_final), rand)

    def verify(self, claims_prod_vec, claims_dotp_vec, length, transcript):
        num_layers = log2(length)
        rand = []
        if len(self.proof) != num_layers:
            raise ProofVerifyError("product proof layer count")
        claims_to_verify = list(claims_prod_vec)
        claims_to_verify_dotp = []
        for i in range(num_layers):
            if i == num_layers - 1:
                claims_to_verify = claims_to_verify + list(claims_dotp_vec)
            coeffs = transcript.challenge_vector(
                b"rand_coeffs_next_layer", len(claims_to_verify))
            claim = _ZERO
            for c, co in zip(claims_to_verify, coeffs):
                claim = claim + c * co
            claim_last, rand_prod = self.proof[i].verify(
                claim, i, 3, transcript)

            cl = self.proof[i].claims_prod_left
            cr = self.proof[i].claims_prod_right
            if not len(cl) == len(cr) == len(claims_prod_vec):
                raise ProofVerifyError("product layer claim count")
            for k in range(len(claims_prod_vec)):
                transcript.append_scalar(b"claim_prod_left", cl[k])
                transcript.append_scalar(b"claim_prod_right", cr[k])

            assert len(rand) == len(rand_prod)
            eq = _ONE
            for a, b in zip(rand, rand_prod):
                eq = eq * (a * b + (_ONE - a) * (_ONE - b))
            claim_expected = _ZERO
            for k in range(len(claims_prod_vec)):
                claim_expected = claim_expected + \
                    coeffs[k] * (cl[k] * cr[k] * eq)

            if i == num_layers - 1:
                npi = len(claims_prod_vec)
                dl, dr, dw = self.claims_dotp
                if not len(dl) == len(dr) == len(dw) == len(claims_dotp_vec):
                    raise ProofVerifyError("dot-product claim count")
                for k in range(len(dl)):
                    transcript.append_scalar(b"claim_dotp_left", dl[k])
                    transcript.append_scalar(b"claim_dotp_right", dr[k])
                    transcript.append_scalar(b"claim_dotp_weight", dw[k])
                    claim_expected = claim_expected + \
                        coeffs[k + npi] * dl[k] * dr[k] * dw[k]

            if not (claim_expected == claim_last):
                raise ProofVerifyError("product layer claim mismatch")

            r_layer = transcript.challenge_scalar(b"challenge_r_layer")
            claims_to_verify = [
                cl[k] + r_layer * (cr[k] - cl[k])
                for k in range(len(cl))
            ]
            if i == num_layers - 1:
                dl, dr, dw = self.claims_dotp
                for k in range(len(claims_dotp_vec) // 2):
                    claims_to_verify_dotp.append(
                        dl[2 * k] + r_layer * (dl[2 * k + 1] - dl[2 * k]))
                    claims_to_verify_dotp.append(
                        dr[2 * k] + r_layer * (dr[2 * k + 1] - dr[2 * k]))
                    claims_to_verify_dotp.append(
                        dw[2 * k] + r_layer * (dw[2 * k + 1] - dw[2 * k]))
            rand = [r_layer] + rand_prod
        return claims_to_verify, claims_to_verify_dotp, rand
