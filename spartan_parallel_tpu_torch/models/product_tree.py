"""Grand-product circuits and the batched layered sumcheck proof.

Reference: src/product_tree.rs (ProductCircuit:12, DotProductCircuit:67,
ProductCircuitEvalProofBatched:260,386) and the non-ZK batched cubic
sumcheck it drives (src/sumcheck.rs:264 prove_cubic_batched); the JAX
package's models/product_tree.py, byte for byte.

Trees built together (`ProductCircuit.batch`) share one stack: every layer
of every tree and the roots come from K6's tree kernel, a few layers a
launch, and each circuit's layers are views of the stacked ones, so its
evaluation is its root, read back once a stack. Dot-product circuits built
together (`DotProductCircuit.batch`) are evaluated once a stack. The
batched layer sumcheck reads the stacked layers in place when its circuits
are consecutive rows of one stack (else it stacks them); each round is one
K6 launch for all product and dot-product circuits (the bind of the
previous challenge, the evaluations and their sum weighted by the layer's
coefficients) and a layer's last bind one more (ops/product.py). The host
holds the transcript and copies 3 field elements a round and the claims
once a layer.
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
    mont_to_scalars,
    scalars_to_mont,
)
from .sumcheck import SumcheckInstanceProof
from .unipoly import UniPoly

_ZERO = Scalar.zero()
_ONE = Scalar.one()


class _Stack:
    """Stacked tables of several circuits and the function of them that
    gives every row's evaluation (the trees' roots, the dot products),
    read back to the host once."""

    __slots__ = ("tables", "_evaluate", "_values")

    def __init__(self, tables, evaluate):
        self.tables, self._evaluate, self._values = tables, evaluate, None

    def value(self, row: int) -> Scalar:
        if self._values is None:
            self._values = mont_to_scalars(self._evaluate(*self.tables))
        return self._values[row]


def _rows(circuits):
    """(stack, first row) when the circuits are consecutive rows of one
    stack, else None."""
    s, r0 = circuits[0].stack, circuits[0].row
    if all(c.stack is s and c.row == r0 + i for i, c in enumerate(circuits)):
        return s, r0
    return None


class ProductCircuit:
    """Binary product tree; layer k holds 2^(L-k) values as (left, right)
    halves (product_tree.rs:12-63)."""

    __slots__ = ("left_vec", "right_vec", "stack", "row")

    def __init__(self, poly: DensePolynomial):
        c = ProductCircuit.batch(poly.Zm[None])[0]
        for k in self.__slots__:
            setattr(self, k, getattr(c, k))

    @staticmethod
    def batch(leaves: torch.Tensor) -> list:
        """B trees over the rows of a (B, n, 16) tensor: every layer and
        the roots of the stack from K6's tree kernel (pt_tree); each
        circuit's layers are views of the stacked ones, layer k the two
        halves of the stack's layer k."""
        layers = pk.pt_tree(leaves)
        stack = _Stack(layers, lambda *t: t[-1])
        out = []
        for b in range(leaves.shape[0]):
            c = object.__new__(ProductCircuit)
            c.left_vec = [t[b, :t.shape[1] // 2] for t in layers[:-1]]
            c.right_vec = [t[b, t.shape[1] // 2:] for t in layers[:-1]]
            c.stack, c.row = stack, b
            out.append(c)
        return out

    def num_layers(self) -> int:
        return len(self.left_vec)

    def evaluate(self) -> Scalar:
        """The root, from the stack's roots (one copy to the host a
        stack)."""
        return self.stack.value(self.row)


class DotProductCircuit:
    """sum_i left_i right_i weight_i (product_tree.rs:67-110)."""

    __slots__ = ("left", "right", "weight", "stack", "row")

    def __init__(self, left, right, weight):
        # (n, 16) Montgomery tensors on one device
        assert left.shape == right.shape == weight.shape
        self.left, self.right, self.weight = left, right, weight
        self.stack = _Stack((left[None], right[None], weight[None]),
                            _dot_products)
        self.row = 0

    @staticmethod
    def batch(left, right, weight) -> list:
        """S circuits over the rows of three (S, n, 16) tensors, evaluated
        together (a K1 product and a K1 dot over the stack, counted as
        dotp_eval) on the first evaluate()."""
        assert left.shape == right.shape == weight.shape
        stack = _Stack((left, right, weight), _dot_products)
        out = []
        for s in range(left.shape[0]):
            d = object.__new__(DotProductCircuit)
            d.left, d.right, d.weight = left[s], right[s], weight[s]
            d.stack, d.row = stack, s
            out.append(d)
        return out

    def evaluate(self) -> Scalar:
        return self.stack.value(self.row)

    def split(self):
        h = self.left.shape[0] // 2
        return (
            DotProductCircuit(self.left[:h], self.right[:h], self.weight[:h]),
            DotProductCircuit(self.left[h:], self.right[h:], self.weight[h:]),
        )


def _dot_products(left, right, weight) -> torch.Tensor:
    """(S,) sums of left right weight over the rows of (S, n, 16)."""
    lr = fq.mul(left, right, counter="dotp_eval")
    return fq.dot(lr, weight, 1, counter="dotp_eval")


def _layer_tables(prod_circuits, layer_id: int):
    """The (Bp, n, 16) left and right tables of the circuits at a layer:
    the stack's layer read in place when they are consecutive rows of one
    stack, else stacked."""
    rows = _rows(prod_circuits)
    if rows is None:
        return (torch.stack([c.left_vec[layer_id] for c in prod_circuits]),
                torch.stack([c.right_vec[layer_id] for c in prod_circuits]))
    stack, r0 = rows
    t = stack.tables[layer_id][r0:r0 + len(prod_circuits)]
    h = t.shape[1] // 2
    return t[:, :h], t[:, h:]


def _dotp_tables(dotp_circuits):
    rows = _rows(dotp_circuits)
    if rows is None:
        return tuple(torch.stack([getattr(d, k) for d in dotp_circuits])
                     for k in ("left", "right", "weight"))
    stack, r0 = rows
    return tuple(t[r0:r0 + len(dotp_circuits)] for t in stack.tables)


def prove_cubic_batched(claim, num_rounds, A_par, B_par, C_par, A_seq,
                        B_seq, C_seq, coeffs, transcript):
    """Non-ZK batched cubic sumcheck (sumcheck.rs:264-434).

    A_par/B_par: (B, n, 16) circuit-layer tables (any row stride) sharing
    C_par (n, 16); A_seq/B_seq/C_seq: (S, n, 16) dot-product tables (or
    None). Each round is one K6 launch (pt_round) and the last bind one
    more (pt_fold). Returns (proof, r, claims_prod, claims_dotp)."""
    e = claim
    r = []
    cubic_polys = []
    have_seq = A_seq is not None and A_seq.shape[0] > 0
    seq = (A_seq, B_seq, C_seq) if have_seq else None
    tabs = (A_par, B_par, C_par, seq)
    coef = scalars_to_mont(coeffs, A_par.device)
    rm = None
    for _ in range(num_rounds):
        evs, bound = pk.pt_round(*tabs[:3], coef, rm, tabs[3])
        tabs = bound or tabs
        c0, c2, c3 = mont_to_scalars(evs)
        poly = UniPoly.from_evals([c0, e - c0, c2, c3])
        poly.append_to_transcript(b"poly", transcript)
        r_j = transcript.challenge_scalar(b"challenge_nextround")
        r.append(r_j)
        rm = scalars_to_mont([r_j], A_par.device)[0]
        e = poly.evaluate(r_j)
        cubic_polys.append(poly.compress())

    Bp = A_par.shape[0]
    if num_rounds:
        claims = pk.pt_fold(*tabs[:3], rm, tabs[3])
    else:
        claims = torch.cat([tabs[0][:, 0], tabs[1][:, 0], tabs[2][:1]] +
                           ([t[:, 0] for t in seq] if have_seq else []))
    claims = mont_to_scalars(claims)
    claims_prod = (claims[:Bp], claims[Bp:2 * Bp], claims[2 * Bp])
    if have_seq:
        S = A_seq.shape[0]
        q = 2 * Bp + 1
        claims_dotp = (claims[q:q + S], claims[q + S:q + 2 * S],
                       claims[q + 2 * S:])
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
        """The circuits' layers are read in place when they are
        consecutive rows of one stack (ProductCircuit.batch,
        DotProductCircuit.batch), else stacked a layer at a time."""
        assert prod_circuits
        dev = prod_circuits[0].left_vec[0].device
        claims_dotp_final = ([], [], [])
        proof_layers = []
        num_layers = prod_circuits[0].num_layers()
        claims_to_verify = [c.evaluate() for c in prod_circuits]
        rand = []
        for layer_id in range(num_layers - 1, -1, -1):
            A_par, B_par = _layer_tables(prod_circuits, layer_id)
            C_par = EqPolynomial(rand).evals_dev(dev)
            assert C_par.shape[0] == A_par.shape[1]
            num_rounds_prod = log2(C_par.shape[0])

            A_seq = B_seq = C_seq = None
            if layer_id == 0 and dotp_circuits:
                claims_to_verify = claims_to_verify + [
                    d.evaluate() for d in dotp_circuits]
                A_seq, B_seq, C_seq = _dotp_tables(dotp_circuits)

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
