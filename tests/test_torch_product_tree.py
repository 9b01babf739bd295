"""K6 (SPARK's grand-product circuits): the port's plain versions against
the JAX package's models/product_tree.py kernels (_layer_mul,
_batched_cubic_evals, _batched_cubic_evals_seq, _batched_fold) at B = 3
circuits, S = 2 dot-product circuits and n = 8; ProductCircuit.evaluate;
and ProductCircuitEvalProofBatched at the shapes of tests/test_spark.py
(three product circuits of 8 leaves, and two with two dot-product
circuits): the port's proof must serialize to the JAX package's bytes
with the same random point and transcript state, and each package's
verifier must accept the other's proof. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_parallel_tpu import serialization as jser
from spartan_parallel_tpu.core.consts import L
from spartan_parallel_tpu.core.field import Scalar as JScalar
from spartan_parallel_tpu.models import dense_mlpoly as jdm
from spartan_parallel_tpu.models import product_tree as jpt
from spartan_parallel_tpu.ops import fq as jfq
from spartan_parallel_tpu.utils.transcript import Transcript as JTranscript
from spartan_parallel_tpu_torch import serialization as tser
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models import dense_mlpoly as tdm
from spartan_parallel_tpu_torch.models import product_tree as tpt
from spartan_parallel_tpu_torch.ops import product as pk
from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
from spartan_parallel_tpu_torch.utils.transcript import Transcript

from .torch_shared import shared_result

rng = np.random.default_rng(31)


def rand_ints(n):
    return [int.from_bytes(rng.bytes(40), "little") % L for _ in range(n)]


# the circuits of the proof tests, fixed at import (the same in every
# xdist worker)
CASES = {
    "prod": ([rand_ints(8) for _ in range(3)], None),
    "dotp": ([rand_ints(8) for _ in range(2)],
             [rand_ints(8) for _ in range(3)]),
}
LABEL = {"prod": b"prodtest", "dotp": b"prodtest2"}


def tab(*shape):
    """A random Montgomery table in both packages."""
    n = int(np.prod(shape))
    enc = jfq.encode(rand_ints(n)).reshape(shape + (16,))
    return jnp.asarray(enc), torch.from_numpy(enc.astype(np.int32))


def same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64),
                          t.numpy().astype(np.int64))


@pytest.mark.parametrize("kernel", ["layer_mul", "cubic", "cubic_seq",
                                    "fold"])
def test_kernel_matches_jax(kernel):
    A, B = tab(3, 8), tab(3, 8)
    if kernel == "layer_mul":
        got = pk.layer_mul(A[1], B[1])
        for b in range(3):
            jl, jr = jpt._layer_mul(A[0][b], B[0][b])
            assert same(jl, got[0][b]) and same(jr, got[1][b])
    elif kernel == "cubic":
        C = tab(8)
        assert same(jpt._batched_cubic_evals(A[0], B[0], C[0]),
                    pk.cubic_evals(A[1], B[1], C[1]))
    elif kernel == "cubic_seq":
        A, B, C = tab(2, 8), tab(2, 8), tab(2, 8)
        assert same(jpt._batched_cubic_evals_seq(A[0], B[0], C[0]),
                    pk.cubic_evals(A[1], B[1], C[1]))
    else:
        r = tab(1)
        assert same(jpt._batched_fold(A[0], r[0][0]),
                    pk.fold(A[1], r[1][0]))
        assert same(jpt._batched_fold(A[0][:1], r[0][0])[0],
                    pk.fold(A[1][0], r[1][0]))


def test_product_circuit_evaluate():
    """One circuit and a batch of three, against the JAX circuit and the
    product of the leaves."""
    polys = [rand_ints(8) for _ in range(3)]
    batch = tpt.ProductCircuit.batch(torch.stack(
        [tdm.scalars_to_mont(p, "cpu") for p in polys]))
    for vals, c in zip(polys, batch):
        expect = 1
        for v in vals:
            expect = expect * v % L
        single = tpt.ProductCircuit(tdm.DensePolynomial.from_scalars(
            vals, "cpu"))
        jc = jpt.ProductCircuit(jdm.DensePolynomial.from_scalars(vals))
        assert int(single.evaluate()) == int(c.evaluate()) == \
            int(jc.evaluate()) == expect
        assert single.num_layers() == jc.num_layers() == 3
        for k in range(3):
            assert same(jc.left_vec[k], c.left_vec[k])
            assert same(jc.right_vec[k], c.right_vec[k])


def ints(v):
    return [int(x) for x in v]


def jax_case(case):
    polys, dotp = CASES[case]
    circuits = [jpt.ProductCircuit(jdm.DensePolynomial.from_scalars(p))
                for p in polys]
    dots = []
    if dotp is not None:
        d = jpt.DotProductCircuit(*(jdm.scalars_to_mont(v) for v in dotp))
        dots = list(d.split())
    return circuits, dots


def port_case(case):
    polys, dotp = CASES[case]
    circuits = [tpt.ProductCircuit(tdm.DensePolynomial.from_scalars(p, "cpu"))
                for p in polys]
    dots = []
    if dotp is not None:
        d = tpt.DotProductCircuit(*(tdm.scalars_to_mont(v, "cpu")
                                    for v in dotp))
        dots = list(d.split())
    return circuits, dots


@pytest.fixture(scope="module", params=["prod", "dotp"])
def jax_proof(request, tmp_path_factory):
    """The JAX package's proof: (bytes, rand, probe, claims, dotp
    claims)."""
    case = request.param

    def prove():
        circuits, dots = jax_case(case)
        tp = JTranscript(LABEL[case])
        proof, rand = jpt.ProductCircuitEvalProofBatched.prove(
            circuits, dots, tp)
        return (jser.serialize(proof, "ProductCircuitEvalProofBatched"),
                ints(rand), int(tp.challenge_scalar(b"probe")),
                [int(c.evaluate()) for c in circuits],
                [int(d.evaluate()) for d in dots])

    return case, shared_result(tmp_path_factory, f"jax_prod_{case}", prove)


def port_prove(case):
    circuits, dots = port_case(case)
    tp = Transcript(LABEL[case])
    proof, rand = tpt.ProductCircuitEvalProofBatched.prove(circuits, dots,
                                                           tp)
    return (tser.serialize(proof, "ProductCircuitEvalProofBatched"),
            ints(rand), int(tp.challenge_scalar(b"probe")),
            [int(c.evaluate()) for c in circuits],
            [int(d.evaluate()) for d in dots])


def test_proof_matches_jax(jax_proof):
    case, want = jax_proof
    got = port_prove(case)
    assert got[3:] == want[3:], "circuit evaluations differ"
    assert got[1] == want[1], "random points differ"
    assert got[2] == want[2], "transcript states differ"
    assert got[0] == want[0], "proof bytes differ"


def test_port_verifies_jax_proof(jax_proof):
    case, (raw, rand, _, claims, dotp) = jax_proof
    proof = tser.deserialize(raw, "ProductCircuitEvalProofBatched")
    out, out_dotp, r = proof.verify([Scalar(c) for c in claims],
                                    [Scalar(c) for c in dotp], 8,
                                    Transcript(LABEL[case]))
    assert ints(r) == rand
    # the final claims are the leaf polynomials bound to the point
    for c, vals in zip(out, CASES[case][0]):
        assert int(c) == int(tdm.DensePolynomial.from_scalars(
            vals, "cpu").evaluate(r))
    assert len(out_dotp) == (3 if case == "dotp" else 0)


def test_jax_verifies_port_proof(jax_proof):
    case, (_, rand, _, claims, dotp) = jax_proof
    raw = port_prove(case)[0]
    proof = jser.deserialize(raw, "ProductCircuitEvalProofBatched")
    _, _, r = proof.verify([JScalar(c) for c in claims],
                           [JScalar(c) for c in dotp], 8,
                           JTranscript(LABEL[case]))
    assert ints(r) == rand


@pytest.mark.parametrize("tamper", ["claim", "layer_claim", "round_poly",
                                    "dotp_claim"])
def test_port_rejects_tampered_proof(tamper):
    raw, _, _, claims, dotp = port_prove("dotp")
    proof = tser.deserialize(raw, "ProductCircuitEvalProofBatched")
    claims = [Scalar(c) for c in claims]
    if tamper == "claim":
        claims[0] = claims[0] + Scalar(1)
    elif tamper == "layer_claim":
        layer = proof.proof[1]
        layer.claims_prod_left[0] = layer.claims_prod_left[0] + Scalar(1)
    elif tamper == "round_poly":
        cp = proof.proof[2].proof.compressed_polys[0]
        cp.coeffs_except_linear_term[0] = \
            cp.coeffs_except_linear_term[0] + Scalar(1)
    else:
        proof.claims_dotp[2][0] = proof.claims_dotp[2][0] + Scalar(1)
    with pytest.raises(ProofVerifyError):
        proof.verify(claims, [Scalar(c) for c in dotp], 8,
                     Transcript(LABEL["dotp"]))
