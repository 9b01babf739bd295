"""K6 (SPARK's grand-product circuits): the port's plain versions against
the JAX package's models/product_tree.py kernels (_layer_mul,
_batched_cubic_evals, _batched_cubic_evals_seq, _batched_fold) at B = 3
circuits, S = 2 dot-product circuits and n = 8; the round (pt_round_plain:
folds, evaluations and the coefficient sum, with and without r and the
dot-product stack, and at n = 2), the last bind (pt_fold_plain) and the
tree (pt_tree_plain, stacks of 3 trees of 8 and 16 leaves) against the
JAX kernels they stand for (run in a fresh process);
ProductCircuit.evaluate; and ProductCircuitEvalProofBatched at the shapes
of tests/test_spark.py (three product circuits of 8 leaves, and two with
two dot-product circuits): the port's proof must serialize to the JAX
package's bytes with the same random point and transcript state, each
package's verifier must accept the other's proof, and the port's proof
from stacked circuits must equal its proof from a list of views.
Tolerance: exact equality."""

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

from .torch_shared import in_fresh_process, shared_result

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
        got = pk.layer_mul_plain(A[1], B[1])
        for b in range(3):
            jl, jr = jpt._layer_mul(A[0][b], B[0][b])
            assert same(jl, got[0][b]) and same(jr, got[1][b])
    elif kernel == "cubic":
        C = tab(8)
        assert same(jpt._batched_cubic_evals(A[0], B[0], C[0]),
                    pk.cubic_evals_plain(A[1], B[1], C[1]))
    elif kernel == "cubic_seq":
        A, B, C = tab(2, 8), tab(2, 8), tab(2, 8)
        assert same(jpt._batched_cubic_evals_seq(A[0], B[0], C[0]),
                    pk.cubic_evals_plain(A[1], B[1], C[1]))
    else:
        r = tab(1)
        assert same(jpt._batched_fold(A[0], r[0][0]),
                    pk.fold_plain(A[1], r[1][0]))
        assert same(jpt._batched_fold(A[0][:1], r[0][0])[0],
                    pk.fold_plain(A[1][0], r[1][0]))


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


# pt_round cases: (bound to r first, with the dot-product stack, n)
ROUND_CASES = {
    "evals": (False, False, 8), "evals_seq": (False, True, 8),
    "bind": (True, False, 16), "bind_seq": (True, True, 16),
    "evals_n2": (False, True, 2), "last_bind": (True, True, 2),
}


def round_inputs(case):
    """A case's tables as the JAX package's Montgomery limbs (numpy, from a
    fixed seed): A, B (3, n), C (n), Aq, Bq, Cq (2, n), the coefficients
    and r."""
    bind, seq, n = ROUND_CASES[case]
    g = np.random.default_rng(70 + list(ROUND_CASES).index(case))
    shapes = [(3, n), (3, n), (n,), (2, n), (2, n), (2, n), (5,), (1,)]
    out = []
    for shape in shapes:
        v = [int.from_bytes(g.bytes(40), "little") % L
             for _ in range(int(np.prod(shape)))]
        out.append(jfq.encode(v).reshape(shape + (16,)))
    return out


def jax_rounds():
    """Per case, from the JAX package: the tables after _batched_fold
    (the eq table C by _fold of its halves, as prove_cubic_batched folds
    it), and then the round's (c0, c2, c3) = sum_k coef_k (e0, e2, e3)_k
    of _batched_cubic_evals and _batched_cubic_evals_seq, summed in Python
    Scalars (the last bind: the folded tables only)."""
    from spartan_parallel_tpu.ops.sumcheck import _fold, _split

    res = {}
    for case, (bind, seq, n) in ROUND_CASES.items():
        A, B, C, Aq, Bq, Cq, coef, r = (jnp.asarray(t)
                                        for t in round_inputs(case))
        tabs = [A, B, C] + ([Aq, Bq, Cq] if seq else [])
        if bind:
            rm = r[0]
            tabs = [jpt._batched_fold(t, rm) if t.ndim == 3 else
                    _fold(*_split(t, 0), rm) for t in tabs]
        folded = [np.asarray(t).astype(np.int32) for t in tabs]
        if case == "last_bind":
            res[case] = (folded, None)
            continue
        evs = jdm.mont_to_scalars(jpt._batched_cubic_evals(*tabs[:3]))
        if seq:
            evs += jdm.mont_to_scalars(
                jpt._batched_cubic_evals_seq(*tabs[3:]))
        cos = jdm.mont_to_scalars(coef)
        sums = [JScalar.zero()] * 3
        for k in range(len(evs) // 3):
            for t in range(3):
                sums[t] = sums[t] + evs[3 * k + t] * cos[k]
        res[case] = (folded, [int(x) for x in sums])
    return res


def jax_k6_refs():
    """The JAX package's results for the round and tree tests, computed
    together in one process."""
    return {"rounds": jax_rounds(), "trees": {n: jax_trees(n)
                                              for n in (8, 16)}}


@pytest.fixture(scope="module")
def jax_k6(tmp_path_factory):
    return shared_result(tmp_path_factory, "jax_k6_refs",
                         lambda: in_fresh_process(jax_k6_refs, timeout=600))


@pytest.mark.parametrize("case", list(ROUND_CASES))
def test_pt_round_matches_jax(jax_k6, case):
    """pt_round_plain (and, for the last bind, pt_fold_plain) against JAX's
    folds, cubic evaluations and the coefficient sum in Scalars."""
    bind, seq, n = ROUND_CASES[case]
    want_tabs, want_sums = jax_k6["rounds"][case]
    A, B, C, Aq, Bq, Cq, coef, r = (torch.from_numpy(t.astype(np.int32))
                                    for t in round_inputs(case))
    sq = (Aq, Bq, Cq) if seq else None
    if case == "last_bind":
        claims = pk.pt_fold_plain(A, B, C, r[0], sq)
        want = np.concatenate([want_tabs[0][:, 0], want_tabs[1][:, 0],
                               want_tabs[2][:1]]
                              + [t[:, 0] for t in want_tabs[3:]])
        assert np.array_equal(claims.numpy(), want)
        return
    coef = coef[:3 + (2 if seq else 0)]
    out, tabs = pk.pt_round_plain(A, B, C, coef, r[0] if bind else None, sq)
    assert [int(x) for x in tdm.mont_to_scalars(out)] == want_sums
    if bind:
        got = list(tabs[:3]) + (list(tabs[3]) if seq else [])
        assert len(got) == len(want_tabs)
        assert all(np.array_equal(g.numpy(), w)
                   for g, w in zip(got, want_tabs))
    else:
        assert tabs is None


def jax_trees(n):
    """JAX's layers of 3 trees of n leaves (_layer_mul iterated, each
    layer the concatenation of its halves, the last the root alone) and
    each circuit's root from ProductCircuit.evaluate."""
    g = np.random.default_rng(40 + n)
    leaves = [[int.from_bytes(g.bytes(40), "little") % L for _ in range(n)]
              for _ in range(3)]
    layers = []
    for vals in leaves:
        t = jnp.asarray(jfq.encode(vals))
        rows = [np.asarray(t)]
        while t.shape[0] > 1:
            lo, hi = jpt._layer_mul(t[:t.shape[0] // 2], t[t.shape[0] // 2:])
            t = jnp.concatenate([lo, hi])
            rows.append(np.asarray(t))
        layers.append(rows)
    roots = [int(jpt.ProductCircuit(
        jdm.DensePolynomial.from_scalars(v)).evaluate()) for v in leaves]
    return leaves, layers, roots


@pytest.mark.parametrize("n", [8, 16])
def test_pt_tree_matches_jax(jax_k6, n):
    """pt_tree_plain on a stack of 3 trees against JAX's _layer_mul layers
    and ProductCircuit.evaluate, and ProductCircuit.batch's roots."""
    leaves, layers, roots = jax_k6["trees"][n]
    stack = torch.stack([tdm.scalars_to_mont(v, "cpu") for v in leaves])
    got = pk.pt_tree_plain(stack)
    assert len(got) == len(layers[0])
    for k, t in enumerate(got):
        for b in range(3):
            assert np.array_equal(t[b].numpy(), layers[b][k])
    assert [int(x) for x in tdm.mont_to_scalars(got[-1])] == roots
    circuits = tpt.ProductCircuit.batch(stack)
    assert [int(c.evaluate()) for c in circuits] == roots


def test_proof_from_stack_equals_views():
    """ProductCircuitEvalProofBatched.prove from circuits that are
    consecutive rows of one stack (read in place) and from the same
    circuits as a list of views (stacked a layer at a time: their stack
    built in another row order, the dot-product circuits one by one) gives
    the same bytes."""
    polys, dotp = CASES["dotp"]
    polys = polys + [rand_ints(8)]
    leaves = torch.stack([tdm.scalars_to_mont(p, "cpu") for p in polys])
    stacked = tpt.ProductCircuit.batch(leaves)
    perm = [2, 0, 1]
    shuffled = tpt.ProductCircuit.batch(leaves[perm])
    views = [shuffled[perm.index(b)] for b in range(3)]
    assert tpt._rows(stacked) is not None and tpt._rows(views) is None
    cols = [tdm.scalars_to_mont(v, "cpu") for v in dotp]
    dots_stacked = tpt.DotProductCircuit.batch(
        *(c.reshape(2, 4, 16) for c in cols))
    dots_views = list(tpt.DotProductCircuit(*cols).split())
    assert tpt._rows(dots_views) is None
    out = []
    for circuits, dots in ((stacked, dots_stacked), (views, dots_views)):
        tp = Transcript(b"prodtest3")
        proof, rand = tpt.ProductCircuitEvalProofBatched.prove(
            circuits, dots, tp)
        out.append((tser.serialize(proof, "ProductCircuitEvalProofBatched"),
                    ints(rand), int(tp.challenge_scalar(b"probe"))))
    assert out[0] == out[1]
