"""K1 (scalar field mod l): the port's plain path against the JAX
package's ops/fq.py and dense_mlpoly binds, eq tables, evaluations and
Hyrax opening on the same inputs. Every JAX value of the file is computed
once a run, in a fresh process whose result the pytest-xdist workers
share (`jax_refs`); each case draws its inputs from a seed of its own, so
that process and every worker hold the same inputs. Tolerance: exact
equality of the Montgomery limbs."""

import numpy as np
import pytest
import torch

from spartan_parallel_tpu_torch.core.consts import L
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models import dense_mlpoly as tdm
from spartan_parallel_tpu_torch.models import sparse_mlpoly as tsp
from spartan_parallel_tpu_torch.ops import fq
from spartan_parallel_tpu_torch.ops import sumcheck as tsck

from .torch_shared import case_rng, in_fresh_process, shared_result

OPS = ["mul", "add", "sub", "neg"]
DOTS = [((100,), 0), ((4, 8), 0), ((4, 8), 1)]
ELLS = [0, 1, 7, 13, 14]
# dot_many: three tables of 2^3 entries apart, or four cut from one (4, 8)
# allocation (as AddrTimestamps cuts ops_addr and read_ts)
MANY = ["separate", "one_allocation"]


def rand_mod(rng, n):
    edge = [0, 1, 2, L - 1, L - 2, (1 << 255) % L, (L - 1) // 2]
    vals = [int.from_bytes(rng.bytes(40), "little") % L
            for _ in range(max(0, n - len(edge)))]
    return (edge + vals)[:n]


def limbs(xs, shape=None):
    """Montgomery limbs (int32 numpy) of the ints xs."""
    enc = fq.encode(xs)
    return enc if shape is None else enc.reshape(tuple(shape) + (16,))


def port(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def same(want, got):
    return np.array_equal(np.asarray(want).astype(np.int64),
                          got.numpy().astype(np.int64))


# --------------------------------------------------------------------------
# Each case's inputs (numpy and ints)
# --------------------------------------------------------------------------
def encode_inputs():
    return rand_mod(case_rng("encode"), 12)


def elementwise_inputs(op):
    rng = case_rng("elementwise", op)
    return limbs(rand_mod(rng, 32)), limbs(rand_mod(rng, 32)[::-1])


def broadcast_inputs():
    rng = case_rng("broadcast")
    return limbs(rand_mod(rng, 16)), limbs(rand_mod(rng, 1))


def canonical_inputs():
    return limbs(rand_mod(case_rng("canonical"), 8))


def dot_inputs(shape, axis):
    rng = case_rng("dot", shape, axis)
    n = int(np.prod(shape))
    return limbs(rand_mod(rng, n), shape), limbs(rand_mod(rng, n)[::-1],
                                                 shape)


def bind_inputs():
    rng = case_rng("binds")
    return limbs(rand_mod(rng, 16)), limbs(rand_mod(rng, 3))


def eq_bound_inputs():
    rng = case_rng("eq_bound")
    return rand_mod(rng, 6), rand_mod(rng, 64), rand_mod(rng, 8)


def eq_inputs(ell):
    return rand_mod(case_rng("eq", ell), ell)[::-1]


def many_inputs(layout):
    rng = case_rng("dot_many", layout)
    n = 3 if layout == "separate" else 4
    return [rand_mod(rng, 8) for _ in range(n)], rand_mod(rng, 3)


def opening_inputs():
    rng = case_rng("opening")
    return rand_mod(rng, 16), rand_mod(rng, 4)


# --------------------------------------------------------------------------
# The JAX values, in one fresh process a run
# --------------------------------------------------------------------------
def jax_refs():
    import jax.numpy as jnp

    from spartan_parallel_tpu.core.field import Scalar as JScalar
    from spartan_parallel_tpu.models import dense_mlpoly as jdm
    from spartan_parallel_tpu.ops import fq as jfq
    from spartan_parallel_tpu.ops import sumcheck as jsck
    from spartan_parallel_tpu.utils.random_tape import RandomTape as JTape
    from spartan_parallel_tpu.utils.transcript import (
        Transcript as JTranscript,
    )

    def j(a):
        return jnp.asarray(np.asarray(a).astype(np.uint32))

    def npy(a):
        return np.asarray(a)

    out = {"encode": jfq.encode(encode_inputs())}
    for op in OPS:
        a, b = map(j, elementwise_inputs(op))
        out["elementwise", op] = npy(jfq.neg(a) if op == "neg" else
                                     getattr(jfq, op)(a, b))
    a, r = map(j, broadcast_inputs())
    out["broadcast"] = npy(jfq.mul(a, jnp.broadcast_to(r[0], a.shape)))
    a = j(canonical_inputs())
    out["canonical"] = (npy(jfq.to_canonical(a)),
                        npy(jfq.from_canonical(jfq.to_canonical(a))))
    for shape, axis in DOTS:
        a, b = map(j, dot_inputs(shape, axis))
        out["dot", shape, axis] = (npy(jfq.dot(a, b, axis=axis)),
                                   npy(jfq.sum_reduce(a, axis=axis)))
    a, r = map(j, bind_inputs())
    out["binds"] = (npy(jdm._bound_top(a, r[0])), npy(jdm._bound_bot(a, r[0])),
                    npy(jsck.fold_chain(a.reshape(2, 8, 16), r, axis=1)))
    rs, vals, l8 = eq_bound_inputs()
    rj = [JScalar(x) for x in rs]
    jp = jdm.DensePolynomial.from_scalars(vals)
    out["eq_bound"] = (npy(jdm.EqPolynomial(rj).evals_dev()),
                       npy(jp.bound([JScalar(x) for x in l8])),
                       int(jp.evaluate(rj)))
    for ell in ELLS:
        out["eq", ell] = npy(jdm.EqPolynomial(
            [JScalar(x) for x in eq_inputs(ell)]).evals_dev())
    for layout in MANY:
        tables, r = many_inputs(layout)
        out["dot_many", layout] = [
            int(jdm.DensePolynomial.from_scalars(t).evaluate(
                [JScalar(x) for x in r])) for t in tables]
    vals, r = opening_inputs()
    jp = jdm.DensePolynomial.from_scalars(vals)
    jgens = jdm.PolyCommitmentGens(4, b"test gens")
    jtape = JTape(b"tape", seed=b"\x01" * 32)
    jcomm, jblinds = jp.commit(jgens, jtape)
    jr = [JScalar(x) for x in r]
    jt = JTranscript(b"test")
    _, jC = jdm.PolyEvalProof.prove(jp, jblinds, jr, jp.evaluate(jr), None,
                                    jgens, jt, jtape)
    out["opening"] = (jcomm.C, jC, int(jt.challenge_scalar(b"end")))
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return shared_result(tmp_path_factory, "jax_fq_refs",
                         lambda: in_fresh_process(jax_refs, timeout=900))


# --------------------------------------------------------------------------
# The port against them
# --------------------------------------------------------------------------
def test_encode_matches_jax(jax_ref):
    xs = encode_inputs()
    assert np.array_equal(fq.encode(xs), jax_ref["encode"].astype(np.int32))
    assert fq.decode(fq.encode(xs)) == xs


@pytest.mark.parametrize("op", OPS)
def test_elementwise_matches_jax(jax_ref, op):
    a, b = map(port, elementwise_inputs(op))
    got = fq.neg(a) if op == "neg" else getattr(fq, op)(a, b)
    assert same(jax_ref["elementwise", op], got)


def test_broadcast_scalar_mul_matches_jax(jax_ref):
    a, r = map(port, broadcast_inputs())
    assert same(jax_ref["broadcast"], fq.mul(a, r[0]))


def test_canonical_roundtrip_matches_jax(jax_ref):
    a = port(canonical_inputs())
    canon, back = jax_ref["canonical"]
    assert same(canon, fq.to_canonical(a))
    assert same(back, fq.from_canonical(fq.to_canonical(a)))


@pytest.mark.parametrize("shape,axis", DOTS)
def test_dot_and_sum_match_jax(jax_ref, shape, axis):
    a, b = map(port, dot_inputs(shape, axis))
    dot, total = jax_ref["dot", shape, axis]
    assert same(dot, fq.dot(a, b, axis=axis))
    assert same(total, fq.sum_reduce(a, axis=axis))


def test_binds_match_jax(jax_ref):
    """bind serves _bound_top, _bound_bot, fold_chain and the
    fixed-buffer sumcheck binds."""
    a, r = map(port, bind_inputs())
    top, bot, chain = jax_ref["binds"]
    assert same(top, fq.bind(a, r[0], 0, 8, 8))
    assert same(bot, fq.bind(a.reshape(8, 2, 16), r[0], 1, 1, 1).reshape(
        8, 16))
    assert same(chain, tsck.fold_chain(a.reshape(2, 8, 16), r, axis=1))


def test_eq_table_and_bound_match_jax(jax_ref):
    rs, vals, l8 = eq_bound_inputs()
    r = [Scalar(x) for x in rs]
    eq, bound, ev = jax_ref["eq_bound"]
    assert same(eq, tdm.EqPolynomial(r).evals_dev("cpu"))
    tp = tdm.DensePolynomial.from_scalars(vals, "cpu")
    assert same(bound, tp.bound([Scalar(x) for x in l8]))
    assert ev == int(tp.evaluate(r))


@pytest.mark.parametrize("ell", ELLS)
def test_eq_table_matches_jax(jax_ref, ell):
    """The port's eq table (eq_evals' plain version, the CPU path of
    csrc/fq.cu k_eq_evals) against JAX EqPolynomial.evals_dev: the
    doubling build up to 2^13 entries and the half-table product above;
    challenges include 0, 1 and l - 1."""
    r = [Scalar(x) for x in eq_inputs(ell)]
    assert same(jax_ref["eq", ell], tdm.EqPolynomial(r).evals_dev("cpu"))


@pytest.mark.parametrize("layout", MANY)
def test_dot_many_matches_jax(jax_ref, layout):
    """fq.dot_many (one launch for a list of tables on the card; here its
    plain version) and sparse_mlpoly._evaluate_many, which calls it,
    against JAX DensePolynomial.evaluate of each table: tables apart, and
    tables cut from one allocation."""
    tables, r = many_inputs(layout)
    if layout == "separate":
        polys = [tdm.DensePolynomial.from_scalars(t, "cpu") for t in tables]
    else:
        m = tdm.scalars_to_mont([x for t in tables for x in t],
                                "cpu").reshape(len(tables), -1, 16)
        polys = [tdm.DensePolynomial(m[i]) for i in range(len(tables))]
    want = jax_ref["dot_many", layout]
    chis = tdm.EqPolynomial([Scalar(x) for x in r]).evals_dev("cpu")
    got = fq.dot_many([p.Zm for p in polys], chis)
    assert got.shape == (len(tables), 16)
    assert [int(x) for x in tdm.mont_to_scalars(got)] == want
    assert [int(x) for x in tsp._evaluate_many(polys, [Scalar(x)
                                                       for x in r])] == want


def test_poly_eval_proof_matches_jax(jax_ref):
    """The single Hyrax opening (PolyEvalProof.prove/verify) on the same
    polynomial, point and tape: the commitment, the committed evaluation
    and the transcript state equal the JAX package's; the port's verifier
    accepts the proof and rejects it at another point."""
    from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    vals, r = opening_inputs()
    jcommC, jC, jend = jax_ref["opening"]
    tp = tdm.DensePolynomial.from_scalars(vals, "cpu")
    tgens = tdm.PolyCommitmentGens(4, b"test gens")
    ttape = RandomTape(b"tape", seed=b"\x01" * 32)
    tcomm, tblinds = tp.commit(tgens, ttape)
    assert jcommC == tcomm.C

    tr = [Scalar(x) for x in r]
    tt = Transcript(b"test")
    proof, tC = tdm.PolyEvalProof.prove(tp, tblinds, tr, tp.evaluate(tr),
                                        None, tgens, tt, ttape)
    assert jC == tC
    assert jend == int(tt.challenge_scalar(b"end"))

    proof.verify(tgens, Transcript(b"test"), tr, tC, tcomm, "cpu")
    with pytest.raises(ProofVerifyError):
        proof.verify(tgens, Transcript(b"test"), tr[::-1], tC, tcomm, "cpu")
