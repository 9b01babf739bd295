"""K1 (scalar field mod l): the port's plain path against the JAX
package's ops/fq.py and dense_mlpoly binds on the same inputs. Tolerance:
exact equality of the Montgomery limbs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from spartan_parallel_tpu.core.consts import L
from spartan_parallel_tpu.models import dense_mlpoly as jdm
from spartan_parallel_tpu.ops import fq as jfq
from spartan_parallel_tpu.ops import sumcheck as jsck
from spartan_parallel_tpu_torch.models import dense_mlpoly as tdm
from spartan_parallel_tpu_torch.ops import fq
from spartan_parallel_tpu_torch.ops import sumcheck as tsck

rng = np.random.default_rng(20)


def rand_mod(n):
    edge = [0, 1, 2, L - 1, L - 2, (1 << 255) % L, (L - 1) // 2]
    vals = [int.from_bytes(rng.bytes(40), "little") % L
            for _ in range(max(0, n - len(edge)))]
    return (edge + vals)[:n]


def both(xs):
    """The same Montgomery limbs for JAX (uint32) and the port (int32)."""
    enc = jfq.encode(xs)
    return jnp.asarray(enc), torch.from_numpy(enc.astype(np.int32))


def same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64),
                          t.numpy().astype(np.int64))


def test_encode_matches_jax():
    xs = rand_mod(12)
    assert np.array_equal(fq.encode(xs), jfq.encode(xs).astype(np.int32))
    assert fq.decode(fq.encode(xs)) == xs


@pytest.mark.parametrize("op", ["mul", "add", "sub", "neg"])
def test_elementwise_matches_jax(op):
    xs, ys = rand_mod(32), rand_mod(32)[::-1]
    (ja, ta), (jb, tb) = both(xs), both(ys)
    if op == "neg":
        assert same(jfq.neg(ja), fq.neg(ta))
    else:
        assert same(getattr(jfq, op)(ja, jb), getattr(fq, op)(ta, tb))


def test_broadcast_scalar_mul_matches_jax():
    (ja, ta), (jr, tr) = both(rand_mod(16)), both(rand_mod(1))
    assert same(jfq.mul(ja, jnp.broadcast_to(jr[0], ja.shape)),
                fq.mul(ta, tr[0]))


def test_canonical_roundtrip_matches_jax():
    ja, ta = both(rand_mod(8))
    assert same(jfq.to_canonical(ja), fq.to_canonical(ta))
    assert same(jfq.from_canonical(jfq.to_canonical(ja)),
                fq.from_canonical(fq.to_canonical(ta)))


@pytest.mark.parametrize("shape,axis", [((100,), 0), ((4, 8), 0),
                                        ((4, 8), 1)])
def test_dot_and_sum_match_jax(shape, axis):
    n = int(np.prod(shape))
    (ja, ta), (jb, tb) = both(rand_mod(n)), both(rand_mod(n)[::-1])
    ja, ta = ja.reshape(shape + (16,)), ta.reshape(shape + (16,))
    jb, tb = jb.reshape(shape + (16,)), tb.reshape(shape + (16,))
    assert same(jfq.dot(ja, jb, axis=axis), fq.dot(ta, tb, axis=axis))
    assert same(jfq.sum_reduce(ja, axis=axis), fq.sum_reduce(ta, axis=axis))


def test_binds_match_jax():
    """bind serves _bound_top, _bound_bot, fold_chain and the
    fixed-buffer sumcheck binds."""
    (ja, ta), (jr, tr) = both(rand_mod(16)), both(rand_mod(3))
    assert same(jdm._bound_top(ja, jr[0]), fq.bind(ta, tr[0], 0, 8, 8))
    assert same(jdm._bound_bot(ja, jr[0]),
                fq.bind(ta.reshape(8, 2, 16), tr[0], 1, 1, 1).reshape(8, 16))
    t3j, t3t = ja.reshape(2, 8, 16), ta.reshape(2, 8, 16)
    assert same(jsck.fold_chain(t3j, jr, axis=1),
                tsck.fold_chain(t3t, tr, axis=1))


def test_eq_table_and_bound_match_jax():
    from spartan_parallel_tpu.core.field import Scalar

    r = [Scalar(x) for x in rand_mod(6)]
    assert same(jdm.EqPolynomial(r).evals_dev(),
                tdm.EqPolynomial(r).evals_dev("cpu"))
    vals = rand_mod(64)
    jp = jdm.DensePolynomial.from_scalars(vals)
    tp = tdm.DensePolynomial.from_scalars(vals, "cpu")
    L8 = [Scalar(x) for x in rand_mod(8)]
    assert same(jp.bound(L8), tp.bound(L8))
    assert int(jp.evaluate(r)) == int(tp.evaluate(r))


@pytest.mark.parametrize("ell", [0, 1, 7, 13, 14])
def test_eq_table_matches_jax(ell):
    """The port's eq table (eq_evals' plain version, the CPU path of
    csrc/fq.cu k_eq_evals) against JAX EqPolynomial.evals_dev: the
    doubling build up to 2^13 entries and the half-table product above;
    challenges include 0, 1 and l - 1."""
    from spartan_parallel_tpu.core.field import Scalar

    r = [Scalar(x) for x in rand_mod(ell)[::-1]]
    assert same(jdm.EqPolynomial(r).evals_dev(),
                tdm.EqPolynomial(r).evals_dev("cpu"))


def test_poly_eval_proof_matches_jax():
    """The single Hyrax opening (PolyEvalProof.prove/verify) on the same
    polynomial, point and tape: the commitment, the committed evaluation
    and the transcript state equal the JAX package's; the port's verifier
    accepts the proof and rejects it at another point."""
    from spartan_parallel_tpu.core.field import Scalar as JScalar
    from spartan_parallel_tpu.utils.random_tape import RandomTape as JTape
    from spartan_parallel_tpu.utils.transcript import Transcript as JTranscript
    from spartan_parallel_tpu_torch.core.field import Scalar
    from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    vals, r = rand_mod(16), rand_mod(4)
    jp = jdm.DensePolynomial.from_scalars(vals)
    tp = tdm.DensePolynomial.from_scalars(vals, "cpu")
    jgens = jdm.PolyCommitmentGens(4, b"test gens")
    tgens = tdm.PolyCommitmentGens(4, b"test gens")
    jtape = JTape(b"tape", seed=b"\x01" * 32)
    ttape = RandomTape(b"tape", seed=b"\x01" * 32)
    jcomm, jblinds = jp.commit(jgens, jtape)
    tcomm, tblinds = tp.commit(tgens, ttape)
    assert jcomm.C == tcomm.C

    jr, tr = [JScalar(x) for x in r], [Scalar(x) for x in r]
    jt, tt = JTranscript(b"test"), Transcript(b"test")
    _, jC = jdm.PolyEvalProof.prove(jp, jblinds, jr, jp.evaluate(jr), None,
                                    jgens, jt, jtape)
    proof, tC = tdm.PolyEvalProof.prove(tp, tblinds, tr, tp.evaluate(tr),
                                        None, tgens, tt, ttape)
    assert jC == tC
    assert int(jt.challenge_scalar(b"end")) == int(tt.challenge_scalar(b"end"))

    proof.verify(tgens, Transcript(b"test"), tr, tC, tcomm, "cpu")
    with pytest.raises(ProofVerifyError):
        proof.verify(tgens, Transcript(b"test"), tr[::-1], tC, tcomm, "cpu")
