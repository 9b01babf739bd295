"""K3 (sparse R1CS products) and the R1CS instance: the port's plain path
against the JAX package's ops/spmv.py and models/r1csinstance.py on the
same inputs. Tolerance: exact equality of the Montgomery limbs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_parallel_tpu.core.consts import L
from spartan_parallel_tpu.core.field import Scalar as JScalar
from spartan_parallel_tpu.models import r1csinstance as jri
from spartan_parallel_tpu.ops import fq as jfq
from spartan_parallel_tpu_torch.convert import instance_from_numpy
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models import r1csinstance as tri

rng = np.random.default_rng(17)


def rnd():
    return int.from_bytes(rng.bytes(40), "little") % L


def same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64),
                          t.numpy().astype(np.int64))


def matrices():
    """A random 8x8 matrix with empty rows/columns and repeated entries,
    in both packages."""
    entries = [(int(rng.integers(0, 8)), int(rng.integers(0, 8)), rnd())
               for _ in range(20)]
    return (jri.SparseMatPolynomial(3, 3, entries),
            tri.SparseMatPolynomial(3, 3, entries))


def test_spmv_and_eval_table_match_jax():
    jm, tm = matrices()
    enc = jfq.encode([rnd() for _ in range(3 * 8)]).reshape(3, 8, 16)
    assert same(jm.multiply_vec_batched(jnp.asarray(enc), 8),
                tm.multiply_vec_batched(torch.from_numpy(
                    enc.astype(np.int32))))
    rx = jfq.encode([rnd() for _ in range(8)])
    assert same(jm.eval_table(jnp.asarray(rx), 8),
                tm.eval_table(torch.from_numpy(rx.astype(np.int32))))


def test_sparse_eval_matches_jax():
    jm, tm = matrices()
    rx = jfq.encode([rnd() for _ in range(8)])
    ry = jfq.encode([rnd() for _ in range(8)])
    assert same(jm.evaluate_with_tables_dev(jnp.asarray(rx), jnp.asarray(ry)),
                tm.evaluate_with_tables(torch.from_numpy(rx.astype(np.int32)),
                                        torch.from_numpy(ry.astype(np.int32))))


def test_instance_ops_match_jax():
    """The synthetic instance, its digest, Az/Bz/Cz, the phase-2 tables
    and the verifier's evaluations."""
    jinst, jv, ji = jri.produce_synthetic_r1cs(1, [1], 16, 16, 4, seed=3)
    tinst, tv, ti = tri.produce_synthetic_r1cs(1, [1], 16, 16, 4, seed=3,
                                               device="cpu")
    assert jv == tv and ji == ti
    assert jinst.get_digest() == tinst.get_digest()

    rx = [rnd() for _ in range(4)]
    ry = [rnd() for _ in range(5)]
    jev = jinst.evaluate([JScalar(x) for x in rx], [JScalar(x) for x in ry])
    tev = tinst.evaluate([Scalar(x) for x in rx], [Scalar(x) for x in ry],
                         device="cpu")
    assert [int(x) for x in jev] == [int(x) for x in tev]

    z = jfq.encode([rnd() for _ in range(32)]).reshape(1, 1, 2, 16, 16)
    jz, tz = jnp.asarray(z), torch.from_numpy(z.astype(np.int32))
    for a, b in zip(jinst.multiply_vec_block(1, [1], 1, [16], 16, 16, [16],
                                             jz),
                    tinst.multiply_vec_block(1, [1], 1, [16], 16, 16, [16],
                                             tz)):
        assert same(a.Zm, b.Zm)
    rx_tab = jfq.encode([rnd() for _ in range(16)])
    for a, b in zip(
            jinst.compute_eval_table_sparse_disjoint_rounds(
                1, [16], 2, 16, [16], jnp.asarray(rx_tab))[0],
            tinst.compute_eval_table_sparse_disjoint_rounds(
                1, [16], 2, 16, [16],
                torch.from_numpy(rx_tab.astype(np.int32)))[0]):
        assert same(a, b)


def test_instance_from_numpy_carries_the_jax_instance():
    jinst, _, _ = jri.produce_synthetic_r1cs(1, [1], 16, 16, 4, seed=5)
    mats = [(m.rows, m.cols, m.vals)
            for m in (jinst.A_list[0], jinst.B_list[0], jinst.C_list[0])]
    tinst = instance_from_numpy(16, 16, 4, *mats, device="cpu")
    assert tinst.get_digest() == jinst.get_digest()


def test_matrix_rejects_out_of_range_indices():
    """The kernels index the z and eq tables with the matrix's rows and
    columns, so an index past the table is refused when the matrix is
    built."""
    with pytest.raises(ValueError):
        tri.SparseMatPolynomial(2, 2, [(0, 4, 1)])
    with pytest.raises(ValueError):
        tri.SparseMatPolynomial(2, 2, arrays=([-1], [0], [1]))
