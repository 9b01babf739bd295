"""K3 (sparse R1CS products) and the R1CS instance: the port's plain path
against the JAX package's ops/spmv.py and models/r1csinstance.py on the
same inputs. Every JAX value of the file is computed once a run, in a
fresh process whose result the pytest-xdist workers share (`jax_refs`);
each case draws its inputs from a seed of its own. Tolerance: exact
equality of the Montgomery limbs."""

import numpy as np
import pytest
import torch

from spartan_parallel_tpu_torch.convert import instance_from_numpy
from spartan_parallel_tpu_torch.core.consts import L
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models import r1csinstance as tri
from spartan_parallel_tpu_torch.ops import fq

from .torch_shared import case_rng, in_fresh_process, shared_result


def rnd(rng):
    return int.from_bytes(rng.bytes(40), "little") % L


def port(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def same(want, got):
    return np.array_equal(np.asarray(want).astype(np.int64),
                          got.numpy().astype(np.int64))


def entries(rng):
    """A random 8x8 matrix with empty rows/columns and repeated entries."""
    return [(int(rng.integers(0, 8)), int(rng.integers(0, 8)), rnd(rng))
            for _ in range(20)]


def spmv_inputs():
    rng = case_rng("spmv")
    ents = entries(rng)
    z = fq.encode([rnd(rng) for _ in range(3 * 8)]).reshape(3, 8, 16)
    return ents, z, fq.encode([rnd(rng) for _ in range(8)])


def sparse_eval_inputs():
    rng = case_rng("sparse_eval")
    ents = entries(rng)
    return (ents, fq.encode([rnd(rng) for _ in range(8)]),
            fq.encode([rnd(rng) for _ in range(8)]))


def instance_inputs():
    rng = case_rng("instance")
    rx = [rnd(rng) for _ in range(4)]
    ry = [rnd(rng) for _ in range(5)]
    z = fq.encode([rnd(rng) for _ in range(32)]).reshape(1, 1, 2, 16, 16)
    rx_tab = fq.encode([rnd(rng) for _ in range(16)])
    return rx, ry, z, rx_tab


# P = 3 instances of distinct 16 x 32 matrices executed [4, 2, 1] times
MULTI_PROOFS = [4, 2, 1]


def multi_inputs():
    """Each instance's A, B and C (entries), z (P, Q_max, W, Y) with W = 2,
    Y = 16, an eq table over the rows and the points (rx, ry)."""
    rng = case_rng("multi")
    mats = [[[(int(rng.integers(0, 16)), int(rng.integers(0, 32)), rnd(rng))
              for _ in range(int(rng.integers(1, 40)))] for _ in range(3)]
            for _ in range(3)]
    z = fq.encode([rnd(rng) for _ in range(3 * 4 * 32)]).reshape(
        3, 4, 2, 16, 16)
    rx_tab = fq.encode([rnd(rng) for _ in range(16)])
    return (mats, z, rx_tab, [rnd(rng) for _ in range(4)],
            [rnd(rng) for _ in range(5)])


def crowded_inputs():
    """A 16 x 16 matrix of 256 entries: 200 in column 0 and 40 in row 5."""
    rng = case_rng("crowded")
    ents = [(int(rng.integers(0, 16)), 0, rnd(rng)) for _ in range(200)]
    ents += [(5, int(rng.integers(1, 16)), rnd(rng)) for _ in range(40)]
    ents += [(int(rng.integers(0, 16)), int(rng.integers(1, 16)), rnd(rng))
             for _ in range(16)]
    z = fq.encode([rnd(rng) for _ in range(2 * 16)]).reshape(2, 16, 16)
    return (ents, z, fq.encode([rnd(rng) for _ in range(16)]),
            fq.encode([rnd(rng) for _ in range(16)]))


def jax_refs():
    import jax.numpy as jnp

    from spartan_parallel_tpu.core.field import Scalar as JScalar
    from spartan_parallel_tpu.models import r1csinstance as jri

    def j(a):
        return jnp.asarray(np.asarray(a).astype(np.uint32))

    out = {}
    ents, z, rx = spmv_inputs()
    jm = jri.SparseMatPolynomial(3, 3, ents)
    out["spmv"] = (np.asarray(jm.multiply_vec_batched(j(z), 8)),
                   np.asarray(jm.eval_table(j(rx), 8)))
    ents, rx, ry = sparse_eval_inputs()
    jm = jri.SparseMatPolynomial(3, 3, ents)
    out["sparse_eval"] = np.asarray(jm.evaluate_with_tables_dev(j(rx),
                                                                j(ry)))
    jinst, jv, ji = jri.produce_synthetic_r1cs(1, [1], 16, 16, 4, seed=3)
    rx, ry, z, rx_tab = instance_inputs()
    ev = jinst.evaluate([JScalar(x) for x in rx], [JScalar(x) for x in ry])
    out["instance"] = {
        "vars": jv, "inputs": ji, "digest": jinst.get_digest(),
        "evaluate": [int(x) for x in ev],
        "block": [np.asarray(a.Zm) for a in jinst.multiply_vec_block(
            1, [1], 1, [16], 16, 16, [16], j(z))],
        "eval_table": [np.asarray(a) for a in
                       jinst.compute_eval_table_sparse_disjoint_rounds(
                           1, [16], 2, 16, [16], j(rx_tab))[0]]}
    mats, z, rx_tab, rx, ry = multi_inputs()
    jinst = jri.R1CSInstance(3, 16, [16] * 3, 32, *zip(*mats))
    out["multi"] = {
        "block": [np.asarray(a.Zm) for a in jinst.multiply_vec_block(
            3, MULTI_PROOFS, 4, [16] * 3, 16, 16, [16] * 3, j(z))],
        "classed": [np.asarray(a) for a in jinst.multiply_vec_block_classed(
            1, 2, 16, j(z[1:3, :2]))],
        "eval_table": [[np.asarray(a) for a in t] for t in
                       jinst.compute_eval_table_sparse_disjoint_rounds(
                           3, [16] * 3, 2, 16, [16] * 3, j(rx_tab))],
        "evaluate": [int(x) for x in jinst.multi_evaluate(
            [JScalar(x) for x in rx], [JScalar(x) for x in ry])]}
    ents, z, rx, ry = crowded_inputs()
    jm = jri.SparseMatPolynomial(4, 4, ents)
    out["crowded"] = (np.asarray(jm.multiply_vec_batched(j(z), 16)),
                      np.asarray(jm.eval_table(j(rx), 16)),
                      np.asarray(jm.evaluate_with_tables_dev(j(rx), j(ry))))
    jinst, _, _ = jri.produce_synthetic_r1cs(1, [1], 16, 16, 4, seed=5)
    out["from_numpy"] = (
        [(np.asarray(m.rows), np.asarray(m.cols), m.vals)
         for m in (jinst.A_list[0], jinst.B_list[0], jinst.C_list[0])],
        jinst.get_digest())
    return out


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return shared_result(tmp_path_factory, "jax_spmv_refs",
                         lambda: in_fresh_process(jax_refs, timeout=900))


def test_spmv_and_eval_table_match_jax(jax_ref):
    ents, z, rx = spmv_inputs()
    tm = tri.SparseMatPolynomial(3, 3, ents)
    spmv, table = jax_ref["spmv"]
    assert same(spmv, tm.multiply_vec_batched(port(z)))
    assert same(table, tm.eval_table(port(rx)))


def test_sparse_eval_matches_jax(jax_ref):
    ents, rx, ry = sparse_eval_inputs()
    tm = tri.SparseMatPolynomial(3, 3, ents)
    assert same(jax_ref["sparse_eval"],
                tm.evaluate_with_tables(port(rx), port(ry)))


def test_instance_ops_match_jax(jax_ref):
    """The synthetic instance, its digest, Az/Bz/Cz, the phase-2 tables
    and the verifier's evaluations."""
    want = jax_ref["instance"]
    tinst, tv, ti = tri.produce_synthetic_r1cs(1, [1], 16, 16, 4, seed=3,
                                               device="cpu")
    assert want["vars"] == tv and want["inputs"] == ti
    assert want["digest"] == tinst.get_digest()

    rx, ry, z, rx_tab = instance_inputs()
    tev = tinst.evaluate([Scalar(x) for x in rx], [Scalar(x) for x in ry],
                         device="cpu")
    assert want["evaluate"] == [int(x) for x in tev]
    got = tinst.multiply_vec_block(1, [1], 1, [16], 16, 16, [16], port(z))
    assert len(got) == len(want["block"])
    for a, b in zip(want["block"], got):
        assert same(a, b.Zm)
    got = tinst.compute_eval_table_sparse_disjoint_rounds(
        1, [16], 2, 16, [16], port(rx_tab))[0]
    assert len(got) == len(want["eval_table"])
    for a, b in zip(want["eval_table"], got):
        assert same(a, b)


def _multi_instance():
    mats, z, rx_tab, rx, ry = multi_inputs()
    return tri.R1CSInstance(3, 16, [16] * 3, 32, *zip(*mats),
                            device="cpu"), z, rx_tab, rx, ry


def test_multiply_vec_block_distinct_instances_match_jax(jax_ref):
    """Three instances of distinct matrices, executed [4, 2, 1] times (the
    products of each written in place, q and x bit-reversed, the unused
    (p, q) slots zero)."""
    tinst, z, _, _, _ = _multi_instance()
    got = tinst.multiply_vec_block(3, MULTI_PROOFS, 4, [16] * 3, 16, 16,
                                   [16] * 3, port(z))
    assert len(got) == 3
    for a, b in zip(jax_ref["multi"]["block"], got):
        assert b.Zm.shape == (4, 4, 1, 16, 16)
        assert same(a, b.Zm)


def test_multiply_vec_block_classed_matches_jax(jax_ref):
    """One class: instances 1 and 2, two executions each."""
    tinst, z, _, _, _ = _multi_instance()
    got = tinst.multiply_vec_block_classed(1, 2, 16, port(z[1:3, :2]))
    assert len(got) == 3
    for a, b in zip(jax_ref["multi"]["classed"], got):
        assert same(a, b)


def test_eval_tables_and_multi_evaluate_match_jax(jax_ref):
    """The phase-2 tables and the verifier's evaluations of the same three
    instances."""
    tinst, _, rx_tab, rx, ry = _multi_instance()
    got = tinst.compute_eval_table_sparse_disjoint_rounds(
        3, [16] * 3, 2, 16, [16] * 3, port(rx_tab))
    want = jax_ref["multi"]["eval_table"]
    assert len(got) == len(want) == 3
    for wt, gt in zip(want, got):
        assert len(gt) == 3
        for a, b in zip(wt, gt):
            assert same(a, b)
    ev = tinst.multi_evaluate([Scalar(x) for x in rx],
                              [Scalar(x) for x in ry], device="cpu")
    assert [int(x) for x in ev] == jax_ref["multi"]["evaluate"]


def test_crowded_matrix_matches_jax(jax_ref):
    """200 of 256 entries in column 0 and 40 in row 5: Az, the column
    table and M(rx, ry) against the JAX per-matrix functions."""
    ents, z, rx, ry = crowded_inputs()
    tm = tri.SparseMatPolynomial(4, 4, ents)
    spmv, table, ev = jax_ref["crowded"]
    assert same(spmv, tm.multiply_vec_batched(port(z)))
    assert same(table, tm.eval_table(port(rx)))
    assert same(ev, tm.evaluate_with_tables(port(rx), port(ry)))


def test_instance_from_numpy_carries_the_jax_instance(jax_ref):
    mats, digest = jax_ref["from_numpy"]
    tinst = instance_from_numpy(16, 16, 4, *mats, device="cpu")
    assert tinst.get_digest() == digest


def test_matrix_rejects_out_of_range_indices():
    """The kernels index the z and eq tables with the matrix's rows and
    columns, so an index past the table is refused when the matrix is
    built."""
    with pytest.raises(ValueError):
        tri.SparseMatPolynomial(2, 2, [(0, 4, 1)])
    with pytest.raises(ValueError):
        tri.SparseMatPolynomial(2, 2, arrays=([-1], [0], [1]))
