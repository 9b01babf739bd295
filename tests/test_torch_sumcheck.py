"""K4 (sumcheck round kernels): the port's plain path against the JAX
package's ops/sumcheck.py p1_* / p2_* on the same inputs, for every mode,
including the live-length (n_half) semantics and the compaction at a mode
change. The JAX steps keep fixed-size buffers; the port's steps return
tables of the new live length along the bound axis, so their tables are
held against the JAX buffers' live region, and the JAX dead region must
be all zero: nothing of the JAX tables goes unchecked. Whole sumchecks
run round by round on both. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_parallel_tpu.core.consts import L
from spartan_parallel_tpu.ops import fq as jfq
from spartan_parallel_tpu.ops import sumcheck as jsck
from spartan_parallel_tpu_torch.ops import sumcheck as tsck

rng = np.random.default_rng(44)


def tab(*shape):
    """A random Montgomery table in both packages."""
    n = int(np.prod(shape))
    enc = jfq.encode([int.from_bytes(rng.bytes(40), "little") % L
                      for _ in range(n)]).reshape(shape + (16,))
    return jnp.asarray(enc), torch.from_numpy(enc.astype(np.int32))


def same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64),
                          t.numpy().astype(np.int64))


def all_same(js, ts):
    return len(js) == len(ts) and all(same(a, b) for a, b in zip(js, ts))


def live_same(j, t):
    """The port's table equals the JAX buffer's live region (its leading
    entries along each axis), and the rest of the buffer is zero."""
    j = np.asarray(j).astype(np.int64)
    live = tuple(slice(0, n) for n in t.shape)
    if any(a < b for a, b in zip(j.shape, t.shape)) or \
            not np.array_equal(j[live], t.numpy().astype(np.int64)):
        return False
    dead = j.copy()
    dead[live] = 0
    return not dead.any()


def all_live_same(js, ts):
    return len(js) == len(ts) and all(live_same(a, b)
                                      for a, b in zip(js, ts))


P1 = [(jsck.MODE_X, jsck.MODE_X, 2, 1), (jsck.MODE_X, jsck.MODE_Q, 1, 1),
      (jsck.MODE_Q, jsck.MODE_P, 1, 1)]


@pytest.mark.parametrize("mode_prev,mode,nh_prev,nh", P1)
def test_phase1_round_matches_jax(mode_prev, mode, nh_prev, nh):
    """(P, Q, X) = (2, 2, 4): evals, fused step and final bind."""
    tp, tq, tx = tab(2), tab(2), tab(4)
    B, C, D = tab(2, 2, 4), tab(2, 2, 4), tab(2, 2, 4)
    r = tab(1)
    if mode_prev == jsck.MODE_Q:  # x fully bound: compact as the loop does
        tx = (tx[0][:1], tx[1][:1])
        B, C, D = ((t[0][:, :, :1], t[1][:, :, :1]) for t in (B, C, D))
    js = [t[0] for t in (tp, tq, tx, B, C, D)]
    ts = [t[1] for t in (tp, tq, tx, B, C, D)]
    assert same(jsck.p1_evals(*js, np.uint32(nh_prev), mode=mode_prev),
                tsck.p1_evals(*ts, nh_prev, mode=mode_prev))
    jev, jtabs = jsck.p1_step(*js, r[0][0], np.uint32(nh_prev),
                              np.uint32(nh), mode_prev=mode_prev, mode=mode)
    tev, ttabs = tsck.p1_step(*ts, r[1][0], nh_prev, nh,
                              mode_prev=mode_prev, mode=mode)
    assert same(jev, tev)
    assert all_live_same(jtabs, ttabs)
    assert all_live_same(
        jsck.p1_bind(*jtabs, r[0][0], np.uint32(nh), mode=mode),
        tsck.p1_bind(*ttabs, r[1][0], nh, mode=mode))


P2 = [(jsck.MODE_X, jsck.MODE_X, 2, 1, False),
      (jsck.MODE_X, jsck.MODE_W, 1, 1, True),
      (jsck.MODE_W, jsck.MODE_P, 1, 1, False),
      (jsck.MODE_W, jsck.MODE_P, 1, 1, True)]


@pytest.mark.parametrize("mode_prev,mode,nh_prev,nh,single", P2)
def test_phase2_round_matches_jax(mode_prev, mode, nh_prev, nh, single):
    """(P, W, Y) = (2, 2, 4), ABC per instance or shared (single_inst)."""
    ep, Z = tab(2), tab(2, 2, 4)
    ABC = tab(1, 2, 4) if single else tab(2, 2, 4)
    r = tab(1)
    if mode_prev == jsck.MODE_W:
        Z = (Z[0][:, :, :1], Z[1][:, :, :1])
        ABC = (ABC[0][:, :, :1], ABC[1][:, :, :1])
    js = [t[0] for t in (ep, ABC, Z)]
    ts = [t[1] for t in (ep, ABC, Z)]
    assert same(jsck.p2_evals(*js, np.uint32(nh_prev), mode=mode_prev,
                              single_inst=single),
                tsck.p2_evals(*ts, nh_prev, mode=mode_prev,
                              single_inst=single))
    jev, jtabs = jsck.p2_step(*js, r[0][0], np.uint32(nh_prev),
                              np.uint32(nh), mode_prev=mode_prev, mode=mode,
                              single_inst=single)
    tev, ttabs = tsck.p2_step(*ts, r[1][0], nh_prev, nh,
                              mode_prev=mode_prev, mode=mode,
                              single_inst=single)
    assert same(jev, tev)
    assert all_live_same(jtabs, ttabs)
    assert all_live_same(jsck.p2_bind(*jtabs, r[0][0], np.uint32(nh),
                                      mode=mode, single_inst=single),
                         tsck.p2_bind(*ttabs, r[1][0], nh, mode=mode,
                                      single_inst=single))


def _whole(first, step, final, modes, live, compare):
    """A whole sumcheck on both packages: the first round's evaluations,
    then every fused step down to n_half = 1, then the final bind; the
    evaluations and the tables held after each round."""
    pending = None
    for mode in modes:
        nh = live[mode] // 2
        if pending is None:
            jev, tev = first(nh, mode)
        else:
            jev, tev = step(*pending, nh, mode)
        assert same(jev, tev)
        compare()
        pending = (tab(1), nh, mode)
        live[mode] //= 2
    final(*pending)
    compare()


def test_phase1_whole_sumcheck_matches_jax():
    """Phase 1 at (P, Q, X) = (2, 2, 4) (the round tests' shapes, whose
    JAX compiles it shares): two x rounds, one q round, one p round, each
    step against JAX p1_step, then the final bind."""
    M = jsck
    tabs = [tab(2), tab(2), tab(4), tab(2, 2, 4), tab(2, 2, 4),
            tab(2, 2, 4)]
    js, ts = [t[0] for t in tabs], [t[1] for t in tabs]

    def first(nh, mode):
        return (jsck.p1_evals(*js, np.uint32(nh), mode=mode),
                tsck.p1_evals(*ts, nh, mode=mode))

    def step(r, nh_prev, mode_prev, nh, mode):
        jev, js[:] = jsck.p1_step(*js, r[0][0], np.uint32(nh_prev),
                                  np.uint32(nh), mode_prev=mode_prev,
                                  mode=mode)
        tev, ts[:] = tsck.p1_step(*ts, r[1][0], nh_prev, nh,
                                  mode_prev=mode_prev, mode=mode)
        return jev, tev

    def final(r, nh, mode):
        js[:] = jsck.p1_bind(*js, r[0][0], np.uint32(nh), mode=mode)
        ts[:] = tsck.p1_bind(*ts, r[1][0], nh, mode=mode, out_len=nh)

    def compare():
        assert all_live_same(js, ts)

    _whole(first, step, final, [M.MODE_X] * 2 + [M.MODE_Q, M.MODE_P],
           {M.MODE_X: 4, M.MODE_Q: 2, M.MODE_P: 2}, compare)
    assert all(t.shape[:-1] == (1,) * (t.dim() - 1) for t in ts)


def test_phase2_whole_sumcheck_matches_jax():
    """Phase 2 at (P, W, Y) = (2, 2, 4) (the round tests' shapes), one ABC
    table per instance: two y rounds, one w round, one p round, each step
    against JAX p2_step, then the final bind (a shared ABC's steps: the
    round tests)."""
    M = jsck
    single = False
    tabs = [tab(2), tab(1 if single else 2, 2, 4), tab(2, 2, 4)]
    js, ts = [t[0] for t in tabs], [t[1] for t in tabs]

    def first(nh, mode):
        return (jsck.p2_evals(*js, np.uint32(nh), mode=mode,
                              single_inst=single),
                tsck.p2_evals(*ts, nh, mode=mode, single_inst=single))

    def step(r, nh_prev, mode_prev, nh, mode):
        jev, js[:] = jsck.p2_step(*js, r[0][0], np.uint32(nh_prev),
                                  np.uint32(nh), mode_prev=mode_prev,
                                  mode=mode, single_inst=single)
        tev, ts[:] = tsck.p2_step(*ts, r[1][0], nh_prev, nh,
                                  mode_prev=mode_prev, mode=mode,
                                  single_inst=single)
        return jev, tev

    def final(r, nh, mode):
        js[:] = jsck.p2_bind(*js, r[0][0], np.uint32(nh), mode=mode,
                             single_inst=single)
        ts[:] = tsck.p2_bind(*ts, r[1][0], nh, mode=mode,
                             single_inst=single, out_len=nh)

    def compare():
        assert all_live_same(js, ts)

    _whole(first, step, final, [M.MODE_X] * 2 + [M.MODE_W, M.MODE_P],
           {M.MODE_X: 4, M.MODE_W: 2, M.MODE_P: 2}, compare)
    assert ts[2].shape[:-1] == (1, 1, 1)


def test_rev_perm_matches_jax():
    for n in (1, 2, 8, 64):
        assert np.array_equal(jsck.rev_perm(n), tsck.rev_perm(n))


# (mode, active, S, p0): the three q-size classes of tests/test_r1cs.py's
# q-class proof (16 x 16 x 4, num_proofs [8, 2, 1]: eq tables tp 4, tq 8,
# tx 16) in a round where that proof runs them, so the JAX side reuses the
# compiles of that test when the persistent XLA cache holds them
PC = [(jsck.MODE_X, True, 4, 1), (jsck.MODE_Q, True, 1, 0),
      (jsck.MODE_Q, False, 8, 2)]


@pytest.mark.parametrize("mode,active,S,p0", PC)
def test_classed_round_matches_jax(mode, active, S, p0):
    """K5's plain path (pc_evals, pc_bind, the fused pc_step) and the
    shared eq_fold against the JAX package's fused pc_step (its pc_bind,
    then pc_evals: a same-mode step compacts nothing) and eq_fold."""
    tp, tq, tx = tab(4), tab(8), tab(16)
    qc = 8 // S if active else 1
    xc = 16 if mode == jsck.MODE_X else 1
    T = [tab(1, qc, xc) for _ in range(3)]
    r = tab(1)
    # n_half: the class's own when active, the global q one when inactive
    nh_prev, nh = ((8, 4) if mode == jsck.MODE_X else (qc // 2, qc // 4)) \
        if active else (4, 2)
    js = [t[0] for t in (tp, tq, tx, *T)]
    ts = [t[1] for t in (tp, tq, tx, *T)]
    jev, jtabs = jsck.pc_step(*js, r[0][0], np.uint32(nh_prev),
                              np.uint32(nh), mode_prev=mode, mode=mode,
                              p0=p0, S=S, active_prev=active, active=active)
    tabs = tsck.pc_bind(*ts[3:], r[1][0], nh_prev, mode, active)
    assert all_same(jtabs, tabs)
    assert same(jev, tsck.pc_evals(*ts[:3], *tabs, nh, mode, p0, S, active))
    tev, ttabs = tsck.pc_step(*ts, r[1][0], nh_prev, nh, mode_prev=mode,
                              mode=mode, p0=p0, S=S, active_prev=active,
                              active=active)
    assert same(jev, tev)
    assert all_same(jtabs, ttabs)
    eq = tx if mode == jsck.MODE_X else tq
    assert same(jsck.eq_fold(eq[0], r[0][0], np.uint32(nh_prev)),
                tsck.eq_fold(eq[1], r[1][0], nh_prev))


def test_dense_pqx_binds_match_jax():
    """DensePolynomialPqx (custom_mlpoly.py): the q bind and the full
    evaluation at (rp, rq, rw, rx) on a (P, Q, W, Y) = (2, 4, 2, 4) table
    with ragged live regions."""
    from spartan_parallel_tpu.core.field import Scalar as JScalar
    from spartan_parallel_tpu.models.custom_mlpoly import (
        DensePolynomialPqx as JPqx,
    )
    from spartan_parallel_tpu_torch.core.field import Scalar
    from spartan_parallel_tpu_torch.models.custom_mlpoly import (
        DensePolynomialPqx,
    )

    Z = tab(2, 4, 2, 4)
    rs = [int.from_bytes(rng.bytes(40), "little") % L for _ in range(6)]
    rp, rq, rw, rx = rs[:1], rs[1:3], rs[3:4], rs[4:6]
    j = JPqx(Z[0], [4, 2], [4, 2])
    t = DensePolynomialPqx(Z[1], [4, 2], [4, 2])
    ev_j = j.evaluate(*([JScalar(v) for v in g] for g in (rp, rq, rw, rx)))
    ev_t = t.evaluate(*([Scalar(v) for v in g] for g in (rp, rq, rw, rx)))
    assert int(ev_j) == int(ev_t)
    j.bound_poly_vars_rq([JScalar(v) for v in rq])
    t.bound_poly_vars_rq([Scalar(v) for v in rq])
    assert same(j.Zm, t.Zm) and j.num_proofs == t.num_proofs == [1, 1]
    # natural-order lists in, bit-reversed storage, flattening back out
    z = [[[[int.from_bytes(rng.bytes(40), "little") % L for _ in range(ni)]
           for _ in range(2)] for _ in range(q)]
         for q, ni in ((4, 4), (2, 2))]
    j = JPqx.new_rev(z, [4, 2], 4, [4, 2], 4)
    t = DensePolynomialPqx.new_rev(z, [4, 2], 4, [4, 2], 4, "cpu")
    assert same(j.Zm, t.Zm)
    assert int(j.index(1, 1, 1, 1)) == int(t.index(1, 1, 1, 1))
    assert same(j.to_dense_poly().Zm, t.to_dense_poly().Zm)
