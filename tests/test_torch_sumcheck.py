"""K4 and K5 (sumcheck round kernels): the port's plain path against the
JAX package's ops/sumcheck.py p1_* / p2_* / pc_* on the same inputs, for
every mode, including the live-length (n_half) semantics and the
compaction at a mode change. The JAX steps keep fixed-size buffers; the
port's steps return tables of the new live length along the bound axis,
so their tables are held against the JAX buffers' live region, and the
JAX dead region must be all zero: nothing of the JAX tables goes
unchecked. Whole sumchecks run round by round on both. K5's round of
every class at once (pc_round, the classed prover's entry) is held
against the JAX pc_step of each class, stacked. Every JAX value of the
file is computed once a run, a group of cases (the key's first part) in a
fresh process of its own whose result the pytest-xdist workers share
(`jax_refs`): a worker waits only for its case's group, and the groups
of a cold run compile side by side. Each case draws its inputs from a
seed of its own. Tolerance: exact equality."""

import numpy as np
import pytest
import torch

from spartan_parallel_tpu_torch.core.consts import L
from spartan_parallel_tpu_torch.ops import fq
from spartan_parallel_tpu_torch.ops import sumcheck as tsck

from .torch_shared import case_rng, in_fresh_process, shared_result

X, Q, W, P_ = tsck.MODE_X, tsck.MODE_Q, tsck.MODE_W, tsck.MODE_P


def tabs_of(rng, *shapes):
    """Random Montgomery tables (int32 numpy) of the given shapes."""
    out = []
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(fq.encode([int.from_bytes(rng.bytes(40), "little") % L
                              for _ in range(n)]).reshape(shape + (16,)))
    return out


def port(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


def same(want, got):
    return np.array_equal(np.asarray(want).astype(np.int64),
                          got.numpy().astype(np.int64))


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


P1 = [(X, X, 2, 1), (X, Q, 1, 1), (Q, P_, 1, 1)]
P2 = [(X, X, 2, 1, False), (X, W, 1, 1, True), (W, P_, 1, 1, False),
      (W, P_, 1, 1, True)]
# (mode, active, S, p0): the three q-size classes of tests/test_r1cs.py's
# q-class proof (16 x 16 x 4, num_proofs [8, 2, 1]: eq tables tp 4, tq 8,
# tx 16) in a round where that proof runs them
PC = [(X, True, 4, 1), (Q, True, 1, 0), (Q, False, 8, 2)]
# rounds of all three classes of that proof at once (pc_round): the PC
# cases one class at a time, a q round with n_half 4 -> 2 (the first
# class binds and evaluates q, the second changes to inactive, the third
# scales) and the round after the x rounds (x -> q: the first two classes
# active, the third inactive)
CLASSES = ((8, 1, 0), (2, 4, 1), (1, 8, 2))  # (Q_c, S, p0)
ALL = ["pc0", "pc1", "pc2", "mixed_q", "x_to_q"]


# --------------------------------------------------------------------------
# Each case's inputs
# --------------------------------------------------------------------------
def p1_inputs(case):
    mode_prev = case[0]
    tp, tq, tx, B, C, D, r = tabs_of(case_rng("p1", case), (2,), (2,), (4,),
                                     (2, 2, 4), (2, 2, 4), (2, 2, 4), (1,))
    if mode_prev == Q:  # x fully bound: compact as the loop does
        tx, B, C, D = tx[:1], B[:, :, :1], C[:, :, :1], D[:, :, :1]
    return [tp, tq, tx, B, C, D], r


def p2_inputs(case):
    mode_prev, single = case[0], case[4]
    ep, Z, ABC, r = tabs_of(case_rng("p2", case), (2,), (2, 2, 4),
                            (1, 2, 4) if single else (2, 2, 4), (1,))
    if mode_prev == W:
        Z, ABC = Z[:, :, :1], ABC[:, :, :1]
    return [ep, ABC, Z], r


WHOLE = {"p1": ([X] * 2 + [Q, P_], {X: 4, Q: 2, P_: 2}),
         "p2": ([X] * 2 + [W, P_], {X: 4, W: 2, P_: 2})}


def whole_inputs(phase):
    """The tables and the challenge of each round (one a round)."""
    rng = case_rng("whole", phase)
    shapes = [(2,), (2,), (4,), (2, 2, 4), (2, 2, 4), (2, 2, 4)] \
        if phase == "p1" else [(2,), (2, 2, 4), (2, 2, 4)]
    tabs = tabs_of(rng, *shapes)
    return tabs, tabs_of(rng, *[(1,)] * len(WHOLE[phase][0]))


def pc_inputs(case):
    mode, active, S, p0 = case
    qc = 8 // S if active else 1
    xc = 16 if mode == X else 1
    tabs = tabs_of(case_rng("pc", case), (4,), (8,), (16,), (1, qc, xc),
                   (1, qc, xc), (1, qc, xc), (1,))
    # n_half: the class's own when active, the global q one when inactive
    nh_prev, nh = ((8, 4) if mode == X else (qc // 2, qc // 4)) \
        if active else (4, 2)
    return tabs[:6], tabs[6], nh_prev, nh


def all_inputs(case):
    """(eq tables, each class's (B, C, D), r, mode_prev, mode, the global
    n_half before and now, the classes' (p0, S))."""
    if case.startswith("pc"):
        mode, active, S, p0 = PC[int(case[2])]
        tabs, r, nh_prev, nh = pc_inputs(PC[int(case[2])])
        glob = (nh_prev * S, nh * S) if mode == Q and active else \
            (nh_prev, nh)
        return tabs[:3], [tuple(tabs[3:])], r, mode, mode, *glob, [(p0, S)]
    rng = case_rng("all", case)
    eqs = tabs_of(rng, (4,), (8,), (16,))
    if case == "mixed_q":  # live q lengths after the round of n_half 4
        shapes = [(1, 8, 1), (1, 2, 1), (1, 1, 1)]
        mode_prev, nh_prev, nh = Q, 4, 2
    else:  # two x entries left of each row
        shapes = [(1, 8, 2), (1, 2, 2), (1, 1, 2)]
        mode_prev, nh_prev, nh = X, 1, 4
    classes = [tuple(tabs_of(rng, s, s, s)) for s in shapes]
    r = tabs_of(rng, (1,))[0]
    return eqs, classes, r, mode_prev, Q, nh_prev, nh, \
        [(p0, S) for _, S, p0 in CLASSES]


def pqx_inputs():
    rng = case_rng("pqx")
    Z, = tabs_of(rng, (2, 4, 2, 4))
    rs = [int.from_bytes(rng.bytes(40), "little") % L for _ in range(6)]
    z = [[[[int.from_bytes(rng.bytes(40), "little") % L for _ in range(ni)]
           for _ in range(2)] for _ in range(q)]
         for q, ni in ((4, 4), (2, 2))]
    return Z, rs, z


# --------------------------------------------------------------------------
# The JAX values, one fresh process a group a run
# --------------------------------------------------------------------------
def jax_refs(group):
    import jax.numpy as jnp

    from spartan_parallel_tpu.core.field import Scalar as JScalar
    from spartan_parallel_tpu.models.custom_mlpoly import (
        DensePolynomialPqx as JPqx,
    )
    from spartan_parallel_tpu.ops import sumcheck as jsck

    def j(a):
        return jnp.asarray(np.asarray(a).astype(np.uint32))

    def npy(ts):
        return [np.asarray(t) for t in ts]

    u32 = np.uint32
    out = {}
    if group == "p1":
        for case in P1:
            mode_prev, mode, nh_prev, nh = case
            tabs, r = p1_inputs(case)
            js = [j(t) for t in tabs]
            rj = j(r)[0]
            ev0 = jsck.p1_evals(*js, u32(nh_prev), mode=mode_prev)
            jev, jtabs = jsck.p1_step(*js, rj, u32(nh_prev), u32(nh),
                                      mode_prev=mode_prev, mode=mode)
            out["p1", case] = (np.asarray(ev0), np.asarray(jev), npy(jtabs),
                               npy(jsck.p1_bind(*jtabs, rj, u32(nh),
                                                mode=mode)))
    if group == "p2":
        for case in P2:
            mode_prev, mode, nh_prev, nh, single = case
            tabs, r = p2_inputs(case)
            js = [j(t) for t in tabs]
            rj = j(r)[0]
            ev0 = jsck.p2_evals(*js, u32(nh_prev), mode=mode_prev,
                                single_inst=single)
            jev, jtabs = jsck.p2_step(*js, rj, u32(nh_prev), u32(nh),
                                      mode_prev=mode_prev, mode=mode,
                                      single_inst=single)
            out["p2", case] = (np.asarray(ev0), np.asarray(jev), npy(jtabs),
                               npy(jsck.p2_bind(*jtabs, rj, u32(nh), mode=mode,
                                                single_inst=single)))
    if group == "whole":
        for phase, (modes, live0) in WHOLE.items():
            tabs, rs = whole_inputs(phase)
            js = [j(t) for t in tabs]
            kw = {} if phase == "p1" else {"single_inst": False}
            evals_, bind_, step_ = (
                (jsck.p1_evals, jsck.p1_bind, jsck.p1_step) if phase == "p1"
                else (jsck.p2_evals, jsck.p2_bind, jsck.p2_step))
            live, pending, rounds = dict(live0), None, []
            for k, mode in enumerate(modes):
                nh = live[mode] // 2
                if pending is None:
                    ev = evals_(*js, u32(nh), mode=mode, **kw)
                else:
                    ev, js = step_(*js, j(pending[0])[0], u32(pending[1]),
                                   u32(nh), mode_prev=pending[2], mode=mode,
                                   **kw)
                rounds.append((np.asarray(ev), npy(js)))
                pending = (rs[k], nh, mode)
                live[mode] //= 2
            js = bind_(*js, j(pending[0])[0], u32(pending[1]), mode=pending[2],
                       **kw)
            out["whole", phase] = (rounds, npy(js))
    if group == "rev_perm":
        out["rev_perm"] = {n: jsck.rev_perm(n) for n in (1, 2, 8, 64)}
    if group == "pc":
        for case in PC:
            mode, active, S, p0 = case
            tabs, r, nh_prev, nh = pc_inputs(case)
            js = [j(t) for t in tabs]
            rj = j(r)[0]
            jev, jtabs = jsck.pc_step(*js, rj, u32(nh_prev), u32(nh),
                                      mode_prev=mode, mode=mode, p0=p0, S=S,
                                      active_prev=active, active=active)
            eq = js[2] if mode == X else js[1]
            out["pc", case] = (np.asarray(jev), npy(jtabs),
                               np.asarray(jsck.eq_fold(eq, rj, u32(nh_prev))))
    if group == "all":
        for case in ALL:
            eqs, classes, r, mode_prev, mode, nh_prev, nh, pos = \
                all_inputs(case)
            js = [j(t) for t in eqs]
            rj = j(r)[0]
            evs, tabs = [], []
            for T, (p0, S) in zip(classes, pos):
                nhp, actp = tsck.pc_class_state(nh_prev, mode_prev, S)
                nhc, act = tsck.pc_class_state(nh, mode, S)
                ev, T = jsck.pc_step(*js, *(j(t) for t in T), rj, u32(nhp),
                                     u32(nhc), mode_prev=mode_prev, mode=mode,
                                     p0=p0, S=S, active_prev=actp, active=act)
                evs.append(ev)
                tabs.append(npy(T))
            out["all", case] = (np.asarray(jnp.stack(evs)), tabs)
    if group == "pqx":
        Z, rs, z = pqx_inputs()
        rp, rq, rw, rx = rs[:1], rs[1:3], rs[3:4], rs[4:6]
        jp = JPqx(j(Z), [4, 2], [4, 2])
        ev = jp.evaluate(*([JScalar(v) for v in g]
                           for g in (rp, rq, rw, rx)))
        jp.bound_poly_vars_rq([JScalar(v) for v in rq])
        bound = (np.asarray(jp.Zm), list(jp.num_proofs))
        jp = JPqx.new_rev(z, [4, 2], 4, [4, 2], 4)
        out["pqx"] = (int(ev), bound, np.asarray(jp.Zm),
                      int(jp.index(1, 1, 1, 1)),
                      np.asarray(jp.to_dense_poly().Zm))
    return out


class JaxRefs:
    """jax_refs by key, each group computed on first use (once a run)."""

    def __init__(self, tmp_path_factory):
        self.tmp = tmp_path_factory
        self.groups = {}

    def __getitem__(self, key):
        group = key[0] if isinstance(key, tuple) else key
        if group not in self.groups:
            self.groups[group] = shared_result(
                self.tmp, "jax_sumcheck_" + group,
                lambda: in_fresh_process(jax_refs, group, timeout=1200))
        return self.groups[group][key]


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    return JaxRefs(tmp_path_factory)


# --------------------------------------------------------------------------
# The port against them
# --------------------------------------------------------------------------
@pytest.mark.parametrize("mode_prev,mode,nh_prev,nh", P1)
def test_phase1_round_matches_jax(jax_ref, mode_prev, mode, nh_prev, nh):
    """(P, Q, X) = (2, 2, 4): evals, fused step and final bind."""
    tabs, r = p1_inputs((mode_prev, mode, nh_prev, nh))
    ts, r = [port(t) for t in tabs], port(r)[0]
    ev0, jev, jtabs, jbound = jax_ref["p1", (mode_prev, mode, nh_prev, nh)]
    assert same(ev0, tsck.p1_evals(*ts, nh_prev, mode=mode_prev))
    tev, ttabs = tsck.p1_step(*ts, r, nh_prev, nh, mode_prev=mode_prev,
                              mode=mode)
    assert same(jev, tev)
    assert all_live_same(jtabs, ttabs)
    assert all_live_same(jbound, tsck.p1_bind(*ttabs, r, nh, mode=mode))


@pytest.mark.parametrize("mode_prev,mode,nh_prev,nh,single", P2)
def test_phase2_round_matches_jax(jax_ref, mode_prev, mode, nh_prev, nh,
                                  single):
    """(P, W, Y) = (2, 2, 4), ABC per instance or shared (single_inst)."""
    case = (mode_prev, mode, nh_prev, nh, single)
    tabs, r = p2_inputs(case)
    ts, r = [port(t) for t in tabs], port(r)[0]
    ev0, jev, jtabs, jbound = jax_ref["p2", case]
    assert same(ev0, tsck.p2_evals(*ts, nh_prev, mode=mode_prev,
                                   single_inst=single))
    tev, ttabs = tsck.p2_step(*ts, r, nh_prev, nh, mode_prev=mode_prev,
                              mode=mode, single_inst=single)
    assert same(jev, tev)
    assert all_live_same(jtabs, ttabs)
    assert all_live_same(jbound, tsck.p2_bind(*ttabs, r, nh, mode=mode,
                                              single_inst=single))


def _whole(jax_ref, phase, first, step, final):
    """A whole sumcheck on the port against the JAX rounds: the first
    round's evaluations, then every fused step down to n_half = 1, then
    the final bind; the evaluations and the tables held after each
    round."""
    modes, live = WHOLE[phase][0], dict(WHOLE[phase][1])
    rounds, jfinal = jax_ref["whole", phase]
    _, rs = whole_inputs(phase)
    pending, ts = None, None
    for k, mode in enumerate(modes):
        nh = live[mode] // 2
        tev, ts = first(nh, mode) if pending is None else \
            step(*pending, nh, mode)
        assert same(rounds[k][0], tev)
        assert all_live_same(rounds[k][1], ts)
        pending = (port(rs[k])[0], nh, mode)
        live[mode] //= 2
    ts = final(*pending)
    assert all_live_same(jfinal, ts)
    return ts


def test_phase1_whole_sumcheck_matches_jax(jax_ref):
    """Phase 1 at (P, Q, X) = (2, 2, 4) (the round tests' shapes): two x
    rounds, one q round, one p round, each step against JAX p1_step, then
    the final bind."""
    ts = [port(t) for t in whole_inputs("p1")[0]]

    def first(nh, mode):
        return tsck.p1_evals(*ts, nh, mode=mode), ts

    def step(r, nh_prev, mode_prev, nh, mode):
        tev, ts[:] = tsck.p1_step(*ts, r, nh_prev, nh, mode_prev=mode_prev,
                                  mode=mode)
        return tev, ts

    def final(r, nh, mode):
        return tsck.p1_bind(*ts, r, nh, mode=mode, out_len=nh)

    out = _whole(jax_ref, "p1", first, step, final)
    assert all(t.shape[:-1] == (1,) * (t.dim() - 1) for t in out)


def test_phase2_whole_sumcheck_matches_jax(jax_ref):
    """Phase 2 at (P, W, Y) = (2, 2, 4) (the round tests' shapes), one ABC
    table per instance: two y rounds, one w round, one p round, each step
    against JAX p2_step, then the final bind (a shared ABC's steps: the
    round tests)."""
    ts = [port(t) for t in whole_inputs("p2")[0]]

    def first(nh, mode):
        return tsck.p2_evals(*ts, nh, mode=mode, single_inst=False), ts

    def step(r, nh_prev, mode_prev, nh, mode):
        tev, ts[:] = tsck.p2_step(*ts, r, nh_prev, nh, mode_prev=mode_prev,
                                  mode=mode, single_inst=False)
        return tev, ts

    def final(r, nh, mode):
        return tsck.p2_bind(*ts, r, nh, mode=mode, single_inst=False,
                            out_len=nh)

    out = _whole(jax_ref, "p2", first, step, final)
    assert out[2].shape[:-1] == (1, 1, 1)


def test_rev_perm_matches_jax(jax_ref):
    for n in (1, 2, 8, 64):
        assert np.array_equal(jax_ref["rev_perm"][n], tsck.rev_perm(n))


@pytest.mark.parametrize("mode,active,S,p0", PC)
def test_classed_round_matches_jax(jax_ref, mode, active, S, p0):
    """K5's plain path (pc_evals, pc_bind, the fused pc_step) and the
    shared eq_fold against the JAX package's fused pc_step (its pc_bind,
    then pc_evals: a same-mode step compacts nothing) and eq_fold; the
    step's tables are of the live length."""
    tabs, r, nh_prev, nh = pc_inputs((mode, active, S, p0))
    ts, r = [port(t) for t in tabs], port(r)[0]
    jev, jtabs, jeq = jax_ref["pc", (mode, active, S, p0)]
    bound = tsck.pc_bind(*ts[3:], r, nh_prev, mode, active)
    assert all_same(jtabs, bound)
    assert same(jev, tsck.pc_evals(*ts[:3], *bound, nh, mode, p0, S, active))
    tev, ttabs = tsck.pc_step(*ts, r, nh_prev, nh, mode_prev=mode,
                              mode=mode, p0=p0, S=S, active_prev=active,
                              active=active)
    assert same(jev, tev)
    assert all_live_same(jtabs, ttabs)
    eq = ts[2] if mode == X else ts[1]
    assert same(jeq, tsck.eq_fold(eq, r, nh_prev))


@pytest.mark.parametrize("case", ALL)
def test_all_classes_round_matches_jax(jax_ref, case):
    """pc_round (the classed prover's entry: one K5 launch for every
    class on the card; here its plain version) against the JAX pc_step of
    each class, stacked: the PC cases one class at a time, a q round that
    mixes an active class, one that changes to inactive and one that
    scales, and the first q round after the x rounds."""
    eqs, classes, r, mode_prev, mode, nh_prev, nh, pos = all_inputs(case)
    jev, jtabs = jax_ref["all", case]
    Ss = [S for _, S in pos]
    before = [tsck.pc_class_state(nh_prev, mode_prev, S) for S in Ss]
    now = [tsck.pc_class_state(nh, mode, S) for S in Ss]
    ev, tabs, nhs, acts = tsck.pc_round(
        *(port(t) for t in eqs), [tuple(port(t) for t in T)
                                  for T in classes],
        [p0 for p0, _ in pos], Ss, nh, mode,
        (port(r)[0], mode_prev, [s[0] for s in before],
         [s[1] for s in before]))
    assert ev.shape == (len(classes), 3, 16)
    assert same(jev, ev)
    assert all(all_live_same(j, t) for j, t in zip(jtabs, tabs))
    assert nhs == [s[0] for s in now] and acts == [s[1] for s in now]


def test_dense_pqx_binds_match_jax(jax_ref):
    """DensePolynomialPqx (custom_mlpoly.py): the q bind and the full
    evaluation at (rp, rq, rw, rx) on a (P, Q, W, Y) = (2, 4, 2, 4) table
    with ragged live regions; natural-order lists in, bit-reversed
    storage, flattening back out."""
    from spartan_parallel_tpu_torch.core.field import Scalar
    from spartan_parallel_tpu_torch.models.custom_mlpoly import (
        DensePolynomialPqx,
    )

    Z, rs, z = pqx_inputs()
    ev, (bound, num_proofs), rev, idx, flat = jax_ref["pqx"]
    rp, rq, rw, rx = rs[:1], rs[1:3], rs[3:4], rs[4:6]
    t = DensePolynomialPqx(port(Z), [4, 2], [4, 2])
    ev_t = t.evaluate(*([Scalar(v) for v in g] for g in (rp, rq, rw, rx)))
    assert ev == int(ev_t)
    t.bound_poly_vars_rq([Scalar(v) for v in rq])
    assert same(bound, t.Zm) and num_proofs == t.num_proofs == [1, 1]
    t = DensePolynomialPqx.new_rev(z, [4, 2], 4, [4, 2], 4, "cpu")
    assert same(rev, t.Zm)
    assert idx == int(t.index(1, 1, 1, 1))
    assert same(flat, t.to_dense_poly().Zm)
