"""Sumcheck round kernels for the two R1CS sumchecks (K4, K5).

Counterpart of the JAX package's ops/sumcheck.py (dense p1_*, p2_*,
fold_chain, and the q-size-classed eq_fold, pc_*). Same layout: phase-1
tables are (P, Q, X, 16) with q and x bit-reversed, phase-2 tables
(P, W, Y, 16) with y bit-reversed; eq tables stay factored per axis.
`n_half` is half the live length along the axis being bound, and the
region past the live length is the field zero.

The JAX package keeps every buffer at its size for the whole sumcheck
(XLA sees static shapes). Here the steps of K4's sumchecks (`p1_step`,
`p2_step`, plain and on the card alike) return tables of the new live
length along the axis they bound, so the next round reads and writes only
live entries; `p1_bind` / `p2_bind` keep the buffer's length unless given
`out_len`. So do K5's class steps (`pc_step`, `pc_round`); `pc_bind`
keeps the buffer's length.

`p1_evals` / `p1_step` and `p2_evals` / `p2_step` launch K4
(csrc/sumcheck.cu) on CUDA tensors: a step whose previous round bound the
same axis runs as one fused kernel; at an axis change it binds through K1
and then evaluates. `pc_round` launches K5 once for a round of every
q-size class, each class's bind (same axis, axis change, change of
activity or the inactive scale) fused into it; `pc_evals` / `pc_step` are
K5 with one class. Binds, `eq_fold` and `pc_bind` go through K1
(ops/fq.py). CPU tensors take the *_plain versions. Bound on the card by
bytes (every live table entry read once per round), see
csrc/sumcheck.cu.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import fq, kernels
from . import limbs as lb

MODE_P = 1
MODE_Q = 2
MODE_W = 3
MODE_X = 4

_P1_AXIS = {MODE_X: 2, MODE_Q: 1, MODE_P: 0}
_P2_AXIS = {MODE_X: 2, MODE_W: 1, MODE_P: 0}
# launch counts per table axis: the x (y) rounds keep the first slice's
# names, the q, w and p rounds of the data-parallel proof count apart
_P1_COUNTER = {2: "sc_p1_round", 1: "sc_p1_round_q", 0: "sc_p1_round_p"}
_P2_COUNTER = {2: "sc_p2_round", 1: "sc_p2_round_w", 0: "sc_p2_round_p"}


def rev_bits(x: int, size: int) -> int:
    """Bit-reverse x within log2(size) bits (custom_dense_mlpoly.rs:38-43)."""
    nbits = size.bit_length() - 1
    out = 0
    for i in range(nbits):
        out = (out << 1) | ((x >> i) & 1)
    return out


def rev_perm(size: int) -> np.ndarray:
    """Self-inverse permutation p with p[s] = rev_bits(s)."""
    nbits = size.bit_length() - 1
    idx = np.arange(size, dtype=np.int64)
    out = np.zeros(size, dtype=np.int64)
    for i in range(nbits):
        out = (out << 1) | ((idx >> i) & 1)
    return out


def fold_chain(T: torch.Tensor, rs: torch.Tensor, axis: int) -> torch.Tensor:
    """Bind len(rs) variables along `axis` in order (K1 binds); the live
    prefix of length n >> k ends at index 0 of the full-size buffer."""
    n = T.shape[axis]
    for i in range(rs.shape[0]):
        T = fq.bind(T, rs[i], axis, n >> (i + 1))
    return T


# --------------------------------------------------------------------------
# Plain versions
# --------------------------------------------------------------------------
def _lohi(t: torch.Tensor, axis: int, n_half: int):
    return t.narrow(axis, 0, n_half), t.narrow(axis, n_half, n_half)


def _ext2(lo, hi):
    """table extrapolated to the point 2: 2 hi - lo."""
    return fq.sub_plain(fq.add_plain(hi, hi), lo)


def _ext3(e2, lo, hi):
    """the point 3 from the point 2: e2 + (hi - lo)."""
    return fq.add_plain(e2, fq.sub_plain(hi, lo))


def _total(t: torch.Tensor) -> torch.Tensor:
    return fq.sum_plain(t.reshape(-1, 16), 0)


def p1_evals_plain(tp, tq, tx, B, C, D, n_half: int, mode: int):
    """Round-poly evaluations (e0, e2, e3) of eq_p eq_q eq_x (B C - D) as a
    (3, 16) Montgomery tensor."""
    axis = _P1_AXIS[mode]
    n_half = int(n_half)
    Bl, Bh = _lohi(B, axis, n_half)
    Cl, Ch = _lohi(C, axis, n_half)
    Dl, Dh = _lohi(D, axis, n_half)
    eqs = [tp, tq, tx]
    el, eh = _lohi(eqs[axis], 0, n_half)

    def contract(b, c, d, efold):
        fac = [t.reshape(s) for t, s in zip(
            eqs, ((-1, 1, 1, 16), (1, -1, 1, 16), (1, 1, -1, 16)))]
        shape = [1, 1, 1, 16]
        shape[axis] = -1
        fac[axis] = efold.reshape(shape)
        w = fq.mul_plain(fq.mul_plain(fac[0], fac[1]), fac[2])
        g = fq.sub_plain(fq.mul_plain(b, c), d)
        return _total(fq.mul_plain(g, w))

    e0 = contract(Bl, Cl, Dl, el)
    B2, C2, D2, t2 = _ext2(Bl, Bh), _ext2(Cl, Ch), _ext2(Dl, Dh), \
        _ext2(el, eh)
    e2 = contract(B2, C2, D2, t2)
    e3 = contract(_ext3(B2, Bl, Bh), _ext3(C2, Cl, Ch), _ext3(D2, Dl, Dh),
                  _ext3(t2, el, eh))
    return torch.stack([e0, e2, e3])


def p1_bind(tp, tq, tx, B, C, D, r, n_half: int, mode: int,
            out_len: int | None = None):
    """Bind the round's variable to r in every phase-1 table (K1); the
    bound axis keeps its length, or has out_len entries."""
    axis = _P1_AXIS[mode]
    n_half = int(n_half)
    B, C, D = (fq.bind(t, r, axis, n_half, out_len) for t in (B, C, D))
    eqs = [tp, tq, tx]
    eqs[axis] = fq.bind(eqs[axis], r, 0, n_half, out_len)
    return (*eqs, B, C, D)


def _p1_compact(tp, tq, tx, B, C, D, mode: int):
    """Fully bound axes collapse to length 1 at a mode change."""
    if mode != MODE_X and tx.shape[0] > 1:
        tx, B, C, D = tx[:1], B[:, :, :1], C[:, :, :1], D[:, :, :1]
    if mode == MODE_P and tq.shape[0] > 1:
        tq, B, C, D = tq[:1], B[:, :1], C[:, :1], D[:, :1]
    return tuple(t.contiguous() for t in (tp, tq, tx, B, C, D))


def p1_step_plain(tp, tq, tx, B, C, D, r_prev, n_half_prev, n_half,
                  mode_prev: int, mode: int):
    """The previous round's bind, to the new live length n_half_prev along
    its axis, then this round's evaluations; returns (evals, tables)."""
    tabs = p1_bind(tp, tq, tx, B, C, D, r_prev, n_half_prev, mode_prev,
                   int(n_half_prev))
    tabs = _p1_compact(*tabs, mode)
    return p1_evals_plain(*tabs, n_half, mode), tabs


def p2_evals_plain(ep, ABC, Z, n_half: int, mode: int, single_inst: bool):
    """(e0, e2, e3) of eq_p ABC Z as a (3, 16) Montgomery tensor; ABC may
    hold one instance shared by every p."""
    axis = _P2_AXIS[mode]
    n_half = int(n_half)
    Zl, Zh = _lohi(Z, axis, n_half)
    if mode == MODE_P and single_inst:
        Al = Ah = ABC
    else:
        Al, Ah = _lohi(ABC, axis, n_half)
    if mode == MODE_P:
        el, eh = _lohi(ep, 0, n_half)
    else:
        el = eh = ep

    def contract(a, z, e):
        m = fq.mul_plain(fq.mul_plain(a, z), e.reshape(-1, 1, 1, 16))
        return _total(m)

    e0 = contract(Al, Zl, el)
    A2, Z2, t2 = _ext2(Al, Ah), _ext2(Zl, Zh), _ext2(el, eh)
    e2 = contract(A2, Z2, t2)
    e3 = contract(_ext3(A2, Al, Ah), _ext3(Z2, Zl, Zh), _ext3(t2, el, eh))
    return torch.stack([e0, e2, e3])


def p2_bind(ep, ABC, Z, r, n_half: int, mode: int, single_inst: bool,
            out_len: int | None = None):
    """Bind the round's variable to r in every phase-2 table (K1); the
    bound axis keeps its length, or has out_len entries."""
    axis = _P2_AXIS[mode]
    n_half = int(n_half)
    Z = fq.bind(Z, r, axis, n_half, out_len)
    if not (mode == MODE_P and single_inst):
        ABC = fq.bind(ABC, r, axis, n_half, out_len)
    if mode == MODE_P:
        ep = fq.bind(ep, r, 0, n_half, out_len)
    return ep, ABC, Z


def _p2_compact(ep, ABC, Z, mode: int):
    if mode != MODE_X and Z.shape[2] > 1:
        Z, ABC = Z[:, :, :1], ABC[:, :, :1]
    if mode == MODE_P and Z.shape[1] > 1:
        Z, ABC = Z[:, :1], ABC[:, :1]
    return ep, ABC.contiguous(), Z.contiguous()


def p2_step_plain(ep, ABC, Z, r_prev, n_half_prev, n_half, mode_prev: int,
                  mode: int, single_inst: bool):
    """As p1_step_plain, for phase 2."""
    tabs = p2_bind(ep, ABC, Z, r_prev, n_half_prev, mode_prev, single_inst,
                   int(n_half_prev))
    tabs = _p2_compact(*tabs, mode)
    return p2_evals_plain(*tabs, n_half, mode, single_inst), tabs


# --------------------------------------------------------------------------
# Kernel wrappers
# --------------------------------------------------------------------------
_K4_THREADS = 128  # csrc/sumcheck.cu K4_THREADS
_K4_MAX_BLOCKS = 2048  # csrc/sumcheck.cu K4_MAX_BLOCKS


def _k4_prep(tabs, n_axis: int, n_half: int, bind: bool, n_half_prev,
             n_entries: int) -> list:
    """K4's checks: the pairs of the round (and, fused, of the bind)
    inside the tables, indices below 2^31, 16-byte aligned tables.
    Returns the tables' pointers."""
    if bind and 2 * n_half != n_half_prev:
        raise ValueError("fused step binds the same axis: n_half_prev "
                         "must be 2 * n_half")
    if n_half < 1 or (4 if bind else 2) * n_half > n_axis:
        raise ValueError(f"n_half {n_half} outside an axis of {n_axis}")
    if n_entries >= 1 << 31:
        raise ValueError("K4 indexes tables below 2^31 entries")
    ptrs = [t.data_ptr() for t in tabs]
    if any(p % 16 for p in ptrs):
        raise ValueError("K4 reads 16-byte aligned tables")
    return ptrs


def _k4_scratch(npairs: int, device):
    """The (3, 16) evaluations and the partials of at most
    min(ceil(npairs / K4_THREADS), K4_MAX_BLOCKS) blocks."""
    nb = max(1, min(-(-npairs // _K4_THREADS), _K4_MAX_BLOCKS))
    out = torch.empty((3, 16), dtype=torch.int32, device=device)
    part = torch.empty(24 * nb, dtype=torch.int32, device=device)
    return out, part


def _new_table(t: torch.Tensor, axis: int, n: int, copies: int = 1):
    """New tables of t's shape with n entries along `axis`: one tensor,
    or `copies` of them in one allocation (the host's share of a round is
    most of a small round's time)."""
    shape = list(t.shape)
    shape[axis] = n
    if copies == 1:
        return torch.empty(shape, dtype=torch.int32, device=t.device)
    return torch.empty([copies] + shape, dtype=torch.int32,
                       device=t.device).unbind(0)


def _p1_launch(tp, tq, tx, B, C, D, n_half, mode, r=None, n_half_prev=None):
    axis = _P1_AXIS[mode]
    bind = r is not None
    dims = B.shape[:3]
    if C.shape != B.shape or D.shape != B.shape or \
            (tp.shape[0], tq.shape[0], tx.shape[0]) != dims:
        raise ValueError("phase-1 table shapes disagree")
    tabs = [t.contiguous() for t in (tp, tq, tx, B, C, D)]
    r = r.reshape(16).contiguous() if bind else tabs[0]
    kernels.require_cuda(*tabs, r)
    P, Q, X = dims
    ptrs = _k4_prep(tabs, dims[axis], n_half, bind, n_half_prev, P * Q * X)
    if bind:  # the new tables: 2 n_half entries along the axis
        nB, nC, nD = _new_table(tabs[3], axis, 2 * n_half, 3)
        neq = _new_table(tabs[axis], 0, 2 * n_half)
    else:
        nB = nC = nD = neq = tabs[0]
    out, part = _k4_scratch(P * Q * X // dims[axis] * n_half, B.device)
    kernels.launch(_P1_COUNTER[axis], "p1_round_launch", *ptrs,
                   nB.data_ptr(), nC.data_ptr(), nD.data_ptr(),
                   neq.data_ptr(), P, Q, X, axis, int(n_half), int(bind),
                   r.data_ptr(), part.data_ptr(), out.data_ptr(),
                   kernels.stream(B))
    if not bind:
        return out, None
    eqs = tabs[:3]
    eqs[axis] = neq
    return out, (*eqs, nB, nC, nD)


def p1_evals(tp, tq, tx, B, C, D, n_half: int, mode: int):
    if B.device.type == "cpu":
        return p1_evals_plain(tp, tq, tx, B, C, D, n_half, mode)
    return _p1_launch(tp, tq, tx, B, C, D, int(n_half), mode)[0]


def p1_step(tp, tq, tx, B, C, D, r_prev, n_half_prev, n_half,
            mode_prev: int, mode: int):
    """The previous round's bind fused with this round's evaluations;
    returns (evals, tables), the bound axis at its new live length."""
    if B.device.type == "cpu":
        return p1_step_plain(tp, tq, tx, B, C, D, r_prev, n_half_prev,
                             n_half, mode_prev, mode)
    if mode_prev == mode:
        # the plain step's compaction, which commutes with a bind along
        # the same axis (a no-op on the prover's tables)
        return _p1_launch(*_p1_compact(tp, tq, tx, B, C, D, mode),
                          int(n_half), mode, r_prev, int(n_half_prev))
    tabs = p1_bind(tp, tq, tx, B, C, D, r_prev, n_half_prev, mode_prev,
                   int(n_half_prev))
    tabs = _p1_compact(*tabs, mode)
    return p1_evals(*tabs, n_half, mode), tabs


def _p2_launch(ep, ABC, Z, n_half, mode, single_inst, r=None,
               n_half_prev=None):
    axis = _P2_AXIS[mode]
    bind = r is not None
    P, Wn, Y = Z.shape[:3]
    PB = ABC.shape[0]
    if ABC.shape[1:] != Z.shape[1:] or PB not in (1, P) or \
            ep.shape[0] != P:
        raise ValueError("phase-2 table shapes disagree")
    tabs = [t.contiguous() for t in (ep, ABC, Z)]
    r = r.reshape(16).contiguous() if bind else tabs[0]
    kernels.require_cuda(*tabs, r)
    ptrs = _k4_prep(tabs, (P, Wn, Y)[axis], n_half, bind, n_half_prev,
                    max(P, PB) * Wn * Y)
    fold_a = not (axis == 0 and PB == 1)
    nZ = _new_table(tabs[2], axis, 2 * n_half) if bind else tabs[2]
    nABC = _new_table(tabs[1], axis, 2 * n_half) if bind and fold_a \
        else tabs[1]
    nep = _new_table(tabs[0], 0, 2 * n_half) if bind and axis == 0 \
        else tabs[0]
    out, part = _k4_scratch(P * Wn * Y // (P, Wn, Y)[axis] * n_half,
                            Z.device)
    kernels.launch(_P2_COUNTER[axis], "p2_round_launch", *ptrs,
                   nABC.data_ptr(),
                   nZ.data_ptr(), nep.data_ptr(), P, PB, Wn, Y, axis,
                   int(n_half), int(bind), r.data_ptr(), part.data_ptr(),
                   out.data_ptr(), kernels.stream(Z))
    return out, (nep, nABC, nZ) if bind else None


def p2_evals(ep, ABC, Z, n_half: int, mode: int, single_inst: bool):
    if Z.device.type == "cpu":
        return p2_evals_plain(ep, ABC, Z, n_half, mode, single_inst)
    return _p2_launch(ep, ABC, Z, int(n_half), mode, single_inst)[0]


def p2_step(ep, ABC, Z, r_prev, n_half_prev, n_half, mode_prev: int,
            mode: int, single_inst: bool):
    if Z.device.type == "cpu":
        return p2_step_plain(ep, ABC, Z, r_prev, n_half_prev, n_half,
                             mode_prev, mode, single_inst)
    if mode_prev == mode:
        return _p2_launch(*_p2_compact(ep, ABC, Z, mode), int(n_half), mode,
                          single_inst, r_prev, int(n_half_prev))
    tabs = p2_bind(ep, ABC, Z, r_prev, n_half_prev, mode_prev, single_inst,
                   int(n_half_prev))
    tabs = _p2_compact(*tabs, mode)
    return p2_evals(*tabs, n_half, mode, single_inst), tabs


# --------------------------------------------------------------------------
# Size-classed phase 1 (K5): instances sorted by decreasing num_proofs
# partition into contiguous classes of equal Q_c, each with its own
# (P_c, Q_c, X, 16) tables, q bit-reversed within the class. The class's
# rows sit at the stride-S positions of the global q axis (S = Q_max / Q_c),
# so its eq_q table is tq[::S] while it is active (the first log2(Q_c) q
# rounds); afterwards it is inactive and its dense fold degenerates to
# T' = (1 - r) T. The global eq tables are shared by every class, folded
# once per round by `eq_fold`, and read-only in the class kernel.
# --------------------------------------------------------------------------
_PC_AXIS = {MODE_X: 2, MODE_Q: 1}


def eq_fold(t: torch.Tensor, r: torch.Tensor, n_half: int) -> torch.Tensor:
    """One bind of a shared eq table buffer (K1 fq_bind, counted apart)."""
    return fq.bind(t, r, 0, int(n_half), counter="eq_fold")


def _pc_slices(tp, tq, B, p0: int, S: int):
    return tp[p0:p0 + B.shape[0]], tq[0:S * B.shape[1]:S]


def _pc_inactive_tables(tq, B, C, D, n_half: int):
    """An inactive class as a two-row q axis: the live row and a zero high
    row, with eq_q (tq[0], tq[n_half]) of the folded global table."""
    def two(t):
        lo = t[:, :1, :1]
        return torch.cat([lo, torch.zeros_like(lo)], 1)

    return torch.stack([tq[0], tq[n_half]]), two(B), two(C), two(D)


def pc_evals_plain(tp, tq, tx, B, C, D, n_half: int, mode: int, p0: int,
                   S: int, active: bool):
    """One class's (e0, e2, e3) as a (3, 16) Montgomery tensor. n_half is
    the class's own for active rounds and the global one for inactive q
    rounds (where it addresses the folded tq)."""
    n_half = int(n_half)
    tp_c, tq_c = _pc_slices(tp, tq, B, p0, S)
    if mode == MODE_Q and not active:
        tq2, B2, C2, D2 = _pc_inactive_tables(tq, B, C, D, n_half)
        return p1_evals_plain(tp_c, tq2, tx[:1], B2, C2, D2, 1, MODE_Q)
    return p1_evals_plain(tp_c, tq_c, tx[:B.shape[2]], B, C, D, n_half, mode)


def pc_class_state(n_half: int, mode: int, S: int):
    """(n_half, active) of the class of q stride S in a round of the
    global n_half: a class is active while the global q fold still splits
    its stride-S rows, and its n_half is then its own."""
    active = mode == MODE_X or n_half >= S
    return (n_half // S if mode == MODE_Q and active else n_half), active


def _pc_states(n_half: int, mode: int, Ss):
    """The classes' n_halves and activities in a round."""
    state = [pc_class_state(int(n_half), mode, int(S)) for S in Ss]
    return [n for n, _ in state], [a for _, a in state]


def pc_bind_plain(B, C, D, r, n_half: int, mode: int, active: bool,
                  out_len: int | None = None):
    """Class bind: fold (active; the axis keeps its length, or has out_len
    entries) or (1 - r)-scale each of B, C, D."""
    if mode == MODE_Q and not active:
        one = lb.to_device(fq.ONE_MONT, B.device)
        omr = fq.sub_plain(one, r.reshape(16))
        return tuple(fq.mul_plain(t, omr) for t in (B, C, D))
    return tuple(fq.bind_plain(t, r, _PC_AXIS[mode], int(n_half), out_len)
                 for t in (B, C, D))


def _pc_compact(B, C, D, mode: int, active: bool):
    if mode != MODE_X and B.shape[2] > 1:
        B, C, D = B[:, :, :1], C[:, :, :1], D[:, :, :1]
    if mode == MODE_Q and not active and B.shape[1] > 1:
        B, C, D = B[:, :1], C[:, :1], D[:, :1]
    return tuple(t.contiguous() for t in (B, C, D))


def pc_step_plain(tp, tq, tx, B, C, D, r_prev, n_half_prev, n_half,
                  mode_prev: int, mode: int, p0: int, S: int,
                  active_prev: bool, active: bool):
    """The class's previous-round bind, to the new live length
    n_half_prev along its axis, then this round's evaluations; returns
    (evals, (B, C, D))."""
    tabs = pc_bind_plain(B, C, D, r_prev, n_half_prev, mode_prev,
                         active_prev, int(n_half_prev))
    tabs = _pc_compact(*tabs, mode, active)
    return pc_evals_plain(tp, tq, tx, *tabs, n_half, mode, p0, S,
                          active), tabs


def pc_round_plain(tp, tq, tx, tabs, p0s, Ss, n_half: int, mode: int,
                   prev=None):
    """pc_round's plain version: pc_evals_plain (first round) or
    pc_step_plain of each class, the evaluations stacked."""
    nhs, actives = _pc_states(n_half, mode, Ss)
    evs, new = [], []
    for i, (T, p0, S) in enumerate(zip(tabs, p0s, Ss)):
        if prev is None:
            evs.append(pc_evals_plain(tp, tq, tx, *T, nhs[i], mode, p0, S,
                                      actives[i]))
        else:
            r, mode_prev, nhs_prev, actives_prev = prev
            ev, T = pc_step_plain(tp, tq, tx, *T, r, nhs_prev[i], nhs[i],
                                  mode_prev, mode, p0, S, actives_prev[i],
                                  actives[i])
            evs.append(ev)
        new.append(T)
    return torch.stack(evs), new, nhs, actives


def pc_bind(B, C, D, r, n_half: int, mode: int, active: bool):
    """The class bind on the card, the buffers keeping their length: an
    active fold is K1's fq_bind (counted as pc_bind); the inactive (1 - r)
    scale is K1's fq_bind of the pair (T, 0), T + r (0 - T) (counted as
    pc_bind_inactive; no constant goes up to the card inside a sumcheck).
    The prover's rounds bind inside K5 (pc_round); this serves the end of
    the classed rounds and the multi-device settle."""
    if B.device.type == "cpu":
        return pc_bind_plain(B, C, D, r, n_half, mode, active)
    if mode == MODE_Q and not active:
        return tuple(fq.bind(torch.stack([t, torch.zeros_like(t)]), r, 0, 1,
                             1, counter="pc_bind_inactive")[0]
                     for t in (B, C, D))
    return tuple(fq.bind(t, r, _PC_AXIS[mode], int(n_half),
                         counter="pc_bind") for t in (B, C, D))


_PC_MAX_CLASSES = 16  # csrc/sumcheck.cu PC_MAX_CLASSES
_PC_BIND = {MODE_Q: 1, MODE_X: 2}  # csrc/sumcheck.cu PcClass.bax


def _pc_launch(tp, tq, tx, tabs, p0s, Ss, nhs, actives, mode, prev=None):
    """K5 over the classes: one launch of up to _PC_MAX_CLASSES classes.
    prev: None, or (r, mode_prev, n_halves_prev, actives_prev) of the
    previous round, whose bind each class takes first. Returns (evals (n,
    3, 16), the tables of the round: with prev the new tables of the live
    length, else the tables given)."""
    if mode not in _PC_AXIS:
        raise ValueError("a class round binds x or q")
    dev = tp.device
    eqs = [t.contiguous() for t in (tp, tq, tx)]
    r = prev[0].reshape(16).contiguous() if prev is not None else eqs[0]
    kernels.require_cuda(*eqs, r)
    n = len(tabs)
    # keep: the tables read (and any contiguous copy) alive to the launch
    rows, keep, shapes = [], [], []
    for i in range(n):
        B, C, D = tabs[i]
        nh, active = int(nhs[i]), bool(actives[i])
        if mode == MODE_X and not active:
            raise ValueError("an x round has no inactive class")
        if C.shape != B.shape or D.shape != B.shape or \
                C.stride() != B.stride() or D.stride() != B.stride() or \
                B.stride(-1) != 1 or any(x % 16 for x in B.stride()[:3]):
            B, C, D = (t.contiguous() for t in (B, C, D))
        for t in (B, C, D):
            if t.device != dev or t.dtype != torch.int32 or \
                    t.data_ptr() % 16:
                raise ValueError("K5 reads int32 tables on the eq tables' "
                                 "card, 16-byte aligned")
        dims = list(B.shape[:3])
        bax, h = 0, 0
        if prev is not None:
            mode_prev, h = prev[1], int(prev[2][i])
            if mode_prev == MODE_Q and not prev[3][i]:
                bax, h = 3, 0
            else:
                bax = _PC_BIND[mode_prev]
                if h < 1 or 2 * h > dims[_PC_AXIS[mode_prev]]:
                    raise ValueError(f"bind offset {h} outside an axis of "
                                     f"{dims[_PC_AXIS[mode_prev]]}")
                dims[_PC_AXIS[mode_prev]] = h
        # a step compacts the axes bound before (_pc_compact); an inactive
        # class has one live entry an instance
        if (prev is not None and mode != MODE_X) or not active:
            dims[2] = 1
        if not active:
            dims[1] = 1
        Pc, Qn, Xn = dims
        p0, S = int(p0s[i]), int(Ss[i])
        ax_len = Xn if mode == MODE_X else Qn
        if p0 + Pc > tp.shape[0] or Xn > tx.shape[0] or \
                S * Qn > tq.shape[0]:
            raise ValueError("class tables outside the eq tables")
        if active:
            eq_len = tx.shape[0] if mode == MODE_X else tq.shape[0] // S
            if nh < 1 or 2 * nh > min(ax_len, eq_len) or \
                    (bax and 2 * nh != ax_len):
                raise ValueError(f"n_half {nh} outside an axis of {ax_len}")
        elif nh >= tq.shape[0]:
            raise ValueError("n_half outside the eq_q table")
        shapes.append((Pc, Qn, Xn))
        keep.append((B, C, D))
        rows.append([B.data_ptr(), C.data_ptr(), D.data_ptr(), 0, 0, 0,
                     *(x // 16 for x in B.stride()[:3]), Pc, Qn, Xn, p0, S,
                     nh, h, bax, int(active)])
    if prev is not None:  # every class's new tables in one allocation
        sizes = [3 * math.prod(d) for d in shapes]
        flat = torch.empty((sum(sizes), 16), dtype=torch.int32, device=dev)
        new, at = [], 0
        for i, d in enumerate(shapes):
            m = math.prod(d)
            T = tuple(flat[at + k * m:at + (k + 1) * m].view(*d, 16)
                      for k in range(3))
            rows[i][3:6] = [t.data_ptr() for t in T]
            new.append(T)
            at += sizes[i]
    else:
        new = [tuple(t) for t in tabs]
    out = torch.empty((n, 3, 16), dtype=torch.int32, device=dev)
    part = torch.empty(24 * (_K4_MAX_BLOCKS + _PC_MAX_CLASSES),
                       dtype=torch.int32, device=dev)
    desc = np.asarray(rows, dtype=np.int64)
    for j in range(0, n, _PC_MAX_CLASSES):
        chunk = desc[j:j + _PC_MAX_CLASSES]
        kernels.launch("sc_pc_round", "pc_round_launch",
                       *(t.data_ptr() for t in eqs), r.data_ptr(),
                       chunk.ctypes.data, len(chunk), _PC_AXIS[mode],
                       part.data_ptr(), out[j].data_ptr(),
                       kernels.stream(tp))
    return out, new


def pc_round(tp, tq, tx, tabs, p0s, Ss, n_half: int, mode: int,
             prev=None):
    """One round of the classed phase 1 for every class: each class's
    previous-round bind (prev: None, or (r, mode_prev, its n_halves,
    its activities)) and its evaluations, with tp/tq/tx the current
    global eq tables (already folded for this round by eq_fold). On the
    card one K5 launch for all classes (csrc/sumcheck.cu k_pc_round,
    counted as sc_pc_round). Returns (evals (n, 3, 16), the classes'
    tables, n_halves, activities)."""
    if tp.device.type == "cpu":
        return pc_round_plain(tp, tq, tx, tabs, p0s, Ss, n_half, mode, prev)
    nhs, actives = _pc_states(n_half, mode, Ss)
    ev, new = _pc_launch(tp, tq, tx, tabs, p0s, Ss, nhs, actives, mode,
                         prev)
    return ev, new, nhs, actives


def pc_evals(tp, tq, tx, B, C, D, n_half: int, mode: int, p0: int, S: int,
             active: bool):
    """One class's (e0, e2, e3): K5 with one class."""
    if B.device.type == "cpu":
        return pc_evals_plain(tp, tq, tx, B, C, D, n_half, mode, p0, S,
                              active)
    return _pc_launch(tp, tq, tx, [(B, C, D)], [p0], [S], [n_half],
                      [active], mode)[0][0]


def pc_step(tp, tq, tx, B, C, D, r_prev, n_half_prev, n_half,
            mode_prev: int, mode: int, p0: int, S: int, active_prev: bool,
            active: bool):
    """The class's previous-round bind fused with this round's
    evaluations (K5 with one class); tp/tq/tx are the current global eq
    tables (already folded for this round by eq_fold). Returns (evals,
    (B, C, D)), the tables of the live length."""
    if B.device.type == "cpu":
        return pc_step_plain(tp, tq, tx, B, C, D, r_prev, n_half_prev,
                             n_half, mode_prev, mode, p0, S, active_prev,
                             active)
    ev, new = _pc_launch(tp, tq, tx, [(B, C, D)], [p0], [S], [n_half],
                         [active], mode,
                         (r_prev, mode_prev, [n_half_prev], [active_prev]))
    return ev[0], new[0]
