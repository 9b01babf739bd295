"""The device-resident ZK sumcheck round's plain versions against the JAX
package: the Keccak permutation and STROBE-128 of ops/transcript_dev.py,
the challenge reduction (Scalar::from_bytes_wide, with halves >= l), the
ristretto ENCODE and comb commitments of ops/ristretto_dev.py, the cubic
interpolation and evaluation of ops/zk_round.py, and one whole round tail
against the JAX package's host loop under one tape. Inputs come from
numpy seeds; tolerance: exact equality (points after ristretto
compression). The JAX functions run jitted, one compile each, in one
fresh process per test run (`jax_side`): the thousands of small XLA
executables of the JAX package's own eager tests already crowd a pytest
worker's memory maps, and these programs stay out of them."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_parallel_tpu.models import commitments as jcm
from spartan_parallel_tpu.models import sumcheck as jsum
from spartan_parallel_tpu.models.unipoly import UniPoly as JUniPoly
from spartan_parallel_tpu.ops import fq as jfq
from spartan_parallel_tpu.ops import ristretto_dev as jrdev
from spartan_parallel_tpu.ops import transcript_dev as jtdev
from spartan_parallel_tpu.ops import zk_round as jzkr
from spartan_parallel_tpu.core.field import Scalar as JScalar
from spartan_parallel_tpu.utils.random_tape import RandomTape as JTape
from spartan_parallel_tpu.utils.strobe import Strobe128 as JStrobe
from spartan_parallel_tpu.utils.transcript import Transcript as JTranscript
from spartan_parallel_tpu_torch.core.consts import L, P, SQRT_M1
from spartan_parallel_tpu_torch.core.edwards import (
    RistrettoPoint,
    multiscalar_mul,
)
from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
from spartan_parallel_tpu_torch.ops import curve, fq
from spartan_parallel_tpu_torch.ops import ristretto_dev as rdev
from spartan_parallel_tpu_torch.ops import transcript_dev as tdev
from spartan_parallel_tpu_torch.ops import zk_round as zkr
from spartan_parallel_tpu_torch.utils.transcript import Transcript

from .torch_shared import in_fresh_process, shared_result

rng = np.random.default_rng(55)


def rand_ints(n, m=L):
    return [int.from_bytes(rng.bytes(40), "little") % m for _ in range(n)]


def mont(xs):
    return torch.from_numpy(fq.encode(xs))


def state_of(s):
    """(st, pos, pos_begin) of the plain ops -> (bytes, pos, pos_begin)."""
    return bytes(s[0].numpy().astype(np.uint8)), s[1], s[2]


def fixed_inputs():
    """The inputs of the jitted JAX comparisons, the same in every worker:
    byte states, a transcript state and 64-byte challenges (random,
    all-0xFF halves, the halves l and l - 1), points (two random ones,
    each with the 2- and 4-torsion points added, and the identity), a comb
    table of 4 G + h with three scalar rows (one with a zero, one with
    l - 1), and four evaluations and a point r."""
    g = np.random.default_rng(56)

    def ints(n):
        return [int.from_bytes(g.bytes(40), "little") % L for _ in range(n)]

    t = Transcript(b"challenge")
    t.append_message(b"m", g.bytes(70))
    wide = [g.bytes(64), b"\xff" * 64, b"\xff" * 32 + b"\x00" * 32,
            L.to_bytes(32, "little") + (L - 1).to_bytes(32, "little")]
    B = RistrettoPoint.basepoint()
    t4 = RistrettoPoint(SQRT_M1, 0, 1, 0)
    t2 = RistrettoPoint(0, P - 1, 1, 0)
    pts = [B.scalar_mul(k) + tor for k in ints(2)
           for tor in (RistrettoPoint.identity(), t4, t2, t4 + t2)]
    pts.append(RistrettoPoint.identity())
    gens = MultiCommitGens(4, b"comb_commit")
    scal = [ints(5), [0] + ints(4), [L - 1] + ints(4)]
    return {
        "states": g.integers(0, 256, (3, 200)).astype(np.int32),
        "transcript": t, "st": tdev.host_state(t), "wide": wide,
        "wide_bytes": np.frombuffer(b"".join(wide), np.uint8).reshape(-1, 64),
        "pts": pts, "pts_arr": curve.encode_points(pts),
        "gens": gens, "tab": rdev.make_comb_tables(gens.G + [gens.h]),
        "scal": scal,
        "scal_mont": fq.encode([x for row in scal for x in row]).reshape(
            3, 5, 16),
        "evals": ints(4), "r": ints(1)}


def jax_programs(st, wide, states, pts, tab, sm, evals_r):
    """The jitted JAX functions on the fixed inputs (numpy in and out)."""
    u32 = lambda a: jnp.asarray(np.asarray(a).astype(np.uint32))  # noqa

    def wide_fn(b):
        lo = jtdev.bytes_to_limbs(b[:32])
        hi = jtdev.bytes_to_limbs(b[32:])
        return jfq.add(jfq.from_canonical(lo), jfq.mul(
            jfq.from_canonical(hi), jnp.asarray(jtdev._shift256())))

    @jax.jit
    def challenge(st, pos, pb, b):
        s, c = jtdev.challenge_scalar((st, pos, pb), b"probe")
        return s[0], s[1], s[2], c, jax.vmap(wide_fn)(b)

    @jax.jit
    def coeffs_eval(e0, e1, e2, e3, r):
        c = jzkr._coeffs_from_evals(e0, e1, e2, e3)
        return c, jzkr._poly_eval(c, r)

    out = {"permute": jax.jit(jax.vmap(jtdev.permute))(u32(states)),
           "challenge": challenge(u32(st[:200]), jnp.uint32(st[200]),
                                  jnp.uint32(st[201]), u32(wide)),
           "compress": jax.jit(jrdev.compress)(u32(pts)),
           "comb": jax.jit(jzkr.comb_commit)(u32(tab), u32(sm)),
           "coeffs_eval": coeffs_eval(*(u32(x) for x in evals_r))}
    return jax.tree_util.tree_map(np.asarray, out)


@pytest.fixture(scope="module")
def fixed():
    return fixed_inputs()


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory, fixed):
    """jax_programs on the fixed inputs, once per test run, in a fresh
    process."""
    f = fixed
    return shared_result(tmp_path_factory, "jax_zk_round", lambda: (
        in_fresh_process(jax_programs, f["st"], f["wide_bytes"],
                         f["states"], f["pts_arr"], f["tab"],
                         f["scal_mont"], fq.encode(f["evals"] + f["r"]))))


def test_permute_matches_jax(fixed, jax_side):
    got = tdev.permute(torch.from_numpy(fixed["states"]))
    assert np.array_equal(got.numpy(), jax_side["permute"])


def test_strobe_schedule_matches_jax_host():
    """A 40-step random meta_ad / ad / prf schedule, lengths crossing the
    166-byte block, continued operations included, against the JAX
    package's host Strobe128: same outputs and state after each step."""
    host = JStrobe(b"schedule")
    s = (torch.tensor(list(host.state), dtype=torch.int64), host.pos,
         host.pos_begin)
    prev = None
    for _ in range(40):
        op = int(rng.integers(3))
        n = int(rng.choice([0, 1, 2, 7, 32, 64, 100, 150, 165, 166, 167]))
        more = op == prev and bool(rng.integers(2))
        data = rng.integers(0, 256, n)
        if op == 0:
            host.meta_ad(bytes(data.astype(np.uint8)), more)
            s = tdev.meta_ad(s, torch.from_numpy(data), more)
        elif op == 1:
            host.ad(bytes(data.astype(np.uint8)), more)
            s = tdev.ad(s, torch.from_numpy(data), more)
        else:
            want = host.prf(n, more)
            s, got = tdev.prf(s, n, more)
            assert bytes(got.numpy().astype(np.uint8)) == want
        assert state_of(s) == (bytes(host.state), host.pos, host.pos_begin)
        prev = op


def test_challenge_scalar_matches_jax(fixed, jax_side):
    """challenge_scalar against the JAX device transcript and the host
    transcript, and the 64-byte reduction against JAX's and Python's for
    random bytes, all-0xFF halves and the halves l, l - 1."""
    t = copy.deepcopy(fixed["transcript"])
    st, wide = fixed["st"], fixed["wide"]
    jst, jpos, jpb, jc, jw = jax_side["challenge"]
    s, c = tdev.challenge_scalar(tdev.unpack(torch.from_numpy(st)),
                                 b"probe")
    want = int(t.challenge_scalar(b"probe"))
    assert fq.decode(c) == [want] == fq.decode(jc)
    assert state_of(s) == (bytes(jst.astype(np.uint8)), int(jpos), int(jpb))
    assert state_of(s) == (bytes(t.strobe.state), t.strobe.pos,
                           t.strobe.pos_begin)
    got = tdev.from_bytes_wide(torch.from_numpy(
        fixed["wide_bytes"].astype(np.int64)))
    assert np.array_equal(got.numpy(), jw.astype(np.int32))
    assert fq.decode(got) == [int.from_bytes(w, "little") % L for w in wide]


def encode_branches(pt: RistrettoPoint):
    """ENCODE's (rotate, negate y) for a point's coordinates."""
    X, Y, Z, T = pt.X, pt.Y, pt.Z, pt.T
    u1 = (Z + Y) * (Z - Y) % P
    u2 = X * Y % P
    from spartan_parallel_tpu_torch.core.edwards import sqrt_ratio_m1

    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 * u2 % P)
    z_inv = invsqrt * u1 % P * invsqrt % P * u2 % P * T % P
    rotate = (T * z_inv % P) & 1
    x = Y * SQRT_M1 % P if rotate else X
    return bool(rotate), bool((x * z_inv % P) & 1)


def test_compress_matches_jax(fixed, jax_side):
    """Two random points, each also with the 2- and 4-torsion points added
    (the same encoding through the other branches of ENCODE: both
    rotations and both signs are asserted to occur), and the identity."""
    pts = fixed["pts"]
    branches = {encode_branches(p) for p in pts[:-1]}
    assert {b[0] for b in branches} == {False, True}
    assert {b[1] for b in branches} == {False, True}
    got = rdev.compress(torch.from_numpy(fixed["pts_arr"])).numpy()
    assert np.array_equal(got, jax_side["compress"].astype(np.int32))
    assert [bytes(g.astype(np.uint8)) for g in got] == \
        [p.compress() for p in pts]
    assert not got[-1].any()


def test_comb_tables_match_jax():
    gens = MultiCommitGens(1, b"comb_tables")
    jgens = jcm.MultiCommitGens(1, b"comb_tables")
    got = rdev.make_comb_tables(gens.G + [gens.h])
    want = jrdev.make_comb_tables(list(jgens.G) + [jgens.h])
    assert got.shape == (2, 64, 16, 4, 16)
    assert np.array_equal(got, want.astype(np.int32))


def test_comb_commit_matches_jax(fixed, jax_side):
    """Three commitments of 4 G + h, one with a zero scalar and one with
    l - 1, against the JAX batched comb_commit and the host MSM."""
    gens = fixed["gens"]
    got = rdev.comb_commit(torch.from_numpy(fixed["tab"]),
                           torch.from_numpy(fixed["scal_mont"]))
    enc = [p.compress() for p in curve.decode_points(got)]
    assert enc == [p.compress()
                   for p in curve.decode_points(jax_side["comb"])]
    assert enc == [multiscalar_mul(row, gens.G + [gens.h]).compress()
                   for row in fixed["scal"]]


def test_coeffs_and_poly_eval_match_jax(fixed, jax_side):
    e, r = fixed["evals"], fixed["r"]
    em, rm = mont(e), mont(r)[0]
    coeffs = zkr.coeffs_from_evals(*em)
    ev = zkr.poly_eval(coeffs, rm)
    jc, jev = jax_side["coeffs_eval"]
    assert np.array_equal(coeffs.numpy(), jc.astype(np.int32))
    assert np.array_equal(ev.numpy(), jev.astype(np.int32))
    poly = JUniPoly.from_evals([JScalar(x) for x in e])
    assert fq.decode(coeffs) == [int(c) for c in poly.coeffs]
    assert fq.decode(ev) == [int(poly.evaluate(JScalar(r[0])))]


def round_inputs(k: int):
    """Evaluations of k table sets, a claim and its blind, a transcript."""
    evs = rand_ints(3 * k)
    claim, blind_claim = rand_ints(2)
    tr = JTranscript(b"zk_round")
    tr.append_message(b"before", b"\x01" * 45)
    return evs, claim, blind_claim, tr


def jax_host_round(evs, claim, blind_claim, tr, seed):
    """Round 0 of the JAX package's host loop (models/sumcheck.py:563-590)
    with the classes' evaluations summed: its messages, the next claim and
    commitment, r and the transcript state."""
    gens_1 = jcm.MultiCommitGens(1, b"zk_round_1")
    gens_n = jcm.MultiCommitGens(4, b"zk_round_4")
    tape = JTape(b"tape", seed=seed)
    blinds_poly = tape.random_vector(b"blinds_poly", 1)
    blinds_evals = tape.random_vector(b"blinds_evals", 1)
    s = [JScalar(sum(evs[m::3]) % L) for m in range(3)]
    comm_claim = jcm.commit_scalar(JScalar(claim), JScalar(blind_claim),
                                   gens_1).compress()
    poly = JUniPoly.from_evals([s[0], JScalar(claim) - s[0], s[1], s[2]])
    comm_poly = poly.commit(gens_n, blinds_poly[0]).compress()
    tr.append_point(b"comm_poly", comm_poly)
    r = tr.challenge_scalar(b"challenge_nextround")
    proof, ev, comm_eval = jsum.ZKSumcheckInstanceProof._zk_round_tail(
        poly, r, 0, JScalar(claim), comm_claim, JScalar(blind_claim),
        blinds_poly, blinds_evals, gens_1, gens_n, tr, tape)
    sb = tr.strobe
    return {"comm_claim": comm_claim, "comm_poly": comm_poly,
            "comm_eval": comm_eval, "beta": proof.beta, "delta": proof.delta,
            "z": [int(x) for x in proof.z] + [int(proof.z_delta),
                                             int(proof.z_beta)],
            "r": int(r), "eval": int(ev),
            "state": (bytes(sb.state), sb.pos, sb.pos_begin)}


def port_round_buffers(evs, claim, blind_claim, tr, seed):
    """The port's round-tail buffers for the same round: the tape values
    drawn in the host loop's order, delta and the claim's commitment from
    the host."""
    from spartan_parallel_tpu_torch.models.commitments import (
        commit,
        commit_scalar,
    )
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape

    gens_1 = MultiCommitGens(1, b"zk_round_1")
    gens_n = MultiCommitGens(4, b"zk_round_4")
    tape = RandomTape(b"tape", seed=seed)
    bp = tape.random_vector(b"blinds_poly", 1)
    be = tape.random_vector(b"blinds_evals", 1)
    dv = tape.random_vector(b"d_vec", 4)
    rd = tape.random_scalar(b"r_delta")
    rb = tape.random_scalar(b"r_beta")
    delta = np.frombuffer(commit(dv, rd, gens_n).compress(), np.uint8)
    tape_t = torch.cat([mont(bp + be + [blind_claim] + dv + [rd, rb]),
                        torch.from_numpy(delta.astype(np.int32)).view(2, 16)])
    cc = np.frombuffer(commit_scalar(claim, blind_claim, gens_1).compress(),
                       np.uint8)
    carry = torch.cat([mont([claim]),
                       torch.from_numpy(cc.astype(np.int32)).view(2, 16)])
    st = torch.from_numpy(np.concatenate([
        np.frombuffer(bytes(tr.strobe.state), np.uint8).astype(np.int32),
        [tr.strobe.pos, tr.strobe.pos_begin]]).astype(np.int32))
    tabs = [torch.from_numpy(rdev.make_comb_tables(g.G + [g.h]))
            for g in (gens_n, gens_1)]
    return (mont(evs).view(-1, 3, 16), st, carry, tape_t,
            torch.zeros((zkr.OUT_ROWS, 16), dtype=torch.int32), *tabs)


def port_round_result(st, carry, out):
    def enc(rows):
        return bytes(rows.reshape(32).numpy().astype(np.uint8))

    return {"comm_poly": enc(out[0:2]), "comm_eval": enc(out[2:4]),
            "beta": enc(out[4:6]), "z": fq.decode(out[6:12]),
            "r": fq.decode(out[12])[0], "eval": fq.decode(carry[0])[0],
            "next_comm_claim": enc(carry[1:]),
            "state": (bytes(st[:200].numpy().astype(np.uint8)),
                      int(st[200]), int(st[201]))}


@pytest.mark.parametrize("k", [1, 3])
def test_round_tail_matches_jax_host_loop(k):
    """One round through the plain tail (k table sets, summed in the tail)
    against the JAX package's host round under one tape: messages,
    responses, r, the next claim and commitment, the transcript state."""
    seed = bytes([k]) * 32
    evs, claim, blind_claim, tr = round_inputs(k)
    port_tr = Transcript(b"zk_round")
    port_tr.append_message(b"before", b"\x01" * 45)
    bufs = port_round_buffers(evs, claim, blind_claim, port_tr, seed)
    want = jax_host_round(evs, claim, blind_claim, tr, seed)
    evs_t, st, carry, tape_t, out, tab_n, tab_1 = bufs
    assert bytes(carry[1:].reshape(32).numpy().astype(np.uint8)) == \
        want["comm_claim"]
    zkr.zk_round_tail(evs_t, st, carry, tape_t, out, tab_n, tab_1)
    got = port_round_result(st, carry, out)
    assert got["state"] == want["state"]
    for key in ("comm_poly", "comm_eval", "beta", "z", "r", "eval"):
        assert got[key] == want[key], key
    assert got["next_comm_claim"] == want["comm_eval"]
