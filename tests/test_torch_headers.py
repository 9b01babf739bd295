"""The CUDA kernels' per-element arithmetic (csrc/fq.cuh, fp.cuh, fe.cuh,
curve.cuh), K1's eq table split into chunks (csrc/eq.cuh), K3's work split
(csrc/spmv.cuh), K2's signed digits, cached points and bucket combination
(csrc/msm.cuh, host_check.cpp), the lane-split point operations and the
fold (csrc/lanes.cuh), and the device round's transcript, encoding, comb
commitment and tail (csrc/keccak.cuh, ristretto.cuh, zk_round.cuh) built
for the host with g++ (csrc/host_check.cpp) and held against Python
integers, the port's plain PyTorch versions and host oracles on random and
edge inputs. Code that runs on several lanes runs here through its host
model: the kernels' own step functions, lane by lane. Only the launch code
of the kernels stays unchecked on a host without a card."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spartan_parallel_tpu_torch.core.consts import L, P
from spartan_parallel_tpu_torch.core.edwards import RistrettoPoint
from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
from spartan_parallel_tpu_torch.ops import curve, fp, fq, msm
from spartan_parallel_tpu_torch.ops import limbs as lb
from spartan_parallel_tpu_torch.ops import ristretto_dev as rdev
from spartan_parallel_tpu_torch.ops import transcript_dev as tdev
from spartan_parallel_tpu_torch.ops import zk_round as zkr
from spartan_parallel_tpu_torch.utils.keccak import keccak_f1600
from spartan_parallel_tpu_torch.utils.transcript import Transcript

from .torch_shared import msm_edge_scalars

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "spartan_parallel_tpu_torch", "csrc")
rng = np.random.default_rng(9)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no C++ compiler on this host")
    so = str(tmp_path_factory.mktemp("hc") / "libhostcheck.so")
    subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-o", so,
                    os.path.join(CSRC, "host_check.cpp")], check=True)
    lib = ctypes.CDLL(so)
    vp, n = ctypes.c_void_p, ctypes.c_long
    lib.host_fq_mul.argtypes = [vp, vp, vp, n]
    lib.host_fq_bind.argtypes = [vp, vp, vp, vp, n]
    lib.host_fq_pow.argtypes = [vp, vp, vp, n]
    lib.host_fp_mul.argtypes = [vp, vp, vp, n]
    lib.host_fe_mul.argtypes = [vp, vp, vp, vp, n, ctypes.c_int]
    lib.host_fe_words.argtypes = [vp, vp, vp, vp, n]
    lib.host_ls_point.argtypes = [vp, vp, vp, n, ctypes.c_int]
    lib.host_fold.argtypes = [vp, vp, vp, vp, n]
    lib.host_point_sum.argtypes = [vp, vp, n, n]
    lib.host_scale.argtypes = [vp, vp, vp, n]
    lib.host_pt_add.argtypes = [vp, vp, vp, n]
    lib.host_pt_double.argtypes = [vp, vp, n]
    lib.host_signed_digits.argtypes = [vp, vp, vp, n]
    lib.host_pt_add_cached.argtypes = [vp, vp, vp, vp, n]
    lib.host_bucket_combine.argtypes = [vp, n, vp]
    lib.host_keccak.argtypes = [vp, vp, n, ctypes.c_int]
    lib.host_strobe_op.argtypes = [vp, ctypes.c_int, vp, vp, n,
                                   ctypes.c_int]
    lib.host_challenge_scalar.argtypes = [vp, ctypes.c_char_p, vp]
    lib.host_from_bytes_wide.argtypes = [vp, vp, n]
    lib.host_compress.argtypes = [vp, vp, n]
    lib.host_comb.argtypes = [vp, n, vp, vp, n, n]
    lib.host_zk_round_tail.argtypes = [vp, n, vp, vp, vp, vp, vp, vp]
    lib.host_eq_evals.argtypes = [vp, ctypes.c_int, vp]
    lib.host_spmv_many.argtypes = [vp] * 12 + [ctypes.c_int, vp]
    return lib


def ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def rand_mod(m, n):
    edge = [0, 1, 2, m - 1, m - 2]
    return edge + [int.from_bytes(rng.bytes(40), "little") % m
                   for _ in range(n - len(edge))]


def test_fq_mul_and_bind(lib):
    n = 64
    a, b = fq.encode(rand_mod(L, n)), fq.encode(rand_mod(L, n)[::-1])
    out = np.zeros_like(a)
    lib.host_fq_mul(ptr(a), ptr(b), ptr(out), n)
    assert np.array_equal(out, fq.mul(torch.from_numpy(a),
                                      torch.from_numpy(b)).numpy())
    r = fq.encode(rand_mod(L, 6))[5].copy()
    lib.host_fq_bind(ptr(a), ptr(b), ptr(r), ptr(out), n)
    want = fq.bind(torch.from_numpy(np.concatenate([a, b])),
                   torch.from_numpy(r), 0, n, n)
    assert np.array_equal(out, want.numpy())


def test_fq_pow(lib):
    """K7's per-thread step (csrc/fq.cuh fq_pow, square-and-multiply on
    Montgomery limbs) against Python's pow(c, e, l), exact: every exponent
    of the path's tables (0 to 1023), the first power of each thread of a
    2^20 table, and 64-bit edge cases."""
    c_int = rand_mod(L, 6)[5]
    c = fq.encode([c_int])[0].copy()
    es = list(range(1024)) + [4096 * k + t for k in (1, 17, 255)
                              for t in (0, 1, 255)] + \
        [(1 << 20) - 1, (1 << 32) + 5, (1 << 64) - 1]
    e = np.array(es, dtype=np.uint64)
    out = np.zeros((len(es), 16), dtype=np.int32)
    lib.host_fq_pow(ptr(c), ptr(e), ptr(out), len(es))
    assert fq.decode(out) == [pow(c_int, x, L) for x in es]


def test_fp_mul(lib):
    n = 64
    a, b = fp.encode(rand_mod(P, n)), fp.encode(rand_mod(P, n)[::-1])
    out = np.zeros_like(a)
    lib.host_fp_mul(ptr(a), ptr(b), ptr(out), n)
    assert np.array_equal(out, fp.mul(torch.from_numpy(a),
                                      torch.from_numpy(b)).numpy())


FE_W = [26, 25] * 5
FE_OFF = [(51 * i + 1) >> 1 for i in range(10)]


def fe_value(limbs):
    return sum(int(v) << o for v, o in zip(limbs, FE_OFF))


def fe_limbs(x):
    """A value below 2^255 as fe.cuh's tight limbs."""
    return [(x >> o) & ((1 << w) - 1) for o, w in zip(FE_OFF, FE_W)]


def words_int(w):
    return sum(int(v) << (32 * k) for k, v in enumerate(w))


FE_EDGES = [0, 1, P - 1, P, P + 1, (1 << 255) - 20, (1 << 255) - 1,
            (1 << 256) - 1, (1 << 256) - 38]


@pytest.mark.parametrize("kind", [0, 1, 2, 3],
                         ids=["mul", "sqr", "lanes_mul", "lanes_sqr"])
def test_fe_product(lib, kind):
    """The chains' products against Python integers, out fully reduced:
    csrc/fe.cuh fe_mul and fe_sqr on one thread, and the ten-lane product
    and squaring of the ENCODE (csrc/fp10.cuh, each lane's steps run lane
    by lane by G10Host), whose limbs must also stay within the bounds the
    next product takes (2^W + 2^18.2, limb 0 2^26 + 2^22.5). Inputs:
    seeded random values, the edges 0, 1, p - 1, 2^255 - 20 and their
    neighbours as tight limbs, and every limb at the product's input
    bounds (the first operand below 2^(W + 3), the second and a squaring's
    below 3.36 * 2^W), alone and all at once."""
    sq = kind in (1, 3)
    fmax = [(1 << (w + 3)) - 1 for w in FE_W]
    gmax = [int(3.36 * (1 << w)) for w in FE_W]
    vals = [x % P for x in FE_EDGES] + rand_mod(P, 24)
    f = [fe_limbs(x) for x in vals] + [fmax, gmax, [0] * 10]
    g = [fe_limbs(x) for x in vals[::-1]] + [gmax, gmax, gmax]
    for i in range(10):  # limb i at its bound, the rest random
        f.append([fmax[k] if k == i else int(rng.integers(fmax[k]))
                  for k in range(10)])
        g.append([gmax[k] if k == i else int(rng.integers(gmax[k]))
                  for k in range(10)])
    if sq:
        f = g
    a = np.array(f, dtype=np.uint32)
    b = np.array(g, dtype=np.uint32)
    out = np.zeros((len(f), 8), dtype=np.uint32)
    limbs = np.zeros((len(f), 10), dtype=np.uint32)
    lib.host_fe_mul(ptr(a), ptr(b), ptr(out), ptr(limbs), len(f), kind)
    assert [words_int(w) for w in out] == \
        [fe_value(x) * fe_value(y) % P for x, y in zip(f, g)]
    if kind >= 2:
        bound = [(1 << w) + int(2 ** 18.2) for w in FE_W]
        bound[0] = (1 << 26) + int(2 ** 22.5)
        assert (limbs < np.array(bound)).all()


def test_fe_words(lib):
    """fe_from_words on any 256-bit value (tight limbs, bit 255 folded as
    19) and fe_to_words back, fully reduced: the edges and random words;
    the ten lanes' own limb loads (fp10_limb) give the same limbs."""
    vals = FE_EDGES + [int.from_bytes(rng.bytes(32), "little")
                       for _ in range(32)]
    w = np.array([[(x >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
                  for x in vals], dtype=np.uint32)
    out = np.zeros_like(w)
    limbs = np.zeros((len(vals), 10), dtype=np.uint32)
    lane_limbs = np.zeros_like(limbs)
    lib.host_fe_words(ptr(w), ptr(out), ptr(limbs), ptr(lane_limbs),
                      len(vals))
    assert [words_int(o) for o in out] == [x % P for x in vals]
    assert np.array_equal(lane_limbs, limbs)
    bound = np.array([(1 << w) + (1 << 18) for w in FE_W])
    assert (limbs < bound).all()


@pytest.mark.parametrize("op", [0, 1, 2], ids=["add", "double",
                                               "add_cached"])
def test_lane_point_ops(lib, op):
    """The lane-split point operations (csrc/lanes.cuh: a point's four
    coordinates on four lanes, each step run lane by lane by the host
    model) against curve.cuh's pt_add and pt_double and the plain
    versions, coordinate for coordinate: the same field values."""
    B0 = RistrettoPoint.basepoint()
    pts = [B0.scalar_mul(x) for x in rand_mod(L, 8)] + \
        [RistrettoPoint.identity()]
    p = curve.encode_points(pts)
    q = curve.encode_points(pts[::-1])
    got = np.zeros_like(p)
    want = np.zeros_like(p)
    lib.host_ls_point(ptr(p), ptr(q), ptr(got), len(pts), op)
    if op == 1:
        lib.host_pt_double(ptr(p), ptr(want), len(pts))
    else:
        lib.host_pt_add(ptr(p), ptr(q), ptr(want), len(pts))
    assert np.array_equal(got, want)
    plain = curve.point_double(torch.from_numpy(p)) if op == 1 else \
        curve.point_add(torch.from_numpy(p), torch.from_numpy(q))
    assert np.array_equal(got, plain.numpy())


@pytest.mark.parametrize("ks", [(0, 1), (1, L - 1), (L - 1, 0), None],
                         ids=["0_1", "1_lm1", "lm1_0", "random"])
def test_fold_host_model(lib, ks):
    """k_fold's host model (csrc/host_check.cpp host_fold: the kernel's
    joint double-and-add from the top set bit on the lane-split
    operations) against the plain fold, as group elements."""
    k_l, k_r = ks if ks else rand_mod(L, 7)[5:]
    B0 = RistrettoPoint.basepoint()
    pl = curve.encode_points([B0.scalar_mul(x) for x in rand_mod(L, 8)[3:]])
    pr = curve.encode_points([B0.scalar_mul(x) for x in rand_mod(L, 8)[3:]])
    k = np.ascontiguousarray(curve.scalar_limbs([k_l, k_r], "cpu").numpy())
    got = np.zeros_like(pl)
    lib.host_fold(ptr(pl), ptr(pr), ptr(k), ptr(got), len(pl))
    want = curve.fold_points_plain(torch.from_numpy(pl),
                                   torch.from_numpy(pr), torch.from_numpy(k))
    assert compressed(got) == compressed(want.numpy())


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 6, 7, 8, 9])
def test_point_sum_host_model(lib, d):
    """k_point_sum's host model (csrc/host_check.cpp host_point_sum: the
    kernel's levels on the lane-split additions, the identity padding an
    odd level, scratch above 4 points) against tree_sum, limb for limb:
    every D up to two levels through scratch (9)."""
    B0 = RistrettoPoint.basepoint()
    pts = curve.encode_points([B0.scalar_mul(x) for x in rand_mod(L, 6)]
                              + [RistrettoPoint.identity()])
    parts = np.ascontiguousarray(np.stack([np.roll(pts, k, 0)
                                           for k in range(d)]))
    got = np.zeros_like(pts)
    lib.host_point_sum(ptr(parts), ptr(got), d, len(pts))
    want = curve.tree_sum(torch.from_numpy(parts), 0).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("k", [0, 1, 2, L - 1, 1 << 252, None],
                         ids=["0", "1", "2", "lm1", "2_252", "random"])
def test_scale_host_model(lib, k):
    """k_scale's host model (csrc/host_check.cpp host_scale: the JAX scan
    from the bottom bit, a set bit one fused addition and doubling, a
    clear bit a doubling) against scale_points_plain, limb for limb; 2^252
    sets only the scan's last bit, the random k has 252 bits."""
    k = k if k is not None else rand_mod(1 << 252, 6)[5] | 1 << 251
    B0 = RistrettoPoint.basepoint()
    pts = curve.encode_points([B0.scalar_mul(x) for x in rand_mod(L, 3)]
                              + [RistrettoPoint.identity()])
    kl = np.ascontiguousarray(curve.scalar_limbs([k], "cpu").numpy()[0])
    got = np.zeros_like(pts)
    lib.host_scale(ptr(pts), ptr(kl), ptr(got), len(pts))
    want = curve.scale_points_plain(torch.from_numpy(pts),
                                    torch.from_numpy(kl)).numpy()
    assert np.array_equal(got, want)


def test_point_add_and_double(lib):
    B0 = RistrettoPoint.basepoint()
    pts = [B0.scalar_mul(x) for x in rand_mod(L, 8)] + \
        [RistrettoPoint.identity()]
    p = curve.encode_points(pts)
    q = curve.encode_points(pts[::-1])
    out = np.zeros_like(p)
    lib.host_pt_add(ptr(p), ptr(q), ptr(out), len(pts))
    assert np.array_equal(out, curve.point_add(torch.from_numpy(p),
                                               torch.from_numpy(q)).numpy())
    lib.host_pt_double(ptr(p), ptr(out), len(pts))
    assert np.array_equal(out, curve.point_double(
        torch.from_numpy(p)).numpy())


def compressed(arr):
    return [p.compress() for p in curve.decode_points(arr)]


def test_signed_digits(lib):
    """K2's recoding (csrc/msm.cuh signed_digits) at its edges and on
    random scalars: sum_w d_w 2^(8 w) is the scalar, every digit in
    [-128, 128), no carry out of window 31 for a canonical scalar (any
    s < l < 2^253), equal to the plain version's digits. From 127 * 2^248
    up a carry leaves window 31: no canonical scalar comes near."""
    vals = msm_edge_scalars() + rand_mod(L, 16)
    limbs = np.ascontiguousarray(curve.scalar_limbs(vals, "cpu").numpy())
    dig = np.zeros((len(vals), 32), dtype=np.int32)
    carry = np.ones(len(vals), dtype=np.int32)
    lib.host_signed_digits(ptr(limbs), ptr(dig), ptr(carry), len(vals))
    assert not carry.any()
    assert dig.min() >= -128 and dig.max() < 128
    assert [sum(int(d) << (8 * w) for w, d in enumerate(row))
            for row in dig] == vals
    assert np.array_equal(dig, msm.signed_digits(
        torch.from_numpy(limbs)).numpy())
    big = lb.ints_to_limbs([(127 << 248) - 1, (127 << 248) + (0x80 << 240),
                            128 << 248])
    big = np.ascontiguousarray(big.astype(np.int32))
    lib.host_signed_digits(ptr(big), ptr(dig), ptr(carry), 3)
    assert list(carry[:3]) == [0, 1, 1]


def test_cached_addition(lib):
    """p + q and p - q through q's cached form (pt_to_cached, cached_neg,
    pt_add_cached) against the host points, the identity on either
    side."""
    B0 = RistrettoPoint.basepoint()
    pts = [B0.scalar_mul(x) for x in rand_mod(L, 8)[3:]] + \
        [RistrettoPoint.identity()]
    p = curve.encode_points(pts + pts[:3] + [pts[-1]])
    q = curve.encode_points(pts[::-1] + [pts[-1]] * 3 + [pts[0]])
    neg = np.array([0, 1] * 5, dtype=np.int32)
    out = np.zeros_like(p)
    lib.host_pt_add_cached(ptr(p), ptr(q), ptr(neg), ptr(out), len(neg))
    hp, hq = curve.decode_points(p), curve.decode_points(q)
    assert compressed(out) == [(a - b if s else a + b).compress()
                               for a, b, s in zip(hp, hq, neg)]


@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_bucket_combine(lib, lanes):
    """The window kernel's bucket sum in its order of additions
    (host_check.cpp lane_sums, then bucket_combine's suffix scan over the
    lanes and its two halving trees, lanes A + B) at 4, 8, 16 and 32
    buckets against sum_m m B_m computed naively, identity buckets among
    them."""
    B0 = RistrettoPoint.basepoint()
    bk = [B0.scalar_mul(x) for x in rand_mod(L, 4 * lanes + 5)[5:]]
    bk[1] = RistrettoPoint.identity()
    arr = curve.encode_points(bk)
    out = np.zeros((1, 4, 16), dtype=np.int32)
    lib.host_bucket_combine(ptr(arr), lanes, ptr(out))
    want = RistrettoPoint.identity()
    for m, b in enumerate(bk, 1):
        want = want + b.scalar_mul(m)
    assert compressed(out) == [want.compress()]


def test_keccak_and_strobe(lib):
    """Keccak-f[1600] against the plain version and the host permutation;
    a random meta_ad / ad / prf schedule (lengths across the 166-byte
    block, continued operations) and challenge_scalar against the host
    transcript, state and outputs after every step."""
    st = rng.integers(0, 256, (4, 200)).astype(np.int32)
    out = np.zeros_like(st)
    lib.host_keccak(ptr(st), ptr(out), 4, 0)
    assert np.array_equal(out, tdev.permute(torch.from_numpy(st)).numpy())
    lanes = [int.from_bytes(st[0, 8 * i:8 * i + 8].astype(np.uint8)
                            .tobytes(), "little") for i in range(25)]
    assert out[0].astype(np.uint8).tobytes() == b"".join(
        v.to_bytes(8, "little") for v in keccak_f1600(lanes))

    t = Transcript(b"headers")
    io = tdev.host_state(t)
    prev = None
    for _ in range(60):
        op = int(rng.integers(3))
        k = int(rng.choice([0, 1, 2, 31, 64, 165, 166, 167, 300]))
        more = op == prev and bool(rng.integers(2))
        data = rng.integers(0, 256, max(k, 1)).astype(np.uint8)
        got = np.zeros(max(k, 1), dtype=np.uint8)
        lib.host_strobe_op(ptr(io), op, ptr(data), ptr(got), k, int(more))
        sb = t.strobe
        if op == 0:
            sb.meta_ad(data[:k].tobytes(), more)
        elif op == 1:
            sb.ad(data[:k].tobytes(), more)
        else:
            assert got[:k].tobytes() == sb.prf(k, more)
        assert np.array_equal(io, tdev.host_state(t))
        prev = op
    c = np.zeros(16, dtype=np.int32)
    lib.host_challenge_scalar(ptr(io), b"probe", ptr(c))
    assert fq.decode(c) == [int(t.challenge_scalar(b"probe"))]
    assert np.array_equal(io, tdev.host_state(t))


def test_keccak_lanes(lib):
    """The lane Keccak (csrc/keccak.cuh kl_* steps, one 64-bit word a lane,
    run lane by lane by keccak_lanes_host) against keccak_f1600 and the
    plain permutation, on random states and the all-zero state."""
    st = rng.integers(0, 256, (6, 200)).astype(np.int32)
    st[0] = 0
    got = np.zeros_like(st)
    ref = np.zeros_like(st)
    lib.host_keccak(ptr(st), ptr(got), len(st), 1)
    lib.host_keccak(ptr(st), ptr(ref), len(st), 0)
    assert np.array_equal(got, ref)
    assert np.array_equal(got, tdev.permute(torch.from_numpy(st)).numpy())


def test_from_bytes_wide(lib):
    """The challenge reduction with halves >= l, up to all-0xFF."""
    wide = [rng.bytes(64), b"\xff" * 64, b"\x00" * 32 + b"\xff" * 32,
            L.to_bytes(32, "little") * 2]
    by = np.frombuffer(b"".join(wide), np.uint8).astype(np.int32)
    out = np.zeros((len(wide), 16), dtype=np.int32)
    lib.host_from_bytes_wide(ptr(by), ptr(out), len(wide))
    assert fq.decode(out) == [int.from_bytes(w, "little") % L for w in wide]
    assert np.array_equal(out, tdev.from_bytes_wide(
        torch.from_numpy(by.reshape(-1, 64))).numpy())


def test_compress_and_comb(lib):
    """ENCODE against the plain version and the host (random points, the
    identity); comb commitments of 4 G + h against the plain version, limb
    for limb (the same order of additions), with a zero scalar."""
    B0 = RistrettoPoint.basepoint()
    pts = [B0.scalar_mul(x) for x in rand_mod(L, 6)[3:]] + \
        [RistrettoPoint.identity()]
    arr = curve.encode_points(pts)
    out = np.zeros((len(pts), 32), dtype=np.int32)
    lib.host_compress(ptr(arr), ptr(out), len(pts))
    assert np.array_equal(out, rdev.compress(torch.from_numpy(arr)).numpy())
    assert [bytes(o.astype(np.uint8)) for o in out] == \
        [p.compress() for p in pts]
    gens = MultiCommitGens(4, b"headers_comb")
    tab = rdev.make_comb_tables(gens.G + [gens.h])
    sm = fq.encode(rand_mod(L, 10)).reshape(2, 5, 16)
    sm[1, 2] = 0
    got = np.zeros((2, 4, 16), dtype=np.int32)
    lib.host_comb(ptr(tab), 5, ptr(sm), ptr(got), 2, 64)
    want = rdev.comb_commit(torch.from_numpy(tab), torch.from_numpy(sm))
    assert np.array_equal(got, want.numpy())
    # K11's Cy / beta layout (32 groups, two windows each): the same
    # points in another order of additions
    lib.host_comb(ptr(tab), 5, ptr(sm), ptr(got), 2, 32)
    assert compressed(got) == compressed(want.numpy())


def test_round_tail(lib):
    """K11's round tail (two table sets) against the plain tail on the
    same buffers: transcript state, carry and messages, exact."""
    gens_n = MultiCommitGens(4, b"headers_tail")
    gens_1 = MultiCommitGens(1, b"headers_tail_1")
    tab_n = rdev.make_comb_tables(gens_n.G + [gens_n.h])
    tab_1 = rdev.make_comb_tables(gens_1.G + [gens_1.h])
    evs = fq.encode(rand_mod(L, 6)).reshape(2, 3, 16)
    st = tdev.host_state(Transcript(b"headers_tail"))
    carry = np.concatenate([fq.encode(rand_mod(L, 6)[5:]),
                            rng.integers(0, 256, (2, 16))]).astype(np.int32)
    tape = np.concatenate([fq.encode(rand_mod(L, 9)),
                           rng.integers(0, 256, (2, 16))]).astype(np.int32)
    out = np.zeros((zkr.OUT_ROWS, 16), dtype=np.int32)
    bufs = [torch.from_numpy(a.copy()) for a in (st, carry, out)]
    lib.host_zk_round_tail(ptr(evs), 2, ptr(st), ptr(carry), ptr(tape),
                           ptr(out), ptr(tab_n), ptr(tab_1))
    zkr.zk_round_tail(torch.from_numpy(evs), bufs[0], bufs[1],
                      torch.from_numpy(tape), bufs[2],
                      torch.from_numpy(tab_n), torch.from_numpy(tab_1))
    for got, want in zip((st, carry, out), bufs):
        assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("ell", [0, 1, 5, 11, 14])
def test_eq_table_chunks(lib, ell):
    """K1's eq table as k_eq_evals builds it (csrc/eq.cuh: chunks of 2^10
    entries, each chunk's high factor by the lane tree, then the doubling
    levels in place) against eq_evals' plain version, limb for limb; the
    challenges include 0, 1 and l - 1."""
    from spartan_parallel_tpu_torch.models.dense_mlpoly import eq_evals_plain

    rs = fq.encode(rand_mod(L, max(ell, 5))[:ell][::-1]).reshape(ell, 16)
    out = np.zeros((1 << ell, 16), dtype=np.int32)
    lib.host_eq_evals(ptr(np.ascontiguousarray(rs)), ell, ptr(out))
    want = eq_evals_plain(torch.from_numpy(rs), ell)
    assert np.array_equal(out, want.numpy())


def _crowded(nseg, ncols, n_major, n_minor, extra):
    """Entries with one segment of n_major entries (segment 0) and one
    operand index of n_minor (index 0), the rest random."""
    major = np.concatenate([np.zeros(n_major, np.int64),
                            rng.integers(0, nseg, n_minor + extra)])
    minor = np.concatenate([rng.integers(0, ncols, n_major),
                            np.zeros(n_minor, np.int64),
                            rng.integers(0, ncols, extra)])
    return major, minor


# (segments, operand width, matrices (entries in segment 0, at index 0,
# random), instance matrices, right-hand sides, kk, bit-reversed q and s)
SPMV_CASES = {
    "long_row": (16, 16, [(900, 0, 300)], [0, 0], [3, 1], 1, (2, 4)),
    "long_column": (16, 64, [(700, 0, 50), (0, 600, 40), (3, 3, 9)],
                    [0], [2], 3, (1, 0)),
    "ragged": (32, 16, [(5, 2, 60)] * 9, [2, 0, 1], [4, 2, 0], 3, (2, 5)),
    "empty": (8, 8, [(0, 0, 0), (0, 0, 3), (0, 0, 1)], [0, 0], [1, 2], 3,
              (0, 3)),
}


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_spmv_work_split(lib, case):
    """K3's work split as k_spmv runs it (csrc/spmv.cuh: ranges of 256
    items a warp, a segment finished by the warp of its first item, long
    segments summed from every warp's partials) against spmv_many's plain
    version, limb for limb: a segment of 900 entries (several warps'
    ranges), matrices of distinct instances with ragged right-hand sides
    (one with none), empty matrices, q and s written bit-reversed."""
    from spartan_parallel_tpu_torch.ops import spmv

    nseg, ncols, shapes, mats, counts, kk, bits = SPMV_CASES[case]
    st = spmv.stack([(*_crowded(nseg, ncols, *sh),
                      fq.encode(rand_mod(L, sum(sh)))[:sum(sh)])
                     for sh in shapes], nseg, "cpu")
    ni, qmax = len(counts), 1 << max(0, (max(counts) - 1).bit_length())
    x = fq.encode(rand_mod(L, ni * qmax * ncols)).reshape(ni, qmax, ncols,
                                                          16)
    xs, os_ = (qmax * ncols, ncols), (ni * qmax * nseg, qmax * nseg, nseg)
    want = torch.zeros((kk, ni, qmax, nseg, 16), dtype=torch.int32)
    spmv.spmv_many(st, torch.from_numpy(x), want, counts, mats, kk, xs,
                   os_, bits)
    got = np.zeros(want.shape, dtype=np.int32)
    per = st.host[:, 2] + st.host[:, 4]
    off = np.cumsum([0] + [c * int(per[kk * m + k]) for c, m in
                           zip(counts, mats) for k in range(kk)])
    lib.host_spmv_many(
        *(ptr(np.ascontiguousarray(a)) for a in (
            st.ptr.numpy(), st.seg.numpy(), st.idx.numpy(),
            st.vals.numpy(), st.empty.numpy(), st.host, x)), ptr(got),
        ptr(np.array(xs + os_, dtype=np.int64)),
        ptr(np.array([kk, *bits, 0], dtype=np.int32)),
        ptr(np.array(mats, dtype=np.int32)),
        ptr(np.array(counts, dtype=np.int32)), ni,
        ptr(off.astype(np.int64)))
    assert np.array_equal(got, want.numpy())
    if case.startswith("long"):
        assert st.longest > spmv.SPMV_CAP
