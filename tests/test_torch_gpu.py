"""The hand-written CUDA kernels against their plain versions on the card,
at small shapes, and a small NIZK proved on the card and on the CPU.
Marked `gpu`: these skip on a host without a CUDA card (CUDA kernels have
no CPU mode). chip_smoke.py runs the same comparisons at the main paths'
full shapes.

    python -m pytest tests/test_torch_gpu.py -q     # on a machine with a card
"""

import pytest
import torch

from spartan_parallel_tpu_torch.core.consts import L
from spartan_parallel_tpu_torch.ops import curve, fq, msm, spmv
from spartan_parallel_tpu_torch.ops import sumcheck as sck

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the kernels run only on the card")
    return torch.device("cuda")


def rand_field(shape, dev, seed=0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    t = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=g,
                      device=dev, dtype=torch.int32)
    t[..., 15] &= 0x0FFF
    return t


def test_fq_kernels(dev):
    a, b = rand_field((1000,), dev, 1), rand_field((1000,), dev, 2)
    r = rand_field((), dev, 3)
    for op, plain in ((fq.mul, fq.mul_plain), (fq.add, fq.add_plain),
                      (fq.sub, fq.sub_plain)):
        assert torch.equal(op(a, b), plain(a, b))
        assert torch.equal(op(a, r), plain(a, r))
    t = a[:512].reshape(4, 8, 16, 16)
    assert torch.equal(fq.bind(t, r, 1, 4), fq.bind_plain(t, r, 1, 4))
    m = a[:640].reshape(10, 64, 16)
    assert torch.equal(fq.dot(m, b[:10, None], 0),
                       fq.dot_plain(m, b[:10, None], 0))
    assert torch.equal(fq.dot(a, b), fq.dot_plain(a, b))


def test_msm_and_fold_kernels(dev):
    """K2 against msm_plain at 3 x 16 and at the paths' shapes: single
    rows of 34 and 514 points (the bullet rounds), 1024 rows x 1025 points
    (the NIZK 2^20's commit), and points beyond one launch (1 x 8193, 65 x
    2049: chunks summed by K12); scalars random and with bytes 0-30 all
    0x80 (every digit negative, a carry into each window); then the fold."""
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens

    pts = MultiCommitGens(16, b"gpu_test").device_points(dev)[:16]
    many = curve.multiples(pts, 512).reshape(-1, 4, 16)  # k G_j, k < 512
    many = torch.cat([many, pts[:1]])
    edge = torch.full((65, 2049, 16), 0x8080, dtype=torch.int32, device=dev)
    edge[..., 15] = 0x0F80
    cases = [(pts, rand_field((3, 16), dev, 4))]
    for seed, (b, n) in enumerate(((1, 34), (1, 514), (1024, 1025),
                                   (1, 8193), (65, 2049)), 10):
        cases.append((many[-n:], rand_field((b, n), dev, seed)))
    cases += [(many[-34:], edge[:1, :34]), (many[-2049:], edge)]
    for p, scal in cases:
        got = [q.compress() for q in curve.decode_points(
            msm.msm_dev(p, scal))]
        want = [q.compress() for q in curve.decode_points(
            msm.msm_plain(p, scal))]
        assert got == want, tuple(scal.shape)
    k = curve.scalar_limbs([L - 1, 12345], dev)
    got = curve.fold_points(pts[:8], pts[8:], L - 1, 12345)
    want = curve.fold_points_plain(pts[:8], pts[8:], k)
    assert [p.compress() for p in curve.decode_points(got)] == \
        [p.compress() for p in curve.decode_points(want)]


def test_spmv_kernels(dev):
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )

    inst, _, _ = produce_synthetic_r1cs(1, [1], 64, 64, 4, device=dev)
    csr, csc, coo = inst.B_list[0]._tensors(dev)
    z = rand_field((2, 128), dev, 5)
    rx, ry = rand_field((64,), dev, 6), rand_field((128,), dev, 7)
    assert torch.equal(spmv.spmv_batched(*csr, z), spmv.spmv_plain(*csr, z))
    assert torch.equal(spmv.eval_table(*csc, rx),
                       spmv.eval_table_plain(*csc, rx))
    assert torch.equal(spmv.sparse_eval(*coo, rx, ry),
                       spmv.sparse_eval_plain(*coo, rx, ry))


def test_sumcheck_kernels(dev):
    tp, tq, tx = (rand_field((n,), dev, 8 + n) for n in (2, 2, 16))
    B, C, D = (rand_field((2, 2, 16), dev, 20 + i) for i in range(3))
    r = rand_field((), dev, 30)
    for mode in (sck.MODE_X, sck.MODE_Q, sck.MODE_P):
        assert torch.equal(sck.p1_evals(tp, tq, tx, B, C, D, 1, mode),
                           sck.p1_evals_plain(tp, tq, tx, B, C, D, 1, mode))
    ev, tabs = sck.p1_step(tp, tq, tx, B, C, D, r, 8, 4, sck.MODE_X,
                           sck.MODE_X)
    ev2, tabs2 = sck.p1_step_plain(tp, tq, tx, B, C, D, r, 8, 4, sck.MODE_X,
                                   sck.MODE_X)
    assert torch.equal(ev, ev2)
    assert all(torch.equal(a, b) for a, b in zip(tabs, tabs2))
    ep = rand_field((2,), dev, 40)
    for single in (True, False):
        ABC = rand_field((1 if single else 2, 2, 16), dev, 41)
        Z = rand_field((2, 2, 16), dev, 42)
        ev, tabs = sck.p2_step(ep, ABC, Z, r, 8, 4, sck.MODE_X, sck.MODE_X,
                               single)
        ev2, tabs2 = sck.p2_step_plain(ep, ABC, Z, r, 8, 4, sck.MODE_X,
                                       sck.MODE_X, single)
        assert torch.equal(ev, ev2)
        assert all(torch.equal(a, b) for a, b in zip(tabs, tabs2))
        for mode in (sck.MODE_X, sck.MODE_W, sck.MODE_P):
            assert torch.equal(
                sck.p2_evals(ep, ABC, Z, 1, mode, single),
                sck.p2_evals_plain(ep, ABC, Z, 1, mode, single))


def test_sumcheck_dp_modes(dev):
    """K4 in the q and p rounds of phase 1 and the w and p rounds of
    phase 2 with one ABC table per instance (fused steps included)."""
    tp, tq, tx = (rand_field((n,), dev, 50 + n) for n in (4, 8, 1))
    B, C, D = (rand_field((4, 8, 1), dev, 60 + i) for i in range(3))
    r = rand_field((), dev, 70)
    # the prover's p rounds come after q is bound, on (P, 1, 1) tables; a
    # step given the unbound q axis collapses it as the plain step does
    for mode, nh_prev, nh, q in ((sck.MODE_Q, 4, 2, 8), (sck.MODE_P, 2, 1, 1),
                                 (sck.MODE_P, 2, 1, 8)):
        tabs = (tp, tq[:q], tx, B[:, :q], C[:, :q], D[:, :q])
        ev, got = sck.p1_step(*tabs, r, nh_prev, nh, mode, mode)
        ev2, want = sck.p1_step_plain(*tabs, r, nh_prev, nh, mode, mode)
        assert torch.equal(ev, ev2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    ep = rand_field((4,), dev, 71)
    ABC, Z = rand_field((4, 4, 4), dev, 72), rand_field((4, 4, 4), dev, 73)
    # the w rounds come after y is bound, the p rounds after w and y
    for mode, w, y in ((sck.MODE_X, 4, 4), (sck.MODE_W, 4, 1),
                       (sck.MODE_P, 1, 1), (sck.MODE_P, 4, 4)):
        tabs = (ep, ABC[:, :w, :y], Z[:, :w, :y])
        ev, got = sck.p2_step(*tabs, r, 2, 1, mode, mode, False)
        ev2, want = sck.p2_step_plain(*tabs, r, 2, 1, mode, mode, False)
        assert torch.equal(ev, ev2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_classed_sumcheck_kernel(dev):
    """K5 (one q-size class at p0 = 1, q stride S = 2 of the shared eq
    tables) in its active-x, active-q and inactive-q forms, fused and
    unfused, the transitions between them, pc_bind and eq_fold."""
    X, Q = sck.MODE_X, sck.MODE_Q
    tp, tq, tx = (rand_field((n,), dev, 80 + n) for n in (4, 8, 16))
    T = tuple(rand_field((2, 4, 16), dev, 90 + i) for i in range(3))
    r = rand_field((), dev, 99)
    kw = dict(p0=1, S=2)

    def same(got, want):
        return torch.equal(got[0], want[0]) and all(
            torch.equal(a, b) for a, b in zip(got[1], want[1]))

    assert torch.equal(sck.pc_evals(tp, tq, tx, *T, 8, X, active=True, **kw),
                       sck.pc_evals_plain(tp, tq, tx, *T, 8, X, active=True,
                                          **kw))
    # (mode_prev, active_prev, n_half_prev, mode, active, n_half)
    for step in ((X, True, 8, X, True, 4), (X, True, 1, Q, True, 2),
                 (Q, True, 1, Q, False, 2)):
        args = (tp, tq, tx, *T, r, step[2], step[5], step[0], step[3])
        got = sck.pc_step(*args, active_prev=step[1], active=step[4], **kw)
        assert same(got, sck.pc_step_plain(*args, active_prev=step[1],
                                           active=step[4], **kw))
    Tq = tuple(t[:, :, :1].contiguous() for t in T)
    for active, nh in ((True, 2), (False, 1)):
        assert torch.equal(
            sck.pc_evals(tp, tq, tx, *Tq, nh, Q, active=active, **kw),
            sck.pc_evals_plain(tp, tq, tx, *Tq, nh, Q, active=active, **kw))
    # fused q rounds, the first on tables whose x axis is not collapsed
    fused = ((T, True, 2, 1), (Tq, True, 2, 1),
             (tuple(t[:, :1] for t in Tq), False, 2, 1))
    for tabs, active, nh_prev, nh in fused:
        args = (tp, tq, tx, *tabs, r, nh_prev, nh, Q, Q)
        assert same(sck.pc_step(*args, active_prev=active, active=active,
                                **kw),
                    sck.pc_step_plain(*args, active_prev=active,
                                      active=active, **kw))
    for active in (True, False):
        got = sck.pc_bind(*Tq, r, 2, Q, active)
        want = sck.pc_bind_plain(*Tq, r, 2, Q, active)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(sck.eq_fold(tq, r, 4), fq.bind_plain(tq, r, 0, 4))


@pytest.mark.parametrize("B,n", [(3, 8), (2, 2), (1, 6000), (4, 8192)])
def test_product_kernels(dev, B, n):
    """K6 (layer, cubic round with a shared and a per-instance C) and the
    pt_fold bind against their plain versions, from the last layer (n = 2)
    to rounds of several chunks (h = 3000 and 4096 pairs)."""
    from spartan_parallel_tpu_torch.ops import product as pk

    left, right = rand_field((B, n), dev, 100), rand_field((B, n), dev, 101)
    got, want = pk.layer_mul(left, right), pk.layer_mul_plain(left, right)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    C = rand_field((n,), dev, 102)
    Cb = rand_field((B, n), dev, 103)
    for c in (C, Cb):
        assert torch.equal(pk.cubic_evals(left, right, c),
                           pk.cubic_evals_plain(left, right, c))
    r = rand_field((), dev, 104)
    for t in (left, C):
        assert torch.equal(pk.fold(t, r), pk.fold_plain(t, r))


def test_nizk_card_matches_cpu(dev):
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.models.nizk import NIZK, NIZKGens
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    out = []
    for d in (dev, "cpu"):
        inst, vm, im = produce_synthetic_r1cs(1, [1], 64, 64, 4, device=d)
        gens = NIZKGens(64, 64, device=d)
        proof = NIZK.prove(inst, vm[0][0], im[0][0], gens, Transcript(b"t"),
                           RandomTape(b"proof", seed=b"\x05" * 32), device=d)
        proof.verify(inst, im[0][0], gens, Transcript(b"t"), device=d)
        out.append(ser.serialize(proof, "NIZK"))
    assert out[0] == out[1]


@pytest.mark.parametrize("num_proofs", [[8, 2, 1], [2, 2, 2, 2]])
def test_dp_proof_card_matches_cpu(dev, num_proofs):
    """The data-parallel R1CSProof at 16 x 16 x 4, classed (skewed counts)
    and dense (uniform counts): card and CPU bytes agree, and it verifies."""
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.models import r1csproof as rp
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    P, qmax = len(num_proofs), max(num_proofs)
    out = []
    for d in (dev, "cpu"):
        inst, vm, im = produce_synthetic_r1cs(P, num_proofs, 16, 16, 4,
                                              seed=13, device=d)
        io = [[[1] + list(v) + [0] * (15 - len(v)) for v in im[p]]
              for p in range(P)]
        secs = [rp.ProverWitnessSecInfo.from_scalars([16] * P, m, d)
                for m in (vm, io)]
        gens = rp.R1CSGens(b"gpu_dp", 16, qmax * 16)
        proof, r = rp.R1CSProof.prove(
            P, qmax, num_proofs, 16, [16] * P, secs, inst, gens,
            Transcript(b"t"), RandomTape(b"proof", seed=b"\x0b" * 32), d)
        comms = [[s.poly_w[p].commit(gens.gens_pc, None)[0]
                  for p in range(P)] for s in secs]
        _, bound = inst.multi_evaluate_bound_rp(r[0], r[2], r[3], device=d)
        views = [rp.VerifierWitnessSecInfo(num_proofs, [16] * P, c)
                 for c in comms]
        assert proof.verify(P, qmax, num_proofs, 16, views, 16, gens, bound,
                            Transcript(b"t"), d) == r
        out.append(ser.serialize(proof, "R1CSProof"))
    assert out[0] == out[1]


def test_snark_card_matches_cpu(dev):
    """The upstream SNARK with SPARK at 16 x 16 x 4 under a fixed tape:
    encode and prove on the card and on the CPU give the same bytes, and
    both verify."""
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.models.snark_single import (
        SpartanSNARK,
        SpartanSNARKGens,
    )
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    out = []
    for d in (dev, "cpu"):
        inst, vm, im = produce_synthetic_r1cs(1, [1], 16, 16, 4, device=d)
        gens = SpartanSNARKGens(16, 16, 16)
        comm, decomm = SpartanSNARK.encode(inst, gens, device=d)
        proof = SpartanSNARK.prove(inst, comm, decomm, vm[0][0], im[0][0],
                                   gens, Transcript(b"t"),
                                   RandomTape(b"proof", seed=b"\x09" * 32),
                                   device=d)
        proof.verify(comm, im[0][0], gens, Transcript(b"t"), device=d)
        out.append((ser.serialize(comm, "R1CSCommitment"),
                    ser.serialize(proof, "SpartanSNARK")))
    assert out[0] == out[1]


@pytest.mark.parametrize("n", [1, 2, 7, 1000, 4097, 1 << 14])
def test_powers_kernel(dev, n):
    """K7 against fq_powers_plain, and the rlc dot (K1, counted as
    rlc_eval) against its plain version, across tile edges."""
    from spartan_parallel_tpu_torch.ops import kernels, uni

    c = rand_field((), dev, 5)
    got = uni.fq_powers(c, n)
    assert torch.equal(got, uni.fq_powers_plain(c, n))
    z = rand_field((n,), dev, 6)
    before = kernels.launches.get("rlc_eval", 0)
    assert torch.equal(fq.dot(z, got, 0, counter="rlc_eval"),
                       fq.dot_plain(z, got, 0))
    assert kernels.launches["rlc_eval"] == before + 1


def test_counter_snark_card_matches_cpu(dev):
    """The 9-stage SNARK of the counter program under a fixed tape: set-up
    and prove on the card and on the CPU give the same bytes, and the
    card's proof verifies there."""
    from spartan_parallel_tpu_torch import examples as ex
    from spartan_parallel_tpu_torch import serialization as ser

    out = []
    for d in (dev, "cpu"):
        args, pa = ex.build_counter_program()
        ctx = ex.setup_counter_instances(args, device=d)
        proof = ex.prove_counter(pa, ctx, tape_seed=b"\x07" * 32, device=d)
        ex.verify_counter(proof, pa, ctx, device=d)
        out.append(ser.serialize(proof, "SNARK"))
    assert out[0] == out[1]


def test_zk_round_kernels(dev):
    """K8-K11 against their plain versions: Keccak on 37 states, ENCODE of
    random points and the identity, comb commitments of 4 G + h and G + h
    with a zero scalar, and one round tail over two table sets."""
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.ops import ristretto_dev as rdev
    from spartan_parallel_tpu_torch.ops import transcript_dev as tdev
    from spartan_parallel_tpu_torch.ops import zk_round as zkr
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    g = torch.Generator(device=dev)
    g.manual_seed(7)
    st = torch.randint(0, 256, (37, 200), generator=g, device=dev,
                       dtype=torch.int32)
    assert torch.equal(tdev.permute(st), tdev.permute_plain(st))
    tabs = [MultiCommitGens(n, b"gpu_zk").comb_tables(dev) for n in (4, 1)]
    for tab in tabs:
        sc = rand_field((3, tab.shape[0]), dev, 8)
        sc[1, 0] = 0
        pts = rdev.comb_commit(tab, sc)
        assert torch.equal(pts, rdev.comb_commit_plain(tab, sc))
        pts = torch.cat([pts, torch.as_tensor(curve.identity((1,)),
                                              device=dev)])
        assert torch.equal(rdev.compress(pts), rdev.compress_plain(pts))
    st0 = tdev.from_host(Transcript(b"gpu_zk"), dev)
    carry = torch.cat([rand_field((1,), dev, 9), rand_field((2,), dev, 10)
                       & 0xFF])
    tape = torch.cat([rand_field((9,), dev, 11), rand_field((2,), dev, 12)
                      & 0xFF])
    evs = rand_field((2, 3), dev, 13)
    out = []
    for fn in (zkr.zk_round_tail, zkr.zk_round_tail_plain):
        bufs = [st0.clone(), carry.clone(),
                torch.zeros((zkr.OUT_ROWS, 16), dtype=torch.int32,
                            device=dev)]
        fn(evs, bufs[0], bufs[1], tape, bufs[2], *tabs)
        out.append(torch.cat([b.flatten() for b in bufs]))
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("pairs", [1, 8, 33, 512])
def test_fold_kernel(dev, pairs):
    """fold_points (k_fold: eight pairs a warp, a point on four lanes)
    against fold_points_plain at 1, 8, 33 and 512 pairs (idle groups in
    the last warp), with the scalars 0, 1, l - 1 and random ones, as group
    elements."""
    from spartan_parallel_tpu_torch.core.edwards import RistrettoPoint
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens

    pts = MultiCommitGens(2 * pairs, b"gpu_fold").device_points(dev)
    pl, pr = pts[:pairs], pts[pairs:2 * pairs]
    kr = fq.decode(rand_field((2,), dev, pairs).cpu())
    for k_l, k_r in ((0, 0), (0, 1), (1, L - 1), (L - 1, L - 1),
                     (kr[0], kr[1])):
        got = curve.fold_points(pl, pr, k_l, k_r)
        want = curve.fold_points_plain(pl, pr,
                                       curve.scalar_limbs([k_l, k_r], dev))
        assert [p.compress() for p in curve.decode_points(got)] == \
            [p.compress() for p in curve.decode_points(want)]
        if k_l == k_r == 0:
            ident = RistrettoPoint.identity().compress()
            assert all(p.compress() == ident
                       for p in curve.decode_points(got))


def test_zk_round_tail_two_rounds(dev):
    """Two consecutive K11 rounds (the second reads the first's transcript
    state and carry) against zk_round_tail_plain: state, carry and out,
    byte for byte after each round."""
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.ops import transcript_dev as tdev
    from spartan_parallel_tpu_torch.ops import zk_round as zkr
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    tab_n = MultiCommitGens(4, b"gpu_zk2").comb_tables(dev)
    tab_1 = MultiCommitGens(1, b"gpu_zk2").comb_tables(dev)
    carry = torch.cat([rand_field((1,), dev, 20), rand_field((2,), dev, 21)
                       & 0xFF])
    bufs = {}
    for fn in (zkr.zk_round_tail, zkr.zk_round_tail_plain):
        bufs[fn] = [tdev.from_host(Transcript(b"gpu_zk2"), dev),
                    carry.clone(),
                    torch.zeros((zkr.OUT_ROWS, 16), dtype=torch.int32,
                                device=dev)]
    for rnd in range(2):
        tape = torch.cat([rand_field((9,), dev, 22 + rnd),
                          rand_field((2,), dev, 24 + rnd) & 0xFF])
        evs = rand_field((1, 3), dev, 26 + rnd)
        for fn, b in bufs.items():
            fn(evs, b[0], b[1], tape, b[2], tab_n, tab_1)
        card, plain = bufs.values()
        for x, y in zip(card, plain):
            assert torch.equal(x, y), f"round {rnd}"


@pytest.mark.parametrize("num_proofs", [[8, 2, 1], [2, 2, 2, 2]])
def test_device_rounds_match_host_loop(dev, monkeypatch, num_proofs):
    """The data-parallel R1CSProof at 16 x 16 x 4 on the card: the
    device-resident rounds (the default) and the host loop
    (models/sumcheck.py _device_rounds_on patched off) give the same
    bytes."""
    from spartan_parallel_tpu_torch import serialization as ser
    from spartan_parallel_tpu_torch.models import r1csproof as rp
    from spartan_parallel_tpu_torch.models import sumcheck as msum
    from spartan_parallel_tpu_torch.models.r1csinstance import (
        produce_synthetic_r1cs,
    )
    from spartan_parallel_tpu_torch.ops import kernels
    from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
    from spartan_parallel_tpu_torch.utils.transcript import Transcript

    P, qmax = len(num_proofs), max(num_proofs)
    inst, vm, im = produce_synthetic_r1cs(P, num_proofs, 16, 16, 4,
                                          seed=13, device=dev)
    io = [[[1] + list(v) + [0] * (15 - len(v)) for v in im[p]]
          for p in range(P)]
    secs = [rp.ProverWitnessSecInfo.from_scalars([16] * P, m, dev)
            for m in (vm, io)]
    gens = rp.R1CSGens(b"gpu_dp", 16, qmax * 16)
    out = []
    for on_card in (True, False):
        if not on_card:
            monkeypatch.setattr(msum, "_device_rounds_on", lambda d: False)
        before = kernels.launches.get("zk_round_tail", 0)
        proof, _ = rp.R1CSProof.prove(
            P, qmax, num_proofs, 16, [16] * P, secs, inst, gens,
            Transcript(b"t"), RandomTape(b"proof", seed=b"\x0b" * 32), dev)
        tails = kernels.launches.get("zk_round_tail", 0) - before
        rounds = len(proof.sc_proof_phase1.comm_polys) + \
            len(proof.sc_proof_phase2.comm_polys)
        assert tails == (rounds if on_card else 0)
        out.append(ser.serialize(proof, "R1CSProof"))
    assert out[0] == out[1]


def test_point_sum_and_scale_kernels(dev):
    """K12 and K13 against their plain versions, limb for limb (both
    follow the plain order of additions): point sums of 2, 3 and 5
    partials, and k * P for k = 0, 1, l - 1 and a 252-bit k."""
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens

    pts = MultiCommitGens(40, b"gpu_test").device_points(dev)[:40]
    for d in (2, 3, 5):
        parts = pts[:8 * d].reshape(d, 8, 4, 16)
        assert torch.equal(curve.point_sum(parts), curve.tree_sum(parts, 0))
    for k in (0, 1, L - 1, (1 << 252) - 12345):
        kl = curve.scalar_limbs([k], dev)[0]
        assert torch.equal(curve.scale_points(pts[:16], k),
                           curve.scale_points_plain(pts[:16], kl))


def test_gloo_ranks_share_the_card(dev):
    """Two ranks on the one card over gloo: the q-sharded phase-1 round on
    the dryrun tables and the sharded MSM equal the single-rank results."""
    from spartan_parallel_tpu_torch import _dryrun_stages as ds
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.parallel.mesh import dryrun_tables

    from .torch_shared import rank_jobs

    tables = {k: v.numpy() for k, v in dryrun_tables(2, 8, 8).items()}
    pts = MultiCommitGens(64, b"gpu_test").device_points(dev)[:64]
    scal = rand_field((4, 64), dev, 9)
    jobs = [("sharded_round", (tables, 4, sck.MODE_X)),
            ("msm_sharded", (pts.cpu().numpy(), scal.cpu().numpy()))]
    reps = ds.launch(rank_jobs, 2, args=(jobs,), timeout=300)
    want = ds.sharded_round(None, dev, tables, 4, sck.MODE_X)
    msm_want = [p.compress() for p in msm.msm(pts, scal)]
    for rep in reps:
        assert rep["backend"] == "gloo" or torch.cuda.device_count() > 1
        assert torch.equal(torch.from_numpy(rep["result"][0]["evals"]),
                           torch.from_numpy(want["evals"]))
        assert rep["result"][1] == msm_want
        assert rep["launches"].get("point_sum") and \
            rep["launches"].get("msm_batched")


def test_nccl_ranks_on_their_own_cards(dev):
    """Four ranks over NCCL, each on a card of its own (skips with fewer
    than four cards): the NIZK on a 2 x 2 mesh, the q-sharded round and
    the sharded MSM equal the single-rank results."""
    from spartan_parallel_tpu_torch import _dryrun_stages as ds
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
    from spartan_parallel_tpu_torch.parallel.mesh import dryrun_tables

    from .torch_shared import rank_jobs

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    nizk = (64, 4, 2, b"\x07" * 32, b"dryrun")
    tables = {k: v.numpy() for k, v in dryrun_tables(2, 8, 8).items()}
    pts = MultiCommitGens(64, b"gpu_test").device_points(dev)[:64]
    scal = rand_field((4, 64), dev, 9)
    jobs = [("stage_2_nizk", nizk),
            ("sharded_round", (tables, 4, sck.MODE_X)),
            ("msm_sharded", (pts.cpu().numpy(), scal.cpu().numpy()))]
    reps = ds.launch(rank_jobs, 4, args=(jobs,), shape=(2, 2), timeout=600)
    want = ds.stage_2_nizk(None, dev, *nizk)["bytes"]
    evals = ds.sharded_round(None, dev, tables, 4, sck.MODE_X)["evals"]
    msm_want = [p.compress() for p in msm.msm(pts, scal)]
    assert sorted(r["device"] for r in reps) == \
        [f"cuda:{k}" for k in range(4)]
    for rep in reps:
        assert rep["backend"] == "nccl"
        assert rep["result"][0]["bytes"] == want
        assert rep["result"][0]["split_rounds"] == [4, 4]
        assert torch.equal(torch.from_numpy(rep["result"][1]["evals"]),
                           torch.from_numpy(evals))
        assert rep["result"][2] == msm_want
        assert rep["launches"].get("point_sum")
