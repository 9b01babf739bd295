"""The hand-written CUDA kernels against their plain versions on the card,
at small shapes, and a small NIZK proved on the card and on the CPU.
Marked `gpu`: these skip on a host without a CUDA card (CUDA kernels have
no CPU mode). chip_smoke.py runs the same comparisons at the NIZK's
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
    from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens

    pts = MultiCommitGens(16, b"gpu_test").device_points(dev)[:16]
    scal = rand_field((3, 16), dev, 4)
    got = [p.compress() for p in curve.decode_points(msm.msm_dev(pts, scal))]
    want = [p.compress() for p in curve.decode_points(
        msm.msm_plain(pts, scal))]
    assert got == want
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
