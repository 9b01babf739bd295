"""K2 (MSM and the bullet generator fold) and the point arithmetic under
it: the port's plain path against the JAX package's ops/curve.py and
ops/msm.py on the same inputs. Points are compared after ristretto
compression; the tolerance is exact equality."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spartan_parallel_tpu.core.consts import L
from spartan_parallel_tpu.core.edwards import RistrettoPoint
from spartan_parallel_tpu.ops import curve as jcurve
from spartan_parallel_tpu.ops import limbs as jlb
from spartan_parallel_tpu.ops import msm as jmsm
from spartan_parallel_tpu_torch.ops import curve, msm

from .torch_shared import in_fresh_process, msm_edge_scalars, shared_result

rng = np.random.default_rng(31)


def rand_scalar():
    return int.from_bytes(rng.bytes(40), "little") % L


def points(n):
    B0 = RistrettoPoint.basepoint()
    return [B0.scalar_mul(rand_scalar()) for _ in range(n)] + \
        [RistrettoPoint.identity()]


def enc_jax(pts):
    return jnp.asarray(jcurve.encode_points(pts))


def enc_port(pts):
    return torch.from_numpy(jcurve.encode_points(pts).astype(np.int32))


def compressed_jax(arr):
    return [p.compress() for p in jcurve.decode_points(np.asarray(arr))]


def compressed_port(t):
    return [p.compress() for p in curve.decode_points(t)]


def test_codec_matches_jax():
    pts = points(3)
    assert np.array_equal(curve.encode_points(pts),
                          jcurve.encode_points(pts).astype(np.int32))


def test_point_add_double_match_jax():
    pts = points(3)
    p, q = pts, pts[::-1]
    assert compressed_port(curve.point_add(enc_port(p), enc_port(q))) == \
        compressed_jax(jcurve.point_add(enc_jax(p), enc_jax(q)))
    assert compressed_port(curve.point_double(enc_port(p))) == \
        compressed_jax(jcurve.point_double(enc_jax(p)))


def test_aligned_points():
    """K12 and K13 load a coordinate as four 16-byte vectors: their
    wrappers copy a contiguous view that starts off a 16-byte boundary
    and pass an aligned one as it is."""
    flat = torch.arange(65 * 64, dtype=torch.int32)
    off = flat[1:1 + 64 * 64].view(64, 4, 16)
    got = curve._aligned(off)
    assert off.data_ptr() % 16 and got.data_ptr() % 16 == 0
    assert torch.equal(got, off)
    pts = flat[64:].view(64, 4, 16)
    assert curve._aligned(pts).data_ptr() == pts.data_ptr()


def test_fold_points_matches_jax():
    pts = points(2)  # one pair of two random points
    kl, kr = rand_scalar(), rand_scalar()
    got = curve.fold_points(enc_port(pts[:1]), enc_port(pts[1:2]), kl, kr)
    want = jcurve.fold_points(enc_jax(pts[:1]), enc_jax(pts[1:2]), kl, kr)
    assert compressed_port(got) == compressed_jax(want)


@functools.lru_cache(maxsize=1)
def msm_cases():
    """The two MSM comparisons' points and scalar rows, from a seed of
    their own (every pytest-xdist worker makes the same): tests/test_msm.py's
    batched shape, 2 rows of 16 points, with its edge digits; and a bullet
    round's single row of N = 34 points (no multiple of K2's 2048-point
    tile or of its 4 chunks), the scalars at the signed recoding's edges
    (0, 1, l - 1, 0x7F / 0x80 / 0xFF bytes, a rippling carry)."""
    r = np.random.default_rng(37)

    def scalar():
        return int.from_bytes(r.bytes(40), "little") % L

    def pts(n):
        B0 = RistrettoPoint.basepoint()
        return [B0.scalar_mul(scalar()) for _ in range(n)] + \
            [RistrettoPoint.identity()]

    rows = [[scalar() for _ in range(16)] for _ in range(2)]
    rows[0][0] = 0
    rows[0][1] = L - 1
    rows[0][2] = rows[0][3] = 0x0101
    edge = msm_edge_scalars()
    vals = edge[:3] + edge[-4:] + edge[3:96:4] + [scalar() for _ in range(3)]
    assert len(vals) == 34
    return [(pts(15), rows), (pts(33), [vals])]


def jax_msms():
    """The JAX package's ops/msm.py on each case, compressed (run in a
    fresh process: see tests/torch_shared.py)."""
    return [[p.compress() for p in jmsm.msm(
        enc_jax(pts), np.stack([jlb.ints_to_limbs(r) for r in rows]))]
        for pts, rows in msm_cases()]


@pytest.fixture(scope="module")
def jax_msm_refs(tmp_path_factory):
    return shared_result(tmp_path_factory, "msm_jax_refs",
                         lambda: in_fresh_process(jax_msms))


def port_msm(case):
    pts, rows = case
    sl = np.stack([jlb.ints_to_limbs(r) for r in rows])
    return [p.compress() for p in msm.msm(
        enc_port(pts), torch.from_numpy(sl.astype(np.int32)))]


def test_msm_batched_matches_jax(jax_msm_refs):
    """tests/test_msm.py's batched shape, with its edge digits."""
    assert port_msm(msm_cases()[0]) == jax_msm_refs[0]


def test_msm_signed_digits_match_jax(jax_msm_refs):
    """msm_plain's signed recoding (the kernel's, csrc/msm.cuh) at a
    bullet round's single row of N = 34 points, the scalars at the
    recoding's edges, against the JAX package's 8-bit unsigned
    windows."""
    assert port_msm(msm_cases()[1]) == jax_msm_refs[1]
