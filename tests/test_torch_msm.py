"""K2 (MSM and the bullet generator fold) and the point arithmetic under
it: the port's plain path against the JAX package's ops/curve.py and
ops/msm.py on the same inputs. Points are compared after ristretto
compression; the tolerance is exact equality."""

import jax.numpy as jnp
import numpy as np
import torch

from spartan_parallel_tpu.core.consts import L
from spartan_parallel_tpu.core.edwards import RistrettoPoint
from spartan_parallel_tpu.ops import curve as jcurve
from spartan_parallel_tpu.ops import limbs as jlb
from spartan_parallel_tpu.ops import msm as jmsm
from spartan_parallel_tpu_torch.ops import curve, msm

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


def test_fold_points_matches_jax():
    pts = points(2)  # one pair of two random points
    kl, kr = rand_scalar(), rand_scalar()
    got = curve.fold_points(enc_port(pts[:1]), enc_port(pts[1:2]), kl, kr)
    want = jcurve.fold_points(enc_jax(pts[:1]), enc_jax(pts[1:2]), kl, kr)
    assert compressed_port(got) == compressed_jax(want)


def test_msm_batched_matches_jax():
    """tests/test_msm.py's batched shape, with its edge digits."""
    n, b = 16, 2
    pts = points(n - 1)
    rows = [[rand_scalar() for _ in range(n)] for _ in range(b)]
    rows[0][0] = 0
    rows[0][1] = L - 1
    rows[0][2] = rows[0][3] = 0x0101
    sl = np.stack([jlb.ints_to_limbs(r) for r in rows])
    want = jmsm.msm(enc_jax(pts), sl)
    got = msm.msm(enc_port(pts), torch.from_numpy(sl.astype(np.int32)))
    assert [p.compress() for p in got] == [p.compress() for p in want]
