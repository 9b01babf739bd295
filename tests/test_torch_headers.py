"""The CUDA kernels' per-element arithmetic (csrc/fq.cuh, fp.cuh,
curve.cuh) built for the host with g++ (csrc/host_check.cpp) and held
against the port's plain PyTorch versions on random inputs. Only the
launch code of the kernels stays unchecked on a host without a card."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spartan_parallel_tpu_torch.core.consts import L, P
from spartan_parallel_tpu_torch.core.edwards import RistrettoPoint
from spartan_parallel_tpu_torch.ops import curve, fp, fq

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
    lib.host_pt_add.argtypes = [vp, vp, vp, n]
    lib.host_pt_double.argtypes = [vp, vp, n]
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
