"""ctypes loader for the native ristretto255 host kernels.

Compiles this package's own native/ristretto.c, keccak.c and tdefl.c with
the system C compiler on first use into build/native/ at the repository
root (cached by source hash), then exposes the point
ops. Falls back to None if no compiler is available or
SPARTAN_NO_NATIVE is set — core/edwards.py keeps a pure-Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from .consts import (
    D_MINUS_ONE_SQ,
    EDWARDS_D,
    EDWARDS_D2,
    INVSQRT_A_MINUS_D,
    ONE_MINUS_D_SQ,
    SQRT_AD_MINUS_ONE,
    SQRT_M1,
)

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "native")
_SRCS = [os.path.join(_NATIVE_DIR, f)
         for f in ("ristretto.c", "keccak.c", "tdefl.c")]

_lib = None
_tried = False


def _build() -> str | None:
    h = hashlib.sha256()
    for path in _SRCS:
        with open(path, "rb") as f:
            h.update(f.read())
    tag = h.hexdigest()[:16]
    cache_dir = os.environ.get(
        "SPARTAN_NATIVE_CACHE",
        os.path.join(os.path.dirname(os.path.dirname(_NATIVE_DIR)),
                     "build", "native"))
    os.makedirs(cache_dir, exist_ok=True)
    so_path = os.path.join(cache_dir, f"ristretto_{tag}.so")
    if os.path.exists(so_path):
        return so_path
    cc = os.environ.get("CC", "cc")
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = [cc, "-O3", "-march=native", "-shared", "-fPIC", "-o", tmp, *_SRCS]
    try:
        subprocess.run(cmd, check=True, capture_output=True)
    except Exception:
        try:
            cmd = [cc, "-O2", "-shared", "-fPIC", "-o", tmp, *_SRCS]
            subprocess.run(cmd, check=True, capture_output=True)
        except Exception:
            return None
    os.replace(tmp, so_path)
    return so_path


def get() -> "ctypes.CDLL | None":
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("SPARTAN_NO_NATIVE"):
        return None
    so = _build()
    if so is None:
        return None
    lib = ctypes.CDLL(so)
    u8p = ctypes.c_char_p
    lib.rst_init.argtypes = [u8p]
    lib.pt_add.argtypes = [u8p, u8p, u8p]
    lib.pt_double.argtypes = [u8p, u8p]
    lib.pt_scalar_mul.argtypes = [u8p, u8p, u8p]
    lib.pt_msm.argtypes = [u8p, u8p, ctypes.c_size_t, u8p]
    lib.pt_compress.argtypes = [u8p, u8p]
    lib.pt_decompress.argtypes = [u8p, u8p]
    lib.pt_decompress.restype = ctypes.c_int
    lib.pt_from_uniform.argtypes = [u8p, u8p]
    lib.keccak_f1600.argtypes = [u8p]
    lib.spartan_tdefl_zlib.argtypes = [u8p, ctypes.c_long, u8p,
                                       ctypes.c_long, ctypes.c_int]
    lib.spartan_tdefl_zlib.restype = ctypes.c_long

    consts = b"".join(
        v.to_bytes(32, "little")
        for v in (EDWARDS_D, EDWARDS_D2, SQRT_M1, ONE_MINUS_D_SQ,
                  D_MINUS_ONE_SQ, SQRT_AD_MINUS_ONE, INVSQRT_A_MINUS_D))
    lib.rst_init(consts)
    _lib = lib
    return _lib
