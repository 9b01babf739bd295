"""Build, load and count the hand-written CUDA kernels (csrc/*.cu).

Each source compiles with nvcc into its own shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), under
build/kernels/ at the repository root, named by a hash of the source and
the headers it includes (`_includes`), so an edit to a header rebuilds
only the libraries that include it. The wrappers in ops/ pass raw device pointers and PyTorch's
current stream as ctypes.c_void_p; every C entry returns
cudaGetLastError() and `launch` raises when it is not 0.

`launches` counts, per wrapper, the calls that launched a kernel on the
card; a function built on K1's wrappers (eq tables, eq_fold, pc_bind, the
ABC combination, SPARK's hash layer and product-tree folds, the rlc dot
of ShiftProofs) also counts its launches under its own name. CPU tensors
take the plain PyTorch versions and are not counted.

K8-K11 (zk_round.cu) carry the device-resident ZK sumcheck rounds: the
Keccak permutation, ristretto compression, comb commitments and the round
tail. K12 (point_sum) and K13 (scale_points) sit in msm.cu. fp_chain.cu
holds a measurement kernel on no path, not in SOURCES: chip_smoke.py
phase 2 `fp_chain` builds and calls it directly, uncounted.

`build` writes each library under a temporary name and renames it, so
processes that build at once (the ranks of a mesh) never load a partial
file; the dryrun launcher builds once before it starts its ranks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess

import torch

_CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(__file__)))
BUILD_DIR = os.path.join(_ROOT, "build", "kernels")
SOURCES = ("fq", "msm", "spmv", "sumcheck", "product", "uni", "zk_round")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
# C entry -> (library, argtypes)
_ENTRIES = {
    "fq_mul_launch": ("fq", [_P, _P, _P, _I64, _I32, _P]),
    "fq_add_launch": ("fq", [_P, _P, _P, _I64, _I32, _P]),
    "fq_sub_launch": ("fq", [_P, _P, _P, _I64, _I32, _P]),
    "fq_bind_launch": ("fq", [_P, _P, _P, _I64, _I64, _I64, _I64, _I64, _P]),
    "fq_dot_launch": ("fq", [_P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64,
                             _I64, _P]),
    "msm_launch": ("msm", [_P] * 7 + [_I64, _I64, _P]),
    "msm_window_occupancy": ("msm", [_P]),
    "msm_chunking": ("msm", [_I64, _P, _P]),
    "fold_points_launch": ("msm", [_P, _P, _P, _P, _I64, _P]),
    "point_sum_launch": ("msm", [_P, _P, _P, _I64, _I64, _P]),
    "scale_points_launch": ("msm", [_P, _P, _P, _I64, _P]),
    "spmv_launch": ("spmv", [_P, _P, _P, _P, _P, _I64, _I64, _I64, _P]),
    "sparse_eval_launch": ("spmv", [_P, _P, _P, _P, _P, _P, _P, _I64, _P]),
    "p1_round_launch": ("sumcheck", [_P] * 10 + [_I64, _I64, _I64, _I32,
                                                 _I64, _I32, _P, _P, _P, _P]),
    "p2_round_launch": ("sumcheck", [_P] * 6 + [_I64, _I64, _I64, _I64, _I32,
                                                _I64, _I32, _P, _P, _P, _P]),
    "pc_round_launch": ("sumcheck", [_P] * 9 + [_I64, _I64, _I64, _I32, _I32,
                                                _I64, _I64, _I64, _I32, _P,
                                                _P, _P, _P]),
    "pt_layer_mul_launch": ("product", [_P, _P, _P, _P, _I64, _I64, _P]),
    "pt_cubic_launch": ("product", [_P] * 5 + [_I64, _I64, _I64, _P]),
    "fq_powers_launch": ("uni", [_P, _P, _I64, _P]),
    "keccak_launch": ("zk_round", [_P, _P, _I64, _P]),
    "compress_launch": ("zk_round", [_P, _P, _I64, _P]),
    "comb_launch": ("zk_round", [_P, _I32, _P, _P, _I64, _P]),
    "zk_round_tail_launch": ("zk_round", [_P, _I32, _P, _P, _P, _P, _P,
                                          _I32, _P, _P]),
    "fp_chain_launch": ("fp_chain", [_I32, _P, _P, _P, _I32, _P]),
}

launches: dict = {}
_libs: dict = {}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def count(name: str) -> None:
    launches[name] = launches.get(name, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit")


def _includes(src: str) -> list:
    """The csrc headers `src` includes, directly or through another
    header, sorted."""
    seen, todo = set(), [src]
    while todo:
        with open(os.path.join(_CSRC, todo.pop()), encoding="utf-8") as fh:
            for h in re.findall(r'^#include "([^"]+)"', fh.read(), re.M):
                if h not in seen:
                    seen.add(h)
                    todo.append(h)
    return sorted(seen)


def _so_path(name: str) -> str:
    h = hashlib.sha256()
    for f in [name + ".cu"] + _includes(name + ".cu"):
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _cmd(name: str, out: str) -> list:
    # -Xptxas -v: the build log reports each kernel's registers and spills
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
            "-std=c++17", "-O3", "-Xptxas", "-v", "-shared", "-Xcompiler",
            "-fPIC", "-o", out, os.path.join(_CSRC, name + ".cu")]


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one nvcc process
    per source, all started together. Returns {name: (seconds, ptxas log)}
    for the sources it compiled."""
    import time

    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _so_path(name)
        if os.path.exists(out):
            continue
        tmp = out + f".tmp{os.getpid()}"
        procs[name] = (subprocess.Popen(_cmd(name, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT),
                       tmp, out)
    done = {}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n"
                               + log.decode(errors="replace"))
        os.replace(tmp, out)
        done[name] = (time.perf_counter() - t0, log.decode(errors="replace"))
    return done


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        path = _so_path(name)
        if not os.path.exists(path):
            build((name,))
        lib = ctypes.CDLL(path)
        for entry, (src, argtypes) in _ENTRIES.items():
            if src == name:
                fn = getattr(lib, entry)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
        _libs[name] = lib
    return lib


def launch(counter: str, entry: str, *args) -> None:
    """Call a C entry point (pointers and the stream as Python ints),
    count the launch under `counter`, and raise on a CUDA error."""
    fn = getattr(_lib(_ENTRIES[entry][0]), entry)
    count(counter)
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(*ts) -> None:
    """The kernels take contiguous int32 tensors on one CUDA device."""
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError("tensors on different devices")
        if t.dtype != torch.int32:
            raise TypeError(f"expected int32 limbs, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("expected a contiguous tensor")
