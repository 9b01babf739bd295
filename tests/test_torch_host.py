"""The port's host layer (its own copies of the framework-free modules):
merlin, RFC 9496 and tdefl vectors, the import boundary and the device
rule."""

import hashlib
import os
import random
import subprocess
import sys
import zlib

import pytest

from spartan_parallel_tpu.core.edwards import RistrettoPoint as JaxPoint
from spartan_parallel_tpu.models.commitments import MultiCommitGens as JaxGens
from spartan_parallel_tpu_torch.core import device as tdevice
from spartan_parallel_tpu_torch.core import native
from spartan_parallel_tpu_torch.core.consts import L
from spartan_parallel_tpu_torch.core.edwards import RistrettoPoint
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models.commitments import MultiCommitGens
from spartan_parallel_tpu_torch.models.r1csinstance import _deflate_digest
from spartan_parallel_tpu_torch.utils.keccak import sha3_256
from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
from spartan_parallel_tpu_torch.utils.transcript import Transcript

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_merlin_vector():
    # merlin crate, transcript.rs test `equivalence_simple`
    t = Transcript(b"test protocol")
    t.append_message(b"some label", b"some data")
    assert t.challenge_bytes(b"challenge", 32).hex() == \
        "d5a21972d0d5fe320c0d263fac7fffb8145aa640af6e9bca177c03c7efcf0615"


def test_keccak_matches_hashlib():
    for msg in (b"", b"abc", bytes(1000), bytes(range(256)) * 3):
        assert sha3_256(msg) == hashlib.sha3_256(msg).digest()


def test_ristretto_rfc9496_small_multiples():
    expected = [
        "0000000000000000000000000000000000000000000000000000000000000000",
        "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
        "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
        "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
        "da80862773358b466ffadfe0b3293ab3d9fd53c5ea6c955358f568322daf6a57",
    ]
    p = RistrettoPoint.identity()
    for i, exp in enumerate(expected):
        assert p.compress().hex() == exp, f"multiple {i}"
        p = p + RistrettoPoint.basepoint()
    with pytest.raises(ValueError):
        RistrettoPoint.decompress(b"\x01" + b"\x00" * 31)


def test_native_library_is_the_ports_own():
    lib = native.get()
    assert lib is not None
    assert all(os.path.dirname(s).endswith(
        os.path.join("spartan_parallel_tpu_torch", "native"))
        for s in native._SRCS)


def test_tdefl_golden_vectors():
    """The port's native/tdefl.c gives the pinned digest streams."""
    rng = random.Random(42)
    vecs = (b"the quick brown fox jumps over the lazy dog " * 100,
            bytes(rng.randbytes(100000)),
            bytes(rng.choices(range(16), k=123456)))
    got = [hashlib.sha256(_deflate_digest(v)).hexdigest()[:16] for v in vecs]
    with open(os.path.join(ROOT, "tests", "fixtures",
                           "tdefl_golden.txt")) as f:
        assert got == f.read().split()
    for v in vecs:
        assert zlib.decompress(_deflate_digest(v)) == v


def test_generators_and_tape_match_jax():
    """Generators are derived from labels in both packages; the random
    tape is the same merlin transcript."""
    ours = MultiCommitGens(8, b"gens_r1cs_sat")
    theirs = JaxGens(8, b"gens_r1cs_sat")
    assert [g.compress() for g in ours.G + [ours.h]] == \
        [g.compress() for g in theirs.G + [theirs.h]]
    from spartan_parallel_tpu.utils.random_tape import RandomTape as JaxTape

    a = RandomTape(b"proof", seed=b"\x05" * 32).random_vector(b"v", 3)
    b = JaxTape(b"proof", seed=b"\x05" * 32).random_vector(b"v", 3)
    assert [int(x) for x in a] == [int(x) for x in b]
    s = Scalar(L - 1)
    assert JaxPoint.basepoint().scalar_mul(int(s)).compress() == \
        RistrettoPoint.basepoint().scalar_mul(int(s)).compress()


def test_port_imports_no_jax():
    """Importing every module of the port, chip_smoke.py and k2_turns.py
    in a fresh interpreter loads neither jax nor the JAX package."""
    code = (
        "import pkgutil, sys, importlib\n"
        "import spartan_parallel_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, k2_turns\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'spartan_parallel_tpu'"
        " or m.startswith('spartan_parallel_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_device_rule():
    """The card by default; the CPU only when named; no card -> raise."""
    import torch

    assert tdevice.resolve("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert tdevice.resolve().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            tdevice.resolve()
        from spartan_parallel_tpu_torch import NIZKGens, ProverWitnessSecInfo

        with pytest.raises(RuntimeError):
            NIZKGens(16, 16)
        with pytest.raises(RuntimeError):
            ProverWitnessSecInfo.from_scalars([1], [[[1]]])
