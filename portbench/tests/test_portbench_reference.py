"""CPU tests of the plain reference: ristretto255 against RFC 9496's
vectors and against the port's host code as a second witness, and the
reference's judgement of real proofs made on the CPU at a tiny size:
nought for a sound proof, one for each altered part.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import copy
import os
import random
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.reference import ristretto as R  # noqa: E402

SEED = 2**32 + 3

# RFC 9496 A.1: encodings of B * k, k = 0 .. 3
MULTIPLES = [
    "0000000000000000000000000000000000000000000000000000000000000000",
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76",
    "6a493210f7499cd17fecb510ae0cea23a110e8d5b901f8acadd3095c73a3b919",
    "94741f5d5d52755ece4f23f044ee27d5d1ea1e2bd196b462166b16152a9d0259",
]


def test_rfc_multiples_and_group_law():
    acc = R.IDENTITY
    for k, h in enumerate(MULTIPLES):
        assert R.encode(acc).hex() == h
        assert R.encode(R.mul(R.BASEPOINT, k)).hex() == h
        assert R.encode(R.decode(bytes.fromhex(h))) == bytes.fromhex(h)
        acc = R.add(acc, R.BASEPOINT)
    two = R.double(R.BASEPOINT)
    assert R.encode(two) == R.encode(R.add(R.BASEPOINT, R.BASEPOINT))
    assert R.encode(R.add(two, R.mul(two, R.L - 1))) == bytes(32)
    assert R.encode(R.mul(R.BASEPOINT, R.L)) == bytes(32)


def test_invalid_encodings_are_refused():
    for bad in (R.P.to_bytes(32, "little"),           # not canonical
                (1).to_bytes(32, "little"),           # negative s
                b"\xff" * 32, bytes(31)):
        with pytest.raises(ValueError):
            R.decode(bad)


def test_msm_and_eq_table():
    rng = random.Random(3)
    pts = [R.mul(R.BASEPOINT, rng.randrange(1, R.L)) for _ in range(9)]
    ks = [rng.randrange(R.L) for _ in pts] + [0]
    want = R.IDENTITY
    for p, k in zip(pts, ks):
        want = R.add(want, R.mul(p, k))
    assert R.encode(R.msm(pts + [pts[0]], ks)) == R.encode(want)
    r = [rng.randrange(R.L) for _ in range(3)]
    tab = R.eq_table(r)
    for i in range(8):
        bits = [(i >> (2 - j)) & 1 for j in range(3)]
        want = 1
        for rj, b in zip(r, bits):
            want = want * (rj if b else 1 - rj) % R.L
        assert tab[i] == want
    assert R.eq_table([0, 1, 1]) == [0, 0, 0, 1, 0, 0, 0, 0]


def test_one_way_map_and_generators_match_the_port():
    """The port's host code as a second witness (it is never imported by
    the reference)."""
    from spartan_parallel_tpu_torch.core.edwards import RistrettoPoint
    from spartan_parallel_tpu_torch.models.commitments import \
        MultiCommitGens

    rng = random.Random(5)
    for _ in range(8):
        b = bytes(rng.randrange(256) for _ in range(64))
        assert R.encode(R.from_uniform_bytes(b)) == \
            RistrettoPoint.from_uniform_bytes(b).compress()
    g = MultiCommitGens(6, b"portbench")
    mine = R.generators(b"portbench", 6)
    assert [R.encode(p) for p in mine[:6]] == [p.compress() for p in g.G]
    assert R.encode(mine[6]) == g.h.compress()


def _tiny(spec, cell, **over):
    _, cfg, _ = harness.cell_files(spec, cell, ROOT)
    return dict(cfg, **over)


@pytest.fixture(scope="module")
def snark_proofs():
    import torch

    from portbench.systems import spartan_snark

    spec = harness.load_spec(ROOT)
    cfg = _tiny(spec, "snark_2p20.prove_verify", num_cons=64, num_vars=64,
                num_inputs=3)
    sysm = spartan_snark.System(cfg, SEED, torch.device("cpu"))
    req = {"index": 0, "input": 0, "tape_seed": b"\x07" * 32}
    rec = sysm.verify(req, sysm.prove(req))
    return sysm, sysm.plain(rec)


def test_snark_reference_accepts_a_sound_proof(snark_proofs):
    sysm, pf = snark_proofs
    assert sysm.check([pf], SEED) == {"commit": 0, "claims": 0,
                                      "sections": 0, "evals": 0}
    # judged against the statement of another seed, it is not correct
    other = sysm.check([pf], SEED + 1)
    assert other["commit"] == 1 and other["evals"] >= 1


@pytest.mark.parametrize("part", ["commit", "claims", "sections", "evals",
                                  "blind", "point"])
def test_snark_reference_finds_each_altered_part(snark_proofs, part):
    sysm, pf = snark_proofs
    bad = copy.deepcopy(pf)
    other = R.encode(R.mul(R.BASEPOINT, 12345))
    if part == "commit":
        bad["comm_vars"][3] = other
    elif part == "claims":
        bad["claims"][1] = other
    elif part == "sections":
        bad["sections"][0] = other
    elif part == "evals":
        bad["evals"][2] = (bad["evals"][2] + 1) % R.L
    elif part == "blind":
        bad["blinds"]["Cz_blind"] += 1
    else:
        bad["rx"][0] = (bad["rx"][0] + 1) % R.L
    got = sysm.check([bad], SEED)
    key = {"blind": "claims", "point": "claims"}.get(part, part)
    assert got[key] >= 1
    if part == "point":
        assert got["evals"] >= 1
