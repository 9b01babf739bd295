"""The port's .ctk/.rtk driver and the memory half of the 9-stage SNARK.

The committed fixtures tests/fixtures/counter_bin.{ctk,rtk} (the counter
program) and counter_mem_bin.{ctk,rtk} (the counter with physical and
virtual memory, tests/test_snark_mem.py): the port's bincode reader and
writer must reproduce them byte for byte and read the JAX reader's
values; the counter runs prove -> verify from the files on the CPU. On
the memory fixture's lists, mem_gen, ShiftProofs.prove and IOProofs.prove
must equal the JAX functions under one tape (commitments, proof bytes,
transcript state), and SPARTAN_LAX_SHIFT=1 must switch off the shift
relation check in both packages alike.

The memory fixture has 3 unpadded inputs, fewer than the perm-root
circuit needs for a virtual-memory record: its witness does not satisfy
that circuit, in the JAX package as in the port, so its proof is
rejected. The same program with its inputs widened to 5 (two inputs that
are always 0; chip_smoke.widen_inputs, which phase 3 proves on the card)
proves and verifies, and its tampered proofs are rejected.
Tolerance: exact equality."""

import copy
import os

import pytest

from chip_smoke import widen_inputs
from spartan_parallel_tpu import driver as jdrv
from spartan_parallel_tpu import serialization as jser
from spartan_parallel_tpu.core.field import Scalar as JScalar
from spartan_parallel_tpu.models import dense_mlpoly as jdm
from spartan_parallel_tpu.models import snark as jsn
from spartan_parallel_tpu.models.r1csproof import R1CSGens as JGens
from spartan_parallel_tpu.utils.random_tape import RandomTape as JTape
from spartan_parallel_tpu.utils.transcript import Transcript as JTranscript
from spartan_parallel_tpu_torch import driver as tdrv
from spartan_parallel_tpu_torch import serialization as tser
from spartan_parallel_tpu_torch.core.edwards import RistrettoPoint
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models import dense_mlpoly as tdm
from spartan_parallel_tpu_torch.models import r1csproof as rp
from spartan_parallel_tpu_torch.models import snark as tsn
from spartan_parallel_tpu_torch.models.r1csproof import R1CSGens
from spartan_parallel_tpu_torch.ops import fq
from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
from spartan_parallel_tpu_torch.utils.transcript import Transcript

FIXTURE_DIR = os.path.join(os.path.dirname(__file__), "fixtures")
TAPE = b"\x0d" * 32


def fixture(name):
    with open(os.path.join(FIXTURE_DIR, name), "rb") as f:
        return f.read()


def load(name, drv=tdrv):
    return (drv.CompileTimeKnowledge.deserialize(fixture(name + ".ctk")),
            drv.RunTimeKnowledge.deserialize(fixture(name + ".rtk")))


@pytest.mark.parametrize("name", ["counter_bin", "counter_mem_bin"])
def test_codec_reproduces_fixtures(name):
    ctk, rtk = load(name)
    assert ctk.serialize() == fixture(name + ".ctk")
    assert rtk.serialize() == fixture(name + ".rtk")
    jctk, jrtk = load(name, jdrv)
    for f in tdrv.CompileTimeKnowledge.FIELDS:
        assert getattr(ctk, f) == getattr(jctk, f), f
    for f in tdrv.RunTimeKnowledge.FIELDS:
        assert getattr(rtk, f) == getattr(jrtk, f), f


def test_driver_run_from_files(capsys):
    ctk = tdrv.CompileTimeKnowledge.from_file(
        os.path.join(FIXTURE_DIR, "counter_bin.ctk"))
    rtk = tdrv.RunTimeKnowledge.from_file(
        os.path.join(FIXTURE_DIR, "counter_bin.rtk"))
    tdrv.run(ctk, rtk, vars_bound=64, device="cpu")
    assert "proof verification successful!" in capsys.readouterr().out


def test_driver_default_vars_bound_gens():
    """R1CSGens accepts the non-power-of-two TOTAL_NUM_VARS_BOUND."""
    gens = R1CSGens(b"gens_r1cs_sat", 1024, tdrv.TOTAL_NUM_VARS_BOUND)
    assert gens.gens_pc.gens.gens_n.n == \
        JGens(b"gens_r1cs_sat", 1024, 10_000_000).gens_pc.gens.gens_n.n


def test_driver_main_runs_on_the_card(tmp_path, monkeypatch):
    """main() reads ../zok_tests/{constraints,inputs}/<name>_bin.* and runs
    on the card: on a host without one it raises before proving."""
    for sub, ext in (("constraints", "ctk"), ("inputs", "rtk")):
        d = tmp_path / "zok_tests" / sub
        d.mkdir(parents=True)
        (d / f"counter_bin.{ext}").write_bytes(fixture(f"counter_bin.{ext}"))
    (tmp_path / "run").mkdir()
    monkeypatch.chdir(tmp_path / "run")
    monkeypatch.setattr("sys.argv", ["driver", "counter"])
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdrv.main()


# --------------------------------------------------------------------------
# The memory SNARK
# --------------------------------------------------------------------------
def prove_mem(ctk, rtk):
    s = tdrv._setup(ctk, rtk, vars_bound=64, device="cpu")
    proof = tdrv._prove(ctk, rtk, s, RandomTape(b"proof", seed=TAPE), "cpu")
    return proof, s


@pytest.fixture(scope="module")
def widened():
    ctk, rtk = widen_inputs(*load("counter_mem_bin"), 5)
    proof, s = prove_mem(ctk, rtk)
    return ctk, rtk, s, tser.serialize(proof, "SNARK")


def unsatisfied(num_instances, max_num_proofs, num_proofs,
                max_num_inputs, num_inputs, secs, inst):
    """{(instance, execution): [constraint rows]} where the witness of an
    R1CSProof.prove call violates A z * B z = C z."""
    z = rp.assemble_z(num_instances, num_proofs, max_num_proofs,
                      num_inputs, max_num_inputs, secs, "cpu")
    out = {}
    for p in range(num_instances):
        zp = z[p, :num_proofs[p]].reshape(num_proofs[p], -1, 16)
        A, B, C = (m[0 if inst.num_instances == 1 else p]
                   .multiply_vec_batched(zp)
                   for m in (inst.A_list, inst.B_list, inst.C_list))
        bad = (fq.sub(fq.mul(A, B), C) != 0).any(-1)
        for q in range(num_proofs[p]):
            rows = bad[q].nonzero().flatten().tolist()
            if rows:
                out[(p, q)] = rows
    return out


def test_mem_fixture_proof_rejected_at_perm_root(monkeypatch):
    """The fixture's perm-root witness (executions, memories and their
    w2/w3 tables, merged by size) leaves constraints 3 and 4 unsatisfied
    on the virtual-memory records (merged instance 1) whose ls or ts is
    not 0: their w2 holds r^2 ls and r^3 ts where the perm-root circuit
    reads two outputs' dot products (3 unpadded inputs), and its ZO entry
    is 0. The JAX package builds the same tables (models/snark.py:771-
    792), so the verifier rejects the proof at the perm root."""
    calls = []
    real = rp.R1CSProof.prove

    def spy(*args):
        calls.append(unsatisfied(*args[:7]))
        return real(*args)

    monkeypatch.setattr(rp.R1CSProof, "prove", staticmethod(spy))
    ctk, rtk = load("counter_mem_bin")
    proof, s = prove_mem(ctk, rtk)
    assert calls == [{}, {}, {(1, q): [3, 4] for q in range(1, 5)}]
    with pytest.raises(ProofVerifyError, match="equality proof"):
        tdrv._verify(proof, ctk, rtk, s, "cpu")


def test_mem_snark_proves_and_verifies(widened):
    ctk, rtk, s, raw = widened
    proof = tser.deserialize(raw, "SNARK")
    tdrv._verify(proof, ctk, rtk, s, "cpu")
    assert tser.serialize(proof, "SNARK") == raw


@pytest.mark.parametrize("tamper", ["witness_commitment", "perm_product",
                                    "memory_trace"])
def test_mem_snark_rejects_tampering(widened, tamper):
    ctk, rtk, s, raw = widened
    proof = tser.deserialize(raw, "SNARK")
    if tamper == "witness_commitment":
        proof.block_comm_vars_list[0].C[0] = \
            RistrettoPoint.basepoint().compress()
    elif tamper == "perm_product":
        proof.perm_poly_poly_list[0] = proof.perm_poly_poly_list[0] + \
            proof.perm_poly_poly_list[0]
    else:
        # a block claims a physical load (0, 99) that the address-sorted
        # trace never holds: the phy grand products differ
        rtk = copy.deepcopy(rtk)
        rtk.block_vars_matrix[0][0][11] = 99
        proof, s = prove_mem(ctk, rtk)
    with pytest.raises(ProofVerifyError):
        tdrv._verify(proof, ctk, rtk, s, "cpu")


# --------------------------------------------------------------------------
# mem_gen, ShiftProofs and IOProofs against the JAX functions
# --------------------------------------------------------------------------
def _padded(rows, width):
    n = len(rows)
    return [list(r) for r in rows] + [[0] * width] * (jdm.next_pow2(n) - n)


@pytest.fixture(scope="module")
def mem_parts():
    """Both packages' mem_gen of the fixture's physical accesses, then a
    ShiftProofs of its w3 table and an IOProofs of the execution rows, in
    one transcript per package under one tape."""
    _, rtk = load("counter_mem_bin")
    phy = _padded(rtk.addr_phy_mems_list, tsn.PHY_MEM_WIDTH)
    exec_rows = _padded(rtk.exec_inputs, 8)
    tau, r = 5 ** 40, 7 ** 50
    out = {}
    for pkg, sn, Tr, Tape, S, gens, dev in (
            ("jax", jsn, JTranscript, JTape, JScalar,
             JGens(b"gens_r1cs_sat", 16, 64), ()),
            ("port", tsn, Transcript, RandomTape, Scalar,
             R1CSGens(b"gens_r1cs_sat", 16, 64), ("cpu",))):
        tp, tape = Tr(b"mem_parts"), Tape(b"proof", seed=TAPE)
        w2, c2, w3, c3, w3s, c3s = sn.mem_gen(
            sn.PHY_MEM_WIDTH, len(phy), phy, S(r), S(tau), gens, tp, *dev)
        shift = sn.ShiftProofs.prove(w3.poly_w, w3s.poly_w, [6], gens, tp,
                                     tape)
        DP = jdm.DensePolynomial if pkg == "jax" else tdm.DensePolynomial
        poly = DP.from_scalars([v for row in exec_rows for v in row], *dev)
        io = sn.IOProofs.prove(poly, 8, 3, len(exec_rows), S(0), S(2),
                               [False, False, True], 1, 2,
                               [S(0), S(0), S(3)], S(9), 3, gens, tp, tape)
        ser = jser if pkg == "jax" else tser
        out[pkg] = dict(
            mats=[m.w_mat[0] for m in (w2, w3, w3s)],
            comms=[ser.serialize(c, "PolyCommitment") for c in (c2, c3, c3s)],
            shift=ser.serialize(shift, "ShiftProofs"),
            io=ser.serialize(io, "IOProofs"),
            probe=int(tp.challenge_scalar(b"probe")), gens=gens, S=S,
            raw=(c3, c3s, shift, io, poly, len(phy)))
    return out


def test_mem_gen_shift_and_io_proofs_match_jax(mem_parts):
    j, t = mem_parts["jax"], mem_parts["port"]
    for jm, tm in zip(j["mats"], t["mats"]):
        assert jm.shape == tuple(tm.shape)
        assert [int(x) for x in jdm.mont_to_scalars(jm)] == \
            [int(x) for x in tdm.mont_to_scalars(tm)]
    assert t["comms"] == j["comms"]
    assert t["shift"] == j["shift"]
    assert t["io"] == j["io"]
    assert t["probe"] == j["probe"]


@pytest.mark.parametrize("lax", [False, True])
def test_lax_shift_behaves_as_jax(mem_parts, monkeypatch, lax):
    """A ShiftProofs checked against a wrong shift size: rejected by the
    shift relation in both packages, or accepted by both with
    SPARTAN_LAX_SHIFT=1 (the relation is the only check it reaches)."""
    if lax:
        monkeypatch.setenv("SPARTAN_LAX_SHIFT", "1")
    else:
        monkeypatch.delenv("SPARTAN_LAX_SHIFT", raising=False)
    outcome = {}
    for pkg, sn, Tr, ser in (("jax", jsn, JTranscript, jser),
                             ("port", tsn, Transcript, tser)):
        part = mem_parts[pkg]
        c3, c3s, shift, _, _, n = part["raw"]
        # the verifier's transcript: mem_gen's three commitments first
        tp = Tr(b"mem_parts")
        for raw in part["comms"]:
            ser.deserialize(raw, "PolyCommitment").append_to_transcript(
                b"poly_commitment", tp)
        try:
            shift.verify([c3], [c3s], [8 * n], [4], [6], part["gens"], tp)
            outcome[pkg] = "accepted"
        except jsn.ProofVerifyError if pkg == "jax" else ProofVerifyError:
            outcome[pkg] = "rejected"
    assert outcome == {"jax": "accepted" if lax else "rejected",
                       "port": "accepted" if lax else "rejected"}


def test_shift_and_io_proofs_verify(mem_parts):
    """The port's ShiftProofs and IOProofs verify with the right sizes."""
    part = mem_parts["port"]
    c3, c3s, shift, io, poly, n = part["raw"]
    tp = Transcript(b"mem_parts")
    for raw in part["comms"]:
        tser.deserialize(raw, "PolyCommitment").append_to_transcript(
            b"poly_commitment", tp)
    shift.verify([c3], [c3s], [8 * n], [8], [6], part["gens"], tp)
    comm, _ = poly.commit(part["gens"].gens_pc, None)
    S = Scalar
    io.verify(comm, 8, 3, len(poly) // 8, S(0), S(2), [False, False, True],
              1, 2, [S(0), S(0), S(3)], S(9), 3, part["gens"], tp, "cpu")
