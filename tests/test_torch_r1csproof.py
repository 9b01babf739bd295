"""The data-parallel R1CSProof: P = 3 instances executed [8, 2, 1] times,
16 constraints x 16 variables x 4 inputs (the shape of tests/test_r1cs.py's
q-class test). The statement is built by the JAX package and carried into
the port with convert.py; the port's q-size-classed proof on the CPU must
serialize to the JAX package's bytes under the same tape, return the same
challenge vectors and leave the transcript in the same state, each
package's verifier must accept the other's proof, the port's dense layout
must give the classed layout's bytes, and tampered proofs must be
rejected; with device-resident rounds (torch_shared.device_rounds, the
plain round tail on the CPU) the same bytes, challenges and transcript
state.
Tolerance: exact equality."""

import numpy as np
import pytest

from spartan_parallel_tpu import serialization as jser
from spartan_parallel_tpu.core.field import Scalar as JScalar
from spartan_parallel_tpu.models import r1csinstance as jri
from spartan_parallel_tpu.models import r1csproof as jrp
from spartan_parallel_tpu.utils.random_tape import RandomTape as JTape
from spartan_parallel_tpu.utils.transcript import Transcript as JTranscript
from spartan_parallel_tpu_torch import convert
from spartan_parallel_tpu_torch import serialization as tser
from spartan_parallel_tpu_torch.models import r1csinstance as tri
from spartan_parallel_tpu_torch.models import r1csproof as trp
from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
from spartan_parallel_tpu_torch.utils.transcript import Transcript

from .torch_shared import device_rounds, in_fresh_process, shared_result

NP = [8, 2, 1]
P, NV, QMAX = 3, 16, 8
TAPE = b"\x0b" * 32
LABEL = b"qclass_test"
GENS = b"test_qclass"


def io_rows(inputs_mat, num_proofs):
    return [[[1] + [int(v) for v in io] + [0] * (NV - 1 - len(io))
             for io in inputs_mat[p]] for p in range(len(num_proofs))]


def ints(r):
    return [[int(x) for x in v] for v in r]


@pytest.fixture(scope="module")
def jax_statement():
    return make_jax_statement()


def make_jax_statement():
    inst, vm, im = jri.produce_synthetic_r1cs(P, NP, 16, NV, 4, seed=13)
    secs = [jrp.ProverWitnessSecInfo.from_scalars([NV] * P, m)
            for m in (vm, io_rows(im, NP))]
    gens = jrp.R1CSGens(GENS, 16, QMAX * NV)
    comms = [[s.poly_w[p].commit(gens.gens_pc, None)[0] for p in range(P)]
             for s in secs]
    return inst, secs, gens, comms


@pytest.fixture(scope="module")
def jax_proof(tmp_path_factory, jax_statement):
    """The JAX package's classed proof: (bytes, r, post-prove probe)."""
    def prove():
        inst, secs, gens, _ = jax_statement
        tp = JTranscript(LABEL)
        proof, r = jrp.R1CSProof.prove(P, QMAX, NP, NV, [NV] * P, secs,
                                       inst, gens, tp, JTape(b"proof",
                                                             seed=TAPE))
        return (jser.serialize(proof, "R1CSProof"), ints(r),
                int(tp.challenge_scalar(b"probe")))

    return shared_result(tmp_path_factory, "jax_dp_classed_proof", prove)


@pytest.fixture(scope="module")
def port_statement(jax_statement):
    """The JAX statement carried into the port: instance, witness
    sections, gens and the verifier's commitments."""
    jinst, jsecs, _, jcomms = jax_statement

    def mats(lst):
        return [(m.rows, m.cols, m.vals) for m in lst]

    inst = convert.instances_from_numpy(
        P, 16, jinst.get_inst_num_cons(), jinst.get_num_vars(),
        mats(jinst.A_list), mats(jinst.B_list), mats(jinst.C_list),
        device="cpu")
    secs = [convert.witness_sec_from_numpy(
        s.num_inputs, [np.asarray(m) for m in s.w_mat], "cpu")
        for s in jsecs]
    views = [convert.verifier_sec_from_points(NP, [NV] * P,
                                              [c.C for c in comms])
             for comms in jcomms]
    return inst, secs, trp.R1CSGens(GENS, 16, QMAX * NV), views


def port_prove(statement, num_proofs=NP):
    inst, secs, gens, _ = statement
    tp = Transcript(LABEL)
    proof, r = trp.R1CSProof.prove(
        len(num_proofs), max(num_proofs), num_proofs, NV,
        [NV] * len(num_proofs), secs, inst, gens, tp,
        RandomTape(b"proof", seed=TAPE), "cpu")
    return (tser.serialize(proof, "R1CSProof"), ints(r),
            int(tp.challenge_scalar(b"probe")), r)


def port_verify(statement, proof, r, num_proofs=NP):
    inst, _, gens, views = statement
    _, bound = inst.multi_evaluate_bound_rp(r[0], r[2], r[3], device="cpu")
    return proof.verify(len(num_proofs), max(num_proofs), num_proofs, NV,
                        views, 16, gens, bound, Transcript(LABEL), "cpu")


@pytest.fixture(scope="module")
def port_proof(port_statement):
    return port_prove(port_statement)


@pytest.fixture(scope="module")
def port_proof_dev(port_statement):
    """The classed proof with device-resident rounds on the CPU (the plain
    round tail of ops/zk_round.py)."""
    with device_rounds():
        return port_prove(port_statement)


def test_convert_carries_the_statement(jax_statement, port_statement):
    assert port_statement[0].get_digest() == jax_statement[0].get_digest()
    assert [[c.C for c in v.comm_w] for v in port_statement[3]] == \
        [[c.C for c in s] for s in jax_statement[3]]


def test_classed_proof_matches_jax(jax_proof, port_proof):
    assert port_proof[1] == jax_proof[1], "challenge vectors differ"
    assert port_proof[2] == jax_proof[2], "transcript states differ"
    assert port_proof[0] == jax_proof[0], "proof bytes differ"


def test_device_rounds_match_jax(jax_proof, port_statement, port_proof_dev):
    """Device-resident rounds give the JAX host loop's bytes, challenges
    and transcript state; both packages verify the proof."""
    assert port_proof_dev[1] == jax_proof[1], "challenge vectors differ"
    assert port_proof_dev[2] == jax_proof[2], "transcript states differ"
    assert port_proof_dev[0] == jax_proof[0], "proof bytes differ"
    proof = tser.deserialize(port_proof_dev[0], "R1CSProof")
    assert ints(port_verify(port_statement, proof, port_proof_dev[3])) == \
        jax_proof[1]
    assert in_fresh_process(jax_verify, port_proof_dev[0],
                            port_proof_dev[1]) == jax_proof[1]


def jax_verify(raw: bytes, r_ints):
    """The JAX package's verifier on a serialized classed proof of the
    fixture's statement, at the point r_ints (run in a fresh process: see
    tests/torch_shared.py); returns its challenge vectors."""
    inst, _, gens, comms = make_jax_statement()
    rp, _, rx, ry = ([JScalar(x) for x in v] for v in r_ints)
    _, bound = inst.multi_evaluate_bound_rp(rp, rx, ry)
    views = [jrp.VerifierWitnessSecInfo(NP, [NV] * P, c) for c in comms]
    out = jser.deserialize(raw, "R1CSProof").verify(
        P, QMAX, NP, NV, views, 16, gens, bound, JTranscript(LABEL))
    return ints(out)


def test_port_verifies_jax_proof(jax_proof, port_statement, port_proof):
    proof = tser.deserialize(jax_proof[0], "R1CSProof")
    assert ints(port_verify(port_statement, proof, port_proof[3])) == \
        jax_proof[1]


def test_jax_verifies_port_proof(jax_statement, port_proof):
    inst, _, gens, comms = jax_statement
    rp, _, rx, ry = port_proof[3]
    _, bound = inst.multi_evaluate_bound_rp(rp, rx, ry)
    views = [jrp.VerifierWitnessSecInfo(NP, [NV] * P, c) for c in comms]
    proof = jser.deserialize(port_proof[0], "R1CSProof")
    out = proof.verify(P, QMAX, NP, NV, views, 16, gens, bound,
                       JTranscript(LABEL))
    assert ints(out) == port_proof[1]


def test_dense_layout_gives_the_classed_bytes(monkeypatch, port_statement,
                                              port_proof):
    monkeypatch.setattr(trp, "q_classes", lambda num_proofs: None)
    assert port_prove(port_statement)[:3] == port_proof[:3]


def test_uniform_counts_prove_and_verify():
    """Four instances executed twice each take the dense layout."""
    num_proofs = [2, 2, 2, 2]
    inst, vm, im = tri.produce_synthetic_r1cs(4, num_proofs, 16, NV, 4,
                                              seed=3, device="cpu")
    secs = [trp.ProverWitnessSecInfo.from_scalars([NV] * 4, m, "cpu")
            for m in (vm, io_rows(im, num_proofs))]
    gens = trp.R1CSGens(GENS, 16, 2 * NV)
    views = [trp.VerifierWitnessSecInfo(
        num_proofs, [NV] * 4,
        [s.poly_w[p].commit(gens.gens_pc, None)[0] for p in range(4)])
        for s in secs]
    statement = (inst, secs, gens, views)
    raw, r_ints, _, r = port_prove(statement, num_proofs)
    proof = tser.deserialize(raw, "R1CSProof")
    assert ints(port_verify(statement, proof, r, num_proofs)) == r_ints


def test_three_witness_sections_prove_and_verify():
    """num_segs that is not a power of two: the synthetic instance's
    columns [vars | 1, io, 0...] as four sections of NV / 2, the last of
    which (zeros) is left out, so W = 4 holds three sections."""
    num_proofs, h = [2, 1], NV // 2
    inst, vm, im = tri.produce_synthetic_r1cs(2, num_proofs, 16, NV, 4,
                                              seed=5, device="cpu")
    io = io_rows(im, num_proofs)
    parts = ([[row[:h] for row in m] for m in vm],
             [[row[h:] for row in m] for m in vm],
             [[row[:h] for row in m] for m in io])
    secs = [trp.ProverWitnessSecInfo.from_scalars([h] * 2, m, "cpu")
            for m in parts]
    gens = trp.R1CSGens(GENS, 16, 2 * h)
    views = [trp.VerifierWitnessSecInfo(
        num_proofs, [h] * 2,
        [s.poly_w[p].commit(gens.gens_pc, None)[0] for p in range(2)])
        for s in secs]
    tp = Transcript(LABEL)
    proof, r = trp.R1CSProof.prove(2, 2, num_proofs, h, [h] * 2, secs, inst,
                                   gens, tp, RandomTape(b"proof", seed=TAPE),
                                   "cpu")
    _, bound = inst.multi_evaluate_bound_rp(r[0], r[2], r[3], device="cpu")
    assert proof.verify(2, 2, num_proofs, h, views, 16, gens, bound,
                        Transcript(LABEL), "cpu") == r


@pytest.mark.parametrize("tamper", ["swap_sc1_evals", "swap_sc2_polys",
                                    "drop_opening", "other_comm_vars",
                                    "wrong_num_proofs"])
def test_port_rejects_tampered_proof(port_statement, port_proof, tamper):
    proof = tser.deserialize(port_proof[0], "R1CSProof")
    num_proofs = NP
    if tamper == "swap_sc1_evals":
        e = proof.sc_proof_phase1.comm_evals
        e[0], e[1] = e[1], e[0]
    elif tamper == "swap_sc2_polys":
        c = proof.sc_proof_phase2.comm_polys
        c[0], c[1] = c[1], c[0]
    elif tamper == "drop_opening":
        proof.comm_vars_at_ry_list[0].pop()
    elif tamper == "other_comm_vars":
        proof.comm_vars_at_ry = proof.comm_vars_at_ry_list[0][0]
    else:
        num_proofs = [8, 2, 2]
    with pytest.raises((ProofVerifyError, AssertionError)):
        port_verify(port_statement, proof, port_proof[3], num_proofs)


def test_witness_sec_merge_matches_jax():
    """merge interleaves components by decreasing num_proofs
    (lib.rs:558-597, 655-695); concat appends."""
    counts = ([8, 2], [4, 4, 1], [2])

    def prover(mod, qs, arr):
        return mod.ProverWitnessSecInfo([NV] * len(qs),
                                        [arr((q, 1, 16)) for q in qs],
                                        [None] * len(qs))

    def verifier(mod, qs):
        return mod.VerifierWitnessSecInfo(qs, [NV] * len(qs), list(qs))

    for merge in ("merge", "concat"):
        j = getattr(jrp.ProverWitnessSecInfo, merge)(
            [prover(jrp, qs, np.zeros) for qs in counts])
        t = getattr(trp.ProverWitnessSecInfo, merge)(
            [prover(trp, qs, np.zeros) for qs in counts])
        jv = getattr(jrp.VerifierWitnessSecInfo, merge)(
            [verifier(jrp, qs) for qs in counts])
        tv = getattr(trp.VerifierWitnessSecInfo, merge)(
            [verifier(trp, qs) for qs in counts])
        if merge == "merge":
            assert t[1] == j[1] and tv[1] == jv[1]
            j, t, jv, tv = j[0], t[0], jv[0], tv[0]
        assert [m.shape[0] for m in t.w_mat] == \
            [m.shape[0] for m in j.w_mat]
        assert (tv.num_proofs, tv.comm_w) == (jv.num_proofs, jv.comm_w)
