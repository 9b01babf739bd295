"""The slice end to end: SPARK and the upstream single-instance SNARK.

The fixed-tape SpartanSNARK at 16 constraints x 16 variables x 4 inputs
(nnz 16 per matrix), encoded and proved by the JAX package once per run
(shared across pytest-xdist workers) and by the port on the CPU: the
port's R1CSCommitment and proof must serialize to the JAX package's
bytes, with the same evaluation point and transcript state; each
package's verifier must accept the other's proof; the port's proof must
round-trip through its serialization and be rejected with wrong inputs or
a wrong claimed evaluation. Also the parts SPARK adds to the port's
modules against the JAX functions (the dense-polynomial helpers, the
timestamps and derefs, the hash layer), and a port-only R1CSEvalProof at
the shape of tests/test_spark.py. Tolerance: exact equality."""

import jax.numpy as jnp
import numpy as np
import pytest

from spartan_parallel_tpu import serialization as jser
from spartan_parallel_tpu.core.consts import L
from spartan_parallel_tpu.core.field import Scalar as JScalar
from spartan_parallel_tpu.models import dense_mlpoly as jdm
from spartan_parallel_tpu.models import r1csinstance as jri
from spartan_parallel_tpu.models import snark_single as jss
from spartan_parallel_tpu.models import sparse_mlpoly as jsp
from spartan_parallel_tpu.utils.random_tape import RandomTape as JTape
from spartan_parallel_tpu.utils.transcript import Transcript as JTranscript
from spartan_parallel_tpu_torch import serialization as tser
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models import dense_mlpoly as tdm
from spartan_parallel_tpu_torch.models import r1csinstance as tri
from spartan_parallel_tpu_torch.models import snark_single as tss
from spartan_parallel_tpu_torch.models import sparse_mlpoly as tsp
from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
from spartan_parallel_tpu_torch.utils.transcript import Transcript

from .torch_shared import device_rounds, in_fresh_process, shared_result

N, NUM_INPUTS = 16, 4
TAPE = b"\x09" * 32
LABEL = b"snark_single"

rng = np.random.default_rng(33)


def rand_ints(n):
    return [int.from_bytes(rng.bytes(40), "little") % L for _ in range(n)]


def ints(r):
    return [[int(x) for x in v] for v in r]


def nnz(inst):
    return max(m.get_num_nz_entries()
               for m in inst.A_list + inst.B_list + inst.C_list)


def same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64),
                          t.numpy().astype(np.int64))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's encode and fixed-tape prove: (commitment bytes,
    proof bytes, r, post-prove probe), and its statement."""
    inst, vm, im = jri.produce_synthetic_r1cs(1, [1], N, N, NUM_INPUTS)
    gens = jss.SpartanSNARKGens(N, N, nnz(inst))

    def prove():
        comm, decomm = jss.SpartanSNARK.encode(inst, gens)
        tp = JTranscript(LABEL)
        proof = jss.SpartanSNARK.prove(inst, comm, decomm, vm[0][0],
                                       im[0][0], gens, tp,
                                       JTape(b"proof", seed=TAPE))
        return (jser.serialize(comm, "R1CSCommitment"),
                jser.serialize(proof, "SpartanSNARK"), ints(proof.r),
                int(tp.challenge_scalar(b"probe")))

    return inst, gens, im[0][0], shared_result(tmp_path_factory,
                                               "jax_snark_single", prove)


def prove_port():
    inst, vm, im = tri.produce_synthetic_r1cs(1, [1], N, N, NUM_INPUTS,
                                              device="cpu")
    gens = tss.SpartanSNARKGens(N, N, nnz(inst))
    comm, decomm = tss.SpartanSNARK.encode(inst, gens, device="cpu")
    tp = Transcript(LABEL)
    proof = tss.SpartanSNARK.prove(inst, comm, decomm, vm[0][0], im[0][0],
                                   gens, tp, RandomTape(b"proof", seed=TAPE),
                                   device="cpu")
    return {"inst": inst, "gens": gens, "comm": comm, "inputs": im[0][0],
            "comm_bytes": tser.serialize(comm, "R1CSCommitment"),
            "bytes": tser.serialize(proof, "SpartanSNARK"),
            "r": ints(proof.r), "probe": int(tp.challenge_scalar(b"probe"))}


@pytest.fixture(scope="module")
def port_run():
    return prove_port()


@pytest.fixture(scope="module")
def port_run_dev():
    """The port's SNARK with device-resident sumcheck rounds on the CPU."""
    with device_rounds():
        return prove_port()


def port_verify(run, raw, inputs=None):
    proof = tser.deserialize(raw, "SpartanSNARK")
    proof.verify(run["comm"], run["inputs"] if inputs is None else inputs,
                 run["gens"], Transcript(LABEL), device="cpu")
    return proof


def test_commitment_matches_jax(jax_run, port_run):
    assert port_run["comm_bytes"] == jax_run[3][0]


def test_snark_matches_jax(jax_run, port_run):
    _, raw, r, probe = jax_run[3]
    assert port_run["r"] == r, "evaluation points differ"
    assert port_run["probe"] == probe, "transcript states differ"
    assert port_run["bytes"] == raw, "proof bytes differ"


def test_device_rounds_match_jax(jax_run, port_run_dev):
    """Device-resident rounds give the JAX host loop's commitment, bytes,
    point and transcript state; both packages verify the proof."""
    comm_raw, raw, r, probe = jax_run[3]
    assert port_run_dev["comm_bytes"] == comm_raw
    assert port_run_dev["r"] == r, "evaluation points differ"
    assert port_run_dev["probe"] == probe, "transcript states differ"
    assert port_run_dev["bytes"] == raw, "proof bytes differ"
    port_verify(port_run_dev, port_run_dev["bytes"])
    assert in_fresh_process(jax_verify, comm_raw, port_run_dev["bytes"])


def jax_verify(comm_raw: bytes, raw: bytes) -> bool:
    """The JAX package's verifier on a serialized SNARK of the fixture's
    statement (run in a fresh process: see tests/torch_shared.py)."""
    inst, _, im = jri.produce_synthetic_r1cs(1, [1], N, N, NUM_INPUTS)
    gens = jss.SpartanSNARKGens(N, N, nnz(inst))
    jser.deserialize(raw, "SpartanSNARK").verify(
        jser.deserialize(comm_raw, "R1CSCommitment"), im[0][0], gens,
        JTranscript(LABEL))
    return True


def test_port_verifies_jax_proof(jax_run, port_run):
    proof = port_verify(port_run, jax_run[3][1])
    assert ints(proof.r) == jax_run[3][2]


def test_jax_verifies_port_proof(jax_run, port_run):
    _, gens, inputs, (comm_raw, _, _, _) = jax_run
    comm = jser.deserialize(comm_raw, "R1CSCommitment")
    proof = jser.deserialize(port_run["bytes"], "SpartanSNARK")
    proof.verify(comm, inputs, gens, JTranscript(LABEL))


def test_serialization_roundtrip(port_run):
    proof = port_verify(port_run, port_run["bytes"])
    assert tser.serialize(proof, "SpartanSNARK") == port_run["bytes"]
    assert 0 < tser.compressed_size(proof, "SpartanSNARK") < \
        len(port_run["bytes"])
    comm = tser.deserialize(port_run["comm_bytes"], "R1CSCommitment")
    assert tser.serialize(comm) == port_run["comm_bytes"]


@pytest.mark.parametrize("tamper", ["wrong_input", "wrong_eval",
                                    "wrong_hash_eval", "wrong_dotp_claim",
                                    "swap_derefs_commitment"])
def test_port_rejects_tampered_proof(port_run, tamper):
    proof = tser.deserialize(port_run["bytes"], "SpartanSNARK")
    inputs = list(port_run["inputs"])
    spark = proof.r1cs_eval_proof.proof
    net = spark.poly_eval_network_proof
    if tamper == "wrong_input":
        inputs[0] = (int(inputs[0]) + 1) % L
    elif tamper == "wrong_eval":
        proof.inst_evals[0] = proof.inst_evals[0] + Scalar(1)
    elif tamper == "wrong_hash_eval":
        addr = net.proof_hash_layer.eval_row[0]
        addr[1] = addr[1] + Scalar(1)
    elif tamper == "wrong_dotp_claim":
        left = net.proof_prod_layer.eval_val[0]
        left[0] = left[0] + Scalar(1)
    else:
        # rows 0-2 commit to the row derefs of A, B and C, which are equal
        # here (every matrix has entry i in row i); row 3 to A's col derefs
        c = spark.comm_derefs.comm_ops_val.C
        assert c[0] != c[3]
        c[0], c[3] = c[3], c[0]
    with pytest.raises((ProofVerifyError, AssertionError)):
        proof.verify(port_run["comm"], inputs, port_run["gens"],
                     Transcript(LABEL), device="cpu")


def test_r1cs_eval_proof_roundtrip():
    """Port only, at the shape of tests/test_spark.py: an R1CSEvalProof of
    the three matrices at a random point (rx of 4, ry of 5 variables)
    verifies, and fails against a wrong claimed evaluation."""
    inst, _, _ = tri.produce_synthetic_r1cs(1, [1], 16, 16, 4, seed=13,
                                            device="cpu")
    gens = tri.R1CSCommitmentGens(b"spark_test", 1, 16, 32, nnz(inst))
    comm, decomm = tri.r1cs_commit(inst, gens, device="cpu")
    rx = [Scalar(v) for v in rand_ints(4)]
    ry = [Scalar(v) for v in rand_ints(5)]
    evals = list(inst.evaluate(rx, ry, device="cpu"))

    def transcript():
        t = Transcript(b"spark")
        comm.append_to_transcript(b"comm", t)
        return t

    proof = tri.R1CSEvalProof.prove(decomm, rx, ry, evals, gens,
                                    transcript(),
                                    RandomTape(b"tape", seed=b"\x07" * 32))
    raw = tser.serialize(proof, "R1CSEvalProof")
    tser.deserialize(raw, "R1CSEvalProof").verify(
        comm, rx, ry, evals, gens, transcript(), device="cpu")
    bad = [evals[0] + Scalar(1)] + evals[1:]
    with pytest.raises(ProofVerifyError):
        proof.verify(comm, rx, ry, bad, gens, transcript(), device="cpu")


def test_dense_polynomial_additions_match_jax():
    """clone, indexing, to_scalars, split, both binds, extend, merge and
    IdentityPolynomial against the JAX DensePolynomial."""
    vals, other = rand_ints(8), rand_ints(8)
    r = rand_ints(2)
    j = jdm.DensePolynomial.from_scalars(vals)
    t = tdm.DensePolynomial.from_scalars(vals, "cpu")
    assert [int(x) for x in t.to_scalars()] == vals
    assert int(t[3]) == int(j[3]) == vals[3]
    jl, jh = j.split(4)
    tl, th = t.split(4)
    assert same(jl.Zm, tl.Zm) and same(jh.Zm, th.Zm)
    jc, tc = j.clone(), t.clone()
    jc.bound_poly_var_top(r[0])
    tc.bound_poly_var_top(Scalar(r[0]))
    jc.bound_poly_var_bot(r[1])
    tc.bound_poly_var_bot(Scalar(r[1]))
    assert same(jc.Zm, tc.Zm) and tc.get_num_vars() == jc.get_num_vars() == 1
    assert same(j.Zm, t.Zm)  # the clone's binds leave the original
    jo = jdm.DensePolynomial.from_scalars(other)
    to = tdm.DensePolynomial.from_scalars(other, "cpu")
    jm = jdm.DensePolynomial.merge([j, jo, jl])
    tm = tdm.DensePolynomial.merge([t, to, tl])
    assert same(jm.Zm, tm.Zm) and len(tm) == 32
    j.extend(jo)
    t.extend(to)
    assert same(j.Zm, t.Zm) and t.get_num_vars() == 4
    pt = [Scalar(v) for v in rand_ints(5)]
    assert int(tdm.IdentityPolynomial(5).evaluate(pt)) == \
        int(jdm.IdentityPolynomial(5).evaluate([JScalar(int(x)) for x in pt]))


def test_timestamps_and_hash_layer_match_jax():
    """AddrTimestamps (read and audit timestamps of two instances over 8
    cells), a deref, and the hash of the init, read, write and audit
    tables, against the JAX package."""
    addrs = [rng.integers(0, 8, 16), rng.integers(0, 8, 16)]
    jat = jsp.AddrTimestamps(8, 16, addrs)
    tat = tsp.AddrTimestamps(8, 16, addrs, "cpu")
    for jp, tp_ in zip(jat.ops_addr + jat.read_ts + [jat.audit_ts],
                       tat.ops_addr + tat.read_ts + [tat.audit_ts]):
        assert same(jp.Zm, tp_.Zm)
    mem = rand_ints(8)
    jmem = jdm.scalars_to_mont(mem)
    tmem = tdm.scalars_to_mont(mem, "cpu")
    jd, td = jat.deref(jmem), tat.deref(tmem)
    assert all(same(a.Zm, b.Zm) for a, b in zip(jd, td))
    rh, rm = rand_ints(2)
    (mem_h, read_h, write_h) = tsp.Layers.hash_tables(
        tmem, tat, td, (Scalar(rh), Scalar(rm)))
    jl = jsp.Layers(jmem, jat, jd, (JScalar(rh), JScalar(rm))).prod_layer
    assert same(jl.init.left_vec[0], mem_h[0, :4])
    assert same(jl.audit.right_vec[0], mem_h[1, 4:])
    for i in range(2):
        assert same(jl.read_vec[i].left_vec[0], read_h[i, :8])
        assert same(jl.write_vec[i].right_vec[0], write_h[i, 8:])
    # the hash itself (one pass on the card), on tables that broadcast,
    # and with the write timestamps' hash h + r^2 from the same read
    # against JAX's hash of ts + 1
    a, v, ts = (tdm.scalars_to_mont(rand_ints(4), "cpu") for _ in range(3))
    ts2 = tdm.scalars_to_mont(rand_ints(8), "cpu").reshape(2, 4, 16)
    ch = tdm.scalars_to_mont(rand_ints(3), "cpu")
    one = tdm.scalars_to_mont([1], "cpu")[0]

    def jx(*xs):
        return [jnp.asarray(x.numpy().astype(np.uint32)) for x in xs]

    want = jsp._hash_poly(*jx(a, v, ts, ch[0], ch[1], ch[2]))
    assert same(want, tsp._hash_poly(a, v, ts, ch[0], ch[1], ch[2]))
    for t in (ts, ts2):
        want_r = jsp._hash_poly(*jx(a, v, t, ch[0], ch[1], ch[2]))
        want_w = jsp._hash_poly(*jx(a, v, tsp.fq.add(t, one), ch[0], ch[1],
                                    ch[2]))
        got_r, got_w = tsp._hash_poly(a, v, t, ch[0], ch[1], ch[2],
                                      write=True)
        assert same(want_r, got_r) and same(want_w, got_w)
        assert same(want_r, tsp.hash_poly_plain(a, v, t, ch[0], ch[1],
                                                ch[2]))
