"""The slice end to end: the 9-stage data-parallel SNARK.

The counter program (examples.build_counter_program: two blocks executed
0 -> 1 -> 0 -> 1, no memory) under one fixed tape, encoded and proved by
the JAX package once per run, in a fresh process (shared across
pytest-xdist workers), and by
the port on the CPU: the port's circuit commitments, proof and transcript
state after prove must equal the JAX package's; the port's verifier must
accept the JAX proof and reject tampered ones. Also the slice's modules
against the JAX functions: the univariate evaluation (K7's plain version
and the rlc dot), the instance generators (matrices, nnz, digests) and the
grouped commitment's label map; and a synthetic zkVM of three blocks that
proves and verifies. Tolerance: exact equality."""

import numpy as np
import pytest

from spartan_parallel_tpu import examples as jex
from spartan_parallel_tpu import serialization as jser
from spartan_parallel_tpu.core.consts import L
from spartan_parallel_tpu.core.field import Scalar as JScalar
from spartan_parallel_tpu.models import dense_mlpoly as jdm
from spartan_parallel_tpu.models import instance as jinst
from spartan_parallel_tpu.models import r1csinstance as jri
from spartan_parallel_tpu.models.snark import SNARK as JSNARK
from spartan_parallel_tpu.utils.random_tape import RandomTape as JTape
from spartan_parallel_tpu.utils.transcript import Transcript as JTranscript
from spartan_parallel_tpu_torch import examples as tex
from spartan_parallel_tpu_torch import serialization as tser
from spartan_parallel_tpu_torch.core.field import Scalar
from spartan_parallel_tpu_torch.models import dense_mlpoly as tdm
from spartan_parallel_tpu_torch.models import instance as tinst
from spartan_parallel_tpu_torch.models import r1csinstance as tri
from spartan_parallel_tpu_torch.models.snark import SNARK, SNARKGens
from spartan_parallel_tpu_torch.ops import fq, uni
from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
from spartan_parallel_tpu_torch.utils.transcript import Transcript

from .torch_shared import (
    case_rng, device_rounds, in_fresh_process, shared_result,
)

TAPE = b"\x07" * 32
LABEL = b"snark_example"

rng = np.random.default_rng(41)


def rand_ints(n):
    return [int.from_bytes(rng.bytes(40), "little") % L for _ in range(n)]


def same(j, t):
    return np.array_equal(np.asarray(j).astype(np.int64),
                          t.numpy().astype(np.int64))


def prove_args(pa, ctx):
    """SNARK.prove's arguments up to vars_gens, in order (both packages)."""
    return (
        pa["input_block_num"], pa["output_block_num"],
        pa["input_liveness"], pa["func_input_width"], pa["input_offset"],
        pa["output_offset"], pa["input_"], pa["output"],
        pa["output_exec_num"], pa["num_vars"], pa["num_ios"],
        pa["max_block_num_phy_ops"], pa["block_num_phy_ops"],
        pa["max_block_num_vir_ops"], pa["block_num_vir_ops"],
        pa["mem_addr_ts_bits_size"], pa["num_inputs_unpadded"],
        pa["block_num_vars"], pa["block_num_instances_bound"],
        pa["block_max_num_proofs"], pa["block_num_proofs"],
        ctx["block_inst"], ctx["block_comm_map"], ctx["block_comm_list"],
        ctx["block_decomm_list"], ctx["block_gens"],
        pa["consis_num_proofs"], pa["total_num_init_phy_mem_accesses"],
        pa["total_num_init_vir_mem_accesses"],
        pa["total_num_phy_mem_accesses"],
        pa["total_num_vir_mem_accesses"], ctx["pairwise_inst"],
        ctx["pairwise_comm"], ctx["pairwise_decomm"], ctx["pairwise_gens"],
        pa["block_vars_mat"], pa["exec_inputs_list"],
        pa["init_phy_mems_list"], pa["init_vir_mems_list"],
        pa["addr_phy_mems_list"], pa["addr_vir_mems_list"],
        pa["addr_ts_bits_list"], ctx["perm_root_inst"],
        ctx["perm_root_comm"], ctx["perm_root_decomm"],
        ctx["perm_root_gens"], ctx["vars_gens"])


def comm_bytes(ser, ctx):
    return [ser.serialize(c.comm, "R1CSCommitment")
            for c in ctx["block_comm_list"] + [ctx["pairwise_comm"],
                                               ctx["perm_root_comm"]]]


def jax_counter_run():
    """The JAX package's counter SNARK under TAPE: (label map, commitment
    bytes, proof bytes, transcript probe after prove)."""
    args, pa = jex.build_counter_program()
    ctx = jex.setup_counter_instances(args)
    tp = JTranscript(LABEL)
    proof = JSNARK.prove(*prove_args(pa, ctx), tp,
                         random_tape=JTape(b"proof", seed=TAPE))
    return (ctx["block_comm_map"], comm_bytes(jser, ctx),
            jser.serialize(proof, "SNARK"),
            int(tp.challenge_scalar(b"probe")))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """jax_counter_run once a run, in a fresh process, so that the XLA
    executables of the JAX prove do not stay mapped in a worker."""
    return shared_result(tmp_path_factory, "jax_snark_counter",
                         lambda: in_fresh_process(jax_counter_run,
                                                  timeout=1200))


def prove_port():
    args, pa = tex.build_counter_program()
    ctx = tex.setup_counter_instances(args, device="cpu")
    tp = Transcript(LABEL)
    proof = SNARK.prove(*prove_args(pa, ctx), tp,
                        random_tape=RandomTape(b"proof", seed=TAPE),
                        device="cpu")
    return {"pa": pa, "ctx": ctx, "bytes": tser.serialize(proof, "SNARK"),
            "probe": int(tp.challenge_scalar(b"probe"))}


@pytest.fixture(scope="module")
def port_run():
    return prove_port()


@pytest.fixture(scope="module")
def port_run_dev():
    """The port's counter SNARK with device-resident sumcheck rounds on the
    CPU (the plain round tail of ops/zk_round.py, ~40 s)."""
    with device_rounds():
        return prove_port()


def port_verify(run, raw, **changes):
    proof = raw if isinstance(raw, SNARK) else tser.deserialize(raw, "SNARK")
    tex.verify_counter(proof, dict(run["pa"], **changes), run["ctx"],
                       device="cpu")
    return proof


def test_encode_matches_jax(jax_run, port_run):
    """multi_encode's label map and commitments, and the two encodes."""
    label_map, comms, _, _ = jax_run
    assert port_run["ctx"]["block_comm_map"] == label_map
    assert comm_bytes(tser, port_run["ctx"]) == comms


def test_snark_matches_jax(jax_run, port_run):
    _, _, raw, probe = jax_run
    assert port_run["probe"] == probe, "transcript states differ"
    assert port_run["bytes"] == raw, "proof bytes differ"


def test_device_rounds_match_jax(jax_run, port_run_dev):
    """Device-resident rounds give the JAX host loop's bytes and transcript
    state, and the port verifies the proof."""
    _, _, raw, probe = jax_run
    assert port_run_dev["probe"] == probe, "transcript states differ"
    assert port_run_dev["bytes"] == raw, "proof bytes differ"
    port_verify(port_run_dev, port_run_dev["bytes"])


def test_port_verifies_jax_proof(jax_run, port_run):
    port_verify(port_run, jax_run[2])


def test_serialization_roundtrip(port_run):
    proof = port_verify(port_run, port_run["bytes"])
    assert tser.serialize(proof, "SNARK") == port_run["bytes"]
    assert 0 < tser.compressed_size(proof, "SNARK") < len(port_run["bytes"])


@pytest.mark.parametrize("tamper", ["wrong_output", "shift_opening",
                                    "perm_product", "io_proof"])
def test_port_rejects_tampered_proof(port_run, tamper):
    proof = tser.deserialize(port_run["bytes"], "SNARK")
    changes = {}
    if tamper == "wrong_output":
        changes["output"] = (port_run["pa"]["output"] + 1) % L
    elif tamper == "shift_opening":
        op = proof.shift_proof.openings[0]
        op[0], op[1] = op[1], op[0]
        assert op[0] != op[1]
    elif tamper == "perm_product":
        proof.perm_poly_poly_list[0] = proof.perm_poly_poly_list[0] + \
            Scalar(1)
    else:
        dp = proof.io_proof.proofs[0].proof
        dp.z1 = dp.z1 + Scalar(1)
    with pytest.raises(ProofVerifyError):
        port_verify(port_run, proof, **changes)


# --------------------------------------------------------------------------
# The univariate evaluation: K7's plain version and the rlc dot
# --------------------------------------------------------------------------
POWERS = [1, 2, 7, 512, 1000]


def powers_inputs(n):
    """The challenge and table of the case n, drawn from a seed of its own
    (the same in every worker and in the JAX process)."""
    g = case_rng("powers", n)
    vals = [int.from_bytes(g.bytes(40), "little") % L for _ in range(n + 1)]
    return vals[0], vals[1:]


# the tables uni_evaluate_many evaluates at one point in one call
MANY = [1, 7, 512, 1000]


def many_inputs():
    g = case_rng("uni_many")
    c = int.from_bytes(g.bytes(40), "little") % L
    return c, [[int.from_bytes(g.bytes(40), "little") % L for _ in range(n)]
               for n in MANY]


def jax_powers_refs():
    """The JAX package's powers, rlc dot and uni_evaluate of every case,
    and uni_evaluate of each of MANY's tables at one point, in one
    process."""
    c, zs = many_inputs()
    out = {"many": [int(jdm.uni_evaluate(jdm.DensePolynomial.from_scalars(z),
                                         JScalar(c))) for z in zs]}
    for n in POWERS:
        c, z = powers_inputs(n)
        jc = jdm.scalars_to_mont([c])[0]
        pw = jdm._powers_dev(jc, n=n)
        out[n] = (np.asarray(pw),
                  np.asarray(jdm._rlc_eval_dev(jdm.scalars_to_mont(z), pw)),
                  int(jdm.uni_evaluate(jdm.DensePolynomial.from_scalars(z),
                                       JScalar(c))))
    return out


@pytest.fixture(scope="module")
def jax_powers(tmp_path_factory):
    return shared_result(tmp_path_factory, "jax_powers_refs",
                         lambda: in_fresh_process(jax_powers_refs,
                                                  timeout=900))


@pytest.mark.parametrize("n", POWERS)
def test_powers_and_rlc_eval_match_jax(jax_powers, n):
    """K7's plain version, the rlc dot and uni_evaluate against the JAX
    package's (computed once a run in a fresh process)."""
    c, z = powers_inputs(n)
    want_pw, want_rlc, want_uni = jax_powers[n]
    tc = tdm.scalars_to_mont([c], "cpu")[0]
    got = uni.fq_powers(tc, n)
    assert same(want_pw, got)
    assert fq.decode(got) == [pow(c, i, L) for i in range(n)]
    zm = tdm.scalars_to_mont(z, "cpu")
    assert same(want_rlc, fq.dot(zm, got, axis=0, counter="rlc_eval"))
    # uni_evaluate on the table padded to a power of two, as a poly is
    tpoly = tdm.DensePolynomial.from_scalars(z, "cpu")
    assert int(tdm.uni_evaluate(tpoly, Scalar(c))) == want_uni == \
        sum(v * pow(c, i, L) for i, v in enumerate(z)) % L


def test_uni_evaluate_many_matches_jax(jax_powers):
    """Tables of 1, 7, 512 and 1,000 entries (padded to powers of two, as
    a polynomial is) evaluated at one point in one call, against the JAX
    package's uni_evaluate of each."""
    c, zs = many_inputs()
    polys = [tdm.DensePolynomial.from_scalars(z, "cpu") for z in zs]
    got = [int(v) for v in tdm.uni_evaluate_many(polys, Scalar(c))]
    assert got == jax_powers["many"] == [
        sum(v * pow(c, i, L) for i, v in enumerate(z)) % L for z in zs]
    assert tdm.uni_evaluate_many([], Scalar(c)) == []


# --------------------------------------------------------------------------
# Instances and the grouped commitment
# --------------------------------------------------------------------------
def _mem_args():
    """The memory program's block args (tests/test_snark_mem.py), with one
    physical and one virtual memory op per block."""
    from .test_snark_mem import build_mem_program

    return build_mem_program()[0]


def same_instance(j, t):
    assert (j.inst.num_instances, j.inst.max_num_cons, j.inst.num_cons,
            j.inst.num_vars) == (t.inst.num_instances, t.inst.max_num_cons,
                                 t.inst.num_cons, t.inst.num_vars)
    for jm, tm in zip(j.inst.A_list + j.inst.B_list + j.inst.C_list,
                      t.inst.A_list + t.inst.B_list + t.inst.C_list):
        assert jm.get_num_nz_entries() == tm.get_num_nz_entries()
        assert np.array_equal(jm.rows, tm.rows)
        assert np.array_equal(jm.cols, tm.cols)
        assert jm.vals == tm.vals
    assert j.digest == t.digest


@pytest.mark.parametrize("program", ["counter", "memory", "zkvm"])
def test_instances_match_jax(program):
    """gen_block_inst, gen_pairwise_check_inst and gen_perm_root_inst:
    sizes, nnz, matrices and digests; the sorted copy's digest is the
    original's in both packages."""
    if program == "counter":
        args, niu, nv, ops = jex.build_counter_program()[0], 3, 8, [0, 0]
    elif program == "memory":
        args, niu, nv, ops = _mem_args(), 3, 16, [1, 1]
    else:
        args, pa = jex.build_synthetic_zkvm(3, 64, (4, 2, 1))
        niu, nv, ops = 3, pa["num_vars"], [0, 0, 0]
    nb = len(args)
    jb = jinst.gen_block_inst(nb, nv, args, niu, ops, ops)
    tb = tinst.gen_block_inst(nb, nv, args, niu, ops, ops, device="cpu")
    assert jb[:3] == tb[:3]
    same_instance(jb[3], tb[3])
    jp = jinst.gen_pairwise_check_inst(6, 8)
    tp = tinst.gen_pairwise_check_inst(6, 8, "cpu")
    assert jp[:3] == tp[:3]
    same_instance(jp[3], tp[3])
    jr = jinst.gen_perm_root_inst(niu, 8)
    tr = tinst.gen_perm_root_inst(niu, 8, "cpu")
    assert jr[:2] == tr[:2]
    same_instance(jr[2], tr[2])
    index = list(range(nb))[::-1]
    jb[3].sort(nb, index)
    tb[3].sort(nb, index)
    same_instance(jb[3], tb[3])


def test_instance_rejects_bad_entries_and_checks_sat():
    with pytest.raises(tinst.R1CSError):
        tinst.Instance(1, 2, [2], 4, [[(2, 0, 1)]], [[]], [[]], "cpu")
    with pytest.raises(tinst.R1CSError):
        tinst.Instance(1, 2, [2], 4, [[(0, 4, 1)]], [[]], [[]], "cpu")
    # x0 * x0 = x1 over z = [vars | 1, inputs]
    A, B, C = [[(0, 0, 1)]], [[(0, 0, 1)]], [[(0, 1, 1)]]
    ji = jinst.Instance(1, 1, [1], 8, A, B, C)
    ti = tinst.Instance(1, 1, [1], 8, A, B, C, "cpu")
    same_instance(ji, ti)
    for vars_, ok in (([3, 9], True), ([3, 8], False)):
        assert ti.is_sat([[vars_]], [[[]]]) is ok
        assert ji.is_sat([[vars_]], [[[]]]) is ok


def test_multi_commit_groups_match_jax():
    """next_power_of_eight and the label map of the grouped commitment on
    an instance whose matrices fall into three nnz groups."""
    for v in (0, 1, 2, 8, 9, 64, 65, 4096, 4097):
        assert tri.next_power_of_eight(v) == jri.next_power_of_eight(v)
    args = [[([(i % 8, 1)], [(i % 8, 1)], [((i + 1) % 8, 1)])
             for i in range(n)] for n in (1, 100, 600)]
    nv, nc, nnz, tb = tinst.gen_block_inst(3, 8, args, 3, [0] * 3,
                                           [0] * 3, device="cpu")
    gens = SNARKGens(nc, nv, 3, nnz).gens_r1cs_eval
    label_map, comms, decomms = tri.r1cs_multi_commit(tb.inst, gens, "cpu")
    sizes = [jri.next_power_of_eight(jdm.next_pow2(max(
        1, m.get_num_nz_entries())))
        for i in range(3) for m in (tb.inst.A_list[i], tb.inst.B_list[i],
                                    tb.inst.C_list[i])]
    want = {}
    for label, s in enumerate(sizes):
        want.setdefault(s, []).append(label)
    assert label_map == list(want.values())
    assert len(label_map) == len(comms) == len(decomms) == 3


# --------------------------------------------------------------------------
# The find_min-shaped synthetic zkVM at a tiny shape
# --------------------------------------------------------------------------
def test_synthetic_zkvm_proves_and_verifies():
    """Three blocks of 64 constraints executed (4, 2, 1) times: three
    q-size classes in the block proof; a wrong output is rejected."""
    args, pa = tex.build_synthetic_zkvm(num_blocks=3, block_cons=64,
                                        num_execs=(4, 2, 1))
    ctx = tex.setup_program_instances(args, pa, device="cpu")
    proof = tex.prove_program(pa, ctx, label=b"test_zkvm",
                              tape_seed=TAPE, device="cpu")
    tex.verify_program(proof, pa, ctx, label=b"test_zkvm", device="cpu")
    bad_pa = dict(pa, output=(pa["output"] + 1) % L)
    with pytest.raises(ProofVerifyError):
        tex.verify_program(proof, bad_pa, ctx, label=b"test_zkvm",
                           device="cpu")
