"""The slice end to end: the fixed-tape NIZK at 16 constraints x 16
variables x 4 inputs (as in tests/test_r1cs.py) through the port on the
CPU must serialize to the JAX package's bytes, each package's verifier
must accept the other's proof (each parsing it with its own
serialization.py), and a tampered proof must be rejected. The same with
every sumcheck round device-resident (torch_shared.device_rounds: the
plain round tail of ops/zk_round.py on the CPU) against the JAX host
loop's bytes."""

import pytest

from spartan_parallel_tpu import serialization as jser
from spartan_parallel_tpu.models import nizk as jnizk
from spartan_parallel_tpu.models import r1csinstance as jri
from spartan_parallel_tpu.utils.random_tape import RandomTape as JTape
from spartan_parallel_tpu.utils.transcript import Transcript as JTranscript
from spartan_parallel_tpu_torch import serialization as tser
from spartan_parallel_tpu_torch.core.consts import L
from spartan_parallel_tpu_torch.models import nizk as tnizk
from spartan_parallel_tpu_torch.models import r1csinstance as tri
from spartan_parallel_tpu_torch.utils.errors import ProofVerifyError
from spartan_parallel_tpu_torch.utils.random_tape import RandomTape
from spartan_parallel_tpu_torch.utils.transcript import Transcript

from .torch_shared import device_rounds, in_fresh_process, shared_result

SEED = b"\x05" * 32


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    inst, vm, im = jri.produce_synthetic_r1cs(1, [1], 16, 16, 4)
    gens = jnizk.NIZKGens(16, 16)

    def prove():
        proof = jnizk.NIZK.prove(inst, vm[0][0], im[0][0], gens,
                                 JTranscript(b"nizk_example"),
                                 JTape(b"proof", seed=SEED))
        return jser.serialize(proof, "NIZK")

    return inst, gens, im[0][0], shared_result(tmp_path_factory,
                                               "jax_nizk_proof", prove)


@pytest.fixture(scope="module")
def port_run():
    inst, vm, im = tri.produce_synthetic_r1cs(1, [1], 16, 16, 4,
                                              device="cpu")
    gens = tnizk.NIZKGens(16, 16, device="cpu")
    proof = tnizk.NIZK.prove(inst, vm[0][0], im[0][0], gens,
                             Transcript(b"nizk_example"),
                             RandomTape(b"proof", seed=SEED), device="cpu")
    return inst, gens, im[0][0], tser.serialize(proof, "NIZK")


@pytest.fixture(scope="module")
def port_run_dev():
    """The port's NIZK with device-resident rounds on the CPU."""
    with device_rounds():
        inst, vm, im = tri.produce_synthetic_r1cs(1, [1], 16, 16, 4,
                                                  device="cpu")
        gens = tnizk.NIZKGens(16, 16, device="cpu")
        proof = tnizk.NIZK.prove(inst, vm[0][0], im[0][0], gens,
                                 Transcript(b"nizk_example"),
                                 RandomTape(b"proof", seed=SEED),
                                 device="cpu")
    return inst, gens, im[0][0], tser.serialize(proof, "NIZK")


def test_proof_bytes_match_jax(jax_run, port_run):
    assert port_run[3] == jax_run[3]


def test_port_verifies_jax_proof(jax_run, port_run):
    inst, gens, inputs, _ = port_run
    proof = tser.deserialize(jax_run[3], "NIZK")
    proof.verify(inst, inputs, gens, Transcript(b"nizk_example"),
                 device="cpu")


def test_jax_verifies_port_proof(jax_run, port_run):
    inst, gens, inputs, _ = jax_run
    proof = jser.deserialize(port_run[3], "NIZK")
    proof.verify(inst, inputs, gens, JTranscript(b"nizk_example"))


@pytest.mark.parametrize("tamper", ["swap_sc_evals", "wrong_input",
                                    "drop_opening"])
def test_port_rejects_tampered_proof(port_run, tamper):
    inst, gens, inputs, raw = port_run
    proof = tser.deserialize(raw, "NIZK")
    if tamper == "swap_sc_evals":
        sc = proof.r1cs_sat_proof.sc_proof_phase1
        sc.comm_evals[0], sc.comm_evals[1] = sc.comm_evals[1], \
            sc.comm_evals[0]
    elif tamper == "drop_opening":
        proof.r1cs_sat_proof.comm_vars_at_ry_list.pop()
    else:
        inputs = [(inputs[0] + 1) % L] + list(inputs[1:])
    with pytest.raises((ProofVerifyError, AssertionError)):
        proof.verify(inst, inputs, gens, Transcript(b"nizk_example"),
                     device="cpu")


def jax_verify(raw: bytes) -> bool:
    """The JAX package's verifier on a serialized NIZK of the fixture's
    statement (run in a fresh process: see tests/torch_shared.py)."""
    inst, _, im = jri.produce_synthetic_r1cs(1, [1], 16, 16, 4)
    jser.deserialize(raw, "NIZK").verify(inst, im[0][0],
                                         jnizk.NIZKGens(16, 16),
                                         JTranscript(b"nizk_example"))
    return True


def test_device_rounds_match_jax(jax_run, port_run_dev):
    """Device-resident rounds give the JAX host loop's bytes, and both
    packages verify the proof."""
    assert port_run_dev[3] == jax_run[3]
    inst, gens, inputs, raw = port_run_dev
    tser.deserialize(raw, "NIZK").verify(
        inst, inputs, gens, Transcript(b"nizk_example"), device="cpu")
    assert in_fresh_process(jax_verify, raw)


@pytest.mark.parametrize("tamper", ["comm_poly_byte", "z"])
def test_port_rejects_tampered_device_round(port_run_dev, tamper):
    """A flipped byte in a device round's comm_poly, or a changed z of its
    DotProductProof, is rejected (an encoding that no longer decodes
    raises ValueError)."""
    inst, gens, inputs, raw = port_run_dev
    proof = tser.deserialize(raw, "NIZK")
    sc = proof.r1cs_sat_proof.sc_proof_phase2
    if tamper == "comm_poly_byte":
        c = bytearray(sc.comm_polys[1])
        c[5] ^= 0x10
        sc.comm_polys[1] = bytes(c)
    else:
        dp = sc.proofs[1]
        dp.z[2] = dp.z[2] + dp.z[0]
    with pytest.raises((ProofVerifyError, AssertionError, ValueError)):
        proof.verify(inst, inputs, gens, Transcript(b"nizk_example"),
                     device="cpu")
