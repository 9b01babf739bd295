"""Upstream-style single-instance SNARK: SAT proof + SPARK eval proof.

Reference: upstream Spartan's SNARK (one R1CS instance, circuit
preprocessing by `encode`, a verifier sublinear in the non-zeros), as the
JAX package's models/snark_single.py rebuilds it from the fork's parts:

  encode  -> r1cs_commit                (r1csinstance.rs:717-736)
  prove   -> R1CSProof (P = Q = 1, two witness sections, as models/nizk.py)
             + the matrices evaluated at (rx, ry) + R1CSEvalProof
             (r1csinstance.rs:738-780 around SPARK, sparse_mlpoly.rs:1497)
  verify  -> the SAT proof against the claimed evaluations, then the eval
             proof checks those claims against the circuit commitment: the
             verifier never reads the matrices.

The Timers carry upstream's profile names (SNARK::encode, SNARK::prove,
eval_sparse_polys, commit_nondet_witness, build_layered_network,
evalproof_layered_network, SNARK::verify, verify_sat_proof,
verify_eval_proof), so the stage times line up with upstream's profile.
Every entry point takes `device`; the default is the card, and the CPU is
used only when the caller names it.
"""

from __future__ import annotations

from ..core import device as _device
from ..utils.errors import ProofVerifyError
from ..utils.random_tape import RandomTape
from ..utils.timer import Timer
from .nizk import _io_section
from .r1csinstance import R1CSCommitmentGens, R1CSEvalProof, r1cs_commit
from .r1csproof import (
    ProverWitnessSecInfo,
    R1CSGens,
    R1CSProof,
    VerifierWitnessSecInfo,
)


class SpartanSNARKGens:
    """gens for the SAT proof and the SPARK commitment (upstream
    SNARKGens)."""

    __slots__ = ("gens_r1cs_sat", "gens_r1cs_eval")

    def __init__(self, num_cons: int, num_vars: int, num_nz_entries: int):
        self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons, num_vars)
        self.gens_r1cs_eval = R1CSCommitmentGens(
            b"gens_r1cs_eval", 1, num_cons, num_vars, num_nz_entries)


class SpartanSNARK:
    """Single-instance SNARK with circuit preprocessing."""

    __slots__ = ("r1cs_sat_proof", "comm_vars", "inst_evals",
                 "r1cs_eval_proof", "r")

    def __init__(self, r1cs_sat_proof, comm_vars, inst_evals,
                 r1cs_eval_proof, r):
        self.r1cs_sat_proof = r1cs_sat_proof
        self.comm_vars = comm_vars
        self.inst_evals = inst_evals
        self.r1cs_eval_proof = r1cs_eval_proof
        self.r = r

    @staticmethod
    def protocol_name() -> bytes:
        return b"Spartan SNARK proof"

    @staticmethod
    def encode(inst, gens: SpartanSNARKGens, device=None):
        """Commit to the circuit's matrices (preprocessing). The
        decommitment stays on `device`, where the prover will use it."""
        dev = _device.resolve(device)
        timer = Timer("SNARK::encode")
        comm, decomm = r1cs_commit(inst, gens.gens_r1cs_eval, dev)
        timer.stop(dev)
        return comm, decomm

    @staticmethod
    def prove(inst, comm, decomm, vars_, inputs, gens: SpartanSNARKGens,
              transcript, random_tape=None, device=None):
        """inst: 1-instance R1CSInstance; vars_: num_vars ints; inputs:
        fewer than num_vars ints; decomm from encode on the same device.
        `random_tape` may be injected for reproducible proofs."""
        dev = _device.resolve(device)
        if decomm.dense.comb_ops.Zm.device.type != dev.type:
            raise ValueError("the decommitment lies on another device")
        timer = Timer("SNARK::prove")
        assert inst.get_num_instances() == 1
        num_vars = inst.get_num_vars() // 2  # per-section size
        assert len(vars_) == num_vars
        assert len(inputs) < num_vars

        transcript.append_protocol_name(SpartanSNARK.protocol_name())
        comm.comm.append_to_transcript(b"comm", transcript)

        if random_tape is None:
            random_tape = RandomTape(b"proof")

        vars_sec = ProverWitnessSecInfo.from_scalars(
            [num_vars], [[[int(v) for v in vars_]]], dev)
        comm_vars, _ = vars_sec.poly_w[0].commit(
            gens.gens_r1cs_sat.gens_pc, None)
        comm_vars.append_to_transcript(b"poly_commitment", transcript)

        io_sec, comm_io = _io_section(num_vars, inputs,
                                      gens.gens_r1cs_sat.gens_pc, dev)
        comm_io.append_to_transcript(b"poly_commitment", transcript)

        sat_proof, r = R1CSProof.prove(
            1, 1, [1], num_vars, [num_vars], [vars_sec, io_sec], inst,
            gens.gens_r1cs_sat, transcript, random_tape, dev)

        _rp, _rq_rev, rx, ry = r
        timer_eval = Timer("eval_sparse_polys")
        eA, eB, eC = inst.evaluate(rx, ry, device=dev)
        timer_eval.stop(dev)
        for e in (eA, eB, eC):
            transcript.append_scalar(b"ABCr_claim", e)

        eval_proof = R1CSEvalProof.prove(
            decomm, rx, ry, [eA, eB, eC], gens.gens_r1cs_eval,
            transcript, random_tape)
        timer.stop(dev)
        return SpartanSNARK(sat_proof, comm_vars, (eA, eB, eC),
                            eval_proof, r)

    def verify(self, comm, inputs, gens: SpartanSNARKGens, transcript,
               device=None):
        dev = _device.resolve(device)
        timer = Timer("SNARK::verify")
        num_vars = comm.num_vars // 2  # per-section size
        transcript.append_protocol_name(SpartanSNARK.protocol_name())
        comm.comm.append_to_transcript(b"comm", transcript)

        self.comm_vars.append_to_transcript(b"poly_commitment", transcript)
        comm_io = _io_section(num_vars, inputs, gens.gens_r1cs_sat.gens_pc,
                              dev)[1]
        comm_io.append_to_transcript(b"poly_commitment", transcript)

        vars_view = VerifierWitnessSecInfo([1], [num_vars], [self.comm_vars])
        io_view = VerifierWitnessSecInfo([1], [num_vars], [comm_io])
        timer_sat = Timer("verify_sat_proof")
        r_out = self.r1cs_sat_proof.verify(
            1, 1, [1], num_vars, [vars_view, io_view], comm.num_cons,
            gens.gens_r1cs_sat, self.inst_evals, transcript, dev)
        timer_sat.stop(dev)
        if r_out != self.r:
            raise ProofVerifyError("SNARK evaluation point mismatch")

        _rp, _rq_rev, rx, ry = self.r
        for e in self.inst_evals:
            transcript.append_scalar(b"ABCr_claim", e)
        timer_eval = Timer("verify_eval_proof")
        self.r1cs_eval_proof.verify(comm, rx, ry, list(self.inst_evals),
                                    gens.gens_r1cs_eval, transcript, dev)
        timer_eval.stop(dev)
        timer.stop(dev)
