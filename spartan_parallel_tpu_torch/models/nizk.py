"""NIZK: single-instance Spartan proof without circuit preprocessing.

Reference: src/lib.rs:3884-4005 (NIZK/NIZKGens upstream), rebuilt as in
the JAX package on the fork's data-parallel R1CSProof with P = 1, Q = 1
and two witness sections:

  sec 0: vars   (private, committed with zero row blinds)
  sec 1: [1, inputs, 0...]  (public; the verifier recomputes its
         commitment deterministically with zero blinds)

so z = [vars | 1, io] matches upstream's layout (lib.rs:3919-3964). As in
upstream NIZK, the proof stores the evaluation point; the verifier
evaluates A/B/C itself (lib.rs:3981-3984) and checks the point matches.

Every entry point takes `device`; the default is the card, and the CPU is
used only when the caller names it.
"""

from __future__ import annotations

import torch

from ..core import device as _device
from ..core.edwards import RistrettoPoint, multiscalar_mul
from ..core.field import Scalar
from ..ops import limbs as lb
from ..utils.errors import ProofVerifyError
from ..utils.random_tape import RandomTape
from ..utils.timer import Timer
from .dense_mlpoly import EqPolynomial, PolyCommitment, log2
from .r1csproof import (
    ProverWitnessSecInfo,
    R1CSGens,
    R1CSProof,
    VerifierWitnessSecInfo,
)

_ZERO = Scalar.zero()
_ONE = Scalar.one()


class NIZKGens:
    __slots__ = ("gens_r1cs_sat", "device")

    def __init__(self, num_cons: int, num_vars: int, device=None):
        self.device = _device.resolve(device)
        self.gens_r1cs_sat = R1CSGens(b"gens_r1cs_sat", num_cons, num_vars)


def _io_sec(num_vars: int, inputs) -> list:
    io = [_ONE] + [Scalar(int(v)) for v in inputs]
    io += [_ZERO] * (num_vars - len(io))
    return io


def _io_poly_and_comm(num_vars: int, inputs, gens_pc, device):
    """Sparse fast path for the public-io witness section: the io poly
    [1, inputs..., 0...] has len(inputs) + 1 live entries, so its table is
    zeros plus a short prefix, and its commitment is row 0 (a small host
    MSM) followed by identity points (every other row commits to zeros
    with a zero blind). Byte-identical to the dense path. Returns None
    when the prefix spills past row 0."""
    from ..ops import fq

    prefix = [_ONE] + [Scalar(int(v)) for v in inputs]
    k = len(prefix)
    left, right = EqPolynomial.compute_factored_lens(log2(num_vars))
    L_size, R_size = 1 << left, 1 << right
    if k > R_size:
        return None
    Zm = torch.zeros((num_vars, 16), dtype=torch.int32, device=device)
    Zm[:k] = lb.to_device(fq.encode(prefix), device)
    row0 = multiscalar_mul([int(v) for v in prefix],
                           gens_pc.gens.gens_n.G[:k])
    ident = RistrettoPoint.identity().compress()
    comm = PolyCommitment([row0.compress()] + [ident] * (L_size - 1))
    return Zm, comm


def _io_section(num_vars: int, inputs, gens_pc, device):
    """The public io witness section [1, inputs, 0...] and its zero-blind
    commitment: the sparse fast path where it applies, else the dense
    commit."""
    fast = _io_poly_and_comm(num_vars, inputs, gens_pc, device)
    if fast is not None:
        Zm, comm = fast
        return ProverWitnessSecInfo.from_tensors(
            [num_vars], [Zm.reshape(1, num_vars, 16)]), comm
    sec = ProverWitnessSecInfo.from_scalars(
        [num_vars], [[_io_sec(num_vars, inputs)]], device)
    comm, _ = sec.poly_w[0].commit(gens_pc, None)
    return sec, comm


class NIZK:
    __slots__ = ("r1cs_sat_proof", "comm_vars", "r")

    def __init__(self, r1cs_sat_proof, comm_vars, r):
        self.r1cs_sat_proof = r1cs_sat_proof
        self.comm_vars = comm_vars
        self.r = r

    @staticmethod
    def protocol_name() -> bytes:
        return b"Spartan NIZK proof"

    @staticmethod
    def prove(inst, vars_, inputs, gens: NIZKGens, transcript,
              random_tape=None, device=None):
        """inst: 1-instance R1CSInstance; vars_: num_vars ints; inputs:
        fewer than num_vars ints. `random_tape` may be injected for
        reproducible proofs; the default is a fresh OS-seeded tape as in
        the reference. device: the card unless the caller names the CPU."""
        dev = _device.resolve(device)
        timer = Timer("NIZK::prove")
        assert inst.get_num_instances() == 1
        num_vars = inst.get_num_vars() // 2  # per-section size
        assert len(vars_) == num_vars
        assert len(inputs) < num_vars

        transcript.append_protocol_name(NIZK.protocol_name())
        t_dig = Timer("instance_digest")
        transcript.append_message(b"R1CSInstanceDigest", inst.get_digest())
        t_dig.stop()

        if random_tape is None:
            random_tape = RandomTape(b"proof")

        # witness sec 0: private vars, committed with zero row blinds as the
        # fork does for every witness poly (lib.rs:1973 etc. pass None)
        t_wit = Timer("witness_commit")
        vars_sec = ProverWitnessSecInfo.from_scalars(
            [num_vars], [[[int(v) for v in vars_]]], dev)
        comm_vars, _blinds = vars_sec.poly_w[0].commit(
            gens.gens_r1cs_sat.gens_pc, None)
        comm_vars.append_to_transcript(b"poly_commitment", transcript)

        # witness sec 1: public io (deterministic zero-blind commitment)
        io_sec, comm_io = _io_section(num_vars, inputs,
                                      gens.gens_r1cs_sat.gens_pc, dev)
        comm_io.append_to_transcript(b"poly_commitment", transcript)
        t_wit.stop(dev)

        proof, r = R1CSProof.prove(
            1, 1, [1], num_vars, [num_vars], [vars_sec, io_sec], inst,
            gens.gens_r1cs_sat, transcript, random_tape, dev)
        timer.stop(dev)
        return NIZK(proof, comm_vars, r)

    def verify(self, inst, inputs, gens: NIZKGens, transcript, device=None):
        dev = _device.resolve(device)
        timer = Timer("NIZK::verify")
        num_vars = inst.get_num_vars() // 2  # per-section size
        transcript.append_protocol_name(NIZK.protocol_name())
        transcript.append_message(b"R1CSInstanceDigest", inst.get_digest())

        self.comm_vars.append_to_transcript(b"poly_commitment", transcript)
        t_io = Timer("verify_comm_io")
        comm_io = _io_section(num_vars, inputs, gens.gens_r1cs_sat.gens_pc,
                              dev)[1]
        comm_io.append_to_transcript(b"poly_commitment", transcript)
        t_io.stop()

        # evaluate A/B/C at the claimed point (upstream lib.rs:3981-3984)
        timer_eval = Timer("eval_sparse_polys")
        _rp, _rq_rev, rx, ry_full = self.r
        eA, eB, eC = inst.evaluate(rx, ry_full, device=dev)
        timer_eval.stop(dev)

        views = [VerifierWitnessSecInfo([1], [num_vars], [c])
                 for c in (self.comm_vars, comm_io)]
        r_out = self.r1cs_sat_proof.verify(
            1, 1, [1], num_vars, views, inst.get_num_cons(),
            gens.gens_r1cs_sat, (eA, eB, eC), transcript, dev)
        if r_out != self.r:
            raise ProofVerifyError("NIZK evaluation point mismatch")
        timer.stop()
