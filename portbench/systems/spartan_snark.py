"""Upstream Spartan's single-instance SNARK through the port
(models/snark_single.py): set-up builds the instance, the generators and
the SPARK encode of the circuit; the steps a mix may name are `prove`
(SpartanSNARK.prove) and `verify` (SpartanSNARK.verify of the request's
proof).
"""

from __future__ import annotations

import random
import time

from .. import workload
from ..reference import checks
from ._tape import recording_tape


def statement(cfg: dict, seed: int):
    """(matrices, vars, inputs) of the configuration, from the seed."""
    return workload.synthetic_r1cs(cfg["num_cons"], cfg["num_vars"],
                                   cfg["num_inputs"],
                                   workload.rng_for(seed, "r1cs"))


class System:
    def __init__(self, cfg: dict, seed: int, device):
        from spartan_parallel_tpu_torch.models.r1csinstance import (
            R1CSInstance,
            SparseMatPolynomial,
        )
        from spartan_parallel_tpu_torch.models.snark_single import (
            SpartanSNARK,
            SpartanSNARKGens,
        )
        from spartan_parallel_tpu_torch.utils.transcript import Transcript

        self._snark, self._transcript = SpartanSNARK, Transcript
        self.cfg, self.device = cfg, device
        self.label = cfg["transcript_label"].encode()
        n_cons, n_vars = cfg["num_cons"], cfg["num_vars"]
        t = time.perf_counter()
        mats, self.vars, self.inputs = statement(cfg, seed)
        self.setup_parts = {"statement": time.perf_counter() - t}
        nx, ny = n_cons.bit_length() - 1, (2 * n_vars).bit_length() - 1
        sp = [[SparseMatPolynomial(nx, ny, arrays=m)] for m in mats]
        self.inst = R1CSInstance(1, n_cons, [n_cons], 2 * n_vars, sp[0],
                                 sp[1], sp[2], device=device)
        self.inst.get_digest()
        self.setup_parts["instance and digest"] = time.perf_counter() - t
        nnz = max(len(m[0]) for m in mats)
        self.gens = SpartanSNARKGens(n_cons, n_vars, nnz)
        self.setup_parts["generators"] = time.perf_counter() - t
        self.comm, self.decomm = SpartanSNARK.encode(self.inst, self.gens,
                                                     device=device)
        self.setup_parts["encode"] = time.perf_counter() - t
        self.pool = 1

    def prove(self, req: dict, rec=None):
        tape = recording_tape(req["tape_seed"])
        proof = self._snark.prove(
            self.inst, self.comm, self.decomm, self.vars, self.inputs,
            self.gens, self._transcript(self.label), tape,
            device=self.device)
        return {"proof": proof, "blinds": tape.drawn}

    def verify(self, req: dict, rec):
        rec["proof"].verify(self.comm, self.inputs, self.gens,
                            self._transcript(self.label), device=self.device)
        return rec

    def free(self) -> None:
        self.inst = self.comm = self.decomm = self.gens = None
        self.vars = self.inputs = None

    @staticmethod
    def plain(rec) -> dict:
        """What the reference reads of a proof, as bytes and ints."""
        p = rec["proof"]
        sat = p.r1cs_sat_proof
        return {
            "comm_vars": [bytes(c) for c in p.comm_vars.C],
            "claims": [bytes(c) for c in sat.claims_phase2],
            "blinds": {k: int(v) for k, v in rec["blinds"].items()},
            "sections": [bytes(c[0]) for c in sat.comm_vars_at_ry_list],
            "evals": [int(e) for e in p.inst_evals],
            "rx": [int(x) for x in p.r[2]],
            "rwy": [int(x) for x in p.r[3]],
        }

    def check(self, plains: list, seed: int) -> dict:
        """Counts of disagreements over the sampled proofs, against the
        statement built again from the seed."""
        mats, vars_, inputs = statement(self.cfg, seed)
        st = checks.SnarkStatement(mats, vars_, inputs, len(vars_))
        rng = random.Random(workload.sub_seed(seed, "rlc"))
        tot = {"commit": 0, "claims": 0, "sections": 0, "evals": 0}
        cache: dict = {}
        for pf in plains:
            for k, v in checks.check_snark_proof(st, pf, rng, cache).items():
                tot[k] += v
        return tot
