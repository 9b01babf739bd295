"""CLI driver: consume circ_blocks frontend files and run prove+verify.

Reference: examples/interface.rs — CompileTimeKnowledge (:47-71) and
RunTimeKnowledge (:198-220) are bincode files produced by the external
circ_blocks compiler (`../zok_tests/constraints/<name>_bin.ctk`,
`../zok_tests/inputs/<name>_bin.rtk`); main() (:458-691) builds the three
instance-sets, gens, commitments, then proves and verifies. The port's
copy of the JAX package's driver.py: the same codec, byte for byte, and
entry points that take `device` (the card unless the caller names the
CPU).

    python -m spartan_parallel_tpu_torch.driver <name>

reads ../zok_tests/constraints/<name>_bin.ctk and
../zok_tests/inputs/<name>_bin.rtk and proves and verifies on the card.

The bincode decoder implements the subset of bincode 1.x's default config
used by these structs: little-endian u64 lengths/usize, raw [u8; 32]
arrays, u8 bools, and `Scalar` as its four internal u64 limbs — which in
the reference are MONTGOMERY form (ristretto255.rs:199 derives serde on
the raw limbs), so values are multiplied by R^{-1} on load.
"""

from __future__ import annotations

import struct
import sys

from .core.consts import L
from .models.instance import (
    gen_block_inst,
    gen_pairwise_check_inst,
    gen_perm_root_inst,
)
from .models.r1csproof import R1CSGens
from .models.snark import SNARK, SNARKGens
from .utils.transcript import Transcript

_R_INV = pow(1 << 256, -1, L)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def u64(self) -> int:
        v = struct.unpack_from("<Q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def u8(self) -> int:
        v = self.buf[self.pos]
        self.pos += 1
        return v

    def bytes32(self) -> bytes:
        v = self.buf[self.pos : self.pos + 32]
        self.pos += 32
        return v

    def vec(self, read_item):
        return [read_item() for _ in range(self.u64())]

    def scalar_bytes_int(self) -> int:
        """[u8;32] canonical little-endian field value."""
        return int.from_bytes(self.bytes32(), "little")

    def scalar_montgomery(self) -> int:
        """Scalar serialized as raw Montgomery limbs -> canonical int."""
        return int.from_bytes(self.bytes32(), "little") * _R_INV % L


class _Writer:
    """bincode 1.x encoder (exact inverse of _Reader): little-endian u64
    lengths, raw [u8;32], u8 bools (interface.rs:74-80, 223-229)."""

    __slots__ = ("parts",)

    def __init__(self):
        self.parts = []

    def u64(self, v: int):
        self.parts.append(struct.pack("<Q", v))

    def u8(self, v: int):
        self.parts.append(bytes([v & 0xFF]))

    def bytes32(self, b: bytes):
        assert len(b) == 32
        self.parts.append(b)

    def vec(self, items, write_item):
        self.u64(len(items))
        for it in items:
            write_item(it)

    def scalar_bytes_int(self, v: int):
        self.bytes32(int(v % L).to_bytes(32, "little"))

    def scalar_montgomery(self, v: int):
        """canonical int -> raw Montgomery limbs (ristretto255.rs:199)."""
        self.bytes32((int(v) % L * (1 << 256) % L).to_bytes(32, "little"))

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


class CompileTimeKnowledge:
    FIELDS = ("block_num_instances", "num_vars", "num_inputs_unpadded",
              "num_vars_per_block", "block_num_phy_ops",
              "block_num_vir_ops", "max_ts_width", "args",
              "input_liveness", "func_input_width", "input_offset",
              "input_block_num", "output_offset", "output_block_num")

    def __init__(self, **kw):
        for k in self.FIELDS:
            setattr(self, k, kw[k])

    @staticmethod
    def deserialize(buf: bytes) -> "CompileTimeKnowledge":
        r = _Reader(buf)

        def term():
            return (r.u64(), r.scalar_bytes_int())

        def constr():
            return (r.vec(term), r.vec(term), r.vec(term))

        return CompileTimeKnowledge(
            block_num_instances=r.u64(),
            num_vars=r.u64(),
            num_inputs_unpadded=r.u64(),
            num_vars_per_block=r.vec(r.u64),
            block_num_phy_ops=r.vec(r.u64),
            block_num_vir_ops=r.vec(r.u64),
            max_ts_width=r.u64(),
            args=r.vec(lambda: r.vec(constr)),
            input_liveness=r.vec(lambda: bool(r.u8())),
            func_input_width=r.u64(),
            input_offset=r.u64(),
            input_block_num=r.u64(),
            output_offset=r.u64(),
            output_block_num=r.u64(),
        )

    def serialize(self) -> bytes:
        w = _Writer()

        def term(t):
            w.u64(t[0])
            w.scalar_bytes_int(t[1])

        def constr(c):
            for side in c:
                w.vec(side, term)

        w.u64(self.block_num_instances)
        w.u64(self.num_vars)
        w.u64(self.num_inputs_unpadded)
        w.vec(self.num_vars_per_block, w.u64)
        w.vec(self.block_num_phy_ops, w.u64)
        w.vec(self.block_num_vir_ops, w.u64)
        w.u64(self.max_ts_width)
        w.vec(self.args, lambda blk: w.vec(blk, constr))
        w.vec(self.input_liveness, lambda b: w.u8(1 if b else 0))
        w.u64(self.func_input_width)
        w.u64(self.input_offset)
        w.u64(self.input_block_num)
        w.u64(self.output_offset)
        w.u64(self.output_block_num)
        return w.getvalue()

    @staticmethod
    def from_file(path: str) -> "CompileTimeKnowledge":
        with open(path, "rb") as f:
            return CompileTimeKnowledge.deserialize(f.read())


class RunTimeKnowledge:
    FIELDS = ("block_max_num_proofs", "block_num_proofs",
              "consis_num_proofs", "total_num_init_phy_mem_accesses",
              "total_num_init_vir_mem_accesses",
              "total_num_phy_mem_accesses", "total_num_vir_mem_accesses",
              "block_vars_matrix", "exec_inputs", "init_phy_mems_list",
              "init_vir_mems_list", "addr_phy_mems_list",
              "addr_vir_mems_list", "addr_ts_bits_list", "input",
              "input_stack", "input_mem", "output", "output_exec_num")

    def __init__(self, **kw):
        for k in self.FIELDS:
            setattr(self, k, kw[k])

    @staticmethod
    def deserialize(buf: bytes) -> "RunTimeKnowledge":
        r = _Reader(buf)

        def assignment():
            return r.vec(r.scalar_montgomery)

        return RunTimeKnowledge(
            block_max_num_proofs=r.u64(),
            block_num_proofs=r.vec(r.u64),
            consis_num_proofs=r.u64(),
            total_num_init_phy_mem_accesses=r.u64(),
            total_num_init_vir_mem_accesses=r.u64(),
            total_num_phy_mem_accesses=r.u64(),
            total_num_vir_mem_accesses=r.u64(),
            block_vars_matrix=r.vec(lambda: r.vec(assignment)),
            exec_inputs=r.vec(assignment),
            init_phy_mems_list=r.vec(assignment),
            init_vir_mems_list=r.vec(assignment),
            addr_phy_mems_list=r.vec(assignment),
            addr_vir_mems_list=r.vec(assignment),
            addr_ts_bits_list=r.vec(assignment),
            input=r.vec(r.scalar_bytes_int),
            input_stack=r.vec(r.scalar_bytes_int),
            input_mem=r.vec(r.scalar_bytes_int),
            output=r.scalar_bytes_int(),
            output_exec_num=r.u64(),
        )

    def serialize(self) -> bytes:
        w = _Writer()

        def assignment(a):
            w.vec(a, w.scalar_montgomery)

        w.u64(self.block_max_num_proofs)
        w.vec(self.block_num_proofs, w.u64)
        w.u64(self.consis_num_proofs)
        w.u64(self.total_num_init_phy_mem_accesses)
        w.u64(self.total_num_init_vir_mem_accesses)
        w.u64(self.total_num_phy_mem_accesses)
        w.u64(self.total_num_vir_mem_accesses)
        w.vec(self.block_vars_matrix, lambda blk: w.vec(blk, assignment))
        w.vec(self.exec_inputs, assignment)
        w.vec(self.init_phy_mems_list, assignment)
        w.vec(self.init_vir_mems_list, assignment)
        w.vec(self.addr_phy_mems_list, assignment)
        w.vec(self.addr_vir_mems_list, assignment)
        w.vec(self.addr_ts_bits_list, assignment)
        w.vec(self.input, w.scalar_bytes_int)
        w.vec(self.input_stack, w.scalar_bytes_int)
        w.vec(self.input_mem, w.scalar_bytes_int)
        w.scalar_bytes_int(self.output)
        w.u64(self.output_exec_num)
        return w.getvalue()

    @staticmethod
    def from_file(path: str) -> "RunTimeKnowledge":
        with open(path, "rb") as f:
            return RunTimeKnowledge.deserialize(f.read())


TOTAL_NUM_VARS_BOUND = 10_000_000


def _setup(ctk: CompileTimeKnowledge, rtk: RunTimeKnowledge,
           vars_bound: int | None = None, device=None) -> dict:
    """Instances + gens + circuit commitments (interface.rs:458-576); the
    decommitments stay on `device` for the prover."""
    num_vars = ctk.num_vars
    niu = ctk.num_inputs_unpadded
    num_ios = 1 << (2 * niu - 1).bit_length()
    mem_addr_ts_bits_size = 1 << max(0, (2 + ctk.max_ts_width - 1)
                                     .bit_length())
    assert ctk.output_block_num >= ctk.block_num_instances

    (block_num_vars_total, block_num_cons, block_nnz,
     block_inst) = gen_block_inst(
        ctk.block_num_instances, num_vars, ctk.args, niu,
        ctk.block_num_phy_ops, ctk.block_num_vir_ops, device=device)
    (pw_vars, pw_cons, pw_nnz, pairwise_inst) = gen_pairwise_check_inst(
        ctk.max_ts_width, mem_addr_ts_bits_size, device)
    (pr_cons, pr_nnz, perm_root_inst) = gen_perm_root_inst(niu, num_ios,
                                                           device)

    block_gens = SNARKGens(block_num_cons, block_num_vars_total,
                           ctk.block_num_instances, block_nnz)
    pairwise_gens = SNARKGens(pw_cons, 4 * pw_vars, 3, pw_nnz)
    perm_root_gens = SNARKGens(pr_cons, 8 * num_ios, 1, pr_nnz)
    vars_gens = R1CSGens(b"gens_r1cs_sat", block_num_cons,
                         vars_bound or TOTAL_NUM_VARS_BOUND)

    block_comm_map, block_comm_list, block_decomm_list = SNARK.multi_encode(
        block_inst, block_gens, device)
    pairwise_comm, pairwise_decomm = SNARK.encode(pairwise_inst,
                                                  pairwise_gens, device)
    perm_root_comm, perm_root_decomm = SNARK.encode(perm_root_inst,
                                                    perm_root_gens, device)
    return dict(
        num_vars=num_vars, niu=niu, num_ios=num_ios,
        mem_addr_ts_bits_size=mem_addr_ts_bits_size,
        max_bpo=max(ctk.block_num_phy_ops),
        max_bvo=max(ctk.block_num_vir_ops),
        block_num_cons=block_num_cons, block_inst=block_inst,
        pw_cons=pw_cons, pairwise_inst=pairwise_inst,
        pr_cons=pr_cons, perm_root_inst=perm_root_inst,
        block_gens=block_gens, pairwise_gens=pairwise_gens,
        perm_root_gens=perm_root_gens, vars_gens=vars_gens,
        block_comm_map=block_comm_map, block_comm_list=block_comm_list,
        block_decomm_list=block_decomm_list, pairwise_comm=pairwise_comm,
        pairwise_decomm=pairwise_decomm, perm_root_comm=perm_root_comm,
        perm_root_decomm=perm_root_decomm,
    )


def _prove(ctk: CompileTimeKnowledge, rtk: RunTimeKnowledge, s: dict,
           random_tape=None, device=None):
    """SNARK.prove from the files' knowledge and a set-up (_setup)."""
    return SNARK.prove(
        ctk.input_block_num, ctk.output_block_num, ctk.input_liveness,
        ctk.func_input_width, ctk.input_offset, ctk.output_offset,
        rtk.input, rtk.output, rtk.output_exec_num,
        s["num_vars"], s["num_ios"], s["max_bpo"], ctk.block_num_phy_ops,
        s["max_bvo"], ctk.block_num_vir_ops, s["mem_addr_ts_bits_size"],
        s["niu"], ctk.num_vars_per_block, ctk.block_num_instances,
        rtk.block_max_num_proofs, rtk.block_num_proofs, s["block_inst"],
        s["block_comm_map"], s["block_comm_list"], s["block_decomm_list"],
        s["block_gens"], rtk.consis_num_proofs,
        rtk.total_num_init_phy_mem_accesses,
        rtk.total_num_init_vir_mem_accesses,
        rtk.total_num_phy_mem_accesses, rtk.total_num_vir_mem_accesses,
        s["pairwise_inst"], s["pairwise_comm"], s["pairwise_decomm"],
        s["pairwise_gens"], rtk.block_vars_matrix, rtk.exec_inputs,
        rtk.init_phy_mems_list, rtk.init_vir_mems_list,
        rtk.addr_phy_mems_list, rtk.addr_vir_mems_list,
        rtk.addr_ts_bits_list, s["perm_root_inst"], s["perm_root_comm"],
        s["perm_root_decomm"], s["perm_root_gens"], s["vars_gens"],
        Transcript(b"snark_example"), random_tape, device)


def _verify(proof, ctk: CompileTimeKnowledge, rtk: RunTimeKnowledge,
            s: dict, device=None) -> None:
    """SNARK.verify of `proof` against the files' knowledge; raises
    ProofVerifyError when it does not hold."""
    proof.verify(
        ctk.input_block_num, ctk.output_block_num, ctk.input_liveness,
        ctk.func_input_width, ctk.input_offset, ctk.output_offset,
        rtk.input, rtk.input_stack, rtk.input_mem, rtk.output,
        rtk.output_exec_num, s["num_vars"], s["num_ios"], s["max_bpo"],
        ctk.block_num_phy_ops, s["max_bvo"], ctk.block_num_vir_ops,
        s["mem_addr_ts_bits_size"], s["niu"], ctk.num_vars_per_block,
        ctk.block_num_instances, rtk.block_max_num_proofs,
        rtk.block_num_proofs, s["block_num_cons"], s["block_comm_map"],
        s["block_comm_list"], s["block_gens"], rtk.consis_num_proofs,
        rtk.total_num_init_phy_mem_accesses,
        rtk.total_num_init_vir_mem_accesses,
        rtk.total_num_phy_mem_accesses, rtk.total_num_vir_mem_accesses,
        s["pw_cons"], s["pairwise_comm"], s["pairwise_gens"],
        s["pr_cons"], s["perm_root_comm"], s["perm_root_gens"],
        s["vars_gens"], Transcript(b"snark_example"), device)


def run_prove_only(ctk: CompileTimeKnowledge, rtk: RunTimeKnowledge,
                   vars_bound: int | None = None, device=None):
    """Prove and return the SNARK object (for serialization and
    interchange)."""
    return _prove(ctk, rtk, _setup(ctk, rtk, vars_bound, device),
                  device=device)


def run(ctk: CompileTimeKnowledge, rtk: RunTimeKnowledge,
        vars_bound: int | None = None, device=None) -> None:
    """interface.rs main() :458-691."""
    s = _setup(ctk, rtk, vars_bound, device)
    proof = _prove(ctk, rtk, s, device=device)
    _verify(proof, ctk, rtk, s, device)
    print("proof verification successful!")


def main() -> None:
    name = sys.argv[1]
    ctk = CompileTimeKnowledge.from_file(
        f"../zok_tests/constraints/{name}_bin.ctk")
    rtk = RunTimeKnowledge.from_file(f"../zok_tests/inputs/{name}_bin.rtk")
    run(ctk, rtk)


if __name__ == "__main__":
    main()
