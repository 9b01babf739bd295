"""Hand-built example programs playing the circ_blocks frontend's role
(reference: examples/interface.rs + the zok fixtures), as the JAX
package's examples.py builds them, value for value.

The 2-block "counter" zkVM trace exercises the full 9-stage SNARK
pipeline (blocks, consistency, permutation, shift, IO proofs);
build_synthetic_zkvm gives the find_min shape (9 blocks of 8,192
constraints). The set-up, prove and verify entry points take `device`:
the card unless the caller names the CPU.
"""

from __future__ import annotations

from .core.consts import L
from .models.dense_mlpoly import next_pow2
from .models.instance import (
    gen_block_inst,
    gen_pairwise_check_inst,
    gen_perm_root_inst,
)
from .models.r1csproof import R1CSGens
from .models.snark import SNARK, SNARKGens
from .utils.random_tape import RandomTape
from .utils.transcript import Transcript

NIU = 3
NUM_VARS = 8
NUM_IOS = 8
MAX_TS_WIDTH = 6
TS_BITS = 8


def build_counter_program(s0: int = 3):
    """Counter program: block 0 does s += 1, block 1 does s += 2;
    executed 0 -> 1 -> 0 -> 1 -> exit. Returns (args, prove_args)."""
    m1 = L - 1
    block0_args = [
        ([(5, 1), (3, m1), (0, m1)], [(0, 1)], []),
        ([(4, 1), (0, m1)], [(0, 1)], []),
    ]
    block1_args = [
        ([(5, 1), (3, m1), (0, L - 2)], [(0, 1)], []),
    ]
    args = [block0_args, block1_args]

    s = s0
    exec_rows, io_per_step = [], []
    blocks = [0, 1, 0, 1]
    for q, b in enumerate(blocks):
        s_next = s + (1 if b == 0 else 2)
        next_block = blocks[q + 1] if q + 1 < len(blocks) else 2
        row = [1, 0, b, s % L, next_block, s_next % L, 0, 0]
        exec_rows.append(row)
        io_per_step.append((b, row))
        s = s_next
    final_s = s % L

    block_vars_mat = [[], []]
    for b, row in io_per_step:
        block_vars_mat[b].append(list(row))

    prove_args = dict(
        input_block_num=0, output_block_num=2,
        input_liveness=[False, False, True],
        func_input_width=1, input_offset=1, output_offset=2,
        input_=[0, 0, s0], output=final_s, output_exec_num=3,
        num_vars=NUM_VARS, num_ios=NUM_IOS,
        max_block_num_phy_ops=0, block_num_phy_ops=[0, 0],
        max_block_num_vir_ops=0, block_num_vir_ops=[0, 0],
        mem_addr_ts_bits_size=TS_BITS, num_inputs_unpadded=NIU,
        block_num_vars=[NUM_VARS, NUM_VARS],
        block_num_instances_bound=2, block_max_num_proofs=2,
        block_num_proofs=[2, 2], consis_num_proofs=4,
        total_num_init_phy_mem_accesses=0,
        total_num_init_vir_mem_accesses=0,
        total_num_phy_mem_accesses=0, total_num_vir_mem_accesses=0,
        block_vars_mat=block_vars_mat, exec_inputs_list=exec_rows,
        init_phy_mems_list=[], init_vir_mems_list=[],
        addr_phy_mems_list=[], addr_vir_mems_list=[],
        addr_ts_bits_list=[], input_stack=[], input_mem=[],
    )
    return args, prove_args


def build_synthetic_zkvm(num_blocks: int = 9, block_cons: int = 8192,
                         num_execs=(64, 16, 16, 16, 4, 4, 4, 2, 2),
                         s0: int = 3):
    """find_min-shaped synthetic zkVM trace (BASELINE §B): `num_blocks`
    block circuits of ~`block_cons` constraints each, executed with a
    skewed per-block count — the reference's recorded find_min run is
    9 blocks x 8192 constraints (runtime_comparison/find_min.txt:62-64).

    Block b computes s += b+1 and an internal squaring chain
    w_0 = s^2, w_{i+1} = w_i^2 that pads the circuit to `block_cons`
    app constraints; the trace visits block 0 num_execs[0] times, then
    block 1, ... (transitions are unconstrained except the consis check
    o[k] == i[k+1], which the accumulating s satisfies). Returns
    (args, prove_args) exactly like build_counter_program."""
    assert num_blocks == len(num_execs)
    m1 = L - 1
    chain_len = max(0, block_cons - 16)
    num_vars = next_pow2(max(NUM_VARS, 8 + chain_len + 1))

    args = []
    for b in range(num_blocks):
        blk = [
            # (s_next - s - (b+1)) * valid == 0
            ([(5, 1), (3, m1), (0, (-(b + 1)) % L)], [(0, 1)], []),
        ]
        if chain_len > 0:
            blk.append(([(3, 1)], [(3, 1)], [(8, 1)]))  # w_0 = s * s
            for i in range(1, chain_len):
                blk.append(([(7 + i, 1)], [(7 + i, 1)], [(8 + i, 1)]))
        args.append(blk)

    # trace: block 0 x num_execs[0], block 1 x num_execs[1], ...
    blocks = [b for b in range(num_blocks) for _ in range(num_execs[b])]
    s = s0 % L
    exec_rows = []
    block_vars_mat = [[] for _ in range(num_blocks)]
    for q, b in enumerate(blocks):
        s_next = (s + b + 1) % L
        next_block = blocks[q + 1] if q + 1 < len(blocks) else num_blocks
        row = [1, 0, b, s, next_block, s_next, 0, 0]
        chain = []
        if chain_len > 0:
            w = s * s % L
            chain.append(w)
            for _ in range(chain_len - 1):
                w = w * w % L
                chain.append(w)
        block_vars_mat[b].append(row + chain)
        exec_rows.append(row)
        s = s_next

    total = len(blocks)
    prove_args = dict(
        input_block_num=0, output_block_num=num_blocks,
        input_liveness=[False, False, True],
        func_input_width=1, input_offset=1, output_offset=2,
        input_=[0, 0, s0 % L], output=s, output_exec_num=total - 1,
        num_vars=num_vars, num_ios=NUM_IOS,
        max_block_num_phy_ops=0, block_num_phy_ops=[0] * num_blocks,
        max_block_num_vir_ops=0, block_num_vir_ops=[0] * num_blocks,
        mem_addr_ts_bits_size=TS_BITS, num_inputs_unpadded=NIU,
        block_num_vars=[num_vars] * num_blocks,
        block_num_instances_bound=num_blocks,
        block_max_num_proofs=max(num_execs),
        block_num_proofs=list(num_execs), consis_num_proofs=total,
        total_num_init_phy_mem_accesses=0,
        total_num_init_vir_mem_accesses=0,
        total_num_phy_mem_accesses=0, total_num_vir_mem_accesses=0,
        block_vars_mat=block_vars_mat, exec_inputs_list=exec_rows,
        init_phy_mems_list=[], init_vir_mems_list=[],
        addr_phy_mems_list=[], addr_vir_mems_list=[],
        addr_ts_bits_list=[], input_stack=[], input_mem=[],
    )
    return args, prove_args


def _encode_all(ctx, device):
    """The circuit commitments of a set-up (interface.rs:560-576), added
    to ctx in place."""
    (ctx["block_comm_map"], ctx["block_comm_list"],
     ctx["block_decomm_list"]) = SNARK.multi_encode(
        ctx["block_inst"], ctx["block_gens"], device)
    ctx["pairwise_comm"], ctx["pairwise_decomm"] = SNARK.encode(
        ctx["pairwise_inst"], ctx["pairwise_gens"], device)
    ctx["perm_root_comm"], ctx["perm_root_decomm"] = SNARK.encode(
        ctx["perm_root_inst"], ctx["perm_root_gens"], device)
    return ctx


def setup_program_instances(args, pa, device=None):
    """Generalized setup_counter_instances: builds the three instance
    sets, gens, and circuit commitments for any (args, prove_args) pair
    (plays interface.rs:492-576's role)."""
    nb = pa["block_num_instances_bound"]
    nv = pa["num_vars"]
    niu = pa["num_inputs_unpadded"]
    nios = pa["num_ios"]
    (block_num_vars_total, block_num_cons, block_nnz,
     block_inst) = gen_block_inst(nb, nv, args, niu,
                                  pa["block_num_phy_ops"],
                                  pa["block_num_vir_ops"], device=device)
    (pw_vars, pw_cons, pw_nnz, pairwise_inst) = gen_pairwise_check_inst(
        MAX_TS_WIDTH, pa["mem_addr_ts_bits_size"], device)
    (pr_cons, pr_nnz, perm_root_inst) = gen_perm_root_inst(niu, nios,
                                                           device)

    block_gens = SNARKGens(block_num_cons, block_num_vars_total, nb,
                           block_nnz)
    pairwise_gens = SNARKGens(pw_cons, 4 * pw_vars, 3, pw_nnz)
    perm_root_gens = SNARKGens(pr_cons, 8 * nios, 1, pr_nnz)
    consis = pa["consis_num_proofs"]
    vars_gens_size = 2 * next_pow2(max(
        pa["block_max_num_proofs"] * nv, consis * nios, consis * 8, 8))
    vars_gens = R1CSGens(b"gens_r1cs_sat", block_num_cons, vars_gens_size)
    return _encode_all(dict(
        block_inst=block_inst, block_num_cons=block_num_cons,
        pairwise_inst=pairwise_inst, pw_cons=pw_cons,
        perm_root_inst=perm_root_inst, pr_cons=pr_cons,
        block_gens=block_gens, pairwise_gens=pairwise_gens,
        perm_root_gens=perm_root_gens, vars_gens=vars_gens), device)


def setup_counter_instances(args, device=None):
    (block_num_vars_total, block_num_cons, block_nnz,
     block_inst) = gen_block_inst(2, NUM_VARS, args, NIU, [0, 0], [0, 0],
                                  device=device)
    (pw_vars, pw_cons, pw_nnz, pairwise_inst) = gen_pairwise_check_inst(
        MAX_TS_WIDTH, TS_BITS, device)
    (pr_cons, pr_nnz, perm_root_inst) = gen_perm_root_inst(NIU, NUM_IOS,
                                                           device)

    block_gens = SNARKGens(block_num_cons, block_num_vars_total, 2,
                           block_nnz)
    pairwise_gens = SNARKGens(pw_cons, 4 * pw_vars, 3, pw_nnz)
    perm_root_gens = SNARKGens(pr_cons, 8 * NUM_IOS, 1, pr_nnz)
    vars_gens = R1CSGens(b"gens_r1cs_sat", block_num_cons, 64)
    return _encode_all(dict(
        block_inst=block_inst, block_num_cons=block_num_cons,
        pairwise_inst=pairwise_inst, pw_cons=pw_cons,
        perm_root_inst=perm_root_inst, pr_cons=pr_cons,
        block_gens=block_gens, pairwise_gens=pairwise_gens,
        perm_root_gens=perm_root_gens, vars_gens=vars_gens), device)


def prove_counter(pa, ctx, label: bytes = b"snark_example",
                  tape_seed: bytes | None = None, device=None):
    tp = Transcript(label)
    tape = RandomTape(b"proof", seed=tape_seed) if tape_seed else None
    return SNARK.prove(
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
        ctx["perm_root_gens"], ctx["vars_gens"], tp, random_tape=tape,
        device=device)


# prove/verify only consume (pa, ctx), so the counter entry points work
# unchanged for any program built by build_synthetic_zkvm.
def prove_program(pa, ctx, label: bytes = b"snark_example",
                  tape_seed: bytes | None = None, device=None):
    return prove_counter(pa, ctx, label=label, tape_seed=tape_seed,
                         device=device)


def verify_counter(proof, pa, ctx, label: bytes = b"snark_example",
                   device=None):
    tv = Transcript(label)
    proof.verify(
        pa["input_block_num"], pa["output_block_num"],
        pa["input_liveness"], pa["func_input_width"], pa["input_offset"],
        pa["output_offset"], pa["input_"], pa["input_stack"],
        pa["input_mem"], pa["output"],
        pa["output_exec_num"], pa["num_vars"], pa["num_ios"],
        pa["max_block_num_phy_ops"], pa["block_num_phy_ops"],
        pa["max_block_num_vir_ops"], pa["block_num_vir_ops"],
        pa["mem_addr_ts_bits_size"], pa["num_inputs_unpadded"],
        pa["block_num_vars"], pa["block_num_instances_bound"],
        pa["block_max_num_proofs"], pa["block_num_proofs"],
        ctx["block_num_cons"], ctx["block_comm_map"],
        ctx["block_comm_list"], ctx["block_gens"],
        pa["consis_num_proofs"], pa["total_num_init_phy_mem_accesses"],
        pa["total_num_init_vir_mem_accesses"],
        pa["total_num_phy_mem_accesses"],
        pa["total_num_vir_mem_accesses"], ctx["pw_cons"],
        ctx["pairwise_comm"], ctx["pairwise_gens"], ctx["pr_cons"],
        ctx["perm_root_comm"], ctx["perm_root_gens"], ctx["vars_gens"], tv,
        device)


def verify_program(proof, pa, ctx, label: bytes = b"snark_example",
                   device=None):
    return verify_counter(proof, pa, ctx, label=label, device=device)
