"""Circuit generation frontend: the three R1CS instance sets of the
9-stage SNARK.

Reference: src/instance.rs (Instance::new :19, sort :149, gen_constr :156,
gen_block_inst :253, gen_pairwise_check_inst :740, gen_perm_root_inst
:1088), as the JAX package's models/instance.py builds them, entry for
entry. Construction is host work: each matrix grows as three Python lists
(rows, columns, values mod l) and becomes one
SparseMatPolynomial(arrays=...), checked and padded with numpy. The
instance digest is the reference's zlib(bincode(R1CSInstance))
(R1CSInstance.get_digest).
"""

from __future__ import annotations

import numpy as np

from ..core.consts import L
from ..utils.errors import R1CSError
from .dense_mlpoly import log2, next_pow2
from .r1csinstance import R1CSInstance, SparseMatPolynomial


class _Entries:
    """One matrix's entries in the order they are generated."""

    __slots__ = ("rows", "cols", "vals")

    def __init__(self):
        self.rows, self.cols, self.vals = [], [], []

    def __len__(self) -> int:
        return len(self.rows)

    def append(self, entry) -> None:
        row, col, val = entry
        self.rows.append(row)
        self.cols.append(col)
        self.vals.append(int(val) % L)

    @staticmethod
    def of(entries) -> "_Entries":
        """A list of (row, col, value) triples, or _Entries as they are."""
        if isinstance(entries, _Entries):
            return entries
        out = _Entries()
        for e in entries:
            out.append(e)
        return out


def _r1cs_sort(inst: R1CSInstance, num_instances: int, index) -> None:
    """Reorder instances (r1csinstance.rs:186-200)."""
    inst.num_instances = num_instances
    inst.num_cons = [inst.num_cons[index[i]] for i in range(num_instances)]
    inst.A_list = [inst.A_list[index[i]] for i in range(num_instances)]
    inst.B_list = [inst.B_list[index[i]] for i in range(num_instances)]
    inst.C_list = [inst.C_list[index[i]] for i in range(num_instances)]


class Instance:
    """R1CS matrices + digest (instance.rs:10-15). `device` (default: the
    card) is the R1CSInstance's."""

    __slots__ = ("inst", "digest")

    def __init__(self, num_instances, max_num_cons, num_cons, num_vars,
                 A, B, C, device=None):
        """A/B/C: per-instance lists of (row, col, int-value) triples, or
        _Entries."""
        num_vars_padded = next_pow2(num_vars)
        max_num_cons_padded = max(2, next_pow2(max_num_cons))
        num_cons_padded = [max(2, next_pow2(c)) for c in num_cons]
        nx, ny = log2(max_num_cons_padded), log2(num_vars_padded)

        def convert(b, entries):
            e = _Entries.of(entries)
            rows = np.asarray(e.rows, dtype=np.int64)
            cols = np.asarray(e.cols, dtype=np.int64)
            bad = np.flatnonzero((rows >= num_cons[b]) | (cols >= num_vars))
            if len(bad):
                i = bad[0]
                if rows[i] >= num_cons[b]:
                    raise R1CSError(f"invalid row {rows[i]} >= {num_cons[b]}")
                raise R1CSError(f"invalid col {cols[i]} >= {num_vars}")
            vals = list(e.vals)
            # pad 0/1-constraint instances with zero-value entries
            # (instance.rs:100-106)
            if num_cons[b] in (0, 1):
                extra = np.arange(len(e), num_cons_padded[b], dtype=np.int64)
                rows = np.concatenate([rows, extra])
                cols = np.concatenate([cols, np.zeros_like(extra)])
                vals += [0] * len(extra)
            return SparseMatPolynomial(nx, ny, arrays=(rows, cols, vals))

        A_list = [convert(i, A[i]) for i in range(num_instances)]
        B_list = [convert(i, B[i]) for i in range(num_instances)]
        C_list = [convert(i, C[i]) for i in range(num_instances)]
        self.inst = R1CSInstance(num_instances, max_num_cons_padded,
                                 num_cons_padded, num_vars_padded,
                                 A_list, B_list, C_list, device)
        self.digest = self.inst.get_digest()

    def sort(self, num_instances: int, index) -> None:
        """Reorder the instances. The digest is the R1CSInstance's cached
        one (a shallow copy shares it), as in the JAX package."""
        _r1cs_sort(self.inst, num_instances, index)
        self.digest = self.inst.get_digest()

    def is_sat(self, vars_mat, inputs_mat) -> bool:
        """Witness-checking oracle (instance.rs:1485-1517): Az o Bz == Cz
        with z = [vars | 1, inputs, 0...] per (instance, proof)."""
        inst = self.inst
        half = inst.num_vars // 2
        for p in range(inst.get_num_instances()):
            mats = (inst.A_list[p], inst.B_list[p], inst.C_list[p])
            for q in range(len(vars_mat[p])):
                z = [int(v) % L for v in vars_mat[p][q]]
                z += [0] * (half - len(z))
                z += [1] + [int(v) % L for v in inputs_mat[p][q]]
                z += [0] * (inst.num_vars - len(z))
                az, bz, cz = {}, {}, {}
                for m, acc in zip(mats, (az, bz, cz)):
                    for r_, c_, v_ in zip(m.rows.tolist(), m.cols.tolist(),
                                          m.vals):
                        acc[r_] = (acc.get(r_, 0) + v_ * z[c_]) % L
                for r_ in range(inst.get_num_cons()):
                    if az.get(r_, 0) * bz.get(r_, 0) % L != cz.get(r_, 0):
                        return False
        return True


def _neg(v: int) -> int:
    return (-v) % L


def gen_constr(A, B, C, i, args_A, args_B, args_C):
    """Append one constraint from (col, signed-coeff) pairs
    (instance.rs:156-190)."""
    for col, v in args_A:
        A.append((i, col, v % L))
    for col, v in args_B:
        B.append((i, col, v % L))
    for col, v in args_C:
        C.append((i, col, v % L))


def gen_block_inst(num_instances, num_vars, args, num_inputs_unpadded,
                   num_phy_ops, num_vir_ops, num_vars_per_block=None,
                   block_num_proofs=None, device=None):
    """BLOCK_CORRECTNESS + MEM_EXTRACT (instance.rs:253-738).

    args[b] is the frontend's constraint list for block b: a list of
    (A_terms, B_terms, C_terms), each a list of (col, int-value) pairs in
    block-variable space.

    Returns (block_num_vars, block_max_num_cons,
             block_num_non_zero_entries, Instance).
    """
    assert num_instances == len(args)
    block_max_num_cons = 0
    block_num_cons = []
    block_nnz = 0
    A_list, B_list, C_list = [], [], []

    io_width = 2 * num_inputs_unpadded
    V_valid = 0
    V_cnst = 0

    def V_input(i):
        return 2 + i

    def V_output(i):
        return 2 + (num_inputs_unpadded - 1) + i

    for b in range(num_instances):
        def V_PA(i):
            return io_width + 2 * i

        def V_PD(i):
            return io_width + 2 * i + 1

        def V_VA(i):
            return io_width + 2 * num_phy_ops[b] + 4 * i

        def V_VD(i):
            return io_width + 2 * num_phy_ops[b] + 4 * i + 1

        def V_VL(i):
            return io_width + 2 * num_phy_ops[b] + 4 * i + 2

        def V_VT(i):
            return io_width + 2 * num_phy_ops[b] + 4 * i + 3

        V_tau = num_vars

        def V_r(i):
            return num_vars + i

        def V_input_dot_prod(i):
            return V_input(0) if i == 0 else 2 * num_vars + 2 + i

        def V_output_dot_prod(i):
            return 2 * num_vars + 2 + (num_inputs_unpadded - 1) + i

        def V_PMR(i):
            return 2 * num_vars + 2 * num_inputs_unpadded + 2 * i

        def V_PMC(i):
            return 2 * num_vars + 2 * num_inputs_unpadded + 2 * i + 1

        def V_VMR1(i):
            return (2 * num_vars + 2 * num_inputs_unpadded +
                    2 * num_phy_ops[b] + 4 * i)

        def V_VMR2(i):
            return V_VMR1(i) + 1

        def V_VMR3(i):
            return V_VMR1(i) + 2

        def V_VMC(i):
            return V_VMR1(i) + 3

        V_v = 3 * num_vars
        V_x = 3 * num_vars + 1
        V_pi = 3 * num_vars + 2
        V_d = 3 * num_vars + 3
        V_Pp = 3 * num_vars + 4
        V_Pd = 3 * num_vars + 5
        V_Vp = 3 * num_vars + 6
        V_Vd = 3 * num_vars + 7
        V_sv = 4 * num_vars
        V_spi = 4 * num_vars + 2
        V_Psp = 4 * num_vars + 4
        V_Vsp = 4 * num_vars + 6

        arg = args[b]
        counter = len(arg)
        A, B, C = _Entries(), _Entries(), _Entries()
        nnz_A = nnz_B = nnz_C = 0
        for i, (ta, tb, tc) in enumerate(arg):
            nnz_A += len(ta)
            nnz_B += len(tb)
            nnz_C += len(tc)
            gen_constr(A, B, C, i, ta, tb, tc)

        # input permutation (instance.rs:377-453)
        for i in range(1, num_inputs_unpadded - 1):
            gen_constr(A, B, C, counter, [(V_input(i), 1)], [(V_r(i), 1)],
                       [(V_input_dot_prod(i), 1)])
            counter += 1
        for i in range(num_inputs_unpadded - 1):
            gen_constr(A, B, C, counter, [(V_output(i), 1)],
                       [(V_r(i + num_inputs_unpadded - 1), 1)],
                       [(V_output_dot_prod(i), 1)])
            counter += 1
        gen_constr(A, B, C, counter, [], [], [(V_valid, 1), (V_v, -1)])
        counter += 1
        gen_constr(A, B, C, counter,
                   [(V_tau, 1)] + [(V_input_dot_prod(i), -1)
                                   for i in range(2 * num_inputs_unpadded - 2)],
                   [(V_cnst, 1)], [(V_x, 1)])
        counter += 1
        gen_constr(A, B, C, counter, [(V_x, 1)],
                   [(V_spi, 1), (V_cnst, 1), (V_sv, -1)], [(V_d, 1)])
        counter += 1
        gen_constr(A, B, C, counter, [(V_v, 1)], [(V_d, 1)], [(V_pi, 1)])
        counter += 1
        nnz_A += 4 * num_inputs_unpadded - 2
        nnz_B += 2 * num_inputs_unpadded + 2
        nnz_C += 2 * num_inputs_unpadded + 2

        # physical memory extraction (instance.rs:456-524)
        for i in range(num_phy_ops[b]):
            gen_constr(A, B, C, counter, [(V_r(1), 1)], [(V_PD(i), 1)],
                       [(V_PMR(i), 1)])
            counter += 1
            first = [(V_cnst, 1)] if i == 0 else [(V_PMC(i - 1), 1)]
            gen_constr(A, B, C, counter, first,
                       [(V_tau, 1), (V_PA(i), -1), (V_PMR(i), -1)],
                       [(V_PMC(i), 1)])
            counter += 1
        counter += 1
        gen_constr(A, B, C, counter,
                   [(V_cnst, 1) if num_phy_ops[b] == 0 else
                    (V_PMC(num_phy_ops[b] - 1), 1)],
                   [(V_Psp, 1), (V_cnst, 1), (V_sv, -1)], [(V_Pd, 1)])
        counter += 1
        gen_constr(A, B, C, counter, [(V_v, 1)], [(V_Pd, 1)], [(V_Pp, 1)])
        counter += 1
        nnz_A += 3 * num_phy_ops[b] + 2
        nnz_B += 7 * num_phy_ops[b] + 4
        nnz_C += 3 * num_phy_ops[b] + 2

        # virtual memory extraction (instance.rs:527-633)
        for i in range(num_vir_ops[b]):
            gen_constr(A, B, C, counter, [(V_r(1), 1)], [(V_VD(i), 1)],
                       [(V_VMR1(i), 1)])
            counter += 1
            gen_constr(A, B, C, counter, [(V_r(2), 1)], [(V_VL(i), 1)],
                       [(V_VMR2(i), 1)])
            counter += 1
            gen_constr(A, B, C, counter, [(V_r(3), 1)], [(V_VT(i), 1)],
                       [(V_VMR3(i), 1)])
            counter += 1
            first = [(V_cnst, 1)] if i == 0 else [(V_VMC(i - 1), 1)]
            gen_constr(A, B, C, counter, first,
                       [(V_tau, 1), (V_VA(i), -1), (V_VMR1(i), -1),
                        (V_VMR2(i), -1), (V_VMR3(i), -1)],
                       [(V_VMC(i), 1)])
            counter += 1
        counter += 1
        gen_constr(A, B, C, counter,
                   [(V_cnst, 1) if num_vir_ops[b] == 0 else
                    (V_VMC(num_vir_ops[b] - 1), 1)],
                   [(V_Vsp, 1), (V_cnst, 1), (V_sv, -1)], [(V_Vd, 1)])
        counter += 1
        gen_constr(A, B, C, counter, [(V_v, 1)], [(V_Vd, 1)], [(V_Vp, 1)])
        counter += 1
        nnz_A += 5 * num_vir_ops[b] + 2
        nnz_B += 13 * num_vir_ops[b] + 4
        nnz_C += 5 * num_vir_ops[b] + 2

        block_max_num_cons = max(block_max_num_cons, counter)
        block_num_cons.append(counter)
        block_nnz = max(block_nnz, nnz_A, nnz_B, nnz_C)
        A_list.append(A)
        B_list.append(B)
        C_list.append(C)

    block_num_vars = 8 * num_vars
    block_inst = Instance(num_instances, block_max_num_cons, block_num_cons,
                          block_num_vars, A_list, B_list, C_list, device)
    return block_num_vars, block_max_num_cons, block_nnz, block_inst


def gen_pairwise_check_inst(max_ts_width, mem_addr_ts_bits_size,
                            device=None):
    """CONSIS_CHECK + PHY_MEM_COHERE + VIR_MEM_COHERE
    (instance.rs:740-1070).

    Returns (pairwise_check_num_vars, pairwise_check_max_num_cons,
             pairwise_check_num_non_zero_entries, Instance).
    """
    width = max(8, mem_addr_ts_bits_size)
    max_num_cons = 8 + max_ts_width
    num_cons = [2, 4, 8 + max_ts_width]
    nnz = max(13 + max_ts_width, 5 + 2 * max_ts_width)

    A_list, B_list, C_list = [], [], []

    # CONSIS_CHECK: o[k] == i[k+1] when valid (instance.rs:770-806)
    A, B, C = _Entries(), _Entries(), _Entries()
    V_i, V_o = 4, 5
    gen_constr(A, B, C, 0, [(V_o, 1), (width + V_i, -1)],
               [(width + V_i, 1)], [])
    A_list.append(A)
    B_list.append(B)
    C_list.append(C)

    # PHY_MEM_COHERE (instance.rs:811-884)
    A, B, C = _Entries(), _Entries(), _Entries()
    V_valid = V_cnst = 0
    V_D, V_addr, V_val = 1, 2, 3
    n = 0
    gen_constr(A, B, C, n, [(V_valid, 1), (V_cnst, -1)],
               [(width + V_valid, 1)], [])
    n += 1
    gen_constr(A, B, C, n, [(width + V_valid, 1)],
               [(V_cnst, 1), (width + V_addr, -1), (V_addr, 1)],
               [(V_D, 1)])
    n += 1
    gen_constr(A, B, C, n, [(V_D, 1)],
               [(width + V_addr, 1), (V_addr, -1)], [])
    n += 1
    gen_constr(A, B, C, n, [(V_D, 1)],
               [(width + V_val, 1), (V_val, -1)], [])
    n += 1
    A_list.append(A)
    B_list.append(B)
    C_list.append(C)

    # VIR_MEM_COHERE (instance.rs:889-1034)
    A, B, C = _Entries(), _Entries(), _Entries()
    V_valid = V_cnst = 0
    V_D1, V_addr, V_data, V_ls, V_ts = 1, 2, 3, 4, 5
    V_D2 = 2 * width
    V_EQ = 2 * width + 1

    def V_B(i):
        return 2 * width + 2 + i

    n = 0
    gen_constr(A, B, C, n, [(V_valid, 1), (V_cnst, -1)],
               [(width + V_valid, 1)], [])
    n += 1
    gen_constr(A, B, C, n, [(width + V_valid, 1)],
               [(V_cnst, 1), (width + V_addr, -1), (V_addr, 1)],
               [(V_D1, 1)])
    n += 1
    gen_constr(A, B, C, n, [(V_D1, 1)],
               [(width + V_addr, 1), (V_addr, -1)], [])
    n += 1
    gen_constr(A, B, C, n, [(V_EQ, 1)], [(V_EQ, 1)], [(V_EQ, 1)])
    n += 1
    for i in range(max_ts_width):
        gen_constr(A, B, C, n, [(V_B(i), 1)], [(V_B(i), 1)], [(V_B(i), 1)])
        n += 1
    gen_constr(A, B, C, n, [(V_D1, 1)],
               [(width + V_ts, 1), (V_ts, -1)],
               [(V_EQ, 1)] + [(V_B(i), 1 << i) for i in range(max_ts_width)])
    n += 1
    gen_constr(A, B, C, n, [(V_D1, 1)], [(width + V_ls, 1)], [(V_D2, 1)])
    n += 1
    gen_constr(A, B, C, n, [(V_D2, 1)],
               [(width + V_data, 1), (V_data, -1)], [])
    n += 1
    gen_constr(A, B, C, n, [(V_cnst, 1), (V_D1, -1)],
               [(width + V_ls, 1)], [])
    n += 1
    A_list.append(A)
    B_list.append(B)
    C_list.append(C)

    inst = Instance(3, max_num_cons, num_cons, 4 * width,
                    A_list, B_list, C_list, device)
    return width, max_num_cons, nnz, inst


def gen_perm_root_inst(num_inputs_unpadded, num_vars, device=None):
    """PERM_ROOT (instance.rs:1088-1330).

    Returns (perm_root_num_cons, perm_root_num_non_zero_entries, Instance).
    """
    num_cons = 2 * num_inputs_unpadded + 4
    nnz = 4 * num_inputs_unpadded + 5

    A, B, C = _Entries(), _Entries(), _Entries()
    V_tau = 0

    def V_r(i):
        return i

    V_valid = num_vars
    V_cnst = V_valid

    def V_input(i):
        return num_vars + 2 + i

    def V_output(i):
        return num_vars + 2 + (num_inputs_unpadded - 1) + i

    V_ZO = 2 * num_vars + 2

    def V_input_dot_prod(i):
        return V_input(0) if i == 0 else 2 * num_vars + 2 + i

    def V_output_dot_prod(i):
        return 2 * num_vars + 2 + (num_inputs_unpadded - 1) + i

    V_v = 3 * num_vars
    V_x = 3 * num_vars + 1
    V_pi = 3 * num_vars + 2
    V_d = 3 * num_vars + 3
    V_I = 3 * num_vars + 4
    V_O = 3 * num_vars + 5
    V_sv = 4 * num_vars
    V_spi = 4 * num_vars + 2

    n = 0
    for i in range(1, num_inputs_unpadded - 1):
        gen_constr(A, B, C, n, [(V_input(i), 1)], [(V_r(i), 1)],
                   [(V_input_dot_prod(i), 1)])
        n += 1
    for i in range(num_inputs_unpadded - 1):
        gen_constr(A, B, C, n, [(V_output(i), 1)],
                   [(V_r(i + num_inputs_unpadded - 1), 1)],
                   [(V_output_dot_prod(i), 1)])
        n += 1
    gen_constr(A, B, C, n, [(V_ZO, 1)],
               [(V_r(num_inputs_unpadded - 1), 1)],
               [(V_output_dot_prod(i), 1)
                for i in range(num_inputs_unpadded - 1)])
    n += 1
    gen_constr(A, B, C, n, [(V_valid, 1)],
               [(V_cnst, 1)] + [(V_input_dot_prod(i), 1)
                                for i in range(num_inputs_unpadded - 1)],
               [(V_I, 1)])
    n += 1
    gen_constr(A, B, C, n, [(V_valid, 1)], [(V_valid, 1), (V_ZO, 1)],
               [(V_O, 1)])
    n += 1
    gen_constr(A, B, C, n, [], [], [(V_valid, 1), (V_v, -1)])
    n += 1
    gen_constr(A, B, C, n,
               [(V_tau, 1)] + [(V_input_dot_prod(i), -1)
                               for i in range(2 * num_inputs_unpadded - 2)],
               [(num_vars, 1)], [(V_x, 1)])
    n += 1
    gen_constr(A, B, C, n, [(V_x, 1)],
               [(V_spi, 1), (V_cnst, 1), (V_sv, -1)], [(V_d, 1)])
    n += 1
    gen_constr(A, B, C, n, [(V_v, 1)], [(V_d, 1)], [(V_pi, 1)])
    n += 1

    inst = Instance(1, num_cons, [num_cons], 8 * num_vars, [A], [B], [C],
                    device)
    return num_cons, nnz, inst
