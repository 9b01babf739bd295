"""Proof serialization: bincode 1.x layout of the NIZK structs.

Reference: serde derives on lib.rs:3908-3911 (NIZK, upstream),
r1csproof.rs:26-43 (R1CSProof), sumcheck.rs:75-79,
nizk/mod.rs:16-20,78-81,146-151,292-298,421-427, nizk/bullet.rs:16-19,
dense_mlpoly.rs:45-47,428-430, unipoly.rs:18-20, and for SPARK and the
single-instance SNARK sumcheck.rs:28-30, product_tree.rs:240-258,
sparse_mlpoly.rs (DerefsCommitment, DerefsEvalProof, HashLayerProof,
ProductLayerProof, PolyEvalNetworkProof, SparseMatPolyEvalProof,
SparseMatPolyCommitment), r1csinstance.rs (R1CSCommitment,
R1CSEvalProof), and for the 9-stage SNARK lib.rs:701-756 (SNARK),
lib.rs:189-196 (IOProofs), lib.rs:365-370 (ShiftProofs).

bincode 1.x default config: usize and Vec lengths as u64 little-endian;
fixed arrays/tuples with no length prefix; `Scalar` as its raw Montgomery
[u64;4] limbs (32 LE bytes, ristretto255.rs:199); `CompressedGroup`/
`CompressedRistretto` as raw 32 bytes.

The reference reports proof sizes after zlib compression
(`bincode::serialize(&proof)` then flate2, README.md:156 — 141,768 B at
2^20); `compressed_size` mirrors that so the Timer proof-size lines are
comparable.
"""

from __future__ import annotations

import struct
import zlib

from .core.consts import L


def _scalar_bytes(v) -> bytes:
    return (int(v) % L * (1 << 256) % L).to_bytes(32, "little")


class _W:
    __slots__ = ("parts",)

    def __init__(self):
        self.parts = []

    def u64(self, v):
        self.parts.append(struct.pack("<Q", int(v)))

    def scalar(self, v):
        self.parts.append(_scalar_bytes(v))

    def point(self, b):
        assert isinstance(b, (bytes, bytearray)) and len(b) == 32
        self.parts.append(bytes(b))

    def emit(self, spec, val):
        """spec grammar: "u64" | "scalar" | "point" | ("vec", s) |
        ("tuple", (s1, ...)) | ("arr", s, n) | a schema key string."""
        if spec == "u64":
            self.u64(val)
        elif spec == "scalar":
            self.scalar(val)
        elif spec == "point":
            self.point(val)
        elif isinstance(spec, tuple) and spec[0] == "vec":
            self.u64(len(val))
            for item in val:
                self.emit(spec[1], item)
        elif isinstance(spec, tuple) and spec[0] == "tuple":
            assert len(val) == len(spec[1])
            for s, item in zip(spec[1], val):
                self.emit(s, item)
        elif isinstance(spec, tuple) and spec[0] == "arr":
            assert len(val) == spec[2]
            for item in val:
                self.emit(spec[1], item)
        else:
            self.struct(spec, val)

    def struct(self, name, obj):
        for field, spec in SCHEMAS[name]:
            self.emit(spec, getattr(obj, field))


def _vec(s):
    return ("vec", s)


# Field order matches the Rust struct declarations cited in the module
# docstring; serde/bincode serializes fields in declaration order.
SCHEMAS = {
    "PolyCommitment": [("C", _vec("point"))],
    "CompressedUniPoly": [("coeffs_except_linear_term", _vec("scalar"))],
    "SumcheckInstanceProof": [
        ("compressed_polys", _vec("CompressedUniPoly"))],
    "KnowledgeProof": [("alpha", "point"), ("z1", "scalar"),
                       ("z2", "scalar")],
    "EqualityProof": [("alpha", "point"), ("z", "scalar")],
    "ProductProof": [("alpha", "point"), ("beta", "point"),
                     ("delta", "point"), ("z", ("arr", "scalar", 5))],
    "DotProductProof": [("delta", "point"), ("beta", "point"),
                        ("z", _vec("scalar")), ("z_delta", "scalar"),
                        ("z_beta", "scalar")],
    "BulletReductionProof": [("L_vec", _vec("point")),
                             ("R_vec", _vec("point"))],
    "DotProductProofLog": [("bullet_reduction_proof",
                            "BulletReductionProof"),
                           ("delta", "point"), ("beta", "point"),
                           ("z1", "scalar"), ("z2", "scalar")],
    "PolyEvalProof": [("proof", "DotProductProofLog")],
    "ZKSumcheckInstanceProof": [("comm_polys", _vec("point")),
                                ("comm_evals", _vec("point")),
                                ("proofs", _vec("DotProductProof"))],
    "R1CSProof": [
        ("sc_proof_phase1", "ZKSumcheckInstanceProof"),
        ("claims_phase2", ("tuple", ("point", "point", "point", "point"))),
        ("pok_claims_phase2",
         ("tuple", ("KnowledgeProof", "ProductProof"))),
        ("proof_eq_sc_phase1", "EqualityProof"),
        ("sc_proof_phase2", "ZKSumcheckInstanceProof"),
        ("comm_vars_at_ry_list", _vec(_vec("point"))),
        ("comm_vars_at_ry", "point"),
        ("proof_eval_vars_at_ry_list", _vec("PolyEvalProof")),
        ("proof_eq_sc_phase2", "EqualityProof"),
    ],
    "LayerProofBatched": [("proof", "SumcheckInstanceProof"),
                          ("claims_prod_left", _vec("scalar")),
                          ("claims_prod_right", _vec("scalar"))],
    "ProductCircuitEvalProofBatched": [
        ("proof", _vec("LayerProofBatched")),
        ("claims_dotp", ("tuple", (_vec("scalar"), _vec("scalar"),
                                   _vec("scalar"))))],
    "DerefsCommitment": [("comm_ops_val", "PolyCommitment")],
    "DerefsEvalProof": [("proof_derefs", "PolyEvalProof")],
    "HashLayerProof": [
        ("eval_row", ("tuple", (_vec("scalar"), _vec("scalar"), "scalar"))),
        ("eval_col", ("tuple", (_vec("scalar"), _vec("scalar"), "scalar"))),
        ("eval_val", _vec("scalar")),
        ("eval_derefs", ("tuple", (_vec("scalar"), _vec("scalar")))),
        ("proof_ops", "PolyEvalProof"),
        ("proof_mem", "PolyEvalProof"),
        ("proof_derefs", "DerefsEvalProof"),
    ],
    "ProductLayerProof": [
        ("eval_row", ("tuple", ("scalar", _vec("scalar"), _vec("scalar"),
                                "scalar"))),
        ("eval_col", ("tuple", ("scalar", _vec("scalar"), _vec("scalar"),
                                "scalar"))),
        ("eval_val", ("tuple", (_vec("scalar"), _vec("scalar")))),
        ("proof_mem", "ProductCircuitEvalProofBatched"),
        ("proof_ops", "ProductCircuitEvalProofBatched"),
    ],
    "PolyEvalNetworkProof": [("proof_prod_layer", "ProductLayerProof"),
                             ("proof_hash_layer", "HashLayerProof")],
    "SparseMatPolyEvalProof": [
        ("comm_derefs", "DerefsCommitment"),
        ("poly_eval_network_proof", "PolyEvalNetworkProof")],
    "R1CSEvalProof": [("proof", "SparseMatPolyEvalProof")],
    "SparseMatPolyCommitment": [
        ("batch_size", "u64"), ("num_ops", "u64"),
        ("num_mem_cells", "u64"), ("comm_comb_ops", "PolyCommitment"),
        ("comm_comb_mem", "PolyCommitment")],
    "R1CSCommitment": [("num_cons", "u64"), ("num_vars", "u64"),
                       ("comm", "SparseMatPolyCommitment")],
    "IOProofs": [("proofs", _vec("PolyEvalProof"))],
    "ShiftProofs": [("proof", "PolyEvalProof"),
                    ("C_orig_evals", _vec("point")),
                    ("C_shifted_evals", _vec("point")),
                    ("openings", _vec(_vec("point")))],
    "SNARK": [
        ("block_comm_vars_list", _vec("PolyCommitment")),
        ("exec_comm_inputs", _vec("PolyCommitment")),
        ("addr_comm_phy_mems", "PolyCommitment"),
        ("addr_comm_phy_mems_shifted", "PolyCommitment"),
        ("addr_comm_vir_mems", "PolyCommitment"),
        ("addr_comm_vir_mems_shifted", "PolyCommitment"),
        ("addr_comm_ts_bits", "PolyCommitment"),
        ("perm_exec_comm_w2_list", "PolyCommitment"),
        ("perm_exec_comm_w3_list", "PolyCommitment"),
        ("perm_exec_comm_w3_shifted", "PolyCommitment"),
        ("block_comm_w2_list", _vec("PolyCommitment")),
        ("block_comm_w3_list", _vec("PolyCommitment")),
        ("block_comm_w3_list_shifted", _vec("PolyCommitment")),
        ("init_phy_mem_comm_w2", "PolyCommitment"),
        ("init_phy_mem_comm_w3", "PolyCommitment"),
        ("init_phy_mem_comm_w3_shifted", "PolyCommitment"),
        ("init_vir_mem_comm_w2", "PolyCommitment"),
        ("init_vir_mem_comm_w3", "PolyCommitment"),
        ("init_vir_mem_comm_w3_shifted", "PolyCommitment"),
        ("phy_mem_addr_comm_w2", "PolyCommitment"),
        ("phy_mem_addr_comm_w3", "PolyCommitment"),
        ("phy_mem_addr_comm_w3_shifted", "PolyCommitment"),
        ("vir_mem_addr_comm_w2", "PolyCommitment"),
        ("vir_mem_addr_comm_w3", "PolyCommitment"),
        ("vir_mem_addr_comm_w3_shifted", "PolyCommitment"),
        ("block_r1cs_sat_proof", "R1CSProof"),
        ("block_inst_evals_bound_rp", ("arr", "scalar", 3)),
        ("block_inst_evals_list", _vec("scalar")),
        ("block_r1cs_eval_proof_list", _vec("R1CSEvalProof")),
        ("pairwise_check_r1cs_sat_proof", "R1CSProof"),
        ("pairwise_check_inst_evals_bound_rp", ("arr", "scalar", 3)),
        ("pairwise_check_inst_evals_list", _vec("scalar")),
        ("pairwise_check_r1cs_eval_proof", "R1CSEvalProof"),
        ("perm_root_r1cs_sat_proof", "R1CSProof"),
        ("perm_root_inst_evals", ("arr", "scalar", 3)),
        ("perm_root_r1cs_eval_proof", "R1CSEvalProof"),
        ("perm_poly_poly_list", _vec("scalar")),
        ("proof_eval_perm_poly_prod_list", _vec("PolyEvalProof")),
        ("shift_proof", "ShiftProofs"),
        ("io_proof", "IOProofs"),
    ],
    # NIZK: the fork's R1CSProof returns 4 challenge vectors
    # [rp, rq_rev, rx, rw++ry] instead of upstream's (rx, ry) pair
    # (lib.rs:3908-3911) — serialized as 4 Vec<Scalar> (PARITY.md D4).
    "NIZK": [("r1cs_sat_proof", "R1CSProof"),
             ("comm_vars", "PolyCommitment"),
             ("r", ("tuple", (_vec("scalar"), _vec("scalar"),
                              _vec("scalar"), _vec("scalar"))))],
    # Upstream-style single-instance SNARK (models/snark_single.py);
    # same 4-vector challenge caveat as NIZK.
    "SpartanSNARK": [("r1cs_sat_proof", "R1CSProof"),
                     ("comm_vars", "PolyCommitment"),
                     ("inst_evals", ("arr", "scalar", 3)),
                     ("r1cs_eval_proof", "R1CSEvalProof"),
                     ("r", ("tuple", (_vec("scalar"), _vec("scalar"),
                                      _vec("scalar"), _vec("scalar"))))],
}


def serialize(obj, schema: str | None = None) -> bytes:
    """bincode-layout bytes of a proof/commitment object."""
    w = _W()
    w.struct(schema or type(obj).__name__, obj)
    return b"".join(w.parts)


def compressed_size(obj, schema: str | None = None) -> int:
    """len(zlib(bincode(obj))) — the reference's reported proof size
    metric (e.g. README.md:156 `len_proof_compressed`)."""
    return len(zlib.compress(serialize(obj, schema), 6))


# --------------------------------------------------------------------------
# Deserialization (inverse reader over the same schemas)
# --------------------------------------------------------------------------
def _classes():
    """Lazy class registry (import cycle: models import nothing from
    here, we import them only when deserializing)."""
    from .models import dense_mlpoly as dm
    from .models import nizk as nz
    from .models import product_tree as pt
    from .models import r1csinstance as ri
    from .models import r1csproof as rp
    from .models import sigma as sg
    from .models import snark as sn
    from .models import snark_single as ss
    from .models import sparse_mlpoly as sp
    from .models import sumcheck as sc
    from .models import unipoly as up

    return {
        "PolyCommitment": dm.PolyCommitment,
        "PolyEvalProof": dm.PolyEvalProof,
        "CompressedUniPoly": up.CompressedUniPoly,
        "SumcheckInstanceProof": sc.SumcheckInstanceProof,
        "ZKSumcheckInstanceProof": sc.ZKSumcheckInstanceProof,
        "KnowledgeProof": sg.KnowledgeProof,
        "EqualityProof": sg.EqualityProof,
        "ProductProof": sg.ProductProof,
        "DotProductProof": sg.DotProductProof,
        "BulletReductionProof": sg.BulletReductionProof,
        "DotProductProofLog": sg.DotProductProofLog,
        "R1CSProof": rp.R1CSProof,
        "LayerProofBatched": pt.LayerProofBatched,
        "ProductCircuitEvalProofBatched": pt.ProductCircuitEvalProofBatched,
        "DerefsCommitment": sp.DerefsCommitment,
        "DerefsEvalProof": sp.DerefsEvalProof,
        "HashLayerProof": sp.HashLayerProof,
        "ProductLayerProof": sp.ProductLayerProof,
        "PolyEvalNetworkProof": sp.PolyEvalNetworkProof,
        "SparseMatPolyEvalProof": sp.SparseMatPolyEvalProof,
        "SparseMatPolyCommitment": sp.SparseMatPolyCommitment,
        "R1CSEvalProof": ri.R1CSEvalProof,
        "R1CSCommitment": ri.R1CSCommitment,
        "IOProofs": sn.IOProofs,
        "ShiftProofs": sn.ShiftProofs,
        "SNARK": sn.SNARK,
        "NIZK": nz.NIZK,
        "SpartanSNARK": ss.SpartanSNARK,
    }


class _R:
    __slots__ = ("buf", "pos", "classes")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.classes = _classes()

    def u64(self):
        v = struct.unpack_from("<Q", self.buf, self.pos)[0]
        self.pos += 8
        return v

    def scalar(self):
        from .core.field import Scalar

        raw = int.from_bytes(self.buf[self.pos : self.pos + 32], "little")
        self.pos += 32
        return Scalar(raw * pow(1 << 256, -1, L) % L)

    def point(self):
        b = self.buf[self.pos : self.pos + 32]
        self.pos += 32
        return b

    def parse(self, spec):
        if spec == "u64":
            return self.u64()
        if spec == "scalar":
            return self.scalar()
        if spec == "point":
            return self.point()
        if isinstance(spec, tuple) and spec[0] == "vec":
            return [self.parse(spec[1]) for _ in range(self.u64())]
        if isinstance(spec, tuple) and spec[0] == "tuple":
            # lists, not tuples: callers unpack positionally and NIZK
            # compares r against a freshly-built list-of-lists
            return [self.parse(s) for s in spec[1]]
        if isinstance(spec, tuple) and spec[0] == "arr":
            return [self.parse(spec[1]) for _ in range(spec[2])]
        return self.struct(spec)

    def struct(self, name):
        cls = self.classes[name]
        obj = object.__new__(cls)
        for field, spec in SCHEMAS[name]:
            setattr(obj, field, self.parse(spec))
        return obj


def deserialize(buf: bytes, schema: str):
    """Parse bincode-layout bytes back into the proof object graph."""
    r = _R(buf)
    obj = r.struct(schema)
    assert r.pos == len(buf), "trailing bytes after proof"
    return obj
