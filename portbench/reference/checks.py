"""The plain reference's judgements of the port's proofs.

Each function takes the statement as the benchmark made it (matrices,
witness, public sizes) and what a proof says (compressed points, scalars,
the point it was opened at), all as plain bytes and ints, and returns
counts of disagreements: 0 is correct. Nothing here imports the port; the
generators, evaluations and commitments are worked out again from the
statement with reference/ristretto.py.

Witness commitments are Hyrax row commitments with zero blinds: a
polynomial of 2^ell evaluations is 2^(ell // 2) rows of 2^(ell - ell // 2)
entries, row i committed as sum_j Z[i cols + j] G_j. They are judged all at
once by a random linear combination, drawn from the benchmark's seed:
sum_i rho_i C_i must equal sum_j (sum_i rho_i Z_i,j) G_j, which fails with
probability about 2^-128 where any row is wrong.
"""

from __future__ import annotations

import random

from . import ristretto as R


def _log2(n: int) -> int:
    assert n >= 1 and n & (n - 1) == 0, n
    return n.bit_length() - 1


def commit_gens(label: bytes, num_vars: int):
    """(G, g1, h) of a PolyCommitmentGens over num_vars variables: the
    2^(num_vars - num_vars // 2) row generators, the single generator
    after them, and the blinding point."""
    right = num_vars - num_vars // 2
    n = 1 << right
    pts = R.generators(label, n + 1)
    return pts[:n], pts[n], pts[n + 1]


def rows_commitment_mismatch(polys, comms, G, rng: random.Random) -> int:
    """polys: flat lists of ints (2^ell entries each); comms: for each, its
    row commitments as 32-byte encodings. 1 when the random combination of
    every row disagrees (or a count or an encoding is wrong), else 0."""
    width = max(1 << (_log2(len(z)) - _log2(len(z)) // 2) for z in polys)
    acc = [0] * width
    row_pts, rhos = [], []
    for z, comm in zip(polys, comms):
        ell = _log2(len(z))
        rows, cols = 1 << (ell // 2), 1 << (ell - ell // 2)
        if len(comm) != rows:
            return 1
        for i in range(rows):
            rho = rng.getrandbits(128)
            try:
                row_pts.append(R.decode(bytes(comm[i])))
            except ValueError:
                return 1
            rhos.append(rho)
            base = i * cols
            for j in range(cols):
                v = z[base + j]
                if v:
                    acc[j] += rho * v
    lhs = R.msm(row_pts, rhos)
    rhs = R.msm(G[:width], [a % R.L for a in acc])
    return int(R.encode(lhs) != R.encode(rhs))


# --------------------------------------------------------------------------
# Single-instance Spartan SNARK
# --------------------------------------------------------------------------
class SnarkStatement:
    """The R1CS (A, B, C as (rows, cols, vals)), z = [vars | 1, inputs,
    0...] with num_vars entries a section, and the SAT proof's
    generators (label b"gens_r1cs_sat"), worked out once a run."""

    def __init__(self, mats, vars_, inputs, num_vars: int):
        self.num_vars = num_vars
        self.vars = [int(v) % R.L for v in vars_]
        io = [0] * num_vars
        io[0] = 1
        for k, x in enumerate(inputs):
            io[1 + k] = int(x) % R.L
        self.io = io
        z = self.vars + io
        self.mats = []
        self.mz = []
        for rows, cols, vals in mats:
            rows = [int(r) for r in rows]
            cols = [int(c) for c in cols]
            vals = [int(v) % R.L for v in vals]
            self.mats.append((rows, cols, vals))
            out = {}
            for r, c, v in zip(rows, cols, vals):
                out[r] = out.get(r, 0) + v * z[c]
            self.mz.append(out)
        self.G, self.g1, self.h = commit_gens(b"gens_r1cs_sat",
                                              _log2(num_vars))

    def scalar_commit(self, v: int, blind: int) -> bytes:
        return R.encode(R.add(R.mul(self.g1, v), R.mul(self.h, blind)))


def check_snark_proof(st: SnarkStatement, pf: dict, rng: random.Random,
                      vars_checked: dict) -> dict:
    """Disagreements of one proof with the statement. pf holds comm_vars
    (row encodings), claims (the encodings of Az, Bz, Cz and Az Bz at rx),
    blinds (their blinds from the benchmark's random tape), sections
    (the encodings of each witness section's value at ry), evals (A, B, C
    at (rx, ry)) and r (rx, and rw + ry as the proof gives them).
    vars_checked caches the commitment verdict by its bytes."""
    out = {}
    key = b"".join(bytes(c) for c in pf["comm_vars"])
    if key not in vars_checked:
        vars_checked[key] = rows_commitment_mismatch(
            [st.vars], [pf["comm_vars"]], st.G, rng)
    out["commit"] = vars_checked[key]

    rx = [int(x) % R.L for x in pf["rx"]]
    rwy = [int(x) % R.L for x in pf["rwy"]]
    nx = _log2(st.num_vars)
    if len(rwy) != nx + 1:
        return dict(out, claims=1, sections=1, evals=1)
    rw, ry = rwy[0], rwy[1:]
    ex = R.eq_table(rx)
    claims = []
    for mz in st.mz:
        claims.append(sum(ex[r] * v for r, v in mz.items()) % R.L)
    az, bz, cz = claims
    want = [st.scalar_commit(az, pf["blinds"]["Az_blind"]),
            st.scalar_commit(bz, pf["blinds"]["Bz_blind"]),
            st.scalar_commit(cz, pf["blinds"]["Cz_blind"]),
            st.scalar_commit(az * bz % R.L, pf["blinds"]["prod_Az_Bz_blind"])]
    out["claims"] = sum(bytes(a) != b for a, b in zip(pf["claims"], want))

    ey = R.eq_table(ry)
    sec = [sum(v * e for v, e in zip(st.vars, ey) if v) % R.L,
           sum(v * e for v, e in zip(st.io, ey) if v) % R.L]
    got = [bytes(s) for s in pf["sections"]]
    out["sections"] = sum(g != st.scalar_commit(v, 0)
                          for g, v in zip(got, sec)) + abs(len(got) - 2)

    half = st.num_vars
    ef = [(1 - rw) * e % R.L for e in ey] + [rw * e % R.L for e in ey]
    evals = [sum(v * ex[r] * ef[c] for r, c, v in zip(*m)) % R.L
             for m in st.mats]
    assert len(ef) == 2 * half
    out["evals"] = sum(int(a) % R.L != b for a, b in zip(pf["evals"], evals))
    return out
