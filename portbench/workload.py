"""The benchmark's inputs: one general generator for every traffic mix,
and the statement builder, in plain Python and NumPy.

Every number comes from the run's --seed through `sub_seed`, so the same
seed gives the same inputs in every checkout and on both sides of a
comparison. The statement is upstream Spartan's synthetic R1CS
(`produce_synthetic_r1cs`, r1csinstance.rs), written out here with its
randomness taken from the benchmark's seed; the port receives only what
it produces.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .reference.ristretto import L


def sub_seed(seed: int, *purpose) -> int:
    """A 64-bit seed for one purpose, from a seed of any size or sign."""
    h = hashlib.sha256(repr((int(seed),) + purpose).encode()).digest()
    return int.from_bytes(h[:8], "little")


def rng_for(seed: int, *purpose) -> np.random.Generator:
    return np.random.default_rng(sub_seed(seed, *purpose))


def random_scalars(rng: np.random.Generator, n: int) -> list:
    """n uniform scalars mod L (40 random bytes each, reduced)."""
    raw = rng.bytes(40 * n)
    return [int.from_bytes(raw[40 * i:40 * i + 40], "little") % L
            for i in range(n)]


# --------------------------------------------------------------------------
# Requests
# --------------------------------------------------------------------------
def _tape(seed: int, *purpose) -> bytes:
    return hashlib.sha256(repr((int(seed),) + purpose).encode()).digest()


def requests(traffic: dict, seed: int, pool: int):
    """The request stream of a closed-loop mix: request k runs the mix's
    `steps` on input order[k % len(order)] of the pool (a permutation of
    the pool drawn from the seed, each input used in turn) under a random
    tape seeded from (seed, k). Endless; the window takes as many as it
    finishes."""
    if traffic.get("loop") != "closed":
        raise ValueError(f"unknown loop {traffic.get('loop')!r}")
    if not traffic.get("steps"):
        raise ValueError("a mix names its steps")
    order = [int(i) for i in rng_for(seed, "order").permutation(pool)]
    k = 0
    while True:
        yield {"index": k, "input": order[k % pool],
               "tape_seed": _tape(seed, "tape", k)}
        k += 1


def prepared(seed: int, pool: int) -> list:
    """One request a pool input for the mix's `prepare` steps, which run in
    set-up (a proof made there, say, for a mix that only verifies)."""
    return [{"index": -2 - i, "input": i,
             "tape_seed": _tape(seed, "prepare", i)} for i in range(pool)]


# --------------------------------------------------------------------------
# Upstream Spartan's synthetic R1CS (r1csinstance.rs produce_synthetic_r1cs)
# --------------------------------------------------------------------------
def synthetic_r1cs(num_cons: int, num_vars: int, num_inputs: int,
                   rng: np.random.Generator):
    """Upstream's satisfiable instance and its witness. z = [vars | 1,
    inputs] is uniform (its constant term 1); row i has A[i, i] = 1,
    B[i, i + 2] = 1 and C[i, i + 3] = z_i z_(i+2) / z_(i+3), columns mod
    |z| (C[i, num_vars] = z_i z_(i+2) where z_(i+3) is 0). Columns are
    [vars | 1, inputs, 0...], num_vars each. Returns ((rows, cols, vals)
    of A, B and C, with int64 rows and cols and vals as a list of ints or
    of ones), vars, inputs."""
    size_z = num_vars + num_inputs + 1
    z = random_scalars(rng, size_z)
    z[num_vars] = 1
    i = np.arange(num_cons, dtype=np.int64)
    a_idx, b_idx, c_idx = i % size_z, (i + 2) % size_z, (i + 3) % size_z
    ab = [z[a] * z[b] % L for a, b in zip(a_idx.tolist(), b_idx.tolist())]
    cz = [z[c] for c in c_idx.tolist()]
    inv = _batch_inverse(cz)
    c_cols = np.where(np.array([c == 0 for c in cz]), num_vars, c_idx)
    c_vals = [v if c == 0 else v * w % L for v, c, w in zip(ab, cz, inv)]
    ones = np.ones(num_cons, dtype=np.int64)
    mats = ((i, a_idx, ones), (i, b_idx, ones), (i, c_cols, c_vals))
    return mats, z[:num_vars], z[num_vars + 1:]


def _batch_inverse(xs: list) -> list:
    """Inverses mod L of xs (0 stays 0), by one inversion and three
    products an entry."""
    pre, acc = [0] * len(xs), 1
    for k, x in enumerate(xs):
        pre[k] = acc
        if x:
            acc = acc * x % L
    inv = pow(acc, -1, L)
    out = [0] * len(xs)
    for k in range(len(xs) - 1, -1, -1):
        if xs[k]:
            out[k] = inv * pre[k] % L
            inv = inv * xs[k] % L
    return out
