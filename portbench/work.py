"""The yardstick of the kernels' rooflines: the card's peaks, and the least
work each call needs, counted from its shapes whatever implements it.

A launch's least time is the larger of its bytes over the HBM bandwidth
and its 32-bit multiplies over the card's int32 multiply rate. Bytes count
each input once at its least size (a field element 32 bytes, a point its
two affine coordinates) and each output once. Multiplies count a product
of two 256-bit field elements as the 64 word products of 8 x 8 32-bit
words (a square as 36), and no reduction: a lower bound for any design.
"""

from __future__ import annotations

import math
import shutil
import subprocess

# NVIDIA H100 SXM data sheet: 3.35 TB/s of HBM3 (published)
HBM_BYTES_PER_S = 3.35e12
INT32_LANES_PER_SM = 64  # int32 multiply-adds a clock per SM on Hopper

E = 32  # bytes of a field element at its least
FMUL = 64  # 32-bit word products of a 256-bit product
FSQR = 36  # of a 256-bit square
ADD_MULS = 7 * FMUL  # a mixed Edwards addition (7 products)
DBL_MULS = 4 * FMUL + 4 * FSQR  # a doubling (4 products, 4 squares)


def max_sm_clock_hz(device_index: int = 0) -> float | None:
    """The card's maximum SM clock, from nvidia-smi (None where it cannot
    be read)."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return None
    try:
        out = subprocess.run(
            [smi, "-i", str(device_index), "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20).stdout.strip()
        return float(out.splitlines()[0]) * 1e6
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def int32_rate(sms: int, clock_hz: float) -> float:
    """Computed, not published: SMs x 64 lanes x the maximum SM clock."""
    return sms * INT32_LANES_PER_SM * clock_hz


def least_seconds(nbytes: float, muls: float, rate: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, muls / rate)


# --------------------------------------------------------------------------
# K2: batched multi-scalar multiplication
# --------------------------------------------------------------------------
def pippenger_least(n_nonzero: int, bits: int) -> tuple:
    """(additions, doublings) of the cheapest signed-digit Pippenger sum of
    n_nonzero scalars of at most `bits` bits over every window width c:
    ceil(bits / c) windows, each adding the nonzero digits' points into
    2^(c-1) buckets (a digit is zero with probability 2^-c) and reducing
    the buckets that can be filled (two additions each), and bits - c
    doublings between the windows."""
    if n_nonzero <= 0 or bits <= 0:
        return 0.0, 0.0
    best = None
    for c in range(1, 25):
        w = math.ceil(bits / c)
        fill = n_nonzero * (1.0 - 2.0 ** -c)
        adds = w * (fill + 2.0 * min(fill, 2.0 ** (c - 1)))
        dbls = max(bits - c, 0)
        cost = adds * ADD_MULS + dbls * DBL_MULS
        if best is None or cost < best[0]:
            best = (cost, adds, dbls)
    return best[1], best[2]


def pippenger_8bit(n: int, bits: int = 253) -> tuple:
    """(additions, doublings) of a signed 8-bit Pippenger row at full
    width (the port's K2 design), for comparison in tests."""
    w = math.ceil(bits / 8)
    return w * (n + 2 * 128), bits - 8


def msm_work(n_points: int, rows: list) -> tuple:
    """(bytes, multiplies) of one batched MSM: n_points points shared by
    the rows, each row given as (nonzero scalars, largest bit length)."""
    muls = 0.0
    for nz, bits in rows:
        adds, dbls = pippenger_least(nz, bits)
        muls += adds * ADD_MULS + dbls * DBL_MULS
    nbytes = n_points * 2 * E + len(rows) * (n_points * E + E)
    return nbytes, muls


# --------------------------------------------------------------------------
# K6: SPARK's grand-product circuits
# --------------------------------------------------------------------------
def tree_work(trees: int, leaves: int) -> tuple:
    """Every layer of `trees` product trees: leaves read once, each
    product written once."""
    prods = trees * (leaves - 1)
    return trees * leaves * E + prods * E, prods * FMUL


def round_work(prod_rows: int, n: int, seq_rows: int, bind: bool) -> tuple:
    """One round of the batched layer sumcheck over tables of n entries:
    prod_rows rows of A and B with one shared C, and seq_rows dot-product
    instances of three tables. With bind, every table is first bound to
    the round's challenge (one product a new entry) and written; then each
    instance's product at 3 points of each pair (2 products each) and its
    weight."""
    tables = 2 * prod_rows + 1 + 3 * seq_rows
    muls = 0
    nbytes = tables * n * E
    live = n
    if bind:
        live = n // 2
        muls += tables * live
        nbytes += tables * live * E
    pairs = live // 2
    muls += 6 * pairs * (prod_rows + seq_rows) + 3 * (prod_rows + seq_rows)
    return nbytes + 3 * E, muls * FMUL


def fold_work(prod_rows: int, seq_rows: int) -> tuple:
    """A layer's last bind: tables of 2 entries to 1."""
    tables = 2 * prod_rows + 1 + 3 * seq_rows
    return tables * 3 * E, tables * FMUL
