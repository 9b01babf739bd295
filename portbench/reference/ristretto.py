"""Plain ristretto255 (RFC 9496) and the scalar field, in Python integers.

The benchmark's reference judges the port's commitments with this module.
It is written from the RFC, not from the port, and imports nothing but the
standard library: extended twisted Edwards coordinates (a = -1), the
ristretto encoding and decoding, the one-way map, and a windowed
multi-scalar multiplication. Points are tuples (X, Y, Z, T); scalars are
ints mod L.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)


def _is_neg(x: int) -> bool:
    return (x % P) & 1 == 1


def _abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def sqrt_ratio_m1(u: int, v: int):
    """(was_square, r): r the non-negative root of u/v, or of SQRT_M1 u/v
    where u/v is not a square (RFC 9496 section 4.2)."""
    u %= P
    v %= P
    v3 = v * v % P * v % P
    v7 = v3 * v3 % P * v % P
    r = u * v3 % P * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * r % P * r % P
    correct = check == u
    flipped = check == (-u) % P
    flipped_i = check == (-u) * SQRT_M1 % P
    if flipped or flipped_i:
        r = r * SQRT_M1 % P
    return correct or flipped, _abs(r)


SQRT_AD_MINUS_ONE = sqrt_ratio_m1((-D - 1) % P, 1)[1]
INVSQRT_A_MINUS_D = sqrt_ratio_m1(1, (-1 - D) % P)[1]
ONE_MINUS_D_SQ = (1 - D * D) % P
D_MINUS_ONE_SQ = (D - 1) * (D - 1) % P

IDENTITY = (0, 1, 1, 0)


def add(p, q):
    """Unified addition (add-2008-hwcd-3, a = -1)."""
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 % P * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p):
    """dbl-2008-hwcd with a = -1."""
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    e = ((x1 + y1) * (x1 + y1) - a - b) % P
    g = (b - a) % P
    f = (g - c) % P
    h = (-a - b) % P
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def decode(s: bytes):
    """32 bytes -> point; ValueError for a non-canonical or invalid
    encoding (RFC 9496 section 4.3.1)."""
    if len(s) != 32:
        raise ValueError("an encoding has 32 bytes")
    v = int.from_bytes(s, "little")
    if v >= P or _is_neg(v):
        raise ValueError("non-canonical encoding")
    ss = v * v % P
    u1 = (1 - ss) % P
    u2 = (1 + ss) % P
    u2_sqr = u2 * u2 % P
    w = (-(D * u1 % P * u1) - u2_sqr) % P
    ok, invsqrt = sqrt_ratio_m1(1, w * u2_sqr % P)
    den_x = invsqrt * u2 % P
    den_y = invsqrt * den_x % P * w % P
    x = _abs(2 * v * den_x)
    y = u1 * den_y % P
    t = x * y % P
    if not ok or _is_neg(t) or y == 0:
        raise ValueError("invalid encoding")
    return (x, y, 1, t)


def encode(p) -> bytes:
    """RFC 9496 section 4.3.2."""
    x0, y0, z0, t0 = p
    u1 = (z0 + y0) * (z0 - y0) % P
    u2 = x0 * y0 % P
    _, invsqrt = sqrt_ratio_m1(1, u1 * u2 % P * u2 % P)
    den1 = invsqrt * u1 % P
    den2 = invsqrt * u2 % P
    z_inv = den1 * den2 % P * t0 % P
    if _is_neg(t0 * z_inv):
        x, y = y0 * SQRT_M1 % P, x0 * SQRT_M1 % P
        den_inv = den1 * INVSQRT_A_MINUS_D % P
    else:
        x, y, den_inv = x0, y0, den2
    if _is_neg(x * z_inv):
        y = (-y) % P
    return _abs(den_inv * (z0 - y)).to_bytes(32, "little")


def _map(t: int):
    """The one-way map of one field element (RFC 9496 section 4.3.4)."""
    r = SQRT_M1 * t % P * t % P
    u = (r + 1) * ONE_MINUS_D_SQ % P
    v = (-1 - r * D) * (r + D) % P
    ok, s = sqrt_ratio_m1(u, v)
    if not ok:
        s = (-_abs(s * t)) % P
        c = r
    else:
        c = P - 1
    n = (c * (r - 1) % P * D_MINUS_ONE_SQ - v) % P
    w0 = 2 * s * v % P
    w1 = n * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return (w0 * w3 % P, w2 * w1 % P, w1 * w3 % P, w0 * w2 % P)


def from_uniform_bytes(b: bytes):
    mask = (1 << 255) - 1
    t1 = (int.from_bytes(b[:32], "little") & mask) % P
    t2 = (int.from_bytes(b[32:64], "little") & mask) % P
    return add(_map(t1), _map(t2))


BASEPOINT = decode(bytes.fromhex(
    "e2f2ae0a6abc4e71a884a961c500515f58e30b6aa582dd8db6a65945e08d2d76"))


def mul(p, k: int):
    """k P by double-and-add (k taken mod L)."""
    k %= L
    acc = IDENTITY
    for bit in bin(k)[2:]:
        acc = double(acc)
        if bit == "1":
            acc = add(acc, p)
    return acc


def msm(points, scalars):
    """sum_i k_i P_i by Pippenger's buckets with the width suited to the
    count; scalars taken mod L."""
    ks = [k % L for k in scalars]
    n = len(points)
    if n == 0:
        return IDENTITY
    c = max(1, min(12, (n.bit_length() - 1)))
    bits = max(max(ks).bit_length(), 1)
    acc = IDENTITY
    for w in range((bits - 1) // c, -1, -1):
        for _ in range(c):
            acc = double(acc)
        buckets = [None] * (1 << c)
        shift = w * c
        mask = (1 << c) - 1
        for pt, k in zip(points, ks):
            d = (k >> shift) & mask
            if d:
                b = buckets[d]
                buckets[d] = pt if b is None else add(b, pt)
        run = IDENTITY
        tot = IDENTITY
        for d in range(mask, 0, -1):
            if buckets[d] is not None:
                run = add(run, buckets[d])
            tot = add(tot, run)
        acc = add(acc, tot)
    return acc


def generators(label: bytes, n: int):
    """The n + 1 points shake256(label || encode(B)) read 64 bytes a
    point through the one-way map: Spartan's MultiCommitGens
    (commitments.rs), G_0 .. G_{n-1} and the blinding point h last."""
    shake = hashlib.shake_256()
    shake.update(label)
    shake.update(encode(BASEPOINT))
    stream = shake.digest(64 * (n + 1))
    return [from_uniform_bytes(stream[64 * i:64 * i + 64])
            for i in range(n + 1)]


# --------------------------------------------------------------------------
# Scalar field and multilinear extensions
# --------------------------------------------------------------------------
def eq_table(r):
    """eq(r, i) for every i < 2^len(r), r[0] the most significant bit."""
    tab = [1]
    for ri in r:
        ri %= L
        nxt = []
        for v in tab:
            hi = v * ri % L
            nxt.append((v - hi) % L)
            nxt.append(hi)
        tab = nxt
    return tab
