"""Host-side exact ristretto255 group over curve25519 (extended Edwards).

Protocol-layer group arithmetic with Python integers. Mirrors the behavior of
the reference's `GroupElement = RistrettoPoint` (src/group.rs:1-117), but is
implemented from the ristretto255 specification (RFC 9496): extended twisted
Edwards coordinates with a = -1, unified complete addition, ristretto
encode/decode, and the one-way map (`from_uniform_bytes`).

Bulk point arithmetic (MSM) lives in `spartan_parallel_tpu_torch.ops` as
limb tensors and CUDA kernels tested against this module.
"""

from __future__ import annotations

from .consts import (
    BASE_X,
    BASE_Y,
    D_MINUS_ONE_SQ,
    EDWARDS_D,
    EDWARDS_D2,
    INVSQRT_A_MINUS_D,
    ONE_MINUS_D_SQ,
    P,
    SQRT_AD_MINUS_ONE,
    SQRT_M1,
)
from .consts import L
from .field import Scalar


def _native():
    from . import native

    return native.get()


def _is_negative(x: int) -> bool:
    return (x % P) & 1 == 1


def _ct_abs(x: int) -> int:
    x %= P
    return P - x if x & 1 else x


def sqrt_ratio_m1(u: int, v: int):
    """(was_square, r) with r = nonneg sqrt(u/v) if u/v square, else
    nonneg sqrt(SQRT_M1 * u/v). RFC 9496 section 4.2."""
    u %= P
    v %= P
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    r = (u * v3 % P) * pow(u * v7 % P, (P - 5) // 8, P) % P
    check = v * (r * r % P) % P
    correct_sign = check == u
    flipped_sign = check == (P - u) % P
    flipped_sign_i = check == (P - u) * SQRT_M1 % P
    if flipped_sign or flipped_sign_i:
        r = r * SQRT_M1 % P
    if r & 1:
        r = P - r
    return (correct_sign or flipped_sign), r


class RistrettoPoint:
    """A ristretto255 group element in extended Edwards coordinates."""

    __slots__ = ("X", "Y", "Z", "T")

    def __init__(self, X: int, Y: int, Z: int, T: int):
        self.X, self.Y, self.Z, self.T = X % P, Y % P, Z % P, T % P

    # --- constructors -----------------------------------------------------
    @staticmethod
    def identity() -> "RistrettoPoint":
        return RistrettoPoint(0, 1, 1, 0)

    @staticmethod
    def basepoint() -> "RistrettoPoint":
        return RistrettoPoint(BASE_X, BASE_Y, 1, BASE_X * BASE_Y % P)

    @staticmethod
    def from_uniform_bytes(b: bytes) -> "RistrettoPoint":
        """Hash-to-group: two Elligator maps added (RFC 9496 section 4.3.4).

        Matches curve25519-dalek's `RistrettoPoint::from_uniform_bytes`, used
        by the reference for generator derivation (src/commitments.rs:25).
        """
        assert len(b) == 64
        lib = _native()
        if lib is not None:
            out = RistrettoPoint._obuf(128)
            lib.pt_from_uniform(bytes(b), out)
            return RistrettoPoint._unpack(out.raw)
        p1 = _elligator_map(int.from_bytes(b[:32], "little") & ((1 << 255) - 1))
        p2 = _elligator_map(int.from_bytes(b[32:], "little") & ((1 << 255) - 1))
        return p1 + p2

    @staticmethod
    def decompress(data: bytes) -> "RistrettoPoint":
        """Ristretto DECODE (RFC 9496 section 4.3.1). Raises on invalid."""
        assert len(data) == 32
        lib = _native()
        if lib is not None:
            out = RistrettoPoint._obuf(128)
            if not lib.pt_decompress(bytes(data), out):
                raise ValueError("invalid ristretto encoding")
            return RistrettoPoint._unpack(out.raw)
        s = int.from_bytes(data, "little")
        if s >= P or (s & 1):
            raise ValueError("invalid ristretto encoding (non-canonical)")
        ss = s * s % P
        u1 = (1 - ss) % P
        u2 = (1 + ss) % P
        u2_sqr = u2 * u2 % P
        v = (-(EDWARDS_D * (u1 * u1 % P)) - u2_sqr) % P
        was_square, invsqrt = sqrt_ratio_m1(1, v * u2_sqr % P)
        den_x = invsqrt * u2 % P
        den_y = invsqrt * den_x % P * v % P
        x = _ct_abs(2 * s % P * den_x % P)
        y = u1 * den_y % P
        t = x * y % P
        if (not was_square) or _is_negative(t) or y == 0:
            raise ValueError("invalid ristretto encoding")
        return RistrettoPoint(x, y, 1, t)

    # --- encoding ---------------------------------------------------------
    def compress(self) -> bytes:
        """Ristretto ENCODE (RFC 9496 section 4.3.2) -> 32 bytes."""
        lib = _native()
        if lib is not None:
            out = RistrettoPoint._obuf(32)
            lib.pt_compress(self._pack(), out)
            return out.raw
        X, Y, Z, T = self.X, self.Y, self.Z, self.T
        u1 = (Z + Y) * (Z - Y) % P
        u2 = X * Y % P
        _, invsqrt = sqrt_ratio_m1(1, u1 * (u2 * u2 % P) % P)
        den1 = invsqrt * u1 % P
        den2 = invsqrt * u2 % P
        z_inv = den1 * den2 % P * T % P
        ix0 = X * SQRT_M1 % P
        iy0 = Y * SQRT_M1 % P
        enchanted_denominator = den1 * INVSQRT_A_MINUS_D % P
        rotate = _is_negative(T * z_inv % P)
        if rotate:
            x, y, den_inv = iy0, ix0, enchanted_denominator
        else:
            x, y, den_inv = X, Y, den2
        if _is_negative(x * z_inv % P):
            y = (P - y) % P
        s = _ct_abs(den_inv * ((Z - y) % P) % P)
        return s.to_bytes(32, "little")

    # --- native fast path ---------------------------------------------------
    @staticmethod
    def _obuf(n: int):
        import ctypes

        return ctypes.create_string_buffer(n)

    def _pack(self) -> bytes:
        return b"".join(v.to_bytes(32, "little")
                        for v in (self.X, self.Y, self.Z, self.T))

    @staticmethod
    def _unpack(b: bytes) -> "RistrettoPoint":
        return RistrettoPoint(
            int.from_bytes(b[:32], "little"),
            int.from_bytes(b[32:64], "little"),
            int.from_bytes(b[64:96], "little"),
            int.from_bytes(b[96:], "little"))

    # --- group law ----------------------------------------------------------
    def __add__(self, o: "RistrettoPoint") -> "RistrettoPoint":
        lib = _native()
        if lib is not None:
            out = RistrettoPoint._obuf(128)
            lib.pt_add(self._pack(), o._pack(), out)
            return RistrettoPoint._unpack(out.raw)
        # Unified complete addition, add-2008-hwcd-3 specialized for a = -1.
        A = (self.Y - self.X) * (o.Y - o.X) % P
        B = (self.Y + self.X) * (o.Y + o.X) % P
        C = self.T * EDWARDS_D2 % P * o.T % P
        D = 2 * self.Z * o.Z % P
        E = (B - A) % P
        F = (D - C) % P
        G = (D + C) % P
        H = (B + A) % P
        return RistrettoPoint(E * F, G * H, F * G, E * H)

    def double(self) -> "RistrettoPoint":
        lib = _native()
        if lib is not None:
            out = RistrettoPoint._obuf(128)
            lib.pt_double(self._pack(), out)
            return RistrettoPoint._unpack(out.raw)
        A = self.X * self.X % P
        B = self.Y * self.Y % P
        C = 2 * self.Z % P * self.Z % P
        D = (P - A) % P  # a = -1
        E = ((self.X + self.Y) * (self.X + self.Y) - A - B) % P
        G = (D + B) % P
        F = (G - C) % P
        H = (D - B) % P
        return RistrettoPoint(E * F, G * H, F * G, E * H)

    def __neg__(self) -> "RistrettoPoint":
        return RistrettoPoint(P - self.X, self.Y, self.Z, P - self.T)

    def __sub__(self, o: "RistrettoPoint") -> "RistrettoPoint":
        return self + (-o)

    def scalar_mul(self, s) -> "RistrettoPoint":
        """Variable-time double-and-add (host path; device MSM is the bulk op)."""
        k = int(s) if not isinstance(s, Scalar) else s.v
        lib = _native()
        if lib is not None:
            out = RistrettoPoint._obuf(128)
            lib.pt_scalar_mul(self._pack(), (k % L).to_bytes(32, "little"),
                              out)
            return RistrettoPoint._unpack(out.raw)
        acc = RistrettoPoint.identity()
        add = self
        while k:
            if k & 1:
                acc = acc + add
            add = add.double()
            k >>= 1
        return acc

    def __rmul__(self, s) -> "RistrettoPoint":
        return self.scalar_mul(s)

    def __mul__(self, s) -> "RistrettoPoint":
        return self.scalar_mul(s)

    # --- equality (ristretto quotient) --------------------------------------
    def __eq__(self, o: object) -> bool:
        if not isinstance(o, RistrettoPoint):
            return NotImplemented
        # X1*Y2 == Y1*X2 or Y1*Y2 == X1*X2 (a = -1), RFC 9496 section 4.5.
        return (
            self.X * o.Y % P == self.Y * o.X % P
            or self.Y * o.Y % P == self.X * o.X % P
        )

    def __hash__(self) -> int:
        return hash(self.compress())

    def is_identity(self) -> bool:
        return self == RistrettoPoint.identity()

    def __repr__(self) -> str:
        return f"RistrettoPoint({self.compress().hex()})"


def _elligator_map(t: int) -> RistrettoPoint:
    """MAP of RFC 9496 section 4.3.4: field element -> group element."""
    t %= P
    r = SQRT_M1 * (t * t % P) % P
    u = (r + 1) % P * ONE_MINUS_D_SQ % P
    v = ((P - 1) - r * EDWARDS_D) % P * ((r + EDWARDS_D) % P) % P
    was_square, s = sqrt_ratio_m1(u, v)
    s_prime = P - _ct_abs(s * t % P)
    if not was_square:
        s = s_prime
        c = r
    else:
        c = P - 1
    N = c * ((r - 1) % P) % P * D_MINUS_ONE_SQ % P
    N = (N - v) % P
    w0 = 2 * s % P * v % P
    w1 = N * SQRT_AD_MINUS_ONE % P
    w2 = (1 - s * s) % P
    w3 = (1 + s * s) % P
    return RistrettoPoint(w0 * w3, w2 * w1, w1 * w3, w0 * w2)


def multiscalar_mul(scalars, points) -> RistrettoPoint:
    """Host-side MSM (exact, variable time). Mirrors the reference's
    `VartimeMultiscalarMul` (src/group.rs:89) semantics; the fast path is the
    device Pippenger kernel in ops/msm.py, which is tested against this."""
    lib = _native()
    if lib is not None:
        pts = list(points)
        ks = [int(s) % L for s in scalars]
        assert len(ks) == len(pts)
        if not pts:
            return RistrettoPoint.identity()
        pbuf = b"".join(p._pack() for p in pts)
        sbuf = b"".join(k.to_bytes(32, "little") for k in ks)
        out = RistrettoPoint._obuf(128)
        lib.pt_msm(pbuf, sbuf, len(pts), out)
        return RistrettoPoint._unpack(out.raw)
    acc = RistrettoPoint.identity()
    for s, pt in zip(scalars, points):
        k = int(s) if not isinstance(s, Scalar) else s.v
        if k:
            acc = acc + pt.scalar_mul(k)
    return acc
