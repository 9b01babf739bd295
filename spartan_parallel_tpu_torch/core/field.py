"""Host-side exact scalar field: Z/L where L is the ristretto255 group order.

This is the *protocol* arithmetic layer: small numbers of field ops executed
on the host with Python integers (exact, arbitrary precision). Bulk tensor
field arithmetic lives in `spartan_parallel_tpu_torch.ops.fq` as limb
tensors and CUDA kernels; those are tested against this module.

API parity with the reference's `Scalar` (src/scalar/ristretto255.rs):
to_bytes/from_bytes (canonical 32-byte LE), from_bytes_wide (64-byte LE
reduced mod L), invert, batch_invert, pow2/from_u64 style constructors.
Internally we keep plain residues (no Montgomery form): only I/O bytes must
match the reference.
"""

from __future__ import annotations

from .consts import L


class Scalar:
    """An element of the scalar field Z/L."""

    __slots__ = ("v",)

    def __init__(self, v: int = 0):
        self.v = v % L

    # --- constructors -----------------------------------------------------
    @staticmethod
    def zero() -> "Scalar":
        return Scalar(0)

    @staticmethod
    def one() -> "Scalar":
        return Scalar(1)

    @staticmethod
    def from_u64(x: int) -> "Scalar":
        return Scalar(x)

    @staticmethod
    def from_bytes(b: bytes) -> "Scalar":
        """Canonical 32-byte little-endian decoding; raises if >= L.

        reference: ristretto255.rs `from_bytes` returns CtOption; we raise.
        """
        assert len(b) == 32
        v = int.from_bytes(b, "little")
        if v >= L:
            raise ValueError("non-canonical scalar encoding")
        return Scalar(v)

    @staticmethod
    def from_bytes_mod_order(b: bytes) -> "Scalar":
        assert len(b) == 32
        return Scalar(int.from_bytes(b, "little"))

    @staticmethod
    def from_bytes_wide(b: bytes) -> "Scalar":
        """64 little-endian bytes reduced mod L (ristretto255.rs:435)."""
        assert len(b) == 64
        return Scalar(int.from_bytes(b, "little"))

    # --- encoding ---------------------------------------------------------
    def to_bytes(self) -> bytes:
        return self.v.to_bytes(32, "little")

    def __int__(self) -> int:
        return self.v

    # --- arithmetic -------------------------------------------------------
    def __add__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v + o.v)

    def __sub__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v - o.v)

    def __neg__(self) -> "Scalar":
        return Scalar(-self.v)

    def __mul__(self, o: "Scalar") -> "Scalar":
        return Scalar(self.v * o.v)

    def square(self) -> "Scalar":
        return Scalar(self.v * self.v)

    def double(self) -> "Scalar":
        return Scalar(self.v * 2)

    def pow(self, e: int) -> "Scalar":
        return Scalar(pow(self.v, e, L))

    def invert(self) -> "Scalar":
        if self.v == 0:
            raise ZeroDivisionError("invert of zero scalar")
        return Scalar(pow(self.v, L - 2, L))

    def is_zero(self) -> bool:
        return self.v == 0

    # --- comparisons / hashing ---------------------------------------------
    def __eq__(self, o: object) -> bool:
        return isinstance(o, Scalar) and self.v == o.v

    def __hash__(self) -> int:
        return hash(self.v)

    def __repr__(self) -> str:
        return f"Scalar(0x{self.v:x})"


ZERO = Scalar(0)
ONE = Scalar(1)


def batch_invert(scalars: list) -> list:
    """Montgomery's trick (ristretto255.rs:597): one inversion for n elements.

    Zero entries are not allowed (matches reference's debug assertion).
    """
    n = len(scalars)
    if n == 0:
        return []
    prefix = [0] * n
    acc = 1
    for i, s in enumerate(scalars):
        v = s.v if isinstance(s, Scalar) else s % L
        assert v != 0, "batch_invert with zero element"
        prefix[i] = acc
        acc = (acc * v) % L
    inv = pow(acc, L - 2, L)
    out = [None] * n
    for i in range(n - 1, -1, -1):
        v = scalars[i].v if isinstance(scalars[i], Scalar) else scalars[i] % L
        out[i] = Scalar(inv * prefix[i])
        inv = (inv * v) % L
    return out
