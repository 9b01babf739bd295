"""Merlin transcript + the reference's ProofTranscript extensions.

Byte-exact reimplementation of the `merlin` crate's `Transcript` on top of
STROBE-128, plus the `ProofTranscript` / `AppendToTranscript` conventions of
the reference (src/transcript.rs:5-63): append_scalar/point,
challenge_scalar (64-byte PRF reduced mod L), vector framing.

The transcript is inherently sequential and lives on the host; device kernels
only exchange already-reduced scalars with it (SURVEY.md section 2.3).
"""

from __future__ import annotations

from ..core.edwards import RistrettoPoint
from ..core.field import Scalar
from .strobe import Strobe128


def _u32_le(n: int) -> bytes:
    return n.to_bytes(4, "little")


class Transcript:
    """merlin::Transcript equivalent."""

    __slots__ = ("strobe",)

    def __init__(self, label: bytes):
        self.strobe = Strobe128(b"Merlin v1.0")
        self.append_message(b"dom-sep", label)

    def append_message(self, label: bytes, message: bytes) -> None:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32_le(len(message)), True)
        self.strobe.ad(message, False)

    def append_u64(self, label: bytes, x: int) -> None:
        self.append_message(label, x.to_bytes(8, "little"))

    def challenge_bytes(self, label: bytes, n: int) -> bytes:
        self.strobe.meta_ad(label, False)
        self.strobe.meta_ad(_u32_le(n), True)
        return self.strobe.prf(n, False)

    # --- ProofTranscript extension trait (reference src/transcript.rs) ------
    def append_protocol_name(self, protocol_name: bytes) -> None:
        self.append_message(b"protocol-name", protocol_name)

    def append_scalar(self, label: bytes, scalar: Scalar) -> None:
        self.append_message(label, scalar.to_bytes())

    def append_scalar_vector(self, label: bytes, scalars) -> None:
        # AppendToTranscript for [Scalar] (src/transcript.rs:49-57)
        self.append_message(label, b"begin_append_vector")
        for s in scalars:
            self.append_scalar(label, s)
        self.append_message(label, b"end_append_vector")

    def append_point(self, label: bytes, point) -> None:
        """point: RistrettoPoint or 32-byte compressed encoding."""
        if isinstance(point, RistrettoPoint):
            point = point.compress()
        assert isinstance(point, (bytes, bytearray)) and len(point) == 32
        self.append_message(label, bytes(point))

    def challenge_scalar(self, label: bytes) -> Scalar:
        return Scalar.from_bytes_wide(self.challenge_bytes(label, 64))

    def challenge_vector(self, label: bytes, n: int):
        return [self.challenge_scalar(label) for _ in range(n)]
