"""Keccak-f[1600] permutation (pure Python, host-side).

Used by the STROBE-128 sponge underlying the merlin Fiat-Shamir transcript
(the reference uses the `merlin` crate; see src/transcript.rs). Validated in
tests by building SHA3-256 on top and comparing against hashlib.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# Rotation offsets r[x][y], lane (x, y) stored at index x + 5*y.
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl(v: int, n: int) -> int:
    n %= 64
    return ((v << n) | (v >> (64 - n))) & _MASK


def keccak_f1600(lanes: list) -> list:
    """Apply Keccak-f[1600] to 25 u64 lanes (index x + 5*y), in place-ish."""
    a = list(lanes)
    for rc in _RC:
        # theta
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] ^= d[x]
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(a[x + 5 * y], _ROT[x][y])
        # chi
        for x in range(5):
            for y in range(5):
                a[x + 5 * y] = b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y]) & b[(x + 2) % 5 + 5 * y] & _MASK)
        # iota
        a[0] ^= rc
    return a


def permute_state(state: bytearray) -> None:
    """Apply Keccak-f[1600] to a 200-byte state, little-endian lanes.

    Uses the native C permutation (native/keccak.c) when available —
    the transcript flushes the sponge on every challenge, making this
    the host-side fixed cost per proof — with the pure-Python
    implementation above as fallback and validation oracle."""
    import ctypes

    from ..core import native

    lib = native.get()
    if lib is not None:
        lib.keccak_f1600((ctypes.c_char * 200).from_buffer(state))
        return
    lanes = [int.from_bytes(state[8 * i : 8 * i + 8], "little") for i in range(25)]
    lanes = keccak_f1600(lanes)
    for i, lane in enumerate(lanes):
        state[8 * i : 8 * i + 8] = lane.to_bytes(8, "little")


def sha3_256(data: bytes) -> bytes:
    """SHA3-256 built on keccak_f1600 — used only to validate the permutation."""
    rate = 136
    state = bytearray(200)
    # absorb with pad10*1, domain 0x06
    padded = bytearray(data)
    padded.append(0x06)
    while len(padded) % rate != 0:
        padded.append(0x00)
    padded[-1] |= 0x80
    for off in range(0, len(padded), rate):
        for i in range(rate):
            state[i] ^= padded[off + i]
        permute_state(state)
    return bytes(state[:32])
