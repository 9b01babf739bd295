"""The merlin transcript on the device: Keccak-f[1600] and STROBE-128 (K8).

Counterpart of the JAX package's ops/transcript_dev.py. The host transcript
(utils/transcript.py) would cost one device-to-host copy per sumcheck
round: a round's commitment has to be absorbed before its challenge can be
squeezed. The device-resident rounds (ops/zk_round.py) keep the
transcript on the card instead, byte for byte the same STROBE-128 subset
that merlin uses (utils/strobe.py).

A transcript state is a (202,) int32 tensor: the 200 bytes of the sponge
state, then `pos` and `pos_begin`. On the card the state lives inside K11
(csrc/zk_round.cu, csrc/keccak.cuh). The plain versions below operate on
(st, pos, pos_begin) with st an int64 tensor of byte values and the two
positions Python ints, and serve the plain round tail and the CPU tests.

`permute` launches K8 on a CUDA tensor (a batch of states, one thread
each; the kernel-level check of the permutation K11 runs) and takes
`permute_plain` on a CPU tensor. Replaces transcript_dev.py _f1600 and
permute; bound by operations, see csrc/zk_round.cu.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fq, kernels
from . import limbs as lb

STROBE_R = 166
STATE_LEN = 202

FLAG_I = 1
FLAG_A = 1 << 1
FLAG_C = 1 << 2
FLAG_M = 1 << 4
FLAG_K = 1 << 5

_M32 = 0xFFFFFFFF
_RC64 = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]
# rho offsets of lane (x, y) at flat index x + 5 y (utils/keccak.py)
_ROT_XY = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]
# rho + pi as one permutation: dst[y + 5 ((2x + 3y) % 5)] = rotl(src[x + 5y])
_PI_SRC = np.zeros(25, dtype=np.int64)
_PI_ROT = np.zeros(25, dtype=np.int64)
for _x in range(5):
    for _y in range(5):
        _dst = _y + 5 * ((2 * _x + 3 * _y) % 5)
        _PI_SRC[_dst] = _x + 5 * _y
        _PI_ROT[_dst] = _ROT_XY[_x][_y]


# --------------------------------------------------------------------------
# Keccak-f[1600], plain: 64-bit lanes as (lo, hi) 32-bit halves in int64
# --------------------------------------------------------------------------
def _rotl(lo, hi, rot):
    """Rotate-left of (lo, hi) lane pairs by per-lane amounts (an int64
    tensor broadcast over the lanes' last axis)."""
    sw = rot >= 32
    lo, hi = torch.where(sw, hi, lo), torch.where(sw, lo, hi)
    rr = rot % 32
    z = rr == 0
    rs = torch.where(z, torch.ones_like(rr), rr)
    lo2 = ((lo << rs) | (hi >> (32 - rs))) & _M32
    hi2 = ((hi << rs) | (lo >> (32 - rs))) & _M32
    return torch.where(z, lo, lo2), torch.where(z, hi, hi2)


def _f1600(lo, hi):
    """(..., 25) lo/hi lane halves -> the permuted halves."""
    dev = lo.device
    src = torch.as_tensor(_PI_SRC, device=dev)
    rot = torch.as_tensor(_PI_ROT, device=dev)
    one = torch.ones(5, dtype=torch.int64, device=dev)
    for rc in _RC64:
        a_lo = lo.unflatten(-1, (5, 5))  # [..., y, x]
        a_hi = hi.unflatten(-1, (5, 5))
        c_lo = a_lo[..., 0, :] ^ a_lo[..., 1, :] ^ a_lo[..., 2, :] \
            ^ a_lo[..., 3, :] ^ a_lo[..., 4, :]
        c_hi = a_hi[..., 0, :] ^ a_hi[..., 1, :] ^ a_hi[..., 2, :] \
            ^ a_hi[..., 3, :] ^ a_hi[..., 4, :]
        r_lo, r_hi = _rotl(c_lo.roll(-1, -1), c_hi.roll(-1, -1), one)
        d_lo = c_lo.roll(1, -1) ^ r_lo
        d_hi = c_hi.roll(1, -1) ^ r_hi
        lo = (a_lo ^ d_lo.unsqueeze(-2)).flatten(-2)
        hi = (a_hi ^ d_hi.unsqueeze(-2)).flatten(-2)
        lo, hi = _rotl(lo[..., src], hi[..., src], rot)
        b_lo = lo.unflatten(-1, (5, 5))
        b_hi = hi.unflatten(-1, (5, 5))
        lo = (b_lo ^ (~b_lo.roll(-1, -1) & _M32 & b_lo.roll(-2, -1)))
        hi = (b_hi ^ (~b_hi.roll(-1, -1) & _M32 & b_hi.roll(-2, -1)))
        lo = lo.flatten(-2).clone()
        hi = hi.flatten(-2).clone()
        lo[..., 0] ^= rc & _M32
        hi[..., 0] ^= rc >> 32
    return lo, hi


def permute_plain(st: torch.Tensor) -> torch.Tensor:
    """(..., 200) byte states -> the permuted states (int32)."""
    b = st.to(torch.int64).unflatten(-1, (25, 8))
    sh = torch.arange(0, 32, 8, dtype=torch.int64, device=st.device)
    lo = (b[..., :4] << sh).sum(-1)
    hi = (b[..., 4:] << sh).sum(-1)
    lo, hi = _f1600(lo, hi)
    w = torch.stack([lo, hi], -1).unsqueeze(-1)  # (..., 25, 2, 1)
    return ((w >> sh) & 0xFF).flatten(-3).to(torch.int32)


def permute(st: torch.Tensor) -> torch.Tensor:
    """Keccak-f[1600] on each (200,) byte state of `st`: K8 on a CUDA
    tensor, the plain version on a CPU tensor."""
    if st.shape[-1] != 200:
        raise ValueError(f"expected (..., 200) byte states, got "
                         f"{tuple(st.shape)}")
    if st.device.type == "cpu":
        return permute_plain(st)
    st = st.contiguous()
    kernels.require_cuda(st)
    out = torch.empty_like(st)
    if st.numel():
        kernels.launch("keccak_f1600", "keccak_launch", st.data_ptr(),
                       out.data_ptr(), st.numel() // 200, kernels.stream(st))
    return out


# --------------------------------------------------------------------------
# STROBE-128, plain (utils/strobe.py): s = (st, pos, pos_begin)
# --------------------------------------------------------------------------
def _run_f(s):
    st, pos, pos_begin = s
    st = st.clone()
    st[pos] ^= pos_begin
    st[pos + 1] ^= 0x04
    st[STROBE_R + 1] ^= 0x80
    return permute_plain(st).to(torch.int64), 0, 0


def _absorb(s, data: torch.Tensor):
    """XOR-absorb the bytes of `data`, permuting at each full block."""
    st, pos, pos_begin = s
    i = 0
    while i < data.shape[0]:
        k = min(data.shape[0] - i, STROBE_R - pos)
        st = st.clone()
        st[pos:pos + k] ^= data[i:i + k]
        pos += k
        i += k
        if pos == STROBE_R:
            st, pos, pos_begin = _run_f((st, pos, pos_begin))
    return st, pos, pos_begin


def _squeeze(s, n: int):
    """PRF-squeeze n bytes, zeroing the state bytes it reads."""
    st, pos, pos_begin = s
    out = []
    while n > 0:
        k = min(n, STROBE_R - pos)
        out.append(st[pos:pos + k].clone())
        st = st.clone()
        st[pos:pos + k] = 0
        pos += k
        n -= k
        if pos == STROBE_R:
            st, pos, pos_begin = _run_f((st, pos, pos_begin))
    return (st, pos, pos_begin), torch.cat(out) if out else st[:0]


def _begin_op(s, flags: int, more: bool):
    if more:
        return s
    st, pos, pos_begin = s
    data = torch.tensor([pos_begin, flags], dtype=torch.int64,
                        device=st.device)
    # pos_begin becomes pos + 1 before the flag bytes are absorbed
    s = _absorb((st, pos, pos + 1), data)
    if flags & (FLAG_C | FLAG_K) and s[1] != 0:
        s = _run_f(s)
    return s


def meta_ad(s, data, more: bool):
    return _absorb(_begin_op(s, FLAG_M | FLAG_A, more), data)


def ad(s, data, more: bool):
    return _absorb(_begin_op(s, FLAG_A, more), data)


def prf(s, n: int, more: bool):
    return _squeeze(_begin_op(s, FLAG_I | FLAG_A | FLAG_C, more), n)


# --------------------------------------------------------------------------
# merlin ops, plain (utils/transcript.py)
# --------------------------------------------------------------------------
def _bytes(bs: bytes, device) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(bs, dtype=np.uint8).astype(
        np.int64), device=device)


def append_message(s, label: bytes, msg: torch.Tensor):
    """msg: (k,) byte values."""
    dev = s[0].device
    s = meta_ad(s, _bytes(label, dev), False)
    s = meta_ad(s, _bytes(int(msg.shape[0]).to_bytes(4, "little"), dev),
                True)
    return ad(s, msg.to(torch.int64), False)


def challenge_bytes(s, label: bytes, n: int):
    dev = s[0].device
    s = meta_ad(s, _bytes(label, dev), False)
    s = meta_ad(s, _bytes(n.to_bytes(4, "little"), dev), True)
    return prf(s, n, False)


def bytes_to_limbs(by: torch.Tensor) -> torch.Tensor:
    """(..., 2k) little-endian bytes -> (..., k) 16-bit limbs."""
    b = by.to(torch.int64).unflatten(-1, (-1, 2))
    return (b[..., 0] | (b[..., 1] << 8)).to(torch.int32)


def limbs_to_bytes(limbs: torch.Tensor) -> torch.Tensor:
    """(..., k) 16-bit limbs -> (..., 2k) little-endian bytes."""
    li = limbs.to(torch.int64)
    return torch.stack([li & 0xFF, (li >> 8) & 0xFF], -1).flatten(-2)


def from_bytes_wide(by: torch.Tensor) -> torch.Tensor:
    """(..., 64) bytes -> (..., 16) Montgomery limbs of
    Scalar::from_bytes_wide: lo + hi 2^256 mod l. Each half may be >= l; a
    Montgomery product of a value below 2^256 with one below l stays below
    2 l before its last subtraction, so the results are fully reduced."""
    r2 = lb.to_device(fq.R2_LIMBS, by.device)
    lo = fq.mul_plain(bytes_to_limbs(by[..., :32]), r2)
    hi = fq.mul_plain(fq.mul_plain(bytes_to_limbs(by[..., 32:]), r2), r2)
    return fq.add_plain(lo, hi)


def challenge_scalar(s, label: bytes):
    """-> (state, (16,) Montgomery limbs)."""
    s, by = challenge_bytes(s, label, 64)
    return s, from_bytes_wide(by)


def append_scalar(s, label: bytes, mont: torch.Tensor):
    """mont: (16,) Montgomery limbs, appended as 32 canonical bytes."""
    one = lb.to_device(fq.ONE_LIMBS, mont.device)
    return append_message(s, label, limbs_to_bytes(fq.mul_plain(mont, one)))


def append_scalar_vector(s, label: bytes, monts: torch.Tensor):
    """monts: (n, 16) Montgomery limbs (src/transcript.rs:49-57)."""
    dev = monts.device
    s = append_message(s, label, _bytes(b"begin_append_vector", dev))
    for i in range(monts.shape[0]):
        s = append_scalar(s, label, monts[i])
    return append_message(s, label, _bytes(b"end_append_vector", dev))


def append_point(s, label: bytes, pt_bytes: torch.Tensor):
    """pt_bytes: (32,) compressed ristretto bytes."""
    return append_message(s, label, pt_bytes)


# --------------------------------------------------------------------------
# State tensors and the host transcript
# --------------------------------------------------------------------------
def from_host(transcript, device) -> torch.Tensor:
    """A host utils/transcript.Transcript's STROBE state as a (202,) int32
    tensor on `device`."""
    return torch.from_numpy(host_state(transcript)).to(device)


def host_state(transcript) -> np.ndarray:
    sb = transcript.strobe
    out = np.empty(STATE_LEN, dtype=np.int32)
    out[:200] = np.frombuffer(bytes(sb.state), np.uint8)
    out[200] = sb.pos
    out[201] = sb.pos_begin
    return out


def set_host_state(transcript, state) -> None:
    """Resync a host transcript to a (202,) state (numpy or tensor). The
    last operation of a round is a PRF, whose flags the host keeps."""
    state = np.asarray(state.cpu() if isinstance(state, torch.Tensor)
                       else state)
    sb = transcript.strobe
    sb.state = bytearray(state[:200].astype(np.uint8).tobytes())
    sb.pos = int(state[200])
    sb.pos_begin = int(state[201])
    sb.cur_flags = FLAG_I | FLAG_A | FLAG_C


def unpack(t: torch.Tensor):
    """(202,) state tensor -> (st, pos, pos_begin) of the plain ops."""
    pos, pos_begin = (int(v) for v in t[200:].cpu())
    return t[:200].to(torch.int64), pos, pos_begin


def pack(s, out: torch.Tensor) -> None:
    """Write (st, pos, pos_begin) into a (202,) state tensor."""
    st, pos, pos_begin = s
    out[:200] = st
    out[200] = pos
    out[201] = pos_begin
