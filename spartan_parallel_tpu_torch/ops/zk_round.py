"""One device-resident ZK sumcheck round after its evaluations (K11).

Counterpart of the JAX package's ops/zk_round.py (_coeffs_from_evals,
_poly_eval, _zk_round_tail). The reference prover's ZK sumcheck
(src/sumcheck.rs:788, :1067) is a host loop: each round commits its round
polynomial, squeezes a Fiat-Shamir challenge, combines two claims and runs
a DotProductProof (src/nizk/mod.rs:292-358). On the card the port runs
that tail as one kernel launch per round, after the round kernel (K4 or
K5) and on the same stream: the transcript stays on the card
(ops/transcript_dev.py), the commitments use fixed-base comb tables and
the device ENCODE (ops/ristretto_dev.py), and the challenge `r` is written
straight into the row that the next round's fused bind reads. The host
uploads the round's tape values (drawn in the host loop's order) before
the sumcheck and downloads its messages after it; models/sumcheck.py
drives the rounds.

Per round, in this order:
  1. sum the evaluations over the table sets and interpolate the cubic;
  2. commit coeffs || blinds_poly[j] (comb, 4 G + h), compress, append
     comm_poly, squeeze r;
  3. evaluate at r, commit eval || blinds_evals[j] (comb, G + h);
  4. append comm_claim_per_round and comm_eval, squeeze the two
     combine_two_claims_to_one weights;
  5. the combined target and blind, the vector a and <a, d_vec>;
  6. the DotProductProof transcript: protocol-name, Cx = comm_poly, Cy,
     a (with its begin/end framing), delta (committed before the
     sumcheck), beta, then the challenge c;
  7. z = c coeffs + d_vec, z_delta, z_beta.

Buffers (int32, as in csrc/zk_round.cuh): evs (k, 3, 16); the transcript
state (202,); carry (3, 16): the claim and its commitment's 32 bytes;
tape (11, 16): blinds_poly[j], blinds_evals[j], the claim's blind, d_vec,
r_delta, r_beta, delta's 32 bytes; out (13, 16): comm_poly, comm_eval,
beta, z (4), z_delta, z_beta, r. `zk_round_tail` updates the state, carry
and out in place: K11 on CUDA tensors, `zk_round_tail_plain` on CPU
tensors.
"""

from __future__ import annotations

import torch

from ..core.consts import L
from . import fq, kernels
from . import limbs as lb
from . import ristretto_dev as rdev
from . import transcript_dev as tdev

TAPE_ROWS = 11
OUT_ROWS = 13
OUT_R = 12  # the row of r in out

_TWO_INV = fq.const(pow(2, -1, L))
_SIX_INV = fq.const(pow(6, -1, L))


def _consts(dev):
    return (lb.to_device(_TWO_INV, dev), lb.to_device(_SIX_INV, dev))


def coeffs_from_evals(e0, e1, e2, e3):
    """Cubic UniPoly::from_evals (unipoly.rs:23-55): (4, 16) Montgomery
    coefficients [d, c, b, a], constant first."""
    add, sub, mul = fq.add_plain, fq.sub_plain, fq.mul_plain
    two_inv, six_inv = _consts(e0.device)
    d = e0
    a = mul(six_inv, sub(add(sub(e3, add(add(e2, e2), e2)),
                             add(add(e1, e1), e1)), e0))
    b = mul(two_inv, sub(
        add(add(e0, e0), add(add(add(e2, e2), e2), e2)),
        add(add(add(add(add(e1, e1), e1), e1), e1), e3)))
    c = sub(sub(sub(e1, d), a), b)
    return torch.stack([d, c, b, a])


def poly_eval(coeffs, r):
    """Horner evaluation of (4, 16) coefficients at r."""
    acc = coeffs[3]
    for i in (2, 1, 0):
        acc = fq.add_plain(fq.mul_plain(acc, r), coeffs[i])
    return acc


def zk_round_tail_plain(evs, st, carry, tape, out, tab_n, tab_1) -> None:
    """The round tail in plain PyTorch (see the module docstring)."""
    add, mul = fq.add_plain, fq.mul_plain
    e = evs[0]
    for i in range(1, evs.shape[0]):
        e = add(e, evs[i])
    claim, comm_claim = carry[0], carry[1:].reshape(32)
    bp, be, bsc = tape[0], tape[1], tape[2]
    dv, rd, rb = tape[3:7], tape[7], tape[8]
    delta = tape[9:11].reshape(32)
    coeffs = coeffs_from_evals(e[0], fq.sub_plain(claim, e[0]), e[1], e[2])

    s = tdev.unpack(st)
    comm_poly = rdev.compress_plain(rdev.comb_commit_plain(
        tab_n, torch.cat([coeffs, bp[None]])))
    s = tdev.append_point(s, b"comm_poly", comm_poly)
    s, r = tdev.challenge_scalar(s, b"challenge_nextround")
    ev = poly_eval(coeffs, r)
    comm_eval = rdev.compress_plain(rdev.comb_commit_plain(
        tab_1, torch.stack([ev, be])))
    s = tdev.append_point(s, b"comm_claim_per_round", comm_claim)
    s = tdev.append_point(s, b"comm_eval", comm_eval)
    s, w0 = tdev.challenge_scalar(s, b"combine_two_claims_to_one")
    s, w1 = tdev.challenge_scalar(s, b"combine_two_claims_to_one")

    target = add(mul(w0, claim), mul(w1, ev))
    blind = add(mul(w0, bsc), mul(w1, be))
    r2 = mul(r, r)
    a = torch.stack([add(add(w0, w0), w1), add(w0, mul(w1, r)),
                     add(w0, mul(w1, r2)), add(w0, mul(w1, mul(r2, r)))])
    m = mul(a, dv)
    dp_ad = add(add(m[0], m[1]), add(m[2], m[3]))
    cy_beta = rdev.compress_plain(rdev.comb_commit_plain(
        tab_1, torch.stack([torch.stack([target, blind]),
                            torch.stack([dp_ad, rb])])))

    # DotProductProof::prove (nizk/mod.rs:305-358); Cx is comm_poly
    dev = st.device
    s = tdev.append_message(s, b"protocol-name",
                            tdev._bytes(b"dot product proof", dev))
    s = tdev.append_point(s, b"Cx", comm_poly)
    s = tdev.append_point(s, b"Cy", cy_beta[0])
    s = tdev.append_scalar_vector(s, b"a", a)
    s = tdev.append_point(s, b"delta", delta)
    s = tdev.append_point(s, b"beta", cy_beta[1])
    s, c = tdev.challenge_scalar(s, b"c")

    z = add(mul(c.expand(4, 16), coeffs), dv)
    out[0:2] = comm_poly.reshape(2, 16)
    out[2:4] = comm_eval.reshape(2, 16)
    out[4:6] = cy_beta[1].reshape(2, 16)
    out[6:10] = z
    out[10] = add(mul(c, bp), rd)
    out[11] = add(mul(c, blind), rb)
    out[OUT_R] = r
    carry[0] = ev
    carry[1:] = comm_eval.reshape(2, 16)
    tdev.pack(s, st)


def zk_round_tail(evs, st, carry, tape, out, tab_n, tab_1) -> None:
    """One round's tail: K11 on CUDA tensors (one block), the plain
    version on CPU tensors. Updates st, carry and out in place."""
    evs = evs.reshape(-1, 3, 16)
    if tab_n.shape[0] != 5 or tab_1.shape[0] != 2:
        raise ValueError("the round tail commits with 4 G + h and G + h")
    if st.shape != (tdev.STATE_LEN,) or carry.shape != (3, 16) or \
            tape.shape != (TAPE_ROWS, 16) or out.shape != (OUT_ROWS, 16):
        raise ValueError("round tail buffers have the wrong shapes")
    if evs.device.type == "cpu":
        zk_round_tail_plain(evs, st, carry, tape, out, tab_n, tab_1)
        return
    evs = evs.contiguous()
    for t in (st, carry, tape, out, tab_n, tab_1):
        if not t.is_contiguous():
            raise ValueError("round tail buffers must be contiguous")
    kernels.require_cuda(evs, st, carry, tape, out, tab_n, tab_1)
    kernels.launch("zk_round_tail", "zk_round_tail_launch", evs.data_ptr(),
                   evs.shape[0], st.data_ptr(), carry.data_ptr(),
                   tape.data_ptr(), out.data_ptr(), tab_n.data_ptr(),
                   tab_n.shape[0], tab_1.data_ptr(), kernels.stream(evs))
