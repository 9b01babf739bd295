"""Sigma protocols over Pedersen commitments + Bulletproofs reduction.

Mirrors the reference's proof systems and transcript schedules exactly
(src/nizk/mod.rs: KnowledgeProof:16, EqualityProof:78, ProductProof:146,
DotProductProof:292, DotProductProofLog:421; src/nizk/bullet.rs:16).

Host/device split: the sigma protocols themselves are constant-size
(host); on the card the bullet reduction's per-round L/R MSMs and generator
folds run as K2 kernels (ops/msm.py, ops/curve.fold_points) until the
vectors are short enough for the host; the verifier's G_hat runs as K2
above the commit threshold (commitments.host_msm_max)."""

from __future__ import annotations

import numpy as np
import torch

from ..core.consts import L as L_MOD
from ..core.edwards import RistrettoPoint, multiscalar_mul
from ..core.field import Scalar, batch_invert
from ..ops import curve, msm
from ..ops import limbs as lb
from ..utils.errors import ProofVerifyError
from .commitments import (
    MultiCommitGens,
    commit,
    commit_scalar,
    host_msm_max,
)


def _dot(a, b) -> Scalar:
    acc = 0
    for x, y in zip(a, b):
        acc += int(x) * int(y)
    return Scalar(acc)


def _log2(n: int) -> int:
    assert n & (n - 1) == 0 and n > 0
    return n.bit_length() - 1


class KnowledgeProof:
    __slots__ = ("alpha", "z1", "z2")

    def __init__(self, alpha, z1, z2):
        self.alpha, self.z1, self.z2 = alpha, z1, z2

    @staticmethod
    def prove(gens_n, transcript, random_tape, x: Scalar, r: Scalar):
        transcript.append_protocol_name(b"knowledge proof")
        t1 = random_tape.random_scalar(b"t1")
        t2 = random_tape.random_scalar(b"t2")
        C = commit_scalar(x, r, gens_n).compress()
        transcript.append_point(b"C", C)
        alpha = commit_scalar(t1, t2, gens_n).compress()
        transcript.append_point(b"alpha", alpha)
        c = transcript.challenge_scalar(b"c")
        return KnowledgeProof(alpha, x * c + t1, r * c + t2), C

    def verify(self, gens_n, transcript, C: bytes) -> None:
        transcript.append_protocol_name(b"knowledge proof")
        transcript.append_point(b"C", C)
        transcript.append_point(b"alpha", self.alpha)
        c = transcript.challenge_scalar(b"c")
        lhs = commit_scalar(self.z1, self.z2, gens_n)
        rhs = RistrettoPoint.decompress(C) * c + RistrettoPoint.decompress(self.alpha)
        if lhs != rhs:
            raise ProofVerifyError("knowledge proof failed")


class EqualityProof:
    __slots__ = ("alpha", "z")

    def __init__(self, alpha, z):
        self.alpha, self.z = alpha, z

    @staticmethod
    def prove(gens_n, transcript, random_tape, v1, s1, v2, s2):
        transcript.append_protocol_name(b"equality proof")
        r = random_tape.random_scalar(b"r")
        C1 = commit_scalar(v1, s1, gens_n).compress()
        transcript.append_point(b"C1", C1)
        C2 = commit_scalar(v2, s2, gens_n).compress()
        transcript.append_point(b"C2", C2)
        alpha = (gens_n.h * r).compress()
        transcript.append_point(b"alpha", alpha)
        c = transcript.challenge_scalar(b"c")
        z = c * (s1 - s2) + r
        return EqualityProof(alpha, z), C1, C2

    def verify(self, gens_n, transcript, C1: bytes, C2: bytes) -> None:
        transcript.append_protocol_name(b"equality proof")
        transcript.append_point(b"C1", C1)
        transcript.append_point(b"C2", C2)
        transcript.append_point(b"alpha", self.alpha)
        c = transcript.challenge_scalar(b"c")
        Cdiff = RistrettoPoint.decompress(C1) - RistrettoPoint.decompress(C2)
        rhs = Cdiff * c + RistrettoPoint.decompress(self.alpha)
        lhs = gens_n.h * self.z
        if lhs != rhs:
            raise ProofVerifyError("equality proof failed")


class ProductProof:
    __slots__ = ("alpha", "beta", "delta", "z")

    def __init__(self, alpha, beta, delta, z):
        self.alpha, self.beta, self.delta, self.z = alpha, beta, delta, z

    @staticmethod
    def prove(gens_n, transcript, random_tape, x, rX, y, rY, z, rZ):
        transcript.append_protocol_name(b"product proof")
        b1 = random_tape.random_scalar(b"b1")
        b2 = random_tape.random_scalar(b"b2")
        b3 = random_tape.random_scalar(b"b3")
        b4 = random_tape.random_scalar(b"b4")
        b5 = random_tape.random_scalar(b"b5")
        X = commit_scalar(x, rX, gens_n).compress()
        transcript.append_point(b"X", X)
        Y = commit_scalar(y, rY, gens_n).compress()
        transcript.append_point(b"Y", Y)
        Z = commit_scalar(z, rZ, gens_n).compress()
        transcript.append_point(b"Z", Z)
        alpha = commit_scalar(b1, b2, gens_n).compress()
        transcript.append_point(b"alpha", alpha)
        beta = commit_scalar(b3, b4, gens_n).compress()
        transcript.append_point(b"beta", beta)
        Xpt = RistrettoPoint.decompress(X)
        delta = (Xpt * b3 + gens_n.h * b5).compress()
        transcript.append_point(b"delta", delta)
        c = transcript.challenge_scalar(b"c")
        zs = [b1 + c * x, b2 + c * rX, b3 + c * y, b4 + c * rY, b5 + c * (rZ - rX * y)]
        return ProductProof(alpha, beta, delta, zs), X, Y, Z

    @staticmethod
    def _check(P: bytes, X: bytes, c, gens_n, z1, z2) -> bool:
        lhs = RistrettoPoint.decompress(P) + RistrettoPoint.decompress(X) * c
        return lhs == commit_scalar(z1, z2, gens_n)

    def verify(self, gens_n, transcript, X: bytes, Y: bytes, Z: bytes) -> None:
        transcript.append_protocol_name(b"product proof")
        transcript.append_point(b"X", X)
        transcript.append_point(b"Y", Y)
        transcript.append_point(b"Z", Z)
        transcript.append_point(b"alpha", self.alpha)
        transcript.append_point(b"beta", self.beta)
        transcript.append_point(b"delta", self.delta)
        z1, z2, z3, z4, z5 = self.z
        c = transcript.challenge_scalar(b"c")
        ok = (
            ProductProof._check(self.alpha, X, c, gens_n, z1, z2)
            and ProductProof._check(self.beta, Y, c, gens_n, z3, z4)
            and RistrettoPoint.decompress(self.delta)
            + RistrettoPoint.decompress(Z) * c
            == RistrettoPoint.decompress(X) * z3 + gens_n.h * z5
        )
        if not ok:
            raise ProofVerifyError("product proof failed")


class DotProductProof:
    """Linear-size dot product proof (nizk/mod.rs:292). Used with n = 4 per
    ZK sumcheck round, so this is a pure host object."""

    __slots__ = ("delta", "beta", "z", "z_delta", "z_beta")

    def __init__(self, delta, beta, z, z_delta, z_beta):
        self.delta, self.beta = delta, beta
        self.z, self.z_delta, self.z_beta = z, z_delta, z_beta

    @staticmethod
    def prove(gens_1, gens_n, transcript, random_tape, x_vec, blind_x, a_vec, y, blind_y):
        transcript.append_protocol_name(b"dot product proof")
        n = len(x_vec)
        assert len(a_vec) == n and gens_n.n == n and gens_1.n == 1
        d_vec = random_tape.random_vector(b"d_vec", n)
        r_delta = random_tape.random_scalar(b"r_delta")
        r_beta = random_tape.random_scalar(b"r_beta")
        Cx = commit(x_vec, blind_x, gens_n).compress()
        transcript.append_point(b"Cx", Cx)
        Cy = commit_scalar(y, blind_y, gens_1).compress()
        transcript.append_point(b"Cy", Cy)
        transcript.append_scalar_vector(b"a", a_vec)
        delta = commit(d_vec, r_delta, gens_n).compress()
        transcript.append_point(b"delta", delta)
        dp_ad = _dot(a_vec, d_vec)
        beta = commit_scalar(dp_ad, r_beta, gens_1).compress()
        transcript.append_point(b"beta", beta)
        c = transcript.challenge_scalar(b"c")
        z = [c * x_vec[i] + d_vec[i] for i in range(n)]
        return (
            DotProductProof(delta, beta, z, c * blind_x + r_delta, c * blind_y + r_beta),
            Cx,
            Cy,
        )

    def verify(self, gens_1, gens_n, transcript, a_vec, Cx: bytes, Cy: bytes) -> None:
        assert gens_n.n == len(a_vec) and gens_1.n == 1
        transcript.append_protocol_name(b"dot product proof")
        transcript.append_point(b"Cx", Cx)
        transcript.append_point(b"Cy", Cy)
        transcript.append_scalar_vector(b"a", a_vec)
        transcript.append_point(b"delta", self.delta)
        transcript.append_point(b"beta", self.beta)
        c = transcript.challenge_scalar(b"c")
        ok = RistrettoPoint.decompress(Cx) * c + RistrettoPoint.decompress(
            self.delta
        ) == commit(self.z, self.z_delta, gens_n)
        dp_za = _dot(self.z, a_vec)
        ok = ok and (
            RistrettoPoint.decompress(Cy) * c + RistrettoPoint.decompress(self.beta)
            == commit_scalar(dp_za, self.z_beta, gens_1)
        )
        if not ok:
            raise ProofVerifyError("dot product proof failed")


class DotProductProofGens:
    __slots__ = ("n", "gens_n", "gens_1")

    def __init__(self, n: int, label: bytes):
        gens = MultiCommitGens(n + 1, label)
        self.gens_n, self.gens_1 = gens.split_at(n)
        self.n = n


class BulletReductionProof:
    """Bulletproofs inner-product reduction (nizk/bullet.rs:16).

    Prover state: scalar vectors a, b live on the host (object ints, the
    folds are trivial); the generator vector lives on the device, folded
    per round with a batched uniform-scalar ladder, and L/R are device
    Pippenger MSMs."""

    __slots__ = ("L_vec", "R_vec")

    def __init__(self, L_vec, R_vec):
        self.L_vec, self.R_vec = L_vec, R_vec

    @staticmethod
    def prove(transcript, Q: RistrettoPoint, G_list, H: RistrettoPoint,
              a_vec, b_vec, blind: Scalar, blinds_vec, device=None):
        """device: where the generator vector is folded. None, or a
        vector no longer than bullet_host_max(device), keeps everything on
        the host; otherwise the L/R MSMs and the folds run as kernels until
        the vector is 32 long, and the host finishes."""
        n = len(G_list)
        assert n & (n - 1) == 0
        lg_n = _log2(n)
        assert len(blinds_vec) == 2 * lg_n
        a = np.array([int(x) for x in a_vec], dtype=object)
        b = np.array([int(x) for x in b_vec], dtype=object)
        host = device is None or n <= bullet_host_max(device)
        G_host = list(G_list)
        G_dev = None
        if not host and n > 1:
            G_dev = lb.to_device(curve.encode_points(G_host), device)
        QH_dev = None if host else lb.to_device(
            curve.encode_points([Q, H]), device)
        L_vec, R_vec = [], []
        blind_fin = int(blind)
        blind_iter = iter(blinds_vec)
        while n != 1:
            n //= 2
            aL, aR = a[:n], a[n:]
            bL, bR = b[:n], b[n:]
            c_L = int(_dot(aL, bR))
            c_R = int(_dot(aR, bL))
            blind_L, blind_R = next(blind_iter)
            if host:
                GL, GR = G_host[:n], G_host[n:]
                L = multiscalar_mul(
                    list(aL) + [c_L, int(blind_L)], GR + [Q, H])
                R = multiscalar_mul(
                    list(aR) + [c_R, int(blind_R)], GL + [Q, H])
            else:
                GL_dev, GR_dev = G_dev[:n], G_dev[n:]
                L = _msm_with_qh(aL, c_L, blind_L, GR_dev, QH_dev)
                R = _msm_with_qh(aR, c_R, blind_R, GL_dev, QH_dev)
            transcript.append_point(b"L", L)
            transcript.append_point(b"R", R)
            u = transcript.challenge_scalar(b"u")
            u_inv = u.invert()
            a = (int(u) * aL + int(u_inv) * aR) % L_MOD
            b = (int(u_inv) * bL + int(u) * bR) % L_MOD
            if host:
                G_host = [gl * u_inv + gr * u for gl, gr in zip(GL, GR)]
            else:
                G_dev = curve.fold_points(GL_dev, GR_dev, int(u_inv), int(u))
                if n <= 32:
                    # finish the tail on the host
                    G_host = curve.decode_points(G_dev)
                    G_dev = None
                    host = True
            blind_fin = (
                blind_fin + int(blind_L) * int(u) ** 2 + int(blind_R) * int(u_inv) ** 2
            ) % L_MOD
            L_vec.append(L.compress())
            R_vec.append(R.compress())
        G_final = G_host[0]
        a0, b0 = Scalar(int(a[0])), Scalar(int(b[0]))
        Gamma_hat = G_final * a0 + Q * (a0 * b0) + H * blind_fin
        return (
            BulletReductionProof(L_vec, R_vec),
            Gamma_hat,
            a0,
            b0,
            G_final,
            Scalar(blind_fin),
        )

    def verification_scalars(self, n: int, transcript):
        lg_n = len(self.L_vec)
        if lg_n >= 32 or n != (1 << lg_n):
            raise ProofVerifyError("bullet: bad length")
        challenges = []
        for Lc, Rc in zip(self.L_vec, self.R_vec):
            transcript.append_point(b"L", Lc)
            transcript.append_point(b"R", Rc)
            challenges.append(transcript.challenge_scalar(b"u"))
        challenges_inv = batch_invert(challenges)
        allinv = Scalar(1)
        for ci in challenges_inv:
            allinv = allinv * ci
        chal_sq = [c.square() for c in challenges]
        chal_inv_sq = [c.square() for c in challenges_inv]
        s = [allinv]
        for i in range(1, n):
            lg_i = i.bit_length() - 1
            k = 1 << lg_i
            u_lg_i_sq = chal_sq[(lg_n - 1) - lg_i]
            s.append(s[i - k] * u_lg_i_sq)
        return chal_sq, chal_inv_sq, s

    def verify(self, n: int, a_vec, transcript, Gamma: RistrettoPoint,
               gens_n: MultiCommitGens, device=None):
        """G_hat = <s, gens_n.G[:n]>. With a `device` and n above
        max(32, host_msm_max(device)) it is K2 (ops/msm.py msm_single) on
        the generators' copy on that device, as the JAX package's device
        MSM above its threshold; otherwise the host multiscalar_mul. The
        result is the same point either way."""
        u_sq, u_inv_sq, s = self.verification_scalars(n, transcript)
        Ls = [RistrettoPoint.decompress(p) for p in self.L_vec]
        Rs = [RistrettoPoint.decompress(p) for p in self.R_vec]
        if device is not None and \
                n > max(32, host_msm_max(torch.device(device))):
            G_dev = gens_n.device_points(device)[:n]
            G_hat = msm.msm_single(G_dev, curve.scalar_limbs(s, device))
        else:
            G_hat = multiscalar_mul(s, gens_n.G[:n])
        a_hat = _dot(a_vec, s)
        Gamma_hat = multiscalar_mul(
            u_sq + u_inv_sq + [Scalar(1)], Ls + Rs + [Gamma]
        )
        return G_hat, Gamma_hat, a_hat


def bullet_host_max(device) -> int:
    """Longest generator vector the bullet prover folds on the host. On
    the card the device path takes any vector longer than 32 (the JAX
    package's tail length); on the CPU the host takes the Hyrax sizes."""
    return 32 if torch.device(device).type == "cuda" else 1024


def _msm_with_qh(a_half, c, blind, G_half_dev, QH_dev):
    """MSM of <a_half, G_half> + c*Q + blind*H on device."""
    scal = list(a_half) + [int(c), int(blind)]
    pts = torch.cat([G_half_dev, QH_dev])
    return msm.msm_single(pts, curve.scalar_limbs(scal, pts.device))


class DotProductProofLog:
    """Log-size dot product proof (nizk/mod.rs:421)."""

    __slots__ = ("bullet_reduction_proof", "delta", "beta", "z1", "z2")

    def __init__(self, brp, delta, beta, z1, z2):
        self.bullet_reduction_proof = brp
        self.delta, self.beta, self.z1, self.z2 = delta, beta, z1, z2

    @staticmethod
    def prove(gens: DotProductProofGens, transcript, random_tape,
              x_vec, blind_x, a_vec, y, blind_y, device=None):
        transcript.append_protocol_name(b"dot product proof (log)")
        n = len(x_vec)
        assert len(a_vec) == n and gens.n >= n
        d = random_tape.random_scalar(b"d")
        r_delta = random_tape.random_scalar(b"r_delta")
        # NB: the reference reuses the label "r_delta" for r_beta
        # (nizk/mod.rs:458) — kept for transcript compatibility.
        r_beta = random_tape.random_scalar(b"r_delta")
        lg_n = _log2(n)
        v1 = random_tape.random_vector(b"blinds_vec_1", 2 * lg_n)
        v2 = random_tape.random_vector(b"blinds_vec_2", 2 * lg_n)
        blinds_vec = list(zip(v1, v2))
        Cx = commit(x_vec, blind_x, gens.gens_n).compress()
        transcript.append_point(b"Cx", Cx)
        Cy = commit_scalar(y, blind_y, gens.gens_1).compress()
        transcript.append_point(b"Cy", Cy)
        transcript.append_scalar_vector(b"a", a_vec)
        r = transcript.challenge_scalar(b"r")
        gens_1_scaled = gens.gens_1.scale(r)
        blind_Gamma = blind_x + r * blind_y
        (brp, _Gamma_hat, x_hat, a_hat, g_hat, rhat_Gamma) = BulletReductionProof.prove(
            transcript,
            gens_1_scaled.G[0],
            gens.gens_n.G[:n],
            gens.gens_n.h,
            x_vec,
            a_vec,
            blind_Gamma,
            blinds_vec,
            device=device,
        )
        y_hat = x_hat * a_hat
        delta = (g_hat * d + gens.gens_1.h * r_delta).compress()
        transcript.append_point(b"delta", delta)
        beta = commit_scalar(d, r_beta, gens_1_scaled).compress()
        transcript.append_point(b"beta", beta)
        c = transcript.challenge_scalar(b"c")
        z1 = d + c * y_hat
        z2 = a_hat * (c * rhat_Gamma + r_beta) + r_delta
        return DotProductProofLog(brp, delta, beta, z1, z2), Cx, Cy

    def verify(self, n, gens: DotProductProofGens, transcript, a_vec,
               Cx: bytes, Cy: bytes, device=None) -> None:
        """device: where the bullet reduction's G_hat may run (see
        BulletReductionProof.verify); None keeps it on the host."""
        assert gens.n >= n and len(a_vec) == n
        transcript.append_protocol_name(b"dot product proof (log)")
        transcript.append_point(b"Cx", Cx)
        transcript.append_point(b"Cy", Cy)
        transcript.append_scalar_vector(b"a", a_vec)
        r = transcript.challenge_scalar(b"r")
        gens_1_scaled = gens.gens_1.scale(r)
        Gamma = RistrettoPoint.decompress(Cx) + RistrettoPoint.decompress(Cy) * r
        g_hat, Gamma_hat, a_hat = self.bullet_reduction_proof.verify(
            n, a_vec, transcript, Gamma, gens.gens_n, device)
        transcript.append_point(b"delta", self.delta)
        transcript.append_point(b"beta", self.beta)
        c = transcript.challenge_scalar(b"c")
        beta_pt = RistrettoPoint.decompress(self.beta)
        delta_pt = RistrettoPoint.decompress(self.delta)
        lhs = (Gamma_hat * c + beta_pt) * a_hat + delta_pt
        rhs = (g_hat + gens_1_scaled.G[0] * a_hat) * self.z1 + gens_1_scaled.h * self.z2
        if lhs != rhs:
            raise ProofVerifyError("dot product proof (log) failed")
