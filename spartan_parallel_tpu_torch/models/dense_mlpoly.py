"""Dense multilinear polynomials + the Hyrax-style PCS.

Reference: src/dense_mlpoly.rs (DensePolynomial:20, EqPolynomial:60,
IdentityPolynomial:133, PolyCommitment:45, PolyEvalProof:428). The
protocol schedule (transcript labels, L/R factoring, batched-opening RLC)
is the JAX package's, byte for byte; the tensors are PyTorch:

  * evaluation tables are (n, 16) int32 Montgomery limb tensors on the
    caller's device (ops/fq.py, K1);
  * the eq table is one K1 launch (csrc/fq.cu k_eq_evals);
  * Hyrax row commitments are one batched MSM (K2) of all sqrt(N) rows;
  * the L*Z row contraction and evaluations are K1 dot reductions;
  * tables read as univariate coefficients (ShiftProofs) are evaluated
    at a point in one K7 launch.
"""

from __future__ import annotations

import torch

from ..core.edwards import RistrettoPoint, multiscalar_mul
from ..core.field import Scalar
from ..ops import fq, kernels
from ..ops import limbs as lb
from ..ops.uni import uni_eval_many
from ..utils.errors import ProofVerifyError
from .commitments import commit_rows_device, commit_scalar
from .sigma import DotProductProofGens, DotProductProofLog

_ZERO = Scalar.zero()
_ONE = Scalar.one()


def log2(n: int) -> int:
    assert n > 0 and n & (n - 1) == 0, f"not a power of 2: {n}"
    return n.bit_length() - 1


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------
# Host <-> device scalar codecs
# --------------------------------------------------------------------------
def scalars_to_mont(values, device) -> torch.Tensor:
    """list of Scalar/int -> (n, 16) Montgomery tensor on `device`. Bulk
    inputs are R-scaled on the device (one product by R^2); short ones
    (per-round challenges) on the host."""
    vals = values if isinstance(values, list) else list(values)
    if len(vals) < 64:
        return lb.to_device(fq.encode(vals), device)
    return fq.encode_to_device(vals, device)


def mont_to_scalars(a: torch.Tensor) -> list:
    """(..., 16) Montgomery tensor -> flat list of Scalar."""
    return [Scalar(v) for v in fq.decode(a.reshape(-1, 16))]


def mont_to_scalar(a: torch.Tensor) -> Scalar:
    return mont_to_scalars(a)[0]


# --------------------------------------------------------------------------
# Eq polynomial
# --------------------------------------------------------------------------
def eq_evals_plain(r_mont: torch.Tensor, ell: int) -> torch.Tensor:
    """The plain version of eq_evals from K1's plain versions (the JAX
    package's build): doubling up to 2^13 entries, above that the product
    of the tables of the high and the low half of the variables."""
    def doubling(r, k):
        tab = lb.to_device(fq.ONE_MONT, r.device)[None]
        for j in range(k):
            hi = fq.mul_plain(tab, r[j])
            tab = torch.stack([fq.sub_plain(tab, hi), hi], 1).reshape(-1, 16)
        return tab

    if ell <= 13:
        return doubling(r_mont, ell)
    half = ell // 2
    return fq.mul_plain(doubling(r_mont[:half], half)[:, None],
                        doubling(r_mont[half:], ell - half)[None]
                        ).reshape(-1, 16)


def eq_evals(r_mont: torch.Tensor, ell: int) -> torch.Tensor:
    """(ell, 16) Montgomery challenges -> (2^ell, 16) eq table
    (dense_mlpoly.rs:76-91; the index's MSB is r[0]). On the card one K1
    launch for any ell >= 1 (csrc/fq.cu k_eq_evals, counted as eq_evals);
    CPU challenges take eq_evals_plain."""
    fq._check_limbs(r_mont)
    if r_mont.device.type == "cpu":
        return eq_evals_plain(r_mont, ell)
    if ell == 0:
        return lb.to_device(fq.ONE_MONT, r_mont.device)[None]
    if ell > 41:  # the grid's 2^31 chunks of 2^10 entries
        raise ValueError(f"an eq table of 2^{ell} entries")
    r_mont = r_mont[:ell].contiguous()
    kernels.require_cuda(r_mont)
    out = torch.empty((1 << ell, 16), dtype=torch.int32,
                      device=r_mont.device)
    kernels.launch("eq_evals", "eq_evals_launch", r_mont.data_ptr(), ell,
                   out.data_ptr(), kernels.stream(r_mont))
    return out


class EqPolynomial:
    """eq(r, x) over the boolean hypercube (dense_mlpoly.rs:60-131)."""

    def __init__(self, r):
        self.r = list(r)

    def evaluate(self, rx) -> Scalar:
        assert len(self.r) == len(rx)
        prod = _ONE
        for a, b in zip(self.r, rx):
            prod = prod * (a * b + (_ONE - a) * (_ONE - b))
        return prod

    def evals_dev(self, device) -> torch.Tensor:
        """(2^ell, 16) Montgomery table on `device`."""
        if not self.r:
            return lb.to_device(fq.ONE_MONT, device)[None]
        return eq_evals(scalars_to_mont(self.r, device), len(self.r))

    def evals(self, device) -> list:
        """Host list of Scalar (small ell), built on `device`."""
        return mont_to_scalars(self.evals_dev(device))

    @staticmethod
    def compute_factored_lens(ell: int):
        return ell // 2, ell - ell // 2

    def compute_factored_evals(self, device):
        left, _ = EqPolynomial.compute_factored_lens(len(self.r))
        return (
            EqPolynomial(self.r[:left]).evals(device),
            EqPolynomial(self.r[left:]).evals(device),
        )


def uni_evaluate_many(polys, c: Scalar) -> list:
    """The table of each polynomial read as univariate coefficients,
    evaluated at c (the ShiftProofs trick, lib.rs:390-419): one K7 launch
    for every table (ops/uni.py uni_eval_many, counted as uni_evaluate)
    and one read to the host."""
    if not polys:
        return []
    return mont_to_scalars(uni_eval_many([p.Zm for p in polys], int(c)))


def uni_evaluate(poly: "DensePolynomial", c: Scalar) -> Scalar:
    """uni_evaluate_many of one polynomial."""
    return uni_evaluate_many([poly], c)[0]


class IdentityPolynomial:
    """Evaluates to the integer index (dense_mlpoly.rs:133-152)."""

    def __init__(self, size_point: int):
        self.size_point = size_point

    def evaluate(self, r) -> Scalar:
        assert len(r) == self.size_point
        acc = _ZERO
        n = len(r)
        for i, ri in enumerate(r):
            acc = acc + Scalar(1 << (n - i - 1)) * ri
        return acc


# --------------------------------------------------------------------------
# DensePolynomial
# --------------------------------------------------------------------------
class DensePolynomial:
    """Evaluation-form multilinear polynomial on a device (reference:
    dense_mlpoly.rs:20)."""

    __slots__ = ("Zm", "num_vars")

    def __init__(self, Zm: torch.Tensor):
        n = Zm.shape[0]
        pad = next_pow2(n) - n
        if pad:
            Zm = torch.cat([Zm, torch.zeros((pad, 16), dtype=torch.int32,
                                            device=Zm.device)])
        self.Zm = Zm
        self.num_vars = log2(Zm.shape[0])

    @staticmethod
    def from_scalars(values, device) -> "DensePolynomial":
        return DensePolynomial(scalars_to_mont(values, device))

    def __len__(self) -> int:
        return self.Zm.shape[0]

    def get_num_vars(self) -> int:
        return self.num_vars

    def clone(self) -> "DensePolynomial":
        return DensePolynomial(self.Zm)

    def __getitem__(self, i: int) -> Scalar:
        return mont_to_scalar(self.Zm[i])

    def to_scalars(self) -> list:
        return mont_to_scalars(self.Zm)

    def split(self, idx: int):
        return (DensePolynomial(self.Zm[:idx]),
                DensePolynomial(self.Zm[idx:2 * idx]))

    def bound_poly_var_top(self, r: Scalar) -> None:
        """Bind the first variable (the table's halves) to r (K1)."""
        h = len(self) // 2
        rm = scalars_to_mont([r], self.Zm.device)[0]
        self.Zm = fq.bind(self.Zm, rm, 0, h, h)
        self.num_vars -= 1

    def bound_poly_var_bot(self, r: Scalar) -> None:
        """Bind the last variable (adjacent pairs) to r (K1)."""
        rm = scalars_to_mont([r], self.Zm.device)[0]
        pairs = self.Zm.reshape(-1, 2, 16)
        self.Zm = fq.bind(pairs, rm, 1, 1, 1).reshape(-1, 16)
        self.num_vars -= 1

    def extend(self, other: "DensePolynomial") -> None:
        assert len(self) == len(other)
        self.Zm = torch.cat([self.Zm, other.Zm])
        self.num_vars += 1

    @staticmethod
    def merge(polys) -> "DensePolynomial":
        return DensePolynomial(torch.cat([p.Zm for p in polys]))

    def bound(self, L) -> torch.Tensor:
        """L*Z vector-matrix product -> (R_size, 16) Montgomery
        (dense_mlpoly.rs:258-265)."""
        if isinstance(L, (list, tuple)):
            L = scalars_to_mont(L, self.Zm.device)
        ls = L.shape[0]
        return fq.dot(self.Zm.reshape(ls, -1, 16), L[:, None], axis=0)

    def evaluate(self, r) -> Scalar:
        assert len(r) == self.num_vars
        chis = EqPolynomial(r).evals_dev(self.Zm.device)
        return mont_to_scalar(fq.dot(self.Zm, chis, axis=0))

    # --- Hyrax commitment (dense_mlpoly.rs:153-257) ----------------------
    def commit(self, gens: "PolyCommitmentGens", random_tape=None):
        left, _ = EqPolynomial.compute_factored_lens(self.num_vars)
        L_size = 1 << left
        if random_tape is not None:
            blinds = PolyCommitmentBlinds(
                random_tape.random_vector(b"poly_blinds", L_size))
        else:
            blinds = PolyCommitmentBlinds([_ZERO] * L_size)
        return self.commit_with_blind(gens, blinds), blinds

    def commit_with_blind(self, gens: "PolyCommitmentGens", blinds):
        L_size = len(blinds.blinds)
        rows = self.Zm.reshape(L_size, len(self) // L_size, 16)
        pts = commit_rows_device(rows, blinds.blinds, gens.gens.gens_n)
        return PolyCommitment([p.compress() for p in pts])


class PolyCommitmentGens:
    """gens for sqrt(N)-row Hyrax commitments (dense_mlpoly.rs:26-38)."""

    __slots__ = ("gens",)

    def __init__(self, num_vars: int, label: bytes):
        _, right = EqPolynomial.compute_factored_lens(num_vars)
        self.gens = DotProductProofGens(1 << right, label)


class PolyCommitmentBlinds:
    __slots__ = ("blinds",)

    def __init__(self, blinds):
        self.blinds = list(blinds)


class PolyCommitment:
    __slots__ = ("C",)

    def __init__(self, C):
        self.C = list(C)  # list of 32-byte compressed points

    @staticmethod
    def empty() -> "PolyCommitment":
        return PolyCommitment([])

    def append_to_transcript(self, label: bytes, transcript) -> None:
        # dense_mlpoly.rs:412-420
        transcript.append_message(label, b"poly_commitment_begin")
        for c in self.C:
            transcript.append_point(b"poly_commitment_share", c)
        transcript.append_message(label, b"poly_commitment_end")

    def decompress(self):
        return [RistrettoPoint.decompress(c) for c in self.C]


# --------------------------------------------------------------------------
# PolyEvalProof
# --------------------------------------------------------------------------
def _lz_blind(blinds, L) -> Scalar:
    acc = _ZERO
    for b, l in zip(blinds, L):
        acc = acc + b * l
    return acc


class PolyEvalProof:
    """Hyrax opening: L*Z reduction + log-size dot-product proof
    (dense_mlpoly.rs:428-530) and the fork's batched variants: one poly at
    many points (:531), instances at their own points (:689), instances
    as univariates at one point (:1046), instances over disjoint rounds
    (:861-1044)."""

    __slots__ = ("proof",)

    def __init__(self, proof: DotProductProofLog):
        self.proof = proof

    @staticmethod
    def protocol_name() -> bytes:
        return b"polynomial evaluation proof"

    @staticmethod
    def prove(poly: DensePolynomial, blinds_opt, r, Zr: Scalar, blind_Zr_opt,
              gens: PolyCommitmentGens, transcript, random_tape):
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        assert poly.get_num_vars() == len(r)
        left, _ = EqPolynomial.compute_factored_lens(len(r))
        L_size = 1 << left
        blinds = blinds_opt if blinds_opt is not None else \
            PolyCommitmentBlinds([_ZERO] * L_size)
        assert len(blinds.blinds) == L_size
        blind_Zr = blind_Zr_opt if blind_Zr_opt is not None else _ZERO

        L, R = EqPolynomial(list(r)).compute_factored_evals(poly.Zm.device)
        LZ = mont_to_scalars(poly.bound(L))
        LZ_blind = _lz_blind(blinds.blinds, L)

        proof, _C_LR, C_Zr_prime = DotProductProofLog.prove(
            gens.gens, transcript, random_tape, LZ, LZ_blind, R, Zr,
            blind_Zr, device=poly.Zm.device)
        return PolyEvalProof(proof), C_Zr_prime

    def verify(self, gens: PolyCommitmentGens, transcript, r, C_Zr: bytes,
               comm: PolyCommitment, device) -> None:
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        L, R = EqPolynomial(list(r)).compute_factored_evals(device)
        C_LZ = multiscalar_mul(L, comm.decompress()).compress()
        self.proof.verify(len(R), gens.gens, transcript, R, C_LZ, C_Zr,
                          device)

    def verify_plain(self, gens: PolyCommitmentGens, transcript, r,
                     Zr: Scalar, comm: PolyCommitment, device) -> None:
        """verify against a plain evaluation Zr (committed with a zero
        blind)."""
        C_Zr = commit_scalar(Zr, _ZERO, gens.gens.gens_1).compress()
        self.verify(gens, transcript, r, C_Zr, comm, device)

    # --- batched points: one poly at many points (dense_mlpoly.rs:531) ---
    # Points that share their left half share an L*Z row; their R vectors
    # and claims fold in by powers of one challenge.
    @staticmethod
    def _group_points(transcript, r_list, Zr_list, device):
        left, _ = EqPolynomial.compute_factored_lens(len(r_list[0]))
        index_map = {}
        L_list, R_list, Zc_list = [], [], []
        c_base = transcript.challenge_scalar(b"challenge_c")
        c = _ONE
        for i, r in enumerate(r_list):
            L, R = EqPolynomial(list(r)).compute_factored_evals(device)
            key = tuple(int(x) for x in r[:left])
            if key in index_map:
                c = c * c_base
                idx = index_map[key]
                R_list[idx] = [a + c * b for a, b in zip(R_list[idx], R)]
                Zc_list[idx] = Zc_list[idx] + c * Zr_list[i]
            else:
                index_map[key] = len(L_list)
                L_list.append(L)
                R_list.append(R)
                Zc_list.append(Zr_list[i])
        return L_list, R_list, Zc_list

    @staticmethod
    def prove_batched_points(poly, blinds_opt, r_list, Zr_list,
                             blind_Zr_opt, gens, transcript, random_tape):
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        assert len(r_list) == len(Zr_list)
        for r in r_list:
            assert poly.get_num_vars() == len(r)
        left, _ = EqPolynomial.compute_factored_lens(len(r_list[0]))
        L_size = 1 << left
        blinds = blinds_opt if blinds_opt is not None else \
            PolyCommitmentBlinds([_ZERO] * L_size)
        assert len(blinds.blinds) == L_size
        blind_Zr = blind_Zr_opt if blind_Zr_opt is not None else _ZERO
        dev = poly.Zm.device
        L_list, R_list, Zc_list = PolyEvalProof._group_points(
            transcript, r_list, Zr_list, dev)
        proofs = []
        for L, R, Zc in zip(L_list, R_list, Zc_list):
            proof, _, _ = DotProductProofLog.prove(
                gens.gens, transcript, random_tape,
                mont_to_scalars(poly.bound(L)), _lz_blind(blinds.blinds, L),
                R, Zc, blind_Zr, device=dev)
            proofs.append(PolyEvalProof(proof))
        return proofs

    @staticmethod
    def verify_plain_batched_points(proof_list, gens, transcript, r_list,
                                    Zr_list, comm, device):
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        L_list, R_list, Zc_list = PolyEvalProof._group_points(
            transcript, r_list, Zr_list, device)
        if len(L_list) != len(proof_list):
            raise ProofVerifyError("expected one opening per left half")
        pts = comm.decompress()
        for proof, L, R, Zc in zip(proof_list, L_list, R_list, Zc_list):
            C_Zc = commit_scalar(Zc, _ZERO, gens.gens.gens_1).compress()
            C_LZ = multiscalar_mul(L, pts).compress()
            proof.proof.verify(len(R), gens.gens, transcript, R, C_LZ, C_Zc,
                               device)

    # --- batched instances, each at its own point (dense_mlpoly.rs:689) --
    @staticmethod
    def _fit_point(r, num_vars: int):
        """The point cut or zero-padded in front to num_vars variables."""
        r = list(r)
        if num_vars >= len(r):
            return [_ZERO] * (num_vars - len(r)) + r
        return r[len(r) - num_vars:]

    @staticmethod
    def prove_batched_instances(poly_list, blinds_opt, r_list, Zr_list,
                                blind_Zr_opt, gens, transcript, random_tape):
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        assert len(poly_list) == len(r_list) == len(Zr_list)
        index_map = {}
        LZ_list, Zc_list, L_list, R_list = [], [], [], []
        c_base = transcript.challenge_scalar(b"challenge_c")
        c = _ONE
        for i, poly in enumerate(poly_list):
            num_vars = poly.get_num_vars()
            r = PolyEvalProof._fit_point(r_list[i], num_vars)
            L, R = EqPolynomial(r).compute_factored_evals(poly.Zm.device)
            key = (num_vars, tuple(int(x) for x in R))
            if key in index_map:
                c = c * c_base
                idx = index_map[key]
                LZ = poly.bound(L)
                cm = scalars_to_mont([c], LZ.device)[0]
                LZ_list[idx] = fq.add(LZ_list[idx], fq.mul(LZ, cm))
                Zc_list[idx] = Zc_list[idx] + c * Zr_list[i]
            else:
                index_map[key] = len(LZ_list)
                LZ_list.append(poly.bound(L))
                Zc_list.append(Zr_list[i])
                L_list.append(L)
                R_list.append(R)

        proofs = []
        blind_Zr = blind_Zr_opt if blind_Zr_opt is not None else _ZERO
        for i in range(len(LZ_list)):
            L = L_list[i]
            blinds = blinds_opt if blinds_opt is not None else \
                PolyCommitmentBlinds([_ZERO] * len(L))
            assert len(blinds.blinds) == len(L)
            proof, _, _ = DotProductProofLog.prove(
                gens.gens, transcript, random_tape,
                mont_to_scalars(LZ_list[i]), _lz_blind(blinds.blinds, L),
                R_list[i], Zc_list[i], blind_Zr, device=LZ_list[i].device)
            proofs.append(PolyEvalProof(proof))
        return proofs

    @staticmethod
    def verify_plain_batched_instances(proof_list, gens, transcript, r_list,
                                       Zr_list, comm_list, num_vars_list,
                                       device):
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        assert len(comm_list) == len(r_list)
        index_map = {}
        LZ_list, Zc_list, R_list = [], [], []
        c_base = transcript.challenge_scalar(b"challenge_c")
        c = _ONE
        for i, comm in enumerate(comm_list):
            pts = comm.decompress()
            num_vars = num_vars_list[i]
            r = PolyEvalProof._fit_point(r_list[i], num_vars)
            L, R = EqPolynomial(r).compute_factored_evals(device)
            key = (num_vars, tuple(int(x) for x in R))
            if key in index_map:
                c = c * c_base
                idx = index_map[key]
                LZ_list[idx] = LZ_list[idx] + \
                    multiscalar_mul(L[: len(pts)], pts) * c
                Zc_list[idx] = Zc_list[idx] + c * Zr_list[i]
            else:
                index_map[key] = len(LZ_list)
                LZ_list.append(multiscalar_mul(L[: len(pts)], pts))
                Zc_list.append(Zr_list[i])
                R_list.append(R)
        if len(LZ_list) != len(proof_list):
            raise ProofVerifyError("expected one opening per size class")
        for proof, LZ, Zc, R in zip(proof_list, LZ_list, Zc_list, R_list):
            C_Zc = commit_scalar(Zc, _ZERO, gens.gens.gens_1).compress()
            proof.proof.verify(len(R), gens.gens, transcript, R,
                               LZ.compress(), C_Zc, device)

    # --- univariate batched openings at one scalar (dense_mlpoly.rs:1046) -
    # A table of 2^num_vars coefficients is a (2^left, 2^right) matrix:
    # its value at r is L Z R with R = (1, r, ..., r^(2^right - 1)) and
    # L = (1, r^(2^right), r^(2 * 2^right), ...). Both are host loops of at
    # most 2^right entries, as in the JAX package.
    @staticmethod
    def _uni_powers(r: Scalar, n: int) -> list:
        out, x = [], _ONE
        for _ in range(n):
            out.append(x)
            x = x * r
        return out

    @staticmethod
    def _uni_L(r: Scalar, num_vars: int) -> list:
        left_nv, right_nv = EqPolynomial.compute_factored_lens(num_vars)
        rb = _ONE
        for _ in range(1 << right_nv):
            rb = rb * r
        return PolyEvalProof._uni_powers(rb, 1 << left_nv)

    @staticmethod
    def prove_uni_batched_instances(poly_list, r: Scalar, Zr_list, gens,
                                    transcript, random_tape):
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        max_num_vars = max(p.get_num_vars() for p in poly_list)
        _, right = EqPolynomial.compute_factored_lens(max_num_vars)
        R_size = 1 << right
        R = PolyEvalProof._uni_powers(r, R_size)

        dev = poly_list[0].Zm.device
        L_map = {}
        c_base = transcript.challenge_scalar(b"challenge_c")
        c = _ONE
        LZ_comb = torch.zeros((R_size, 16), dtype=torch.int32, device=dev)
        Zr_comb = _ZERO
        for i, poly in enumerate(poly_list):
            num_vars = poly.get_num_vars()
            if num_vars not in L_map:
                L_map[num_vars] = PolyEvalProof._uni_L(r, num_vars)
            LZ = poly.bound(L_map[num_vars])  # (R_size_i, 16)
            scaled = fq.mul(LZ, scalars_to_mont([c], dev)[0])
            LZ_comb[:LZ.shape[0]] = fq.add(LZ_comb[:LZ.shape[0]], scaled)
            Zr_comb = Zr_comb + c * Zr_list[i]
            c = c * c_base

        proof, _C_LR, C_Zr_prime = DotProductProofLog.prove(
            gens.gens, transcript, random_tape, mont_to_scalars(LZ_comb),
            _ZERO, R, Zr_comb, _ZERO, device=dev)
        return PolyEvalProof(proof), C_Zr_prime

    def verify_uni_batched_instances(self, gens, transcript, r: Scalar,
                                     C_Zr_list, comm_list, poly_size,
                                     device=None):
        """C_Zr_list: list of RistrettoPoint; the opening's G_hat may run
        on `device` (sigma.BulletReductionProof.verify; None: the
        host)."""
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        _, right = EqPolynomial.compute_factored_lens(
            log2(next_pow2(max(poly_size))))
        R = PolyEvalProof._uni_powers(r, 1 << right)

        L_map = {}
        c_base = transcript.challenge_scalar(b"challenge_c")
        c = _ONE
        C_LZ_comb = RistrettoPoint.identity()
        C_Zr_comb = RistrettoPoint.identity()
        for i, comm in enumerate(comm_list):
            num_vars = log2(next_pow2(poly_size[i]))
            if num_vars not in L_map:
                L_map[num_vars] = PolyEvalProof._uni_L(r, num_vars)
            pts = comm.decompress()
            C_LZ = multiscalar_mul(L_map[num_vars][: len(pts)], pts)
            C_LZ_comb = C_LZ_comb + C_LZ * c
            C_Zr_comb = C_Zr_comb + C_Zr_list[i] * c
            c = c * c_base

        self.proof.verify(len(R), gens.gens, transcript, R,
                          C_LZ_comb.compress(), C_Zr_comb.compress(), device)

    # --- batched opening: many instances, (rq, ry) trimmed per size ------
    # One dot-product proof per distinct (num_proofs, num_inputs) pair;
    # same-size instances fold in by a c-power RLC.
    @staticmethod
    def _disjoint_r_short(num_proofs: int, num_inputs: int, rq, ry):
        nq, ny = log2(num_proofs), log2(num_inputs)
        if ny >= len(ry):
            ry_short = [_ZERO] * (ny - len(ry)) + list(ry)
        else:
            ry_short = list(ry[len(ry) - ny:])
        rq_short = list(rq[len(rq) - nq:])
        return rq_short + ry_short

    @staticmethod
    def prove_batched_instances_disjoint_rounds(
            poly_list, num_proofs_list, num_inputs_list, blinds_opt, rq, ry,
            Zr_list, blind_Zr_opt, gens: PolyCommitmentGens, transcript,
            random_tape):
        transcript.append_protocol_name(PolyEvalProof.protocol_name())
        assert len(poly_list) == len(Zr_list)

        index_map = {}
        LZ_list, Zc_list, L_list, R_list = [], [], [], []
        c_base = transcript.challenge_scalar(b"challenge_c")
        c = _ONE
        for i, poly in enumerate(poly_list):
            key = (num_proofs_list[i], num_inputs_list[i])
            if key in index_map:
                c = c * c_base
                idx = index_map[key]
                LZ = poly.bound(L_list[idx])
                cm = scalars_to_mont([c], LZ.device)[0]
                LZ_list[idx] = fq.add(LZ_list[idx], fq.mul(LZ, cm))
                Zc_list[idx] = Zc_list[idx] + c * Zr_list[i]
            else:
                index_map[key] = len(LZ_list)
                r = PolyEvalProof._disjoint_r_short(key[0], key[1], rq, ry)
                L, R = EqPolynomial(r).compute_factored_evals(poly.Zm.device)
                LZ_list.append(poly.bound(L))
                Zc_list.append(Zr_list[i])
                L_list.append(L)
                R_list.append(R)

        proofs = []
        blind_Zr = blind_Zr_opt if blind_Zr_opt is not None else _ZERO
        for i in range(len(LZ_list)):
            L = L_list[i]
            blinds = blinds_opt if blinds_opt is not None else \
                PolyCommitmentBlinds([_ZERO] * len(L))
            assert len(blinds.blinds) == len(L)
            LZ_blind = _lz_blind(blinds.blinds, L)
            proof, _, _ = DotProductProofLog.prove(
                gens.gens, transcript, random_tape,
                mont_to_scalars(LZ_list[i]), LZ_blind, R_list[i],
                Zc_list[i], blind_Zr, device=LZ_list[i].device)
            proofs.append(PolyEvalProof(proof))
        return proofs

    @staticmethod
    def verify_batched_instances_disjoint_rounds(
            proof_list, num_proofs_list, num_inputs_list,
            gens: PolyCommitmentGens, transcript, rq, ry, Zr_list, comm_list,
            device):
        """Zr_list: list of RistrettoPoint (commitments to evals); the eq
        tables are built on `device`."""
        transcript.append_protocol_name(PolyEvalProof.protocol_name())

        index_map = {}
        LZ_list, Zc_list, L_list, R_list = [], [], [], []
        c_base = transcript.challenge_scalar(b"challenge_c")
        c = _ONE
        for i, comm in enumerate(comm_list):
            pts = comm.decompress()
            key = (num_proofs_list[i], num_inputs_list[i])
            if key in index_map:
                c = c * c_base
                idx = index_map[key]
                LZ = multiscalar_mul(L_list[idx][: len(pts)], pts)
                LZ_list[idx] = LZ_list[idx] + LZ * c
                Zc_list[idx] = Zc_list[idx] + Zr_list[i] * c
            else:
                index_map[key] = len(LZ_list)
                r = PolyEvalProof._disjoint_r_short(key[0], key[1], rq, ry)
                L, R = EqPolynomial(r).compute_factored_evals(device)
                LZ_list.append(multiscalar_mul(L[: len(pts)], pts))
                Zc_list.append(Zr_list[i])
                L_list.append(L)
                R_list.append(R)
        assert len(LZ_list) == len(proof_list)

        for i in range(len(LZ_list)):
            proof_list[i].proof.verify(
                len(R_list[i]), gens.gens, transcript, R_list[i],
                LZ_list[i].compress(), Zc_list[i].compress(), device)
