"""Curve25519 / ristretto255 constants.

Mirrors the parameter set of the reference prover's L0 layer
(reference: src/scalar/ristretto255.rs, src/group.rs), re-derived from first
principles here: the scalar field is the prime-order-subgroup order of
curve25519 (ristretto255 group order), the base field is GF(2^255 - 19).
"""

# Base field prime of curve25519.
P = 2**255 - 19

# ristretto255 / ed25519 group order (scalar field modulus).
# reference: src/scalar/ristretto255.rs:248 (MODULUS)
L = 2**252 + 27742317777372353535851937790883648493

# Twisted Edwards curve: -x^2 + y^2 = 1 + d*x^2*y^2  (a = -1)
EDWARDS_D = (-121665 * pow(121666, P - 2, P)) % P
EDWARDS_D2 = (2 * EDWARDS_D) % P

# sqrt(-1) mod P, chosen as the "nonnegative" root (even canonical encoding).
SQRT_M1 = pow(2, (P - 1) // 4, P)
if SQRT_M1 & 1:
    SQRT_M1 = P - SQRT_M1
assert (SQRT_M1 * SQRT_M1) % P == P - 1

# Ed25519 basepoint in affine coordinates (RFC 8032): y = 4/5 mod P.
BASE_X = 15112221349535400772501151409588531511454012693041857206046113283949847762202
BASE_Y = 46316835694926478169428394003475163141307993866256225615783033603165251855960
assert (-BASE_X * BASE_X + BASE_Y * BASE_Y) % P == (
    1 + EDWARDS_D * BASE_X * BASE_X % P * BASE_Y % P * BASE_Y
) % P

# Ristretto map constants (RFC 9496 section 4.1 notation).
ONE_MINUS_D_SQ = (1 - EDWARDS_D * EDWARDS_D) % P
D_MINUS_ONE_SQ = ((EDWARDS_D - 1) * (EDWARDS_D - 1)) % P


def _sqrt_nonneg(x: int) -> int:
    """Square root mod P of x (must be a QR), nonnegative convention."""
    r = pow(x, (P + 3) // 8, P)
    if (r * r) % P != x % P:
        r = (r * SQRT_M1) % P
    assert (r * r) % P == x % P, "not a square"
    if r & 1:
        r = P - r
    return r


# sqrt(a*d - 1) = sqrt(-d - 1), nonnegative root
SQRT_AD_MINUS_ONE = _sqrt_nonneg((-EDWARDS_D - 1) % P)
# 1/sqrt(a - d) = nonnegative sqrt of 1/(-1 - d)  (RFC 9496: SQRT_RATIO_M1(1, a-d))
INVSQRT_A_MINUS_D = _sqrt_nonneg(pow((-1 - EDWARDS_D) % P, P - 2, P))
