"""Error types (reference: src/errors.rs)."""


class ProofVerifyError(Exception):
    """Proof verification failed (reference errors.rs:7-25)."""


class DecompressionError(ProofVerifyError):
    """Compressed group element failed to decompress."""


class R1CSError(Exception):
    """Invalid R1CS shape or assignment (reference errors.rs:27-41)."""
