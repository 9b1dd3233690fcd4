from .pedersen import DEFAULT_LABEL, CommitmentKey, commitment_key, derive_generators

__all__ = ["DEFAULT_LABEL", "CommitmentKey", "commitment_key", "derive_generators"]
