from .int_poseidon import IntTranscript, permute_ints
from .params import ALPHA, FULL_ROUNDS, generate_constants, partial_rounds
from .permutation import Poseidon, Transcript, get_poseidon, hash_fixed

__all__ = [
    "ALPHA",
    "FULL_ROUNDS",
    "generate_constants",
    "partial_rounds",
    "IntTranscript",
    "permute_ints",
    "Poseidon",
    "Transcript",
    "get_poseidon",
    "hash_fixed",
]
