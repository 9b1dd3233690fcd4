from .xorshift import TEST_SEED, XorShiftRng, field_random

__all__ = ["TEST_SEED", "XorShiftRng", "field_random"]
