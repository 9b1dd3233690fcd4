"""The program's field elements as the reference reads them: rows of eight
little-endian 32-bit limbs (int32 bit patterns) in Montgomery form,
R = 2^256."""

from __future__ import annotations

import numpy as np

R_BITS = 256


def mont_to_ints(rows, p: int) -> list[int]:
    """(n, 8) Montgomery limbs (an int32 array or CPU tensor) -> n canonical ints."""
    a = np.ascontiguousarray(np.asarray(rows), dtype=np.int32).view(np.uint32)
    data = a.astype("<u4").tobytes()
    r_inv = pow(1 << R_BITS, -1, p)
    return [int.from_bytes(data[32 * k: 32 * k + 32], "little") * r_inv % p
            for k in range(a.shape[0])]
