"""The port's Poseidon (vdf_tpu_torch.poseidon): host-integer twin and
tensor permutation / transcript against the frozen vectors of
tests/test_golden.py and against the JAX package on seeded inputs.  Exact
equality at canonical integers.
"""

import hashlib

import numpy as np
import pytest
import torch

from vdf_tpu.fields import get_field as jax_get_field
from vdf_tpu.poseidon import Transcript as JaxTranscript
from vdf_tpu.poseidon import get_poseidon as jax_get_poseidon
from vdf_tpu_torch import interop
from vdf_tpu_torch.fields import get_field
from vdf_tpu_torch.poseidon import (
    IntTranscript,
    Transcript,
    generate_constants,
    get_poseidon,
    hash_fixed,
    permute_ints,
)

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

# The frozen vectors of tests/test_golden.py.
POSEIDON_DIGESTS = {
    ("Fp", 3): "01002673b0cbc3d30f06f36a46750ab0d7b2afaaeee8e8970b097131e7123b26",
    ("Fp", 5): "424c814b8b12229fd6ce2ea33ce558c75f0dce611b7007194fb0b5bdf6ebff61",
    ("Fq", 3): "1eb9bf6c566b7ac0fe115315703c6febcff92c0515eeb527e910a8efc4ca2032",
    ("Fq", 5): "163980e8d9032d129ccbd492404672a863fc6235f64e154d0c3bb95cae63da6d",
}
PERMUTE_STATE0 = {
    ("Fp", 3): 0xA070019374AD8A80F58621B488C888EBEAA8568D6DEB965179DF980D437DAD6,
    ("Fp", 5): 0x2B5FCC0D26105F3F6017EF5F7D9DC5CCDC8E1A22D9D60EDF126B37ACAD689667,
    ("Fq", 3): 0x1B80FEFCE1DACF419D85C2493DCC5E94760429C18198991DC58DA32A9A127194,
    ("Fq", 5): 0x362BA55BD8233AE8C55AC13BC64F8A17746D84CAC88F85AD9FEA36E96B8BE740,
}
TRANSCRIPT_CHALLENGES = {
    "Fp": (
        0x3DD5F3FF7A158818052D121349BF4BBE08155A4F7484707387EFE17833C6EE77,
        0x30D8AE8BEF5EDCE48718E8970E0E2CC65BBC07137924D9A6C603336FFFA6DD2,
    ),
    "Fq": (
        0x2D48C5E236B2315AACEEA7EEEA38C8E69A5DB0716DCB690041658DC8CA320349,
        0x6B1A9BB369109F4237A13B8B78FD5C475D559556B61FBCECD84A1A353F675CA,
    ),
}


def seeded(field_name: str, n: int, seed: int) -> list[int]:
    p = get_field(field_name).params.modulus
    raw = np.random.default_rng(seed).bytes(32 * n)
    return [int.from_bytes(raw[32 * k : 32 * k + 32], "little") % p for k in range(n)]


@pytest.mark.parametrize("field,width", list(POSEIDON_DIGESTS))
def test_constants_and_permutation_vector_frozen(field, width):
    rc, mds = generate_constants(field, width)
    h = hashlib.sha256()
    for v in list(rc) + [v for row in mds for v in row]:
        h.update(int(v).to_bytes(32, "little"))
    assert h.hexdigest() == POSEIDON_DIGESTS[(field, width)]
    assert permute_ints(field, list(range(width)), width)[0] == PERMUTE_STATE0[(field, width)]
    f = get_field(field)
    out = get_poseidon(field, width).permute([f.encode(k, device="cpu") for k in range(width)])
    assert f.decode(out[0]) == PERMUTE_STATE0[(field, width)]


@pytest.mark.parametrize("field", ["Fp", "Fq"])
def test_transcript_challenges_frozen(field):
    it = IntTranscript(field)
    it.absorb(1, 2, 3, 4, 5, 6, 7)
    assert (it.squeeze(), it.squeeze()) == TRANSCRIPT_CHALLENGES[field]
    f = get_field(field)
    tr = Transcript(field)
    tr.absorb(*[f.encode(k, device="cpu") for k in range(1, 8)])
    assert (f.decode(tr.squeeze()), f.decode(tr.squeeze())) == TRANSCRIPT_CHALLENGES[field]


@pytest.mark.parametrize("field,width", [("Fq", 3), ("Fq", 5), ("Fp", 5), ("Fq", 10)])
def test_permutation_matches_int_twin_batched(field, width):
    """A batch of two lanes (0 and p - 1 among the values); width 10 takes
    the MDS row sum in two parts."""
    f = get_field(field)
    p = f.params.modulus
    lanes = [seeded(field, width, seed=width), seeded(field, width, seed=width + 1)]
    lanes[0][0], lanes[1][1] = 0, p - 1
    state = [f.encode([lanes[0][k], lanes[1][k]], device="cpu") for k in range(width)]
    out = get_poseidon(field, width).permute(state)
    want = [permute_ints(field, lane, width) for lane in lanes]
    assert [f.decode(o) for o in out] == [[want[0][k], want[1][k]] for k in range(width)]


@pytest.mark.parametrize("field", ["Fp", "Fq"])
def test_permutation_and_transcript_match_jax(field):
    """The same seeded inputs through the JAX package's permutation and
    Transcript and, carried across with interop, through the port's; a flush
    in mid-stream, two squeezes, and an exported state carried on."""
    f, jf = get_field(field), jax_get_field(field)
    vals = seeded(field, 11, seed=23)
    jstate = [jf.encode(v) for v in vals[:5]]
    want = [jf.decode(o) for o in jax_get_poseidon(field, 5).permute(jstate)]
    state = [interop.from_jax(field, np.asarray(a), device="cpu") for a in jstate]
    assert [f.decode(o) for o in get_poseidon(field, 5).permute(state)] == want

    jtr, tr = JaxTranscript(field), Transcript(field)
    jtr.absorb(*[jf.encode(v) for v in vals[:6]])
    tr.absorb(*[f.encode(v, device="cpu") for v in vals[:6]])
    jtr.flush()
    tr.flush()
    tr = Transcript.from_state(field, tr.export_state())
    jtr.absorb(*[jf.encode(v) for v in vals[6:]])
    tr.absorb(*[f.encode(v, device="cpu") for v in vals[6:]])
    for _ in range(2):
        assert f.decode(tr.squeeze()) == jf.decode(jtr.squeeze())


def test_hash_fixed_and_transcript_binding():
    f = get_field("Fq")
    a, b = f.encode([5], device="cpu"), f.encode([7], device="cpu")
    h1, h3 = hash_fixed("Fq", [a, b]), hash_fixed("Fq", [b, a])
    assert f.decode(h1) == [permute_ints("Fq", [3, 5, 7])[0]]
    assert f.decode(h1) != f.decode(h3)

    def run(vals):
        tr = Transcript("Fq")
        tr.absorb(*[f.encode(v, device="cpu") for v in vals])
        return f.decode(tr.squeeze())

    assert run([1, 2, 3]) == run([1, 2, 3]) != run([1, 2, 4])
    with pytest.raises(ValueError):
        Transcript("Fq").flush()
