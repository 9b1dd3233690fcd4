"""The port's compressed IVC proof and byte serialization
(vdf_tpu_torch.nova.compressed, vdf_tpu_torch.serialize) on the CPU.

  * The two-curve IVC on the native engine at T = 2 iterations a step, N = 3
    steps, from the z0 of tests/test_compressed.py: the port's
    ``serialize_compressed(ivc_compress(...))`` and ``serialize_ivc_proof``
    are byte-equal to the JAX package's on the same statement, each package
    decodes and verifies the other's compressed bytes, and the port passes
    the mirror of tests/test_compressed.py's cases (verifies, wrong claims,
    a tampered instance and argument, both round trips, malformed blobs,
    here also a point off its curve).
  * The single-curve engine's ``NovaVDFProof.compress`` at t = 2, n = 3 on
    device="cpu" (the kernels' plain versions), from tests/test_nova.py's
    statement: it verifies, and a tampered one does not; its transcript
    starts as the JAX package's compress starts it (the digest, then the
    instance with all six X), to the same challenges; and (``slow`` and
    ``nightly``, as the JAX package's own single-curve compress test: its
    compress is ~12 min of XLA:CPU) its argument equals the JAX package's
    field by field, and each package's verifier accepts the other's.

The reference's compress alone takes about a minute here, most of it its
host derivation of both keys, so each package's proof is built once.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from vdf_tpu import serialize as jax_serialize
from vdf_tpu.nova import compressed as jax_compressed
from vdf_tpu.nova import ivc as jax_ivc
from vdf_tpu_torch import (
    NovaVDFProof,
    interop,
    eval_and_make_circuits,
    pallas_vdf,
    public_params,
)
from vdf_tpu_torch.curves import Point, get_curve
from vdf_tpu_torch.errors import SerializationError
from vdf_tpu_torch.fields import get_field, get_int_field
from vdf_tpu_torch.nova import RecursiveIVC, ivc_public_params, ivc_verify
from vdf_tpu_torch.nova.compressed import ivc_compress, ivc_verify_compressed
from vdf_tpu_torch.nova.snark import _host_instance
from vdf_tpu_torch.serialize import (
    deserialize_compressed,
    deserialize_ivc_proof,
    serialize_compressed,
    serialize_ivc_proof,
)
from vdf_tpu_torch.spartan.host import (
    HostIPAProof,
    HostSpartanProof,
    _flat,
    _rebuild,
    absorb_instance_ints,
    spartan_from_device,
    spartan_to_device,
)
from vdf_tpu_torch.spartan.multilinear import num_vars
from vdf_tpu_torch.spartan.snark import spartan_transcript
from vdf_tpu_torch.utils import TEST_SEED, XorShiftRng, field_random

torch.set_num_threads(1)  # many small tensor ops; see tests/test_torch_commit.py

T, N = 2, 3
START = [5, 6, 0]  # tests/test_compressed.py's


def forward_eval(x: int, y: int, i: int, total: int):
    f = get_int_field("Fq")
    invalpha = pow(5, -1, f.p - 1)
    for _ in range(total):
        x, y, i = pow((x + y) % f.p, invalpha, f.p), (x + i) % f.p, i + 1
    return x, y, i


Z0 = list(forward_eval(*START, N * T))


@pytest.fixture(scope="module")
def port():
    pp = ivc_public_params(T, engine="native")
    prover = RecursiveIVC(pp, Z0)
    for _ in range(N - 1):
        prover.prove_step()
    proof = prover.proof()
    return pp, proof, ivc_compress(pp, proof)


@pytest.fixture(scope="module")
def jax():
    pp = jax_ivc.ivc_public_params(T, engine="native")
    prover = jax_ivc.RecursiveIVC(pp, Z0)
    for _ in range(N - 1):
        prover.prove_step()
    proof = prover.proof()
    return pp, proof, jax_compressed.ivc_compress(pp, proof)


# -- the port against the JAX package


def test_compressed_bytes_equal_jax_packages(port, jax):
    pp, _, cp = port
    jpp, _, jcp = jax
    assert isinstance(cp.spartan_primary, HostSpartanProof)  # the native engine's form
    assert serialize_compressed(pp, cp) == jax_serialize.serialize_compressed(jpp, jcp)


def test_ivc_bytes_equal_jax_packages(port, jax):
    pp, proof, _ = port
    jpp, jproof, _ = jax
    assert serialize_ivc_proof(pp, proof) == jax_serialize.serialize_ivc_proof(jpp, jproof)


def test_each_package_verifies_the_others_bytes(port, jax):
    pp, _, cp = port
    jpp, _, jcp = jax
    mine = deserialize_compressed(pp, jax_serialize.serialize_compressed(jpp, jcp))
    assert ivc_verify_compressed(pp, mine, N, Z0, START)
    theirs = jax_serialize.deserialize_compressed(jpp, serialize_compressed(pp, cp))
    assert jax_compressed.ivc_verify_compressed(jpp, theirs, N, Z0, START)


# -- tests/test_compressed.py's cases on the port


class TestCompressed:
    def test_verifies(self, port):
        pp, _, cp = port
        assert ivc_verify_compressed(pp, cp, N, Z0, START)

    def test_wrong_claim_rejected(self, port):
        pp, _, cp = port
        assert not ivc_verify_compressed(pp, cp, N + 1, Z0, START)
        assert not ivc_verify_compressed(pp, cp, 0, Z0, START)
        bad = dataclasses.replace(cp, z_i=[1, 2, 3])
        assert not ivc_verify_compressed(pp, bad, N, Z0, [1, 2, 3])

    def test_tampered_instance_rejected(self, port):
        pp, _, cp = port
        U = cp.r_U_primary
        bad = dataclasses.replace(
            cp, r_U_primary=dataclasses.replace(U, X=[(U.X[0] + 1) % (1 << 255), U.X[1]]))
        assert not ivc_verify_compressed(pp, bad, N, Z0, START)

    def test_tampered_spartan_rejected(self, port):
        pp, _, cp = port
        q = pp.primary.field.params.modulus
        for side in ("spartan_primary", "spartan_secondary"):
            sp = getattr(cp, side)
            bad = dataclasses.replace(cp, **{side: sp._replace(vA=(sp.vA + 1) % q)})
            assert not ivc_verify_compressed(pp, bad, N, Z0, START), side


class TestSerialization:
    def test_ivc_roundtrip(self, port):
        pp, proof, _ = port
        blob = serialize_ivc_proof(pp, proof)
        back = deserialize_ivc_proof(pp, blob)
        assert ivc_verify(pp, back, N, Z0, START)
        assert serialize_ivc_proof(pp, back) == blob

    def test_compressed_roundtrip(self, port):
        pp, _, cp = port
        blob = serialize_compressed(pp, cp)
        back = deserialize_compressed(pp, blob)
        assert ivc_verify_compressed(pp, back, N, Z0, START)
        assert serialize_compressed(pp, back) == blob

    def test_malformed_rejected(self, port):
        pp, proof, cp = port
        blob = serialize_ivc_proof(pp, proof)
        with pytest.raises(SerializationError, match="magic"):
            deserialize_ivc_proof(pp, b"XXXXXXXX" + blob[8:])
        with pytest.raises(SerializationError, match="truncated"):
            deserialize_ivc_proof(pp, blob[:-1])
        with pytest.raises(SerializationError, match="trailing"):
            deserialize_ivc_proof(pp, blob + b"\x00")
        with pytest.raises(SerializationError, match="magic"):
            deserialize_compressed(pp, blob)  # an IVC proof is not a compressed one
        comp = serialize_compressed(pp, cp)
        with pytest.raises(SerializationError, match="non-canonical"):
            bad = bytearray(comp)
            bad[-32:] = (get_int_field("Fp").p + 1).to_bytes(32, "little")  # a_final
            deserialize_compressed(pp, bytes(bad))
        # The first point after the header and the two z vectors:
        # r_U_primary.comm_w, (x, y) after its tag byte; y + 1 leaves the curve.
        off = 9 + 8 + 2 * (8 + 3 * 32) + 1 + 32
        y = int.from_bytes(comp[off : off + 32], "little")
        assert cp.r_U_primary.comm_w[1] == y
        bad = comp[:off] + ((y + 1) % get_int_field("Fp").p).to_bytes(32, "little") + comp[off + 32:]
        with pytest.raises(SerializationError, match="off pallas"):
            deserialize_compressed(pp, bad)


# -- the single-curve engine's compress, device="cpu"


@pytest.fixture(scope="module")
def single():
    """The port's NovaVDFProof at t = 2, n = 3 from tests/test_nova.py's
    statement (x from TEST_SEED, y = 0, i = 1), and its compression."""
    vdf = pallas_vdf()
    x = field_random(XorShiftRng(TEST_SEED), vdf.field.params.modulus)
    s0 = vdf.state_from_ints(x, 0, 1, device="cpu")
    pp = public_params(T, device="cpu")
    z0, circuits = eval_and_make_circuits(vdf, T, N, s0)
    proof = NovaVDFProof.prove_recursively(pp, circuits, z0)
    return pp, proof, proof.compress(pp), z0, list(s0)


def test_nova_vdf_proof_compress(single):
    pp, _, cp, z0, zi = single
    assert cp.verify(pp, N, z0, zi)
    f = get_field("Fq")
    sp = cp.spartan
    bad = dataclasses.replace(cp, spartan=sp._replace(vW=f.add(sp.vW, f.one("cpu"))))
    assert not bad.verify(pp, N, z0, zi)
    assert not cp.verify(pp, N + 1, z0, zi)


def _jax_relaxed_instance(U):
    import jax.numpy as jnp
    from vdf_tpu.curves import Point as JaxPoint
    from vdf_tpu.nova.nifs import RelaxedInstance as JaxRelaxedInstance

    cw, ce, x, u = interop.relaxed_instance_to_jax("pallas", U)
    return JaxRelaxedInstance(JaxPoint(*map(jnp.asarray, cw)), JaxPoint(*map(jnp.asarray, ce)),
                              jnp.asarray(x), jnp.asarray(u))


def test_nova_vdf_proof_compress_transcript_is_jax_packages(single):
    """The single-curve argument's transcript starts as the JAX package's
    ``NovaVDFProof.compress`` starts it: the digest on a device ``Transcript``,
    then ``spartan.snark._absorb_instance`` of the final instance (two points,
    all six X, u).  The port's digest, int transcript and instance read
    (``_host_instance``) must give the same state and the same challenges
    tau.  From there both run the Spartan argument whose tiers this file's
    and tests/test_torch_spartan.py's other tests hold against the JAX
    package's; the whole argument against the JAX package's compress is
    ``test_nova_vdf_proof_compress_equals_jax_packages``."""
    import numpy as np
    from vdf_tpu.curves import get_curve as jax_get_curve
    from vdf_tpu.nova import public_params as jax_public_params
    from vdf_tpu.poseidon import Transcript as JaxTranscript
    from vdf_tpu.spartan.snark import _absorb_instance

    pp, proof, _, _, _ = single
    f = pp.field
    jpp = jax_public_params(T)
    assert interop.jax_limbs_to_ints("Fq", np.asarray(jpp.digest)) == [f.decode(pp.digest)]
    U = proof.snark.U
    assert U.x.shape[0] == 6  # the single-curve instance: z_in and z_out

    jtr = JaxTranscript("Fq")
    jtr.absorb(jpp.digest)
    jtr.flush()
    _absorb_instance(jtr, jpp.field, jax_get_curve("pallas"), _jax_relaxed_instance(U))
    tr = spartan_transcript(f, f.decode(pp.digest))
    absorb_instance_ints(tr, _host_instance(pp, U))

    jstate, jbuf = ([interop.jax_limbs_to_ints("Fq", np.asarray(a))[0] for a in part]
                    for part in jtr.export_state())
    assert (tr.state, tr.buf) == (jstate, jbuf)
    assert len(jbuf) == 2 * 5 + 6 + 1  # two points, X, u
    rounds = num_vars(pp.dev_shape.shape.num_cons)
    want = [interop.jax_limbs_to_ints("Fq", np.asarray(jtr.squeeze()))[0] for _ in range(rounds)]
    assert [tr.squeeze() for _ in range(rounds)] == want


def _jax_spartan_ints(sp) -> HostSpartanProof:
    """A JAX SpartanProof (Pallas commitments, Fq scalars) as ints."""
    import numpy as np

    scalars, points = _flat(sp)
    ints = interop.jax_limbs_to_ints("Fq", np.stack([np.asarray(v) for v in scalars]))
    pts = [interop.point_from_jax("pallas", p_, "cpu") for p_ in points]
    affs = get_curve("pallas").to_affine_ints(Point(*(torch.cat(c) for c in zip(*(
        Point(*(v[None] for v in p_)) for p_ in pts)))))
    return _rebuild(sp, ints, affs, HostIPAProof, HostSpartanProof)


def _jax_spartan_from_ints(hp: HostSpartanProof):
    """Ints -> a JAX SpartanProof, as the JAX package's prover holds it."""
    import jax.numpy as jnp
    from vdf_tpu.curves import Point as JaxPoint
    from vdf_tpu.spartan.ipa import IPAProof as JaxIPAProof
    from vdf_tpu.spartan.snark import SpartanProof as JaxSpartanProof

    scalars, points = _flat(hp)
    limbs = [jnp.asarray(v) for v in interop.ints_to_jax_limbs("Fq", scalars)]
    xyz = interop.point_to_jax("pallas", get_curve("pallas").from_affine_ints(points, "cpu"))
    pts = [JaxPoint(*(jnp.asarray(a[k]) for a in xyz)) for k in range(len(points))]
    return _rebuild(hp, limbs, pts, JaxIPAProof, JaxSpartanProof)


@pytest.mark.slow
@pytest.mark.nightly  # the JAX package's single-curve compress: ~12 min of XLA:CPU here
def test_nova_vdf_proof_compress_equals_jax_packages(single):
    """On the same statement the JAX package's ``NovaVDFProof.compress``
    gives the port's argument field by field (every sumcheck message, each
    v*, each IPA's L and R in affine and a_final), and each package's
    ``CompressedVDFProof.verify`` accepts the other's argument."""
    from vdf_tpu.minroot import pallas_vdf as jax_pallas_vdf
    from vdf_tpu.nova.snark import CompressedVDFProof as JaxCompressedVDFProof
    from vdf_tpu.nova.snark import NovaVDFProof as JaxNovaVDFProof
    from vdf_tpu.nova.snark import eval_and_make_circuits as jax_eval_and_make_circuits
    from vdf_tpu.nova.snark import public_params as jax_public_params
    from vdf_tpu.utils import TEST_SEED as JAX_TEST_SEED

    pp, _, cp, z0, zi = single
    jvdf = jax_pallas_vdf()
    x = field_random(XorShiftRng(JAX_TEST_SEED), jvdf.field.params.modulus)
    s0 = jvdf.state_from_ints(x, 0, 1)
    jzi = [s0.x, s0.y, s0.i]
    jpp = jax_public_params(T)
    jz0, circuits = jax_eval_and_make_circuits(jvdf, T, N, s0)
    jproof = JaxNovaVDFProof.prove_recursively(jpp, circuits, jz0)
    jcp = jproof.compress(jpp)

    mine = spartan_from_device(pp.spartan_ctx, cp.spartan)
    theirs = _jax_spartan_ints(jcp.spartan)
    assert mine == theirs

    ported = JaxCompressedVDFProof(jcp.step_instances, jcp.comm_ts, jcp.U,
                                   _jax_spartan_from_ints(mine))
    assert ported.verify(jpp, N, jz0, jzi)
    back = dataclasses.replace(cp, spartan=spartan_to_device(pp.spartan_ctx, theirs))
    assert back.verify(pp, N, z0, zi)
