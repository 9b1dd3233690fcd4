"""The port stands alone: it imports without jax or vdf_tpu, and its
native oracle is the JAX package's C++ source, byte for byte.  The ``gpu``
tests prove and verify one step of the two-curve IVC on the card, compress,
serialize and verify that proof, and resume a device-engine checkpoint;
they skip where ``torch.cuda.is_available()`` is False:

    python -m pytest tests/test_torch_package.py -q -m gpu --noconftest
"""

import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

BLOCKED_IMPORT = r"""
import sys

BLOCKED = ("jax", "jaxlib", "vdf_tpu")


class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Block())
import vdf_tpu_torch
from vdf_tpu_torch import _build, curves, device, interop, native, nova, poseidon, r1cs
from vdf_tpu_torch import bench, checkpoint, config, entry, parallel, serialize, spartan
from vdf_tpu_torch.fields import chains
from vdf_tpu_torch.fields import kernels as field_kernels, ops as field_ops
from vdf_tpu_torch.nova import pipeline
from vdf_tpu_torch.parallel import distributed, mesh
from vdf_tpu_torch.curves import bucket_msm, kernels
from vdf_tpu_torch.curves.msm import msm, msm_layout
from vdf_tpu_torch.nova import augmented, circuit, compressed, ivc, nifs, r1cs_device, snark
from vdf_tpu_torch.spartan import host, ipa, multilinear, sumcheck
from vdf_tpu_torch.spartan import snark as spartan_snark
from vdf_tpu_torch.nova.gadgets import bignat, ec, instance, sponge
from vdf_tpu_torch.poseidon import int_poseidon, params, permutation
from vdf_tpu_torch.r1cs import bits, cs, gadgets, witness
from vdf_tpu_torch.utils import profiling

assert vdf_tpu_torch.ivc_public_params is ivc.ivc_public_params
assert vdf_tpu_torch.ivc_compress is compressed.ivc_compress
assert vdf_tpu_torch.serialize_compressed is serialize.serialize_compressed
assert spartan.spartan_prove is spartan_snark.spartan_prove and spartan.ipa_prove is ipa.ipa_prove
assert int_poseidon.checked_native() is native  # the native tier builds and agrees

assert vdf_tpu_torch.commitment_key is nova.commitment_key
assert vdf_tpu_torch.msm is msm and curves.msm is msm and vdf_tpu_torch.NovaVDFProof is snark.NovaVDFProof
assert vdf_tpu_torch.default_device is device.default_device
assert vdf_tpu_torch.ProverConfig is config.ProverConfig and nova.prove_stream is pipeline.prove_stream
assert parallel.sharded_msm is mesh.sharded_msm and distributed.make_mesh is mesh.make_mesh
assert checkpoint.save_ivc and chains.get_program(5, "rtl_add_chain")
assert entry.dryrun_multichip and entry.entry
assert bench.main and bench.msm_inputs
assert field_kernels.field_ew and field_kernels.field_segsum and field_kernels.r1cs_matvec
assert field_ops.digit_calls() == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
print("ok")
"""


def test_port_imports_with_jax_and_vdf_tpu_blocked():
    proc = subprocess.run([sys.executable, "-c", BLOCKED_IMPORT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_native_source_is_the_jax_packages():
    port = (REPO / "vdf_tpu_torch" / "native" / "pasta.cpp").read_bytes()
    assert port == (REPO / "vdf_tpu" / "native" / "pasta.cpp").read_bytes()


@pytest.mark.gpu
def test_ivc_step_on_card():
    """One device-engine prove_step and ivc_verify at t = 1, no device
    argument anywhere: the witness handles are CUDA tensors and the commit
    kernels ran."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from vdf_tpu_torch import RecursiveIVC, ivc_public_params, ivc_verify
    from vdf_tpu_torch.curves import kernels as CK

    pp = ivc_public_params(1)
    CK.reset_launches()
    z0 = [3, 4, 5]
    prover = RecursiveIVC(pp, z0)
    prover.prove_step()
    proof = prover.proof()
    assert proof.r_W_primary.is_cuda and proof.l_w_secondary.is_cuda
    assert all(CK.LAUNCHES[k] > 0 for k in ("canon_digits", "canon_mont", "scan", "colscan",
                                            "bucket"))
    assert ivc_verify(pp, proof, 2, z0, proof.z_i)
    assert not ivc_verify(pp, proof, 3, z0, proof.z_i)


@pytest.mark.gpu
def test_compress_on_card():
    """The t = 1 proof of two steps compressed on the card, serialized, read
    back and verified, no device argument anywhere; K9 ran (the openings'
    msm)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from vdf_tpu_torch import (
        RecursiveIVC,
        deserialize_compressed,
        ivc_compress,
        ivc_public_params,
        ivc_verify_compressed,
        serialize_compressed,
    )
    from vdf_tpu_torch.curves import kernels as CK

    pp = ivc_public_params(1)
    z0 = [3, 4, 5]
    prover = RecursiveIVC(pp, z0)
    prover.prove_step()
    proof = prover.proof()
    CK.reset_launches()
    cp = ivc_compress(pp, proof)
    assert cp.spartan_primary.vW.is_cuda
    back = deserialize_compressed(pp, serialize_compressed(pp, cp))
    assert ivc_verify_compressed(pp, back, 2, z0, proof.z_i)
    assert not ivc_verify_compressed(pp, back, 3, z0, proof.z_i)
    assert CK.LAUNCHES["horner"] > 0


@pytest.mark.gpu
def test_resume_device_checkpoint_on_card(tmp_path):
    """A device-engine chain at t = 1 checkpointed after one step, resumed
    (verified first) and proven one step further: its handles are back on
    the card and the proof is byte-equal to an uninterrupted chain's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    from vdf_tpu_torch import RecursiveIVC, ivc_public_params, serialize_ivc_proof
    from vdf_tpu_torch.checkpoint import resume_ivc, save_ivc

    pp = ivc_public_params(1)
    z0 = [3, 4, 5]
    full = RecursiveIVC(pp, z0)
    full.prove_step()
    full.prove_step()
    want = serialize_ivc_proof(pp, full.proof())
    part = RecursiveIVC(pp, z0)
    part.prove_step()
    path = tmp_path / "ivc.ckpt"
    save_ivc(str(path), pp, part)
    resumed = resume_ivc(str(path), pp)
    assert resumed.r_W_primary.is_cuda and resumed.l_w_secondary.is_cuda
    resumed.prove_step()
    assert serialize_ivc_proof(pp, resumed.proof()) == want
