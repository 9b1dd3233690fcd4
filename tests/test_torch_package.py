"""The port stands alone: it imports without jax or vdf_tpu, and its
native oracle is the JAX package's C++ source, byte for byte."""

import pathlib
import subprocess
import sys

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
from vdf_tpu_torch.curves import bucket_msm, kernels
from vdf_tpu_torch.curves.msm import msm, msm_layout
from vdf_tpu_torch.nova import circuit, nifs, r1cs_device, snark
from vdf_tpu_torch.poseidon import int_poseidon, params, permutation
from vdf_tpu_torch.r1cs import cs, gadgets, witness

assert vdf_tpu_torch.commitment_key is nova.commitment_key
assert vdf_tpu_torch.msm is msm and curves.msm is msm and vdf_tpu_torch.NovaVDFProof is snark.NovaVDFProof
assert vdf_tpu_torch.default_device is device.default_device
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
