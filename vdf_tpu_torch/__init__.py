"""vdf_tpu_torch: the MinRoot VDF framework on PyTorch and CUDA (H100).

The port of ``vdf_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports neither jax nor vdf_tpu.  It holds the
delay side of the main path (MinRoot eval and verify over the Pasta
fields, fused eval and inverse kernels) and the fixed-base Pedersen
commit of the proving side (``nova.commitment_key``: curves, the
pre-shifted generator table and the bucket pipeline), each kernel
written by hand in CUDA C++ for sm_90a (csrc/), built with nvcc at first
use.

Top-level surface mirrors the reference's ``lib.rs`` exports
(src/lib.rs:1-4) as far as this slice reaches.
"""

from . import curves, fields, minroot, nova, poseidon, r1cs  # noqa: F401
from .curves import Curve, Point, get_curve, msm  # noqa: F401
from .minroot import (  # noqa: F401
    EvalMode,
    Evaluation,
    MinRootVDF,
    State,
    pallas_vdf,
    vesta_vdf,
)
from .device import default_device  # noqa: F401
from .errors import (  # noqa: F401
    KernelError,
    NovaError,
    SerializationError,
    SynthesisError,
    VDFError,
)
from .nova import (  # noqa: F401
    CommitmentKey,
    NovaVDFProof,
    commitment_key,
    eval_and_make_circuits,
    public_params,
)
from .utils import TEST_SEED  # noqa: F401

# The reference declares Pallas the canonical instantiation
# (``TargetVDF``, src/minroot.rs:265).
target_vdf = pallas_vdf

__version__ = "0.1.0"
