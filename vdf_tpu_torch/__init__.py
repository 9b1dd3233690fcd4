"""vdf_tpu_torch: the MinRoot VDF framework on PyTorch and CUDA (H100).

The port of ``vdf_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports neither jax nor vdf_tpu.  Its first
slice is the delay side of the main path: MinRoot eval and verify over
the Pasta fields, with the fused eval and inverse kernels written by hand
in CUDA C++ for sm_90a (csrc/), built with nvcc at first use.

Top-level surface mirrors the reference's ``lib.rs`` exports
(src/lib.rs:1-4) as far as this slice reaches.
"""

from . import fields, minroot  # noqa: F401
from .minroot import (  # noqa: F401
    EvalMode,
    Evaluation,
    MinRootVDF,
    State,
    pallas_vdf,
    vesta_vdf,
)
from .errors import (  # noqa: F401
    KernelError,
    NovaError,
    SerializationError,
    SynthesisError,
    VDFError,
)
from .utils import TEST_SEED  # noqa: F401

# The reference declares Pallas the canonical instantiation
# (``TargetVDF``, src/minroot.rs:265).
target_vdf = pallas_vdf

__version__ = "0.1.0"
