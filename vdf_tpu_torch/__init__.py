"""vdf_tpu_torch: the MinRoot VDF framework on PyTorch and CUDA (H100).

The port of ``vdf_tpu`` (JAX on a TPU), which stays beside it as the
reference.  This package imports neither jax nor vdf_tpu.  It holds:

  * the delay side: MinRoot eval and verify over the Pasta fields, fused
    eval and inverse kernels (``minroot``, ``fields``);
  * the curves and their bucket pipeline: the fixed-base Pedersen commit
    (``nova.commitment_key``: the pre-shifted generator table, sort keys,
    column scan, carries, bucket sums) and the variable-base ``msm`` that
    reuses the pipeline a window a batch row (``curves``);
  * the single-curve Nova folding engine: the Poseidon transcript
    (``poseidon``), R1CS constraint systems and the MinRoot circuit
    (``r1cs``, ``nova.circuit``), folding and the recursive proof
    (``nova.nifs``, ``nova.snark``);
  * the two-curve Nova IVC, the statement the repo exists to prove: the
    augmented circuits and their gadgets (``nova.augmented``,
    ``nova.gadgets``, ``r1cs.bits``) synthesized on host ints, and the
    prover and O(1) verifier (``nova.ivc``: ``ivc_public_params``,
    ``RecursiveIVC``, ``ivc_verify``), whose commits and cross terms run on
    the card (``engine="device"``) or on the native C++ tier
    (``engine="native"``);
  * compression and serialization: the Spartan+IPA argument (``spartan``)
    that replaces the IVC proof's witness vectors (``nova.ivc_compress``,
    ``nova.ivc_verify_compressed``; ``NovaVDFProof.compress`` for the
    single-curve engine), and the canonical byte form of both IVC proofs
    (``serialize``), the JAX package's byte for byte;
  * the service around them: proof-carrying checkpoints (``checkpoint``),
    ``ProverConfig`` (``config``), the statement pipeline and interleaved
    chains (``nova.prove_stream``, ``nova.prove_interleaved``), the four
    ``EvalMode`` schedules and their addition chains (``fields.chains``),
    and the multi-process entry on ``torch.distributed`` (``parallel``),
    whose mesh the IVC takes for tensor parallelism.

Every kernel is written by hand in CUDA C++ for sm_90a (csrc/) and built
with nvcc at first use.  Top-level surface mirrors the reference's
``lib.rs`` exports (src/lib.rs:1-4) as far as the port reaches.
"""

from . import curves, fields, minroot, nova, poseidon, r1cs, serialize, spartan  # noqa: F401
from . import checkpoint, config, parallel  # noqa: F401
from .config import ProverConfig  # noqa: F401
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
    CompressedIVCProof,
    CompressedVDFProof,
    IVCParams,
    IVCProof,
    NovaVDFProof,
    RecursiveIVC,
    commitment_key,
    eval_and_make_circuits,
    ivc_compress,
    ivc_public_params,
    ivc_verify,
    ivc_verify_compressed,
    public_params,
)
from .serialize import (  # noqa: F401
    deserialize_compressed,
    deserialize_ivc_proof,
    serialize_compressed,
    serialize_ivc_proof,
)
from .utils import TEST_SEED  # noqa: F401

# The reference declares Pallas the canonical instantiation
# (``TargetVDF``, src/minroot.rs:265).
target_vdf = pallas_vdf

__version__ = "0.1.0"
