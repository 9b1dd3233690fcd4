from .augmented import AugmentedCircuit, AugmentedInputs, make_circuits
from .circuit import InverseMinRootCircuit, inverse_round_gadget
from .ivc import (
    ENGINES,
    CanonicalWitness,
    HostInstance,
    HostRelaxedInstance,
    IVCParams,
    IVCProof,
    RecursiveIVC,
    ivc_public_params,
    ivc_verify,
)
from .nifs import NIFS, R1CSInstance, RelaxedInstance, RelaxedWitness
from .pedersen import DEFAULT_LABEL, CommitmentKey, commitment_key, derive_generators
from .r1cs_device import DeviceMatrix, DeviceShape
from .snark import (
    CompressedVDFProof,
    NovaVDFProof,
    PublicParams,
    RecursiveSNARK,
    eval_and_make_circuits,
    public_params,
)
from .compressed import CompressedIVCProof, ivc_compress, ivc_verify_compressed
from .pipeline import (
    InterleavedProver,
    StatementProof,
    VDFStatement,
    prove_interleaved,
    prove_stream,
)

__all__ = [
    "AugmentedCircuit",
    "AugmentedInputs",
    "make_circuits",
    "ENGINES",
    "CanonicalWitness",
    "CompressedIVCProof",
    "CompressedVDFProof",
    "HostInstance",
    "HostRelaxedInstance",
    "IVCParams",
    "IVCProof",
    "RecursiveIVC",
    "ivc_public_params",
    "ivc_verify",
    "ivc_compress",
    "ivc_verify_compressed",
    "DEFAULT_LABEL",
    "CommitmentKey",
    "commitment_key",
    "derive_generators",
    "InverseMinRootCircuit",
    "inverse_round_gadget",
    "NIFS",
    "R1CSInstance",
    "RelaxedInstance",
    "RelaxedWitness",
    "DeviceMatrix",
    "DeviceShape",
    "NovaVDFProof",
    "PublicParams",
    "RecursiveSNARK",
    "eval_and_make_circuits",
    "public_params",
    "InterleavedProver",
    "StatementProof",
    "VDFStatement",
    "prove_interleaved",
    "prove_stream",
]
