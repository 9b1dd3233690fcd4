"""Typed error surface (reference Error enum, src/nova/proof.rs:45-49).

The same classes as ``vdf_tpu.errors``, plus ``KernelError`` for the
port's CUDA kernels: a build that fails, a launch CUDA refuses, or
a tensor the kernel does not take.
"""

from __future__ import annotations


class VDFError(Exception):
    """Base class for all framework errors."""


class SynthesisError(VDFError):
    """Circuit synthesis failed (unsatisfied constraint, missing
    assignment) — bellperson's SynthesisError domain (proof.rs:47)."""


class NovaError(VDFError):
    """Folding/IVC-level failure (mismatched shapes, bad instance,
    unverifiable fold) — nova-snark's NovaError domain (proof.rs:46)."""


class SerializationError(VDFError):
    """Malformed or non-canonical proof bytes."""


class KernelError(VDFError):
    """A CUDA kernel could not be built or launched, or was handed a
    tensor it does not take."""
