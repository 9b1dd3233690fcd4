"""Spartan+IPA: the argument that compresses a relaxed R1CS witness away
(port of ``vdf_tpu.spartan``).  ``host`` is the int tier (the native
engine's, and every test's oracle); the rest is the device tier."""

from .ipa import IPAProof, ipa_prove, ipa_verify
from .multilinear import eq_table, evaluate, fold_top, num_vars, pad_to_pow2
from .snark import SpartanCtx, SpartanProof, spartan_prove, spartan_verify
from .sumcheck import eval_univariate, sumcheck_prove, sumcheck_verify

__all__ = [
    "IPAProof",
    "ipa_prove",
    "ipa_verify",
    "eq_table",
    "evaluate",
    "fold_top",
    "num_vars",
    "pad_to_pow2",
    "SpartanCtx",
    "SpartanProof",
    "spartan_prove",
    "spartan_verify",
    "eval_univariate",
    "sumcheck_prove",
    "sumcheck_verify",
]
