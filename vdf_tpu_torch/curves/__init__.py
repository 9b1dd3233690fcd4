from .point import (
    CURVES,
    PALLAS,
    VESTA,
    Curve,
    CurveParams,
    Point,
    get_curve,
    hash_to_curve_ints,
    sqrt_mod,
    stack_point,
    unstack_point,
)
from .int_ops import IDENTITY, IntCurve, IntPoint, get_int_curve
from .bucket_msm import commit_fixed, commit_fixed_batch, digits_of_scalars, shifted_gens
from .msm import msm

__all__ = [
    "CURVES",
    "PALLAS",
    "VESTA",
    "Curve",
    "CurveParams",
    "Point",
    "get_curve",
    "hash_to_curve_ints",
    "sqrt_mod",
    "stack_point",
    "unstack_point",
    "IDENTITY",
    "IntCurve",
    "IntPoint",
    "get_int_curve",
    "commit_fixed",
    "commit_fixed_batch",
    "digits_of_scalars",
    "shifted_gens",
    "msm",
]
