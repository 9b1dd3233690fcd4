from .params import FP, FQ, FIELDS, NLIMBS, LIMB_BITS, FieldParams, int_to_limbs, limbs_to_int
from .ops import Field, get_field
from .int_field import IntField, get_int_field
from .chains import get_program, pow_fixed, program_cost

__all__ = [
    "FP",
    "FQ",
    "FIELDS",
    "NLIMBS",
    "LIMB_BITS",
    "FieldParams",
    "Field",
    "get_field",
    "IntField",
    "get_int_field",
    "int_to_limbs",
    "limbs_to_int",
    "get_program",
    "pow_fixed",
    "program_cost",
]
