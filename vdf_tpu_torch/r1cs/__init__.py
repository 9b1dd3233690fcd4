from .cs import ONE, LinearCombination, R1CSShape, ShapeCS, Variable
from .gadgets import AllocatedNum, Num
from .witness import WitnessCS

__all__ = [
    "ONE",
    "LinearCombination",
    "R1CSShape",
    "ShapeCS",
    "Variable",
    "AllocatedNum",
    "Num",
    "WitnessCS",
]
