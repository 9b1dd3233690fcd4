from .vdf import EvalMode, MinRootVDF, State, pallas_vdf, vesta_vdf
from .evaluation import Evaluation
from .fused import eval_fused, inverse_eval_fused

__all__ = [
    "EvalMode",
    "MinRootVDF",
    "State",
    "Evaluation",
    "eval_fused",
    "inverse_eval_fused",
    "pallas_vdf",
    "vesta_vdf",
]
