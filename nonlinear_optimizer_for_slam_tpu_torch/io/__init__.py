from . import bal, g2o
from .bal import BALProblem, read_bal, snavely_project, synthetic_bal_problem, write_bal

__all__ = [
    "bal",
    "g2o",
    "BALProblem",
    "read_bal",
    "snavely_project",
    "synthetic_bal_problem",
    "write_bal",
]
