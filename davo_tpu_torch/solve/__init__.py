from .bfgs import (
    BFGSConfig,
    bfgs_solve,
    clamp_search_direction,
    scale_initial_inverse_hessian,
    update_inverse_hessian,
)
from .lbfgs import LBFGSConfig, lbfgs_solve
from .least_squares import LMConfig, levenberg_marquardt, spd_solve_small
from .line_search import line_search_backtracking, line_search_wolfe_conditions
from .sgd import SGDConfig, sgd_solve

__all__ = [
    "BFGSConfig",
    "bfgs_solve",
    "clamp_search_direction",
    "scale_initial_inverse_hessian",
    "update_inverse_hessian",
    "LMConfig",
    "levenberg_marquardt",
    "spd_solve_small",
    "LBFGSConfig",
    "lbfgs_solve",
    "line_search_backtracking",
    "line_search_wolfe_conditions",
    "SGDConfig",
    "sgd_solve",
]
