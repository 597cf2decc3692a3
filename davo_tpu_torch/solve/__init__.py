from .bfgs import (
    BFGSConfig,
    bfgs_solve,
    clamp_search_direction,
    scale_initial_inverse_hessian,
    update_inverse_hessian,
)
from .line_search import line_search_backtracking, line_search_wolfe_conditions

__all__ = [
    "BFGSConfig",
    "bfgs_solve",
    "clamp_search_direction",
    "scale_initial_inverse_hessian",
    "update_inverse_hessian",
    "line_search_backtracking",
    "line_search_wolfe_conditions",
]
