from .schur import (
    BAObservations,
    BAProblem,
    SchurConfig,
    ba_cost,
    ba_residuals,
    default_gauge_masks,
    schur_ba_solve,
    schur_normal_step,
)

__all__ = [
    "BAObservations",
    "BAProblem",
    "SchurConfig",
    "ba_cost",
    "ba_residuals",
    "default_gauge_masks",
    "schur_ba_solve",
    "schur_normal_step",
]
