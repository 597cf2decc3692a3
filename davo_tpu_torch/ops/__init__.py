from .attention import (
    flash_match_attention,
    match_attention,
    reference_attention,
    reference_flash_attention,
)
from .bfgs_update import fused_bfgs_update_direction, reference_update_direction
from .build import launch_counts, load_library, reset_launch_counts
from .calibration_obj import calibration_value_and_grad, make_fused_calibration_objective

__all__ = [
    "flash_match_attention",
    "match_attention",
    "reference_attention",
    "reference_flash_attention",
    "fused_bfgs_update_direction",
    "reference_update_direction",
    "launch_counts",
    "load_library",
    "reset_launch_counts",
    "calibration_value_and_grad",
    "make_fused_calibration_objective",
]
