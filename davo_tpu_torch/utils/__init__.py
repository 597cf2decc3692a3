from .device import resolve_device
from .precision import full_f32_matmuls
from .guards import (
    guarded_sqrt,
    interpolate_alpha,
    inverse_curvature,
    project_vector_onto_axis,
    safe_norm,
    safe_reciprocal,
    straight_through_max,
)
from .profiling import debug_nans, timed, trace
from .masked import (
    broadcast_mask,
    masked_merge_tensors,
    masked_update,
    masked_update_tree,
)
from .stable_trig import (
    cos_from_sq,
    cos_sin_sq,
    cos_x_on_x_squared_minus_sin_x_on_x_cubed,
    one_minus_cos_sq,
    one_minus_cos_x_on_x_squared,
    sin_cubed_sq,
    sin_x_on_x,
    sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth,
    sinc_sq,
)

__all__ = [
    "full_f32_matmuls",
    "resolve_device",
    "guarded_sqrt",
    "interpolate_alpha",
    "inverse_curvature",
    "safe_norm",
    "safe_reciprocal",
    "straight_through_max",
    "project_vector_onto_axis",
    "trace",
    "timed",
    "debug_nans",
    "broadcast_mask",
    "masked_merge_tensors",
    "masked_update",
    "masked_update_tree",
    "cos_from_sq",
    "cos_sin_sq",
    "one_minus_cos_sq",
    "sin_cubed_sq",
    "sinc_sq",
    "sin_x_on_x",
    "one_minus_cos_x_on_x_squared",
    "cos_x_on_x_squared_minus_sin_x_on_x_cubed",
    "sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth",
]
