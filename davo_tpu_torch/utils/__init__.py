from .device import resolve_device
from .precision import full_f32_matmuls
from .guards import (
    guarded_sqrt,
    interpolate_alpha,
    inverse_curvature,
    safe_norm,
    safe_reciprocal,
)
from .masked import (
    broadcast_mask,
    masked_merge_tensors,
    masked_update,
    masked_update_tree,
)
from .stable_trig import (
    cos_from_sq,
    cos_sin_sq,
    one_minus_cos_sq,
    sin_cubed_sq,
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
    "broadcast_mask",
    "masked_merge_tensors",
    "masked_update",
    "masked_update_tree",
    "cos_from_sq",
    "cos_sin_sq",
    "one_minus_cos_sq",
    "sin_cubed_sq",
    "sinc_sq",
]
