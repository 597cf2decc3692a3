from .distances import projective_plane_angle_distance
from .projection import pixel_coordinates_to_homogeneous
from .so3 import (
    axis_angle_from_matrix,
    axis_angle_from_quaternion,
    quaternion_from_matrix,
    rotate_vector_axis_angle,
    skew_matrix,
    so3_parameter_jacobian,
    so3_rotation_matrix,
    wrap_axis_angle,
)

__all__ = [
    "projective_plane_angle_distance",
    "pixel_coordinates_to_homogeneous",
    "axis_angle_from_matrix",
    "axis_angle_from_quaternion",
    "quaternion_from_matrix",
    "rotate_vector_axis_angle",
    "skew_matrix",
    "so3_parameter_jacobian",
    "so3_rotation_matrix",
    "wrap_axis_angle",
]
