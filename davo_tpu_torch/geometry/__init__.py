from .distances import projective_plane_angle_distance, projective_plane_cosine_distance
from .orientation import two_vector_rotation_jacobian, two_vector_rotation_matrix
from .projection import (
    pixel_coordinates_to_homogeneous,
    project_points_basic_pinhole,
    project_points_clamped_pinhole,
    project_points_pinhole_homogeneous,
)
from .so3 import (
    axis_angle_from_matrix,
    axis_angle_from_quaternion,
    quaternion_from_matrix,
    rotate_vector_axis_angle,
    skew_matrix,
    so3_parameter_jacobian,
    so3_rotation_matrix,
    so3_vector_jacobian,
    wrap_axis_angle,
)

__all__ = [
    "rotate_vector_axis_angle",
    "so3_rotation_matrix",
    "so3_parameter_jacobian",
    "so3_vector_jacobian",
    "axis_angle_from_quaternion",
    "quaternion_from_matrix",
    "axis_angle_from_matrix",
    "wrap_axis_angle",
    "skew_matrix",
    "project_points_basic_pinhole",
    "project_points_clamped_pinhole",
    "pixel_coordinates_to_homogeneous",
    "project_points_pinhole_homogeneous",
    "projective_plane_angle_distance",
    "projective_plane_cosine_distance",
    "two_vector_rotation_matrix",
    "two_vector_rotation_jacobian",
]
