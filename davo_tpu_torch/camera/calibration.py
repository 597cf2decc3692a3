"""Multi-view calibration objective over a flat parameter vector (the
port of ``davo_tpu/camera/calibration.py``).

A flat ``(..., 3 + 3N + 6(M-1))`` vector unpacks into intrinsics, world
points and the poses of views 2..M (view 1 pinned at the identity); the
scene is gauge-rescaled and the error is the projective angle between
each observed pixel ray and the camera-relative point.
:func:`basin_score` adds flat-bottom plausibility penalties to that error
for the selection among multi-start solves.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from davo_tpu_torch.geometry import (
    pixel_coordinates_to_homogeneous,
    projective_plane_angle_distance,
    rotate_vector_axis_angle,
)

__all__ = [
    "CalibrationParameters",
    "num_calibration_parameters",
    "unpack_calibration_parameters",
    "pack_calibration_parameters",
    "get_camera_relative_points",
    "calibration_error",
    "calibration_residuals",
    "BasinScoreConfig",
    "basin_score",
]


class CalibrationParameters(NamedTuple):
    """Slices of the flat calibration vector, for leading batch dims ``B...``:
    ``intrinsics (B..., 1, 1, 3)``, ``world_points (B..., 1, N, 3)``,
    ``camera_translations`` and ``camera_rotations`` ``(B..., M-1, 1, 3)``."""

    intrinsics: torch.Tensor
    world_points: torch.Tensor
    camera_translations: torch.Tensor
    camera_rotations: torch.Tensor


def num_calibration_parameters(num_views: int, num_points: int) -> int:
    """``P = 3 + 3N + 6(M - 1)`` (view 1 pinned at the identity)."""
    return 3 + 3 * num_points + 6 * (num_views - 1)


def unpack_calibration_parameters(
    parameters: torch.Tensor, num_views: int, num_points: int
) -> CalibrationParameters:
    """Split a flat parameter vector into its slices."""
    expected = num_calibration_parameters(num_views, num_points)
    if parameters.shape[-1] != expected:
        raise ValueError(
            f"The final dimension of the parameters must be "
            f"3 + 3*num_points + 6*(num_views - 1) = {expected}, "
            f"got {parameters.shape[-1]}"
        )
    batch = tuple(parameters.shape[:-1])
    points_end = 3 + 3 * num_points
    translations_end = points_end + 3 * (num_views - 1)
    return CalibrationParameters(
        intrinsics=parameters[..., 0:3].reshape(batch + (1, 1, 3)),
        world_points=parameters[..., 3:points_end].reshape(batch + (1, num_points, 3)),
        camera_translations=parameters[..., points_end:translations_end].reshape(
            batch + (num_views - 1, 1, 3)
        ),
        camera_rotations=parameters[..., translations_end:].reshape(
            batch + (num_views - 1, 1, 3)
        ),
    )


def pack_calibration_parameters(params: CalibrationParameters) -> torch.Tensor:
    """Inverse of :func:`unpack_calibration_parameters`."""
    batch = tuple(params.intrinsics.shape[:-3])
    return torch.cat(
        [
            params.intrinsics.reshape(batch + (-1,)),
            params.world_points.reshape(batch + (-1,)),
            params.camera_translations.reshape(batch + (-1,)),
            params.camera_rotations.reshape(batch + (-1,)),
        ],
        dim=-1,
    )


def get_camera_relative_points(
    world_points: torch.Tensor,
    camera_translations: torch.Tensor,
    camera_rotations: torch.Tensor,
) -> torch.Tensor:
    """Express N world points relative to each of M views.

    The scene is first rescaled so the mean |coordinate| over points and
    camera centres is 1 (floored at 1e-6 so an all-zero scene cannot
    divide by zero), fixing the gauge scale.

    :param world_points: ``(..., 1, N, 3)``.
    :param camera_translations: ``(..., M-1, 1, 3)``.
    :param camera_rotations: ``(..., M-1, 1, 3)``.
    :return: ``(..., M, N, 3)``.
    """
    num_points = world_points.shape[-2]
    num_views = camera_translations.shape[-3] + 1
    points_scale = torch.mean(torch.abs(world_points), dim=(-1, -2, -3))
    camera_scale = torch.mean(torch.abs(camera_translations), dim=(-1, -2, -3))
    overall_scale = (points_scale * num_points + camera_scale * num_views) / (
        num_points + num_views
    )
    overall_scale = torch.clamp(overall_scale, min=1e-6)[..., None, None, None]
    world_points = world_points / overall_scale
    camera_translations = camera_translations / overall_scale
    transformed = rotate_vector_axis_angle(world_points, camera_rotations) + camera_translations
    return torch.cat([world_points, transformed], dim=-3)


def calibration_error(
    parameters: torch.Tensor,
    true_projected_points: torch.Tensor,
    visibility_mask: torch.Tensor,
) -> torch.Tensor:
    """Total masked reprojection angle of calibration parameter vectors.

    :param parameters: ``(B..., P)``.
    :param true_projected_points: ``(B..., M, N, 2)`` observed pixels.
    :param visibility_mask: ``(B..., M, N)`` boolean or float visibility.
    :return: ``(B...,)``.
    """
    num_views = true_projected_points.shape[-3]
    num_points = true_projected_points.shape[-2]
    params = unpack_calibration_parameters(parameters, num_views, num_points)
    rays = pixel_coordinates_to_homogeneous(true_projected_points, params.intrinsics)
    relative_points = get_camera_relative_points(
        params.world_points, params.camera_translations, params.camera_rotations
    )
    rays, relative_points = torch.broadcast_tensors(rays, relative_points)
    distance = projective_plane_angle_distance(rays, relative_points)
    return torch.sum(distance * visibility_mask, dim=(-1, -2))


def calibration_residuals(parameters: torch.Tensor, true_projected_points: torch.Tensor) -> torch.Tensor:
    """Per-observation reprojection angles ``(B..., M, N)``: the un-reduced
    :func:`calibration_error`, without the visibility weighting."""
    num_views = true_projected_points.shape[-3]
    num_points = true_projected_points.shape[-2]
    params = unpack_calibration_parameters(parameters, num_views, num_points)
    rays = pixel_coordinates_to_homogeneous(true_projected_points, params.intrinsics)
    relative_points = get_camera_relative_points(
        params.world_points, params.camera_translations, params.camera_rotations
    )
    rays, relative_points = torch.broadcast_tensors(rays, relative_points)
    return projective_plane_angle_distance(rays, relative_points)


@dataclasses.dataclass(frozen=True)
class BasinScoreConfig:
    """Weights of :func:`basin_score`.  The penalties are zero inside the
    domain the scene generator samples (FOV 30-120 degrees, so the
    effective focal ``elu(f) + 1`` lies in [0.577, 3.73]; principal point
    within +-0.5) and for visible points in front of their cameras."""

    # bounds of log(elu(f) + 1)
    log_focal_bounds: tuple = (-0.55, 1.32)
    focal_weight: float = 1.0
    centre_bound: float = 0.5
    centre_weight: float = 1.0
    # least camera-frame depth of a visible point (the scene is
    # gauge-rescaled to mean |coordinate| 1)
    depth_margin: float = 0.05
    depth_weight: float = 1.0
    # quadratic pull of each estimate's log focal towards an anchor the
    # caller passes (the guess head's focal)
    anchor_weight: float = 0.0


def basin_score(
    parameters: torch.Tensor,
    true_projected_points: torch.Tensor,
    visibility_mask: torch.Tensor,
    config: BasinScoreConfig = BasinScoreConfig(),
    anchor_log_focal: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Reprojection error plus plausibility penalties; lower is better.

    Inside the plausible domain the score equals :func:`calibration_error`;
    estimates with implausible intrinsics or visible points behind a
    camera are pushed out of contention even where their error is lower
    (the projectively ambiguous basins of weak starts).

    :param parameters: ``(B..., P)``.
    :param true_projected_points: ``(B..., M, N, 2)``.
    :param visibility_mask: ``(B..., M, N)`` boolean or float.
    :param anchor_log_focal: broadcastable to ``(B...,)``; read when
        ``config.anchor_weight > 0``.
    :return: ``(B...,)``.
    """
    num_views = true_projected_points.shape[-3]
    num_points = true_projected_points.shape[-2]
    error = calibration_error(parameters, true_projected_points, visibility_mask)
    params = unpack_calibration_parameters(parameters, num_views, num_points)

    # the effective focal of pixel_coordinates_to_homogeneous: elu(f) + 1
    log_f = torch.log(torch.clamp(F.elu(params.intrinsics[..., 0, 0, 0]) + 1.0, min=1e-6))
    lo, hi = config.log_focal_bounds
    focal_penalty = torch.square(F.relu(log_f - hi)) + torch.square(F.relu(lo - log_f))

    centre = params.intrinsics[..., 0, 0, 1:3]
    centre_penalty = torch.sum(torch.square(F.relu(torch.abs(centre) - config.centre_bound)), dim=-1)

    relative = get_camera_relative_points(
        params.world_points, params.camera_translations, params.camera_rotations
    )
    vis = visibility_mask.to(error.dtype)
    behind = torch.square(F.relu(config.depth_margin - relative[..., 2]))
    depth_penalty = torch.sum(behind * vis, dim=(-1, -2)) / torch.clamp(torch.sum(vis, dim=(-1, -2)), min=1.0)

    score = (
        error
        + config.focal_weight * focal_penalty
        + config.centre_weight * centre_penalty
        + config.depth_weight * depth_penalty
    )
    if config.anchor_weight > 0.0 and anchor_log_focal is not None:
        score = score + config.anchor_weight * torch.square(log_f - anchor_log_focal)
    return score
