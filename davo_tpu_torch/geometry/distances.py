"""Distances between homogeneous projective-plane coordinates (the port of
``davo_tpu/geometry/distances.py``): the angle and the cosine distance."""

from __future__ import annotations

import torch

from davo_tpu_torch.utils.guards import safe_norm

__all__ = ["projective_plane_angle_distance", "projective_plane_cosine_distance"]

# float64 machine epsilon: the floor under every normalising norm
_NORM_FLOOR = 2.220446049250313e-16


def _normalise(v: torch.Tensor) -> torch.Tensor:
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=_NORM_FLOOR)


def projective_plane_angle_distance(
    projective_points_a: torch.Tensor,
    projective_points_b: torch.Tensor,
    keepdim: bool = False,
) -> torch.Tensor:
    """Angle in ``[0, pi]`` between two homogeneous coordinates as vectors
    of R^3, in Kahan's stable form

        theta = 2 atan2(|a/|a| - b/|b||, |a/|a| + b/|b||)

    with :func:`safe_norm`, so an exact zero distance has derivative 0."""
    a = _normalise(projective_points_a)
    b = _normalise(projective_points_b)
    diff = safe_norm(a - b, keepdim=keepdim)
    summ = safe_norm(a + b, keepdim=keepdim)
    return 2.0 * torch.atan2(diff, summ)


def projective_plane_cosine_distance(
    projective_points_a: torch.Tensor,
    projective_points_b: torch.Tensor,
) -> torch.Tensor:
    """``1 - cos`` of the angle between homogeneous coordinates as vectors
    of R^3, in ``[0, 2]``."""
    a = _normalise(projective_points_a)
    b = _normalise(projective_points_b)
    return 1.0 - torch.sum(a * b, dim=-1)
