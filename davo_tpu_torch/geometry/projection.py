"""Pinhole camera projections (the port of
``davo_tpu/geometry/projection.py``): basic, clamped and homogeneous.

Every function broadcasts over leading batch dimensions and takes the
3-parameter intrinsics ``(f, cx, cy)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "project_points_basic_pinhole",
    "project_points_clamped_pinhole",
    "pixel_coordinates_to_homogeneous",
    "project_points_pinhole_homogeneous",
]


def project_points_basic_pinhole(points: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """``(f x / z + cx, f y / z + cy)``.

    :param points: ``(..., 3)`` camera-relative points.
    :param intrinsics: ``(..., 3)`` intrinsics ``(f, cx, cy)``.
    :return: ``(..., 2)`` pixel coordinates.
    """
    return intrinsics[..., 0:1] * points[..., 0:2] / points[..., 2:3] + intrinsics[..., 1:3]


def project_points_clamped_pinhole(points: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """A projection that keeps useful gradients for points behind the
    camera and for huge projected coordinates (image bounds [-1, 1]), with
    the focal length parameterised as ``e^f``:

    * ``z < -1``: ``u = sign(x) (101 + log|z|) + cx``;
    * ``-1 <= z <= ~0``: ``u = sign(x) (100 - z) + cx``;
    * ``z > 0`` and ``f + log|x| - log|z| >= 0``:
      ``u = sign(x) (1 + f + log|x| - log|z|) + cx``;
    * otherwise ``u = e^f x / z + cx``.

    The logarithms and the division are guarded by double ``where``s, so
    the branch that is not taken contributes no NaN.
    """
    focal_length = intrinsics[..., 0:1]
    principal_point = intrinsics[..., 1:3]
    xy = points[..., 0:2]
    z = points[..., 2:3]
    one = torch.ones((), dtype=points.dtype, device=points.device)

    is_z_large_negative = z < -1.0
    is_z_positive = z > 1e-100
    abs_xy = torch.abs(xy)
    abs_z = torch.abs(z)
    log_xy = torch.log(torch.where(abs_xy == 0.0, one, abs_xy))
    log_z = torch.log(torch.where(abs_z == 0.0, one, abs_z))
    sign_xy = torch.sign(xy)

    negative_projected = sign_xy * torch.where(is_z_large_negative, 101.0 + log_z, 100.0 - z)
    log_projection = focal_length + log_xy - log_z
    projection = torch.exp(focal_length) * xy / torch.where(is_z_positive, z, one)
    positive_projected = torch.where(log_projection < 0.0, projection, sign_xy * (log_projection + 1.0))
    return principal_point + torch.where(is_z_positive, positive_projected, negative_projected)


def _positive_focal_length(intrinsics: torch.Tensor) -> torch.Tensor:
    """``elu(f) + 1`` — strictly positive focal length."""
    return F.elu(intrinsics[..., 0:1]) + 1.0


def pixel_coordinates_to_homogeneous(
    projected_points: torch.Tensor, intrinsics: torch.Tensor
) -> torch.Tensor:
    """The ray ``(u - cx, v - cy, f')`` through each pixel, with
    ``f' = elu(f) + 1``.

    :param projected_points: ``(..., 2)`` pixel coordinates.
    :param intrinsics: ``(..., 3)`` intrinsics ``(f, cx, cy)``.
    :return: ``(..., 3)`` rays, defined up to scale.
    """
    focal_length = _positive_focal_length(intrinsics)
    centred = projected_points - intrinsics[..., 1:3]
    focal = focal_length.expand(centred.shape[:-1] + (1,))
    return torch.cat([centred, focal], dim=-1)


def project_points_pinhole_homogeneous(points: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Camera-relative points to homogeneous projective-plane coordinates
    without a division: ``(f' x + z cx, f' y + z cy, z)`` with
    ``f' = elu(f) + 1``; the invalid coordinate (0:0:0) becomes (0:0:1)."""
    focal_length = _positive_focal_length(intrinsics)
    z = points[..., 2:3]
    projected = focal_length * points[..., 0:2] + z * intrinsics[..., 1:3]
    is_zero = (z == 0.0) & torch.all(projected == 0.0, dim=-1, keepdim=True)
    z = torch.where(is_zero, torch.ones_like(z), z)
    return torch.cat([projected, z], dim=-1)
