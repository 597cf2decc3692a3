"""Pixel rays for the homogeneous pinhole (the port of the part of
``davo_tpu/geometry/projection.py`` the calibration objective uses)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["pixel_coordinates_to_homogeneous"]


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
