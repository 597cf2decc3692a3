"""Tensor-bundle types shared across the port (mirrors ``davo_tpu/types.py``)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = [
    "CameraViewsAndPoints",
    "FeaturePoints",
    "MatchedPoints",
    "ErrorAndGradient",
    "PointsAndJacobian",
]


class CameraViewsAndPoints(NamedTuple):
    """A batch of synthetic multi-view scenes.

    * ``projected_points``: ``(B, M, N, 2)`` pixel observations.
    * ``visibility_mask``: ``(B, M, N)`` bool, in-image-bounds flags.
    * ``camera_intrinsics``: ``(B, 3)`` — ``(f, cx, cy)``.
    * ``camera_orientations``: ``(B, M-1, 3)`` axis-angle (view 1 = identity).
    * ``camera_translations``: ``(B, M-1, 3)``.
    * ``world_points``: ``(B, N, 3)`` in the frame of view 1.
    """

    projected_points: torch.Tensor
    visibility_mask: torch.Tensor
    camera_intrinsics: torch.Tensor
    camera_orientations: torch.Tensor
    camera_translations: torch.Tensor
    world_points: torch.Tensor


class FeaturePoints(NamedTuple):
    """Detected feature locations, descriptors and optional score logits."""

    points: torch.Tensor  # (B, K, 2)
    descriptors: torch.Tensor  # (B, K, D)
    scores: Optional[torch.Tensor] = None  # (B, K)


class MatchedPoints(NamedTuple):
    """Corresponding point coordinates between two views."""

    points_a: torch.Tensor  # (B, K, 2)
    points_b: torch.Tensor  # (B, K, 2)


class ErrorAndGradient(NamedTuple):
    error: torch.Tensor
    gradient: torch.Tensor


class PointsAndJacobian(NamedTuple):
    """Projected points plus their Jacobian w.r.t. model parameters."""

    points: torch.Tensor  # (B, F, N, 2)
    jacobian: torch.Tensor  # (B, F, N, 2, P)
