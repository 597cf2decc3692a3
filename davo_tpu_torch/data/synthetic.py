"""Synthetic multi-view calibration scenes, generated on the device (the
port of ``davo_tpu/data/synthetic.py``).

Sampling scheme (as in the JAX package):

* N world points in front of view 1: ``z ~ |N(20, 5)|``, ``xy ~ N(0, 3)``.
* View 1 is the identity pose; ``M - 1`` look-at views: perturbed camera
  locations, targets near the point centroid and a perturbed "up"
  reference, Gram–Schmidt orthonormalised into a right-handed rotation
  (x right, y down, z forward) and converted to axis-angle.
* Cameras are pushed back along their forward axis until every point is at
  least ``min_camera_distance`` in front.
* Intrinsics from a FOV uniform in the configured range:
  ``f = 1/tan(fov/2)``; principal point ``clip(0.2 N(0,1), +-0.5)``.
* Observations are pinhole projections; visibility = inside [-1, 1]^2.

All random numbers are drawn at once from a ``torch.Generator`` by
:func:`draw_scene_noise`; :func:`scenes_from_noise` is the deterministic
rest, so a test can feed it the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import torch

from davo_tpu_torch.geometry import axis_angle_from_matrix, rotate_vector_axis_angle
from davo_tpu_torch.types import CameraViewsAndPoints
from davo_tpu_torch.utils.device import resolve_device

__all__ = [
    "SceneConfig",
    "draw_scene_noise",
    "scenes_from_noise",
    "generate_scene",
    "generate_batch",
]


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    """Scene sampling hyper-parameters (the JAX package's defaults)."""

    num_views: int = 4
    num_points: int = 8
    min_camera_distance: float = 0.1
    camera_distance_mean: float = 20.0
    camera_distance_std: float = 5.0
    camera_location_spread: float = 3.0
    camera_target_spread: float = 3.0
    camera_up_spread: float = 3.0
    points_std: float = 3.0
    fov_min_degrees: float = 30.0
    fov_max_degrees: float = 120.0
    # observation noise std ([-1, 1] pixel units); visibility is taken on
    # the noisy pixels
    pixel_noise: float = 0.0
    dtype: torch.dtype = torch.float32


def draw_scene_noise(
    generator: torch.Generator,
    batch_size: int,
    config: SceneConfig,
    device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Every standard-normal / uniform draw of ``batch_size`` scenes."""
    n, m, e = config.num_points, config.num_views, config.num_views - 1

    def normal(*shape):
        return torch.randn(
            (batch_size,) + shape, generator=generator, device=device, dtype=config.dtype
        )

    def uniform(*shape):
        return torch.rand(
            (batch_size,) + shape, generator=generator, device=device, dtype=config.dtype
        )

    noise = dict(
        z=normal(n, 1),
        xy=normal(n, 2),
        up_distance=normal(),
        target_scale=uniform(),
        target=normal(3),
        locations=normal(e, 3),
        targets=normal(e, 3),
        ups=normal(e, 3),
        fov=uniform(),
        centre=normal(2),
    )
    if config.pixel_noise > 0.0:
        noise["pixels"] = normal(m, n, 2)
    return noise


def _look_at_rotation(forward: torch.Tensor, up_ref: torch.Tensor) -> torch.Tensor:
    """Rows [right, down, forward]: world -> camera, right-handed."""
    forward = forward / torch.linalg.vector_norm(forward, dim=-1, keepdim=True)
    up = up_ref - forward * torch.sum(forward * up_ref, dim=-1, keepdim=True)
    up = up / torch.linalg.vector_norm(up, dim=-1, keepdim=True)
    down = -up
    right = torch.linalg.cross(down, forward, dim=-1)
    return torch.stack([right, down, forward], dim=-2)


def scenes_from_noise(noise: Dict[str, torch.Tensor], config: SceneConfig) -> CameraViewsAndPoints:
    """Build a batch of scenes from the draws of :func:`draw_scene_noise`."""
    world_points = torch.cat(
        [
            config.points_std * noise["xy"],
            torch.abs(config.camera_distance_mean + config.camera_distance_std * noise["z"]),
        ],
        dim=-1,
    )  # (B, N, 3)

    up_distance = torch.abs(
        config.camera_distance_mean + config.camera_distance_std * noise["up_distance"]
    )
    target_base = torch.mean(world_points, dim=1) * (1.0 + noise["target_scale"])[:, None] + (
        config.points_std / 2.0
    ) * noise["target"]  # (B, 3)
    up_base = up_distance[:, None] * torch.tensor(
        [0.0, -1.0, 0.0], dtype=world_points.dtype, device=world_points.device
    )

    locations = config.camera_location_spread * noise["locations"]  # (B, E, 3)
    targets = target_base[:, None] + config.camera_target_spread * noise["targets"]
    ups = up_base[:, None] + config.camera_up_spread * noise["ups"]

    rotations_mat = _look_at_rotation(targets - locations, ups - locations)
    forward = rotations_mat[..., 2, :]  # (B, E, 3)

    # push cameras back so every point is >= min_camera_distance in front
    depths = torch.sum(
        forward[:, :, None, :] * (world_points[:, None, :, :] - locations[:, :, None, :]), dim=-1
    )  # (B, E, N)
    shortfall = torch.amin(depths, dim=-1) - config.min_camera_distance
    backoff = torch.clamp(shortfall, max=0.0)
    locations = locations + backoff[..., None] * forward

    orientations = axis_angle_from_matrix(rotations_mat)
    translations = -torch.einsum("bvij,bvj->bvi", rotations_mat, locations)

    fov_lo = math.radians(config.fov_min_degrees)
    fov_span = math.radians(config.fov_max_degrees - config.fov_min_degrees)
    fov = fov_lo + fov_span * noise["fov"]
    focal_length = 1.0 / torch.tan(fov / 2.0)  # (B,)
    centre = torch.clamp(0.2 * noise["centre"], -0.5, 0.5)  # (B, 2)
    intrinsics = torch.cat([focal_length[:, None], centre], dim=-1)

    relative_extra = rotate_vector_axis_angle(
        world_points[:, None, :, :], orientations[:, :, None, :]
    ) + translations[:, :, None, :]
    relative = torch.cat([world_points[:, None], relative_extra], dim=1)  # (B, M, N, 3)
    z_rel = torch.clamp(relative[..., 2], min=1e-8)
    f_b = focal_length[:, None, None]
    u = f_b * relative[..., 0] / z_rel + centre[:, 0, None, None]
    v = f_b * relative[..., 1] / z_rel + centre[:, 1, None, None]
    projected = torch.stack([u, v], dim=-1)
    if config.pixel_noise > 0.0:
        projected = projected + config.pixel_noise * noise["pixels"]
        u, v = projected[..., 0], projected[..., 1]
    visibility = (u > -1.0) & (u < 1.0) & (v > -1.0) & (v < 1.0) & (relative[..., 2] > 0.0)

    return CameraViewsAndPoints(
        projected_points=projected,
        visibility_mask=visibility,
        camera_intrinsics=intrinsics,
        camera_orientations=orientations,
        camera_translations=translations,
        world_points=world_points,
    )


def generate_batch(
    generator: torch.Generator,
    batch_size: int,
    config: SceneConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> CameraViewsAndPoints:
    """Generate ``batch_size`` independent scenes on ``device`` (the card
    unless the caller asks for another).  ``generator`` must live on the
    same device."""
    device = resolve_device(device)
    return scenes_from_noise(draw_scene_noise(generator, batch_size, config, device), config)


def generate_scene(
    generator: torch.Generator,
    config: SceneConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> CameraViewsAndPoints:
    """Generate one scene (no batch dimension)."""
    batch = generate_batch(generator, 1, config, device)
    return CameraViewsAndPoints(*(x[0] for x in batch))
