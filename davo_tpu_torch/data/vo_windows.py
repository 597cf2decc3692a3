"""VO-style keyframe-window scenes, generated on the device (the port of
``davo_tpu/data/vo_windows.py``).

Each sample: a point cloud at the origin, M cameras on a random orbit-arc
segment (random radius, start angle, angular step, vertical bob), poses
re-expressed relative to the first camera (the ``CameraViewsAndPoints``
convention: world frame = view 1).  Optional augmentations, as in the JAX
package: Gaussian pixel noise (visibility taken on the noisy pixels),
verified-but-wrong assignments (``outlier_fraction``: a visible
non-anchor observation replaced by another point's projection in the same
view) and per-view visibility dropout.

All random numbers are drawn at once from a ``torch.Generator`` by
:func:`draw_window_noise`; :func:`windows_from_noise` is the deterministic
rest, so a test can feed it the JAX package's own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import torch

from davo_tpu_torch.geometry import axis_angle_from_matrix
from davo_tpu_torch.types import CameraViewsAndPoints
from davo_tpu_torch.utils.device import resolve_device

from .synthetic import _look_at_rotation

__all__ = [
    "VOWindowConfig",
    "draw_window_noise",
    "windows_from_noise",
    "generate_vo_window_batch",
]


@dataclasses.dataclass(frozen=True)
class VOWindowConfig:
    """Window sampling hyper-parameters (the JAX package's defaults)."""

    num_views: int = 4
    num_points: int = 8
    points_std: float = 3.0
    min_radius: float = 8.0
    max_radius: float = 16.0
    min_step: float = 0.05  # radians of arc between consecutive keyframes
    max_step: float = 0.3
    bob_amplitude: float = 1.5
    target_jitter: float = 1.5
    min_fov: float = math.pi / 6.0
    max_fov: float = 2.0 * math.pi / 3.0
    # std of Gaussian noise on the projected pixels (visibility is taken
    # on the noisy pixels)
    pixel_noise: float = 0.0
    # per non-anchor view m, d_m ~ U(0, visibility_dropout) and each
    # visible observation is dropped with probability d_m
    visibility_dropout: float = 0.0
    # per visible non-anchor observation, the probability of replacing its
    # pixel by another point's projection in the same view
    outlier_fraction: float = 0.0
    dtype: torch.dtype = torch.float32


def draw_window_noise(
    generator: torch.Generator,
    batch_size: int,
    config: VOWindowConfig,
    device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Every standard-normal / unit-uniform / integer draw of
    ``batch_size`` windows."""
    m, n = config.num_views, config.num_points

    def normal(*shape):
        return torch.randn((batch_size,) + shape, generator=generator, device=device, dtype=config.dtype)

    def uniform(*shape):
        return torch.rand((batch_size,) + shape, generator=generator, device=device, dtype=config.dtype)

    noise = dict(
        points=normal(n, 3),
        radius=uniform(),
        start=uniform(),
        step=uniform(),
        bob=uniform(),
        target=normal(3),
        fov=uniform(),
        centre=normal(2),
    )
    if config.pixel_noise > 0.0:
        noise["pixels"] = normal(m, n, 2)
    if config.outlier_fraction > 0.0:
        noise["swap"] = uniform(m, n)
        noise["shift"] = torch.randint(1, n, (batch_size, m, n), generator=generator, device=device)
    if config.visibility_dropout > 0.0:
        noise["rate"] = uniform(m, 1)
        noise["drop"] = uniform(m, n)
    return noise


def _uniform(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """A unit-uniform draw moved to ``[low, high)`` as ``jax.random.uniform``
    does it."""
    return torch.clamp(u * (high - low) + low, min=low)


def windows_from_noise(noise: Dict[str, torch.Tensor], config: VOWindowConfig) -> CameraViewsAndPoints:
    """Build a batch of windows from the draws of :func:`draw_window_noise`."""
    m, n = config.num_views, config.num_points
    points = config.points_std * noise["points"]  # (B, N, 3)
    dtype, device = points.dtype, points.device

    radius = _uniform(noise["radius"], config.min_radius, config.max_radius)  # (B,)
    start = _uniform(noise["start"], 0.0, 2.0 * math.pi)
    step = _uniform(noise["step"], config.min_step, config.max_step)
    phase = _uniform(noise["bob"], 0.0, 2.0 * math.pi)
    angles = start[:, None] + step[:, None] * torch.arange(m, dtype=dtype, device=device)  # (B, M)
    centres = torch.stack(
        [
            radius[:, None] * torch.sin(angles),
            config.bob_amplitude * torch.sin(2.0 * angles + phase[:, None]),
            -radius[:, None] * torch.cos(angles),
        ],
        dim=-1,
    )  # (B, M, 3)
    target = config.target_jitter * noise["target"]  # (B, 3)
    up = torch.tensor([0.0, -1.0, 0.0], dtype=dtype, device=device)
    rot = _look_at_rotation(target[:, None, :] - centres, up)  # (B, M, 3, 3)

    # re-express everything in the frame of view 1
    r0, c0 = rot[:, 0], centres[:, 0]
    points_v0 = torch.einsum("bij,bnj->bni", r0, points - c0[:, None, :])
    rel_rot = torch.einsum("bmij,bkj->bmik", rot[:, 1:], r0)  # R_j R0^T
    rel_trans = torch.einsum("bmij,bmj->bmi", rot[:, 1:], c0[:, None, :] - centres[:, 1:])
    orientations = axis_angle_from_matrix(rel_rot)

    fov = _uniform(noise["fov"], config.min_fov, config.max_fov)
    focal = 1.0 / torch.tan(fov / 2.0)  # (B,)
    centre_px = torch.clamp(0.2 * noise["centre"], -0.5, 0.5)  # (B, 2)
    intrinsics = torch.cat([focal[:, None], centre_px], dim=-1)

    rel = torch.cat(
        [
            points_v0[:, None],
            torch.einsum("bmij,bnj->bmni", rel_rot, points_v0) + rel_trans[:, :, None, :],
        ],
        dim=1,
    )  # (B, M, N, 3)
    z = torch.clamp(rel[..., 2], min=1e-8)
    u = focal[:, None, None] * rel[..., 0] / z + centre_px[:, 0, None, None]
    v = focal[:, None, None] * rel[..., 1] / z + centre_px[:, 1, None, None]
    projected = torch.stack([u, v], dim=-1)
    if config.pixel_noise > 0.0:
        projected = projected + config.pixel_noise * noise["pixels"]
        u, v = projected[..., 0], projected[..., 1]
    visibility = (u > -1.0) & (u < 1.0) & (v > -1.0) & (v < 1.0) & (rel[..., 2] > 0.1)
    if config.outlier_fraction > 0.0:
        swap = (noise["swap"] < config.outlier_fraction) & visibility
        swap[:, 0] = False  # anchor view stays clean
        # wrong assignment: another point's projection in the same view
        other = (torch.arange(n, device=device)[None, None, :] + noise["shift"]) % n
        wrong = torch.gather(projected, 2, other[..., None].expand(-1, -1, -1, 2))
        projected = torch.where(swap[..., None], wrong, projected)
    if config.visibility_dropout > 0.0:
        rate = _uniform(noise["rate"], 0.0, config.visibility_dropout)  # (B, M, 1)
        drop = noise["drop"] < rate
        drop[:, 0] = False  # anchor view keeps its detections
        visibility = visibility & ~drop
    return CameraViewsAndPoints(
        projected_points=projected,
        visibility_mask=visibility,
        camera_intrinsics=intrinsics,
        camera_orientations=orientations,
        camera_translations=rel_trans,
        world_points=points_v0,
    )


def generate_vo_window_batch(
    generator: torch.Generator,
    batch_size: int,
    config: VOWindowConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> CameraViewsAndPoints:
    """``batch_size`` independent VO-window scenes on ``device`` (the card
    unless the caller asks for another).  ``generator`` must live on the
    same device."""
    device = resolve_device(device)
    return windows_from_noise(draw_window_noise(generator, batch_size, config, device), config)
