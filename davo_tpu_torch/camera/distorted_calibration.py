"""Distorted-camera calibration: Brown-Conrady scenes and their
Levenberg-Marquardt refinement (the port of
``davo_tpu/camera/distorted_calibration.py``).

Batched synthetic scenes with known distortion (one camera observing
known world points), and a lockstep LM solve
(:func:`davo_tpu_torch.solve.least_squares.levenberg_marquardt`) that
recovers all 16 parameters from the observed pixels.  The LM runs in
plain PyTorch, as the JAX package's runs in plain XLA: no kernel.

Scenes come from a ``torch.Generator``, drawn in the order the JAX
function splits its key; ``jax.random`` draws other numbers, so the two
packages' metrics agree statistically, not draw by draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from davo_tpu_torch.solve.least_squares import LMConfig, levenberg_marquardt
from davo_tpu_torch.utils.device import resolve_device
from davo_tpu_torch.utils.precision import full_f32_matmuls

from .distortion import NUM_DISTORTED_PARAMS, distorted_project, distorted_project_and_jacobian

__all__ = [
    "DistortedSceneConfig",
    "generate_distorted_scenes",
    "refine_distorted",
    "evaluate_distorted_calibration",
]


@dataclasses.dataclass(frozen=True)
class DistortedSceneConfig:
    """Sampling ranges of the synthetic scenes.

    One scene is one camera observing ``num_points`` known world points
    (a calibration target): 2N observations against 16 parameters, so
    ``num_points >= 16`` keeps the system over-determined.
    """

    num_points: int = 32
    points_spread: float = 2.0  # xy extent of the target cloud
    points_depth_spread: float = 1.5  # z extent (a non-coplanar target)
    camera_distance: float = 6.0
    focal_range: Tuple[float, float] = (1.2, 2.2)
    skew_range: Tuple[float, float] = (-0.02, 0.02)
    centre_range: Tuple[float, float] = (-0.2, 0.2)
    k1_range: Tuple[float, float] = (-0.15, 0.15)
    k2_range: Tuple[float, float] = (-0.05, 0.05)
    k3_range: Tuple[float, float] = (-0.01, 0.01)
    p_range: Tuple[float, float] = (-0.01, 0.01)
    rotation_range: Tuple[float, float] = (-0.2, 0.2)
    dtype: torch.dtype = torch.float32


def generate_distorted_scenes(
    generator: torch.Generator,
    batch: int,
    config: DistortedSceneConfig = DistortedSceneConfig(),
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sample ``batch`` scenes on ``device`` (the card unless the caller
    asks for another; the generator must live there).

    :return: ``(world_points (B, N, 3), pixels (B, N, 2), true_params
        (B, 16))``, the pixels the exact distorted projections.
    """
    device = resolve_device(device)
    dtype, n = config.dtype, config.num_points

    def uni(lo, hi, shape=(batch,)):
        return lo + (hi - lo) * torch.rand(shape, generator=generator, dtype=dtype, device=device)

    xy = config.points_spread * uni(-1.0, 1.0, (batch, n, 2))
    z = config.points_depth_spread * uni(-1.0, 1.0, (batch, n, 1))
    world = torch.cat([xy, z], dim=-1)
    fx, fy = uni(*config.focal_range), uni(*config.focal_range)
    s = uni(*config.skew_range)
    cx, cy = uni(*config.centre_range), uni(*config.centre_range)
    k1, k2, k3 = uni(*config.k1_range), uni(*config.k2_range), uni(*config.k3_range)
    p1, p2 = uni(*config.p_range), uni(*config.p_range)
    rx, ry, rz = (uni(*config.rotation_range) for _ in range(3))
    t_xy = 0.3 * torch.randn((batch, 2), generator=generator, dtype=dtype, device=device)
    tz = config.camera_distance + uni(-1.0, 1.0)
    params = torch.stack(
        [cx, cy, k1, k2, k3, p1, p2, fx, s, fy, rx, ry, rz, t_xy[:, 0], t_xy[:, 1], tz], dim=-1
    )
    return world, distorted_project(world, params), params


def refine_distorted(
    world_points: torch.Tensor,
    pixels: torch.Tensor,
    initial_params: torch.Tensor,
    config: LMConfig = LMConfig(iterations=60),
) -> torch.Tensor:
    """LM-refine the 16 parameters against the observed pixels, batched
    over the leading dimensions.

    The residuals are the ``2N`` flattened reprojection differences and
    the ``(2N, 16)`` Jacobian is
    :func:`davo_tpu_torch.camera.distorted_project_and_jacobian`.  On the
    card TF32 is turned off first (the JAX function's ``full_f32_matmuls``):
    ``J^T J`` in reduced-precision products loses the conditioning the
    16-parameter recovery needs (the JAX package measured mean and max
    parameter errors of 1.8e-3 and 2.4 in bf16 passes against 1e-6 and
    3e-4 in full float32).
    """
    if world_points.device.type == "cuda":
        full_f32_matmuls()
    batch = initial_params.shape[:-1]

    def residuals(params):
        return (distorted_project(world_points, params) - pixels).reshape(*batch, -1)

    def residual_and_jacobian(params):
        proj, jac = distorted_project_and_jacobian(world_points, params)
        res = (proj - pixels).reshape(*batch, -1)
        return res, jac.reshape(*batch, res.shape[-1], NUM_DISTORTED_PARAMS)

    return levenberg_marquardt(residual_and_jacobian, initial_params, config, residual_fn=residuals)


def evaluate_distorted_calibration(
    generator: torch.Generator,
    batch: int = 16,
    perturbation: float = 0.02,
    pixel_noise: float = 0.0,
    scene: DistortedSceneConfig = DistortedSceneConfig(),
    lm: LMConfig = LMConfig(iterations=60),
    device: Optional[Union[str, torch.device]] = None,
) -> dict:
    """Recovery metrics end to end: scenes, a perturbed start, LM, the
    parameter errors.

    :param perturbation: standard deviation of the Gaussian start offset of
        every parameter (the translation's is 5 times larger: its scale is
        about the camera distance).
    :return: the JAX function's keys: ``max_param_error``,
        ``mean_param_error``, ``rms_residual`` (after refinement) and
        ``start_max_param_error``.
    """
    device = resolve_device(device)
    world, pixels, true_params = generate_distorted_scenes(generator, batch, scene, device)
    if pixel_noise > 0.0:
        pixels = pixels + pixel_noise * torch.randn(pixels.shape, generator=generator, dtype=pixels.dtype,
                                                    device=device)
    scale = torch.ones(NUM_DISTORTED_PARAMS, dtype=true_params.dtype, device=device)
    scale[13:16] = 5.0
    start = true_params + perturbation * scale * torch.randn(
        true_params.shape, generator=generator, dtype=true_params.dtype, device=device
    )
    refined = refine_distorted(world, pixels, start, lm)
    err = torch.abs(refined - true_params)
    final_res = distorted_project(world, refined) - pixels
    return {
        "max_param_error": float(torch.max(err)),
        "mean_param_error": float(torch.mean(err)),
        "rms_residual": float(torch.sqrt(torch.mean(torch.square(final_res)))),
        "start_max_param_error": float(torch.max(torch.abs(start - true_params))),
    }
