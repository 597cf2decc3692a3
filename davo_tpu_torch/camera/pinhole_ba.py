"""Gauge-fixed multi-view pinhole bundle-adjustment objective (L1, L2 or
mixed) with its analytic batched gradient (the port of
``davo_tpu/camera/pinhole_ba.py``, the gen-1 objective).

Model: M views of N world points with shared intrinsics ``(f, cx, cy)``,
per-view translation and axis-angle rotation, and free world points.  The
first world point is pinned to the origin, the second to ``[1, 0, 0]``
and the third to the z = 0 plane, so

    P = 3 + 6 M + 3 N - 7

free parameters, laid out as

    [cx, cy, f,
     a_1..a_M, b_1..b_M, c_1..c_M,          (axis-angle per view)
     tx_1..tx_M, ty_1..ty_M, tz_1..tz_M,
     x_3..x_N, y_3..y_N, z_4..z_N]          (free world-point coordinates)

The camera-relative depth is clamped to ``max(max|x', y'| /
maximum_pixel_ratio, minimum_z_distance)`` with a straight-through
derivative (:func:`davo_tpu_torch.utils.straight_through_max`), so clamped
points keep pulling toward the camera plane.

:func:`ba_error_and_gradient` is the hand-derived chain rule, vectorised
over ``(..., M, N)``; it is the gen-1 solver's ``value_and_grad_fn`` and is
written out, not taken from autograd.  It is itself differentiable: the
``bfgs_solver_full_gradient`` recipe differentiates through it.  With
``max_gradient > 0`` every partial is scaled by ``min(1, max_gradient /
z)`` and clipped to ``+-max_gradient``, once.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from davo_tpu_torch.geometry import (
    rotate_vector_axis_angle,
    so3_parameter_jacobian,
    so3_rotation_matrix,
    wrap_axis_angle,
)
from davo_tpu_torch.utils.guards import straight_through_max

__all__ = [
    "PinholeBAConfig",
    "PinholeBAParams",
    "PinholeBAData",
    "num_ba_parameters",
    "ba_params_to_vector",
    "ba_params_from_vector",
    "ba_add_vector",
    "augmented_world_points",
    "ba_camera_relative_points",
    "ba_project",
    "ba_error",
    "ba_error_and_gradient",
]


@dataclasses.dataclass(frozen=True)
class PinholeBAConfig:
    minimum_z_distance: float = 1e-3
    maximum_pixel_ratio: float = 5.0
    constrain: bool = False
    max_gradient: float = -1.0  # <= 0 disables the gradient scaling and clipping
    # "l1", "l2", or "mixed" (L1 on u, L2 on v)
    error_norm: str = "l1"


class PinholeBAParams(NamedTuple):
    """BA parameters with leading batch dimensions ``(...)``:
    ``focal_length``, ``cx``, ``cy`` ``(...)``; ``translation`` and
    ``orientation`` (axis-angle) ``(..., M, 3)``; ``world_points``
    ``(..., N - 2, 3)``, the first row's z ignored (gauge-fixed to 0)."""

    focal_length: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    translation: torch.Tensor
    orientation: torch.Tensor
    world_points: torch.Tensor

    @property
    def num_views(self) -> int:
        return self.translation.shape[-2]

    @property
    def num_points(self) -> int:
        return self.world_points.shape[-2] + 2


class PinholeBAData(NamedTuple):
    """Observations broadcasting against the parameters' batch dimensions:
    ``true_projected_points (..., M, N, 2)`` and ``visibility_mask (...,
    M, N)`` (bool or float)."""

    true_projected_points: torch.Tensor
    visibility_mask: torch.Tensor


def num_ba_parameters(num_views: int, num_points: int) -> int:
    """``P = 3 + 6 M + 3 N - 7``."""
    return 3 + 6 * num_views + 3 * num_points - 7


def ba_params_to_vector(params: PinholeBAParams) -> torch.Tensor:
    """The canonical ``(..., P)`` layout."""
    t, o, w = params.translation, params.orientation, params.world_points
    return torch.cat(
        [
            params.cx[..., None],
            params.cy[..., None],
            params.focal_length[..., None],
            o[..., 0],
            o[..., 1],
            o[..., 2],
            t[..., 0],
            t[..., 1],
            t[..., 2],
            w[..., 0],
            w[..., 1],
            w[..., 1:, 2],
        ],
        dim=-1,
    )


def ba_params_from_vector(vector: torch.Tensor, num_views: int, num_points: int) -> PinholeBAParams:
    """Read an absolute ``(..., P)`` vector as parameters."""
    expected = num_ba_parameters(num_views, num_points)
    if vector.shape[-1] != expected:
        raise ValueError(
            f"Expected parameter vectors of size {expected} for M={num_views}, N={num_points}; "
            f"got {vector.shape[-1]}"
        )
    m, n_free = num_views, num_points - 2
    a, b, c, tx, ty, tz, x, y, z = torch.split(
        vector[..., 3:], (m, m, m, m, m, m, n_free, n_free, num_points - 3), dim=-1
    )
    z = torch.cat([torch.zeros_like(z[..., 0:1]), z], dim=-1)
    return PinholeBAParams(
        focal_length=vector[..., 2],
        cx=vector[..., 0],
        cy=vector[..., 1],
        translation=torch.stack([tx, ty, tz], dim=-1),
        orientation=torch.stack([a, b, c], dim=-1),
        world_points=torch.stack([x, y, z], dim=-1),
    )


def ba_add_vector(
    params: PinholeBAParams, delta: torch.Tensor, config: PinholeBAConfig = PinholeBAConfig()
) -> PinholeBAParams:
    """Apply a flat ``(..., P)`` step.  With ``config.constrain`` the
    rotation wraps to ``[-pi, pi]``, the focal length clamps to
    ``[1/maximum_pixel_ratio, 1e3]`` and the principal point to ``[-1,
    1]``."""
    d = ba_params_from_vector(delta, params.num_views, params.num_points)
    focal = params.focal_length + d.focal_length
    cx = params.cx + d.cx
    cy = params.cy + d.cy
    orientation = params.orientation + d.orientation
    if config.constrain:
        orientation = wrap_axis_angle(orientation)
        focal = torch.clamp(focal, 1.0 / abs(config.maximum_pixel_ratio), 1e3)
        cx = torch.clamp(cx, -1.0, 1.0)
        cy = torch.clamp(cy, -1.0, 1.0)
    return PinholeBAParams(
        focal_length=focal,
        cx=cx,
        cy=cy,
        translation=params.translation + d.translation,
        orientation=orientation,
        world_points=params.world_points + d.world_points,
    )


def augmented_world_points(params: PinholeBAParams) -> torch.Tensor:
    """``(..., N, 3)``: the gauge points ``[0, 0, 0]``, ``[1, 0, 0]``,
    ``[x0, y0, 0]``, then the free points."""
    w = params.world_points
    zeros = torch.zeros(w.shape[:-2] + (1, 3), dtype=w.dtype, device=w.device)
    unit_x = zeros.clone()
    unit_x[..., 0, 0] = 1.0
    third = torch.cat([w[..., 0:1, 0:2], torch.zeros_like(w[..., 0:1, 2:3])], dim=-1)
    return torch.cat([zeros, unit_x, third, w[..., 1:, :]], dim=-2)


def ba_camera_relative_points(params: PinholeBAParams, config: PinholeBAConfig = PinholeBAConfig()) -> torch.Tensor:
    """``(..., M, N, 3)`` camera-relative points with the straight-through
    depth clamp."""
    world = augmented_world_points(params)
    rotated = rotate_vector_axis_angle(world[..., None, :, :], params.orientation[..., :, None, :])
    rotated = rotated + params.translation[..., :, None, :]
    inv_ratio = 1.0 / abs(config.maximum_pixel_ratio)
    min_z = torch.amax(torch.abs(inv_ratio * rotated[..., 0:2]), dim=-1)
    min_z = torch.clamp(min_z, min=config.minimum_z_distance)
    z = straight_through_max(rotated[..., 2], min_z.detach())
    return torch.cat([rotated[..., 0:2], z[..., None]], dim=-1)


def ba_project(params: PinholeBAParams, config: PinholeBAConfig = PinholeBAConfig()) -> torch.Tensor:
    """``(..., M, N, 2)`` pixels ``f xy / z + (cx, cy)``."""
    rel = ba_camera_relative_points(params, config)
    f = params.focal_length[..., None, None, None]
    centre = torch.stack([params.cx, params.cy], dim=-1)[..., None, None, :]
    return f * rel[..., 0:2] / rel[..., 2:3] + centre


def _error_scale(num_views: int, num_points: int) -> float:
    return float(1.0 / (num_views * num_points)) ** 0.5


def _residual_norms(res_u, res_v, config: PinholeBAConfig):
    """Per-residual error terms and their derivatives in the residual:
    L1 ``(|r|, sign r)``, L2 ``(r^2, 2 r)``, mixed L1 on u and L2 on v."""
    if config.error_norm == "l1":
        return torch.abs(res_u), torch.abs(res_v), torch.sign(res_u), torch.sign(res_v)
    if config.error_norm == "l2":
        return torch.square(res_u), torch.square(res_v), 2.0 * res_u, 2.0 * res_v
    if config.error_norm == "mixed":
        return torch.abs(res_u), torch.square(res_v), torch.sign(res_u), 2.0 * res_v
    raise ValueError(f"Unknown error_norm: {config.error_norm!r}")


def ba_error(params: PinholeBAParams, data: PinholeBAData, config: PinholeBAConfig = PinholeBAConfig()) -> torch.Tensor:
    """Masked reprojection error scaled by ``sqrt(1/(M N))``, of the
    parameters' batch shape.  Visibility weights the error terms (norm
    first, then weight), as in the analytic gradient."""
    uv = ba_project(params, config)
    residuals = uv - data.true_projected_points
    vis = data.visibility_mask.to(uv.dtype)
    scale = _error_scale(params.num_views, params.num_points)
    err_u, err_v, _, _ = _residual_norms(residuals[..., 0], residuals[..., 1], config)
    return scale * torch.sum((err_u + err_v) * vis, dim=(-1, -2))


def ba_error_and_gradient(
    params: PinholeBAParams, data: PinholeBAData, config: PinholeBAConfig = PinholeBAConfig()
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The error and its analytic gradient in the flat layout:

        du/d[x'y'z'] = [f/z, 0, -f x/z^2],  dv/d... = [0, f/z, -f y/z^2]
        d[x'y'z']/d(rotation parameters) = so3_parameter_jacobian
        d[x'y'z']/d(world point)         = R (the rotation matrix)
        d[x'y'z']/d(translation)         = I

    contracted against the residual norm's derivatives.

    :return: ``(error, gradient)`` of shapes ``(...)`` and ``(..., P)``.
    """
    world = augmented_world_points(params)  # (..., N, 3)
    rel = ba_camera_relative_points(params, config)  # (..., M, N, 3)
    x, y, z = rel[..., 0], rel[..., 1], rel[..., 2]
    f = params.focal_length[..., None, None]
    u = f * x / z + params.cx[..., None, None]
    v = f * y / z + params.cy[..., None, None]

    true_uv = data.true_projected_points
    vis = data.visibility_mask.to(u.dtype)
    scale = _error_scale(params.num_views, params.num_points)
    res_u = u - true_uv[..., 0]
    res_v = v - true_uv[..., 1]
    err_u, err_v, d_u, d_v = _residual_norms(res_u, res_v, config)
    error = scale * torch.sum((err_u + err_v) * vis, dim=(-1, -2))
    sign_u = scale * vis * d_u
    sign_v = scale * vis * d_v

    inv_z = 1.0 / z
    f_on_z = f * inv_z
    x_on_z = x * inv_z
    y_on_z = y * inv_z
    du_dx = f_on_z
    du_dz = -f_on_z * x_on_z
    dv_dy = f_on_z
    dv_dz = -f_on_z * y_on_z
    du_df = x_on_z
    dv_df = y_on_z

    g = config.max_gradient
    if g > 0.0:
        sf = torch.clamp(g * inv_z, max=1.0)

        def clip(t):
            return torch.clamp(sf * t, -g, g)

        du_dx, du_dz = clip(du_dx), clip(du_dz)
        dv_dy, dv_dz = clip(dv_dy), clip(dv_dz)
        du_df, dv_df = clip(du_df), clip(dv_df)

    # the rotated point's Jacobian in the rotation parameters, (..., M, N, 3, 3)
    j_rot = so3_parameter_jacobian(world[..., None, :, :], params.orientation[..., :, None, :])
    # in the world point: the rotation matrix, (..., M, 1, 3, 3)
    j_world = so3_rotation_matrix(params.orientation)[..., None, :, :]

    du_drot = du_dx[..., None] * j_rot[..., 0, :] + du_dz[..., None] * j_rot[..., 2, :]
    dv_drot = dv_dy[..., None] * j_rot[..., 1, :] + dv_dz[..., None] * j_rot[..., 2, :]
    du_dworld = du_dx[..., None] * j_world[..., 0, :] + du_dz[..., None] * j_world[..., 2, :]
    dv_dworld = dv_dy[..., None] * j_world[..., 1, :] + dv_dz[..., None] * j_world[..., 2, :]

    if g > 0.0:
        sf_e = sf[..., None]
        du_drot = torch.clamp(sf_e * du_drot, -g, g)
        dv_drot = torch.clamp(sf_e * dv_drot, -g, g)
        du_dworld = torch.clamp(sf_e * du_dworld, -g, g)
        dv_dworld = torch.clamp(sf_e * dv_dworld, -g, g)

    # reduce into the flat layout
    g_cx = torch.sum(sign_u, dim=(-1, -2))[..., None]
    g_cy = torch.sum(sign_v, dim=(-1, -2))[..., None]
    g_f = torch.sum(sign_u * du_df + sign_v * dv_df, dim=(-1, -2))[..., None]
    # per view: sums over the points, (..., M, 3)
    g_rot = torch.sum(sign_u[..., None] * du_drot + sign_v[..., None] * dv_drot, dim=-2)
    g_tx = torch.sum(sign_u * du_dx, dim=-1)
    g_ty = torch.sum(sign_v * dv_dy, dim=-1)
    g_tz = torch.sum(sign_u * du_dz + sign_v * dv_dz, dim=-1)
    # per point: sums over the views; points 0 and 1 are fixed, point 2
    # has free x and y only
    g_world = torch.sum(sign_u[..., None] * du_dworld + sign_v[..., None] * dv_dworld, dim=-3)  # (..., N, 3)
    gradient = torch.cat(
        [
            g_cx,
            g_cy,
            g_f,
            g_rot[..., 0],
            g_rot[..., 1],
            g_rot[..., 2],
            g_tx,
            g_ty,
            g_tz,
            g_world[..., 2:, 0],
            g_world[..., 2:, 1],
            g_world[..., 3:, 2],
        ],
        dim=-1,
    )
    return error, gradient
