"""Channel-major (batch-minor) calibration objective (the port of
``davo_tpu/camera/calibration_fast.py``).

Semantically identical to :func:`davo_tpu_torch.camera.calibration_error`,
but every intermediate is a structure-of-arrays component of shape
``(N, B)``, ``(M, N, B)`` or ``(B,)`` and the small view and coordinate
axes are unrolled in Python.  It is the plain objective of the eval solve:
the Wolfe line search differentiates it in forward mode, and kernel K2
(:mod:`davo_tpu_torch.ops.calibration_obj`) evaluates its value and
gradient with ``approx_atan2=True``.
"""

from __future__ import annotations

import torch

from davo_tpu_torch.geometry.distances import _NORM_FLOOR
from davo_tpu_torch.utils.guards import guarded_sqrt
from davo_tpu_torch.utils.stable_trig import cos_from_sq, one_minus_cos_sq, sinc_sq

__all__ = [
    "calibration_error_fast",
    "calibration_error_channel_major",
    "first_quadrant_atan2_poly",
]

_TAN_PI_8 = 0.41421356237309503
_PI_4 = 0.7853981633974483
_PI_2 = 1.5707963267948966
# Cephes atanf minimax coefficients, highest order first, valid for
# |t| <= tan(pi/8)
ATAN_COEFFS = (
    8.05374449538e-2,
    -1.38776856032e-1,
    1.99777106478e-1,
    -3.33329491539e-1,
)


def _atan_poly(t: torch.Tensor) -> torch.Tensor:
    z = t * t
    p = ATAN_COEFFS[0] * z + ATAN_COEFFS[1]
    p = p * z + ATAN_COEFFS[2]
    p = p * z + ATAN_COEFFS[3]
    return p * z * t + t


def first_quadrant_atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``atan2(y, x)`` for ``y, x >= 0`` by a polynomial: fold onto
    ``t = min/max``, reduce ``t > tan(pi/8)`` with
    ``atan(t) = pi/4 + atan((t-1)/(t+1))``, evaluate the cephes
    polynomial and unfold.  Accuracy ~1e-7 absolute; both zero give 0.

    Selection is by ``where`` (not min/max), so the derivative on the
    ``y == x`` diagonal follows one branch instead of splitting.
    """
    swap = y > x
    num = torch.where(swap, x, y)
    den = torch.clamp(torch.where(swap, y, x), min=1e-30)
    t = num / den
    reduced = t > _TAN_PI_8
    tr = torch.where(reduced, (t - 1.0) / (t + 1.0), t)
    a = _atan_poly(tr) + torch.where(
        reduced, torch.full_like(t, _PI_4), torch.zeros_like(t)
    )
    return torch.where(swap, _PI_2 - a, a)


def calibration_error_fast(
    parameters: torch.Tensor,
    true_projected_points: torch.Tensor,
    visibility_mask: torch.Tensor,
) -> torch.Tensor:
    """:func:`calibration_error` for a ``(B, P)`` batch through the
    channel-major core."""
    if parameters.ndim != 2:
        raise ValueError("calibration_error_fast expects a (B, P) batch")
    dtype = parameters.dtype
    u_t = true_projected_points[..., 0].permute(1, 2, 0).to(dtype)
    v_t = true_projected_points[..., 1].permute(1, 2, 0).to(dtype)
    vis_t = visibility_mask.permute(1, 2, 0).to(dtype)
    return calibration_error_channel_major(parameters.T, u_t, v_t, vis_t)


def calibration_error_channel_major(
    pt: torch.Tensor,
    u_t: torch.Tensor,
    v_t: torch.Tensor,
    vis_t: torch.Tensor,
    *,
    approx_atan2: bool = False,
) -> torch.Tensor:
    """Structure-of-arrays calibration objective.

    :param pt: ``(P, B)`` transposed parameter vectors.
    :param u_t: ``(M, N, B)`` observed pixel x components.
    :param v_t: ``(M, N, B)`` observed pixel y components.
    :param vis_t: ``(M, N, B)`` visibility as floats.
    :param approx_atan2: use :func:`first_quadrant_atan2_poly` instead of
        ``torch.atan2`` (the form kernel K2 evaluates).
    :return: ``(B,)`` summed masked angular error.
    """
    num_views, num_points = u_t.shape[0], u_t.shape[1]
    batch = pt.shape[-1]

    f, cx, cy = pt[0], pt[1], pt[2]
    points_end = 3 + 3 * num_points
    w = pt[3:points_end].reshape(num_points, 3, batch)
    wx, wy, wz = w[:, 0], w[:, 1], w[:, 2]  # (N, B)
    trans_end = points_end + 3 * (num_views - 1)
    t = pt[points_end:trans_end].reshape(num_views - 1, 3, batch)
    r = pt[trans_end:].reshape(num_views - 1, 3, batch)

    # gauge rescale: mean |coordinate| over points and camera centres -> 1
    points_scale = torch.mean(torch.abs(wx) + torch.abs(wy) + torch.abs(wz), dim=0) / 3.0
    camera_scale = torch.mean(torch.abs(t), dim=(0, 1))
    overall = (points_scale * num_points + camera_scale * num_views) / (
        num_points + num_views
    )
    inv_scale = 1.0 / torch.clamp(overall, min=1e-6)
    wx, wy, wz = wx * inv_scale, wy * inv_scale, wz * inv_scale

    # rays (u - c, f') with f' = elu(f) + 1 = where(f > 0, f + 1, exp(f));
    # the inner where keeps the unselected exp branch finite
    positive = f > 0.0
    focal = torch.where(positive, f + 1.0, torch.exp(torch.where(positive, torch.zeros_like(f), f)))
    ray_x = u_t - cx
    ray_y = v_t - cy
    inv_ray_norm = 1.0 / torch.clamp(
        torch.sqrt(ray_x * ray_x + ray_y * ray_y + focal * focal), min=_NORM_FLOOR
    )

    total = torch.zeros_like(f)
    for m in range(num_views):
        if m == 0:
            qx, qy, qz = wx, wy, wz
        else:
            ox, oy, oz = r[m - 1, 0], r[m - 1, 1], r[m - 1, 2]
            tx = t[m - 1, 0] * inv_scale
            ty = t[m - 1, 1] * inv_scale
            tz = t[m - 1, 2] * inv_scale
            s_ang = ox * ox + oy * oy + oz * oz
            cos_theta = cos_from_sq(s_ang)
            f1 = sinc_sq(s_ang)
            f4 = one_minus_cos_sq(s_ang)
            dot = wx * ox + wy * oy + wz * oz  # (N, B)
            qx = wx * cos_theta + f4 * dot * ox + (oy * wz - oz * wy) * f1 + tx
            qy = wy * cos_theta + f4 * dot * oy + (oz * wx - ox * wz) * f1 + ty
            qz = wz * cos_theta + f4 * dot * oz + (ox * wy - oy * wx) * f1 + tz

        inv_qn = 1.0 / torch.clamp(
            torch.sqrt(qx * qx + qy * qy + qz * qz), min=_NORM_FLOOR
        )
        ax = ray_x[m] * inv_ray_norm[m]
        ay = ray_y[m] * inv_ray_norm[m]
        az = focal * inv_ray_norm[m]
        bx, by, bz = qx * inv_qn, qy * inv_qn, qz * inv_qn
        diff = guarded_sqrt((ax - bx) ** 2 + (ay - by) ** 2 + (az - bz) ** 2)
        summ = guarded_sqrt((ax + bx) ** 2 + (ay + by) ** 2 + (az + bz) ** 2)
        if approx_atan2:
            theta = 2.0 * first_quadrant_atan2_poly(diff, summ)
        else:
            theta = 2.0 * torch.atan2(diff, summ)
        total = total + torch.sum(theta * vis_t[m], dim=0)
    return total
