"""Brown-Conrady distorted camera model (16 parameters) with batched
Jacobians (the port of ``davo_tpu/camera/distortion.py``).

Parameter layout ``(..., 16)``:

    [cx, cy, k1, k2, k3, p1, p2, fx, s, fy, rx, ry, rz, tx, ty, tz]

* extrinsics: Euler angles composed as ``Rz @ Ry @ Rx`` and a translation;
* intrinsics: focal lengths ``fx, fy`` and skew ``s``;
* distortion: radial ``k1, k2, k3`` and tangential ``p1, p2``, applied to
  the normalised pinhole coordinates.

:func:`distorted_project_and_jacobian` assembles the ``(N, 2, 16)``
Jacobian in closed form by the stage chain rule; it equals
:func:`distorted_project_and_jacobian_jacfwd` (``torch.func.jacfwd`` over
the 16 parameters, the tests' reference) to rounding.  Levenberg-Marquardt
refines the parameters with it
(:mod:`davo_tpu_torch.camera.distorted_calibration`).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "DISTORTED_PARAM_NAMES",
    "NUM_DISTORTED_PARAMS",
    "distorted_project",
    "distorted_project_and_jacobian",
    "distorted_project_and_jacobian_jacfwd",
]

DISTORTED_PARAM_NAMES = (
    "cx", "cy", "k1", "k2", "k3", "p1", "p2",
    "fx", "s", "fy", "rx", "ry", "rz", "tx", "ty", "tz",
)
NUM_DISTORTED_PARAMS = 16

CX, CY, K1, K2, K3, P1, P2, FX, S, FY, RX, RY, RZ, TX, TY, TZ = range(16)


def _euler_zyx_matrix(rx, ry, rz):
    """``Rz(rz) @ Ry(ry) @ Rx(rx)``, shape ``(..., 3, 3)``."""
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    row0 = torch.stack([cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz], -1)
    row1 = torch.stack([cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz], -1)
    row2 = torch.stack([-sy, sx * cy, cx * cy], -1)
    return torch.stack([row0, row1, row2], dim=-2)


def _camera_points(points_3d, parameters):
    """World points in the camera's frame, ``(..., N, 3)``."""
    rot = _euler_zyx_matrix(parameters[..., RX], parameters[..., RY], parameters[..., RZ])
    cam = torch.einsum("...ij,...nj->...ni", rot, points_3d)
    return cam + parameters[..., None, TX:TZ + 1]


def distorted_project(points_3d: torch.Tensor, parameters: torch.Tensor) -> torch.Tensor:
    """Project world points through the 16-parameter distorted camera.

    :param points_3d: ``(..., N, 3)`` world points.
    :param parameters: ``(..., 16)`` model parameters.
    :return: ``(..., N, 2)`` distorted pixel coordinates.
    """
    p = parameters[..., None, :]  # broadcast over points
    cam = _camera_points(points_3d, parameters)
    z = cam[..., 2]
    z = torch.where(z == 0.0, 1e-8, z)
    x_on_z = cam[..., 0] / z
    y_on_z = cam[..., 1] / z
    u = p[..., FX] * x_on_z + p[..., S] * y_on_z
    v = p[..., FY] * y_on_z
    r2 = u * u + v * v
    radial = 1.0 + p[..., K1] * r2 + p[..., K2] * r2 * r2 + p[..., K3] * r2 * r2 * r2
    uv = u * v
    u_prime = u * radial + 2.0 * p[..., P1] * uv + p[..., P2] * (r2 + 2.0 * u * u) + p[..., CX]
    v_prime = v * radial + 2.0 * p[..., P2] * uv + p[..., P1] * (r2 + 2.0 * v * v) + p[..., CY]
    return torch.stack([u_prime, v_prime], dim=-1)


def _euler_zyx_derivatives(rx, ry, rz):
    """``(dR/drx, dR/dry, dR/drz)`` of :func:`_euler_zyx_matrix`."""
    sx, cx = torch.sin(rx), torch.cos(rx)
    sy, cy = torch.sin(ry), torch.cos(ry)
    sz, cz = torch.sin(rz), torch.cos(rz)
    zero = torch.zeros_like(sx)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    d_rx = mat([
        [zero, cx * sy * cz + sx * sz, -sx * sy * cz + cx * sz],
        [zero, cx * sy * sz - sx * cz, -sx * sy * sz - cx * cz],
        [zero, cx * cy, -sx * cy],
    ])
    d_ry = mat([
        [-sy * cz, sx * cy * cz, cx * cy * cz],
        [-sy * sz, sx * cy * sz, cx * cy * sz],
        [-cy, -sx * sy, -cx * sy],
    ])
    d_rz = mat([
        [-cy * sz, -sx * sy * sz - cx * cz, -cx * sy * sz + sx * cz],
        [cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
        [zero, zero, zero],
    ])
    return d_rx, d_ry, d_rz


def distorted_project_and_jacobian(
    points_3d: torch.Tensor, parameters: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projection and its closed-form Jacobian with respect to the 16
    parameters.

    The intrinsics' and distortion's columns are written in the
    distorted-plane quantities; the six pose columns share one 2 x 3
    downstream Jacobian ``d(pixels)/d(cam)``.  Where a point's depth is 0,
    the guard replaces it by 1e-8 and passes no depth derivative
    (``zmask``), as autodiff through the guard does.

    :return: ``(pixels (..., N, 2), jacobian (..., N, 2, 16))``.
    """
    p = parameters[..., None, :]  # broadcast over points
    rx, ry, rz = parameters[..., RX], parameters[..., RY], parameters[..., RZ]
    cam = _camera_points(points_3d, parameters)
    z_raw = cam[..., 2]
    z = torch.where(z_raw == 0.0, 1e-8, z_raw)
    zmask = (z_raw != 0.0).to(z.dtype)
    a = cam[..., 0] / z
    b = cam[..., 1] / z
    fx, skew, fy = p[..., FX], p[..., S], p[..., FY]
    k1, k2, k3 = p[..., K1], p[..., K2], p[..., K3]
    tp1, tp2 = p[..., P1], p[..., P2]
    u = fx * a + skew * b
    v = fy * b
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    radial = 1.0 + k1 * r2 + k2 * r4 + k3 * r6
    uv = u * v
    u_prime = u * radial + 2.0 * tp1 * uv + tp2 * (r2 + 2.0 * u * u) + p[..., CX]
    v_prime = v * radial + 2.0 * tp2 * uv + tp1 * (r2 + 2.0 * v * v) + p[..., CY]
    pixels = torch.stack([u_prime, v_prime], dim=-1)

    # distorted-plane Jacobian d(u', v')/d(u, v), symmetric off the diagonal
    g = k1 + 2.0 * k2 * r2 + 3.0 * k3 * r4  # d(radial)/d(r2)
    duu = radial + 2.0 * u * u * g + 2.0 * tp1 * v + 6.0 * tp2 * u
    duv = 2.0 * uv * g + 2.0 * tp1 * u + 2.0 * tp2 * v
    dvv = radial + 2.0 * v * v * g + 2.0 * tp2 * u + 6.0 * tp1 * v

    # d(u, v)/d(cam), 2 x 3: u, v are affine in (a, b) = cam_xy / z
    inv_z = 1.0 / z
    du_dc = (fx * inv_z, skew * inv_z, -u * inv_z * zmask)
    dv_dc = (torch.zeros_like(v), fy * inv_z, -v * inv_z * zmask)
    # the downstream 2 x 3 chain every pose column shares
    jpc0 = tuple(duu * dc0 + duv * dc1 for dc0, dc1 in zip(du_dc, dv_dc))
    jpc1 = tuple(duv * dc0 + dvv * dc1 for dc0, dc1 in zip(du_dc, dv_dc))

    d_rx, d_ry, d_rz = _euler_zyx_derivatives(rx, ry, rz)
    ones, zeros = torch.ones_like(u), torch.zeros_like(u)
    cols = [None] * NUM_DISTORTED_PARAMS
    cols[CX] = (ones, zeros)
    cols[CY] = (zeros, ones)
    cols[K1] = (u * r2, v * r2)
    cols[K2] = (u * r4, v * r4)
    cols[K3] = (u * r6, v * r6)
    cols[P1] = (2.0 * uv, r2 + 2.0 * v * v)
    cols[P2] = (r2 + 2.0 * u * u, 2.0 * uv)
    cols[FX] = (duu * a, duv * a)
    cols[S] = (duu * b, duv * b)
    cols[FY] = (duv * b, dvv * b)
    for idx, d_rot in ((RX, d_rx), (RY, d_ry), (RZ, d_rz)):
        dcam = torch.einsum("...ij,...nj->...ni", d_rot, points_3d)
        cols[idx] = (
            sum(jpc0[i] * dcam[..., i] for i in range(3)),
            sum(jpc1[i] * dcam[..., i] for i in range(3)),
        )
    for axis, idx in enumerate((TX, TY, TZ)):
        cols[idx] = (jpc0[axis], jpc1[axis])
    jac = torch.stack([torch.stack(col, dim=-1) for col in cols], dim=-1)  # (..., N, 2, 16)
    return pixels, jac


def distorted_project_and_jacobian_jacfwd(
    points_3d: torch.Tensor, parameters: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Autodiff reference for :func:`distorted_project_and_jacobian`: 16
    forward tangents through :func:`distorted_project` by
    ``torch.func.jacfwd``, vmapped over the leading dimensions."""
    batch = parameters.shape[:-1]
    points = points_3d.expand(*batch, *points_3d.shape[-2:]).reshape(-1, *points_3d.shape[-2:])
    jac = torch.func.vmap(torch.func.jacfwd(lambda q, x: distorted_project(x, q)))(
        parameters.reshape(-1, NUM_DISTORTED_PARAMS), points
    )
    return distorted_project(points_3d, parameters), jac.reshape(*batch, *jac.shape[1:])
