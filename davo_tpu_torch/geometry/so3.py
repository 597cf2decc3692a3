"""SO(3) via the axis-angle chart (the port of ``davo_tpu/geometry/so3.py``).

Rodrigues' formula for an unnormalised axis ``w`` with ``s = |w|^2``:

    R(w) v = v cos(x) + f4 (w . v) w + f1 (w x v)

with the squared-angle ratios of :mod:`davo_tpu_torch.utils.stable_trig`,
so values and derivatives are finite at the identity.  The matrix to
axis-angle conversion serves the synthetic scene generator; the rotation
matrix serves the trajectory metrics (:mod:`davo_tpu_torch.train.evaluation`);
the parameter Jacobian serves the Schur bundle adjustment and PnP
(:mod:`davo_tpu_torch.parallel.schur`, :mod:`davo_tpu_torch.train.vo_eval`)
and the gen-1 bundle adjustment's analytic gradient
(:mod:`davo_tpu_torch.camera.pinhole_ba`), whose constrained step wraps
the angle with :func:`wrap_axis_angle`.
"""

from __future__ import annotations

import math

import torch

from davo_tpu_torch.utils.stable_trig import cos_from_sq, cos_sin_sq, one_minus_cos_sq, sin_cubed_sq, sinc_sq

__all__ = [
    "skew_matrix",
    "so3_rotation_matrix",
    "rotate_vector_axis_angle",
    "so3_parameter_jacobian",
    "so3_vector_jacobian",
    "axis_angle_from_quaternion",
    "quaternion_from_matrix",
    "axis_angle_from_matrix",
    "wrap_axis_angle",
]


def skew_matrix(w: torch.Tensor) -> torch.Tensor:
    """``[w]_x`` such that ``[w]_x v = w x v``; shape ``(..., 3, 3)``."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_rotation_matrix(axis_angle: torch.Tensor) -> torch.Tensor:
    """The rotation matrix ``R(w) = cos(x) I + f4 w w^T + f1 [w]_x``,
    shape ``(..., 3, 3)``."""
    s = torch.sum(torch.square(axis_angle), dim=-1, keepdim=True)[..., None]
    eye = torch.eye(3, dtype=axis_angle.dtype, device=axis_angle.device)
    outer = axis_angle[..., :, None] * axis_angle[..., None, :]
    return cos_from_sq(s) * eye + one_minus_cos_sq(s) * outer + sinc_sq(s) * skew_matrix(axis_angle)


# d(R(w) v)/dv is R(w) itself
so3_vector_jacobian = so3_rotation_matrix


def rotate_vector_axis_angle(vector: torch.Tensor, axis_angle: torch.Tensor) -> torch.Tensor:
    """Rotate ``(..., 3)`` vectors by ``(..., 3)`` axis-angle rotations,
    broadcasting over leading dimensions."""
    s = torch.sum(torch.square(axis_angle), dim=-1, keepdim=True)
    cos_theta = cos_from_sq(s)
    f1 = sinc_sq(s)
    f4 = one_minus_cos_sq(s)
    dot = torch.sum(vector * axis_angle, dim=-1, keepdim=True)
    vector, axis_angle = torch.broadcast_tensors(vector, axis_angle)
    cross = torch.linalg.cross(axis_angle, vector, dim=-1)
    return vector * cos_theta + f4 * dot * axis_angle + f1 * cross


def so3_parameter_jacobian(vector: torch.Tensor, axis_angle: torch.Tensor) -> torch.Tensor:
    """Analytic Jacobian ``d(R(w) v)/dw``, shape ``(..., 3, 3)``:
    ``J[..., i, j] = d (R v)_i / d w_j``.  With ``f2 = cos_sin_sq`` and
    ``f3 = sin_cubed_sq`` (``dx/dw_j = w_j / x``)

        J_ij = -v_i w_j f1 + (w.v) f3 w_i w_j + f4 (w_i v_j + (w.v) delta_ij)
             + f2 w_j (w x v)_i + f1 eps_ijk v_k

    Every ratio switches to its Taylor series at small angles with the
    double ``where`` of :mod:`davo_tpu_torch.utils.stable_trig`, so the
    Jacobian is finite at ``w = 0`` (where it is ``-[v]_x``)."""
    s = torch.sum(torch.square(axis_angle), dim=-1, keepdim=True)
    f1 = sinc_sq(s)[..., None]
    f4 = one_minus_cos_sq(s)[..., None]
    f2 = cos_sin_sq(s)[..., None]
    f3 = sin_cubed_sq(s)[..., None]
    vector, axis_angle = torch.broadcast_tensors(vector, axis_angle)
    dot = torch.sum(vector * axis_angle, dim=-1, keepdim=True)[..., None]
    cross = torch.linalg.cross(axis_angle, vector, dim=-1)
    w_i, w_j = axis_angle[..., :, None], axis_angle[..., None, :]
    v_i, v_j = vector[..., :, None], vector[..., None, :]
    eye = torch.eye(3, dtype=vector.dtype, device=vector.device)
    term_cos = -v_i * w_j * f1
    term_dot = dot * f3 * w_i * w_j + f4 * (w_i * v_j + dot * eye)
    # eps_ijk v_k is the negated skew of v
    term_cross = f2 * w_j * cross[..., :, None] - f1 * skew_matrix(vector)
    return term_cos + term_dot + term_cross


def axis_angle_from_quaternion(quaternion: torch.Tensor) -> torch.Tensor:
    """WXYZ quaternions (not assumed normalised) to axis-angle vectors."""
    scalar = quaternion[..., 0:1]
    vector = quaternion[..., 1:4]
    vector_norm = torch.linalg.vector_norm(vector, dim=-1, keepdim=True)
    half_angle = torch.atan2(vector_norm, scalar)
    sin_half = torch.sin(half_angle)
    nonzero = sin_half != 0.0
    scale = torch.where(
        nonzero,
        2.0 * half_angle / torch.where(nonzero, sin_half, torch.ones_like(sin_half)),
        torch.zeros_like(sin_half),
    )
    return scale * vector


def quaternion_from_matrix(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrices to WXYZ quaternions with ``w >= 0``: the
    branch-free Shepperd method (all four pivots, selected by ``where``)."""
    m = matrix
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def pivot(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    sw = pivot(1.0 + tr)
    qw = torch.stack(
        [0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw, (m10 - m01) / sw], dim=-1
    )
    sx = pivot(1.0 + m00 - m11 - m22)
    qx = torch.stack(
        [(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx, (m02 + m20) / sx], dim=-1
    )
    sy = pivot(1.0 - m00 + m11 - m22)
    qy = torch.stack(
        [(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy, (m12 + m21) / sy], dim=-1
    )
    sz = pivot(1.0 - m00 - m11 + m22)
    qz = torch.stack(
        [(m10 - m01) / sz, (m02 + m20) / sz, (m12 + m21) / sz, 0.25 * sz], dim=-1
    )

    cond_w = (tr > m00) & (tr > m11) & (tr > m22)
    cond_x = (m00 >= m11) & (m00 >= m22)
    cond_y = m11 >= m22
    q = torch.where(
        cond_w[..., None],
        qw,
        torch.where(cond_x[..., None], qx, torch.where(cond_y[..., None], qy, qz)),
    )
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., 0:1] < 0.0, -q, q)


def axis_angle_from_matrix(matrix: torch.Tensor) -> torch.Tensor:
    """Rotation matrix to so(3) vector (via quaternions, branch-free)."""
    return axis_angle_from_quaternion(quaternion_from_matrix(matrix))


def wrap_axis_angle(axis_angle: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """The axis-angle vector with its angle wrapped into ``[-pi, pi)``
    (floored modulo, as ``jnp.mod``: ``torch.remainder``, not ``fmod``)."""
    angle = torch.linalg.vector_norm(axis_angle, dim=-1, keepdim=True)
    axis = axis_angle / torch.clamp(angle, min=eps)
    wrapped = torch.remainder(angle + math.pi, 2.0 * math.pi) - math.pi
    return wrapped * axis
