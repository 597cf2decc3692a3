"""Trajectory and scene accuracy metrics (the port of
``davo_tpu/train/evaluation.py``).

Estimated scenes are determined only up to a similarity transform, so the
absolute trajectory error (ATE) first aligns the estimate to the truth by
Umeyama's least-squares similarity.  The JAX package maps its per-scene
functions over a batch with ``vmap``; here every function takes any
leading batch dimensions.  On the card the products run in full float32
(the port's networks turn TF32 off), the counterpart of the JAX package's
``full_f32_matmuls``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from davo_tpu_torch.geometry import so3_rotation_matrix

__all__ = [
    "camera_centers_from_poses",
    "umeyama_alignment",
    "absolute_trajectory_error",
    "relative_pose_error",
    "intrinsics_error",
]


def camera_centers_from_poses(orientations: torch.Tensor, translations: torch.Tensor) -> torch.Tensor:
    """Camera centres in world coordinates from world->camera poses
    (``p_cam = R p + t`` => centre ``= -R^T t``).

    :param orientations: ``(..., M, 3)`` axis-angle.
    :param translations: ``(..., M, 3)``.
    """
    rot = so3_rotation_matrix(orientations)
    return -torch.einsum("...ji,...j->...i", rot, translations)


def umeyama_alignment(
    source: torch.Tensor, target: torch.Tensor, with_scale: bool = True
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Least-squares similarity transform aligning ``source`` to ``target``
    (Umeyama 1991): ``(R, t, s)`` minimising
    ``sum_i | s R source_i + t - target_i |^2``.

    :param source, target: ``(..., K, 3)`` points.
    :return: ``R (..., 3, 3)``, ``t (..., 3)``, ``s (...)``.
    """
    mu_s = torch.mean(source, dim=-2)
    mu_t = torch.mean(target, dim=-2)
    xs = source - mu_s[..., None, :]
    xt = target - mu_t[..., None, :]
    cov = torch.einsum("...ki,...kj->...ij", xt, xs) / source.shape[-2]
    u, d, vt = torch.linalg.svd(cov)
    sign = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    s_diag = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign], dim=-1)
    rot = (u * s_diag[..., None, :]) @ vt
    if with_scale:
        var_s = torch.mean(torch.sum(torch.square(xs), dim=-1), dim=-1)
        scale = torch.sum(d * s_diag, dim=-1) / torch.clamp(var_s, min=1e-12)
    else:
        scale = torch.ones_like(sign)
    t = mu_t - scale[..., None] * torch.einsum("...ij,...j->...i", rot, mu_s)
    return rot, t, scale


def absolute_trajectory_error(
    estimated_positions: torch.Tensor,
    true_positions: torch.Tensor,
    align: bool = True,
    with_scale: bool = True,
) -> Dict[str, torch.Tensor]:
    """ATE statistics between estimated and ground-truth positions.

    :param estimated_positions, true_positions: ``(..., K, 3)``.
    :param align: align with a similarity transform first (gauge removal).
    :return: ``rmse``, ``mean``, ``median`` (the mean of the two middle
        values for even K, as ``jnp.median``) and ``max``, each ``(...)``.
    """
    est = estimated_positions
    if align:
        rot, t, s = umeyama_alignment(est, true_positions, with_scale)
        est = s[..., None, None] * est @ rot.transpose(-1, -2) + t[..., None, :]
    err = torch.linalg.vector_norm(est - true_positions, dim=-1)
    return {
        "rmse": torch.sqrt(torch.mean(torch.square(err), dim=-1)),
        "mean": torch.mean(err, dim=-1),
        "median": torch.quantile(err, 0.5, dim=-1),
        "max": torch.amax(err, dim=-1),
    }


def relative_pose_error(
    estimated_poses: torch.Tensor, true_poses: torch.Tensor, delta: int = 1
) -> Dict[str, torch.Tensor]:
    """RPE over frame pairs ``(i, i + delta)`` (the TUM benchmark metric):
    the error motion ``E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d})`` of the
    ground-truth ``Q`` and estimated ``P`` camera-to-world transforms;
    translational and rotational (radians) RMSE and mean, with no global
    alignment.

    :param estimated_poses, true_poses: ``(..., K, 6)`` world->camera
        ``[axis-angle, t]``.
    """
    k = estimated_poses.shape[-2]
    if delta < 1 or delta >= k:
        raise ValueError(f"delta must be in [1, K-1] (got {delta}, K={k})")

    def rel_motion(poses):
        # camera-to-world: R_c2w = R^T, c = -R^T t
        rot = so3_rotation_matrix(poses[..., 0:3])
        c = -torch.einsum("...kji,...kj->...ki", rot, poses[..., 3:6])
        r_c2w = rot.transpose(-1, -2)
        r_rel = torch.einsum("...kji,...kjl->...kil", r_c2w[..., :-delta, :, :], r_c2w[..., delta:, :, :])
        t_rel = torch.einsum("...kji,...kj->...ki", r_c2w[..., :-delta, :, :], c[..., delta:, :] - c[..., :-delta, :])
        return r_rel, t_rel

    r_est, t_est = rel_motion(estimated_poses)
    r_true, t_true = rel_motion(true_poses)
    r_err = torch.einsum("...kji,...kjl->...kil", r_true, r_est)
    t_err = torch.linalg.vector_norm(t_est - t_true, dim=-1)
    trace = r_err[..., 0, 0] + r_err[..., 1, 1] + r_err[..., 2, 2]
    ang = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0))
    return {
        "trans_rmse": torch.sqrt(torch.mean(torch.square(t_err), dim=-1)),
        "trans_mean": torch.mean(t_err, dim=-1),
        "rot_rmse": torch.sqrt(torch.mean(torch.square(ang), dim=-1)),
        "rot_mean": torch.mean(ang, dim=-1),
    }


def intrinsics_error(estimated: torch.Tensor, true: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-component absolute intrinsics errors (``f``, ``cx``, ``cy``),
    averaged over every leading dimension."""
    diff = torch.abs(estimated - true)
    return {
        "f_error": torch.mean(diff[..., 0]),
        "cx_error": torch.mean(diff[..., 1]),
        "cy_error": torch.mean(diff[..., 2]),
    }
