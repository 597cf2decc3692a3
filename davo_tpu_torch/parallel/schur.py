"""Bundle adjustment by Schur-complement reduction, on one device (the port
of the single-device part of ``davo_tpu/parallel/schur.py``).

A damped Gauss-Newton / Levenberg-Marquardt step on the joint (intrinsics,
poses, points) problem:

* the point block ``C`` is block-diagonal (3 x 3 per point) and is
  eliminated point by point;
* the reduced camera system ``S = H_cc - H_cp C^-1 H_cp^T`` is small and
  dense ((3 + 6M)^2) and is solved with one step of iterative refinement;
* the point updates are ``dp = C^-1 (-g_p - H_cp^T dc)``.

Gauge freedom is handled with fixed shapes: boolean free-masks over the
intrinsics, pose and point coordinates zero the pinned Jacobian columns
and give their rows a diagonal at the block's own scale.  The L1 flavour
of the objective is IRLS weighting (``loss="l1"``).

The small inverses and solves are ``inv_ex``/``solve_ex`` without their
error checks: a singular block gives inf or NaN as in the JAX package,
and the card's stream never waits on the host.  The LM loop runs a fixed
number of iterations with ``where`` acceptance, so it does not sync the
host either.  On the card the products run with TF32 off
(:func:`davo_tpu_torch.utils.precision.full_f32_matmuls`): the normal
equations square the condition number.  The distributed solvers of the
JAX module are not ported yet (``ROADMAP.md`` Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from davo_tpu_torch.geometry import rotate_vector_axis_angle, so3_parameter_jacobian, so3_rotation_matrix
from davo_tpu_torch.utils.precision import full_f32_matmuls

__all__ = [
    "BAProblem",
    "BAObservations",
    "SchurConfig",
    "ba_residuals",
    "ba_cost",
    "schur_normal_step",
    "schur_ba_solve",
    "default_gauge_masks",
]


class BAProblem(NamedTuple):
    """One bundle-adjustment problem (no batch dimension).

    * ``intrinsics``: ``(3,)`` — ``(f, cx, cy)`` shared by all views.
    * ``poses``: ``(M, 6)`` — per view ``[axis-angle(3), translation(3)]``;
      camera-relative point = ``R(w) p + t``.
    * ``points``: ``(N, 3)`` world points.
    """

    intrinsics: torch.Tensor
    poses: torch.Tensor
    points: torch.Tensor


class BAObservations(NamedTuple):
    pixels: torch.Tensor  # (M, N, 2)
    visibility: torch.Tensor  # (M, N) bool/float


@dataclasses.dataclass(frozen=True)
class SchurConfig:
    iterations: int = 10
    damping: float = 1e-4
    loss: str = "l2"  # "l2" | "l1" (IRLS)
    irls_epsilon: float = 1e-6
    min_z: float = 1e-3


def default_gauge_masks(num_views: int, num_points: int, device=None):
    """Free-masks fixing exactly the 7-dimensional similarity gauge: view
    0's pose (6 DOF) and point 0's depth (scale).

    :return: ``(intr_free (3,), pose_free (M, 6), point_free (N, 3))``.
    """
    intr_free = torch.ones(3, dtype=torch.bool, device=device)
    pose_free = torch.ones(num_views, 6, dtype=torch.bool, device=device)
    pose_free[0] = False
    point_free = torch.ones(num_points, 3, dtype=torch.bool, device=device)
    point_free[0, 2] = False
    return intr_free, pose_free, point_free


def _project_terms(problem: BAProblem, config: SchurConfig):
    """Camera-relative points and projection intermediates, ``(M, N, ...)``."""
    rel = rotate_vector_axis_angle(problem.points[None, :, :], problem.poses[:, None, 0:3]) + problem.poses[:, None, 3:6]
    x, y = rel[..., 0], rel[..., 1]
    z = torch.clamp(rel[..., 2], min=config.min_z)
    return rel, x, y, z


def ba_residuals(problem: BAProblem, obs: BAObservations, config: SchurConfig = SchurConfig()) -> torch.Tensor:
    """Visibility-masked reprojection residuals, shape ``(M, N, 2)``."""
    _, x, y, z = _project_terms(problem, config)
    f, cx, cy = problem.intrinsics[0], problem.intrinsics[1], problem.intrinsics[2]
    uv = torch.stack([f * x / z + cx, f * y / z + cy], dim=-1)
    vis = obs.visibility.to(uv.dtype)[..., None]
    return (uv - obs.pixels) * vis


def _irls_weights(r: torch.Tensor, config: SchurConfig) -> torch.Tensor:
    if config.loss == "l2":
        return torch.ones_like(r)
    # minimise sum |r| by reweighted least squares
    return 1.0 / torch.sqrt(torch.abs(r) + config.irls_epsilon)


def ba_cost(problem: BAProblem, obs: BAObservations, config: SchurConfig = SchurConfig()) -> torch.Tensor:
    """The scalar objective :func:`schur_ba_solve` minimises (IRLS-weighted
    half squared residual norm)."""
    r = ba_residuals(problem, obs, config)
    return 0.5 * torch.sum(torch.square(r * _irls_weights(r, config)))


_weighted_cost = ba_cost


def _jacobian_blocks(problem: BAProblem, obs: BAObservations, config: SchurConfig):
    """Residuals and analytic Jacobian blocks, all visibility-masked.

    :return: ``(r (M,N,2), J_intr (M,N,2,3), J_pose (M,N,2,6),
        J_point (M,N,2,3))``.
    """
    _, x, y, z = _project_terms(problem, config)
    f = problem.intrinsics[0]
    inv_z = 1.0 / z
    f_on_z = f * inv_z
    x_on_z = x * inv_z
    y_on_z = y * inv_z
    vis = obs.visibility.to(x.dtype)
    u = f * x_on_z + problem.intrinsics[1]
    v = f * y_on_z + problem.intrinsics[2]
    r = (torch.stack([u, v], -1) - obs.pixels) * vis[..., None]

    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    # d(u,v)/d(f, cx, cy)
    j_intr = torch.stack([torch.stack([x_on_z, one, zero], -1), torch.stack([y_on_z, zero, one], -1)], dim=-2)
    # d(u,v)/d(x', y', z'), (M, N, 2, 3)
    du_dp = torch.stack([f_on_z, zero, -f_on_z * x_on_z], -1)
    dv_dp = torch.stack([zero, f_on_z, -f_on_z * y_on_z], -1)
    j_prime = torch.stack([du_dp, dv_dp], dim=-2)

    # chain: rotation parameters (M, N, 3, 3), translation = I, point = R
    j_rot = so3_parameter_jacobian(problem.points[None, :, :], problem.poses[:, None, 0:3])
    rmat = so3_rotation_matrix(problem.poses[:, 0:3])[:, None]  # (M, 1, 3, 3)
    j_pose_rot = torch.einsum("mnri,mnij->mnrj", j_prime, j_rot)
    j_pose = torch.cat([j_pose_rot, j_prime], dim=-1)  # (M, N, 2, 6)
    j_point = torch.einsum("mnri,mnij->mnrj", j_prime, rmat.expand(-1, j_prime.shape[1], -1, -1))

    vis_e = vis[..., None, None]
    return r, j_intr * vis_e, j_pose * vis_e, j_point * vis_e


def _camera_dim(num_views: int) -> int:
    return 3 + 6 * num_views


def _normal_parts(problem, obs, config, gauge_masks):
    """Raw normal-equation parts of the whole problem.

    :return: ``(h_cc (C,C), g_c (C,), h_cp (N,C,3), c_blk (N,3,3),
        g_p (N,3))`` with ``C = 3 + 6M``, before pinning and inversion.
    """
    intr_free, pose_free, point_free = gauge_masks
    m = problem.poses.shape[0]
    r, j_intr, j_pose, j_point = _jacobian_blocks(problem, obs, config)
    w_irls = _irls_weights(r, config)
    r = r * w_irls
    j_intr = j_intr * w_irls[..., None] * intr_free.to(r.dtype)
    j_pose = j_pose * w_irls[..., None] * pose_free.to(r.dtype)[:, None, None, :]
    j_point = j_point * w_irls[..., None] * point_free.to(r.dtype)[None, :, None, :]
    # dense camera Jacobian (M, N, 2, 3 + 6M): pose blocks one-hot at their views
    eye_m = torch.eye(m, dtype=j_pose.dtype, device=j_pose.device)
    j_pose_dense = torch.einsum("mnrp,mv->mnrvp", j_pose, eye_m).reshape(j_pose.shape[:3] + (6 * m,))
    j_cam = torch.cat([j_intr, j_pose_dense], dim=-1)

    h_cc = torch.einsum("mnrc,mnrd->cd", j_cam, j_cam)
    g_c = torch.einsum("mnrc,mnr->c", j_cam, r)
    h_cp = torch.einsum("mnrc,mnrp->ncp", j_cam, j_point)
    c_blk = torch.einsum("mnrp,mnrq->npq", j_point, j_point)
    g_p = torch.einsum("mnrp,mnr->np", j_point, r)
    return h_cc, g_c, h_cp, c_blk, g_p


def _eliminate_points(h_cc, g_c, h_cp, c_blk, g_p, point_free, damping):
    """The Schur elimination of the point blocks.

    :return: ``(s, rhs, c_inv)``.
    """
    # damping and gauge pinning of the point blocks: pinned dims have zero
    # rows, so any positive pin gives a zero delta; pin at the block's own
    # diagonal scale to keep the block well conditioned
    diag_scale = torch.clamp(torch.einsum("npp->n", c_blk)[:, None] / 3.0, min=1.0)
    pin = torch.where(point_free, damping, diag_scale).to(c_blk.dtype)
    c_blk = c_blk + torch.diag_embed(pin)
    c_inv = torch.linalg.inv_ex(c_blk, check_errors=False).inverse
    s = h_cc - torch.einsum("ncp,npq,ndq->cd", h_cp, c_inv, h_cp)
    rhs = -g_c + torch.einsum("ncp,npq,nq->c", h_cp, c_inv, g_p)
    return s, rhs, c_inv


def _solve_camera_and_points(s, rhs, h_cp, c_inv, g_p, gauge_masks, damping, m):
    """Solve the damped reduced camera system and back-substitute the
    point deltas."""
    intr_free, pose_free, point_free = gauge_masks
    cam_free = torch.cat([intr_free, pose_free.reshape(-1)])
    # pinned camera dims have zero rows and columns: a diagonal at the
    # system's own scale keeps them out of the condition number
    diag_scale = torch.clamp(torch.trace(s) / _camera_dim(m), min=1.0)
    s = s + torch.diag(torch.where(cam_free, damping, diag_scale).to(s.dtype))

    def solve(b):
        return torch.linalg.solve_ex(s, b[:, None], check_errors=False).result[:, 0]

    dc = solve(rhs)
    # one step of iterative refinement (float32 LU on ill-conditioned systems)
    dc = dc + solve(rhs - s @ dc)
    dc = dc * cam_free.to(dc.dtype)
    dp = torch.einsum("npq,nq->np", c_inv, -g_p - torch.einsum("ncp,c->np", h_cp, dc))
    dp = dp * point_free.to(dp.dtype)
    return dc, dp


def _damped_step(problem: BAProblem, obs, config, damping, gauge_masks) -> BAProblem:
    """One Schur Gauss-Newton step at a tensor damping value."""
    m = problem.poses.shape[0]
    h_cc, g_c, h_cp, c_blk, g_p = _normal_parts(problem, obs, config, gauge_masks)
    s, rhs, c_inv = _eliminate_points(h_cc, g_c, h_cp, c_blk, g_p, gauge_masks[2], damping)
    dc, dp = _solve_camera_and_points(s, rhs, h_cp, c_inv, g_p, gauge_masks, damping, m)
    return BAProblem(
        intrinsics=problem.intrinsics + dc[0:3],
        poses=problem.poses + dc[3:].reshape(m, 6),
        points=problem.points + dp,
    )


def _masks(gauge_masks, m, n, device):
    if gauge_masks is None:
        return default_gauge_masks(m, n, device)
    return tuple(torch.as_tensor(x, dtype=torch.bool, device=device) for x in gauge_masks)


def schur_normal_step(
    problem: BAProblem,
    obs: BAObservations,
    config: SchurConfig = SchurConfig(),
    gauge_masks=None,
) -> Tuple[BAProblem, torch.Tensor]:
    """One damped Gauss-Newton step by Schur complement.

    :return: ``(updated_problem, cost_before_step)``.
    """
    full_f32_matmuls()
    m, n = obs.pixels.shape[0], obs.pixels.shape[1]
    gauge_masks = _masks(gauge_masks, m, n, obs.pixels.device)
    cost = _weighted_cost(problem, obs, config)
    damping = torch.tensor(config.damping, dtype=problem.points.dtype, device=problem.points.device)
    return _damped_step(problem, obs, config, damping, gauge_masks), cost


def _lm_loop(problem: BAProblem, config: SchurConfig, step_fn, cost_fn) -> BAProblem:
    """LM acceptance: take a candidate step, keep it only where the cost
    improves, adapt the damping.  Fixed iterations, tensor ``where``s."""
    prob = problem
    cost = cost_fn(problem)
    damping = torch.tensor(config.damping, dtype=problem.points.dtype, device=problem.points.device)
    for _ in range(config.iterations):
        candidate = step_fn(prob, damping)
        cand_cost = cost_fn(candidate)
        improved = cand_cost < cost
        prob = BAProblem(*(torch.where(improved, a, b) for a, b in zip(candidate, prob)))
        cost = torch.where(improved, cand_cost, cost)
        damping = torch.clamp(torch.where(improved, damping * 0.3, damping * 5.0), 1e-10, 1e8)
    return prob


def schur_ba_solve(
    problem: BAProblem,
    obs: BAObservations,
    config: SchurConfig = SchurConfig(),
    gauge_masks=None,
) -> BAProblem:
    """Fixed-iteration damped Schur Gauss-Newton with step acceptance (LM
    flavour): a step that raises the cost is rejected and the damping
    raised instead."""
    full_f32_matmuls()
    m, n = obs.pixels.shape[0], obs.pixels.shape[1]
    gauge_masks = _masks(gauge_masks, m, n, obs.pixels.device)
    return _lm_loop(
        problem,
        config,
        lambda prob, damping: _damped_step(prob, obs, config, damping, gauge_masks),
        lambda prob: _weighted_cost(prob, obs, config),
    )
