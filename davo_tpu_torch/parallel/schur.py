"""Bundle adjustment by Schur-complement reduction (the port of
``davo_tpu/parallel/schur.py``), on one device or sharded over a mesh.

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
equations square the condition number.

The distributed solvers run SPMD over a ``DeviceMesh``
(:mod:`davo_tpu_torch.parallel.mesh`): every rank is called with the whole
problem, eliminates its shard of points, and issues the JAX program's
collectives itself (:func:`distributed_schur_ba`: the reduced camera
system and its rhs in one all-reduce, then the candidate's cost;
:func:`distributed_schur_ba_2d`: the separator factors over ``"kf"``, the
reduced system over the whole mesh, the point deltas' regather over
``"kf"``, the cost).  The LM loop decides on the all-reduced cost, which
holds the same bits on every rank, so every rank accepts the same steps.
Each rank returns the whole solved problem (its points' shards gathered
once, at the end).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from davo_tpu_torch.geometry import rotate_vector_axis_angle, so3_parameter_jacobian, so3_rotation_matrix
from davo_tpu_torch.utils.precision import full_f32_matmuls

from .mesh import DATA_AXIS, axis, whole_group

__all__ = [
    "BAProblem",
    "BAObservations",
    "SchurConfig",
    "ba_residuals",
    "ba_cost",
    "schur_normal_step",
    "schur_ba_solve",
    "distributed_schur_ba",
    "distributed_schur_ba_2d",
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


def _normal_parts(problem, obs, config, gauge_masks, *, num_total_views=None, view_offset=0):
    """Raw normal-equation parts of whatever observation block
    ``problem``/``obs`` hold: the whole problem on one device, or a rank's
    ``(M_local x N_local)`` block.

    The dense camera axis spans ``num_total_views`` views (by default the
    local count); the local views' pose columns land at ``view_offset``, so
    keyframe shards assemble disjoint column ranges of one global system.

    :return: ``(h_cc (C,C), g_c (C,), h_cp (N,C,3), c_blk (N,3,3),
        g_p (N,3))`` with ``C = 3 + 6 num_total_views``, before pinning and
        inversion (2-D shards sum ``c_blk`` over the keyframe axis first).
    """
    intr_free, pose_free, point_free = gauge_masks
    m = problem.poses.shape[0]
    if num_total_views is None:
        num_total_views = m
    r, j_intr, j_pose, j_point = _jacobian_blocks(problem, obs, config)
    w_irls = _irls_weights(r, config)
    r = r * w_irls
    j_intr = j_intr * w_irls[..., None] * intr_free.to(r.dtype)
    j_pose = j_pose * w_irls[..., None] * pose_free.to(r.dtype)[:, None, None, :]
    j_point = j_point * w_irls[..., None] * point_free.to(r.dtype)[None, :, None, :]
    # dense camera Jacobian (M, N, 2, 3 + 6M): pose blocks one-hot at their views
    eye_m = torch.eye(m, dtype=j_pose.dtype, device=j_pose.device)
    j_pose_dense = torch.einsum("mnrp,mv->mnrvp", j_pose, eye_m).reshape(j_pose.shape[:3] + (6 * m,))
    j_pose_dense = F.pad(j_pose_dense, (6 * view_offset, 6 * (num_total_views - m - view_offset)))
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


def _local_reduction(problem, obs, config, gauge_masks, damping):
    """A shard's half of a Schur step: its contribution to the reduced
    camera system and its points' elimination factors (the whole problem
    on one device, or a rank's shard of points).

    :return: ``(s_part, rhs_part, h_cp, c_inv, g_p)``.
    """
    h_cc, g_c, h_cp, c_blk, g_p = _normal_parts(problem, obs, config, gauge_masks)
    s_part, rhs_part, c_inv = _eliminate_points(h_cc, g_c, h_cp, c_blk, g_p, gauge_masks[2], damping)
    return s_part, rhs_part, h_cp, c_inv, g_p


def _solve_camera(s, rhs, cam_free, damping, m):
    """Solve the damped reduced camera system."""
    # pinned camera dims have zero rows and columns: a diagonal at the
    # system's own scale keeps them out of the condition number
    diag_scale = torch.clamp(torch.trace(s) / _camera_dim(m), min=1.0)
    s = s + torch.diag(torch.where(cam_free, damping, diag_scale).to(s.dtype))

    def solve(b):
        return torch.linalg.solve_ex(s, b[:, None], check_errors=False).result[:, 0]

    dc = solve(rhs)
    # one step of iterative refinement (float32 LU on ill-conditioned systems)
    dc = dc + solve(rhs - s @ dc)
    return dc * cam_free.to(dc.dtype)


def _point_deltas(dc, h_cp, c_inv, g_p, point_free):
    """Back-substitute the point deltas ``C^-1 (-g_p - H_cp^T dc)``."""
    dp = torch.einsum("npq,nq->np", c_inv, -g_p - torch.einsum("ncp,c->np", h_cp, dc))
    return dp * point_free.to(dp.dtype)


def _solve_camera_and_points(s, rhs, h_cp, c_inv, g_p, gauge_masks, damping, m):
    """Solve the damped reduced camera system and back-substitute the
    point deltas."""
    intr_free, pose_free, point_free = gauge_masks
    dc = _solve_camera(s, rhs, torch.cat([intr_free, pose_free.reshape(-1)]), damping, m)
    return dc, _point_deltas(dc, h_cp, c_inv, g_p, point_free)


def _apply_camera_delta(problem: BAProblem, dc: torch.Tensor) -> BAProblem:
    m = problem.poses.shape[0]
    return problem._replace(intrinsics=problem.intrinsics + dc[0:3], poses=problem.poses + dc[3:].reshape(m, 6))


def _damped_step(problem: BAProblem, obs, config, damping, gauge_masks) -> BAProblem:
    """One Schur Gauss-Newton step at a tensor damping value."""
    m = problem.poses.shape[0]
    s, rhs, h_cp, c_inv, g_p = _local_reduction(problem, obs, config, gauge_masks, damping)
    dc, dp = _solve_camera_and_points(s, rhs, h_cp, c_inv, g_p, gauge_masks, damping, m)
    return _apply_camera_delta(problem, dc)._replace(points=problem.points + dp)


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


def _all_reduce_parts(parts, group):
    """Sum each tensor of ``parts`` over ``group`` in one all-reduce of
    their concatenation (the fusion XLA makes of the JAX program's
    ``psum``s); every rank gets the same bits."""
    flat = torch.cat([x.reshape(-1) for x in parts])
    dist.all_reduce(flat, group=group)
    return [chunk.reshape(x.shape) for chunk, x in zip(flat.split([x.numel() for x in parts]), parts)]


def _all_gather_rows(x, group, size):
    """The ranks' row blocks of ``group``, in their order along the axis."""
    blocks = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(blocks, x.contiguous(), group=group)
    return torch.cat(blocks)


def distributed_schur_ba(
    problem: BAProblem,
    obs: BAObservations,
    mesh,
    config: SchurConfig = SchurConfig(),
    axis_name: str = DATA_AXIS,
    gauge_masks=None,
) -> BAProblem:
    """Schur BA with the point block sharded over ``mesh``'s ``axis_name``.

    Every rank is called with the whole problem and returns the whole
    solution.  The camera parameters are replicated; each rank eliminates
    its ``N / size`` points, and per LM iteration only the reduced camera
    system ``(3 + 6M)^2`` with its rhs (one all-reduce) and the candidate's
    cost cross the interconnect
    (:func:`davo_tpu_torch.parallel.comm_model.schur_1d_traffic`); the
    point shards are gathered once, at the end.

    ``N`` must divide evenly over the axis.
    """
    full_f32_matmuls()
    m, n = obs.pixels.shape[0], obs.pixels.shape[1]
    intr_free, pose_free, point_free = _masks(gauge_masks, m, n, obs.pixels.device)
    group, size, coordinate = axis(mesh, axis_name)
    if n % size != 0:
        raise ValueError(f"num_points={n} must divide evenly over mesh axis {axis_name!r} (size {size})")
    rows = slice(coordinate * (n // size), (coordinate + 1) * (n // size))
    local_obs = BAObservations(obs.pixels[:, rows], obs.visibility[:, rows])
    local_masks = (intr_free, pose_free, point_free[rows])

    def step_fn(prob, damping):
        s_part, rhs_part, h_cp, c_inv, g_p = _local_reduction(prob, local_obs, config, local_masks, damping)
        # the step's only traffic: the reduced camera system and its rhs
        s, rhs = _all_reduce_parts([s_part, rhs_part], group)
        dc, dp = _solve_camera_and_points(s, rhs, h_cp, c_inv, g_p, local_masks, damping, m)
        return _apply_camera_delta(prob, dc)._replace(points=prob.points + dp)

    def cost_fn(prob):
        return _all_reduce_parts([_weighted_cost(prob, local_obs, config)], group)[0]

    solved = _lm_loop(problem._replace(points=problem.points[rows]), config, step_fn, cost_fn)
    return solved._replace(points=_all_gather_rows(solved.points, group, size))


def distributed_schur_ba_2d(
    problem: BAProblem,
    obs: BAObservations,
    mesh,
    config: SchurConfig = SchurConfig(),
    kf_axis: str = "kf",
    pt_axis: str = "pt",
    gauge_masks=None,
) -> BAProblem:
    """Schur BA over a 2-D (keyframe x point) mesh of shape ``(a, b)``.

    Each rank owns an ``(M/a x N/b)`` observation block, its ``M/a`` views'
    pose columns and ``N/b`` points; per LM iteration:

    1. it builds its block's raw normal-equation parts, its pose columns at
       their global offsets (:func:`_normal_parts`);
    2. the point factors ``(H_cp, C, g_p)`` are summed over the keyframe
       axis in one all-reduce: a point seen from several keyframe shards
       couples them (the separator traffic);
    3. each keyframe row eliminates a disjoint ``N/(ab)`` sub-slice of its
       point shard, and the eliminated contributions are summed over the
       whole mesh into the reduced camera system, which every rank solves;
    4. the sub-slices' point deltas are regathered along the keyframe axis
       (scattered into zeros and all-reduced: the JAX program's
       replication-restoring gather, with its data volume);
    5. the candidate's cost is one all-reduce over the whole mesh (XLA
       stages it as one per axis).

    Every rank holds the whole pose mask, so the JAX program's pose-mask
    regather has no counterpart.  Requires ``M % a == 0``, ``N % b == 0``
    and ``(N // b) % a == 0``.  Every rank returns the whole solution.
    """
    full_f32_matmuls()
    m, n = obs.pixels.shape[0], obs.pixels.shape[1]
    intr_free, pose_free, point_free = _masks(gauge_masks, m, n, obs.pixels.device)
    kf_group, a, kf_idx = axis(mesh, kf_axis)
    pt_group, b, pt_idx = axis(mesh, pt_axis)
    if m % a != 0:
        raise ValueError(f"num_views={m} must divide evenly over mesh axis {kf_axis!r} (size {a})")
    if n % b != 0 or (n // b) % a != 0:
        raise ValueError(
            f"num_points={n} must divide evenly over both mesh axes ({pt_axis!r} size {b}, then {kf_axis!r} size {a})"
        )
    everyone = whole_group(mesh)
    m_loc, n_loc = m // a, n // b
    n_sub = n_loc // a
    views = slice(kf_idx * m_loc, (kf_idx + 1) * m_loc)
    points = slice(pt_idx * n_loc, (pt_idx + 1) * n_loc)
    sub = slice(kf_idx * n_sub, (kf_idx + 1) * n_sub)
    block_obs = BAObservations(obs.pixels[views, points], obs.visibility[views, points])
    block_masks = (intr_free, pose_free[views], point_free[points])
    cam_free = torch.cat([intr_free, pose_free.reshape(-1)])

    def block(prob):
        return BAProblem(prob.intrinsics, prob.poses[views], prob.points)

    def step_fn(prob, damping):
        h_cc, g_c, h_cp, c_blk, g_p = _normal_parts(
            block(prob), block_obs, config, block_masks, num_total_views=m, view_offset=kf_idx * m_loc
        )
        # separator: each point's factors over the keyframe shards that see it
        h_cp, c_blk, g_p = _all_reduce_parts([h_cp, c_blk, g_p], kf_group)
        s_part, rhs_part, c_inv = _eliminate_points(
            h_cc, g_c, h_cp[sub], c_blk[sub], g_p[sub], block_masks[2][sub], damping
        )
        s, rhs = _all_reduce_parts([s_part, rhs_part], everyone)
        dc = _solve_camera(s, rhs, cam_free, damping, m)
        dp = torch.zeros_like(prob.points)
        dp[sub] = _point_deltas(dc, h_cp[sub], c_inv, g_p[sub], block_masks[2][sub])
        (dp,) = _all_reduce_parts([dp], kf_group)
        return _apply_camera_delta(prob, dc)._replace(points=prob.points + dp)

    def cost_fn(prob):
        return _all_reduce_parts([_weighted_cost(block(prob), block_obs, config)], everyone)[0]

    solved = _lm_loop(problem._replace(points=problem.points[points]), config, step_fn, cost_fn)
    return solved._replace(points=_all_gather_rows(solved.points, pt_group, b))
