"""Visual odometry on synthetic sequences and along trajectory files (the
port of ``davo_tpu/train/vo_eval.py``).

1. A smooth synthetic camera orbit observes a point cloud
   (:func:`generate_trajectory`), or landmarks are synthesised along a
   TUM/KITTI trajectory file (:func:`observations_for_poses`); with a
   front end the frames are rendered (:func:`render_trajectory_images`)
   and the observations come from the learned detector and matcher.
2. Windows pipeline (the default): every overlapping window is solved by
   the learned guess head and its in-forward BFGS (kernels K1 and K2),
   all windows stacked in one call (:func:`solve_learned_windows`), and
   the window-relative poses are stitched greedily or by the
   overlap-consistent rotation-graph and centre/scale least squares
   (:func:`stitch_windows_global`, optionally robust).  The oracle-prior
   variant chains Schur-BA windows (:func:`solve_windowed_vo`).
3. Incremental pipeline: a learned bootstrap window (with IRLS
   re-solves), then incremental SfM: per frame a constant-velocity
   prediction, geometric data association to the raw detections (host
   numpy, as in the JAX package), PnP (Levenberg-Marquardt, optionally
   RANSAC), re-triangulation, and a periodic Schur BA with in-call Huber
   IRLS (:func:`solve_incremental_vo_detections`); with descriptor
   association the matcher's tracks go straight to the accumulator
   (:func:`solve_incremental_vo`).  The lowest-cost bootstrap wins
   (:func:`solve_learned_vo_incremental`).
4. Refinement: global triangulation + Schur BA
   (:func:`refine_trajectory_global`), multi-start over scale modes
   (:func:`refine_trajectory_multistart`), a float64 polish
   (:func:`refine_trajectory_host_f64`), or a BFGS over per-segment scales
   (:func:`correct_scale_drift`, kernel K1 at P = K - 1).
5. The estimate is similarity-aligned to the truth for the ATE (and the
   RPE along a file).

Random numbers come from explicit ``torch.Generator``s; each draw is
split from the deterministic function that consumes it (the ``draw_*``
functions, the ``noise`` arguments), so a test can inject the JAX
package's own draws.  The PnP Jacobian is analytic
(:func:`davo_tpu_torch.geometry.so3_parameter_jacobian`) where the JAX
package takes ``jax.jacfwd``.  The per-frame loop syncs the host where
the JAX package converts to numpy; the LM and Schur loops run a fixed
number of iterations and never sync.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from davo_tpu_torch.camera import calibration_residuals, unpack_calibration_parameters
from davo_tpu_torch.data.rendering import (
    RenderConfig,
    appearance_from_noise,
    draw_appearance_noise,
    draw_frame_noise,
    render_views,
)
from davo_tpu_torch.data.synthetic import _look_at_rotation
from davo_tpu_torch.geometry import (
    axis_angle_from_matrix,
    rotate_vector_axis_angle,
    so3_parameter_jacobian,
    so3_rotation_matrix,
)
from davo_tpu_torch.parallel import BAObservations, BAProblem, SchurConfig, ba_cost, distributed_schur_ba, schur_ba_solve
from davo_tpu_torch.parallel.mesh import require_mesh
from davo_tpu_torch.solve.least_squares import LMConfig, levenberg_marquardt
from davo_tpu_torch.utils.device import resolve_device
from davo_tpu_torch.utils.precision import full_f32_matmuls

from .evaluation import absolute_trajectory_error, camera_centers_from_poses

__all__ = [
    "TrajectoryConfig",
    "draw_trajectory_noise",
    "trajectory_from_noise",
    "generate_trajectory",
    "draw_trajectory_render_noise",
    "render_trajectory_images",
    "draw_window_prior_noise",
    "solve_windowed_vo",
    "stitch_windows_global",
    "stitch_windows",
    "solve_learned_windows",
    "solve_windowed_vo_learned",
    "triangulate_points",
    "pnp_pose",
    "solve_incremental_vo",
    "solve_incremental_vo_detections",
    "solve_learned_vo_incremental",
    "refine_trajectory_global",
    "refine_trajectory_multistart",
    "correct_scale_drift",
    "refine_trajectory_host_f64",
    "evaluate_learned_vo",
    "draw_observation_noise",
    "observations_for_poses",
    "evaluate_vo_sequence_file",
    "evaluate_vo",
]

@dataclasses.dataclass(frozen=True)
class TrajectoryConfig:
    num_frames: int = 16
    num_points: int = 32
    window: int = 4  # frames per window (the bootstrap window)
    radius: float = 12.0  # orbit radius of the camera path
    focal_length: float = 1.4
    pixel_noise: float = 0.0
    init_noise: float = 0.02
    solver: SchurConfig = SchurConfig(iterations=10, damping=1e-4)
    stride: int = 0
    dtype: torch.dtype = torch.float32


def _pose_from_matrix(rot: torch.Tensor, centre: torch.Tensor) -> torch.Tensor:
    """``(..., 6)`` pose ``[axis-angle, t]`` with ``t = -R c``."""
    t = -torch.einsum("...ij,...j->...i", rot, centre)
    return torch.cat([axis_angle_from_matrix(rot), t], dim=-1)


def draw_trajectory_noise(
    generator: torch.Generator, config: TrajectoryConfig, device: Optional[torch.device] = None
) -> Dict[str, torch.Tensor]:
    """The standard-normal draws of one sequence: the cloud's ``xy`` and
    ``z`` and, with ``pixel_noise > 0``, the pixels' jitter."""
    n, kf = config.num_points, config.num_frames

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device, dtype=config.dtype)

    noise = dict(xy=normal(n, 2), z=normal(n, 1))
    if config.pixel_noise > 0.0:
        noise["pixels"] = normal(kf, n, 2)
    return noise


def trajectory_from_noise(noise: Dict[str, torch.Tensor], config: TrajectoryConfig):
    """The sequence of :func:`draw_trajectory_noise`'s draws: cameras orbit
    the cloud in the xz plane with a gentle vertical bob, looking at its
    centre.

    :return: ``(poses (K, 6), points (N, 3), pixels (K, N, 2),
        visibility (K, N))``, poses world->camera.
    """
    dtype, device = noise["xy"].dtype, noise["xy"].device
    points = torch.cat([3.0 * noise["xy"], 3.0 * noise["z"]], dim=-1)
    angles = torch.linspace(0.0, 1.5 * np.pi, config.num_frames, dtype=dtype, device=device)
    centres = torch.stack(
        [config.radius * torch.sin(angles), 1.5 * torch.sin(2.0 * angles), -config.radius * torch.cos(angles)], dim=-1
    )
    rot = _look_at_rotation(-centres, torch.tensor([0.0, -1.0, 0.0], dtype=dtype, device=device))
    poses = _pose_from_matrix(rot, centres)
    rel = torch.einsum("kij,nj->kni", rot, points) + poses[:, None, 3:6]
    f = config.focal_length
    u = f * rel[..., 0] / rel[..., 2]
    v = f * rel[..., 1] / rel[..., 2]
    pixels = torch.stack([u, v], dim=-1)
    if config.pixel_noise > 0.0:
        pixels = pixels + config.pixel_noise * noise["pixels"]
    visibility = (torch.abs(u) < 1.0) & (torch.abs(v) < 1.0) & (rel[..., 2] > 0.1)
    return poses, points, pixels, visibility


def generate_trajectory(generator: torch.Generator, config: TrajectoryConfig, device=None):
    """A synthetic sequence drawn from ``generator`` (on the card unless
    ``device`` says otherwise); see :func:`trajectory_from_noise`."""
    device = resolve_device(device)
    return trajectory_from_noise(draw_trajectory_noise(generator, config, device), config)


def draw_trajectory_render_noise(
    generator: torch.Generator, num_frames: int, num_points: int, config: RenderConfig, device=None
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The unit draws of a sequence's render: the shared appearance of its
    points and each frame's background and pixel noise."""
    return dict(
        appearance=draw_appearance_noise(generator, (), num_points, config, device),
        frame=draw_frame_noise(generator, (num_frames,), config, device),
    )


def render_trajectory_images(
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    render_config: Optional[RenderConfig] = None,
    noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
) -> torch.Tensor:
    """Render the sequence's frames (one appearance per point, shared by
    every frame), from ``noise`` or draws of ``generator``.

    :param pixels: ``(K, N, 2)`` oracle projections.
    :param visibility: ``(K, N)``.
    :return: ``(K, H, W, C)`` images.
    """
    if render_config is None:
        render_config = RenderConfig()
    if noise is None:
        noise = draw_trajectory_render_noise(
            generator, pixels.shape[0], pixels.shape[1], render_config, pixels.device
        )
    appearance = appearance_from_noise(noise["appearance"], render_config)
    return render_views(pixels, visibility, appearance, render_config, noise["frame"])


def _compose(base_pose: torch.Tensor, rel_pose: torch.Tensor) -> torch.Tensor:
    """World->camera composition: ``rel`` is in the frame of ``base``'s
    camera; returns the absolute pose."""
    r_base = so3_rotation_matrix(base_pose[0:3])
    r_rel = so3_rotation_matrix(rel_pose[0:3])
    t_abs = r_rel @ base_pose[3:6] + rel_pose[3:6]
    return torch.cat([axis_angle_from_matrix(r_rel @ r_base), t_abs])


def _to_window_frame(poses: torch.Tensor, anchor: torch.Tensor) -> torch.Tensor:
    """``(K, 6)`` poses relative to the anchor camera's frame:
    ``rel = pose o anchor^-1``."""
    r_a = so3_rotation_matrix(anchor[0:3])
    r_rel = so3_rotation_matrix(poses[:, 0:3]) @ r_a.T
    t_rel = poses[:, 3:6] - torch.einsum("kij,j->ki", r_rel, anchor[3:6])
    return torch.cat([axis_angle_from_matrix(r_rel), t_rel], dim=-1)


def _vo_gauge_masks(num_frames: int, num_points: int):
    """The gauge of a VO bundle adjustment: intrinsics frozen, pose 0 and
    point 0's depth pinned."""
    pose_free = np.ones((num_frames, 6), bool)
    pose_free[0] = False
    point_free = np.ones((num_points, 3), bool)
    point_free[0, 2] = False
    return np.zeros(3, bool), pose_free, point_free


def draw_window_prior_noise(
    generator: torch.Generator, num_frames: int, num_points: int, dtype=torch.float32, device=None
) -> Dict[str, torch.Tensor]:
    """The standard-normal draws of :func:`solve_windowed_vo`'s odometry
    priors: ``poses`` ``(K - 1, 6)`` and ``points`` ``(N, 3)``."""
    return dict(
        poses=torch.randn((num_frames - 1, 6), generator=generator, dtype=dtype, device=device),
        points=torch.randn((num_points, 3), generator=generator, dtype=dtype, device=device),
    )


def solve_windowed_vo(
    true_poses: torch.Tensor,
    points: torch.Tensor,
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    config: TrajectoryConfig,
    generator: Optional[torch.Generator] = None,
    intrinsics: Optional[torch.Tensor] = None,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Estimate the trajectory by chaining per-window bundle adjustments.

    Windows of ``config.window`` consecutive frames overlap by one frame.
    Each is solved by the Schur BA in its first camera's frame (intrinsics
    frozen, the anchor pose and one point depth pinned), started from
    noise-perturbed odometry priors (the poses but frame 0's, and the
    points, ``config.init_noise`` times :func:`draw_window_prior_noise`'s
    draws of ``generator``, or ``noise``), and chained onto the running
    estimate; the refined points carry over to the next window.

    :return: ``(K, 6)`` estimated absolute poses (gauge: frame 0).
    """
    full_f32_matmuls()
    kf, w = true_poses.shape[0], config.window
    stride = w - 1
    num_windows = (kf - 1 + stride - 1) // stride
    dtype, device = true_poses.dtype, true_poses.device
    if intrinsics is None:
        intrinsics = torch.tensor([config.focal_length, 0.0, 0.0], dtype=dtype, device=device)
    if noise is None:
        noise = draw_window_prior_noise(generator, kf, points.shape[0], dtype, device)
    prior_poses = torch.cat([true_poses[:1], true_poses[1:] + config.init_noise * noise["poses"]])
    est_points = points + config.init_noise * noise["points"]
    vis = visibility.to(dtype)
    # intrinsics known (the VO setting); the anchor pose and one point
    # depth fix each window's gauge
    masks = _vo_gauge_masks(w, points.shape[0])
    estimates = torch.zeros(kf, 6, dtype=dtype, device=device)
    estimates[0] = true_poses[0]
    for wi in range(num_windows):
        start = min(wi * stride, kf - w)
        anchor = estimates[start].clone()
        r_anchor = so3_rotation_matrix(anchor[0:3])
        # window-frame world: the points in the anchor camera's frame
        window_points = torch.einsum("ij,nj->ni", r_anchor, est_points) + anchor[3:6]
        solved = schur_ba_solve(
            BAProblem(
                intrinsics=intrinsics,
                poses=_to_window_frame(prior_poses[start : start + w], prior_poses[start]),
                points=window_points,
            ),
            BAObservations(pixels=pixels[start : start + w], visibility=vis[start : start + w]),
            config.solver,
            gauge_masks=masks,
        )
        for j in range(1, w):
            estimates[start + j] = _compose(anchor, solved.poses[j])
        # the refined points back in world coordinates for the next window
        est_points = torch.einsum("ji,nj->ni", r_anchor, solved.points - anchor[3:6])
    return estimates


def _window_starts(num_frames: int, window: int, stride: int) -> list:
    """Anchor frames of the overlapping windows covering the sequence."""
    starts = []
    start = 0
    while True:
        start = min(start, num_frames - window)
        starts.append(start)
        if start + window >= num_frames:
            return starts
        start += stride


def _stitch_chain(starts, window_poses, num_frames: int) -> torch.Tensor:
    """Greedy stitching: rotations chain through each window's anchor;
    each window's gauge scale is fixed from the previously estimated
    relative translation of the shared pair ``(start, start + 1)``, so
    scale errors compound along the chain (see
    :func:`stitch_windows_global`).

    :param window_poses: ``(W, w, 6)`` (or a list of ``(w, 6)``)
        window-relative poses.
    """
    dtype, device = window_poses[0].dtype, window_poses[0].device
    estimates = torch.zeros(num_frames, 6, dtype=dtype, device=device)
    for wi, start in enumerate(starts):
        poses_w = window_poses[wi]
        w = poses_w.shape[0]
        if wi == 0:
            scale = 1.0
            first_new = 1
        else:
            chained_rel = _to_window_frame(estimates[start : start + 2], estimates[start])[1]
            num = torch.linalg.vector_norm(chained_rel[3:6])
            den = torch.clamp(torch.linalg.vector_norm(poses_w[1, 3:6]), min=1e-9)
            scale = num / den
            # frames up to the previous window's end are already estimated
            first_new = starts[wi - 1] + w - start
        anchor = estimates[start].clone()
        for j in range(first_new, w):
            scaled = torch.cat([poses_w[j, 0:3], poses_w[j, 3:6] * scale])
            estimates[start + j] = _compose(anchor, scaled)
    return estimates


def _huber_row_scale(norms: torch.Tensor, floor: float) -> torch.Tensor:
    """Huber IRLS sqrt-weights: unit inside the scale, ``sqrt(scale/|r|)``
    beyond it.  The scale is the 70th percentile of the residual norms
    (linear interpolation, as ``jnp.percentile``; not the MAD: after
    consensus chaining most residuals are exactly zero, which collapses a
    median-based scale) with an absolute floor."""
    scale = torch.clamp(torch.quantile(norms, 0.7), min=floor)
    return torch.sqrt(torch.clamp(scale / torch.clamp(norms, min=1e-12), max=1.0))


def _lstsq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The least-squares solution of a tall, full-column-rank system (the
    ``gels`` driver, QR: the only one on the card)."""
    return torch.linalg.lstsq(a, b[:, None], driver="gels").solution[:, 0]


def stitch_windows_global(
    starts,
    window_poses,
    num_frames: int,
    rotation_iterations: int = 2,
    robust: bool = False,
) -> torch.Tensor:
    """Overlap-consistent global stitching of window-relative solves.

    Greedy chaining (:func:`_stitch_chain`) fixes each window's gauge
    scale from a single shared frame pair; this solver uses every overlap
    constraint jointly:

    1. **Rotation-graph Gauss-Newton.**  Every window edge
       ``(start, start + j)`` constrains ``R[start+j] = R_rel[w, j]
       R[start]``; from greedy chaining, the linearised residuals
       ``r_e = log(R_f (R_rel R_s)^T)`` give ``delta_f - delta_s = -r_e``
       over per-frame tangent perturbations, solved by least squares and
       applied ``R_f <- exp(delta_f) R_f`` (``rotation_iterations``
       rounds, two more when robust).
    2. **Joint centre/scale least squares.**  Camera centres obey
       ``c[start+j] = c[start] + s_w R_anchor[w]^T cw[w, j]``, linear in
       all centres and window scales; ``c[0] = 0`` and ``s_0 = 1`` fix
       the gauge.

    Both systems are tall and of full column rank (every frame is reached
    from frame 0 through the window edges), so ``torch.linalg.lstsq``'s
    ``gels`` driver (QR, the only one on the card) gives their solution;
    the JAX package's ``jnp.linalg.lstsq`` is SVD-based and agrees to
    rounding.  Percentiles are ``torch.quantile`` with linear
    interpolation, as ``jnp.percentile``.

    :param starts: ``W`` window anchor frames.
    :param window_poses: ``(W, w, 6)`` (or a list of ``(w, 6)``)
        window-relative poses, frame ``starts[i]`` the identity in each
        window's own gauge.
    :param robust: Huber-IRLS down-weighting of outlier edges in both
        solves (scale: the 70th percentile of the residual norms, floors
        0.02 rad and 1 % of the longest window displacement).  The
        rotations are seeded by each frame's consensus candidate over its
        covering windows (the first of equal costs: with two candidates
        the costs tie and the greedy one wins); windows whose rotation
        edges stay outliers after the robust rotation pass (above
        ``max(3 x`` the 70th percentile, 0.1)) are gated to weight 1e-3
        in the centre solve before its four IRLS rounds, so one
        catastrophic window solve stays local.
    :return: ``(K, 6)`` absolute world->camera poses (frame 0 the
        identity, the first window's scale).
    """
    kf, n_win = num_frames, len(starts)
    w = window_poses[0].shape[0]
    dtype, device = window_poses[0].dtype, window_poses[0].device
    rel_rots = torch.stack([so3_rotation_matrix(wp[:, 0:3]) for wp in window_poses])  # (W, w, 3, 3)
    eye3 = torch.eye(3, dtype=dtype, device=device)

    # pass 1: rotation chaining seeds the graph optimisation; the robust
    # path takes each frame's consensus candidate over its covering windows
    rot = [None] * kf
    rot[0] = eye3
    if robust:
        cover = {}
        for wi, s in enumerate(starts):
            for j in range(1, w):
                cover.setdefault(s + j, []).append((wi, s, j))
        for f in range(1, kf):
            cands = [rel_rots[wi, j] @ rot[s] for wi, s, j in cover.get(f, []) if rot[s] is not None]
            if len(cands) == 1:
                rot[f] = cands[0]
                continue
            cand = torch.stack(cands)
            pair = torch.einsum("aij,bkj->abik", cand, cand)  # c_a c_b^T
            ang = torch.linalg.vector_norm(axis_angle_from_matrix(pair), dim=-1)
            rot[f] = cand[torch.argmin(ang.sum(dim=1))]
    else:
        for wi, s in enumerate(starts):
            for j in range(1, w):
                if rot[s + j] is None:
                    rot[s + j] = rel_rots[wi, j] @ rot[s]
    rot = torch.stack(rot)

    # pass 2: rotation-graph Gauss-Newton over the tangent perturbations of
    # frames 1..K-1 (frame 0 fixes the gauge); 3 equations an edge, in
    # window-major order
    edge_s = np.asarray([s for s in starts for _ in range(1, w)])
    edge_f = np.asarray([s + j for s in starts for j in range(1, w)])
    num_edges = len(edge_f)
    a_rot = np.zeros((3 * num_edges, 3 * (kf - 1)))
    for e, (s, f) in enumerate(zip(edge_s, edge_f)):
        a_rot[3 * e : 3 * e + 3, 3 * (f - 1) : 3 * f] = np.eye(3)
        if s > 0:
            a_rot[3 * e : 3 * e + 3, 3 * (s - 1) : 3 * s] -= np.eye(3)
    a_rot = torch.as_tensor(a_rot, dtype=dtype, device=device)
    r_edge = rel_rots[:, 1:].reshape(num_edges, 3, 3)
    s_idx = torch.as_tensor(edge_s, device=device)
    f_idx = torch.as_tensor(edge_f, device=device)

    def edge_residuals(rot):
        return axis_angle_from_matrix(rot[f_idx] @ (r_edge @ rot[s_idx]).transpose(-1, -2))  # (E, 3)

    for _ in range(max(0, rotation_iterations + (2 if robust else 0))):
        residuals = edge_residuals(rot)
        b_rot = -residuals.reshape(-1)
        a_eff = a_rot
        if robust:
            # rotation edges inside ~1 degree are inliers
            sw3 = torch.repeat_interleave(_huber_row_scale(torch.linalg.vector_norm(residuals, dim=-1), 0.02), 3)
            a_eff = a_rot * sw3[:, None]
            b_rot = b_rot * sw3
        delta = _lstsq(a_eff, b_rot).reshape(kf - 1, 3)
        rot = torch.cat([rot[:1], so3_rotation_matrix(delta) @ rot[1:]])

    # the per-window gate of the centre solve: windows whose rotation edges
    # stay outliers are known-bad; a small nonzero weight keeps frames that
    # only a bad window covers determined (badly, but locally)
    win_gate = None
    if robust:
        win_res = torch.linalg.vector_norm(edge_residuals(rot), dim=-1).reshape(n_win, w - 1).amax(dim=-1)
        bad_thresh = torch.clamp(3.0 * torch.quantile(win_res, 0.7), min=0.1)
        win_gate = torch.where(win_res > bad_thresh, 1e-3, 1.0).to(dtype)

    # joint linear least squares for the centres c_1..c_{K-1} and the window
    # scales s_1..s_{W-1}: edge e of window wi reads c_f - c_s = d_e for the
    # first window and c_f - c_s - s_wi d_e = 0 for the others
    nc = 3 * (kf - 1)
    window_of = np.repeat(np.arange(n_win), w - 1)
    cw = -torch.einsum("eji,ej->ei", r_edge, torch.stack([wp[1:, 3:6] for wp in window_poses]).reshape(-1, 3))
    d = torch.einsum("eji,ej->ei", rot[s_idx], cw)  # R_anchor^T cw
    scale_onehot = np.zeros((num_edges, n_win - 1))
    later = window_of > 0
    scale_onehot[np.flatnonzero(later), window_of[later] - 1] = 1.0
    scale_onehot = torch.as_tensor(scale_onehot, dtype=dtype, device=device)
    a_mat = torch.cat(
        [a_rot, (-d[:, :, None] * scale_onehot[:, None, :]).reshape(3 * num_edges, n_win - 1)], dim=1
    )
    first = torch.as_tensor(~later, dtype=dtype, device=device)
    b_vec = (d * first[:, None]).reshape(-1)
    if robust:
        # gate known-bad windows' edges before the first solve, then
        # IRLS-refine from that clean solution
        gate = torch.repeat_interleave(win_gate, w - 1)  # rows follow edge order
        gate3 = torch.repeat_interleave(gate, 3)
        solution = _lstsq(a_mat * gate3[:, None], b_vec * gate3)
        # the centre-residual floor, relative to the window displacements
        edge_len = torch.linalg.vector_norm(b_vec.reshape(-1, 3), dim=-1)
        c_floor = 0.01 * torch.clamp(torch.amax(edge_len), min=1e-6)
        for _ in range(4):
            res = (a_mat @ solution - b_vec).reshape(-1, 3)
            sw3 = torch.repeat_interleave(gate * _huber_row_scale(torch.linalg.vector_norm(res, dim=-1), c_floor), 3)
            solution = _lstsq(a_mat * sw3[:, None], b_vec * sw3)
    else:
        solution = _lstsq(a_mat, b_vec)
    centres = torch.cat([torch.zeros(1, 3, dtype=dtype, device=device), solution[:nc].reshape(kf - 1, 3)])
    t_all = -torch.einsum("kij,kj->ki", rot, centres)
    return torch.cat([axis_angle_from_matrix(rot), t_all], dim=-1)


def _window_layout(num_frames: int, config: TrajectoryConfig):
    """Check the windows pipeline's shape rules; ``(window, stride)``."""
    w = config.window
    if w < 3:
        raise ValueError(
            "learned VO needs window >= 3: consecutive windows overlap by two frames and the shared pair's "
            f"relative translation anchors each window's gauge scale (got window={w})"
        )
    if num_frames < w:
        raise ValueError(f"sequence of {num_frames} frames is shorter than the window ({w})")
    stride = config.stride if config.stride else w - 2
    if not 1 <= stride <= w - 2:
        raise ValueError(
            f"stride must be in [1, window - 2] = [1, {w - 2}] so that consecutive windows overlap by >= 2 "
            f"frames (got {stride})"
        )
    return w, stride


def solve_learned_windows(
    guess_fn: Callable,
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    config: TrajectoryConfig,
    images: Optional[torch.Tensor] = None,
    frontend_fn: Optional[Callable] = None,
    irls_rounds: int = 0,
):
    """Every window's learned solve, all windows in one call: the window
    half of :func:`solve_windowed_vo_learned`.

    The JAX package calls ``guess_fn`` once a window; here the windows are
    stacked on the batch axis and ``guess_fn`` (and ``frontend_fn``) is
    called once for all of them, and once more for each IRLS round.  Each
    row must get what a call of its own would get (the CLI's guess
    function gives every row the restart draw of a one-row call), so the
    result equals the per-window loop's.

    :param guess_fn: rows in, rows out: ``(pixels (W, M, N, 2),
        visibility (W, M, N))`` to flat calibration vectors ``(W, P)``.
    :param frontend_fn: ``images (W, M, H, W_img, C)`` to
        ``(matches (W, M, N, 2), visibility (W, M, N))``.
    :param irls_rounds: geometry-informed re-solves: after each solve a
        window's observations are Huber-weighted against its own solution
        (scale: the 70th percentile of its visible reprojection angles,
        ``torch.nanquantile``, floor 5e-3; no visible observation gives
        the floor) and the windows are solved again.
    :return: ``(starts, window_poses (W, w, 6))``, frame ``starts[i]`` the
        identity of window ``i``.
    """
    kf = pixels.shape[0]
    w, stride = _window_layout(kf, config)
    if (frontend_fn is None) != (images is None):
        raise ValueError("images and frontend_fn must be given together")
    starts = _window_starts(kf, w, stride)
    idx = torch.as_tensor([list(range(s, s + w)) for s in starts], device=pixels.device)
    if frontend_fn is not None:
        w_pix, w_vis = frontend_fn(images[idx.to(images.device)])
    else:
        w_pix, w_vis = pixels[idx], visibility[idx]
    vecs = guess_fn(w_pix, w_vis)
    for _ in range(max(0, irls_rounds)):
        res = calibration_residuals(vecs, w_pix)  # (W, M, N)
        masked = torch.where(w_vis > 0, res, torch.full_like(res, float("nan")))
        scale = torch.clamp(
            torch.nan_to_num(torch.nanquantile(masked.reshape(res.shape[0], -1), 0.7, dim=-1), nan=5e-3), min=5e-3
        )
        w_vis = w_vis * torch.clamp(scale[:, None, None] / torch.clamp(res, min=1e-9), max=1.0)
        vecs = guess_fn(w_pix, w_vis)
    # N from the window observations: a front end's global tracks may be
    # wider than the per-window match count the guess network takes
    params = unpack_calibration_parameters(vecs, w, w_pix.shape[2])
    rel = torch.cat([params.camera_rotations[:, :, 0, :], params.camera_translations[:, :, 0, :]], dim=-1)
    return starts, torch.cat([torch.zeros_like(rel[:, :1]), rel], dim=1)


def stitch_windows(starts, window_poses, num_frames: int, stitch: str = "global") -> torch.Tensor:
    """Window-relative poses to a trajectory: ``chain``
    (:func:`_stitch_chain`), ``global`` or ``robust``
    (:func:`stitch_windows_global`)."""
    if stitch in ("global", "robust"):
        return stitch_windows_global(starts, window_poses, num_frames, robust=stitch == "robust")
    if stitch == "chain":
        return _stitch_chain(starts, window_poses, num_frames)
    raise ValueError(f"unknown stitch mode {stitch!r}")


def solve_windowed_vo_learned(
    guess_fn: Callable,
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    config: TrajectoryConfig,
    stitch: str = "global",
    images: Optional[torch.Tensor] = None,
    frontend_fn: Optional[Callable] = None,
    irls_rounds: int = 0,
) -> torch.Tensor:
    """Full learned VO from observations alone: every window of
    ``config.window`` frames (consecutive windows overlap by ``window -
    stride >= 2``) is solved by ``guess_fn`` (a trained calibration
    network: guess and in-forward BFGS), all windows in one call
    (:func:`solve_learned_windows`), and the window-relative poses are
    stitched (:func:`stitch_windows`: greedy ``chain``, or the
    overlap-consistent ``global`` or ``robust`` joint solve).

    :param guess_fn: rows in, rows out: ``(W, M, N, 2), (W, M, N) ->
        (W, P)``.
    :param pixels: ``(K, N, 2)`` sequence observations (with
        ``frontend_fn``, only their shape is used).
    :param visibility: ``(K, N)``.
    :param images: ``(K, H, W, C)`` rendered frames: with ``frontend_fn``
        each window's observations come from the front end on these.
    :return: ``(K, 6)`` estimated absolute poses (frame 0 the identity,
        the first window's scale).
    """
    full_f32_matmuls()
    _window_layout(pixels.shape[0], config)
    if stitch not in ("chain", "global", "robust"):
        raise ValueError(f"unknown stitch mode {stitch!r}")
    starts, window_poses = solve_learned_windows(
        guess_fn, pixels, visibility, config, images=images, frontend_fn=frontend_fn, irls_rounds=irls_rounds
    )
    return stitch_windows(starts, window_poses, pixels.shape[0], stitch)


def triangulate_points(
    poses: torch.Tensor, intrinsics: torch.Tensor, pixels: torch.Tensor, visibility: torch.Tensor
) -> torch.Tensor:
    """Linear (DLT) triangulation of N points from K posed views: each
    visible observation's normalised ray gives two rows
    ``(u' R3 - R1) P = t1 - u' t3`` (and likewise for v); the 3 x 3 normal
    equations of every point are solved batched (``solve_ex`` without its
    error check: a point no view sees gives what the LU gives, as in the
    JAX package).

    :param poses: ``(K, 6)`` world->camera.
    :param intrinsics: ``(3,)`` ``(f, cx, cy)``.
    :param pixels: ``(K, N, 2)``.
    :param visibility: ``(K, N)``.
    :return: ``(N, 3)`` world points.
    """
    f, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2]
    rot = so3_rotation_matrix(poses[:, 0:3])
    t = poses[:, 3:6]
    u_n = (pixels[..., 0] - cx) / f
    v_n = (pixels[..., 1] - cy) / f
    r1, r2, r3 = rot[:, 0], rot[:, 1], rot[:, 2]
    row_u = u_n[..., None] * r3[:, None, :] - r1[:, None, :]
    row_v = v_n[..., None] * r3[:, None, :] - r2[:, None, :]
    rhs_u = t[:, None, 0] - u_n * t[:, None, 2]
    rhs_v = t[:, None, 1] - v_n * t[:, None, 2]
    w = visibility.to(pixels.dtype)[..., None]
    rows = torch.cat([row_u * w, row_v * w], dim=0)  # (2K, N, 3)
    rhs = torch.cat([rhs_u * w[..., 0], rhs_v * w[..., 0]], dim=0)
    ata = torch.einsum("kni,knj->nij", rows, rows) + 1e-9 * torch.eye(3, dtype=pixels.dtype, device=pixels.device)
    atb = torch.einsum("kni,kn->ni", rows, rhs)
    return torch.linalg.solve_ex(ata, atb[..., None], check_errors=False).result[..., 0]


def _project(points: torch.Tensor, pose: torch.Tensor, intrinsics: torch.Tensor):
    """Pinhole projections ``(..., N, 2)`` of ``(N, 3)`` points under
    ``(..., 6)`` poses, and the in-front flags ``(..., N)``."""
    rel = rotate_vector_axis_angle(points, pose[..., None, 0:3]) + pose[..., None, 3:6]
    z = torch.clamp(rel[..., 2], min=1e-6)
    u = intrinsics[0] * rel[..., 0] / z + intrinsics[1]
    v = intrinsics[0] * rel[..., 1] / z + intrinsics[2]
    return torch.stack([u, v], dim=-1), rel[..., 2] > 0.0


def pnp_pose(
    points: torch.Tensor,
    pixels: torch.Tensor,
    weights: torch.Tensor,
    intrinsics: torch.Tensor,
    init_pose: torch.Tensor,
    iterations: int = 20,
    huber_rounds: int = 2,
) -> torch.Tensor:
    """Perspective-n-Point: LM-refine a camera pose against known 3-D
    points (fixed intrinsics), then ``huber_rounds`` re-solves with Huber
    weights at the 70th percentile of the weighted residual norms.

    Batched over ``weights``' leading dimensions (the RANSAC candidates
    of one frame: the same points, pixels and start, other weights).  The
    Jacobian is analytic: the projection's derivative chained with
    :func:`so3_parameter_jacobian` (the depth clamp at 1e-6 passes no
    derivative below it).

    :param points: ``(N, 3)`` world points.
    :param pixels: ``(N, 2)`` observations in this frame.
    :param weights: ``(..., N)`` observation weights (0 = unseen).
    :param init_pose: ``(6,)`` world->camera start.
    :return: ``(..., 6)`` refined poses.
    """
    f, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2]

    def residuals_of(pose, w):
        uv, _ = _project(points, pose, intrinsics)
        return (uv - pixels) * w[..., None]

    def residual_and_jacobian(pose, w):
        rel = rotate_vector_axis_angle(points, pose[..., None, 0:3]) + pose[..., None, 3:6]
        z = torch.clamp(rel[..., 2], min=1e-6)
        x_on_z, y_on_z, f_on_z = rel[..., 0] / z, rel[..., 1] / z, f / z
        res = (torch.stack([f * x_on_z + cx, f * y_on_z + cy], dim=-1) - pixels) * w[..., None]
        dz = (rel[..., 2] > 1e-6).to(rel.dtype)
        zero = torch.zeros_like(z)
        j_rel = torch.stack(
            [torch.stack([f_on_z, zero, -f_on_z * x_on_z * dz], -1),
             torch.stack([zero, f_on_z, -f_on_z * y_on_z * dz], -1)],
            dim=-2,
        )  # (..., N, 2, 3)
        j_rot = torch.einsum("...ri,...ij->...rj", j_rel, so3_parameter_jacobian(points, pose[..., None, 0:3]))
        jac = torch.cat([j_rot, j_rel], dim=-1) * w[..., None, None]
        return res.reshape(res.shape[:-2] + (-1,)), jac.reshape(jac.shape[:-3] + (-1, 6))

    pose = init_pose.expand(weights.shape[:-1] + (6,))
    w = weights
    for round_i in range(1 + max(0, huber_rounds)):
        pose = levenberg_marquardt(
            lambda p, w=w: residual_and_jacobian(p, w),
            pose,
            LMConfig(iterations=iterations),
            residual_fn=lambda p, w=w: residuals_of(p, w).reshape(p.shape[:-1] + (-1,)),
        )
        if round_i < huber_rounds:
            norms = torch.linalg.vector_norm(residuals_of(pose, weights), dim=-1)
            masked = torch.where(weights > 0, norms, torch.full_like(norms, float("nan")))
            # all-zero weights make the percentile NaN: fall back to the floor
            scale = torch.clamp(torch.nan_to_num(torch.nanquantile(masked, 0.7, dim=-1, keepdim=True), nan=1e-3), min=1e-3)
            w = weights * torch.clamp(scale / torch.clamp(norms, min=1e-9), max=1.0)
    return pose


def solve_incremental_vo(
    tracks: torch.Tensor,
    visibility: torch.Tensor,
    intrinsics: torch.Tensor,
    bootstrap_poses: torch.Tensor,
    solver: SchurConfig = SchurConfig(iterations=10, damping=1e-3),
    ba_every: int = 4,
    min_pnp_tracks: int = 4,
) -> torch.Tensor:
    """Incremental SfM over global tracks: after the bootstrap poses, each
    frame takes a constant-velocity prediction and PnP against the
    structure triangulated from every posed frame (PnP only where at
    least ``min_pnp_tracks`` tracks have triangulation support), with a
    Schur BA every ``ba_every`` frames and at the end.

    :param tracks: ``(K, N, 2)`` track observations (oracle, or the
        front end on the whole sequence, anchor frame 0).
    :param visibility: ``(K, N)`` weights.
    :param intrinsics: ``(3,)`` fixed ``(f, cx, cy)``.
    :param bootstrap_poses: ``(W0, 6)`` poses of the first frames.
    :return: ``(K, 6)`` world->camera poses.
    """
    full_f32_matmuls()
    kf = tracks.shape[0]
    w0 = bootstrap_poses.shape[0]
    vis = visibility.to(tracks.dtype)
    poses = [bootstrap_poses[i] for i in range(w0)]

    def run_ba(posed):
        k = posed.shape[0]
        seen = (vis[:k] > 0).sum(dim=0)
        vis_eff = vis[:k] * (seen >= 2)[None, :].to(vis.dtype)
        points = triangulate_points(posed, intrinsics, tracks[:k], vis_eff)
        gauge_pt = int(np.argmax(seen.cpu().numpy()))
        pose_free = np.ones((k, 6), bool)
        pose_free[0] = False
        point_free = np.ones((points.shape[0], 3), bool)
        point_free[gauge_pt, 2] = False
        solved = schur_ba_solve(
            BAProblem(intrinsics=intrinsics, poses=posed, points=points),
            BAObservations(pixels=tracks[:k], visibility=vis_eff),
            solver,
            gauge_masks=(np.zeros(3, bool), pose_free, point_free),
        )
        return solved.poses

    for k in range(w0, kf):
        posed = torch.stack(poses)
        points = triangulate_points(posed, intrinsics, tracks[:k], vis[:k])
        # constant-velocity prediction in the pose group
        prev, prev2 = poses[-1], poses[-2]
        pred = _compose(prev, _to_window_frame(prev[None], prev2)[0])
        # PnP weights gated on visibility and triangulation support; the
        # acceptance counts the effective weights
        support = torch.sum(vis[:k] > 0, dim=0) >= 2
        w = vis[k] * support.to(vis.dtype)
        n_eff = torch.sum(w > 0)
        solved_pose = pnp_pose(points, tracks[k], w, intrinsics, pred)
        poses.append(torch.where(n_eff >= min_pnp_tracks, solved_pose, pred))
        if (k - w0 + 1) % ba_every == 0:
            refined = run_ba(torch.stack(poses))
            poses = [refined[i] for i in range(refined.shape[0])]
    return run_ba(torch.stack(poses))


def _associate_detections(
    proj: np.ndarray,
    active: np.ndarray,
    dets: np.ndarray,
    det_ok: np.ndarray,
    radius: float,
    desc_cost: Optional[np.ndarray] = None,
):
    """Greedy 1-1 nearest association of predicted track projections to
    detections (host numpy; N and D are tiny).

    ``desc_cost`` (N_tracks, D_dets), when given, is added to the spatial
    distance before the greedy assignment; the spatial gate ``radius``
    applies to the spatial part alone."""
    n, d = proj.shape[0], dets.shape[0]
    spatial = np.linalg.norm(proj[:, None, :] - dets[None, :, :], axis=-1)
    cost = spatial if desc_cost is None else spatial + desc_cost
    cost[~active, :] = np.inf
    cost[:, ~det_ok] = np.inf
    cost[spatial > radius] = np.inf
    coords = np.zeros((n, 2), proj.dtype)
    vis = np.zeros((n,), bool)
    for _ in range(min(n, d)):
        i = int(np.argmin(cost))
        ti, di = divmod(i, cost.shape[1])
        if not np.isfinite(cost[ti, di]):
            break
        coords[ti] = dets[di]
        vis[ti] = True
        cost[ti, :] = np.inf
        cost[:, di] = np.inf
    return coords, vis


def solve_incremental_vo_detections(
    detections: torch.Tensor,
    det_scores: torch.Tensor,
    intrinsics: torch.Tensor,
    bootstrap_poses: torch.Tensor,
    bootstrap_tracks: torch.Tensor,
    bootstrap_vis: torch.Tensor,
    solver: SchurConfig = SchurConfig(iterations=10, damping=1e-3),
    ba_every: int = 4,
    min_pnp_tracks: int = 3,
    assoc_radius: float = 0.12,
    score_threshold: float = 0.2,
    refine_intrinsics: bool = False,
    bootstrap_start: int = 0,
    return_cost: bool = False,
    pnp_ransac: int = 0,
    ransac_inlier_radius: float = 0.03,
    chain_passes: int = 1,
    reject_outliers: bool = False,
    reject_radius: float = 0.025,
    ba_irls: int = 0,
    det_descriptors: Optional[torch.Tensor] = None,
    desc_weight: float = 0.0,
    debug_out: Optional[dict] = None,
):
    """Incremental SfM with geometric data association.

    Each new frame: predict the current structure's projections under a
    constant-velocity pose (or the previous pass's refined pose), greedily
    associate them 1-1 to the frame's raw detections, PnP on the
    associations (RANSAC over random minimal subsets with
    ``pnp_ransac > 0``; ``np.random.default_rng(20240 + bootstrap_start)``
    picks them, as in the JAX package), re-associate under the refined
    pose (three rounds), and cut associations far above the median
    residual with ``reject_outliers``.  The Schur BA runs every
    ``ba_every`` frames with ``ba_irls`` in-call Huber rounds; after the
    chain (``chain_passes`` passes, each later one rebuilding the track
    table under the previous pass's poses in the other direction), a
    trajectory-wide re-association, and with ``refine_intrinsics`` a BA
    with the focal free.  ``det_descriptors`` with ``desc_weight > 0``
    adds a descriptor identity cost to the association.

    :param detections: ``(K, D, 2)`` per-frame detected coordinates.
    :param det_scores: ``(K, D)`` detection probabilities.
    :param bootstrap_tracks: ``(W0, N, 2)`` matcher observations of the
        bootstrap window.
    :param debug_out: optional dict filled with the final ``tracks``,
        ``vis``, ``intrinsics``, ``poses`` and ``bootstrap_start``.
    :return: ``(K, 6)`` world->camera poses (and the coverage-penalised
        self-consistency cost with ``return_cost``).
    """
    full_f32_matmuls()
    device = detections.device
    kf = detections.shape[0]
    w0, n = bootstrap_tracks.shape[0], bootstrap_tracks.shape[1]
    s0 = int(bootstrap_start)
    if not 0 <= s0 <= kf - w0:
        raise ValueError(f"bootstrap_start {s0} out of range for K={kf}")
    dets_np = detections.cpu().numpy()
    boot_tracks_np = bootstrap_tracks.cpu().numpy()
    boot_vis_np = bootstrap_vis.cpu().numpy()
    tracks = np.zeros((kf, n, 2), dets_np.dtype)
    vis = np.zeros((kf, n), np.float64 if detections.dtype == torch.float64 else np.float32)
    tracks[s0 : s0 + w0] = boot_tracks_np
    vis[s0 : s0 + w0] = boot_vis_np.astype(vis.dtype)
    pose_of = {s0 + i: bootstrap_poses[i] for i in range(w0)}
    solved_frames = list(range(s0, s0 + w0))

    def dev(x):
        return torch.as_tensor(x, device=device)

    det_ok_np = (det_scores.cpu().numpy() > score_threshold) & np.all(np.abs(dets_np) < 1.0, axis=-1)

    # --- descriptor identity state (optional) ---------------------------
    use_desc = det_descriptors is not None and desc_weight > 0.0
    if use_desc:
        desc_np = det_descriptors.cpu().numpy()
        desc_np = desc_np / np.maximum(np.linalg.norm(desc_np, axis=-1, keepdims=True), 1e-9)
        track_desc = np.zeros((n, desc_np.shape[-1]), desc_np.dtype)

        def _desc_update(track_ids, frame, coords):
            """Fold the descriptors of accepted detections into the
            per-track reference (EMA, then re-normalise)."""
            d = np.linalg.norm(coords[:, None, :] - dets_np[frame][None, :, :], axis=-1)
            j = d.argmin(axis=1)
            near = d[np.arange(len(j)), j] < 0.02
            for t, det_j, is_near in zip(track_ids, j, near):
                if not is_near:
                    continue
                blend = 0.7 * track_desc[t] + 0.3 * desc_np[frame, det_j]
                track_desc[t] = blend / max(np.linalg.norm(blend), 1e-9)

        def _desc_cost(frame):
            """Scaled cosine distance of each track reference to each
            detection; tracks with no reference yet cost nothing."""
            cost = desc_weight * (1.0 - track_desc @ desc_np[frame].T)
            cost[np.linalg.norm(track_desc, axis=-1) <= 0.5] = 0.0
            return cost

        def _desc_reset():
            track_desc[:] = 0.0
            for f in range(s0, s0 + w0):
                seen = np.flatnonzero(vis[f] > 0)
                _desc_update(seen, f, tracks[f][seen])

        _desc_reset()
    else:

        def _desc_cost(frame):
            return None

        def _desc_update(track_ids, frame, coords):
            return None

        def _desc_reset():
            return None

    def subset():
        idx = sorted(solved_frames)
        return idx, torch.stack([pose_of[i] for i in idx]), dev(tracks[idx]), vis[idx]

    intrinsics_box = [intrinsics]

    def project(points, pose):
        return _project(points, pose, intrinsics_box[0])

    def run_ba(free_focal=False, reject=False):
        # rounds: [IRLS rounds...] -> solve -> [reject + re-solve]
        irls_w = None  # soft weights of this call only, not kept in the table
        last_round = max(0, ba_irls) + (1 if reject else 0)
        for ba_round in range(last_round + 1):
            intr = intrinsics_box[0]
            idx, posed, t_sub, v_sub = subset()
            if irls_w is not None:
                v_sub = v_sub * irls_w
            # points seen from < 2 frames have junk triangulations: keep
            # their observations out of the BA
            support = (v_sub > 0).sum(axis=0) >= 2
            vis_eff = dev(v_sub * support[None, :].astype(vis.dtype))
            points = triangulate_points(posed, intr, t_sub, vis_eff)
            # scale gauge: the z of the best-supported point; pose gauge:
            # the bootstrap anchor
            gauge_pt = int(np.argmax((v_sub > 0).sum(axis=0)))
            pose_free = np.ones((len(idx), 6), bool)
            pose_free[idx.index(s0)] = False
            point_free = np.ones((n, 3), bool)
            point_free[gauge_pt, 2] = False
            ba = schur_ba_solve(
                BAProblem(intrinsics=intr, poses=posed, points=points),
                BAObservations(pixels=t_sub, visibility=vis_eff),
                solver if not free_focal else SchurConfig(iterations=15, damping=1e-3),
                gauge_masks=(np.array([free_focal, False, False]), pose_free, point_free),
            )
            for row, i in enumerate(idx):
                pose_of[i] = ba.poses[row]
            if free_focal:
                intrinsics_box[0] = ba.intrinsics
            if ba_round == last_round:
                break
            # residuals under the freshly solved geometry
            idx2, posed2, t_sub2, v_sub2 = subset()
            support2 = (v_sub2 > 0).sum(axis=0) >= 2
            vis_eff2 = v_sub2 * support2[None, :].astype(vis.dtype)
            points2 = triangulate_points(posed2, intrinsics_box[0], t_sub2, dev(vis_eff2))
            res = np.linalg.norm(project(points2, posed2)[0].cpu().numpy() - t_sub2.cpu().numpy(), axis=-1)
            visb = vis_eff2 > 0
            if not visb.any():
                break
            med = float(np.median(res[visb]))
            if ba_round < max(0, ba_irls):
                # soft Huber reweighting within this BA call only
                scale = max(2.0 * med, 5e-3)
                irls_w = np.minimum(1.0, scale / np.maximum(res, 1e-9))
                continue
            # observation-level outlier rejection under the converged
            # solution: cut from the track table and re-solve once
            bad = visb & (res > max(4.0 * med, reject_radius))
            if not bad.any():
                break
            for row, i in enumerate(idx2):
                vis[i][bad[row]] = 0.0

    # last observed pixel per track: tracks below triangulation support
    # still associate there, so the structure can grow past the bootstrap's
    last_pos = np.zeros((n, 2), tracks.dtype)
    last_seen = np.zeros((n,), bool)

    def reset_last_seen():
        last_pos[:] = 0.0
        last_seen[:] = False
        for f in range(s0, s0 + w0):
            seen = vis[f] > 0
            last_pos[seen] = tracks[f][seen]
            last_seen[seen] = True

    reset_last_seen()
    rng = np.random.default_rng(20240 + s0)

    def ransac_pnp(points, coords, pnp_ok, pose_init):
        """RANSAC over association subsets: PnP on random minimal subsets
        and the full set in one batch, keep the candidate with the most
        reprojection inliers (then the lowest mean inlier residual),
        refit on its inliers."""
        ok_idx = np.flatnonzero(pnp_ok)
        full_w = pnp_ok.astype(vis.dtype)
        if pnp_ransac <= 0 or ok_idx.size <= min_pnp_tracks + 1:
            return pnp_pose(points, dev(coords), dev(full_w), intrinsics, pose_init)
        subset_size = max(4, min_pnp_tracks)
        cand_w = [full_w]
        for _ in range(pnp_ransac):
            pick = rng.choice(ok_idx, size=min(subset_size, ok_idx.size), replace=False)
            w_s = np.zeros_like(full_w)
            w_s[pick] = 1.0
            cand_w.append(w_s)
        cand_poses = pnp_pose(points, dev(coords), dev(np.stack(cand_w)), intrinsics, pose_init)
        res = np.linalg.norm(project(points, cand_poses)[0].cpu().numpy() - coords[None], axis=-1)
        res = np.where(pnp_ok[None], res, np.inf)
        inl = res < ransac_inlier_radius
        counts = inl.sum(axis=1)
        mean_res = np.where(counts > 0, np.where(inl, res, 0.0).sum(axis=1) / np.maximum(counts, 1), np.inf)
        best = int(np.lexsort((mean_res, -counts))[0])
        best_inl = inl[best]
        if counts[best] >= min_pnp_tracks and not best_inl.all():
            return pnp_pose(points, dev(coords), dev(best_inl.astype(vis.dtype)), intrinsics, cand_poses[best])
        return cand_poses[best]

    since_ba = 0

    def run_chain(order, pred_of=None):
        """One association pass over ``order``; ``pred_of`` (frame -> pose)
        replaces the constant-velocity prediction."""
        nonlocal since_ba
        for k in order:
            idx, posed, t_sub, v_sub = subset()
            points = triangulate_points(posed, intrinsics, t_sub, dev(v_sub))
            # count observing frames, not fractional IRLS weights
            support = (v_sub > 0).sum(axis=0) >= 2
            if pred_of is not None and k in pred_of:
                pose_k = pred_of[k]
            else:
                # constant velocity from the two nearest solved frames
                if k > idx[-1]:
                    prev, prev2 = pose_of[idx[-1]], pose_of[idx[-2]]
                else:
                    prev, prev2 = pose_of[idx[0]], pose_of[idx[1]]
                pose_k = _compose(prev, _to_window_frame(prev[None], prev2)[0])
            for _ in range(3):  # associate -> PnP rounds
                proj, in_front = project(points, pose_k)
                proj = proj.cpu().numpy().copy()
                in_front = in_front.cpu().numpy()
                active = (support & in_front) | last_seen
                unsupported = ~(support & in_front) & last_seen
                proj[unsupported] = last_pos[unsupported]
                coords, ok = _associate_detections(
                    proj, active, dets_np[k], det_ok_np[k], assoc_radius, desc_cost=_desc_cost(k)
                )
                pnp_ok = ok & support  # only triangulated tracks
                if pnp_ok.sum() < min_pnp_tracks:
                    break
                pose_k = ransac_pnp(points, coords, pnp_ok, pose_k)
            if reject_outliers and (ok & support).sum() >= min_pnp_tracks:
                # cut associations inconsistent with the accepted pose
                # before they enter the track table
                res = np.linalg.norm(project(points, pose_k)[0].cpu().numpy() - coords, axis=-1)
                checked = ok & support
                med = float(np.median(res[checked]))
                ok = ok & ~(checked & (res > max(4.0 * med, reject_radius)))
            tracks[k] = coords
            vis[k] = ok.astype(vis.dtype)
            last_pos[ok] = coords[ok]
            last_seen[ok] = True
            if use_desc:
                _desc_update(np.flatnonzero(ok), k, coords[ok])
            pose_of[k] = pose_k
            if k not in solved_frames:
                solved_frames.append(k)
            since_ba += 1
            if since_ba % ba_every == 0:
                run_ba()

    # forward from the bootstrap, then backward from it
    order = list(range(s0 + w0, kf)) + list(range(s0 - 1, -1, -1))
    run_chain(order)
    # re-triangulating from the refined poses once more recovers structure
    # that early (drifted) poses seeded badly
    run_ba(reject=reject_outliers)
    run_ba()

    for extra_pass in range(max(0, chain_passes - 1)):
        # re-make every association under the refined trajectory: reset the
        # track table to the bootstrap, keep the poses as predictions, and
        # traverse in the other direction
        pred_of = dict(pose_of)
        tracks[:] = 0.0
        vis[:] = 0.0
        tracks[s0 : s0 + w0] = boot_tracks_np
        vis[s0 : s0 + w0] = boot_vis_np.astype(vis.dtype)
        solved_frames.clear()
        solved_frames.extend(range(s0, s0 + w0))
        reset_last_seen()
        _desc_reset()
        since_ba = 0
        run_chain(list(reversed(order)) if extra_pass % 2 == 0 else order, pred_of=pred_of)
        run_ba(reject=reject_outliers)
        run_ba()

    def reassociate():
        """Trajectory-wide re-association under the converged poses, then
        a refit; a frame takes the new associations where they are more,
        or as many and different."""
        for _ in range(2):
            _, posed, t_sub, v_sub = subset()
            support_all = (v_sub > 0).sum(axis=0) >= 2
            points = triangulate_points(
                posed, intrinsics_box[0], t_sub, dev(v_sub * support_all[None, :].astype(vis.dtype))
            )
            proj_all, front_all = project(points, torch.stack([pose_of[k] for k in range(kf)]))
            proj_all, front_all = proj_all.cpu().numpy(), front_all.cpu().numpy()
            changed = False
            for k in range(kf):
                coords, ok = _associate_detections(
                    proj_all[k].copy(), support_all & front_all[k], dets_np[k], det_ok_np[k], assoc_radius,
                    desc_cost=_desc_cost(k),
                )
                n_ok, n_vis = ok.sum(), (vis[k] > 0).sum()
                if n_ok > n_vis or (n_ok == n_vis and not np.array_equal(ok, vis[k] > 0)):
                    tracks[k] = np.where(ok[:, None], coords, tracks[k])
                    vis[k] = ok.astype(vis.dtype)
                    changed = True
            if not changed:
                break
            run_ba(reject=reject_outliers)
            run_ba()

    reassociate()
    if refine_intrinsics:
        # a final BA with the focal free on the association tracks, then
        # re-association and a refit under the refined focal
        run_ba(free_focal=True)
        reassociate()
        run_ba(free_focal=True)
    final = torch.stack([pose_of[i] for i in range(kf)])
    if debug_out is not None:
        debug_out["tracks"] = tracks.copy()
        debug_out["vis"] = vis.copy()
        debug_out["intrinsics"] = intrinsics_box[0].cpu().numpy()
        debug_out["poses"] = final.cpu().numpy()
        debug_out["bootstrap_start"] = s0
    if return_cost:
        # self-consistency: mean reprojection residual of the associated
        # observations under the final poses, structure and intrinsics
        support = (vis > 0).sum(axis=0) >= 2
        vis_eff = vis * support[None, :].astype(vis.dtype)
        points = triangulate_points(final, intrinsics_box[0], dev(tracks), dev(vis_eff))
        proj = project(points, final)[0].cpu().numpy()
        res = np.linalg.norm(proj - tracks, axis=-1)[vis_eff > 0]
        if res.size == 0:
            res = np.asarray([np.inf])
        # per-frame coverage penalty: a frame with fewer than
        # min_pnp_tracks associations is pose-unconstrained
        per_frame = (vis_eff > 0).sum(axis=1)
        deficit = np.maximum(0.0, 1.0 - per_frame / max(1, min_pnp_tracks + 1))
        cost = float(np.mean(res)) + 0.1 * float(np.mean(deficit))
        return final, cost
    return final


def solve_learned_vo_incremental(
    guess_fn: Callable,
    tracks: torch.Tensor,
    visibility: torch.Tensor,
    config: TrajectoryConfig,
    irls_rounds: int = 2,
    refine_intrinsics: bool = True,
    detections: Optional[torch.Tensor] = None,
    det_scores: Optional[torch.Tensor] = None,
    window_obs_fn: Optional[Callable] = None,
    num_bootstraps: int = 3,
    pnp_ransac: int = 0,
    chain_passes: int = 1,
    reject_outliers: bool = False,
    ba_irls: int = 0,
    det_descriptors: Optional[torch.Tensor] = None,
    desc_weight: float = 0.0,
    debug_out: Optional[dict] = None,
) -> torch.Tensor:
    """Learned incremental VO: a learned bootstrap window, then the
    accumulator.

    Each bootstrap is ``guess_fn``'s window solve with ``irls_rounds``
    geometry-informed re-solves (Huber weights at the 70th percentile of
    the visible reprojection angles, floor 5e-3); its poses, intrinsics
    (focal ``elu(f) + 1``) and observations seed the accumulator.  With
    ``detections``, ``num_bootstraps`` windows (``np.linspace`` starts)
    each seed a two-frame bootstrap of
    :func:`solve_incremental_vo_detections` and the chain of lowest cost
    wins; without, window 0 seeds :func:`solve_incremental_vo` and, with
    ``refine_intrinsics``, one BA with the focal free follows.

    :param guess_fn: ``(pixels (1, M, N, 2), visibility (1, M, N))`` to a
        flat calibration vector ``(1, P)``.
    :param tracks: ``(K, N, 2)`` track observations.
    :param visibility: ``(K, N)`` track weights.
    :param window_obs_fn: ``start -> (pixels (1, M, N, 2), visibility)``
        of the window at ``start`` (the front end's fresh window matches).
    :return: ``(K, 6)`` estimated poses.
    """
    full_f32_matmuls()
    w = config.window
    kf = tracks.shape[0]

    def bootstrap(start):
        if window_obs_fn is not None:
            w_pix, w_vis = window_obs_fn(start)
            w_vis = w_vis.to(tracks.dtype)
        else:
            w_pix = tracks[start : start + w][None]
            w_vis = visibility[start : start + w].to(tracks.dtype)[None]
        vec = guess_fn(w_pix, w_vis)[0]
        for _ in range(max(0, irls_rounds)):
            res = calibration_residuals(vec[None], w_pix)[0]
            masked = torch.where(w_vis[0] > 0, res, torch.full_like(res, float("nan")))
            # no visible observation: the percentile is NaN, take the floor
            scale = torch.clamp(torch.nan_to_num(torch.nanquantile(masked.reshape(-1), 0.7), nan=5e-3), min=5e-3)
            huber = torch.clamp(scale / torch.clamp(res, min=1e-9), max=1.0)
            w_vis = (w_vis[0] * huber)[None]
            vec = guess_fn(w_pix, w_vis)[0]
        params = unpack_calibration_parameters(vec, w, w_pix.shape[2])
        rel = torch.cat([params.camera_rotations[:, 0, :], params.camera_translations[:, 0, :]], dim=-1)
        boot_est = torch.cat([torch.zeros(1, 6, dtype=rel.dtype, device=rel.device), rel], dim=0)
        intr = params.intrinsics.reshape(-1)
        intrinsics = torch.stack([F.elu(intr[0]) + 1.0, intr[1], intr[2]]).to(tracks.dtype)
        return boot_est, intrinsics, w_pix[0], w_vis[0]

    if detections is not None:
        # geometric association over raw detections; each bootstrap is
        # trimmed to two frames and the chain runs forward and backward
        if num_bootstraps <= 1 or kf <= w:
            starts = [0]
        else:
            starts = sorted({int(s) for s in np.linspace(0, kf - w, num_bootstraps).round()})
        best = None
        all_costs = {}
        for s in starts:
            boot_est, intrinsics, b_pix, b_vis = bootstrap(s)
            dbg = {} if debug_out is not None else None
            est, cost = solve_incremental_vo_detections(
                detections,
                det_scores,
                intrinsics,
                boot_est[:2],
                b_pix[:2],
                b_vis[:2],
                refine_intrinsics=refine_intrinsics,
                bootstrap_start=s,
                return_cost=True,
                pnp_ransac=pnp_ransac,
                chain_passes=chain_passes,
                reject_outliers=reject_outliers,
                ba_irls=ba_irls,
                det_descriptors=det_descriptors,
                desc_weight=desc_weight,
                debug_out=dbg,
            )
            all_costs[s] = float(cost)
            if debug_out is not None:
                debug_out.setdefault("candidates", {})[s] = (float(cost), est.cpu().numpy())
            if best is None or cost < best[0]:
                best = (cost, est, s, dbg)
        if debug_out is not None:
            debug_out.update(best[3] or {})
            debug_out["bootstrap_costs"] = all_costs
            debug_out["chosen_bootstrap"] = best[2]
        return best[1]

    boot_est, intrinsics, _, _ = bootstrap(0)
    estimates = solve_incremental_vo(tracks, visibility, intrinsics, boot_est)
    if refine_intrinsics:
        # one final BA with the focal free on the full track set
        points = triangulate_points(estimates, intrinsics, tracks, visibility)
        n = tracks.shape[1]
        pose_free = np.ones((kf, 6), bool)
        pose_free[0] = False
        point_free = np.ones((n, 3), bool)
        point_free[0, 2] = False
        estimates = schur_ba_solve(
            BAProblem(intrinsics=intrinsics, poses=estimates, points=points),
            BAObservations(pixels=tracks, visibility=visibility.to(tracks.dtype)),
            SchurConfig(iterations=15, damping=1e-3),
            gauge_masks=(np.array([True, False, False]), pose_free, point_free),
        ).poses
    return estimates


def refine_trajectory_global(
    estimates: torch.Tensor,
    intrinsics: torch.Tensor,
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    solver: SchurConfig = SchurConfig(iterations=15, damping=1e-3),
    mesh=None,
    rounds: int = 1,
) -> torch.Tensor:
    """Global pose refinement: triangulate every point from the trajectory
    and run a full-sequence BA (intrinsics frozen, frame 0 pinned);
    ``rounds > 1`` alternates the two.  With ``mesh`` the point block is
    sharded over its ``"data"`` axis (:func:`davo_tpu_torch.parallel.
    distributed_schur_ba`; every rank calls this with the whole sequence).

    :param estimates: ``(K, 6)`` world->camera poses.
    :return: ``(K, 6)`` refined poses.
    """
    full_f32_matmuls()
    masks = _vo_gauge_masks(pixels.shape[0], pixels.shape[1])
    poses = estimates
    for _ in range(max(1, rounds)):
        points = triangulate_points(poses, intrinsics, pixels, visibility)
        problem = BAProblem(intrinsics=intrinsics, poses=poses, points=points)
        obs = BAObservations(pixels=pixels, visibility=visibility)
        if mesh is not None:
            poses = distributed_schur_ba(problem, obs, mesh, solver, gauge_masks=masks).poses
        else:
            poses = schur_ba_solve(problem, obs, solver, gauge_masks=masks).poses
    return poses


def _rescale_segments(estimates: torch.Tensor, log_s: torch.Tensor) -> torch.Tensor:
    """Rescale the camera-centre increments of a trajectory,
    ``c_k(s) = c_0 + sum_{j<k} exp(s_j) (c_{j+1} - c_j)``, rotations
    unchanged: the deformation family of chained window-scale drift.

    :param estimates: ``(K, 6)`` world->camera poses.
    :param log_s: ``(..., K - 1)`` per-segment log scales.
    :return: ``(..., K, 6)`` rescaled poses.
    """
    rot = so3_rotation_matrix(estimates[:, 0:3])  # (K, 3, 3)
    centres = -torch.einsum("kji,kj->ki", rot, estimates[:, 3:6])
    scaled = torch.exp(log_s)[..., None] * (centres[1:] - centres[:-1])
    zero = torch.zeros(log_s.shape[:-1] + (1, 3), dtype=estimates.dtype, device=estimates.device)
    new_centres = centres[0] + torch.cat([zero, torch.cumsum(scaled, dim=-2)], dim=-2)
    t = -torch.einsum("kij,...kj->...ki", rot, new_centres)
    return torch.cat([estimates[:, 0:3].expand(t.shape), t], dim=-1)


def refine_trajectory_multistart(
    estimates: torch.Tensor,
    intrinsics: torch.Tensor,
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_hypotheses: int = 16,
    modes: int = 4,
    sigma: float = 0.25,
    solver: SchurConfig = SchurConfig(iterations=30, damping=1e-3),
    rounds: int = 2,
    coefficients: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Multi-hypothesis global refinement that escapes the stitched-scale
    family of local minima: the trajectory is perturbed along ``modes``
    low-order cosine modes of per-segment log-scale (coefficients
    ``sigma`` times standard normals, ``(num_hypotheses - 1, modes)``
    drawn from ``generator`` or given as ``coefficients``; hypothesis 0
    is unperturbed), every hypothesis is refined by ``rounds`` of DLT
    triangulation and Schur BA, and the one of lowest final reprojection
    cost (:func:`~davo_tpu_torch.parallel.ba_cost`, the first of equal
    costs) wins.  The port's Schur BA takes one problem, so the
    hypotheses run one after another (the JAX package vmaps them).

    :return: ``(K, 6)`` refined poses of the best-cost hypothesis.
    """
    full_f32_matmuls()
    kf, n = pixels.shape[0], pixels.shape[1]
    dtype, device = estimates.dtype, estimates.device
    seg = torch.arange(kf - 1, dtype=dtype, device=device)
    basis = torch.stack([torch.cos(np.pi * (m + 1) * (seg + 0.5) / (kf - 1)) for m in range(modes)])
    if coefficients is None:
        coefficients = torch.randn((num_hypotheses - 1, modes), generator=generator, dtype=dtype, device=device)
    log_s = torch.cat([torch.zeros(1, kf - 1, dtype=dtype, device=device), (sigma * coefficients) @ basis])
    masks = _vo_gauge_masks(kf, n)
    obs = BAObservations(pixels=pixels, visibility=visibility)
    refined, costs = [], []
    for start in _rescale_segments(estimates, log_s):
        poses = start
        for _ in range(max(1, rounds)):
            points = triangulate_points(poses, intrinsics, pixels, visibility)
            poses = schur_ba_solve(
                BAProblem(intrinsics=intrinsics, poses=poses, points=points), obs, solver, gauge_masks=masks
            ).poses
        points = triangulate_points(poses, intrinsics, pixels, visibility)
        refined.append(poses)
        costs.append(ba_cost(BAProblem(intrinsics=intrinsics, poses=poses, points=points), obs, solver))
    return torch.stack(refined)[torch.argmin(torch.stack(costs))]


def correct_scale_drift(
    estimates: torch.Tensor,
    intrinsics: torch.Tensor,
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    iterations: int = 30,
) -> torch.Tensor:
    """Remove accumulated window-scale drift from a stitched trajectory:
    optimise the per-segment log-scales ``s_k`` of the camera-centre
    increments (:func:`_rescale_segments`, rotations fixed) and nothing
    else, scored by the reprojection cost of a DLT triangulation at the
    rescaled poses, with the batched BFGS solver (a ``(K - 1)``-parameter
    problem of batch 1: on the card its Hessian block is kernel K1 at
    P = K - 1).  The cost's gradient is autograd through the
    triangulation's solve.

    :param estimates: ``(K, 6)`` stitched world->camera poses.
    :return: ``(K, 6)`` poses with corrected per-segment scales.
    """
    from davo_tpu_torch.solve import BFGSConfig, bfgs_solve

    full_f32_matmuls()
    kf = estimates.shape[0]
    vis = visibility.to(pixels.dtype)

    def one(log_s):
        poses = _rescale_segments(estimates, log_s)
        points = triangulate_points(poses, intrinsics, pixels, visibility)
        rel = torch.einsum("kij,nj->kni", so3_rotation_matrix(poses[:, 0:3]), points) + poses[:, None, 3:6]
        z = torch.clamp(rel[..., 2], min=1e-3)
        u = intrinsics[0] * rel[..., 0] / z + intrinsics[1]
        v = intrinsics[0] * rel[..., 1] / z + intrinsics[2]
        return torch.sum(torch.square((torch.stack([u, v], dim=-1) - pixels) * vis[..., None]))

    solved = bfgs_solve(
        lambda log_s_batch: torch.stack([one(row) for row in log_s_batch]),
        torch.zeros(1, kf - 1, dtype=estimates.dtype, device=estimates.device),
        BFGSConfig(iterations=iterations, error_threshold=0.0, minimum_step=1e-12, drop_path_p=0.0,
                   line_search_iterations=20),
    )
    return _rescale_segments(estimates, solved[0])


def refine_trajectory_host_f64(
    estimates: torch.Tensor,
    intrinsics: torch.Tensor,
    pixels: torch.Tensor,
    visibility: torch.Tensor,
    solver: SchurConfig = SchurConfig(iterations=30, damping=1e-6),
    rounds: int = 2,
) -> torch.Tensor:
    """Final float64 polish of a refined trajectory: one more
    :func:`refine_trajectory_global` (``rounds`` of triangulation and
    Schur BA) in float64, returned in the input dtype.

    The Schur BA and the DLT triangulation form normal equations, so in
    float32 their accuracy floor is about sqrt(eps); the global pose
    system is small, so float64 removes that floor for little cost.  The
    JAX package leaves the TPU for the host CPU here only because the TPU
    has no float64; the H100 has it, so the port polishes on the
    estimates' own device (the caller's) and keeps the JAX name.
    """
    vis = visibility.double() if visibility.is_floating_point() else visibility
    polished = refine_trajectory_global(
        estimates.double(), intrinsics.double(), pixels.double(), vis, solver=solver, rounds=rounds
    )
    return polished.to(estimates.dtype)


def evaluate_learned_vo(
    guess_fn: Callable,
    generator: Optional[torch.Generator],
    config: TrajectoryConfig = TrajectoryConfig(),
    refine: bool = False,
    mesh=None,
    refine_rounds: int = 1,
    host_polish: bool = False,
    multistart: int = 0,
    stitch: str = "global",
    frontend_fn: Optional[Callable] = None,
    render_config: Optional[RenderConfig] = None,
    track_fn: Optional[Callable] = None,
    irls_rounds: int = 0,
    pipeline: str = "windows",
    detections_fn: Optional[Callable] = None,
    pnp_ransac: int = 0,
    chain_passes: int = 1,
    reject_outliers: bool = False,
    ba_irls: int = 0,
    num_bootstraps: int = 3,
    descriptors_fn: Optional[Callable] = None,
    desc_weight: float = 0.0,
    debug_out: Optional[dict] = None,
    device=None,
    noise: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """Generate a sequence, run the learned VO (``pipeline="windows"``, the
    default: every window solved by ``guess_fn`` in one stacked call and
    the windows stitched by ``stitch``; or ``"incremental"``: a learned
    bootstrap and the accumulator), refine it (``multistart`` scale-mode
    hypotheses, else with ``refine`` one global refinement) and with
    ``host_polish`` polish it in float64, and report the
    similarity-aligned ATE of the camera centres.

    With ``frontend_fn`` the pipeline is image-based: the sequence is
    rendered and the refinement (and the accumulator) consumes the front
    end's whole-sequence tracks (``track_fn`` or ``frontend_fn`` on all
    frames; with ``detections_fn`` the raw detections and their
    probabilities); every window (or bootstrap window) is matched fresh
    by ``frontend_fn``.

    :param generator: draws the sequence, then its render, then the
        multistart hypotheses (on the card unless ``device`` says
        otherwise).
    :param noise: ``{"trajectory": ..., "render": ..., "hypotheses": ...}``
        draws to use instead of the generator's
        (:func:`draw_trajectory_noise`, :func:`draw_trajectory_render_noise`,
        the ``(multistart - 1, 4)`` standard normals of
        :func:`refine_trajectory_multistart`).
    :param debug_out: filled by the incremental pipeline (see
        :func:`solve_learned_vo_incremental`) or, for the windows, with
        the ``window_starts``, the ``window_poses``, the ``stitched``
        trajectory, the observations (``pixels``, ``visibility``), the
        ``intrinsics`` and the ``true_poses``.
    :return: ``rmse``, ``mean``, ``median`` and ``max`` of the ATE.
    """
    if pipeline not in ("windows", "incremental"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    if mesh is not None:
        require_mesh(mesh)
    full_f32_matmuls()
    device = resolve_device(device)
    noise = noise or {}
    trajectory_noise = noise.get("trajectory") or draw_trajectory_noise(generator, config, device)
    poses, _, pixels, visibility = trajectory_from_noise(trajectory_noise, config)
    images = None
    if frontend_fn is not None:
        images = render_trajectory_images(
            pixels, visibility, generator, render_config, noise=noise.get("render")
        )
        # learned global tracks replace the oracle observations downstream
        tracks, track_vis = (track_fn or frontend_fn)(images[None])
        pixels, visibility = tracks[0], track_vis[0]
    if pipeline == "incremental":
        detections = det_scores = det_descriptors = window_obs_fn = None
        if detections_fn is not None and images is not None:
            dets, dscores = detections_fn(images[None])
            detections, det_scores = dets[0], dscores[0]
            if descriptors_fn is not None and desc_weight > 0.0:
                det_descriptors = descriptors_fn(images[None])[0]
        if frontend_fn is not None:
            # candidate bootstrap windows are matched fresh, anchored at
            # their own first frame
            def window_obs_fn(s):
                return frontend_fn(images[s : s + config.window][None])

        estimates = solve_learned_vo_incremental(
            guess_fn,
            pixels,
            visibility.to(pixels.dtype),
            config,
            irls_rounds=max(irls_rounds, 2),
            detections=detections,
            det_scores=det_scores,
            window_obs_fn=window_obs_fn,
            pnp_ransac=pnp_ransac,
            chain_passes=chain_passes,
            reject_outliers=reject_outliers,
            ba_irls=ba_irls,
            num_bootstraps=num_bootstraps,
            det_descriptors=det_descriptors,
            desc_weight=desc_weight,
            debug_out=debug_out,
        )
    else:
        if stitch not in ("chain", "global", "robust"):
            raise ValueError(f"unknown stitch mode {stitch!r}")
        starts, window_poses = solve_learned_windows(
            guess_fn, pixels, visibility, config, images=images, frontend_fn=frontend_fn, irls_rounds=irls_rounds
        )
        estimates = stitch_windows(starts, window_poses, pixels.shape[0], stitch)
        if debug_out is not None:
            debug_out.update(window_starts=starts, window_poses=window_poses, stitched=estimates, pixels=pixels,
                             visibility=visibility, true_poses=poses)
    intrinsics = torch.tensor([config.focal_length, 0.0, 0.0], dtype=estimates.dtype, device=estimates.device)
    if debug_out is not None:
        debug_out["intrinsics"] = intrinsics
    if multistart > 0:
        coefficients = noise.get("hypotheses")
        if coefficients is None:
            coefficients = torch.randn((multistart - 1, 4), generator=generator, dtype=estimates.dtype,
                                       device=estimates.device)
        estimates = refine_trajectory_multistart(
            estimates, intrinsics, pixels, visibility, num_hypotheses=multistart, rounds=max(2, refine_rounds),
            coefficients=coefficients,
        )
    elif refine:
        estimates = refine_trajectory_global(
            estimates, intrinsics, pixels, visibility, mesh=mesh, rounds=refine_rounds
        )
    if host_polish:
        estimates = refine_trajectory_host_f64(estimates, intrinsics, pixels, visibility)
    est_centres = camera_centers_from_poses(estimates[:, 0:3], estimates[:, 3:6])
    true_centres = camera_centers_from_poses(poses[:, 0:3], poses[:, 3:6])
    return absolute_trajectory_error(est_centres, true_centres)


def draw_observation_noise(
    generator: torch.Generator,
    num_frames: int,
    num_points: int,
    pixel_noise: bool = False,
    dtype=torch.float32,
    device=None,
) -> Dict[str, torch.Tensor]:
    """The unit draws of :func:`observations_for_poses`: ``depths``
    ``(N, 1)`` uniform in [0, 1), ``scatter`` ``(N, 3)`` standard normal
    and, with ``pixel_noise``, ``pixels`` ``(K, N, 2)`` standard normal."""
    noise = dict(
        depths=torch.rand((num_points, 1), generator=generator, dtype=dtype, device=device),
        scatter=torch.randn((num_points, 3), generator=generator, dtype=dtype, device=device),
    )
    if pixel_noise:
        noise["pixels"] = torch.randn((num_frames, num_points, 2), generator=generator, dtype=dtype, device=device)
    return noise


def observations_for_poses(
    poses: torch.Tensor,
    intrinsics: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    num_points: int = 32,
    depth_scale: float = 10.0,
    pixel_noise: float = 0.0,
    noise: Optional[Dict[str, torch.Tensor]] = None,
):
    """Synthesise landmark observations along an arbitrary camera path.

    Trajectory files carry no tracked features, so landmarks are placed
    ahead of evenly spaced anchor frames (each in front of some camera, so
    every window sees the landmarks anchored near it: forward-motion KITTI
    paths work as well as orbits), at ``depth_scale`` median steps times
    a uniform factor in [0.7, 1.6) and scattered by 0.35 of that depth,
    and projected through every frame (plus ``pixel_noise`` times a
    standard normal).  The draws come from ``generator`` or ``noise``
    (:func:`draw_observation_noise`).

    :param poses: ``(K, 6)`` world->camera.
    :param intrinsics: ``(3,)`` ``(f, cx, cy)``.
    :return: ``(points (N, 3), pixels (K, N, 2), visibility (K, N))``.
    """
    full_f32_matmuls()
    kf = poses.shape[0]
    rot = so3_rotation_matrix(poses[:, 0:3])  # (K, 3, 3)
    centres = -torch.einsum("kji,kj->ki", rot, poses[:, 3:6])
    forward = rot[:, 2, :]  # the camera z-axis in world coordinates
    # the median step (linear interpolation: the mean of the middle two
    # for an even count, as jnp.median)
    step = torch.quantile(torch.linalg.vector_norm(centres[1:] - centres[:-1], dim=-1), 0.5)
    depth = depth_scale * torch.clamp(step, min=1e-3)
    anchor = torch.as_tensor(np.round(np.linspace(0.0, kf - 1.0, num_points)).astype(np.int64), device=poses.device)
    if noise is None:
        noise = draw_observation_noise(generator, kf, num_points, pixel_noise > 0.0, poses.dtype, poses.device)
    depths = depth * torch.clamp(noise["depths"] * (1.6 - 0.7) + 0.7, min=0.7)
    scatter = 0.35 * depth * noise["scatter"]
    points = centres[anchor] + forward[anchor] * depths + scatter
    rel = torch.einsum("kij,nj->kni", rot, points) + poses[:, None, 3:6]
    z = torch.clamp(rel[..., 2], min=1e-8)
    f, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2]
    u = f * rel[..., 0] / z + cx
    v = f * rel[..., 1] / z + cy
    pixels = torch.stack([u, v], dim=-1)
    if pixel_noise > 0.0:
        pixels = pixels + pixel_noise * noise["pixels"]
    visibility = (torch.abs(u) < 1.0) & (torch.abs(v) < 1.0) & (rel[..., 2] > 0.05 * depth)
    return points, pixels, visibility


def evaluate_vo_sequence_file(
    path: str,
    format: str = "tum",
    config: TrajectoryConfig = TrajectoryConfig(),
    generator: Optional[torch.Generator] = None,
    intrinsics: Optional[torch.Tensor] = None,
    max_frames: Optional[int] = None,
    num_points: Optional[int] = None,
    guess_fn: Optional[Callable] = None,
    frontend_fn: Optional[Callable] = None,
    render_config: Optional[RenderConfig] = None,
    stitch: str = "global",
    pipeline: str = "windows",
    detections_fn: Optional[Callable] = None,
    device=None,
    noise: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """Windowed VO along a trajectory loaded from a file (TUM or KITTI).

    The motion comes from the file; landmark observations are synthesised
    along it (:func:`observations_for_poses`).  Without ``guess_fn`` the
    oracle path runs (:func:`solve_windowed_vo`: chained Schur windows
    from noisy priors, the known intrinsics); with it the learned
    pipeline (``pipeline="windows"``: :func:`solve_windowed_vo_learned`;
    ``"incremental"``: :func:`solve_learned_vo_incremental`), on the
    oracle observations or, with ``frontend_fn``, on the front end's
    matches in frames rendered along the file (``detections_fn`` gives
    the incremental pipeline its raw detections).

    :param generator: draws the landmarks, then the priors (oracle) or
        the render (a generator seeded 0 on ``device`` when omitted).
    :param device: the card unless the caller asks for the CPU; the
        poses are ``config.dtype`` there.
    :param noise: ``{"observations": ..., "priors": ..., "render": ...}``
        draws to use instead of the generator's
        (:func:`draw_observation_noise`, :func:`draw_window_prior_noise`,
        :func:`draw_trajectory_render_noise`).
    :return: the aligned ATE (``rmse``, ``mean``, ``median``, ``max``),
        ``rpe_*`` at delta 1 and ``num_frames``.
    """
    from davo_tpu_torch.data.sequences import load_sequence

    from .evaluation import relative_pose_error

    if pipeline not in ("windows", "incremental"):
        raise ValueError(f"unknown pipeline {pipeline!r}")
    full_f32_matmuls()
    device = resolve_device(device)
    noise = noise or {}
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    seq = load_sequence(path, format, device=device, dtype=config.dtype)
    poses = seq.poses if max_frames is None else seq.poses[:max_frames]
    kf = poses.shape[0]
    if kf < config.window:
        raise ValueError(f"sequence has {kf} frames < window {config.window}")
    if intrinsics is None:
        intrinsics = (
            seq.intrinsics
            if seq.intrinsics is not None
            else torch.tensor([config.focal_length, 0.0, 0.0], dtype=poses.dtype, device=device)
        )
    intrinsics = torch.as_tensor(intrinsics, dtype=poses.dtype, device=device)
    n = num_points if num_points is not None else config.num_points
    points, pixels, visibility = observations_for_poses(
        poses, intrinsics, generator, num_points=n, noise=noise.get("observations")
    )
    seq_config = dataclasses.replace(config, num_frames=kf, num_points=n, focal_length=float(intrinsics[0]))
    if guess_fn is None:
        estimates = solve_windowed_vo(
            poses, points, pixels, visibility, seq_config, generator, intrinsics=intrinsics, noise=noise.get("priors")
        )
    else:
        images = None
        if frontend_fn is not None:
            images = render_trajectory_images(pixels, visibility, generator, render_config, noise=noise.get("render"))
        if pipeline == "incremental":
            detections = det_scores = window_obs_fn = None
            obs_pixels, obs_vis = pixels, visibility.to(pixels.dtype)
            if frontend_fn is not None:
                tracks, track_vis = frontend_fn(images[None])
                obs_pixels, obs_vis = tracks[0], track_vis[0].to(pixels.dtype)

                def window_obs_fn(s):
                    return frontend_fn(images[s : s + seq_config.window][None])

                if detections_fn is not None:
                    dets, dscores = detections_fn(images[None])
                    detections, det_scores = dets[0], dscores[0]
            estimates = solve_learned_vo_incremental(
                guess_fn, obs_pixels, obs_vis, seq_config, detections=detections, det_scores=det_scores,
                window_obs_fn=window_obs_fn,
            )
        else:
            estimates = solve_windowed_vo_learned(
                guess_fn, pixels, visibility, seq_config, stitch=stitch, images=images, frontend_fn=frontend_fn
            )
    est_centres = camera_centers_from_poses(estimates[:, 0:3], estimates[:, 3:6])
    true_centres = camera_centers_from_poses(poses[:, 0:3], poses[:, 3:6])
    metrics = absolute_trajectory_error(est_centres, true_centres)
    metrics.update({f"rpe_{name}": value for name, value in relative_pose_error(estimates, poses).items()})
    metrics["num_frames"] = torch.tensor(kf)
    return metrics


def evaluate_vo(
    generator: Optional[torch.Generator],
    config: TrajectoryConfig = TrajectoryConfig(),
    device=None,
    noise: Optional[dict] = None,
) -> Dict[str, torch.Tensor]:
    """Generate a sequence, run the oracle windowed VO
    (:func:`solve_windowed_vo`) and report the aligned ATE.

    :param generator: draws the sequence, then the priors (on the card
        unless ``device`` says otherwise).
    :param noise: ``{"trajectory": ..., "priors": ...}`` draws to use
        instead of the generator's.
    """
    full_f32_matmuls()
    device = resolve_device(device)
    noise = noise or {}
    trajectory_noise = noise.get("trajectory") or draw_trajectory_noise(generator, config, device)
    poses, points, pixels, visibility = trajectory_from_noise(trajectory_noise, config)
    estimates = solve_windowed_vo(poses, points, pixels, visibility, config, generator, noise=noise.get("priors"))
    est_centres = camera_centers_from_poses(estimates[:, 0:3], estimates[:, 3:6])
    true_centres = camera_centers_from_poses(poses[:, 0:3], poses[:, 3:6])
    return absolute_trajectory_error(est_centres, true_centres)
