"""Pose-graph stitching with the window edges sharded over a mesh (the port
of ``davo_tpu/parallel/pose_graph.py``).

The window stitcher (:func:`davo_tpu_torch.train.vo_eval.stitch_windows_global`)
solves two small global systems from every window-overlap edge: a
rotation-graph Gauss-Newton and a joint centre/scale least squares.  Here
the edges are sharded over a mesh axis; each rank reduces its edges into
the small dense normal equations, one all-reduce sums them, and the
replicated solves and updates run identically on every rank (SPMD: each
rank is called with every window and returns the whole trajectory).

Both solves use structure the host version leaves to ``lstsq``:

* the rotation system decouples per tangent component: all three share one
  graph Laplacian ``L = sum_e (h_f - h_s)(h_f - h_s)^T`` over frame
  indicator differences, so one ``(K-1, K-1)`` solve serves a 3-column rhs;
* the centre/scale system is assembled blockwise: the same Laplacian per
  centre component, an edge-summed centre-scale coupling block and a
  diagonal scale block.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch
import torch.nn.functional as F

from davo_tpu_torch.geometry import axis_angle_from_matrix, so3_rotation_matrix
from davo_tpu_torch.utils.precision import full_f32_matmuls

from .mesh import DATA_AXIS, axis
from .schur import _all_reduce_parts

__all__ = ["WindowEdges", "build_window_edges", "distributed_stitch_windows"]


class WindowEdges(NamedTuple):
    """Flat edge arrays of the window-overlap graph (padded).

    * ``start``/``frame``: ``(E,)`` int64 frame indices (the edge
      constrains ``R[frame] = rel_rot @ R[start]``).
    * ``rel_rot``: ``(E, 3, 3)`` window-relative rotations.
    * ``centre``: ``(E, 3)`` window-frame camera centre of ``frame``
      relative to ``start`` (each window's own gauge scale).
    * ``window``: ``(E,)`` int64 owning-window index.
    * ``weight``: ``(E,)`` 1 for real edges, 0 for padding.
    """

    start: torch.Tensor
    frame: torch.Tensor
    rel_rot: torch.Tensor
    centre: torch.Tensor
    window: torch.Tensor
    weight: torch.Tensor


def build_window_edges(starts: Sequence[int], window_poses: List[torch.Tensor], pad_to: int = 1) -> WindowEdges:
    """Edge arrays from per-window relative poses (static structure).

    :param starts: window anchor frames.
    :param window_poses: ``(w, 6)`` window-relative poses (frame
        ``starts[i]`` is the identity of window ``i``).
    :param pad_to: pad the edge count to a multiple of this (the mesh
        axis's size).
    """
    s_idx, f_idx, rels, centres, wins = [], [], [], [], []
    for wi, s in enumerate(starts):
        wp = window_poses[wi]
        rel_rot = so3_rotation_matrix(wp[:, 0:3])
        for j in range(1, wp.shape[0]):
            s_idx.append(s)
            f_idx.append(s + j)
            rels.append(rel_rot[j])
            # camera centre of frame j in the window's anchor frame
            centres.append(-rel_rot[j].T @ wp[j, 3:6])
            wins.append(wi)
    e = len(s_idx)
    pad = (-e) % max(pad_to, 1)
    dtype, device = window_poses[0].dtype, window_poses[0].device

    def index(values):
        return torch.tensor(values + [0] * pad, dtype=torch.int64, device=device)

    eye = torch.eye(3, dtype=dtype, device=device)
    return WindowEdges(
        start=index(s_idx),
        frame=index(f_idx),
        rel_rot=torch.cat([torch.stack(rels), eye.expand(pad, 3, 3)]),
        centre=F.pad(torch.stack(centres), (0, 0, 0, pad)),
        window=index(wins),
        weight=F.pad(torch.ones(e, dtype=dtype, device=device), (0, pad)),
    )


def _frame_indicator_diff(edges: WindowEdges, num_frames: int) -> torch.Tensor:
    """``(E, K-1)`` rows ``h_frame - h_start`` over the free frames 1..K-1
    (frame 0 is the gauge anchor and has no column)."""
    dtype = edges.rel_rot.dtype

    def one_hot(frame):  # frame 0 (and the padding's) has no column
        return F.one_hot(torch.clamp(frame - 1, min=0), num_frames - 1).to(dtype) * (frame > 0)[:, None]

    return (one_hot(edges.frame) - one_hot(edges.start)) * edges.weight[:, None]


def distributed_stitch_windows(
    starts: Sequence[int],
    window_poses: List[torch.Tensor],
    num_frames: int,
    mesh,
    axis_name: str = DATA_AXIS,
    rotation_iterations: int = 2,
) -> torch.Tensor:
    """Overlap-consistent global stitching with the edges sharded over
    ``mesh``'s ``axis_name``.

    Equals :func:`davo_tpu_torch.train.vo_eval.stitch_windows_global` (by
    damped normal equations where it takes least squares).  Traffic: one
    all-reduce of the ``(K-1, K-1)`` Laplacian and its ``(K-1, 3)`` rhs a
    rotation iteration, and one of the centre/scale blocks at the end.

    :return: ``(K, 6)`` absolute world->camera poses.
    """
    full_f32_matmuls()
    kf, n_win = num_frames, len(starts)
    group, size, coordinate = axis(mesh, axis_name)
    edges = build_window_edges(starts, window_poses, pad_to=size)
    per_rank = edges.start.shape[0] // size
    shard = WindowEdges(*(x[coordinate * per_rank : (coordinate + 1) * per_rank] for x in edges))
    dtype, device = edges.rel_rot.dtype, edges.rel_rot.device
    hd = _frame_indicator_diff(shard, kf)  # (E_loc, K-1)

    # greedy chaining seed (a host loop over the static window structure)
    rel_rots = [so3_rotation_matrix(wp[:, 0:3]) for wp in window_poses]
    rot_list = [None] * kf
    rot_list[0] = torch.eye(3, dtype=dtype, device=device)
    for wi, s in enumerate(starts):
        for j in range(1, window_poses[wi].shape[0]):
            if rot_list[s + j] is None:
                rot_list[s + j] = rel_rots[wi][j] @ rot_list[s]
    rot = torch.stack(rot_list)  # (K, 3, 3)

    eye_k = torch.eye(kf - 1, dtype=dtype, device=device)
    for _ in range(max(0, rotation_iterations)):
        # this shard's rotation-graph normal equations: residuals
        # log(R_f (R_rel R_s)^T), then one all-reduce of L and its rhs
        resid = axis_angle_from_matrix(rot[shard.frame] @ (shard.rel_rot @ rot[shard.start]).transpose(-1, -2))
        resid = resid * shard.weight[:, None]
        lap, rhs = _all_reduce_parts([hd.T @ hd, hd.T @ -resid], group)
        delta = torch.linalg.solve(lap + 1e-9 * eye_k, rhs)  # (K-1, 3)
        rot = torch.cat([rot[0:1], so3_rotation_matrix(delta) @ rot[1:]])

    # this shard's centre/scale normal blocks: d_e = R[start]^T cw, the
    # centre offset in world orientation
    d = torch.einsum("eji,ej->ei", rot[shard.start], shard.centre) * shard.weight[:, None]  # (E_loc, 3)
    is_win0 = (shard.window == 0).to(dtype)
    wsel = (
        F.one_hot(torch.clamp(shard.window - 1, min=0), n_win - 1).to(dtype)
        * (1.0 - is_win0)[:, None]
        * shard.weight[:, None]
    )  # (E_loc, W-1): zero rows for window 0 and the padding
    lap, cs, ss, bc = _all_reduce_parts(
        [
            hd.T @ hd,
            torch.einsum("ep,ew,ej->pwj", hd, wsel, -d),  # (K-1, W-1, 3)
            wsel.T @ torch.sum(d * d, dim=-1),  # (W-1,)
            (hd * is_win0[:, None]).T @ d,  # (K-1, 3)
        ],
        group,
    )

    # the dense (3(K-1) + (W-1)) normal system: the free camera centres
    # (component-major) and the window scales
    nc = 3 * (kf - 1)
    nu = nc + (n_win - 1)
    cs_block = cs.permute(0, 2, 1).reshape(nc, n_win - 1)
    ata = torch.zeros(nu, nu, dtype=dtype, device=device)
    ata[:nc, :nc] = torch.kron(lap, torch.eye(3, dtype=dtype, device=device))
    ata[:nc, nc:] = cs_block
    ata[nc:, :nc] = cs_block.T
    ata[nc:, nc:] = torch.diag(ss)
    atb = torch.cat([bc.reshape(nc), torch.zeros(n_win - 1, dtype=dtype, device=device)])
    solution = torch.linalg.solve(ata + 1e-9 * torch.eye(nu, dtype=dtype, device=device), atb)
    centres = torch.cat([torch.zeros(1, 3, dtype=dtype, device=device), solution[:nc].reshape(kf - 1, 3)])
    t_all = -torch.einsum("kij,kj->ki", rot, centres)
    return torch.cat([axis_angle_from_matrix(rot), t_all], dim=-1)
