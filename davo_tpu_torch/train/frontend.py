"""The visual front end's evaluation (the port of the eval part of
``davo_tpu/train/frontend.py``).

VO-window scenes (:mod:`davo_tpu_torch.data.vo_windows`) are rendered
into images (:mod:`davo_tpu_torch.data.rendering`) and the
:class:`~davo_tpu_torch.models.vo_frontend.VOFrontend`'s output is scored
against the known ground-truth correspondences:

* **detection** — for every visible true point, the distance to the
  nearest detected feature in that view;
* **score** — binary cross-entropy of the detection logits against "is
  some visible true point's nearest feature";
* **match** — for each true point visible in the anchor and in view m,
  the distance from the anchor feature assigned to it, regressed into
  view m, to the point's true coordinates there;
* **match_inlier_rate** (:func:`frontend_eval_metrics`) — the share of
  the visible solver-facing matches within two blob sigmas of some
  visible true point in their view.

The training step (optimiser, gradients, BatchNorm statistics updates)
belongs to the front end's training slice of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from davo_tpu_torch.data.rendering import (
    RenderConfig,
    appearance_from_noise,
    draw_appearance_noise,
    draw_frame_noise,
    render_frame,
)
from davo_tpu_torch.data.vo_windows import VOWindowConfig
from davo_tpu_torch.models.vo_frontend import FrontendOutput, VOFrontend
from davo_tpu_torch.types import CameraViewsAndPoints

__all__ = [
    "FrontendExperiment",
    "draw_render_noise",
    "render_scene_batch",
    "frontend_loss",
    "frontend_eval_metrics",
]


@dataclasses.dataclass(frozen=True)
class FrontendExperiment:
    """The front-end experiment's data, network and loss fields (the JAX
    package's; its optimiser, schedule and loop fields come with the
    training slice)."""

    num_views: int = 4
    num_points: int = 8
    num_select: int = 8
    descriptor_channels: int = 64
    embedding_size: int = 64
    detection_weight: float = 1.0
    score_weight: float = 0.2
    match_weight: float = 1.0
    window: VOWindowConfig = VOWindowConfig()
    render: RenderConfig = RenderConfig()

    def build_network(self, device: Optional[Union[str, torch.device]] = None, **gates) -> VOFrontend:
        return VOFrontend(
            num_select=self.num_select,
            descriptor_channels=self.descriptor_channels,
            embedding_size=self.embedding_size,
            image_channels=self.render.channels,
            device=device,
            **gates,
        )


def draw_render_noise(
    generator: torch.Generator,
    batch_size: int,
    num_views: int,
    num_points: int,
    config: RenderConfig,
    device: torch.device,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every draw of :func:`render_scene_batch`: per-scene appearance and
    per-frame background and pixel noise."""
    return dict(
        appearance=draw_appearance_noise(generator, (batch_size,), num_points, config, device),
        frame=draw_frame_noise(generator, (batch_size, num_views), config, device),
    )


def render_scene_batch(
    generator: Optional[torch.Generator],
    batch: CameraViewsAndPoints,
    config: RenderConfig,
    *,
    noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
) -> torch.Tensor:
    """Render every scene of a batch: ``(B, M, H, W, C)`` images.

    Appearance is sampled per scene and shared across that scene's views
    (what makes cross-view matching possible).  ``noise`` (the draws of
    :func:`draw_render_noise`) replaces the generator's draws.
    """
    b, m, n, _ = batch.projected_points.shape
    if noise is None:
        noise = draw_render_noise(generator, b, m, n, config, batch.projected_points.device)
    appearance = appearance_from_noise(noise["appearance"], config)  # (B, N, 8)
    return render_frame(
        batch.projected_points, batch.visibility_mask, appearance[:, None], config, noise["frame"]
    )


def frontend_loss(
    out: FrontendOutput,
    batch: CameraViewsAndPoints,
    config: FrontendExperiment,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Supervised losses against the ground-truth correspondences."""
    proj = batch.projected_points  # (B, M, N, 2)
    vis = batch.visibility_mask.to(proj.dtype)  # (B, M, N)
    pts = out.points  # (B, M, K, 2)
    k = pts.shape[2]

    # detection: nearest feature per visible true point
    d2 = torch.sum(torch.square(proj[:, :, :, None, :] - pts[:, :, None, :, :]), dim=-1)  # (B, M, N, K)
    nearest = torch.argmin(d2, dim=-1)  # (B, M, N)
    min_d = torch.sqrt(torch.amin(d2, dim=-1) + 1e-12)
    vis_count = torch.clamp(torch.sum(vis), min=1.0)
    detection_loss = torch.sum(min_d * vis) / vis_count

    # score: BCE against "assigned to a visible point"
    assigned = torch.clamp(
        torch.sum(F.one_hot(nearest, k).to(proj.dtype) * vis[..., None], dim=2), 0.0, 1.0
    )  # (B, M, K)
    score_loss = torch.mean(F.binary_cross_entropy_with_logits(out.scores, assigned, reduction="none"))

    # matching: anchor-assigned features regress true coordinates
    anchor_idx = nearest[:, 0]  # (B, N)
    match_pred = torch.take_along_dim(out.matched, anchor_idx[:, None, :, None], dim=2)  # (B, M, N, 2)
    joint_vis = vis * vis[:, 0:1]
    joint_vis[:, 0] = 0.0  # view 0 is the anchor itself
    match_err = torch.sqrt(torch.sum(torch.square(match_pred - proj), dim=-1) + 1e-12)
    match_count = torch.clamp(torch.sum(joint_vis), min=1.0)
    match_loss = torch.sum(match_err * joint_vis) / match_count

    loss = (
        config.detection_weight * detection_loss
        + config.score_weight * score_loss
        + config.match_weight * match_loss
    )
    metrics = {
        "loss": loss,
        "detection_loss": detection_loss,
        "score_loss": score_loss,
        "match_loss": match_loss,
    }
    return loss, metrics


def frontend_eval_metrics(
    out: FrontendOutput,
    batch: CameraViewsAndPoints,
    config: FrontendExperiment,
) -> Dict[str, torch.Tensor]:
    """The metrics of the JAX package's ``eval_step``: the losses and
    ``match_inlier_rate``, the share of (visibility-weighted) selected
    matches within ``2 * base_sigma`` of some visible true point in their
    view."""
    _, metrics = frontend_loss(out, batch, config)
    proj = batch.projected_points
    vis = batch.visibility_mask.to(proj.dtype)
    d2 = torch.sum(torch.square(out.matches[:, :, :, None, :] - proj[:, :, None, :, :]), dim=-1)  # (B, M, Nsel, N)
    d2 = torch.where(vis[:, :, None, :] > 0, d2, float("inf"))
    near = torch.sqrt(torch.amin(d2, dim=-1))
    mvis = out.match_visibility.to(proj.dtype)
    tol = 2.0 * config.render.base_sigma
    metrics["match_inlier_rate"] = torch.sum((near < tol).to(proj.dtype) * mvis) / torch.clamp(
        torch.sum(mvis), min=1.0
    )
    return metrics
