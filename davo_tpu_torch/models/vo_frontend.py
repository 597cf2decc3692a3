"""Visual front end: images -> fixed-N matched coordinates (the port of
``davo_tpu/models/vo_frontend.py``, window path).

A conv feature detector runs on every view of a keyframe window, the
attention matcher regresses each of the anchor view's features into every
other view (kernel K3, one call over the ``(M - 1)`` target views folded
into the batch), optional eval-time gates verify the regressed matches,
and the anchor's ``N`` best features are selected.  The output has the
``(B, M, N, 2)`` observation schema the calibration solve consumes, so
learned matches replace oracle matches.

The gates, each off at 0 as in the JAX module: the matcher's peak
attention weight (confidence), snapping to the nearest detection, cycle
consistency (a second K3 call with the roles swapped), the detection
score threshold, the selection's quality bonus, the soft-gate floor
(failed gates keep a weight instead of being dropped) and centroid
refinement of the detections.

In training (``training=True``, as the JAX module's argument; the
module's own mode is not read) the detector normalises with the batch
statistics and moves its BatchNorm running statistics as flax does, the
matcher takes its plain softmax route (K3 is forward-only) with
attention dropout when ``dropout > 0``, and the graph is kept;
everything after the matcher is as in eval.  The eval forward runs
without a graph.

Sequential tracking (``track_sequence``, ``_track_sequence_impl``) and
``frontend_detect`` are not ported yet (``ROADMAP.md`` Queue 1 item 10):
no command of either package reaches them; ``vo-eval`` takes the
forward's ``points`` and ``sigmoid(scores)`` as its detections.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
from torch import nn

from davo_tpu_torch.types import FeaturePoints
from davo_tpu_torch.utils.device import resolve_device
from davo_tpu_torch.utils.precision import full_f32_matmuls

from .detector import FeatureDetectionModule, refine_points_centroid
from .matcher import FeatureMatchModule

__all__ = ["FrontendOutput", "VOFrontend", "select_matches"]


class FrontendOutput(NamedTuple):
    """Everything the losses and the solver need.

    * ``points``: ``(B, M, K, 2)`` all detected feature coordinates.
    * ``scores``: ``(B, M, K)`` detection-confidence logits.
    * ``matched``: ``(B, M, K, 2)`` for each of the anchor view's K
      features, its regressed coordinates in view m (view 0: the
      anchor's own coordinates).
    * ``matches``: ``(B, M, N, 2)`` the selected subset — the
      solver-facing observations.
    * ``match_visibility``: ``(B, M, N)`` in-bounds (and gated) flags of
      ``matches``; float weights when the soft-gate floor is on.
    * ``confidence``: ``(B, M, K)`` peak attention weight per anchor
      feature and view (view 0 = 1), or None when that gate is off.
    """

    points: torch.Tensor
    scores: torch.Tensor
    matched: torch.Tensor
    matches: torch.Tensor
    match_visibility: torch.Tensor
    confidence: Optional[torch.Tensor] = None


def select_matches(
    matched: torch.Tensor,
    anchor_scores: torch.Tensor,
    num_select: int,
    nms_radius: float = 0.0,
):
    """Top-``num_select`` anchor features by score, with in-bounds flags.

    With ``nms_radius > 0`` the selection is greedy non-maximum
    suppression in the anchor view: after each pick, every feature within
    the radius of the picked coordinate is suppressed.

    :param matched: ``(B, M, K, 2)`` per-view coordinates of the anchor's
        K features (view 0 = the anchor's own coordinates).
    :param anchor_scores: ``(B, K)``.
    :return: ``(matches (B, M, N, 2), visibility (B, M, N), idx (B, N))``.
    """
    if nms_radius <= 0.0:
        idx = torch.topk(anchor_scores, num_select, dim=-1, sorted=True).indices  # (B, N)
    else:
        anchor_pts = matched[:, 0]  # (B, K, 2)
        scores = anchor_scores
        picks = []
        for _ in range(num_select):
            i = torch.argmax(scores, dim=-1)  # (B,)
            picks.append(i)
            pos = torch.take_along_dim(anchor_pts, i[:, None, None], dim=1)  # (B, 1, 2)
            d2 = torch.sum(torch.square(anchor_pts - pos), dim=-1)  # (B, K)
            scores = torch.where(d2 < nms_radius**2, float("-inf"), scores)
        idx = torch.stack(picks, dim=-1)
    matches = torch.take_along_dim(matched, idx[:, None, :, None], dim=2)  # (B, M, N, 2)
    visibility = (torch.abs(matches[..., 0]) < 1.0) & (torch.abs(matches[..., 1]) < 1.0)
    return matches, visibility, idx


class VOFrontend(nn.Module):
    """Detector + attention matcher over a keyframe window.

    :param num_select: N — matches handed to the solver per window.
    :param descriptor_channels: detector descriptor width.
    :param embedding_size: matcher key/query projection width.
    :param dropout: the matcher's attention dropout in training.
    :param image_channels: channels of the rendered views.
    :param device: where the module lives — the card unless the caller
        asks for another.

    The gate parameters are the JAX module's; each is off at 0.
    """

    def __init__(
        self,
        num_select: int = 8,
        descriptor_channels: int = 64,
        embedding_size: int = 64,
        dropout: float = 0.0,
        match_confidence_threshold: float = 0.0,
        nms_radius: float = 0.0,
        snap_radius: float = 0.0,
        cycle_threshold: float = 0.0,
        quality_bonus: float = 0.0,
        score_threshold: float = 0.0,
        centroid_refine_iters: int = 0,
        centroid_radius_px: int = 4,
        soft_gate_floor: float = 0.0,
        image_channels: int = 3,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        device = resolve_device(device)
        if device.type == "cuda":
            full_f32_matmuls()  # TF32 off for the convolutions and projections
        self.num_select = num_select
        self.descriptor_channels = descriptor_channels
        self.match_confidence_threshold = match_confidence_threshold
        self.nms_radius = nms_radius
        self.snap_radius = snap_radius
        self.cycle_threshold = cycle_threshold
        self.quality_bonus = quality_bonus
        self.score_threshold = score_threshold
        self.centroid_refine_iters = centroid_refine_iters
        self.centroid_radius_px = centroid_radius_px
        self.soft_gate_floor = soft_gate_floor
        self.detector = FeatureDetectionModule(image_channels, descriptor_channels)
        self.matcher = FeatureMatchModule(descriptor_channels, embedding_size, dropout)
        self.to(device=device, dtype=dtype)
        self.eval()  # not read: the forward's ``training`` selects the route

    def forward(
        self,
        images: torch.Tensor,
        *,
        training: bool = False,
        track_sequence: bool = False,
        generator: Optional[torch.Generator] = None,
        dropout_mask: Optional[torch.Tensor] = None,
    ) -> FrontendOutput:
        """:param images: ``(B, M, H, W, C)`` window views.
        :param training: the training forward (the module docstring).
        :param generator: draws the matcher's dropout keep masks in training.
        :param dropout_mask: ``(B * (M - 1), K, K)`` boolean keep mask of the
            anchor-to-view matcher call instead of the generator's draw.
        :return: :class:`FrontendOutput`."""
        if track_sequence:
            raise NotImplementedError("sequential tracking is not ported yet (ROADMAP.md Queue 1 item 10)")
        if training:
            with torch.enable_grad():
                return self._forward(images, True, generator, dropout_mask)
        with torch.no_grad():
            return self._forward(images, False, None, None)

    def _forward(self, images, training, generator, dropout_mask):
        b, m, h, w, c = images.shape
        feats = self.detector(images.reshape(b * m, h, w, c), training=training)
        k = feats.points.shape[1]
        flat_points = feats.points
        if self.centroid_refine_iters > 0:
            flat_points = refine_points_centroid(
                images.reshape(b * m, h, w, c),
                flat_points,
                iters=self.centroid_refine_iters,
                radius_px=self.centroid_radius_px,
            )
        points = flat_points.reshape(b, m, k, 2)
        descriptors = feats.descriptors.reshape(b, m, k, -1)
        scores = feats.scores.reshape(b, m, k)
        d = descriptors.shape[-1]

        # one matcher call over all (M - 1) target views: the anchor's
        # features are tiled across the view axis folded into the batch
        anchor = FeaturePoints(
            points=points[:, 0:1].expand(b, m - 1, k, 2).reshape(b * (m - 1), k, 2),
            descriptors=descriptors[:, 0:1].expand(b, m - 1, k, d).reshape(b * (m - 1), k, d),
        )
        target = FeaturePoints(
            points=points[:, 1:].reshape(b * (m - 1), k, 2),
            descriptors=descriptors[:, 1:].reshape(b * (m - 1), k, d),
        )
        gate = self.match_confidence_threshold > 0.0
        matched_out = self.matcher(
            anchor, target, training=training, return_confidence=gate, generator=generator, dropout_mask=dropout_mask
        )
        confidence = None
        if gate:
            matched_out, conf_rest = matched_out
            confidence = torch.cat(
                [torch.ones(b, 1, k, dtype=conf_rest.dtype, device=conf_rest.device),
                 conf_rest.reshape(b, m - 1, k)],
                dim=1,
            )
        matched = torch.cat([points[:, 0:1], matched_out.points_b.reshape(b, m - 1, k, 2)], dim=1)

        # --- eval-time verification of the solver-facing matches ---------
        solver_matched = matched
        extra_valid = torch.ones(b, m, k, dtype=torch.bool, device=images.device)
        if self.snap_radius > 0.0 or self.cycle_threshold > 0.0:
            # regressed coordinate against every detection, per view
            d2 = torch.sum(torch.square(matched[:, :, :, None, :] - points[:, :, None, :, :]), dim=-1)
            snap_idx = torch.argmin(d2, dim=-1)  # (B, M, K)
            snap_dist = torch.sqrt(torch.amin(d2, dim=-1) + 1e-12)
        if self.snap_radius > 0.0:
            snapped = torch.take_along_dim(points, snap_idx[..., None], dim=2)
            near = snap_dist < self.snap_radius
            solver_matched = torch.where(near[..., None], snapped, matched)
            extra_valid = extra_valid & near
        if self.cycle_threshold > 0.0:
            # roles swapped: a second K3 call (in training, the plain route)
            rev_out = self.matcher(target, anchor, training=training, generator=generator)
            rev = torch.cat([points[:, 0:1], rev_out.points_b.reshape(b, m - 1, k, 2)], dim=1)
            rev_at_match = torch.take_along_dim(rev, snap_idx[..., None], dim=2)
            cycle_err = torch.sqrt(torch.sum(torch.square(rev_at_match - points[:, 0:1]), dim=-1) + 1e-12)
            extra_valid = extra_valid & (cycle_err < self.cycle_threshold)

        if self.score_threshold > 0.0:
            prob = torch.sigmoid(scores)
            # the anchor track must be a real detection (broadcast over M)
            extra_valid = extra_valid & (prob[:, 0:1] > self.score_threshold)
            if self.snap_radius > 0.0:
                snapped_prob = torch.take_along_dim(prob, snap_idx, dim=2)
                extra_valid = extra_valid & (snapped_prob > self.score_threshold)

        sel_scores = scores[:, 0]
        if self.quality_bonus > 0.0:
            valid_frac = torch.mean(extra_valid.to(sel_scores.dtype), dim=1)  # (B, K)
            sel_scores = sel_scores + self.quality_bonus * valid_frac

        matches, visibility, idx = select_matches(
            solver_matched, sel_scores, self.num_select, nms_radius=self.nms_radius
        )
        gates_ok = torch.take_along_dim(extra_valid, idx[:, None, :], dim=2)
        if gate:
            conf_sel = torch.take_along_dim(confidence, idx[:, None, :], dim=2)
            gates_ok = gates_ok & (conf_sel > self.match_confidence_threshold)
        if self.soft_gate_floor > 0.0:
            floor = torch.tensor(self.soft_gate_floor, dtype=matches.dtype, device=matches.device)
            visibility = visibility.to(matches.dtype) * torch.where(gates_ok, 1.0, floor)
        else:
            visibility = visibility & gates_ok
        return FrontendOutput(
            points=points,
            scores=scores,
            matched=matched,
            matches=matches,
            match_visibility=visibility,
            confidence=confidence,
        )
