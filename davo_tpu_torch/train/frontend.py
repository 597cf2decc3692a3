"""The visual front end's training and evaluation (the port of
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

Training: :func:`create_frontend_state` builds the front end with
flax-style initial weights and the calibration trainer's optimiser
pieces (:class:`~davo_tpu_torch.train.calibration.TrainState`: optax's
``chain(clip_by_global_norm(clip_norm), adamw(schedule, weight_decay))``
with the warm-up/cosine schedule to a tenth of the peak);
:func:`make_frontend_train_step` returns the train step (windows
generated and rendered on the device, the training forward, whose
BatchNorm moves its running statistics, ``frontend_loss``, its backward
and one AdamW update; no kernel runs, as in the JAX package, where the
training matcher is the plain softmax) and the eval step (the eval
forward through kernel K3, the losses and ``match_inlier_rate``);
:func:`fit_frontend` runs epochs of both.  Batches are drawn by
``torch.Generator``s on the key paths ``(seed, epoch, 0, i)`` (train) and
``(seed, epoch, 1, j)`` (validation), and the initial weights by
``(seed,)``, so the port's draws are not ``jax.random``'s: the curves
compare statistically.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from davo_tpu_torch.data.rendering import (
    RenderConfig,
    appearance_from_noise,
    draw_appearance_noise,
    draw_frame_noise,
    render_frame,
)
from davo_tpu_torch.data.vo_windows import VOWindowConfig, generate_vo_window_batch
from davo_tpu_torch.models.calibration_network import flax_style_init_
from davo_tpu_torch.models.convert import frontend_state_to_flax
from davo_tpu_torch.models.vo_frontend import FrontendOutput, VOFrontend
from davo_tpu_torch.types import CameraViewsAndPoints
from davo_tpu_torch.utils.device import resolve_device

from .calibration import TrainState, _mean_metrics, batch_generator
from .checkpoint import save_checkpoint

__all__ = [
    "FrontendExperiment",
    "create_frontend_state",
    "draw_render_noise",
    "fit_frontend",
    "make_frontend_train_step",
    "render_scene_batch",
    "save_frontend_checkpoint",
    "frontend_loss",
    "frontend_eval_metrics",
]


@dataclasses.dataclass(frozen=True)
class FrontendExperiment:
    """Front-end training experiment (the JAX package's fields and
    defaults).  ``image_size`` is kept for parity; the rendered size is
    ``render.image_size``, onto which ``fit-frontend --image-size`` maps."""

    num_views: int = 4
    num_points: int = 8
    num_select: int = 8
    image_size: int = 64
    descriptor_channels: int = 64
    embedding_size: int = 64
    batch_size: int = 16
    batches_per_epoch: int = 64
    val_batches: int = 8
    epochs: int = 30
    learning_rate: float = 3e-4
    weight_decay: float = 1e-5
    clip_norm: float = 10.0
    warmup_steps: int = 200
    detection_weight: float = 1.0
    score_weight: float = 0.2
    match_weight: float = 1.0
    seed: int = 0
    window: VOWindowConfig = VOWindowConfig()
    render: RenderConfig = RenderConfig()

    def build_network(self, device: Optional[Union[str, torch.device]] = None, **options) -> VOFrontend:
        """The experiment's front end in ``render.dtype``; ``options`` are
        :class:`VOFrontend` keywords (the gates, ``dropout``)."""
        return VOFrontend(
            num_select=self.num_select,
            descriptor_channels=self.descriptor_channels,
            embedding_size=self.embedding_size,
            image_channels=self.render.channels,
            device=device,
            dtype=self.render.dtype,
            **options,
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


# ------------------------------------------------------------ training ----


def _window_config(config: FrontendExperiment) -> VOWindowConfig:
    return dataclasses.replace(config.window, num_views=config.num_views, num_points=config.num_points)


def create_frontend_state(
    config: FrontendExperiment,
    device: Optional[Union[str, torch.device]] = None,
    **options,
) -> TrainState:
    """The experiment's front end with flax-style initial weights (drawn on
    the CPU on the key path ``(seed,)``), with AdamW (one group of every
    parameter) and the warm-up/cosine schedule over ``epochs *
    batches_per_epoch`` updates.  ``options`` go to
    :meth:`FrontendExperiment.build_network`.  The front end's forward
    takes ``training=`` (the train step passes it), as the JAX module's
    does; the module's own mode is not read."""
    network = config.build_network(device, **options)
    flax_style_init_(network, batch_generator("cpu", config.seed))
    return TrainState.adamw(
        network, learning_rate=config.learning_rate, weight_decay=config.weight_decay, clip_norm=config.clip_norm,
        total_steps=config.epochs * config.batches_per_epoch, warmup_steps=config.warmup_steps,
    )


def make_frontend_train_step(state: TrainState, config: FrontendExperiment):
    """``(train_step, eval_step)`` of the front end in ``state``.

    ``train_step(generator, *, windows=None, noise=None, dropout_mask=None)
    -> metrics`` draws ``config.batch_size`` windows and their render
    noise with ``generator`` (or takes ``windows`` and ``noise``, the
    draws of :func:`draw_render_noise`), runs the training forward (the
    matcher's dropout mask drawn next from the same generator, or
    ``dropout_mask``), differentiates ``frontend_loss`` and applies one
    update to ``state`` in place (the JAX package's step is a pure
    ``(state, key) -> (state, metrics)``).  ``eval_step(generator, *,
    windows=None, noise=None) -> metrics`` runs the eval forward (K3 on
    the card) and returns :func:`frontend_eval_metrics`."""
    network = state.network
    params = list(network.parameters())
    device = params[0].device
    window_config = _window_config(config)

    def draw(generator, windows, noise):
        if windows is None:
            windows = generate_vo_window_batch(generator, config.batch_size, window_config, device=device)
        return windows, render_scene_batch(generator, windows, config.render, noise=noise)

    def train_step(
        generator: Optional[torch.Generator] = None,
        *,
        windows: Optional[CameraViewsAndPoints] = None,
        noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
        dropout_mask: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        windows, images = draw(generator, windows, noise)
        out = network(images, training=True, generator=generator, dropout_mask=dropout_mask)
        loss, metrics = frontend_loss(out, windows, config)
        gradients = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not reach has gradient 0, as under jax.grad
        gradients = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gradients)]
        state.apply_gradients(gradients)
        return {name: value.detach() for name, value in metrics.items()}

    def eval_step(
        generator: Optional[torch.Generator] = None,
        *,
        windows: Optional[CameraViewsAndPoints] = None,
        noise: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    ) -> Dict[str, torch.Tensor]:
        windows, images = draw(generator, windows, noise)
        return frontend_eval_metrics(network(images, training=False), windows, config)

    return train_step, eval_step


def fit_frontend(
    config: FrontendExperiment,
    *,
    log_fn: Optional[Callable[[str, int, Dict[str, float]], None]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[TrainState, Dict[str, List[Dict[str, float]]]]:
    """Train a fresh :func:`create_frontend_state` for ``config.epochs``
    epochs; returns the state and the per-epoch means (``train`` with
    ``epoch_seconds``, the train steps' time; ``val`` with
    ``match_inlier_rate``), each passed to ``log_fn``."""
    device = resolve_device(device)
    state = create_frontend_state(config, device)
    train_step, eval_step = make_frontend_train_step(state, config)
    history: Dict[str, list] = {"train": [], "val": []}
    for epoch in range(config.epochs):
        start = time.time()
        train_metrics = _mean_metrics(
            [train_step(batch_generator(device, config.seed, epoch, 0, i)) for i in range(config.batches_per_epoch)]
        )
        train_metrics["epoch_seconds"] = time.time() - start
        history["train"].append(train_metrics)
        if log_fn is not None:
            log_fn("train", epoch, train_metrics)
        if config.val_batches > 0:
            val_metrics = _mean_metrics(
                [eval_step(batch_generator(device, config.seed, epoch, 1, j)) for j in range(config.val_batches)]
            )
            history["val"].append(val_metrics)
            if log_fn is not None:
                log_fn("val", epoch, val_metrics)
    return state, history


def save_frontend_checkpoint(directory: str, step: int, network: VOFrontend, config: FrontendExperiment) -> str:
    """What ``fit-frontend`` saves: ``{"params", "batch_stats"}`` (flax-named)
    as ``checkpoint_<step>.pkl`` in the JAX package's pickle format, and
    ``frontend_config.json`` with the architecture and the rendered size
    (:func:`davo_tpu_torch.models.load_frontend` reads the directory).
    Returns the checkpoint's path."""
    params, batch_stats = frontend_state_to_flax(network.state_dict())
    path = save_checkpoint(directory, step, {"params": params, "batch_stats": batch_stats})
    arch = {
        "num_select": config.num_select,
        "descriptor_channels": config.descriptor_channels,
        "embedding_size": config.embedding_size,
        "image_size": config.render.image_size,
    }
    with open(os.path.join(directory, "frontend_config.json"), "w") as f:
        json.dump(arch, f)
    return path
