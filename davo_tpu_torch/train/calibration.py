"""Evaluation of the calibration network: the eval half of
``davo_tpu/train/calibration.py``.

:class:`CalibrationExperiment` holds the fields of the JAX experiment
that evaluation reads; :func:`make_eval_step` draws a batch of scenes,
solves it and returns the JAX package's metric names (``loss``,
``mean_error``, ``focal_length_loss``, ``cx_loss``, ``cy_loss`` and, with
structure supervision, ``structure_loss``); :func:`evaluate_calibration_ate`
solves batches and scores the recovered camera trajectories by their
similarity-aligned ATE and the intrinsics by their absolute errors.

Random draws are ``torch.Generator``s seeded from the experiment's seed
along the JAX package's key paths (``(seed, 1000 + i)`` for the i-th eval
batch, ``(seed, 7, i)`` for the i-th ATE batch), so the port draws other
scenes than ``jax.random`` and matches the JAX figures statistically, not
bit for bit.  The restart noise is the network's fixed default draw, as
the JAX eval draws it from ``key(0)`` when no ``restarts`` key is given.

The training half (``make_train_step``, ``fit``, ``fit_fov_curriculum``
and the optimiser chain) waits for the training slice (``ROADMAP.md``,
Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from davo_tpu_torch.camera import unpack_calibration_parameters
from davo_tpu_torch.data import SceneConfig, VOWindowConfig, generate_batch, generate_vo_window_batch
from davo_tpu_torch.models.calibration_network import CalibrationNetwork
from davo_tpu_torch.solve import BFGSConfig
from davo_tpu_torch.types import CameraViewsAndPoints
from davo_tpu_torch.utils.device import resolve_device

from .evaluation import absolute_trajectory_error, camera_centers_from_poses

__all__ = [
    "CalibrationExperiment",
    "batch_generator",
    "make_eval_step",
    "evaluate_calibration_ate",
]

_REMAINDER = "ROADMAP.md Queue 1 item 1 (basin selection and the permutation/tokens proposals)"


@dataclasses.dataclass(frozen=True)
class CalibrationExperiment:
    """The oracle-match calibration experiment, as far as evaluation reads
    it.  Defaults are the JAX experiment's (4 views x 8 points, hidden
    8 M N, batch 64, structure supervision weight 1, the eval solver of
    strong Wolfe BFGS with 100 iterations, 50 probes and error threshold
    1e-7)."""

    num_views: int = 4
    num_points: int = 8
    hidden_size: int = -1  # <= 0: 8 * M * N
    batch_size: int = 64
    structure_weight: float = 1.0
    num_restarts: int = 1
    restart_noise: float = 0.1
    # "noise" only: "permutation", "tokens" and "input_noise" are still to port
    restart_proposals: str = "noise"
    # "error" only: "basin" (and its focal anchor weight) is still to port
    selection: str = "error"
    head: str = "mlp"
    transformer_layers: int = 3
    transformer_heads: int = 4
    guess_tokens: int = 1
    # "scenes" or "vo_windows"
    data_source: str = "scenes"
    pixel_noise: float = 0.0
    visibility_dropout: float = 0.0
    outlier_fraction: float = 0.0
    seed: int = 0
    dtype: torch.dtype = torch.float32
    scene: Optional[SceneConfig] = None
    solver: BFGSConfig = BFGSConfig(error_threshold=1e-7, iterations=100, line_search_iterations=50)

    def resolved_scene(self) -> SceneConfig:
        if self.scene is not None:
            return self.scene
        return SceneConfig(
            num_views=self.num_views, num_points=self.num_points, pixel_noise=self.pixel_noise, dtype=self.dtype
        )

    def resolved_hidden(self) -> int:
        return self.hidden_size if self.hidden_size > 0 else 8 * self.num_views * self.num_points

    def make_batch_fn(
        self, device: Optional[Union[str, torch.device]] = None
    ) -> Callable[[torch.Generator, int], CameraViewsAndPoints]:
        """``(generator, batch_size) -> CameraViewsAndPoints`` on ``device``
        for the configured scene distribution."""
        device = resolve_device(device)
        if self.data_source == "scenes":
            scene = self.resolved_scene()
            return lambda generator, batch_size: generate_batch(generator, batch_size, scene, device=device)
        if self.data_source == "vo_windows":
            window = VOWindowConfig(
                num_views=self.num_views, num_points=self.num_points, pixel_noise=self.pixel_noise,
                visibility_dropout=self.visibility_dropout, outlier_fraction=self.outlier_fraction,
                dtype=self.dtype,
            )
            return lambda generator, batch_size: generate_vo_window_batch(
                generator, batch_size, window, device=device
            )
        raise ValueError(f"Unknown data_source: {self.data_source!r}")

    def build_network(self, device: Optional[Union[str, torch.device]] = None) -> CalibrationNetwork:
        if self.restart_proposals != "noise":
            raise NotImplementedError(
                f"restart_proposals={self.restart_proposals!r} is not ported yet: {_REMAINDER}"
            )
        if self.selection != "error":
            raise NotImplementedError(f"selection={self.selection!r} is not ported yet: {_REMAINDER}")
        if self.guess_tokens > 1:
            raise NotImplementedError(f"guess_tokens > 1 is not ported yet: {_REMAINDER}")
        return CalibrationNetwork(
            num_views=self.num_views,
            num_points=self.num_points,
            hidden_size=self.resolved_hidden(),
            solver=self.solver,
            num_restarts=self.num_restarts,
            restart_noise=self.restart_noise,
            head=self.head,
            transformer_layers=self.transformer_layers,
            transformer_heads=self.transformer_heads,
            device=device,
            dtype=self.dtype,
        )


def batch_generator(device: Union[str, torch.device], *path: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer key path ``path``
    (``numpy.random.SeedSequence``: distinct paths give unrelated streams)."""
    seed = int(np.random.SeedSequence(list(path)).generate_state(1, dtype=np.uint64)[0] >> 1)
    return torch.Generator(device).manual_seed(seed)


def _structure_targets(batch: CameraViewsAndPoints):
    """Gauge-normalised ground-truth structure: the representative of the
    true solution's gauge orbit with mean |coordinate| 1 over points and
    camera centres (the normalisation the objective applies)."""
    wp = batch.world_points  # (B, N, 3)
    tr = batch.camera_translations  # (B, M-1, 3)
    n, m = wp.shape[1], tr.shape[1] + 1
    points_scale = torch.mean(torch.abs(wp), dim=(-1, -2))
    camera_scale = torch.mean(torch.abs(tr), dim=(-1, -2))
    scale = torch.clamp((points_scale * n + camera_scale * m) / (n + m), min=1e-6)[:, None, None]
    return wp / scale, tr / scale


def _winner_take_all_loss(network, predictions, error, batch, structure_weight):
    """Per-element min-over-tokens supervised loss of ``(B, E, P)`` token
    guesses with ``(B, E)`` objective values: each element is scored by its
    best token; the metrics are the single-guess names at the winning
    token plus the token-usage entropy."""
    b, e, _ = predictions.shape
    unpacked = unpack_calibration_parameters(predictions, network.num_views, network.num_points)
    pred_intrinsics = unpacked.intrinsics.reshape(b, e, 3)
    pred_focal = F.elu(pred_intrinsics[..., 0]) + 1.0
    true_intrinsics = batch.camera_intrinsics[:, None, :]
    focal_se = torch.square(pred_focal - true_intrinsics[..., 0])
    cx_se = torch.square(pred_intrinsics[..., 1] - true_intrinsics[..., 1])
    cy_se = torch.square(pred_intrinsics[..., 2] - true_intrinsics[..., 2])
    total = focal_se + cx_se + cy_se + error
    components = {"focal_length_loss": focal_se, "cx_loss": cx_se, "cy_loss": cy_se, "mean_error": error}
    if structure_weight > 0.0:
        true_points, true_trans = _structure_targets(batch)
        structure_se = (
            torch.mean(torch.square(unpacked.world_points[:, :, 0] - true_points[:, None]), dim=(-1, -2))
            + torch.mean(torch.square(unpacked.camera_translations[:, :, :, 0] - true_trans[:, None]), dim=(-1, -2))
            + torch.mean(
                torch.square(unpacked.camera_rotations[:, :, :, 0] - batch.camera_orientations[:, None]), dim=(-1, -2)
            )
        )
        total = total + structure_weight * structure_se
        components["structure_loss"] = structure_se
    best = torch.argmin(total, dim=-1)

    def pick(x):
        return torch.take_along_dim(x, best[:, None], dim=1)[:, 0]

    loss = torch.mean(pick(total))
    metrics = {name: torch.mean(pick(v)) for name, v in components.items()}
    metrics["loss"] = loss
    usage = torch.mean(F.one_hot(best, e).to(total.dtype), dim=0)
    metrics["token_usage_entropy"] = -torch.sum(usage * torch.log(torch.clamp(usage, min=1e-12)))
    return loss, metrics


def _loss_and_metrics(network: CalibrationNetwork, batch: CameraViewsAndPoints, structure_weight: float = 0.0):
    """The eval-mode loss and metrics of one solved batch."""
    predictions, error = network(batch.projected_points, batch.visibility_mask, return_error=True)
    if predictions.ndim == 3:
        return _winner_take_all_loss(network, predictions, error, batch, structure_weight)
    unpacked = unpack_calibration_parameters(predictions, network.num_views, network.num_points)
    pred_intrinsics = unpacked.intrinsics.reshape(predictions.shape[0], 3)
    pred_focal = F.elu(pred_intrinsics[:, 0]) + 1.0
    true_intrinsics = batch.camera_intrinsics
    focal_loss = torch.mean(torch.square(pred_focal - true_intrinsics[:, 0]))
    cx_loss = torch.mean(torch.square(pred_intrinsics[:, 1] - true_intrinsics[:, 1]))
    cy_loss = torch.mean(torch.square(pred_intrinsics[:, 2] - true_intrinsics[:, 2]))
    mean_error = torch.mean(error)
    loss = focal_loss + cx_loss + cy_loss + mean_error
    metrics = {
        "loss": loss,
        "mean_error": mean_error,
        "focal_length_loss": focal_loss,
        "cx_loss": cx_loss,
        "cy_loss": cy_loss,
    }
    if structure_weight > 0.0:
        true_points, true_trans = _structure_targets(batch)
        structure_loss = (
            torch.mean(torch.square(unpacked.world_points[:, 0] - true_points))
            + torch.mean(torch.square(unpacked.camera_translations[:, :, 0] - true_trans))
            + torch.mean(torch.square(unpacked.camera_rotations[:, :, 0] - batch.camera_orientations))
        )
        loss = loss + structure_weight * structure_loss
        metrics["structure_loss"] = structure_loss
        metrics["loss"] = loss
    return loss, metrics


def make_eval_step(network: CalibrationNetwork, config: CalibrationExperiment):
    """``eval_step(generator) -> metrics``: draw ``config.batch_size``
    scenes with ``generator``, solve them and score them."""
    batch_fn = config.make_batch_fn(next(network.parameters()).device)

    def eval_step(generator: torch.Generator) -> Dict[str, torch.Tensor]:
        batch = batch_fn(generator, config.batch_size)
        _, metrics = _loss_and_metrics(network, batch, config.structure_weight)
        return metrics

    return eval_step


def evaluate_calibration_ate(
    network: CalibrationNetwork, config: CalibrationExperiment, seed: int, batches: int = 4
) -> Dict[str, float]:
    """Accuracy of the solved scenes against ground truth over ``batches``
    batches drawn along the key path ``(seed, 7, i)``: per-scene ATE of the
    recovered camera centres after similarity alignment (the estimate is
    gauge-free), and the absolute focal and principal-point errors."""
    device = next(network.parameters()).device
    batch_fn = config.make_batch_fn(device)
    rmses, f_errs, c_errs = [], [], []
    for i in range(batches):
        batch = batch_fn(batch_generator(device, seed, 7, i), config.batch_size)
        predictions = network(batch.projected_points, batch.visibility_mask)
        unpacked = unpack_calibration_parameters(predictions, network.num_views, network.num_points)
        est_orient = unpacked.camera_rotations[:, :, 0, :]
        est_trans = unpacked.camera_translations[:, :, 0, :]
        zero = torch.zeros_like(est_orient[:, :1])
        est_centres = camera_centers_from_poses(
            torch.cat([zero, est_orient], dim=1), torch.cat([zero, est_trans], dim=1)
        )
        true_centres = camera_centers_from_poses(
            torch.cat([zero, batch.camera_orientations], dim=1), torch.cat([zero, batch.camera_translations], dim=1)
        )
        rmses.append(absolute_trajectory_error(est_centres, true_centres)["rmse"])
        pred_f = F.elu(unpacked.intrinsics[..., 0, 0, 0]) + 1.0
        f_errs.append(torch.abs(pred_f - batch.camera_intrinsics[:, 0]))
        c_errs.append(torch.abs(unpacked.intrinsics[:, 0, 0, 1:] - batch.camera_intrinsics[:, 1:]))
    rmses = torch.cat(rmses)
    return {
        "ate_rmse_mean": float(torch.mean(rmses)),
        "ate_rmse_median": float(torch.quantile(rmses, 0.5)),
        "f_error_mean": float(torch.mean(torch.cat(f_errs))),
        "centre_error_mean": float(torch.mean(torch.cat(c_errs))),
    }
