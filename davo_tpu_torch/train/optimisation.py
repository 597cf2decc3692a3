"""Training of the gen-1 guess(-and-solver) models (the port of
``davo_tpu/train/optimisation.py``).

The loss is the mean squared error of the focal length and of the
principal point plus the mean BA error of the solved model; with E
estimates the intrinsics losses take each scene's lowest-error estimate.
The optimiser is optax's ``chain(clip_by_global_norm, adamw)`` at a
constant rate (:class:`~davo_tpu_torch.train.calibration.TrainState`).
The solve is the differentiable unroll on the analytic gradient (the
``bfgs_solver_*`` presets), or none (``mlp_guess``).

Random draws follow the port's key paths: the initial weights from
``(seed,)`` and the i-th train batch of epoch e from ``(seed, e, 0, i)``,
as the calibration trainer's, so the figures match the JAX package's
statistically; the tests inject the JAX package's scenes.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import torch

from davo_tpu_torch.camera import PinholeBAConfig
from davo_tpu_torch.data import SceneConfig, generate_batch
from davo_tpu_torch.models.guess import PinholeMLPGuess
from davo_tpu_torch.models.guess_and_solver import GuessAndSolverModel, InitialGuessModel
from davo_tpu_torch.models.calibration_network import flax_style_init_
from davo_tpu_torch.solve import BFGSConfig
from davo_tpu_torch.types import CameraViewsAndPoints
from davo_tpu_torch.utils.device import resolve_device

from .calibration import TrainState, batch_generator

__all__ = [
    "OptimisationExperiment",
    "create_optimisation_state",
    "make_optimisation_train_step",
    "fit_optimisation",
]


@dataclasses.dataclass(frozen=True)
class OptimisationExperiment:
    """A gen-1 experiment (the reference's YAML presets)."""

    num_views: int = 4
    num_points: int = 8
    hidden_size: int = -1
    batch_size: int = 64
    batches_per_epoch: int = 128
    epochs: int = 50
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    seed: int = 0
    dtype: torch.dtype = torch.float32
    ba: PinholeBAConfig = PinholeBAConfig(constrain=True)
    solver: BFGSConfig = BFGSConfig(
        error_threshold=1e-6,
        iterations=10,
        drop_path_p=0.0,
        line_search_iterations=40,
        max_step_size=1e5,
    )
    solver_enabled: bool = True  # False: the guess alone (mlp_guess)

    def resolved_scene(self) -> SceneConfig:
        return SceneConfig(num_views=self.num_views, num_points=self.num_points, dtype=self.dtype)

    def build_model(
        self, device: Optional[Union[str, torch.device]] = None, generator: Optional[torch.Generator] = None
    ) -> torch.nn.Module:
        """The MLP guess, with the solver unless ``solver_enabled`` is off,
        on ``device`` with flax-style weights drawn by ``generator``."""
        guess = PinholeMLPGuess(self.num_views, self.num_points, self.hidden_size)
        if self.solver_enabled:
            model = GuessAndSolverModel(guess, ba_config=self.ba, solver=self.solver)
        else:
            model = InitialGuessModel(guess, ba_config=self.ba)
        flax_style_init_(model, generator)
        return model.to(device=resolve_device(device), dtype=self.dtype)


def create_optimisation_state(
    config: OptimisationExperiment,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
) -> TrainState:
    """The model (weights drawn by ``generator``, by default from the key
    path ``(seed,)``) and its optimiser."""
    if generator is None:
        generator = batch_generator("cpu", config.seed)
    return TrainState.adamw(
        config.build_model(device, generator), learning_rate=config.learning_rate,
        weight_decay=config.weight_decay, clip_norm=config.clip_norm,
        total_steps=config.epochs * config.batches_per_epoch, warmup_steps=0, schedule="constant",
    )


def _loss_and_metrics(model, batch: CameraViewsAndPoints, generator: Optional[torch.Generator]):
    solved, error = model(batch.projected_points, batch.visibility_mask, training=True, return_error=True,
                          generator=generator)
    best = torch.argmin(error, dim=-1)

    def take(x):
        return torch.take_along_dim(x, best[:, None], dim=1)[:, 0]

    true = batch.camera_intrinsics
    f_loss = torch.mean(torch.square(take(solved.focal_length) - true[:, 0]))
    cx_loss = torch.mean(torch.square(take(solved.cx) - true[:, 1]))
    cy_loss = torch.mean(torch.square(take(solved.cy) - true[:, 2]))
    mean_error = torch.mean(error)
    loss = f_loss + cx_loss + cy_loss + mean_error
    metrics = {"loss": loss, "mean_error": mean_error, "focal_length_loss": f_loss, "cx_loss": cx_loss,
               "cy_loss": cy_loss}
    return loss, metrics


def make_optimisation_train_step(state: TrainState, config: OptimisationExperiment):
    """``train_step(generator=None, batch=None) -> metrics``: draw
    ``config.batch_size`` scenes with ``generator`` (or take ``batch``),
    run the training forward (the guess's BatchNorm on the batch
    statistics, moving its running statistics; the unrolled solve, whose
    drop-path keep-masks, where the solver has any, come next from the
    same generator), differentiate the loss and update ``state`` in
    place."""
    model = state.network
    params = list(model.parameters())
    scene = config.resolved_scene()

    def train_step(
        generator: Optional[torch.Generator] = None, batch: Optional[CameraViewsAndPoints] = None
    ) -> Dict[str, torch.Tensor]:
        if batch is None:
            batch = generate_batch(generator, config.batch_size, scene, device=params[0].device)
        loss, metrics = _loss_and_metrics(model, batch, generator)
        gradients = torch.autograd.grad(loss, params, allow_unused=True)
        gradients = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gradients)]
        state.apply_gradients(gradients)
        return {name: value.detach() for name, value in metrics.items()}

    return train_step


def fit_optimisation(
    config: OptimisationExperiment,
    *,
    epochs: Optional[int] = None,
    log_fn: Optional[Callable[[str, int, Dict[str, float]], None]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[TrainState, Dict[str, List[dict]]]:
    """Train a gen-1 model; returns the state and the per-epoch mean
    metrics (``train``)."""
    device = resolve_device(device)
    state = create_optimisation_state(config, device)
    train_step = make_optimisation_train_step(state, config)
    history: Dict[str, List[dict]] = {"train": []}
    for epoch in range(config.epochs if epochs is None else epochs):
        start = time.time()
        metrics = [train_step(batch_generator(device, config.seed, epoch, 0, i))
                   for i in range(config.batches_per_epoch)]
        avg = {k: float(torch.mean(torch.stack([m[k] for m in metrics]))) for k in metrics[0]}
        avg["epoch_seconds"] = time.time() - start
        history["train"].append(avg)
        if log_fn is not None:
            log_fn("train", epoch, avg)
    return state, history
