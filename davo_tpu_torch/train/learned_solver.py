"""Training and evaluation of the learned solvers (the port of
``davo_tpu/train/learned_solver.py``).

A learned solver (:class:`~davo_tpu_torch.models.MLPSolver`,
:class:`~davo_tpu_torch.models.TransformerSolver`) is trained to reduce
the calibration objective from noisy starts ``truth + start_noise *
normal`` around the true scenes, and :func:`compare_with_bfgs` holds it
against BFGS from the same starts at the same number of steps and at four
times as many.  ``solver_type="direction"`` instead trains
:class:`~davo_tpu_torch.models.SearchDirectionHeuristic`, a gate on BFGS's
search direction, inside the real (differentiable, unrolled) BFGS solve.

The objective's gradient is autograd of the plain
:func:`~davo_tpu_torch.camera.calibration_error`, as in the JAX package
(no value-and-gradient hook, so no K2); the BFGS eval solves of
:func:`compare_with_bfgs` take kernel K1 for their Hessian block, as every
eval solve of the port; the training solves are differentiable and take
no kernel.

Random draws follow the port's key paths (:func:`batch_generator`): the
initial weights from ``(seed,)``, the i-th train batch of epoch e from
``(seed, 17 + 100003 e + i)`` and the i-th comparison batch from
``(seed', 900 + i)``, each a batch of scenes followed by the starts'
normal draws.  The figures therefore match the JAX package's
statistically; the tests inject the JAX package's scenes and starts.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from davo_tpu_torch.camera import calibration_error, num_calibration_parameters
from davo_tpu_torch.data import SceneConfig, generate_batch
from davo_tpu_torch.models.convert import flax_tree_from_state_dict, load_flax_tree, load_numpy_checkpoint
from davo_tpu_torch.models.learned_solvers import MLPSolver, SearchDirectionHeuristic, TransformerSolver
from davo_tpu_torch.solve import BFGSConfig, bfgs_solve
from davo_tpu_torch.types import CameraViewsAndPoints
from davo_tpu_torch.utils.device import resolve_device

from .calibration import TrainState, batch_generator

__all__ = [
    "LearnedSolverExperiment",
    "true_calibration_vector",
    "make_problem",
    "draw_problem",
    "create_learned_solver_state",
    "make_learned_solver_step",
    "fit_learned_solver",
    "compare_with_bfgs",
    "learned_solver_checkpoint",
    "load_learned_solver",
]


def true_calibration_vector(batch: CameraViewsAndPoints) -> torch.Tensor:
    """Ground-truth scenes as flat calibration vectors ``(B, P)``; the
    focal slot holds the pre-activation of the ``elu(f) + 1``
    parametrisation (``f - 1`` for ``f >= 1``, ``log f`` below)."""
    intr = batch.camera_intrinsics
    f = intr[:, 0]
    f_param = torch.where(f >= 1.0, f - 1.0, torch.log(torch.clamp(f, min=1e-6)))
    b = intr.shape[0]
    return torch.cat(
        [
            torch.stack([f_param, intr[:, 1], intr[:, 2]], dim=-1),
            batch.world_points.reshape(b, -1),
            batch.camera_translations.reshape(b, -1),
            batch.camera_orientations.reshape(b, -1),
        ],
        dim=-1,
    )


@dataclasses.dataclass(frozen=True)
class LearnedSolverExperiment:
    """A learned solver trained on the calibration objective (the JAX
    experiment's fields and defaults).  ``loss_mode`` "final" is the
    objective after the last step; "descent" the mean over steps of
    ``max(err_t / stop_grad(max(err_{t-1}, 1e-6)), 0.5)`` plus half the
    mean log of the final error.  ``solver_type`` "direction" ignores it
    and trains on the final objective of the gated BFGS solve."""

    solver_type: str = "mlp"  # "mlp" | "transformer" | "direction"
    num_steps: int = 5
    recurrent: bool = True
    loss_mode: str = "final"
    num_views: int = 4
    num_points: int = 8
    hidden_size: int = 256
    embed_dim: int = 128  # transformer
    num_heads: int = 4
    start_noise: float = 0.5
    batch_size: int = 256
    batches_per_epoch: int = 64
    epochs: int = 30
    learning_rate: float = 1e-4
    weight_decay: float = 1e-5
    clip_norm: float = 1.0
    seed: int = 0
    scene: SceneConfig = SceneConfig()

    @property
    def num_parameters(self) -> int:
        return num_calibration_parameters(self.num_views, self.num_points)

    def resolved_scene(self) -> SceneConfig:
        return dataclasses.replace(self.scene, num_views=self.num_views, num_points=self.num_points)

    def build_network(
        self, device: Optional[Union[str, torch.device]] = None, generator: Optional[torch.Generator] = None
    ) -> torch.nn.Module:
        """The experiment's network on ``device`` in the scenes' type, with
        flax-style initial weights drawn by ``generator`` (a CPU one)."""
        common = dict(generator=generator, device=device, dtype=self.scene.dtype)
        if self.solver_type == "direction":
            return SearchDirectionHeuristic(self.num_parameters, self.hidden_size, **common)
        if self.solver_type == "mlp":
            return MLPSolver(
                self.num_steps, self.num_parameters, self.hidden_size, self.hidden_size, self.recurrent, **common
            )
        if self.solver_type == "transformer":
            return TransformerSolver(
                self.num_steps, self.num_parameters, self.embed_dim, self.num_heads, recurrent=self.recurrent,
                **common,
            )
        raise ValueError(f"Unknown solver_type: {self.solver_type!r}")

    def bfgs(self, iterations: int, training: bool = False) -> BFGSConfig:
        """The BFGS of the direction gate's training solve and of the
        comparison: no error threshold, 16 probes a line search."""
        return BFGSConfig(
            iterations=iterations, training_iterations=iterations if training else None, error_threshold=0.0,
            line_search_iterations=16, drop_path_p=0.0,
        )


def make_problem(config: LearnedSolverExperiment, batch: CameraViewsAndPoints, noise: torch.Tensor):
    """``(batch, truth, starts (B, 1, P), error_fn)`` from scenes and the
    starts' standard-normal draws ``(B, P)``."""
    truth = true_calibration_vector(batch)
    starts = truth + config.start_noise * noise.to(truth.dtype)
    visibility = batch.visibility_mask.to(truth.dtype)

    def error_fn(parameters):
        # parameters (B, E, P); the observations broadcast over E
        return calibration_error(parameters, batch.projected_points[:, None], visibility[:, None])

    return batch, truth, starts[:, None, :], error_fn


def draw_problem(config: LearnedSolverExperiment, generator: torch.Generator, device=None):
    """:func:`make_problem` of ``config.batch_size`` scenes and start draws
    from ``generator`` (on ``device``)."""
    device = resolve_device(device)
    batch = generate_batch(generator, config.batch_size, config.resolved_scene(), device=device)
    noise = torch.randn((config.batch_size, config.num_parameters), generator=generator, device=device,
                        dtype=config.scene.dtype)
    return make_problem(config, batch, noise)


def create_learned_solver_state(
    config: LearnedSolverExperiment,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
) -> TrainState:
    """The network (flax-style weights drawn by ``generator``, by default
    from the key path ``(seed,)``) and optax's ``chain(clip_by_global_norm,
    adamw)`` at the constant rate."""
    if generator is None:
        generator = batch_generator("cpu", config.seed)
    return TrainState.adamw(
        config.build_network(device, generator), learning_rate=config.learning_rate,
        weight_decay=config.weight_decay, clip_norm=config.clip_norm,
        total_steps=config.epochs * config.batches_per_epoch, warmup_steps=0, schedule="constant",
    )


def _loss_and_metrics(network, config: LearnedSolverExperiment, problem):
    _, _, starts, error_fn = problem
    if config.solver_type == "direction":
        # the gate trains inside the real BFGS solve on its stored BatchNorm
        # statistics (training=False: they never move); its weights train
        def direction_fn(direction, params, error, step_idx):
            return network(direction, step_idx, training=False)

        flat = starts[:, 0, :]

        def flat_error(q):
            return error_fn(q[:, None, :])[:, 0]

        solved = bfgs_solve(flat_error, flat, config.bfgs(config.num_steps, training=True), training=True,
                            direction_fn=direction_fn)
        final_error = torch.mean(flat_error(solved))
        loss = final_error
        start_error = torch.mean(flat_error(flat))
    else:
        trajectory = network(starts, error_fn, training=True, return_trajectory=True)
        errors = torch.stack([error_fn(step) for step in trajectory])  # (T, B, E)
        final_error = torch.mean(errors[-1])
        start_errors = error_fn(starts)
        start_error = torch.mean(start_errors)
        if config.loss_mode == "descent":
            baseline = torch.clamp(torch.cat([start_errors[None], errors[:-1]]), min=1e-6).detach()
            # each step's ratio clipped at halving (the raw ratio is gameable:
            # blow up err_1, then collect easy relative decreases), plus the
            # log of the final error so the landing point counts
            ratios = torch.clamp(errors / baseline, min=0.5)
            loss = torch.mean(ratios) + 0.5 * torch.mean(torch.log(errors[-1] + 1e-6))
        elif config.loss_mode == "final":
            loss = final_error
        else:
            raise ValueError(f"Unknown loss_mode: {config.loss_mode!r}")
    metrics = {"loss": loss, "final_error": final_error, "start_error": start_error,
               "improvement": start_error - final_error}
    return loss, metrics


def make_learned_solver_step(state: TrainState, config: LearnedSolverExperiment):
    """``train_step(generator=None, problem=None) -> metrics``: draw a
    problem with ``generator`` (or take ``problem``, a
    :func:`make_problem`), run the solver, differentiate the loss and
    apply one optimiser update to ``state`` in place."""
    network = state.network
    params = list(network.parameters())

    def train_step(generator: Optional[torch.Generator] = None, problem=None) -> Dict[str, torch.Tensor]:
        if problem is None:
            problem = draw_problem(config, generator, params[0].device)
        loss, metrics = _loss_and_metrics(network, config, problem)
        gradients = torch.autograd.grad(loss, params, allow_unused=True)
        gradients = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gradients)]
        state.apply_gradients(gradients)
        return {name: value.detach() for name, value in metrics.items()}

    return train_step


def fit_learned_solver(
    config: LearnedSolverExperiment,
    log_fn: Optional[Callable[[str, int, Dict[str, float]], None]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[TrainState, Dict[str, List[dict]]]:
    """Train for ``config.epochs`` epochs of ``batches_per_epoch`` steps;
    returns the state and the per-epoch mean metrics (``train``)."""
    device = resolve_device(device)
    state = create_learned_solver_state(config, device)
    train_step = make_learned_solver_step(state, config)
    history: Dict[str, List[dict]] = {"train": []}
    for epoch in range(config.epochs):
        t0 = time.time()
        metrics = [train_step(batch_generator(device, config.seed, 17 + epoch * 100003 + i))
                   for i in range(config.batches_per_epoch)]
        row = {k: float(torch.mean(torch.stack([m[k] for m in metrics]))) for k in metrics[0]}
        row["epoch_seconds"] = time.time() - t0
        history["train"].append(row)
        if log_fn is not None:
            log_fn("train", epoch, row)
    return state, history


@torch.no_grad()
def compare_with_bfgs(
    network: torch.nn.Module,
    config: LearnedSolverExperiment,
    seed: int,
    batches: int = 8,
    *,
    device: Optional[Union[str, torch.device]] = None,
    problems: Optional[Sequence] = None,
) -> Dict[str, Dict[str, float]]:
    """The learned solver against BFGS at the same number of steps and at
    four times as many, from the same starts: per solver (and for the
    starts) the mean objective, the mean absolute focal error and the
    share of scenes with focal error below 0.1 (the basin rate), averaged
    over ``batches`` batches drawn along ``(seed, 900 + i)``, or over
    ``problems`` (:func:`make_problem` tuples) where given."""
    device = resolve_device(device)
    bfgs_equal = config.bfgs(config.num_steps)
    bfgs_4x = config.bfgs(4 * config.num_steps)
    if problems is None:
        problems = [draw_problem(config, batch_generator(device, seed, 900 + i), device) for i in range(batches)]
    totals: Dict[str, Dict[str, float]] = {}
    for batch, _, starts, error_fn in problems:
        flat = starts[:, 0]

        def flat_error(p):
            return error_fn(p[:, None, :])[:, 0]

        if config.solver_type == "direction":
            learned = bfgs_solve(flat_error, flat, bfgs_equal,
                                 direction_fn=lambda d, p, e, step_idx: network(d, step_idx, training=False))
        else:
            learned = network(starts, error_fn, training=False)[:, 0]
        for name, solved in (
            ("start", flat),
            ("learned", learned),
            ("bfgs_equal_budget", bfgs_solve(flat_error, flat, bfgs_equal)),
            ("bfgs_4x_budget", bfgs_solve(flat_error, flat, bfgs_4x)),
        ):
            f_err = torch.abs(F.elu(solved[:, 0]) + 1.0 - batch.camera_intrinsics[:, 0])
            row = totals.setdefault(name, {"objective": 0.0, "focal_error": 0.0, "basin_rate": 0.0})
            row["objective"] += float(torch.mean(flat_error(solved)))
            row["focal_error"] += float(torch.mean(f_err))
            row["basin_rate"] += float(torch.mean((f_err < 0.1).to(f_err.dtype)))
    return {solver: {k: v / len(problems) for k, v in row.items()} for solver, row in totals.items()}


def learned_solver_checkpoint(network: torch.nn.Module, config: LearnedSolverExperiment) -> dict:
    """The JAX CLI's ``--checkpoint-file`` layout: flax-named numpy
    ``params`` and ``batch_stats`` and the experiment as plain types (the
    scenes' type by name), which ``pickle.load`` reads in either package."""
    num_heads = config.num_heads if config.solver_type == "transformer" else None
    params, batch_stats = flax_tree_from_state_dict(network.state_dict(), num_heads=num_heads)
    fields = dataclasses.asdict(config)
    fields["scene"]["dtype"] = str(config.scene.dtype).replace("torch.", "")
    return {"params": params, "batch_stats": batch_stats, "config": fields}


def load_learned_solver(
    path: str, device: Optional[Union[str, torch.device]] = None, **overrides
) -> Tuple[torch.nn.Module, LearnedSolverExperiment]:
    """The network and experiment of a learned-solver checkpoint (the JAX
    CLI's ``--checkpoint-file`` pickle, such as
    ``artifacts/learned_solver_descent_v2.pkl``, read without JAX, or the
    port's), with ``overrides`` of the experiment's fields."""
    checkpoint = load_numpy_checkpoint(path)
    fields = dict(checkpoint["config"])
    scene = dict(fields.pop("scene"))
    scene["dtype"] = getattr(torch, np.dtype(scene["dtype"]).name)
    config = dataclasses.replace(LearnedSolverExperiment(**fields, scene=SceneConfig(**scene)), **overrides)
    network = config.build_network(device)
    load_flax_tree(network, checkpoint["params"], checkpoint.get("batch_stats"))
    return network, config
