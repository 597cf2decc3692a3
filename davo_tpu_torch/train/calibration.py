"""Training and evaluation of the calibration network (the port of
``davo_tpu/train/calibration.py``).

:class:`CalibrationExperiment` is the JAX experiment's configuration.
:func:`create_train_state` builds the network (flax-style initial weights
from the experiment's seed), an AdamW optimiser with one group of every
parameter, and the learning-rate schedule; :func:`make_train_step` returns
the step that draws a batch, runs the training forward (the unrolled
differentiable solve, or the winner-take-all tokens), and applies optax's
``chain(clip_by_global_norm(clip_norm), adamw(schedule, weight_decay))``:
the clipping is written out (optax scales by ``max_norm / norm`` only
where ``norm >= max_norm``), the schedule is read at the count before the
update (the first update has learning rate 0 under the warm-up), and the
weight decay reaches every parameter, biases and norms too, by
``lr * wd * p`` (eps 1e-8, no eps inside the root).  :func:`fit` runs
epochs of train and validation steps with checkpoints in the JAX
package's pickle format and resumes from them; :func:`fit_fov_curriculum`
runs narrow-to-wide field-of-view stages under one schedule.

:func:`make_eval_step` draws a batch of scenes, solves it and returns the
JAX package's metric names (``loss``, ``mean_error``,
``focal_length_loss``, ``cx_loss``, ``cy_loss`` and, with structure
supervision, ``structure_loss``); :func:`evaluate_calibration_ate` solves
batches and scores the recovered camera trajectories by their
similarity-aligned ATE and the intrinsics by their absolute errors.

Random draws are ``torch.Generator``s seeded from the experiment's seed
along integer key paths (:func:`batch_generator`): ``(seed, 1000 + i)``
for the i-th batch of the ``eval`` entry, ``(seed, 7, i)`` for the i-th
ATE batch, ``(seed, epoch, 0, i)`` and ``(seed, epoch, 1, j)`` for the
i-th train and j-th validation batch of a global epoch (so a resumed run
sees an uninterrupted run's batches without replaying a key stream), and
``(seed,)`` for the initial weights.  The port therefore draws other
scenes than ``jax.random`` and matches the JAX figures statistically, not
bit for bit.  The eval restart noise is the network's fixed default draw,
as the JAX eval draws it from ``key(0)`` when no ``restarts`` key is given.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from davo_tpu_torch.camera import BasinScoreConfig, unpack_calibration_parameters
from davo_tpu_torch.data import SceneConfig, VOWindowConfig, generate_batch, generate_vo_window_batch
from davo_tpu_torch.models.calibration_network import CalibrationNetwork
from davo_tpu_torch.models.convert import flax_to_state_dict, load_flax_weights, state_dict_to_flax
from davo_tpu_torch.solve import BFGSConfig, LBFGSConfig
from davo_tpu_torch.types import CameraViewsAndPoints
from davo_tpu_torch.utils.device import resolve_device

from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
from .evaluation import absolute_trajectory_error, camera_centers_from_poses

__all__ = [
    "CalibrationExperiment",
    "TrainState",
    "batch_generator",
    "clip_by_global_norm_",
    "create_train_state",
    "evaluate_calibration_ate",
    "fit",
    "fit_fov_curriculum",
    "learning_rate_schedule",
    "make_eval_step",
    "make_train_step",
    "restore_train_state",
    "train_state_tree",
]


@dataclasses.dataclass(frozen=True)
class CalibrationExperiment:
    """The oracle-match calibration experiment.  Defaults are the JAX
    experiment's (``camera_calibration_from_oracle_matches.py:34-75`` in
    the reference): 4 views x 8 points, hidden 8 M N, batch 64, 128 train
    batches and 16 validation batches an epoch, 50 epochs, AdamW at 1e-4
    with weight decay 0.01 and clipping at global norm 1, a linear warm-up
    over 500 steps then a cosine decay to a tenth, structure supervision
    weight 1; the solver's eval budget is strong Wolfe BFGS with 100
    iterations, 50 probes and error threshold 1e-7, its training budget
    10 unrolled iterations and threshold 1e-3."""

    num_views: int = 4
    num_points: int = 8
    hidden_size: int = -1  # <= 0: 8 * M * N
    batch_size: int = 64
    batches_per_epoch: int = 128
    val_batches: int = 16
    epochs: int = 50
    learning_rate: float = 1e-4
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    # "warmup_cosine" or "constant"
    schedule: str = "warmup_cosine"
    warmup_steps: int = 500
    structure_weight: float = 1.0
    # eval: multi-start solves (training always solves one start)
    num_restarts: int = 1
    restart_noise: float = 0.1
    # "noise", "permutation", "input_noise" or "tokens"
    restart_proposals: str = "noise"
    # "error" or "basin"
    selection: str = "error"
    # the basin score's pull towards the guess head's focal
    basin_anchor_weight: float = 0.0
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
    solver: Union[BFGSConfig, LBFGSConfig] = BFGSConfig(
        error_threshold=1e-7,
        training_error_threshold=1e-3,
        iterations=100,
        training_iterations=10,
        line_search_iterations=50,
    )

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

    def build_network(
        self, device: Optional[Union[str, torch.device]] = None, generator: Optional[torch.Generator] = None
    ) -> CalibrationNetwork:
        """The experiment's network on ``device``; ``generator`` (a CPU
        generator) draws its flax-style initial weights."""
        return CalibrationNetwork(
            num_views=self.num_views,
            num_points=self.num_points,
            hidden_size=self.resolved_hidden(),
            solver=self.solver,
            num_restarts=self.num_restarts,
            restart_noise=self.restart_noise,
            restart_proposals=self.restart_proposals,
            selection=self.selection,
            basin=BasinScoreConfig(anchor_weight=self.basin_anchor_weight),
            head=self.head,
            transformer_layers=self.transformer_layers,
            transformer_heads=self.transformer_heads,
            guess_tokens=self.guess_tokens,
            device=device,
            dtype=self.dtype,
            generator=generator,
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


def _loss_and_metrics(
    network: CalibrationNetwork,
    batch: CameraViewsAndPoints,
    structure_weight: float = 0.0,
    *,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
    keep_masks: Optional[torch.Tensor] = None,
):
    """The loss and metrics of one batch through the network's eval or
    training forward (the training one keeps the graph and moves the
    BatchNorm running statistics)."""
    predictions, error = network(
        batch.projected_points, batch.visibility_mask, training=training, generator=generator,
        keep_masks=keep_masks, return_error=True,
    )
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


# ------------------------------------------------------------ training ----


def learning_rate_schedule(
    learning_rate: float, total_steps: int, warmup_steps: int, kind: str = "warmup_cosine"
) -> Callable[[int], float]:
    """The learning rate of update ``count`` (0 for the first update):
    optax's ``warmup_cosine_decay_schedule(0, lr, warmup, total, 0.1 lr)``
    over ``max(total_steps, 2)`` updates (a linear warm-up over
    ``min(warmup_steps, total // 2)``, then a cosine decay to a tenth), or
    the constant rate (``kind="constant"``)."""
    if kind == "constant":
        return lambda count: learning_rate
    if kind != "warmup_cosine":
        raise ValueError(f"Unknown schedule: {kind!r}")
    total = max(total_steps, 2)
    warmup = min(warmup_steps, total // 2)
    decay = max(total, warmup + 1) - warmup
    peak, end = learning_rate, 0.1 * learning_rate
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            return (0.0 - peak) * (1.0 - min(max(count, 0), warmup) / warmup) + peak
        cosine = 0.5 * (1.0 + math.cos(math.pi * min(count - warmup, decay) / decay))
        return peak * ((1.0 - alpha) * cosine + alpha)

    return schedule


@torch.no_grad()
def clip_by_global_norm_(gradients: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's ``clip_by_global_norm``, in place: where the global norm is
    at least ``max_norm``, every gradient becomes ``g / norm * max_norm``
    (without a host synchronisation).  Returns the norm before clipping."""
    norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in gradients))
    keep = norm < max_norm
    for g in gradients:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    """The network, its AdamW optimiser (one group of every parameter),
    the learning-rate schedule and the count of updates applied (the
    calibration network's and, with its front end, the front end
    trainer's)."""

    network: torch.nn.Module
    optimizer: torch.optim.AdamW
    schedule: Callable[[int], float]
    clip_norm: float
    step: int = 0

    @classmethod
    def adamw(
        cls, network: torch.nn.Module, *, learning_rate: float, weight_decay: float, clip_norm: float,
        total_steps: int, warmup_steps: int, schedule: str = "warmup_cosine",
    ) -> "TrainState":
        """``network`` with optax's ``chain(clip_by_global_norm(clip_norm),
        adamw(schedule, weight_decay))``: AdamW over one group of every
        parameter and :func:`learning_rate_schedule`."""
        optimizer = torch.optim.AdamW(
            network.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay
        )
        return cls(network, optimizer, learning_rate_schedule(learning_rate, total_steps, warmup_steps, schedule),
                   clip_norm)

    def apply_gradients(self, gradients: List[torch.Tensor]) -> None:
        """Clip, then one AdamW update at the schedule's rate for the
        current count."""
        clip_by_global_norm_(gradients, self.clip_norm)
        for param, gradient in zip(self.network.parameters(), gradients):
            param.grad = gradient
        for group in self.optimizer.param_groups:
            group["lr"] = self.schedule(self.step)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1


def create_train_state(
    config: CalibrationExperiment,
    device: Optional[Union[str, torch.device]] = None,
    generator: Optional[torch.Generator] = None,
) -> TrainState:
    """The experiment's network with flax-style initial weights (drawn by
    ``generator``, a CPU generator; by default the key path ``(seed,)``),
    and its optimiser and schedule."""
    if generator is None:
        generator = batch_generator("cpu", config.seed)
    return TrainState.adamw(
        config.build_network(device, generator=generator), learning_rate=config.learning_rate,
        weight_decay=config.weight_decay, clip_norm=config.clip_norm,
        total_steps=config.epochs * config.batches_per_epoch, warmup_steps=config.warmup_steps,
        schedule=config.schedule,
    )


def make_train_step(state: TrainState, config: CalibrationExperiment):
    """``train_step(generator, keep_masks=None) -> metrics``: draw
    ``config.batch_size`` scenes with ``generator``, run the training
    forward (its drop-path keep-masks drawn next from the same generator,
    or ``keep_masks``), differentiate the loss and apply one optimiser
    update to ``state``.  The JAX package's ``make_train_step(network,
    config)`` returns a pure ``(state, key) -> (state, metrics)``; here
    the state is updated in place."""
    network = state.network
    batch_fn = config.make_batch_fn(next(network.parameters()).device)
    params = list(network.parameters())

    def train_step(generator: torch.Generator, keep_masks: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        batch = batch_fn(generator, config.batch_size)
        loss, metrics = _loss_and_metrics(
            network, batch, config.structure_weight, training=True, generator=generator, keep_masks=keep_masks
        )
        gradients = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the loss does not reach has gradient 0, as under jax.grad
        gradients = [torch.zeros_like(p) if g is None else g for p, g in zip(params, gradients)]
        state.apply_gradients(gradients)
        return {name: value.detach() for name, value in metrics.items()}

    return train_step


def _num_heads(network: CalibrationNetwork) -> Optional[int]:
    return network.initial_estimator.layers[0].attn.num_heads if network.head == "transformer" else None


def train_state_tree(state: TrainState) -> dict:
    """The state as the JAX package's checkpoint holds it, in numpy:
    flax-named ``params`` and ``batch_stats``, ``opt_state`` (the Adam
    moments ``mu``, ``nu`` as flax-named trees and their ``count``) and
    ``step``."""
    network, heads = state.network, _num_heads(state.network)
    params, batch_stats = state_dict_to_flax(network.state_dict(), num_heads=heads)
    moments = {}
    for key in ("exp_avg", "exp_avg_sq"):
        named = {
            name: state.optimizer.state.get(p, {}).get(key, torch.zeros_like(p))
            for name, p in network.named_parameters()
        }
        moments[key] = state_dict_to_flax(named, num_heads=heads)[0]
    opt_state = {"count": state.step, "mu": moments["exp_avg"], "nu": moments["exp_avg_sq"]}
    return {"params": params, "batch_stats": batch_stats, "opt_state": opt_state, "step": state.step}


def restore_train_state(state: TrainState, tree: dict) -> None:
    """Load a :func:`train_state_tree` into ``state``, in place."""
    network = state.network
    load_flax_weights(network, tree["params"], tree.get("batch_stats"))
    opt_state = tree["opt_state"]
    mu, nu = flax_to_state_dict(opt_state["mu"]), flax_to_state_dict(opt_state["nu"])
    saved = state.optimizer.state_dict()
    saved["state"] = {
        i: {"step": torch.tensor(float(opt_state["count"])), "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, (name, _) in enumerate(network.named_parameters())
    }
    state.optimizer.load_state_dict(saved)
    state.step = int(tree["step"])


def _mean_metrics(metrics: List[Dict[str, torch.Tensor]]) -> Dict[str, float]:
    return {k: float(torch.mean(torch.stack([m[k] for m in metrics]))) for k in metrics[0]}


def fit(
    config: CalibrationExperiment,
    *,
    epochs: Optional[int] = None,
    log_fn: Optional[Callable[[str, int, Dict[str, float]], None]] = None,
    initial_state: Optional[TrainState] = None,
    epoch_offset: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 25,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[TrainState, Dict[str, list]]:
    """Train the calibration network; returns the final state and the
    history of per-epoch mean metrics (``train``, ``val``).

    ``initial_state`` continues a state (a curriculum stage); its schedule
    continues from its update count.  ``epoch_offset`` shifts the epochs
    passed to ``log_fn``, the data's key paths and the checkpoint steps,
    which are global epochs.  With ``checkpoint_dir`` the whole state is
    saved every ``checkpoint_every`` epochs and at the end, and a fresh
    ``fit`` pointed at the directory resumes from its latest checkpoint.
    """
    device = resolve_device(device)
    state = initial_state if initial_state is not None else create_train_state(config, device)
    num_epochs = epochs if epochs is not None else config.epochs
    start_epoch = 0
    if checkpoint_dir is not None and initial_state is None:
        resume_epoch = latest_step(checkpoint_dir)
        if resume_epoch is not None and resume_epoch - epoch_offset < 0:
            resume_epoch = None  # saved by an earlier curriculum stage
        if resume_epoch is not None:
            if resume_epoch - epoch_offset > num_epochs:
                raise ValueError(
                    f"checkpoint at global epoch {resume_epoch} is beyond this stage "
                    f"(epoch_offset={epoch_offset}, epochs={num_epochs}); use fit_fov_curriculum's "
                    "cross-stage resume or restore manually"
                )
            restore_train_state(state, restore_checkpoint(checkpoint_dir, resume_epoch))
            start_epoch = resume_epoch - epoch_offset
    train_step = make_train_step(state, config)
    eval_step = make_eval_step(state.network, config)

    history: Dict[str, list] = {"train": [], "val": []}
    for epoch in range(start_epoch, num_epochs):
        global_epoch = epoch + epoch_offset
        start = time.time()
        train_metrics = [
            train_step(batch_generator(device, config.seed, global_epoch, 0, i))
            for i in range(config.batches_per_epoch)
        ]
        train_avg = _mean_metrics(train_metrics)
        val_avg = _mean_metrics(
            [eval_step(batch_generator(device, config.seed, global_epoch, 1, j)) for j in range(config.val_batches)]
        )
        train_avg["epoch_seconds"] = time.time() - start
        history["train"].append(train_avg)
        history["val"].append(val_avg)
        if log_fn is not None:
            log_fn("train", global_epoch, train_avg)
            log_fn("val", global_epoch, val_avg)
        if checkpoint_dir is not None and ((epoch + 1) % checkpoint_every == 0 or epoch + 1 == num_epochs):
            save_checkpoint(checkpoint_dir, global_epoch + 1, train_state_tree(state))
    return state, history


def fit_fov_curriculum(
    config: CalibrationExperiment,
    stages: Tuple[Tuple[float, float, Optional[int]], ...] = (
        (50.0, 80.0, None),
        (35.0, 105.0, None),
        (30.0, 120.0, None),
    ),
    *,
    log_fn: Optional[Callable[[str, int, Dict[str, float]], None]] = None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 25,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[TrainState, Dict[str, list]]:
    """Train with a narrow-to-wide field-of-view curriculum.

    Each stage is ``(fov_min_deg, fov_max_deg, epochs)``; ``None`` epochs
    split ``config.epochs`` evenly among such stages.  One optimiser and
    one schedule (built from ``config.epochs``) span the run; only the
    scene distribution changes a stage.  With ``checkpoint_dir`` a
    restarted run skips the stages its checkpoint covers (checkpoint steps
    are global epochs) and resumes the interrupted stage from it.
    """
    remaining = config.epochs - sum(e for _, _, e in stages if e)
    flexible = [i for i, (_, _, e) in enumerate(stages) if not e]
    per_flex = max(remaining // max(len(flexible), 1), 0)
    resolved_epochs = []
    for i, (_, _, stage_epochs) in enumerate(stages):
        if stage_epochs is None:
            stage_epochs = per_flex + (remaining - per_flex * len(flexible) if i == flexible[-1] else 0)
        resolved_epochs.append(stage_epochs)

    resume_global = latest_step(checkpoint_dir) if checkpoint_dir is not None else None
    state = None
    history: Dict[str, list] = {"train": [], "val": []}
    offset = 0
    for i, (lo, hi, _) in enumerate(stages):
        stage_epochs = resolved_epochs[i]
        if resume_global is not None and resume_global >= offset + stage_epochs and i < len(stages) - 1:
            # covered by the checkpoint: the next stage run restores it (the
            # last stage is never skipped; with no epochs left it restores
            # and returns the final state)
            offset += stage_epochs
            continue
        scene = dataclasses.replace(config.resolved_scene(), fov_min_degrees=lo, fov_max_degrees=hi)
        state, h = fit(
            dataclasses.replace(config, scene=scene),
            epochs=stage_epochs,
            log_fn=log_fn,
            initial_state=state,
            epoch_offset=offset,
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
            device=device,
        )
        history["train"].extend(h["train"])
        history["val"].extend(h["val"])
        offset += stage_epochs
    return state, history
