"""Learned solvers: networks that replace the BFGS update rule (the port of
``davo_tpu/models/learned_solvers.py``).

Each step mimics one BFGS iteration: a network picks a search direction
from the normalised parameters and the error, the objective is probed at
the candidate, and a second network picks a step scale (a GELU gate that
can switch the step off).  The solvers take a flat ``(B, E, P)``
parameter tensor and a batched ``error_fn`` ``(B, E, P) -> (B, E)``, so
any objective plugs in.  :class:`SearchDirectionHeuristic` instead gates
the components of a BFGS search direction, as the solver's
``direction_fn`` hook.

Layers follow flax's conventions (:mod:`davo_tpu_torch.models.calibration_network`:
tanh GELU, flax BatchNorm statistics and momentum, LayerNorm epsilon
1e-6), and module names are the flax modules' (``solver_step``,
``search_direction_dense_1``, ...), so
:func:`davo_tpu_torch.models.convert.learned_solver_state_dict` carries the
JAX package's weights across.  In training a recurrent MLP solver moves
its BatchNorm statistics once a step, in order, as flax does.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F
from torch import nn

from davo_tpu_torch.utils.device import resolve_device

from .calibration_network import _EncoderBlock, _FlaxBatchNorm, _gelu, flax_style_init_

__all__ = [
    "MLPSolverStep",
    "MLPSolver",
    "TransformerSolverStep",
    "TransformerSolver",
    "SearchDirectionHeuristic",
]

ErrorFn = Callable[[torch.Tensor], torch.Tensor]


def _normalise(params: torch.Tensor, dim: int = -1):
    """Standardise along ``dim`` (the population std, floored at 1e-8)."""
    mean = torch.mean(params, dim=dim, keepdim=True)
    std = torch.clamp(torch.std(params, dim=dim, keepdim=True, correction=0), min=1e-8)
    return (params - mean) / std, mean, std


def _error_features(error: torch.Tensor) -> torch.Tensor:
    """Bounded error features ``[log1p(e), 1 / (1 + e)]``."""
    safe = torch.clamp(error, min=0.0)
    return torch.cat([torch.log1p(safe), 1.0 / (1.0 + safe)], dim=-1)


class MLPSolverStep(nn.Module):
    """One learned solver iteration (reference ``MLPSolverStep``)."""

    def __init__(self, num_parameters: int, search_direction_hidden: int, line_search_hidden: int):
        super().__init__()
        p = num_parameters
        for prefix, inputs, hidden, outputs in (
            ("search_direction", p + 2, search_direction_hidden, p),
            ("line_search", 2 * p + 4, line_search_hidden, 1),
        ):
            self.add_module(f"{prefix}_dense_1", nn.Linear(inputs, hidden))
            self.add_module(f"{prefix}_norm_1", _FlaxBatchNorm(hidden))
            self.add_module(f"{prefix}_dense_2", nn.Linear(hidden, hidden))
            self.add_module(f"{prefix}_norm_2", _FlaxBatchNorm(hidden))
            self.add_module(f"{prefix}_head", nn.Linear(hidden, outputs))

    def _mlp(self, x: torch.Tensor, prefix: str, training: bool) -> torch.Tensor:
        layer = lambda name: getattr(self, f"{prefix}_{name}")  # noqa: E731
        x = layer("norm_1")(_gelu(layer("dense_1")(x)), training)
        x = layer("norm_2")(_gelu(layer("dense_2")(x)), training)
        return layer("head")(x)

    def forward(self, parameters: torch.Tensor, error_fn: ErrorFn, training: bool = False) -> torch.Tensor:
        """``(B, E, P) -> (B, E, P)``."""
        normed, _, std = _normalise(parameters)
        inputs = torch.cat([normed, _error_features(error_fn(parameters)[..., None])], dim=-1)
        # the direction at the parameters' scale
        direction = self._mlp(inputs, "search_direction", training) * std
        candidate = parameters + direction
        cand_normed, _, _ = _normalise(candidate)
        line_inputs = torch.cat([inputs, cand_normed, _error_features(error_fn(candidate)[..., None])], dim=-1)
        scale = _gelu(self._mlp(line_inputs, "line_search", training))  # the gate can switch the step off
        return parameters + scale * direction


class MLPSolver(nn.Module):
    """``num_steps`` learned steps; ``recurrent=True`` shares one set of
    weights (and BatchNorm statistics) across them."""

    def __init__(
        self,
        num_steps: int,
        num_parameters: int,
        search_direction_hidden: int,
        line_search_hidden: int,
        recurrent: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_steps, self.recurrent = num_steps, recurrent
        self._step_names = _step_names(recurrent, num_steps)
        _register_steps(self, recurrent, num_steps, lambda: MLPSolverStep(
            num_parameters, search_direction_hidden, line_search_hidden))
        _finish(self, generator, device, dtype)

    def forward(
        self, parameters: torch.Tensor, error_fn: ErrorFn, training: bool = False, return_trajectory: bool = False
    ) -> torch.Tensor:
        """``(B, E, P)`` after the last step, or with ``return_trajectory``
        every step's ``(num_steps, B, E, P)``."""
        trajectory = []
        for name in self._step_names:
            parameters = getattr(self, name)(parameters, error_fn, training)
            trajectory.append(parameters)
        return torch.stack(trajectory) if return_trajectory else parameters


class TransformerSolverStep(nn.Module):
    """One transformer solver iteration over the estimates: the E parallel
    estimates and the history of past (parameters, error) rows form the
    sequence, which grows by E rows a step."""

    def __init__(
        self,
        num_parameters: int,
        embed_dim: int,
        num_heads: int = 4,
        search_direction_layers: int = 2,
        line_search_layers: int = 2,
    ):
        super().__init__()
        self.layers = {"search_direction": search_direction_layers, "line_search": line_search_layers}
        for prefix, layers in self.layers.items():
            self.add_module(f"{prefix}_embed", nn.Linear(num_parameters + 2, embed_dim))
            for i in range(layers):
                self.add_module(f"{prefix}_block_{i}", _EncoderBlock(embed_dim, num_heads))
        self.direction_head = nn.Linear(embed_dim, num_parameters)
        self.scale_head = nn.Linear(embed_dim, 1)

    def _encode(self, rows: torch.Tensor, prefix: str) -> torch.Tensor:
        x = getattr(self, f"{prefix}_embed")(rows)
        for i in range(self.layers[prefix]):
            x = getattr(self, f"{prefix}_block_{i}")(x)
        return x

    def forward(self, parameters: torch.Tensor, error_fn: ErrorFn, history: Optional[torch.Tensor] = None):
        """:param parameters: ``(B, E, P)``.
        :param history: ``(B, S E, P + 2)`` accumulated rows or ``None``.
        :return: ``(new_parameters, new_history)``."""
        num_estimates = parameters.shape[-2]
        normed, _, std = _normalise(parameters)
        rows = torch.cat([normed, _error_features(error_fn(parameters)[..., None])], dim=-1)
        sequence = rows if history is None else torch.cat([rows, history], dim=-2)
        direction_tokens = self._encode(sequence, "search_direction")
        direction = self.direction_head(direction_tokens[..., :num_estimates, :]) * std
        candidate = parameters + direction
        cand_normed, _, _ = _normalise(candidate)
        cand_rows = torch.cat([cand_normed, _error_features(error_fn(candidate)[..., None])], dim=-1)
        line_tokens = self._encode(torch.cat([cand_rows, sequence], dim=-2), "line_search")
        scale = _gelu(self.scale_head(line_tokens[..., :num_estimates, :]))
        return parameters + scale * direction, sequence


class TransformerSolver(nn.Module):
    """Fixed-step transformer solver with a growing estimate history."""

    def __init__(
        self,
        num_steps: int,
        num_parameters: int,
        embed_dim: int,
        num_heads: int = 4,
        search_direction_layers: int = 2,
        line_search_layers: int = 2,
        recurrent: bool = False,
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.num_steps, self.recurrent = num_steps, recurrent
        self._step_names = _step_names(recurrent, num_steps)
        _register_steps(self, recurrent, num_steps, lambda: TransformerSolverStep(
            num_parameters, embed_dim, num_heads, search_direction_layers, line_search_layers))
        _finish(self, generator, device, dtype)

    def forward(
        self, parameters: torch.Tensor, error_fn: ErrorFn, training: bool = False, return_trajectory: bool = False
    ) -> torch.Tensor:
        history, trajectory = None, []
        for name in self._step_names:
            parameters, history = getattr(self, name)(parameters, error_fn, history)
            trajectory.append(parameters)
        return torch.stack(trajectory) if return_trajectory else parameters


class SearchDirectionHeuristic(nn.Module):
    """Sigmoid gates on the search direction's components, given the
    direction and the step number (reference
    ``search_direction_heuristic.py``); plugs into
    :func:`davo_tpu_torch.solve.bfgs_solve` as ``direction_fn``.  Hidden
    ``3 P`` unless ``hidden_size > 0``."""

    def __init__(
        self,
        num_parameters: int,
        hidden_size: int = -1,
        *,
        generator: Optional[torch.Generator] = None,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        hidden = hidden_size if hidden_size > 0 else 3 * num_parameters
        self.dense_1 = nn.Linear(num_parameters + 1, hidden)
        self.norm = _FlaxBatchNorm(hidden)
        self.dense_2 = nn.Linear(hidden, num_parameters)
        _finish(self, generator, device, dtype)

    def forward(
        self, search_direction: torch.Tensor, step_number: Union[int, torch.Tensor], training: bool = False
    ) -> torch.Tensor:
        step = torch.as_tensor(step_number, dtype=search_direction.dtype, device=search_direction.device)
        step = step.expand(search_direction.shape[:-1] + (1,))
        x = torch.cat([search_direction, step], dim=-1)
        x = self.norm(F.relu(self.dense_1(x)), training)
        return search_direction * torch.sigmoid(self.dense_2(x))


def _step_names(recurrent: bool, num_steps: int) -> list:
    """Flax's names of each step's module, in order: one shared
    ``solver_step``, or ``solver_step_i``."""
    return ["solver_step"] * num_steps if recurrent else [f"solver_step_{i}" for i in range(num_steps)]


def _register_steps(module: nn.Module, recurrent: bool, num_steps: int, make_step) -> None:
    for name in dict.fromkeys(_step_names(recurrent, num_steps)):
        module.add_module(name, make_step())


def _finish(module: nn.Module, generator, device, dtype) -> None:
    """flax-style initial weights (``generator``, a CPU generator), then
    the module to ``device`` and ``dtype``."""
    flax_style_init_(module, generator)
    module.to(device=resolve_device(device), dtype=dtype)
