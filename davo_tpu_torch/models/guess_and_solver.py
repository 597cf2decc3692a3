"""The gen-1 compositions: guess network -> BA objective -> solver (the
port of ``davo_tpu/models/guess_and_solver.py``).

The solver runs in the flat BA-parameter space on the analytic error and
gradient (:func:`davo_tpu_torch.camera.ba_error_and_gradient` as the
``value_and_grad_fn`` hook: no autograd inside the solve loop, as in the
gen-1 stack).  In training the solve is the differentiable unroll, whose
graph runs through the analytic gradient; in eval it is the eval solve,
kernel K1 on the flattened ``(B E, P)`` batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from davo_tpu_torch.camera.pinhole_ba import (
    PinholeBAConfig,
    PinholeBAData,
    PinholeBAParams,
    ba_error,
    ba_error_and_gradient,
    ba_params_from_vector,
    ba_params_to_vector,
)
from davo_tpu_torch.solve import BFGSConfig, bfgs_solve

__all__ = ["GuessAndSolverModel", "InitialGuessModel", "solve_ba"]


def solve_ba(
    params: PinholeBAParams,
    data: PinholeBAData,
    ba_config: PinholeBAConfig = PinholeBAConfig(),
    solver: BFGSConfig = BFGSConfig(drop_path_p=0.0),
    *,
    training: bool = False,
    generator: Optional[torch.Generator] = None,
    keep_masks: Optional[torch.Tensor] = None,
    direction_fn: Optional[Callable] = None,
) -> PinholeBAParams:
    """Refine BA parameters ``(B, E, ...)`` with batched BFGS and the Wolfe
    search on the analytic gradient."""
    m, n = params.num_views, params.num_points

    def error_fn(vec):
        return ba_error(ba_params_from_vector(vec, m, n), data, ba_config)

    def value_and_grad_fn(vec):
        return ba_error_and_gradient(ba_params_from_vector(vec, m, n), data, ba_config)

    solved = bfgs_solve(
        error_fn, ba_params_to_vector(params), solver, training=training, generator=generator, keep_masks=keep_masks,
        value_and_grad_fn=value_and_grad_fn, direction_fn=direction_fn,
    )
    return ba_params_from_vector(solved, m, n)


def _broadcast_data(projected_points, visibility_mask) -> PinholeBAData:
    """The observations broadcast over the estimates dimension E."""
    return PinholeBAData(projected_points[:, None], visibility_mask[:, None])


class GuessAndSolverModel(nn.Module):
    """``initial_guess`` module -> BA objective -> BFGS solver."""

    def __init__(
        self,
        initial_guess: nn.Module,
        ba_config: PinholeBAConfig = PinholeBAConfig(constrain=True),
        solver: BFGSConfig = BFGSConfig(drop_path_p=0.0),
    ):
        super().__init__()
        self.initial_guess = initial_guess
        self.ba_config = ba_config
        self.solver = solver

    def forward(
        self,
        projected_points: torch.Tensor,
        visibility_mask: torch.Tensor,
        *,
        training: bool = False,
        return_error: bool = False,
        generator: Optional[torch.Generator] = None,
        keep_masks: Optional[torch.Tensor] = None,
    ):
        """:return: the solved :class:`PinholeBAParams` ``(B, E, ...)``, and
        with ``return_error`` their ``(B, E)`` errors.  ``generator`` or
        ``keep_masks`` serve the training solve's drop-path."""
        guess = self.initial_guess(projected_points, visibility_mask, training=training)
        data = _broadcast_data(projected_points, visibility_mask)
        solved = solve_ba(
            guess, data, self.ba_config, self.solver, training=training, generator=generator, keep_masks=keep_masks
        )
        if return_error:
            return solved, ba_error(solved, data, self.ba_config)
        return solved


class InitialGuessModel(nn.Module):
    """The guess alone (the ``mlp_guess`` ablation)."""

    def __init__(self, initial_guess: nn.Module, ba_config: PinholeBAConfig = PinholeBAConfig(constrain=True)):
        super().__init__()
        self.initial_guess = initial_guess
        self.ba_config = ba_config

    def forward(
        self, projected_points, visibility_mask, *, training: bool = False, return_error: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        """As :class:`GuessAndSolverModel`'s; ``generator`` is unused (no
        solve, nothing to draw)."""
        guess = self.initial_guess(projected_points, visibility_mask, training=training)
        if return_error:
            return guess, ba_error(guess, _broadcast_data(projected_points, visibility_mask), self.ba_config)
        return guess
