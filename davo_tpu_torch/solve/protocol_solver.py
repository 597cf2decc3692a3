"""The gen-1 protocol solver: BFGS over optimisable-function objects (the
port of ``davo_tpu/solve/protocol_solver.py``).

The object's flat ``(B, E, P)`` parameter vector is optimised by
:func:`davo_tpu_torch.solve.bfgs_solve` with the object's analytic
``get_error_and_gradient`` as the value-and-gradient hook (no autograd in
the loop).  The solve is an eval solve, so its Hessian block is kernel K1
on the flattened ``(B E, P)`` batch, as every eval solve of the port.
"""

from __future__ import annotations

import dataclasses

from .bfgs import BFGSConfig, bfgs_solve

__all__ = ["BFGSCameraSolverConfig", "bfgs_solve_function"]


@dataclasses.dataclass(frozen=True)
class BFGSCameraSolverConfig:
    """The reference ``BFGSCameraSolver``'s knobs."""

    max_iterations: int = 10
    epsilon: float = 1e-6
    max_step_distance: float = 1e5
    min_step_distance: float = 1e-8
    sufficient_decrease: float = 1e-4
    curvature: float = 0.9
    line_search_max_step: float = 1e5
    line_search_zoom_iterations: int = 20
    strong: bool = True


def bfgs_solve_function(function, config: BFGSCameraSolverConfig = BFGSCameraSolverConfig(), direction_fn=None):
    """Batched BFGS with the strong-Wolfe search over a
    :class:`davo_tpu_torch.camera.IOptimisableFunction` (parameters ``(B,
    E, P)``); ``direction_fn`` is an optional ``(direction, params, error,
    step_idx) -> direction`` modifier.  Returns the object at the
    optimised parameters."""
    base_vector = function.as_parameters_vector()

    def error_fn(vec):
        return function.add(vec - base_vector).get_error()

    def value_and_grad_fn(vec):
        return function.add(vec - base_vector).get_error_and_gradient()

    solver = BFGSConfig(
        sufficient_decrease=config.sufficient_decrease,
        curvature=config.curvature,
        error_threshold=config.epsilon,
        iterations=config.max_iterations,
        minimum_step=0.0,
        drop_path_p=0.0,
        line_search_iterations=config.line_search_zoom_iterations + 32,
        max_step_size=config.line_search_max_step,
        zoom_method="interpolate",
        strong=config.strong,
        max_step_distance=config.max_step_distance,
        min_step_distance=config.min_step_distance,
    )
    solved = bfgs_solve(error_fn, base_vector, solver, value_and_grad_fn=value_and_grad_fn, direction_fn=direction_fn)
    return function.add(solved - base_vector)
