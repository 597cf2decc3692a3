"""Fixed-iteration gradient descent (the port of ``davo_tpu/solve/sgd.py``)
with the differentiability contract of
:func:`davo_tpu_torch.solve.bfgs_solve`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from .bfgs import _value_and_grad_batched, _value_and_grad_with_graph

__all__ = ["SGDConfig", "sgd_solve"]


@dataclasses.dataclass(frozen=True)
class SGDConfig:
    learning_rate: float = 1e-2
    iterations: int = 100


def sgd_solve(
    error_function: Callable[[torch.Tensor], torch.Tensor],
    parameters: torch.Tensor,
    config: SGDConfig = SGDConfig(),
    *,
    differentiable: bool = False,
) -> torch.Tensor:
    """``x <- x - lr * f'(x)`` for ``config.iterations`` steps, each
    element of the batch on its own error.

    :param differentiable: keep the graph through the unroll (the gradient
        of each step is itself differentiable); otherwise the result
        carries no gradient.
    """
    if differentiable:
        params = parameters
        for _ in range(config.iterations):
            _, gradient = _value_and_grad_with_graph(error_function, params)
            params = params - config.learning_rate * gradient
        return params
    with torch.no_grad():
        params = parameters.detach()
        for _ in range(config.iterations):
            _, gradient = _value_and_grad_batched(error_function, params)
            params = params - config.learning_rate * gradient
        return params
