"""Least-squares utilities and a batched Levenberg-Marquardt solver (the
port of ``davo_tpu/solve/least_squares.py``).

``levenberg_marquardt`` carries a damping factor per batch element and
accepts or rejects each element's step with tensor ``where``s, for a fixed
number of iterations: no value goes back to the host inside the loop.
``spd_solve_small`` is the JAX package's unrolled, Jacobi-scaled Cholesky
with two rounds of iterative refinement, kept as written so that the two
packages solve the same small systems with the same arithmetic.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

__all__ = [
    "find_residuals",
    "find_error",
    "find_error_gradient",
    "LMConfig",
    "levenberg_marquardt",
    "spd_solve_small",
]


def spd_solve_small(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve for small P by a column-unrolled Cholesky.

    The system is symmetrically Jacobi-scaled first (unit diagonal), then
    factored column by column, solved by forward and back substitution
    and refined twice against its residual.

    :param a: ``(..., P, P)`` SPD matrices.
    :param b: ``(..., P)`` right-hand sides.
    :return: ``(..., P)`` solutions.
    """
    p = a.shape[-1]
    d = torch.sqrt(torch.clamp(torch.diagonal(a, dim1=-2, dim2=-1), min=1e-30))
    a = a / (d[..., :, None] * d[..., None, :])
    b = b / d
    below = [torch.arange(p, device=a.device) >= j for j in range(p)]
    l_cols = []
    for j in range(p):
        col = a[..., :, j]
        for k in range(j):
            col = col - l_cols[k] * l_cols[k][..., j : j + 1]
        piv = torch.sqrt(torch.clamp(col[..., j : j + 1], min=1e-30))
        col = col / piv
        # zero the upper part so later updates stay consistent
        col = torch.where(below[j], col, torch.zeros_like(col))
        l_cols.append(col)

    def substitute(rhs):
        y = []
        for i in range(p):
            acc = rhs[..., i]
            for k in range(i):
                acc = acc - l_cols[k][..., i] * y[k]
            y.append(acc / l_cols[i][..., i])
        x = [None] * p
        for i in reversed(range(p)):
            acc = y[i]
            for k in range(i + 1, p):
                acc = acc - l_cols[i][..., k] * x[k]
            x[i] = acc / l_cols[i][..., i]
        return torch.stack(x, dim=-1)

    x = substitute(b)
    for _ in range(2):
        resid = b - torch.einsum("...ij,...j->...i", a, x)
        x = x + substitute(resid)
    return x / d


def find_residuals(estimates: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``estimate - target``."""
    return estimates - targets


def find_error(residuals: torch.Tensor, weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Weighted sum of squared residuals over the final axis."""
    sq = torch.square(residuals)
    if weights is not None:
        sq = sq * weights
    return torch.sum(sq, dim=-1)


def find_error_gradient(
    residuals: torch.Tensor, jacobian: torch.Tensor, weights: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``2 r^T J``: the gradient of the squared error with respect to the
    parameters.  ``residuals``: ``(..., R)``, ``jacobian``: ``(..., R, P)``."""
    r = residuals if weights is None else residuals * weights
    return 2.0 * torch.einsum("...r,...rp->...p", r, jacobian)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    iterations: int = 20
    initial_damping: float = 1e-3
    damping_up: float = 10.0
    damping_down: float = 0.1
    min_damping: float = 1e-9
    max_damping: float = 1e9
    error_threshold: float = 0.0


def levenberg_marquardt(
    residual_and_jacobian: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    parameters: torch.Tensor,
    config: LMConfig = LMConfig(),
    residual_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Batched damped Gauss-Newton on ``sum(residuals^2)``.

    Every batch element carries its own damping factor and accepts or
    rejects its step on its own (full-width compute, masked updates); an
    element whose error falls to ``error_threshold`` stops moving.

    :param residual_and_jacobian: maps ``(..., P)`` parameters to
        ``(..., R)`` residuals and ``(..., R, P)`` Jacobians.
    :param parameters: ``(..., P)`` initial iterates.
    :param residual_fn: the residuals alone, for the candidate's error (by
        default the first output of ``residual_and_jacobian``; eager
        PyTorch does not drop the unused Jacobian as XLA does).
    """
    p = parameters.shape[-1]
    eye = torch.eye(p, dtype=parameters.dtype, device=parameters.device)
    if residual_fn is None:
        residual_fn = lambda q: residual_and_jacobian(q)[0]  # noqa: E731
    batch_shape = parameters.shape[:-1]
    params = parameters
    damping = torch.full(batch_shape, config.initial_damping, dtype=parameters.dtype, device=parameters.device)
    active = torch.ones(batch_shape, dtype=torch.bool, device=parameters.device)
    for _ in range(config.iterations):
        res, jac = residual_and_jacobian(params)
        error = torch.sum(torch.square(res), dim=-1)
        jtj = torch.einsum("...rp,...rq->...pq", jac, jac)
        jtr = torch.einsum("...rp,...r->...p", jac, res)
        # J^T J + lambda I is SPD by construction (lambda > 0)
        candidate = params - spd_solve_small(jtj + damping[..., None, None] * eye, jtr)
        new_error = torch.sum(torch.square(residual_fn(candidate)), dim=-1)
        improved = (new_error < error) & active
        params = torch.where(improved[..., None], candidate, params)
        damping = torch.where(improved, damping * config.damping_down, damping * config.damping_up)
        damping = torch.clamp(damping, config.min_damping, config.max_damping)
        active = active & (torch.minimum(new_error, error) > config.error_threshold)
    return params
