"""Batched BFGS with a line search — the eval (non-differentiable) path of
``davo_tpu/solve/bfgs.py``.

The whole batch of independent problems advances in lockstep; an
``updating`` mask tracks per-element convergence and frozen elements keep
their last value.  Each iteration makes one value+gradient evaluation
(kernel K2 through the ``value_and_grad_fn`` hook, or autograd over
``error_function``), one fused Hessian update + direction (kernel K1 on a
channel-major ``(P, P, B)`` carry) and one line search.  The loop tests
``any(updating)`` on the host once per iteration (a synchronisation; CUDA
graphs could remove it in later work).  The result carries no gradient,
the zero-gradient contract of the JAX package's eval solve.

The training-mode solve (differentiable, unrolled, drop-path) belongs to
the later slice that ports ``train/calibration.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from davo_tpu_torch.ops.bfgs_update import fused_bfgs_update_direction
from davo_tpu_torch.utils.guards import inverse_curvature

from .line_search import line_search_backtracking, line_search_wolfe_conditions

__all__ = [
    "BFGSConfig",
    "bfgs_solve",
    "update_inverse_hessian",
    "scale_initial_inverse_hessian",
    "clamp_search_direction",
]


@dataclasses.dataclass(frozen=True)
class BFGSConfig:
    """Hyper-parameters of the eval-mode :func:`bfgs_solve`: the JAX
    package's fields that its eval path reads.  The training budgets,
    drop-path and line-search warm starts come with the later slice that
    ports the training solve."""

    sufficient_decrease: float = 1e-4
    curvature: float = 0.9
    error_threshold: float = 1e-4
    iterations: int = 1000
    minimum_step: float = 1e-8
    line_search_iterations: int = 1000
    # "wolfe" (widen + zoom machine) or "backtracking" (Armijo, value-only)
    line_search_method: str = "wolfe"
    max_step_size: Optional[float] = None
    zoom_method: str = "bisection"
    strong: bool = True
    # scale each direction so its largest |component| lies in these bounds
    max_step_distance: Optional[float] = None
    min_step_distance: Optional[float] = None
    # storage type of the inverse-Hessian carry: None (the parameters'
    # type) or "bfloat16"; the update arithmetic is in the parameters' type
    hessian_dtype: Optional[str] = None


def scale_initial_inverse_hessian(step: torch.Tensor, delta_gradient: torch.Tensor) -> torch.Tensor:
    """Eq. 6.20 of Nocedal & Wright as a scale on the identity,
    ``max(y.s / max(y.y, 1e-5), 1e-4)``; shape ``(..., 1)``."""
    denominator = torch.clamp(
        torch.sum(torch.square(delta_gradient), dim=-1, keepdim=True), min=1e-5
    )
    scale = torch.sum(step * delta_gradient, dim=-1, keepdim=True) / denominator
    return torch.clamp(scale, min=1e-4)


def update_inverse_hessian(
    inverse_hessian: torch.Tensor, step: torch.Tensor, delta_gradient: torch.Tensor
) -> torch.Tensor:
    """Compact BFGS inverse-Hessian update (N&W eq. 6.17)

    ``H+ = H - (H y s^T + s y^T H)/(y.s) + (1 + y^T H y/(y.s)) s s^T/(y.s)``

    guarded by :func:`inverse_curvature`: where ``y.s <= 0`` the update
    collapses to ``H``.  Products are ordered so no term scales like
    ``|y|^2`` or ``|s|^2`` before the division.
    """
    inv_curvature = inverse_curvature(step, delta_gradient)  # (..., 1)
    yth = torch.einsum("...i,...ij->...j", delta_gradient, inverse_hessian)
    y_on_c = delta_gradient * inv_curvature
    yhy_on_c = torch.sum(yth * y_on_c, dim=-1)
    s_on_c = step * inv_curvature
    sst = s_on_c[..., :, None] * step[..., None, :] * (1.0 + yhy_on_c)[..., None, None]
    syth = s_on_c[..., :, None] * yth[..., None, :]
    hy = torch.einsum("...ij,...j->...i", inverse_hessian, delta_gradient)
    hys = hy[..., :, None] * s_on_c[..., None, :]
    return inverse_hessian + sst - syth - hys


def clamp_search_direction(
    search_direction: torch.Tensor,
    max_step_distance: Optional[float],
    min_step_distance: Optional[float],
) -> torch.Tensor:
    """Rescale each direction so its largest |component| lies within the
    given bounds (``None`` disables a bound)."""
    if max_step_distance is None and min_step_distance is None:
        return search_direction
    largest = torch.clamp(
        torch.amax(torch.abs(search_direction), dim=-1, keepdim=True), min=1e-8
    )
    scale = torch.ones_like(largest)
    if max_step_distance is not None:
        scale = torch.where(largest > max_step_distance, max_step_distance / largest, scale)
    if min_step_distance is not None:
        scale = torch.where(largest < min_step_distance, min_step_distance / largest, scale)
    return torch.clamp(scale, min=1e-16) * search_direction


def _value_and_grad_batched(error_function, params):
    """Per-element error and gradient: batch elements are independent, so
    the gradient of the summed error is each element's own gradient."""
    with torch.enable_grad():
        x = params.detach().requires_grad_(True)
        error = error_function(x)
        (gradient,) = torch.autograd.grad(error.sum(), x)
    return error.detach(), gradient


@torch.no_grad()
def bfgs_solve(
    error_function: Callable[[torch.Tensor], torch.Tensor],
    parameters: torch.Tensor,
    config: BFGSConfig = BFGSConfig(),
    *,
    value_and_grad_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Minimise ``error_function`` independently for every batch element.

    :param error_function: maps ``(B, P) -> (B,)``; each output depends only
        on its own parameter row.  The line search probes it.
    :param parameters: ``(B, P)`` initial iterates.
    :param config: solver hyper-parameters.
    :param value_and_grad_fn: optional ``params -> (error, gradient)``
        replacing autograd (the fused objective, kernel K2).
    :return: ``(B, P)`` optimised parameters (no gradient).
    """
    if config.line_search_method not in ("wolfe", "backtracking"):
        raise ValueError(f"unknown line_search_method {config.line_search_method!r}")
    if parameters.ndim != 2:
        raise ValueError(f"expected a (B, P) batch, got shape {tuple(parameters.shape)}")
    params = parameters.detach()
    batch, p = params.shape
    h_dtype = getattr(torch, config.hessian_dtype) if config.hessian_dtype else params.dtype

    # channel-major (P, P, B) carry, as kernel K1 takes it
    inverse_hessian = (
        torch.eye(p, dtype=h_dtype, device=params.device)[:, :, None]
        .expand(p, p, batch)
        .contiguous()
    )
    gradient = torch.zeros_like(params)
    step = torch.zeros_like(params)
    updating = torch.ones(batch, dtype=torch.bool, device=params.device)

    step_idx = 0
    while step_idx < config.iterations and bool(updating.any()):
        if value_and_grad_fn is not None:
            error, new_gradient = value_and_grad_fn(params)
        else:
            error, new_gradient = _value_and_grad_batched(error_function, params)
        updating = updating & (error > config.error_threshold)

        inverse_hessian, search_direction = fused_bfgs_update_direction(
            inverse_hessian,
            step,
            new_gradient - gradient,
            new_gradient,
            updating,
            step_idx == 0,
            step_idx == 1,
        )
        gradient = new_gradient
        search_direction = clamp_search_direction(
            search_direction, config.max_step_distance, config.min_step_distance
        )

        if config.line_search_method == "backtracking":
            alpha = line_search_backtracking(
                params,
                search_direction,
                error,
                gradient,
                error_function,
                sufficient_decrease=config.sufficient_decrease,
                max_iterations=config.line_search_iterations,
                active=updating,
            )
        else:
            alpha = line_search_wolfe_conditions(
                params,
                search_direction,
                error,
                gradient,
                error_function,
                sufficient_decrease=config.sufficient_decrease,
                curvature=config.curvature,
                strong=config.strong,
                max_iterations=config.line_search_iterations,
                max_step_size=config.max_step_size,
                zoom_method=config.zoom_method,
                active=updating,
            )
        new_step = alpha[:, None] * search_direction
        step = torch.where(updating[:, None], new_step, step)
        params = torch.where(updating[:, None], params + new_step, params)
        updating = updating & (torch.linalg.vector_norm(step, dim=-1) > config.minimum_step)
        step_idx += 1
    return params
