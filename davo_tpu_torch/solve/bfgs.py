"""Batched BFGS with a line search (the port of ``davo_tpu/solve/bfgs.py``).

The whole batch of independent problems advances in lockstep; an
``updating`` mask tracks per-element convergence and frozen elements keep
their last value.  Each iteration makes one value+gradient evaluation,
one inverse-Hessian update + search direction and one line search.  Two
modes share the step:

* eval (``differentiable=False``, the default outside training): the
  value+gradient through the ``value_and_grad_fn`` hook (kernel K2 in the
  network) or autograd, the Hessian block through kernel K1 on a
  channel-major ``(P, P, B)`` carry.  The loop tests ``any(updating)`` on
  the host once per iteration and stops early; the result carries no
  gradient (the JAX package's ``custom_jvp`` with a zero tangent).
* differentiable (``differentiable=True``, the default in training): a
  Python loop of exactly ``iterations`` steps with no host test, the
  counterpart of the JAX package's ``lax.scan``.  The graph is kept: the
  gradient comes from ``torch.autograd.grad(..., create_graph=True)``,
  the Hessian block is the JAX package's unfused code
  (:func:`update_inverse_hessian` on a batch-major ``(B, P, P)`` carry,
  merged with ``torch.where``), so the outer loss differentiates through
  the unroll.  Neither kernel runs here, as in the JAX package, where
  both Pallas kernels are eval-only.  The line searches stay
  zero-gradient in both modes.

Training-mode knobs carry over: separate training iteration and threshold
budgets, random early stopping (``drop_path_p``, drawn from a
``torch.Generator`` or injected as keep-masks) and ``return_second_last``.
The loop (:func:`minimise`) is shared with L-BFGS, which supplies its own
:class:`DirectionState` in place of the inverse Hessian.
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
    """Hyper-parameters of :func:`bfgs_solve` (the JAX package's fields)."""

    sufficient_decrease: float = 1e-4
    curvature: float = 0.9
    error_threshold: float = 1e-4
    iterations: int = 1000
    minimum_step: float = 1e-8
    # probability, per training step, that an element stops updating
    drop_path_p: float = 0.1
    # training: return the iterate one step short of convergence
    return_second_last: bool = False
    training_iterations: Optional[int] = None
    training_error_threshold: Optional[float] = None
    line_search_iterations: int = 1000
    # start each line search from the last accepted step size, clipped to
    # [1/16, 16] (for backtracking: twice it, capped at
    # warm_start_max_alpha) instead of 1
    warm_start_line_search: bool = False
    warm_start_max_alpha: float = 16.0
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
    # kept for parity with the JAX package's config: the eval solve always
    # runs kernel K1 (False raises there), the differentiable solve always
    # the unfused update (True raises there); None suits both
    fused_hessian_kernel: Optional[bool] = None

    def resolve(self, training: bool) -> tuple[int, float]:
        """``(iterations, error threshold)`` of the eval or training solve."""
        iterations = self.iterations
        threshold = self.error_threshold
        if training:
            if self.training_iterations is not None:
                iterations = self.training_iterations
            if self.training_error_threshold is not None:
                threshold = self.training_error_threshold
        return iterations, threshold


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


def _value_and_grad_with_graph(error_function, params):
    """As :func:`_value_and_grad_batched`, keeping the graph: the gradient
    is itself differentiable (``create_graph=True``), as the reverse pass
    through the unrolled solve needs."""
    with torch.enable_grad():
        x = params if params.requires_grad else params.detach().requires_grad_(True)
        error = error_function(x)
        (gradient,) = torch.autograd.grad(error.sum(), x, create_graph=True)
    return error, gradient


def _unfused_update_direction(inverse_hessian, step, delta_gradient, gradient, updating, step_idx):
    """The JAX package's unfused Hessian block on a batch-major
    ``(B, P, P)`` carry (its non-fused branch of ``solver_step``): the eq.
    6.20 rescale on the second step, the guarded rank-2 update where
    ``updating`` holds (not on the first step), and ``-H g`` (``-g`` on
    the first step).  Differentiable; only the differentiable solve runs
    it."""
    if step_idx == 1:
        inverse_hessian = scale_initial_inverse_hessian(step, delta_gradient)[..., None] * inverse_hessian
    if step_idx == 0:
        return inverse_hessian, -gradient
    updated = update_inverse_hessian(inverse_hessian, step, delta_gradient)
    inverse_hessian = torch.where(updating[..., None, None], updated, inverse_hessian)
    return inverse_hessian, -torch.einsum("...ij,...j->...i", inverse_hessian, gradient)


def bfgs_solve(
    error_function: Callable[[torch.Tensor], torch.Tensor],
    parameters: torch.Tensor,
    config: BFGSConfig = BFGSConfig(),
    *,
    training: bool = False,
    differentiable: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
    keep_masks: Optional[torch.Tensor] = None,
    value_and_grad_fn: Optional[Callable] = None,
    direction_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Minimise ``error_function`` independently for every batch element.

    :param error_function: maps ``(B..., P) -> (B...,)``; each output
        depends only on its own parameter row.  The line search probes it.
    :param parameters: ``(B..., P)`` initial iterates; the solve runs on
        the ``(B, P)`` flattening of the leading dimensions, and the
        functions below see, and return, the leading shape ``B...``.
    :param config: solver hyper-parameters.
    :param training: the training iteration and threshold budgets,
        drop-path and ``return_second_last``.
    :param differentiable: keep the graph through a fixed-length unroll;
        defaults to ``training``.
    :param generator: draws the drop-path keep-masks (``uniform > p``, once
        a step) when ``training`` and ``config.drop_path_p > 0``.
    :param keep_masks: ``(iterations, B...)`` boolean keep-masks to use
        instead of the generator's draws.
    :param value_and_grad_fn: optional ``params -> (error, gradient)``
        replacing autograd (the fused objective, kernel K2); in the
        differentiable solve it must keep its own graph.
    :param direction_fn: optional ``(direction, params, error, step_idx)
        -> direction`` applied after the clamp (a learned search-direction
        modifier).
    :return: ``(B..., P)`` optimised parameters; in the eval mode without a
        gradient.  With zero iterations, ``parameters`` itself.
    """
    if config.line_search_method not in ("wolfe", "backtracking"):
        raise ValueError(f"unknown line_search_method {config.line_search_method!r}")
    if differentiable is None:
        differentiable = training
    if differentiable and config.fused_hessian_kernel:
        raise ValueError("fused_hessian_kernel (kernel K1) runs on the non-differentiable path only")
    if not differentiable and config.fused_hessian_kernel is False:
        raise ValueError("the eval solve always runs kernel K1; fused_hessian_kernel=False has no eval route")
    return minimise(
        _BFGSDirection, error_function, parameters, config, training=training, differentiable=differentiable,
        generator=generator, keep_masks=keep_masks, value_and_grad_fn=value_and_grad_fn, direction_fn=direction_fn,
    )


class DirectionState:
    """A solver's search direction and its carry through one solve of
    :func:`minimise` (the dense inverse Hessian of BFGS, the pair history
    of L-BFGS).  ``direction(step, delta_gradient, gradient, updating,
    step_idx)`` takes the step just taken, the change of the gradient, the
    new gradient and the elements still updating, and returns the search
    direction; ``line_search`` is the Wolfe search from a unit step, and
    ``accepted(alpha, moving)`` sees each step's size."""

    def __init__(self, config):
        self.config = config

    def direction(self, step, delta_gradient, gradient, updating, step_idx):
        raise NotImplementedError

    def line_search(self, params, search_direction, error, gradient, error_function, updating):
        return self._wolfe(params, search_direction, error, gradient, error_function, updating)

    def _wolfe(self, params, search_direction, error, gradient, error_function, updating, init_alpha=None):
        c = self.config
        return line_search_wolfe_conditions(
            params,
            search_direction,
            error,
            gradient,
            error_function,
            sufficient_decrease=c.sufficient_decrease,
            curvature=c.curvature,
            strong=c.strong,
            max_iterations=c.line_search_iterations,
            max_step_size=c.max_step_size,
            zoom_method=c.zoom_method,
            active=updating,
            init_alpha=init_alpha,
        )

    def accepted(self, alpha, moving):
        pass


class _BFGSDirection(DirectionState):
    """The inverse-Hessian carry: kernel K1 on a channel-major ``(P, P,
    B)`` carry in the eval solve, the unfused block on a batch-major ``(B,
    P, P)`` one in the differentiable solve; with the warm-started and
    backtracking line searches of :class:`BFGSConfig`."""

    def __init__(self, config, params, differentiable):
        super().__init__(config)
        batch, p = params.shape
        self.dtype = params.dtype
        self.h_dtype = getattr(torch, config.hessian_dtype) if config.hessian_dtype else self.dtype
        self.fused = not differentiable
        eye = torch.eye(p, dtype=self.h_dtype, device=params.device)
        if self.fused:
            # channel-major (P, P, B) carry, as kernel K1 takes it
            self.inverse_hessian = eye[:, :, None].expand(p, p, batch).contiguous()
        else:
            self.inverse_hessian = eye.expand(batch, p, p)
        self.alpha_carry = torch.ones(batch, dtype=self.dtype, device=params.device)

    def direction(self, step, delta_gradient, gradient, updating, step_idx):
        if self.fused:
            self.inverse_hessian, search_direction = fused_bfgs_update_direction(
                self.inverse_hessian, step, delta_gradient, gradient, updating, step_idx == 0, step_idx == 1
            )
            return search_direction
        h, search_direction = _unfused_update_direction(
            self.inverse_hessian.to(self.dtype), step, delta_gradient, gradient, updating, step_idx
        )
        self.inverse_hessian = h.to(self.h_dtype)
        return search_direction

    def line_search(self, params, search_direction, error, gradient, error_function, updating):
        config = self.config
        init_alpha = None
        if config.warm_start_line_search:
            init_alpha = torch.clamp(self.alpha_carry, 1.0 / 16.0, 16.0)
            if config.line_search_method == "backtracking":
                # backtracking only shrinks from its first candidate: seed
                # it at twice the last accepted step (capped)
                init_alpha = torch.clamp(2.0 * init_alpha, max=config.warm_start_max_alpha)
        if config.line_search_method == "backtracking":
            return line_search_backtracking(
                params,
                search_direction,
                error,
                gradient,
                error_function,
                sufficient_decrease=config.sufficient_decrease,
                max_iterations=config.line_search_iterations,
                active=updating,
                init_alpha=init_alpha,
            )
        return self._wolfe(params, search_direction, error, gradient, error_function, updating, init_alpha)

    def accepted(self, alpha, moving):
        if self.config.warm_start_line_search:
            # failed searches (alpha 0) keep the last accepted step size
            self.alpha_carry = torch.where(moving & (alpha > 0), alpha, self.alpha_carry)


def minimise(
    make_direction: Callable[..., DirectionState],
    error_function: Callable[[torch.Tensor], torch.Tensor],
    parameters: torch.Tensor,
    config,
    *,
    training: bool,
    differentiable: bool,
    generator: Optional[torch.Generator],
    keep_masks: Optional[torch.Tensor],
    value_and_grad_fn: Optional[Callable],
    direction_fn: Optional[Callable],
) -> torch.Tensor:
    """The quasi-Newton loop that :func:`bfgs_solve` and
    :func:`~davo_tpu_torch.solve.lbfgs_solve` share (their arguments);
    ``make_direction(config, params, differentiable)`` builds the
    solver's :class:`DirectionState`."""
    if parameters.ndim != 2:
        # the solve is per row: run it on the (B, P) flattening of the
        # leading dimensions, the caller's functions seeing their own shape
        return _flattened(
            make_direction, error_function, parameters, config, training=training,
            differentiable=differentiable, generator=generator, keep_masks=keep_masks,
            value_and_grad_fn=value_and_grad_fn, direction_fn=direction_fn,
        )
    iterations, threshold = config.resolve(training)
    use_drop_path = training and config.drop_path_p > 0.0
    if use_drop_path and generator is None and keep_masks is None:
        raise ValueError("drop_path_p > 0 in training mode needs a generator or keep_masks")
    if keep_masks is not None and keep_masks.shape[0] < iterations:
        raise ValueError(f"keep_masks holds {keep_masks.shape[0]} steps, the solve takes up to {iterations}")

    def keep(step_idx, batch, device):
        if keep_masks is not None:
            return keep_masks[step_idx].to(device)
        return torch.rand(batch, generator=generator, device=device) > config.drop_path_p

    solve = dict(
        make_direction=make_direction, error_function=error_function, config=config, iterations=iterations,
        threshold=threshold, second_last=training and config.return_second_last,
        keep=keep if use_drop_path else None, value_and_grad_fn=value_and_grad_fn, direction_fn=direction_fn,
    )
    if differentiable:
        return _solve(parameters, differentiable=True, **solve)
    with torch.no_grad():
        return _solve(parameters.detach(), differentiable=False, **solve)


def _flattened(
    make_direction, error_function, parameters, config, *, keep_masks, value_and_grad_fn, direction_fn, **kwargs
):
    """:func:`minimise` on the ``(B, P)`` flattening of ``(B..., P)``
    parameters; the error function and the hooks are called with, and
    return, the leading shape ``B...``, and the result has it."""
    shape = parameters.shape
    batch = shape[:-1]

    def unflat(x):
        return x.reshape(batch + x.shape[1:])

    def flat(x):
        return x.reshape((-1,) + x.shape[len(batch):])

    def error_flat(params):
        return flat(error_function(unflat(params)))

    vg_flat = dir_flat = None
    if value_and_grad_fn is not None:
        def vg_flat(params):
            error, gradient = value_and_grad_fn(unflat(params))
            return flat(error), flat(gradient)

    if direction_fn is not None:
        def dir_flat(direction, params, error, step_idx):
            return flat(direction_fn(unflat(direction), unflat(params), unflat(error), step_idx))

    if keep_masks is not None:
        keep_masks = keep_masks.reshape(keep_masks.shape[0], -1)
    out = minimise(
        make_direction, error_flat, parameters.reshape(-1, shape[-1]), config, keep_masks=keep_masks,
        value_and_grad_fn=vg_flat, direction_fn=dir_flat, **kwargs,
    )
    return out.reshape(shape)


def _solve(
    params, *, make_direction, error_function, config, iterations, threshold, second_last, keep, value_and_grad_fn,
    direction_fn, differentiable,
):
    batch = params.shape[0]
    method = make_direction(config, params, differentiable)
    gradient = torch.zeros_like(params)
    step = torch.zeros_like(params)
    updating = torch.ones(batch, dtype=torch.bool, device=params.device)

    step_idx = 0
    # the eval solve stops once no element updates (a host test); the
    # differentiable one runs its fixed length, as lax.scan does
    while step_idx < iterations and (differentiable or bool(updating.any())):
        if keep is not None:
            updating = updating & keep(step_idx, batch, params.device)
        if value_and_grad_fn is not None:
            error, new_gradient = value_and_grad_fn(params)
        elif differentiable:
            error, new_gradient = _value_and_grad_with_graph(error_function, params)
        else:
            error, new_gradient = _value_and_grad_batched(error_function, params)
        updating = updating & (error.detach() > threshold)

        search_direction = method.direction(step, new_gradient - gradient, new_gradient, updating, step_idx)
        gradient = new_gradient
        search_direction = clamp_search_direction(
            search_direction, config.max_step_distance, config.min_step_distance
        )
        if direction_fn is not None:
            search_direction = direction_fn(search_direction, params, error, step_idx)

        alpha = method.line_search(params, search_direction, error, gradient, error_function, updating)
        new_step = alpha[:, None] * search_direction
        step = torch.where(updating[:, None], new_step, step)
        moving = updating & (torch.linalg.vector_norm(step.detach(), dim=-1) > config.minimum_step)
        # return_second_last commits the step only where the element keeps
        # moving, so the result lags the converged iterate by one step
        params = torch.where((moving if second_last else updating)[:, None], params + new_step, params)
        method.accepted(alpha, moving)
        updating = moving
        step_idx += 1
    return params
