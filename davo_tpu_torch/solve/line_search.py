"""Batched line searches as masked lockstep loops (the port of
``davo_tpu/solve/line_search.py``).

Every batch element carries its own search state and the whole batch
advances together; the loop ends when no element is still searching
(one host synchronisation per probe) or the probe budget is spent.  The
returned step sizes are search results, not differentiable functions of
the inputs: the searches run on detached tensors without a graph, which
is the zero-gradient contract of the JAX package's ``custom_jvp``.
Elements where no candidate passes get step size 0.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.autograd.forward_ad as fwAD

from davo_tpu_torch.utils.guards import interpolate_alpha

__all__ = ["line_search_wolfe_conditions", "line_search_backtracking"]


def _prepare(parameters, search_direction, base_error, base_gradient, active, init_alpha):
    params = parameters.detach()
    direction = search_direction.detach()
    err0 = base_error.detach()
    dphi0 = torch.sum(direction * base_gradient.detach(), dim=-1)
    if active is None:
        active = torch.ones_like(err0, dtype=torch.bool)
    if init_alpha is None:
        init_alpha = torch.ones_like(err0)
    return params, direction, err0, dphi0, active.expand(err0.shape).clone(), init_alpha.detach().to(params.dtype)


@torch.no_grad()
def line_search_backtracking(
    parameters: torch.Tensor,
    search_direction: torch.Tensor,
    base_error: torch.Tensor,
    base_gradient: torch.Tensor,
    error_function: Callable[[torch.Tensor], torch.Tensor],
    sufficient_decrease: float = 1e-4,
    max_iterations: int = 8,
    active: Optional[torch.Tensor] = None,
    init_alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Armijo backtracking with value-only probes; between probes the next
    candidate is the quadratic-fit minimiser clipped to
    ``[0.1, 0.5] * alpha`` (N&W eq. 3.58).

    :return: ``(B...,)`` accepted step sizes (0 where none passed).
    """
    c1 = sufficient_decrease
    params, direction, err0, dphi0, searching, alpha = _prepare(
        parameters, search_direction, base_error, base_gradient, active, init_alpha
    )
    alpha = alpha.expand(err0.shape).clone()
    accepted = torch.zeros_like(err0)
    step_idx = 0
    while step_idx < max_iterations and bool(searching.any()):
        err = error_function(params + alpha[..., None] * direction)
        ok = err <= err0 + c1 * alpha * dphi0
        accepted = torch.where(searching & ok, alpha, accepted)
        searching = searching & ~ok
        # quadratic through (0, phi0), (0, dphi0), (alpha, err)
        denom = 2.0 * (err - err0 - dphi0 * alpha)
        quad = -dphi0 * torch.square(alpha) / torch.where(
            torch.abs(denom) > 1e-30, denom, torch.ones_like(denom)
        )
        next_alpha = torch.minimum(torch.maximum(quad, 0.1 * alpha), 0.5 * alpha)
        next_alpha = torch.where(torch.isfinite(next_alpha), next_alpha, 0.5 * alpha)
        alpha = torch.where(searching, next_alpha, alpha)
        step_idx += 1
    return accepted


def _phi_and_dphi(error_function, probe, direction):
    """``phi`` and the directional derivative ``phi'`` along
    ``direction``, in one forward-mode pass."""
    with fwAD.dual_level():
        out = error_function(fwAD.make_dual(probe, direction))
        value, tangent = fwAD.unpack_dual(out)
    if tangent is None:
        tangent = torch.zeros_like(value)
    return value, tangent


@torch.no_grad()
def line_search_wolfe_conditions(
    parameters: torch.Tensor,
    search_direction: torch.Tensor,
    base_error: torch.Tensor,
    base_gradient: torch.Tensor,
    error_function: Callable[[torch.Tensor], torch.Tensor],
    sufficient_decrease: float = 1e-4,
    curvature: float = 0.9,
    strong: bool = True,
    max_iterations: int = 1000,
    max_step_size: Optional[float] = None,
    zoom_method: str = "bisection",
    active: Optional[torch.Tensor] = None,
    init_alpha: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-element step sizes satisfying the (strong) Wolfe conditions
    (N&W algorithms 3.5 widen and 3.6 zoom as one masked state machine).

    1. ``f(x + a d) <= f(x) + c1 a d.f'(x)``  (sufficient decrease)
    2. ``|d.f'(x + a d)| <= c2 |d.f'(x)|``     (strong curvature; weak:
       ``-d.f'(x + a d) <= -c2 d.f'(x)``)

    Probes evaluate ``phi`` and ``phi'`` by forward mode over
    ``error_function``.

    :return: ``(B...,)`` step sizes (0 where none passed).
    """
    if not 0.0 < sufficient_decrease < curvature < 1.0:
        raise ValueError(
            f"Line search conditions require 0 < c1 < c2 < 1; got "
            f"c1={sufficient_decrease}, c2={curvature}"
        )
    if zoom_method not in ("bisection", "interpolate"):
        raise ValueError(f"Unknown zoom_method: {zoom_method!r}")
    c1, c2 = sufficient_decrease, curvature
    params, direction, err0, dphi0, widening, first_alpha = _prepare(
        parameters, search_direction, base_error, base_gradient, active, init_alpha
    )
    if max_step_size is not None:
        first_alpha = torch.clamp(first_alpha, max=max_step_size)
    where = torch.where
    zooming = torch.zeros_like(widening)
    zeros = torch.zeros_like(err0)
    lower_alpha, upper_alpha = zeros, zeros
    candidate_alpha = first_alpha.expand(err0.shape).clone()
    lower_error = upper_error = candidate_error = err0
    lower_dphi = upper_dphi = candidate_dphi = dphi0

    step_idx = 0
    while step_idx < max_iterations and bool((widening | zooming).any()):
        updating = widening | zooming
        not_first = step_idx > 0

        # --- choose the next candidate
        widen_adv = widening & not_first
        upper_alpha = where(widen_adv, candidate_alpha, upper_alpha)
        upper_error = where(widen_adv, candidate_error, upper_error)
        upper_dphi = where(widen_adv, candidate_dphi, upper_dphi)
        doubled = 2.0 * candidate_alpha
        if max_step_size is not None:
            doubled = torch.clamp(doubled, max=max_step_size)
        candidate_alpha = where(widen_adv, doubled, candidate_alpha)
        if zoom_method == "bisection":
            zoom_alpha = 0.5 * (lower_alpha + upper_alpha)
        else:
            zoom_alpha = interpolate_alpha(lower_alpha, upper_alpha, lower_dphi, upper_dphi)
        candidate_alpha = where(zooming & not_first, zoom_alpha, candidate_alpha)

        # --- evaluate the candidate
        err, dphi = _phi_and_dphi(
            error_function, params + candidate_alpha[..., None] * direction, direction
        )
        candidate_error = where(updating, err, candidate_error)
        candidate_dphi = where(updating, dphi, candidate_dphi)

        # --- the three condition bits
        decrease = candidate_error > err0 + c1 * candidate_alpha * dphi0
        decrease = decrease | (zooming & (candidate_error >= lower_error))
        decrease = decrease | (widening & not_first & (candidate_error >= upper_error))
        if strong:
            curvature_ok = torch.abs(candidate_dphi) <= -c2 * dphi0
        else:
            curvature_ok = -candidate_dphi <= -c2 * dphi0
        grad_cond_widen = candidate_dphi >= 0.0
        grad_cond_zoom = candidate_dphi * (upper_alpha - lower_alpha) >= 0.0

        # --- zoom (alg 3.6) transitions
        set_high = zooming & decrease
        done_zoom = zooming & ~decrease & curvature_ok
        flip = zooming & ~decrease & ~curvature_ok & grad_cond_zoom
        set_low = zooming & ~decrease & ~curvature_ok

        high = set_high | done_zoom
        new_upper_alpha = where(flip, lower_alpha, where(high, candidate_alpha, upper_alpha))
        new_upper_error = where(flip, lower_error, where(high, candidate_error, upper_error))
        new_upper_dphi = where(flip, lower_dphi, where(high, candidate_dphi, upper_dphi))
        low = set_low | done_zoom
        new_lower_alpha = where(low, candidate_alpha, lower_alpha)
        new_lower_error = where(low, candidate_error, lower_error)
        new_lower_dphi = where(low, candidate_dphi, lower_dphi)
        zooming = zooming & ~done_zoom

        # --- widen (alg 3.5) transitions
        zoom_ordered = widening & decrease
        done_widen = widening & ~decrease & curvature_ok
        zoom_flipped = widening & ~decrease & ~curvature_ok & grad_cond_widen
        # a_lo <- a_{i-1} (held in upper_* during widening)
        new_lower_alpha = where(zoom_ordered, upper_alpha, new_lower_alpha)
        new_lower_error = where(zoom_ordered, upper_error, new_lower_error)
        new_lower_dphi = where(zoom_ordered, upper_dphi, new_lower_dphi)
        to_upper = zoom_ordered | done_widen
        new_upper_alpha = where(to_upper, candidate_alpha, new_upper_alpha)
        new_upper_error = where(to_upper, candidate_error, new_upper_error)
        new_upper_dphi = where(to_upper, candidate_dphi, new_upper_dphi)
        to_lower = done_widen | zoom_flipped
        new_lower_alpha = where(to_lower, candidate_alpha, new_lower_alpha)
        new_lower_error = where(to_lower, candidate_error, new_lower_error)
        new_lower_dphi = where(to_lower, candidate_dphi, new_lower_dphi)
        zooming = zooming | zoom_ordered | zoom_flipped
        # simple failure case: the bounds have collapsed
        zooming = zooming & (new_lower_alpha != new_upper_alpha)
        widening = widening & ~(zoom_ordered | done_widen | zoom_flipped)

        lower_alpha, lower_error, lower_dphi = new_lower_alpha, new_lower_error, new_lower_dphi
        upper_alpha, upper_error, upper_dphi = new_upper_alpha, new_upper_error, new_upper_dphi
        step_idx += 1
    return upper_alpha
