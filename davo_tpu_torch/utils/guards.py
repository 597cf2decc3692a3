"""Guarded numeric primitives used inside the solvers.

The port of ``davo_tpu/utils/guards.py``.  Each guard has a value-level
branch that avoids inf/NaN and a matching ``torch.autograd.Function``
(``backward``, ``jvp`` and a generated vmap rule, so ``torch.func.jacfwd``
takes it) so that no NaN leaks into gradients through the unused branch.
:func:`straight_through_max` is the bundle adjustment's depth clamp: the
value of ``max`` with the derivative of the identity.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "safe_reciprocal",
    "safe_norm",
    "guarded_sqrt",
    "inverse_curvature",
    "interpolate_alpha",
    "straight_through_max",
    "project_vector_onto_axis",
]


def _reciprocal_or_zero(x, keep):
    """``1/x`` where ``keep`` holds, else 0 (double-where)."""
    one = torch.ones_like(x)
    return torch.where(keep, one / torch.where(keep, x, one), torch.zeros_like(x))


class _SafeReciprocal(torch.autograd.Function):
    generate_vmap_rule = True  # torch.func transforms (jacfwd, vmap)

    @staticmethod
    def forward(x):
        return _reciprocal_or_zero(x, x != 0.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, grad):
        (r,) = ctx.saved_tensors
        return -grad * r * r

    @staticmethod
    def jvp(ctx, tangent):
        (r,) = ctx.saved_tensors
        return -tangent * r * r


def safe_reciprocal(x: torch.Tensor) -> torch.Tensor:
    """``1/x`` but exactly 0 where ``x == 0`` (value and derivatives)."""
    return _SafeReciprocal.apply(x)


class _SafeNormLast(torch.autograd.Function):
    """L2 norm over the last axis (keepdim) with derivative zero at 0."""

    generate_vmap_rule = True  # torch.func transforms (jacfwd, vmap)

    @staticmethod
    def forward(x):
        return torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))

    @staticmethod
    def setup_context(ctx, inputs, output):
        (x,) = inputs
        ctx.save_for_backward(x, output)
        ctx.save_for_forward(x, output)

    @staticmethod
    def backward(ctx, grad):
        x, norm = ctx.saved_tensors
        return grad * x * _reciprocal_or_zero(norm, norm > 0.0)

    @staticmethod
    def jvp(ctx, tangent):
        x, norm = ctx.saved_tensors
        return torch.sum(x * tangent, dim=-1, keepdim=True) * _reciprocal_or_zero(
            norm, norm > 0.0
        )


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """Gradient-safe L2 norm (zero derivative at the origin)."""
    if dim != -1:
        x = torch.movedim(x, dim, -1)
    out = _SafeNormLast.apply(x)
    return out if keepdim else out[..., 0]


def guarded_sqrt(squared: torch.Tensor) -> torch.Tensor:
    """``sqrt`` of a sum of squares with a zero derivative at zero
    (double-where pattern)."""
    positive = squared > 0.0
    return torch.where(
        positive,
        torch.sqrt(torch.where(positive, squared, torch.ones_like(squared))),
        torch.zeros_like(squared),
    )


class _InverseCurvature(torch.autograd.Function):
    generate_vmap_rule = True  # torch.func transforms (jacfwd, vmap)

    @staticmethod
    def forward(step, delta_gradient):
        curvature = torch.sum(step * delta_gradient, dim=-1, keepdim=True)
        return _reciprocal_or_zero(curvature, curvature > 0.0)

    @staticmethod
    def setup_context(ctx, inputs, output):
        step, delta_gradient = inputs
        ctx.save_for_backward(step, delta_gradient, output)
        ctx.save_for_forward(step, delta_gradient, output)

    @staticmethod
    def backward(ctx, grad):
        step, delta_gradient, inv = ctx.saved_tensors
        d_curv = -grad * inv * inv
        return d_curv * delta_gradient, d_curv * step

    @staticmethod
    def jvp(ctx, t_step, t_dg):
        step, delta_gradient, inv = ctx.saved_tensors
        d_curv = torch.zeros_like(inv)
        if t_step is not None:
            d_curv = d_curv + torch.sum(t_step * delta_gradient, dim=-1, keepdim=True)
        if t_dg is not None:
            d_curv = d_curv + torch.sum(step * t_dg, dim=-1, keepdim=True)
        return -inv * inv * d_curv


def inverse_curvature(step: torch.Tensor, delta_gradient: torch.Tensor) -> torch.Tensor:
    """``1 / (y^T s)`` along the last axis, zeroed (value and derivative)
    where the curvature is non-positive, so a BFGS update is skipped.

    Returns shape ``(..., 1)``.
    """
    return _InverseCurvature.apply(step, delta_gradient)


def _interpolate_alpha_parts(alpha_1, alpha_2, value_1, value_2):
    value_diff = value_2 - value_1
    inv_diff = _reciprocal_or_zero(value_diff, value_diff != 0.0)
    secant = alpha_1 - value_1 * (alpha_2 - alpha_1) * inv_diff
    min_alpha = torch.minimum(alpha_1, alpha_2)
    max_alpha = torch.maximum(alpha_1, alpha_2)
    use_bisection = (
        (value_diff == 0.0)
        | (secant < min_alpha + 1e-3)
        | (secant > max_alpha - 1e-3)
    )
    bisect = 0.5 * (alpha_1 + alpha_2)
    return secant, bisect, use_bisection, inv_diff


class _InterpolateAlpha(torch.autograd.Function):
    generate_vmap_rule = True  # torch.func transforms (jacfwd, vmap)

    @staticmethod
    def forward(alpha_1, alpha_2, value_1, value_2):
        secant, bisect, use_bisection, _ = _interpolate_alpha_parts(
            alpha_1, alpha_2, value_1, value_2
        )
        return torch.where(use_bisection, bisect, secant)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def _partials(ctx):
        alpha_1, alpha_2, value_1, value_2 = ctx.saved_tensors
        _, _, use_bisection, inv_diff = _interpolate_alpha_parts(
            alpha_1, alpha_2, value_1, value_2
        )
        inv_gradient = (alpha_2 - alpha_1) * inv_diff
        half = torch.full_like(alpha_1, 0.5)
        zero = torch.zeros_like(alpha_1)
        return (
            torch.where(use_bisection, half, value_2 * inv_diff),
            torch.where(use_bisection, half, -value_1 * inv_diff),
            torch.where(use_bisection, zero, -value_2 * inv_gradient * inv_diff),
            torch.where(use_bisection, zero, value_1 * inv_gradient * inv_diff),
        )

    @staticmethod
    def backward(ctx, grad):
        return tuple(grad * d for d in _InterpolateAlpha._partials(ctx))

    @staticmethod
    def jvp(ctx, *tangents):
        out = None
        for d, t in zip(_InterpolateAlpha._partials(ctx), tangents):
            if t is not None:
                out = d * t if out is None else out + d * t
        return out


def interpolate_alpha(alpha_1, alpha_2, value_1, value_2):
    """Secant step between two step sizes from their values, with
    bisection where the values are equal or the secant lands within 1e-3
    of either bound.  The bisection branch propagates 0.5 to each alpha
    and zero to the values."""
    return _InterpolateAlpha.apply(alpha_1, alpha_2, value_1, value_2)


class _StraightThroughMax(torch.autograd.Function):
    generate_vmap_rule = True  # torch.func transforms (jacfwd, vmap)

    @staticmethod
    def forward(x, floor):
        return torch.maximum(x, floor)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        return grad, None

    @staticmethod
    def jvp(ctx, t_x, t_floor):
        return t_x if t_x is not None else torch.zeros_like(t_floor)


def straight_through_max(x: torch.Tensor, floor: torch.Tensor) -> torch.Tensor:
    """``max(x, floor)`` whose derivative is the identity in ``x``
    everywhere and zero in ``floor`` (reverse and forward mode): points
    clamped to the minimum depth keep their depth gradients, so the
    optimiser can pull them back in front of the camera."""
    return _StraightThroughMax.apply(x, torch.as_tensor(floor, dtype=x.dtype, device=x.device))


def project_vector_onto_axis(
    vector: torch.Tensor, axis: torch.Tensor, axis_square_norm: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``((v . a) / |a|^2) a`` along the last dimension, 0 where the axis is
    the zero vector; ``axis_square_norm`` (``(..., 1)`` or ``(...)``) may be
    passed if already computed."""
    if axis_square_norm is None:
        axis_square_norm = torch.sum(torch.square(axis), dim=-1, keepdim=True)
    elif axis_square_norm.ndim < axis.ndim:
        axis_square_norm = axis_square_norm[..., None]
    dot = torch.sum(vector * axis, dim=-1, keepdim=True)
    return dot * safe_reciprocal(axis_square_norm) * axis
