"""Numerically-stable trigonometric ratios of the angle and of its square
(the port of ``davo_tpu/utils/stable_trig.py``).

The x-forms (:func:`sin_x_on_x` and its three companions) take the angle
``x``; each switches to a truncated Taylor series below a threshold and
carries the derivative rules

    d sin_x_on_x/dx                        = x cos_x_on_x_squared_minus_sin_x_on_x_cubed
    d one_minus_cos_x_on_x_squared/dx      = x sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth
    d cos_x_on_x_squared_minus_sin_x_on_x_cubed/dx
                                           = -(sin_x_on_x + 3 cos_x_on_x_squared_minus_sin_x_on_x_cubed) / x
    d sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth/dx
                                           = (cos_x_on_x_squared_minus_sin_x_on_x_cubed
                                              - 4 sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth) / x

(the last two with their own series at small ``x``).  With ``x = sqrt(s)`` the four ratios of Rodrigues' formula are even in
``x`` and so analytic in ``s``; each switches to a truncated Taylor series
below a threshold (the double-``where`` pattern keeps the unused branch
finite) and carries a ``torch.autograd.Function`` whose ``backward`` and
``jvp`` use the closed family of derivatives

    d sinc_sq/ds          = cos_sin_sq / 2
    d one_minus_cos_sq/ds = sin_cubed_sq / 2
    d cos_sin_sq/ds       = -(sinc_sq + 3 cos_sin_sq) / (2 s)
    d sin_cubed_sq/ds     = (cos_sin_sq - 4 sin_cubed_sq) / (2 s)

Both rules are written with these same Functions, so derivatives of any
order stay NaN-free at ``s = 0``.  ``jvp`` serves the Wolfe line search's
forward-mode probes (:mod:`davo_tpu_torch.solve.line_search`).
"""

from __future__ import annotations

import torch

__all__ = [
    "sin_x_on_x",
    "one_minus_cos_x_on_x_squared",
    "cos_x_on_x_squared_minus_sin_x_on_x_cubed",
    "sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth",
    "sinc_sq",
    "one_minus_cos_sq",
    "cos_sin_sq",
    "sin_cubed_sq",
    "cos_from_sq",
]

_SMALL = 0.05
_SMALL_F3 = 0.25
_SMALL_SQ = _SMALL * _SMALL
_SMALL_SQ_F3 = _SMALL_F3 * _SMALL_F3


def _safe(x, small):
    return torch.where(small, torch.ones_like(x), x)


def _sin_x_on_x(x):
    small = torch.abs(x) < _SMALL
    xs = _safe(x, small)
    x2 = torch.square(x)
    taylor = 1.0 + x2 * (-1.0 / 6.0 + x2 * (1.0 / 120.0 + x2 * (-1.0 / 5040.0)))
    return torch.where(small, taylor, torch.sin(xs) / xs)


def _cos_sin_x(x):
    small = torch.abs(x) < _SMALL
    xs = _safe(x, small)
    x2 = torch.square(x)
    taylor = -1.0 / 3.0 + x2 * (1.0 / 30.0 + x2 * (-1.0 / 840.0 + x2 * (1.0 / 45360.0)))
    exact = (torch.cos(xs) - torch.sin(xs) / xs) / torch.square(xs)
    return torch.where(small, taylor, exact)


def _one_minus_cos_x(x):
    small = torch.abs(x) < _SMALL
    xs = _safe(x, small)
    x2 = torch.square(x)
    taylor = 0.5 + x2 * (-1.0 / 24.0 + x2 * (1.0 / 720.0 + x2 * (-1.0 / 40320.0)))
    # 2 sin^2(x/2) / x^2 is stabler than (1 - cos x) / x^2 for moderate x
    exact = 2.0 * torch.square(torch.sin(0.5 * xs)) / torch.square(xs)
    return torch.where(small, taylor, exact)


def _sin_cubed_x(x):
    small = torch.abs(x) < _SMALL_F3
    xs = _safe(x, small)
    x2 = torch.square(x)
    taylor = -1.0 / 12.0 + x2 * (1.0 / 180.0 + x2 * (-1.0 / 6720.0 + x2 * (1.0 / 453600.0)))
    x2s = torch.square(xs)
    exact = (torch.sin(xs) / xs - 4.0 * torch.square(torch.sin(0.5 * xs)) / x2s) / x2s
    return torch.where(small, taylor, exact)


def _d_cos_sin_x(x):
    small = torch.abs(x) < _SMALL
    xs = _safe(x, small)
    x2 = torch.square(x)
    taylor = x * (1.0 / 15.0 + x2 * (-1.0 / 210.0 + x2 * (1.0 / 7560.0)))
    exact = -(sin_x_on_x(xs) + 3.0 * cos_x_on_x_squared_minus_sin_x_on_x_cubed(xs)) / xs
    return torch.where(small, taylor, exact)


def _d_sin_cubed_x(x):
    small = torch.abs(x) < _SMALL_F3
    xs = _safe(x, small)
    x2 = torch.square(x)
    taylor = x * (1.0 / 90.0 + x2 * (-1.0 / 1680.0 + x2 * (1.0 / 75600.0)))
    exact = (
        cos_x_on_x_squared_minus_sin_x_on_x_cubed(xs)
        - 4.0 * sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth(xs)
    ) / xs
    return torch.where(small, taylor, exact)


def _sqrt_safe(s, small):
    return torch.sqrt(torch.where(small, torch.ones_like(s), s))


def _sinc_sq(s):
    small = s < _SMALL_SQ
    x = _sqrt_safe(s, small)
    taylor = 1.0 + s * (-1.0 / 6.0 + s * (1.0 / 120.0 + s * (-1.0 / 5040.0)))
    return torch.where(small, taylor, torch.sin(x) / x)


def _cos_sin_sq(s):
    small = s < _SMALL_SQ
    x = _sqrt_safe(s, small)
    taylor = -1.0 / 3.0 + s * (
        1.0 / 30.0 + s * (-1.0 / 840.0 + s * (1.0 / 45360.0))
    )
    exact = (torch.cos(x) - torch.sin(x) / x) / torch.where(
        small, torch.ones_like(s), s
    )
    return torch.where(small, taylor, exact)


def _one_minus_cos_sq(s):
    small = s < _SMALL_SQ
    x = _sqrt_safe(s, small)
    taylor = 0.5 + s * (-1.0 / 24.0 + s * (1.0 / 720.0 + s * (-1.0 / 40320.0)))
    exact = 2.0 * torch.square(torch.sin(0.5 * x)) / torch.where(
        small, torch.ones_like(s), s
    )
    return torch.where(small, taylor, exact)


def _sin_cubed_sq(s):
    small = s < _SMALL_SQ_F3
    x = _sqrt_safe(s, small)
    ss = torch.where(small, torch.ones_like(s), s)
    taylor = -1.0 / 12.0 + s * (
        1.0 / 180.0 + s * (-1.0 / 6720.0 + s * (1.0 / 453600.0))
    )
    exact = (torch.sin(x) / x - 4.0 * torch.square(torch.sin(0.5 * x)) / ss) / ss
    return torch.where(small, taylor, exact)


def _d_cos_sin_sq(s):
    small = s < _SMALL_SQ
    ss = torch.where(small, torch.ones_like(s), s)
    taylor = 1.0 / 30.0 + s * (-1.0 / 420.0 + s * (1.0 / 15120.0))
    exact = -(sinc_sq(ss) + 3.0 * cos_sin_sq(ss)) / (2.0 * ss)
    return torch.where(small, taylor, exact)


def _d_sin_cubed_sq(s):
    small = s < _SMALL_SQ_F3
    ss = torch.where(small, torch.ones_like(s), s)
    taylor = 1.0 / 180.0 + s * (-1.0 / 3360.0 + s * (1.0 / 151200.0))
    exact = (cos_sin_sq(ss) - 4.0 * sin_cubed_sq(ss)) / (2.0 * ss)
    return torch.where(small, taylor, exact)


def _function(name, value, derivative):
    """An autograd Function computing ``value(s)`` (or ``value(x)``) whose
    backward and forward-mode rules multiply by ``derivative(s)``."""

    class _Ratio(torch.autograd.Function):
        generate_vmap_rule = True  # torch.func transforms (jacfwd, vmap)

        @staticmethod
        def forward(s):
            return value(s)

        @staticmethod
        def setup_context(ctx, inputs, output):
            (s,) = inputs
            ctx.save_for_backward(s)
            ctx.save_for_forward(s)

        @staticmethod
        def backward(ctx, grad):
            (s,) = ctx.saved_tensors
            return grad * derivative(s)

        @staticmethod
        def jvp(ctx, tangent):
            (s,) = ctx.saved_tensors
            return tangent * derivative(s)

    _Ratio.__name__ = _Ratio.__qualname__ = name
    return _Ratio


_SincSq = _function("SincSq", _sinc_sq, lambda s: 0.5 * cos_sin_sq(s))
_CosSinSq = _function("CosSinSq", _cos_sin_sq, _d_cos_sin_sq)
_OneMinusCosSq = _function(
    "OneMinusCosSq", _one_minus_cos_sq, lambda s: 0.5 * sin_cubed_sq(s)
)
_SinCubedSq = _function("SinCubedSq", _sin_cubed_sq, _d_sin_cubed_sq)
_SinXOnX = _function("SinXOnX", _sin_x_on_x, lambda x: x * cos_x_on_x_squared_minus_sin_x_on_x_cubed(x))
_OneMinusCosX = _function(
    "OneMinusCosX", _one_minus_cos_x, lambda x: x * sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth(x)
)
_CosSinX = _function("CosSinX", _cos_sin_x, _d_cos_sin_x)
_SinCubedX = _function("SinCubedX", _sin_cubed_x, _d_sin_cubed_x)


def sin_x_on_x(x: torch.Tensor) -> torch.Tensor:
    """``sin(x) / x`` with its removable singularity at 0 (1)."""
    return _SinXOnX.apply(x)


def one_minus_cos_x_on_x_squared(x: torch.Tensor) -> torch.Tensor:
    """``(1 - cos(x)) / x^2``; 1/2 at 0."""
    return _OneMinusCosX.apply(x)


def cos_x_on_x_squared_minus_sin_x_on_x_cubed(x: torch.Tensor) -> torch.Tensor:
    """``cos(x)/x^2 - sin(x)/x^3``, which is ``(1/x) d/dx [sin(x)/x]``;
    -1/3 at 0."""
    return _CosSinX.apply(x)


def sin_x_on_x_cubed_minus_two_one_minus_cos_x_on_x_fourth(x: torch.Tensor) -> torch.Tensor:
    """``sin(x)/x^3 - 2 (1 - cos(x))/x^4``, which is ``(1/x) d/dx [(1 -
    cos x)/x^2]``; -1/12 at 0."""
    return _SinCubedX.apply(x)


def sinc_sq(s: torch.Tensor) -> torch.Tensor:
    """``sin(sqrt(s)) / sqrt(s)`` as a smooth function of ``s = x^2 >= 0``."""
    return _SincSq.apply(s)


def cos_sin_sq(s: torch.Tensor) -> torch.Tensor:
    """``cos(x)/x^2 - sin(x)/x^3`` with ``x = sqrt(s)``."""
    return _CosSinSq.apply(s)


def one_minus_cos_sq(s: torch.Tensor) -> torch.Tensor:
    """``(1 - cos(x)) / x^2`` with ``x = sqrt(s)``."""
    return _OneMinusCosSq.apply(s)


def sin_cubed_sq(s: torch.Tensor) -> torch.Tensor:
    """``sin(x)/x^3 - 2 (1 - cos(x))/x^4`` with ``x = sqrt(s)``."""
    return _SinCubedSq.apply(s)


def cos_from_sq(s: torch.Tensor) -> torch.Tensor:
    """``cos(sqrt(s))`` as a smooth function of ``s``: ``1 - s * (1-cos)/x^2``."""
    return 1.0 - s * one_minus_cos_sq(s)
