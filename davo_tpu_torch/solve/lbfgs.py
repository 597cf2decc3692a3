"""Batched limited-memory BFGS with the Wolfe line search (the port of
``davo_tpu/solve/lbfgs.py``).

Instead of the dense ``(B, P, P)`` inverse Hessian, L-BFGS keeps the last
``m`` ``(s, y)`` pairs and rebuilds ``-H g`` by the two-loop recursion
(Nocedal & Wright alg. 7.4).  The batching semantics are the JAX
package's, and those of :func:`davo_tpu_torch.solve.bfgs_solve`: the
batch advances in lockstep under an ``updating`` mask; an element stops
on ``error <= threshold`` or a step shorter than ``minimum_step``; the
history shifts for every element each step (frozen and skipped ones
too), and a pair that is skipped (``s.y <= 0``, the first step, or an
element no longer updating) enters as ``rho = 0``, an identity factor of
the recursion; the initial scale ``gamma = max((s.y) / max(y.y, 1e-5),
1e-4)`` is taken from the newest valid pair and kept where the pair was
skipped.  Two modes share the step:

* eval (``differentiable=False``): the value+gradient through the
  ``value_and_grad_fn`` hook (kernel K2 in the network) or autograd; the
  loop tests ``any(updating)`` on the host once per iteration and stops
  early; the result carries no gradient (the JAX package's zero-tangent
  ``custom_jvp``).  L-BFGS has no dense H, so kernel K1 never runs here.
* differentiable (``differentiable=True``, the default in training): a
  fixed unroll of the training iterations with the graph kept through the
  gradient (``create_graph=True``), the counterpart of the JAX package's
  ``lax.scan``; the line search stays detached.

Drop-path keep-masks come from a ``torch.Generator`` (``uniform > p``
once a step) or are injected, as in :func:`bfgs_solve`, whose loop
(:func:`~davo_tpu_torch.solve.bfgs.minimise`) runs here with the pair
history in place of the inverse Hessian.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import torch

from .bfgs import DirectionState, minimise

__all__ = ["LBFGSConfig", "lbfgs_solve"]


@dataclasses.dataclass(frozen=True)
class LBFGSConfig:
    """Hyper-parameters of :func:`lbfgs_solve`; the line-search and stopping
    fields mean what they mean in :class:`davo_tpu_torch.solve.BFGSConfig`."""

    history: int = 10
    sufficient_decrease: float = 1e-4
    curvature: float = 0.9
    error_threshold: float = 1e-4
    iterations: int = 1000
    minimum_step: float = 1e-8
    drop_path_p: float = 0.1
    return_second_last: bool = False
    training_iterations: Optional[int] = None
    training_error_threshold: Optional[float] = None
    line_search_iterations: int = 1000
    max_step_size: Optional[float] = None
    zoom_method: str = "bisection"
    strong: bool = True
    max_step_distance: Optional[float] = None
    min_step_distance: Optional[float] = None

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


TensorSeq = Union[torch.Tensor, Sequence[torch.Tensor]]


def _two_loop_direction(
    gradient: torch.Tensor,
    s_hist: TensorSeq,
    y_hist: TensorSeq,
    rho_hist: TensorSeq,
    gamma: torch.Tensor,
    history: int,
) -> torch.Tensor:
    """``-H g`` by the two-loop recursion over a shift-ordered history.

    :param gradient: ``(B..., P)``.
    :param s_hist, y_hist: ``m`` entries of ``(B..., P)`` (a stacked
        ``(m, B..., P)`` tensor or a list), the oldest pair at index 0.
    :param rho_hist: ``m`` entries of ``(B...,)``: ``1 / (y.s)``, or 0 for
        an empty or skipped slot (an identity factor).
    :param gamma: ``(B..., 1)``, the initial inverse-Hessian scale.
    """
    q = gradient
    alphas = []
    for i in range(history - 1, -1, -1):  # newest to oldest
        alpha = rho_hist[i] * torch.sum(s_hist[i] * q, dim=-1)
        q = q - alpha[..., None] * y_hist[i]
        alphas.append(alpha)
    q = gamma * q
    for i in range(history):
        beta = rho_hist[i] * torch.sum(y_hist[i] * q, dim=-1)
        q = q + (alphas[history - 1 - i] - beta)[..., None] * s_hist[i]
    return -q


def lbfgs_solve(
    error_function: Callable[[torch.Tensor], torch.Tensor],
    parameters: torch.Tensor,
    config: LBFGSConfig = LBFGSConfig(),
    *,
    training: bool = False,
    differentiable: Optional[bool] = None,
    generator: Optional[torch.Generator] = None,
    keep_masks: Optional[torch.Tensor] = None,
    value_and_grad_fn: Optional[Callable] = None,
    direction_fn: Optional[Callable] = None,
) -> torch.Tensor:
    """Minimise ``error_function`` independently for every batch element
    with limited-memory BFGS; the contract of :func:`bfgs_solve`.

    :param error_function: maps ``(B..., P) -> (B...,)``; the line search
        probes it.
    :param parameters: ``(B..., P)`` initial iterates (solved on the ``(B,
        P)`` flattening of the leading dimensions, as :func:`bfgs_solve`).
    :param training: the training iteration and threshold budgets,
        drop-path and ``return_second_last``.
    :param differentiable: keep the graph through a fixed-length unroll;
        defaults to ``training``.
    :param generator: draws the drop-path keep-masks.
    :param keep_masks: ``(iterations, B...)`` keep-masks instead of the draws.
    :param value_and_grad_fn: optional ``params -> (error, gradient)``
        replacing autograd (kernel K2 in the network's eval solve).
    :param direction_fn: optional ``(direction, params, error, step_idx)
        -> direction`` applied after the clamp.
    :return: ``(B..., P)``; in the eval mode without a gradient.
    """
    return minimise(
        _LBFGSDirection, error_function, parameters, config, training=training,
        differentiable=training if differentiable is None else differentiable, generator=generator,
        keep_masks=keep_masks, value_and_grad_fn=value_and_grad_fn, direction_fn=direction_fn,
    )


class _LBFGSDirection(DirectionState):
    """The shift-ordered pair history, the newest pair last (lists: a shift
    is a pop and an append, not a copy of the whole history), and the
    initial scale gamma."""

    def __init__(self, config, params, differentiable):
        super().__init__(config)
        batch = params.shape[0]
        m = config.history
        self.s_hist = [torch.zeros_like(params) for _ in range(m)]
        self.y_hist = [torch.zeros_like(params) for _ in range(m)]
        self.rho_hist = [torch.zeros(batch, dtype=params.dtype, device=params.device) for _ in range(m)]
        self.gamma = torch.ones(batch, 1, dtype=params.dtype, device=params.device)

    def direction(self, step, delta_gradient, gradient, updating, step_idx):
        # the pair of the previous step enters the history
        curvature = torch.sum(step * delta_gradient, dim=-1)
        pair_valid = (curvature > 0.0) & updating if step_idx > 0 else torch.zeros_like(updating)
        rho_new = torch.where(pair_valid, 1.0 / torch.where(pair_valid, curvature, torch.ones_like(curvature)), 0.0)
        write = pair_valid[:, None]
        self.s_hist = self.s_hist[1:] + [torch.where(write, step, 0.0)]
        self.y_hist = self.y_hist[1:] + [torch.where(write, delta_gradient, 0.0)]
        self.rho_hist = self.rho_hist[1:] + [rho_new]
        y_sq = torch.clamp(torch.sum(torch.square(delta_gradient), dim=-1, keepdim=True), min=1e-5)
        self.gamma = torch.where(write, torch.clamp(curvature[:, None] / y_sq, min=1e-4), self.gamma)
        if step_idx == 0:
            return -gradient
        return _two_loop_direction(gradient, self.s_hist, self.y_hist, self.rho_hist, self.gamma, self.config.history)
