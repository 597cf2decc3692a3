"""Time the fused calibration objective kernels K2 and K4 beside torch
autodiff of the plain objective.

    python -m davo_tpu_torch.scripts.time_fused_objective

Four evaluations on the inputs of :mod:`.check_fused_objective` (16,384
scenes of 4 views x 8 points):

* torch value + gradient (``torch.autograd`` of ``calibration_error_fast``);
* K2, the fused value + gradient kernel;
* torch value + directional derivative (``torch.func.jvp``, the forward
  mode of the port's Wolfe probes);
* K4, the fused value + directional derivative kernel.

As in the JAX script, each is timed by a chain of dependent evaluations
(``q <- q + 1e-6 g``, the directional ones returning ``g = dphi d``),
chains of 33 and 1, the best of 3 of each after a warm-up, and the slope
per evaluation; here by CUDA events around each chain.  One JSON line per
evaluation.  On the CPU the chains run once each and no time is read.
"""

from __future__ import annotations

import json
from typing import Callable, List, Optional, Union

import torch

from davo_tpu_torch.utils.device import resolve_device

from .check_fused_objective import device_name, make_inputs

__all__ = ["chain", "slope_ms", "main"]

LONG, SHORT, BEST_OF = 33, 1, 3


def chain(fn: Callable, q0: torch.Tensor, length: int) -> torch.Tensor:
    """``length`` dependent evaluations of ``fn`` from ``q0``; returns a
    scalar that depends on all of them."""
    q, total = q0, torch.zeros_like(q0[:, 0])
    for _ in range(length):
        error, step = fn(q)
        q = q + 1e-6 * step
        total = total + error
    return q.sum() + total.sum()


def _chain_ms(fn, q0, length):
    chain(fn, q0, length)  # warm-up
    best = float("inf")
    for _ in range(BEST_OF):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain(fn, q0, length)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def slope_ms(fn: Callable, q0: torch.Tensor) -> Union[float, str]:
    """Milliseconds per evaluation: the slope between chains of 33 and 1.
    On the CPU the chains run once each and the time is not measured."""
    if q0.device.type != "cuda":
        chain(fn, q0, LONG)
        chain(fn, q0, SHORT)
        return "not measured"
    return (_chain_ms(fn, q0, LONG) - _chain_ms(fn, q0, SHORT)) / (LONG - SHORT)


def main(device: Optional[Union[str, torch.device]] = None, batch: int = 16384) -> List[dict]:
    """Print and return one timing line per evaluation."""
    device = resolve_device(device)
    inputs = make_inputs(device, batch)
    direction = inputs.direction

    def dd_as_vg(fn):
        def wrapped(q):
            error, dphi = fn(q, direction)
            return error, dphi[:, None] * direction

        return wrapped

    evaluations = (
        ("torch value+grad", inputs.torch_value_and_grad),
        ("K2 fused value+grad", inputs.kernel_value_and_grad),
        ("torch value+dirderiv", dd_as_vg(inputs.torch_value_and_dirderiv)),
        ("K4 fused value+dirderiv", dd_as_vg(inputs.kernel_value_and_dirderiv)),
    )
    lines = []
    for label, fn in evaluations:
        line = dict(evaluation=label, ms_per_eval=slope_ms(fn, inputs.guess), device=device_name(device), batch=batch)
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
