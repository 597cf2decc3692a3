"""Check the fused calibration objective kernels K2 and K4 against torch
autodiff of the plain objective.

    python -m davo_tpu_torch.scripts.check_fused_objective

The inputs are the JAX script's (``scripts/check_fused_objective.py``):
16,384 scenes of 4 views x 8 points from :func:`generate_batch`, a guess of
0.1 N(0, 1) plus 1 on the focal parameter and on the points' depths, and
a N(0, 1) direction.  It prints one JSON line per kernel: the max |error|
and |gradient| difference of K2 (value + gradient) against
``torch.autograd`` of :func:`calibration_error_fast`, and the max |error|
and |dphi| difference of K4 (value + directional derivative) against
``torch.func.jvp`` of the same objective.  The kernels evaluate the
polynomial atan2 and the objective the exact one, so the differences are
that approximation plus float32 rounding.

The JAX script sweeps the Pallas grid's ``block_b`` (256, 512); K2 and K4
run one thread per element with a fixed block of 128 threads and take no
such parameter, so each kernel has one line.
"""

from __future__ import annotations

import json
from typing import List, Optional, Union

import torch

from davo_tpu_torch.camera import calibration_error_fast, num_calibration_parameters
from davo_tpu_torch.data import SceneConfig, generate_batch
from davo_tpu_torch.ops.calibration_obj import (
    calibration_value_and_dirderiv,
    calibration_value_and_grad,
)
from davo_tpu_torch.utils.device import resolve_device

__all__ = ["FusedObjectiveInputs", "make_inputs", "device_name", "main"]

M, N = 4, 8
P = num_calibration_parameters(M, N)


class FusedObjectiveInputs:
    """The JAX scripts' problem: scenes from seed 0, guess from seed 1,
    direction from seed 2 (torch generators on ``device``)."""

    def __init__(self, device: torch.device, batch: int):
        scenes = generate_batch(
            torch.Generator(device).manual_seed(0), batch, SceneConfig(num_views=M, num_points=N), device=device
        )
        guess = 0.1 * torch.randn(batch, P, generator=torch.Generator(device).manual_seed(1), device=device)
        guess[:, 0] += 1.0
        guess[:, 3 + 2 : 3 + 3 * N : 3] += 1.0
        self.guess = guess
        self.direction = torch.randn(batch, P, generator=torch.Generator(device).manual_seed(2), device=device)
        self.points = scenes.projected_points.float()
        self.visibility = scenes.visibility_mask.float()
        self.u_t = self.points[..., 0].permute(1, 2, 0).contiguous()
        self.v_t = self.points[..., 1].permute(1, 2, 0).contiguous()
        self.vis_t = self.visibility.permute(1, 2, 0).contiguous()

    def objective(self, params):
        return calibration_error_fast(params, self.points, self.visibility)

    def torch_value_and_grad(self, params):
        with torch.enable_grad():
            q = params.detach().requires_grad_(True)
            error = self.objective(q)
            (gradient,) = torch.autograd.grad(error.sum(), q)
        return error.detach(), gradient

    def torch_value_and_dirderiv(self, params, direction):
        return torch.func.jvp(self.objective, (params,), (direction,))

    def kernel_value_and_grad(self, params):
        return calibration_value_and_grad(params, self.u_t, self.v_t, self.vis_t)

    def kernel_value_and_dirderiv(self, params, direction):
        return calibration_value_and_dirderiv(params, direction, self.u_t, self.v_t, self.vis_t)


def make_inputs(device: torch.device, batch: int) -> FusedObjectiveInputs:
    return FusedObjectiveInputs(device, batch)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _max_abs(a, b) -> float:
    return (a - b).abs().max().item()


def main(device: Optional[Union[str, torch.device]] = None, batch: int = 16384) -> List[dict]:
    """Print and return one result line per kernel."""
    device = resolve_device(device)
    inputs = make_inputs(device, batch)
    err_k, grad_k = inputs.kernel_value_and_grad(inputs.guess)
    err_t, grad_t = inputs.torch_value_and_grad(inputs.guess)
    err_d, dphi_d = inputs.kernel_value_and_dirderiv(inputs.guess, inputs.direction)
    err_j, dphi_j = inputs.torch_value_and_dirderiv(inputs.guess, inputs.direction)
    common = dict(device=device_name(device), batch=batch, block="one thread per element (no block_b parameter)")
    lines = [
        dict(kernel="K2 calibration_value_and_grad", reference="torch.autograd of calibration_error_fast",
             max_abs_err_diff=_max_abs(err_k, err_t), max_abs_grad_diff=_max_abs(grad_k, grad_t),
             max_abs_grad=grad_t.abs().max().item(), **common),
        dict(kernel="K4 calibration_value_and_dirderiv", reference="torch.func.jvp of calibration_error_fast",
             max_abs_err_diff=_max_abs(err_d, err_j), max_abs_dphi_diff=_max_abs(dphi_d, dphi_j),
             max_abs_dphi=dphi_j.abs().max().item(), **common),
    ]
    for line in lines:
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()
