"""Fused BFGS inverse-Hessian update + search direction — kernel K1 and its
plain version.

The port of ``davo_tpu/ops/bfgs_update.py::fused_bfgs_update_direction``
(Pallas kernel ``_kernel``).  The inverse-Hessian carry is channel-major
``(P, P, B)``, so in the CUDA kernel (``csrc/bfgs_update.cu``, one thread
per batch element) neighbouring threads touch neighbouring addresses.
The carry may be stored float32 or bfloat16; the update arithmetic is
float32.  :func:`reference_update_direction` is the plain version: the
batch-major algebra of the solver's Hessian block.

:func:`fused_bfgs_update_direction` launches the kernel for CUDA tensors
and runs the plain version for CPU tensors; nothing else reaches the
plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build

__all__ = ["fused_bfgs_update_direction", "reference_update_direction"]


def reference_update_direction(
    h: torch.Tensor,
    step: torch.Tensor,
    delta_gradient: torch.Tensor,
    gradient: torch.Tensor,
    updating: torch.Tensor,
    is_first: bool,
    is_second: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Hessian/direction block of one solver step, batch-major
    ``(B, P, P)``: eq. 6.20 rescale on the second step, the guarded
    rank-2 update where ``updating`` holds (not on the first step), and
    the direction ``-H g`` (``-g`` on the first step)."""
    from davo_tpu_torch.solve.bfgs import (
        scale_initial_inverse_hessian,
        update_inverse_hessian,
    )

    if is_second:
        h = scale_initial_inverse_hessian(step, delta_gradient)[..., None] * h
    updated = h if is_first else update_inverse_hessian(h, step, delta_gradient)
    h_out = torch.where(updating[..., None, None], updated, h)
    if is_first:
        return h_out, -gradient
    return h_out, -torch.einsum("...ij,...j->...i", h_out, gradient)


def channel_major_plain(plain, h_t, step, delta_gradient, gradient, updating, is_first, is_second):
    """Run a batch-major plain version on a channel-major ``(P, P, B)``
    carry: the carry goes to ``(B, P, P)`` in the vectors' type and comes
    back in its storage type."""
    h_bm = h_t.permute(2, 0, 1).to(step.dtype)
    h_out, direction = plain(h_bm, step, delta_gradient, gradient, updating, is_first, is_second)
    return h_out.permute(1, 2, 0).to(h_t.dtype).contiguous(), direction


def check_kernel_inputs(h_t, step, delta_gradient, gradient, updating):
    """Raise unless a K1 kernel takes these tensors; returns the mask,
    contiguous."""
    b, p = step.shape
    if h_t.device.type != "cuda":
        raise ValueError(f"unsupported device {h_t.device}")
    if h_t.dtype not in (torch.float32, torch.bfloat16) or not h_t.is_contiguous():
        raise ValueError("H must be a contiguous float32 or bfloat16 tensor")
    for name, x in (("step", step), ("delta_gradient", delta_gradient), ("gradient", gradient)):
        if x.dtype != torch.float32 or x.device != h_t.device or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {h_t.device}")
        if tuple(x.shape) != (b, p):
            raise ValueError(f"{name} must have shape {(b, p)}, got {tuple(x.shape)}")
    if updating.dtype != torch.bool or tuple(updating.shape) != (b,) or updating.device != h_t.device:
        raise ValueError(f"updating must be a bool tensor of shape {(b,)} on {h_t.device}")
    return updating.contiguous()


def fused_bfgs_update_direction(
    h_t: torch.Tensor,
    step: torch.Tensor,
    delta_gradient: torch.Tensor,
    gradient: torch.Tensor,
    updating: torch.Tensor,
    is_first: bool,
    is_second: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Second-order state advance of one BFGS iteration (kernel K1).

    :param h_t: ``(P, P, B)`` channel-major inverse-Hessian carry,
        float32 or bfloat16 (symmetric, as the solver keeps it).
    :param step: ``(B, P)`` last parameter step ``s``.
    :param delta_gradient: ``(B, P)`` gradient change ``y``.
    :param gradient: ``(B, P)`` current gradient.
    :param updating: ``(B,)`` boolean active-set mask.
    :param is_first: first solver step (keep H, steepest descent).
    :param is_second: second step (apply the eq. 6.20 rescale).
    :return: ``(h_out_t (P, P, B), search_direction (B, P))``.
    """
    b, p = step.shape
    if tuple(h_t.shape) != (p, p, b):
        raise ValueError(f"expected H of shape {(p, p, b)}, got {tuple(h_t.shape)}")
    if h_t.device.type == "cpu":
        return channel_major_plain(
            reference_update_direction, h_t, step, delta_gradient, gradient, updating, is_first, is_second
        )
    updating = check_kernel_inputs(h_t, step, delta_gradient, gradient, updating)
    lib = build.load_library()
    h_out = torch.empty_like(h_t)
    direction = torch.empty(b, p, device=h_t.device, dtype=torch.float32)
    status = lib.davo_bfgs_update_direction(
        h_t.data_ptr(),
        h_out.data_ptr(),
        step.data_ptr(),
        delta_gradient.data_ptr(),
        gradient.data_ptr(),
        updating.data_ptr(),
        direction.data_ptr(),
        b,
        p,
        int(bool(is_first)),
        int(bool(is_second)),
        int(h_t.dtype == torch.bfloat16),
        torch.cuda.current_stream(h_t.device).cuda_stream,
    )
    build.check_launch(status, "bfgs_update")
    build.launch_counts["bfgs_update"] += 1
    return h_out, direction
