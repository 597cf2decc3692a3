"""Tuning variants of the fused BFGS update + direction — kernel K1′ and
its plain versions.

The port of the two Pallas kernels of ``scripts/tune_bfgs_kernel.py``
(``rowloop_kernel`` and ``rowloop2_kernel``, built by ``build``), which
order the N&W eq. 6.20 rescale of the inverse-Hessian carry differently:

* ``rowloop`` multiplies each raw row of H by the scale before the pass-1
  reductions ``H y`` and ``yᵀ H``;
* ``rowloop2`` reduces the raw rows and scales the two reduced vectors
  once (the ordering of the shipped K1, :mod:`.bfgs_update`).

Both reduce ``yᵀ H`` over the rows on their own rather than take it from
``H y`` by symmetry, so they hold on a carry that is not exactly symmetric
(the solver's drifts by rounding; K1 takes the shortcut).  They agree in
exact arithmetic and round differently in float32.

One CUDA kernel (``csrc/bfgs_update_variants.cu``) is templated on the
ordering and on the storage type of H (float32 or bfloat16).  It is K1's
register route: a thread holds one row of H of one element (or of a
bfloat16 pair) in registers, so each entry is read from device memory
once, and yᵀH is summed over the rows through shared memory in row order,
the TPU kernels' own.  Layouts are K1's: channel-major ``(P, P, B)`` H,
batch-major ``(B, P)`` vectors, P ≤ 48.  ``elements_per_block`` (16, 32 or
64, the counterparts of the TPU sweep's ``block_b`` 128, 256 and 512) is
the elements one block walks in register tiles (16 elements, or 32 in
packed bfloat16 pairs), one after another: float32 1, 2 or 4 tiles;
bfloat16 16 one tile of single elements, 32 and 64 one or two tiles of
pairs (where the batch is even and the carries 4-byte aligned; else 2 or
4 tiles of single elements).

:func:`rowloop_update_direction` and :func:`rowloop2_update_direction`
launch the kernel for CUDA tensors and run their plain versions
(:func:`reference_rowloop`, :func:`reference_rowloop2`) for CPU tensors.
"""

from __future__ import annotations

from typing import Tuple

import torch

from . import build
from .bfgs_update import channel_major_plain, check_kernel_inputs

__all__ = [
    "ELEMENTS_PER_BLOCK",
    "reference_rowloop",
    "reference_rowloop2",
    "rowloop_update_direction",
    "rowloop2_update_direction",
]

ELEMENTS_PER_BLOCK = (16, 32, 64)
_MAX_P = 48  # the kernel holds a row of H in a thread's registers


def _reference(scale_rows, h, step, delta_gradient, gradient, updating, is_first, is_second):
    curvature = torch.sum(step * delta_gradient, dim=-1)
    positive = curvature > 0.0
    inv_c = torch.where(positive, 1.0 / torch.where(positive, curvature, 1.0), 0.0)
    if is_second:
        y_sq = torch.clamp(torch.sum(delta_gradient * delta_gradient, dim=-1), min=1e-5)
        scale = torch.clamp(curvature / y_sq, min=1e-4)
    else:
        scale = torch.ones_like(curvature)
    if scale_rows:
        h_scaled = h * scale[:, None, None]
        hy = torch.einsum("bij,bj->bi", h_scaled, delta_gradient)
        yth = torch.einsum("bi,bij->bj", delta_gradient, h_scaled)
    else:
        hy = torch.einsum("bij,bj->bi", h, delta_gradient) * scale[:, None]
        yth = torch.einsum("bi,bij->bj", delta_gradient, h) * scale[:, None]
    yhy_on_c = torch.sum(yth * delta_gradient, dim=-1) * inv_c
    s_on_c = step * inv_c[:, None]
    common = (1.0 + yhy_on_c)[:, None] * step - yth
    applied = (updating & (not is_first)).to(h.dtype)[:, None, None]
    h_out = h * scale[:, None, None] + applied * (
        s_on_c[:, :, None] * common[:, None, :] - hy[:, :, None] * s_on_c[:, None, :]
    )
    if is_first:
        return h_out, -gradient
    return h_out, -torch.einsum("bij,bj->bi", h_out, gradient)


def reference_rowloop(
    h, step, delta_gradient, gradient, updating, is_first, is_second
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rowloop``, batch-major ``(B, P, P)``: each row of H scaled before
    the reductions.  Returns ``(H+, direction)``."""
    return _reference(True, h, step, delta_gradient, gradient, updating, is_first, is_second)


def reference_rowloop2(
    h, step, delta_gradient, gradient, updating, is_first, is_second
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rowloop2``, batch-major ``(B, P, P)``: the raw rows reduced, the
    reduced vectors scaled.  Returns ``(H+, direction)``."""
    return _reference(False, h, step, delta_gradient, gradient, updating, is_first, is_second)


def _variant(scale_rows, h_t, step, delta_gradient, gradient, updating, is_first, is_second, elements_per_block):
    b, p = step.shape
    if tuple(h_t.shape) != (p, p, b):
        raise ValueError(f"expected H of shape {(p, p, b)}, got {tuple(h_t.shape)}")
    if elements_per_block not in ELEMENTS_PER_BLOCK:
        raise ValueError(f"elements_per_block must be one of {ELEMENTS_PER_BLOCK}, got {elements_per_block}")
    if h_t.device.type == "cpu":
        plain = reference_rowloop if scale_rows else reference_rowloop2
        return channel_major_plain(plain, h_t, step, delta_gradient, gradient, updating, is_first, is_second)
    updating = check_kernel_inputs(h_t, step, delta_gradient, gradient, updating)
    if p > _MAX_P:
        raise ValueError(f"the K1' kernel takes P <= {_MAX_P}, got {p}")
    lib = build.load_library()
    h_out = torch.empty_like(h_t)
    direction = torch.empty(b, p, device=h_t.device, dtype=torch.float32)
    status = lib.davo_bfgs_update_variant(
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
        int(scale_rows),
        elements_per_block,
        torch.cuda.current_stream(h_t.device).cuda_stream,
    )
    name = "bfgs_update_rowloop" if scale_rows else "bfgs_update_rowloop2"
    build.check_launch(status, name)
    build.launch_counts[name] += 1
    return h_out, direction


def rowloop_update_direction(
    h_t, step, delta_gradient, gradient, updating, is_first, is_second, *, elements_per_block=16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's update in the ``rowloop`` ordering (kernel K1′).  Arguments and
    result as :func:`davo_tpu_torch.ops.fused_bfgs_update_direction`;
    ``elements_per_block`` is 16, 32 or 64."""
    return _variant(True, h_t, step, delta_gradient, gradient, updating, is_first, is_second, elements_per_block)


def rowloop2_update_direction(
    h_t, step, delta_gradient, gradient, updating, is_first, is_second, *, elements_per_block=16
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's update in the ``rowloop2`` ordering (kernel K1′).  Arguments and
    result as :func:`davo_tpu_torch.ops.fused_bfgs_update_direction`;
    ``elements_per_block`` is 16, 32 or 64."""
    return _variant(False, h_t, step, delta_gradient, gradient, updating, is_first, is_second, elements_per_block)
