"""Sweep the BFGS update kernels: K1 and its tuning variants K1′.

    python -m davo_tpu_torch.scripts.tune_bfgs_kernel

The nine cases of the JAX script (``scripts/tune_bfgs_kernel.py``, ``main``):
the shipped kernel K1 (``broadcast`` there: the shipped Pallas kernel), and
the ``rowloop`` and ``rowloop2`` orderings of K1′, over the TPU's batch
blocks 128, 256 and 512 (here 16, 32 and 64 elements per block, 8 threads
each; K1 has its own block, 16 elements, or 32 in bfloat16 at an even
batch, so its two bfloat16 cases time the same kernel twice) and H
stored float32 or bfloat16.  Isolated
H-update loop at B = 16,384 and P = 45: 20 iterations ``(h, v) <- (H+, v +
1e-9 d)`` with every element updating and neither the first nor the
second step's flags, timed by CUDA events as the slope between 5 and 1
repetitions (best of 3 each, after a warm-up).

Before it is timed, each case is checked once against its plain version
on random symmetric positive-definite H and curvature pairs (first,
second and later steps; normwise 1e-4, 1e-2 for bfloat16 H); a failure
raises.  One JSON line per case: ``kernel``, ``block`` (the JAX script's
``block_b``), ``elements_per_block``, ``h_dtype``, ``ms_per_20_iters``,
``GBps`` (the port's bytes: H read and written, 2 P^2 sizeof(H) B per
iteration) and the bound (the least bytes of the whole function at the
card's 3.35 TB/s).  On the CPU the cases run their plain versions, the
loops run once and no time is read.
"""

from __future__ import annotations

import json
import math
from typing import List, Optional, Union

import torch

from davo_tpu_torch.ops.bfgs_update import fused_bfgs_update_direction, reference_update_direction
from davo_tpu_torch.ops.bfgs_update_variants import (
    reference_rowloop,
    reference_rowloop2,
    rowloop2_update_direction,
    rowloop_update_direction,
)
from davo_tpu_torch.utils.device import resolve_device

from .check_fused_objective import device_name

__all__ = ["CASES", "KERNELS", "PEAK_BYTES_PER_S", "check_case", "main"]

P, ITERATIONS = 45, 20
SHORT, LONG, BEST_OF = 1, 5, 3
# H100 SXM published memory rate (NVIDIA data sheet)
PEAK_BYTES_PER_S = 3.35e12

# label -> (kernel, its plain version)
KERNELS = {
    "broadcast": (fused_bfgs_update_direction, reference_update_direction),
    "rowloop": (rowloop_update_direction, reference_rowloop),
    "rowloop2": (rowloop2_update_direction, reference_rowloop2),
}
# the JAX script's cases: (kernel, block_b, H storage type)
CASES = (
    ("broadcast", 128, torch.float32),
    ("rowloop", 128, torch.float32),
    ("rowloop2", 128, torch.float32),
    ("rowloop2", 256, torch.float32),
    ("broadcast", 128, torch.bfloat16),
    ("broadcast", 256, torch.bfloat16),
    ("rowloop2", 128, torch.bfloat16),
    ("rowloop2", 256, torch.bfloat16),
    ("rowloop2", 512, torch.bfloat16),
)


def _elements_per_block(label: str, block_b: int, h_dtype: torch.dtype, batch: int) -> int:
    """K1' as the case says; K1 by the rule of ``csrc/bfgs_update.cu``'s
    register route at P = 45: 16 threads along the batch, one element each,
    or a packed bfloat16 pair each where the batch is even (the script's
    carries are fresh, so aligned)."""
    if label != "broadcast":
        return block_b // 8
    return 32 if h_dtype == torch.bfloat16 and batch % 2 == 0 else 16


def _op(label: str, block_b: int):
    kernel = KERNELS[label][0]
    if label == "broadcast":
        return kernel
    elements = block_b // 8
    return lambda *args: kernel(*args, elements_per_block=elements)


def _normwise(actual, expected):
    diff = (actual.float() - expected.float()).abs().max().item()
    return diff, diff / max(1.0, expected.float().abs().max().item())


def check_case(label: str, block_b: int, h_dtype: torch.dtype, batch: int, device: torch.device) -> dict:
    """The case's kernel against its plain version (first, second and later
    steps) on random symmetric positive-definite H, curvature pairs with
    y.s > 0 except on 1/16 of the elements, and a mixed updating mask."""
    g = torch.Generator(device).manual_seed(batch + block_b)
    a = torch.randn(batch, P, P, generator=g, device=device) / math.sqrt(P)
    h = torch.eye(P, device=device) + a @ a.transpose(1, 2)
    s = 0.1 * torch.randn(batch, P, generator=g, device=device)
    c = torch.randn(batch, P, P, generator=g, device=device) / math.sqrt(P)
    y = torch.einsum("bij,bj->bi", torch.eye(P, device=device) + c @ c.transpose(1, 2), s)
    y[: batch // 16] = -s[: batch // 16] * torch.rand(batch // 16, P, generator=g, device=device)
    grad = torch.randn(batch, P, generator=g, device=device)
    updating = torch.rand(batch, generator=g, device=device) > 0.25
    h_t = h.permute(1, 2, 0).contiguous().to(h_dtype)
    del a, c, h
    op, plain = _op(label, block_b), KERNELS[label][1]
    h_tol = 1e-2 if h_dtype == torch.bfloat16 else 1e-4  # bfloat16: one rounding of the stored H
    worst = dict(max_abs_err=0.0, normwise_h=0.0, normwise_d=0.0)
    for first, second in ((True, False), (False, True), (False, False)):
        k_h, k_d = op(h_t, s, y, grad, updating, first, second)
        p_h, p_d = plain(h_t.permute(2, 0, 1).float(), s, y, grad, updating, first, second)
        (h_abs, h_rel), (d_abs, d_rel) = _normwise(k_h, p_h.permute(1, 2, 0).to(h_dtype)), _normwise(k_d, p_d)
        if not (h_rel <= h_tol and d_rel <= 1e-4):
            raise AssertionError(
                f"{label} block {block_b} {h_dtype} (first={first}, second={second}): "
                f"H normwise {h_rel} (tolerance {h_tol}), d normwise {d_rel} (tolerance 1e-4)"
            )
        worst = dict(
            max_abs_err=max(worst["max_abs_err"], h_abs, d_abs),
            normwise_h=max(worst["normwise_h"], h_rel), normwise_d=max(worst["normwise_d"], d_rel),
        )
    return dict(worst, tolerance_h=h_tol, tolerance_d=1e-4)


def _loop(op, h0, v, updating, repetitions):
    h, vv = h0, v
    for _ in range(repetitions * ITERATIONS):
        h, d = op(h, vv, vv, vv, updating, False, False)
        vv = torch.add(vv, d, alpha=1e-9)
    return vv.sum()


def _loop_ms(op, h0, v, updating, repetitions):
    _loop(op, h0, v, updating, repetitions)  # warm-up
    best = float("inf")
    for _ in range(BEST_OF):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        _loop(op, h0, v, updating, repetitions)
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def main(device: Optional[Union[str, torch.device]] = None, batch: int = 16384) -> List[dict]:
    """Check, then time, each case; print and return one line per case."""
    device = resolve_device(device)
    lines = []
    for label, block_b, h_dtype in CASES:
        check = check_case(label, block_b, h_dtype, batch, device)
        op = _op(label, block_b)
        h0 = torch.eye(P, device=device)[:, :, None].expand(P, P, batch).to(h_dtype).contiguous()
        v = torch.full((batch, P), 1e-2, device=device)
        updating = torch.ones(batch, dtype=torch.bool, device=device)
        h_bytes = torch.finfo(h_dtype).bits // 8
        bound_ms = ITERATIONS * batch * (2 * P * P * h_bytes + 4 * P * 4 + 1) / PEAK_BYTES_PER_S * 1e3
        if device.type == "cuda":
            ms = (_loop_ms(op, h0, v, updating, LONG) - _loop_ms(op, h0, v, updating, SHORT)) / (LONG - SHORT)
            gbps = 2 * P * P * h_bytes * batch * ITERATIONS / ms / 1e6
            share = bound_ms / ms
        else:
            _loop(op, h0, v, updating, SHORT)
            ms = gbps = share = "not measured"
        line = dict(
            kernel=label, block=block_b, elements_per_block=_elements_per_block(label, block_b, h_dtype, batch),
            h_dtype=str(h_dtype).replace("torch.", ""), ms_per_20_iters=ms, GBps=gbps,
            bound_ms_per_20_iters=bound_ms, bound_by="bytes", share_of_bound=share, check=check,
            device=device_name(device), batch=batch,
        )
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
