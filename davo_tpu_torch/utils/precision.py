"""Matmul precision on the card (the port of ``davo_tpu/utils/precision.py``)."""

from __future__ import annotations

import torch

__all__ = ["full_f32_matmuls"]


def full_f32_matmuls() -> None:
    """Keep float32 matrix products and convolutions in full float32 on
    the card (TF32 off) — the counterpart of the JAX package's
    ``full_f32_matmuls``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
