"""Masked online-softmax attention over feature descriptors — kernel K3
and its plain versions.

The port of ``davo_tpu/ops/attention.py``.  The matcher regresses match
coordinates as ``softmax(Q K^T / sqrt(D)) V``
(:mod:`davo_tpu_torch.models.matcher`); K3 (``csrc/match_attention.cu``)
computes it without materialising the ``(Q, K)`` score matrix in device
memory, with a key-validity mask: masked keys get exactly zero weight and
a query row with no valid key returns zeros.

* :func:`reference_flash_attention` is K3's plain version, with the
  kernel's semantics (the JAX package's ``_flash_kernel``);
* :func:`reference_attention` is the JAX package's ``_reference_attention``
  — on a row with no valid key it returns the mean of ``value``
  (softmax of an all-equal row is uniform);
* :func:`flash_match_attention` launches K3 for CUDA tensors and runs
  :func:`reference_flash_attention` for CPU tensors; nothing else reaches
  the plain version;
* :func:`match_attention` is the matcher's entry: K3 through
  :func:`flash_match_attention` for ``(B, Q, D)`` inputs, as the JAX
  package calls its Pallas kernel on its accelerator.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import build

__all__ = [
    "match_attention",
    "flash_match_attention",
    "reference_flash_attention",
    "reference_attention",
]

_NEG_INF = -1e30
MAX_DEPTH = 128  # D: descriptor width K3 takes
MAX_VALUE_WIDTH = 8  # C: value width K3 takes


def reference_attention(query, key, value, mask=None):
    """``softmax(QK^T/sqrt(D)) V`` with masked keys at a ``-1e30`` logit
    (the JAX package's ``_reference_attention``): a row with no valid key
    returns the mean of ``value``."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    logits = torch.einsum("...qd,...kd->...qk", query, key) * scale
    if mask is not None:
        logits = torch.where(mask[..., None, :], logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kc->...qc", weights, value)


def reference_flash_attention(query, key, value, mask=None):
    """K3's function in plain PyTorch: masked keys get exactly zero weight
    and a row with no valid key returns zeros (normaliser floored at
    1e-30), as the JAX package's ``_flash_kernel`` computes it."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    logits = torch.einsum("...qd,...kd->...qk", query, key) * scale
    if mask is None:
        mask = torch.ones(key.shape[:-1], dtype=torch.bool, device=key.device)
    valid = mask[..., None, :]
    logits = torch.where(valid, logits, _NEG_INF)
    peak = torch.amax(logits, dim=-1, keepdim=True)
    weights = torch.exp(logits - peak) * valid.to(logits.dtype)
    normaliser = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("...qk,...kc->...qc", weights, value) / normaliser


def flash_match_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Masked online-softmax attention (kernel K3 on the card).

    :param query: ``(B, Q, D)``, D <= 128.
    :param key: ``(B, K, D)``.
    :param value: ``(B, K, C)``, C <= 8.
    :param mask: optional ``(B, K)`` boolean key validity; invalid keys
        get zero weight, and rows with no valid key return zeros.
    :return: ``(B, Q, C)``.
    """
    if query.dim() != 3 or key.dim() != 3 or value.dim() != 3:
        raise ValueError("query, key and value must be 3-D (B, Q, D), (B, K, D), (B, K, C)")
    b, q_len, d = query.shape
    kv_len, c = key.shape[1], value.shape[2]
    if tuple(key.shape) != (b, kv_len, d) or tuple(value.shape) != (b, kv_len, c):
        raise ValueError(
            f"shapes do not agree: query {tuple(query.shape)}, key {tuple(key.shape)}, "
            f"value {tuple(value.shape)}"
        )
    if mask is not None and (mask.dtype != torch.bool or tuple(mask.shape) != (b, kv_len)):
        raise ValueError(f"mask must be a bool tensor of shape {(b, kv_len)}")
    if query.device.type == "cpu":
        return reference_flash_attention(query, key, value, mask)
    if query.device.type != "cuda":
        raise ValueError(f"unsupported device {query.device}")
    for name, x in (("query", query), ("key", key), ("value", value)):
        if x.dtype != torch.float32 or x.device != query.device:
            raise ValueError(f"{name} must be a float32 tensor on {query.device}")
    if not 0 < d <= MAX_DEPTH or not 0 < c <= MAX_VALUE_WIDTH:
        raise ValueError(f"K3 takes D <= {MAX_DEPTH} and C <= {MAX_VALUE_WIDTH}, got D={d}, C={c}")
    if mask is not None and mask.device != query.device:
        raise ValueError(f"mask must be on {query.device}")
    query, key, value = query.contiguous(), key.contiguous(), value.contiguous()
    mask = mask.contiguous() if mask is not None else None
    out = torch.empty(b, q_len, c, device=query.device, dtype=torch.float32)
    if b == 0 or q_len == 0:
        return out
    lib = build.load_library()
    status = lib.davo_match_attention(
        query.data_ptr(),
        key.data_ptr(),
        value.data_ptr(),
        mask.data_ptr() if mask is not None else None,
        out.data_ptr(),
        b,
        q_len,
        kv_len,
        d,
        c,
        torch.cuda.current_stream(query.device).cuda_stream,
    )
    build.check_launch(status, "match_attention")
    build.launch_counts["match_attention"] += 1
    return out


def match_attention(query, key, value, mask=None):
    """Descriptor-similarity attention: K3 for ``(B, Q, D)`` inputs (its
    plain version on the CPU), :func:`reference_attention` otherwise.

    Note the fully-masked-row caveat in :func:`flash_match_attention`.
    """
    if query.dim() == 3:
        return flash_match_attention(query, key, value, mask)
    return reference_attention(query, key, value, mask)
