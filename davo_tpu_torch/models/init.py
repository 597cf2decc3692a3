"""Kaiming (He) weight initialisation (the port of
``davo_tpu/models/init.py``): flax's ``he_normal`` (a normal truncated at
two standard deviations, variance ``2 / fan_in``) and ``he_uniform``
(``U(-sqrt(6 / fan_in), sqrt(6 / fan_in))``), with ``fan_in`` the input
width of a ``Linear`` weight ``(out, in)``."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

__all__ = ["kaiming_normal_init", "kaiming_uniform_init", "dense_kaiming"]

# flax truncated_normal's rescale to unit variance after the cut at +-2
_TRUNCATED_NORMAL_STD = 0.87962566103423978


@torch.no_grad()
def kaiming_normal_init(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``weight`` in place from flax's ``he_normal`` (drawn in float64
    on the CPU by ``generator``, then copied)."""
    std = math.sqrt(2.0 / weight[0].numel()) / _TRUNCATED_NORMAL_STD
    draw = torch.empty(weight.shape, dtype=torch.float64)
    nn.init.trunc_normal_(draw, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    return weight.copy_(draw)


@torch.no_grad()
def kaiming_uniform_init(weight: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Fill ``weight`` in place from flax's ``he_uniform``."""
    limit = math.sqrt(6.0 / weight[0].numel())
    draw = torch.empty(weight.shape, dtype=torch.float64).uniform_(-limit, limit, generator=generator)
    return weight.copy_(draw)


def dense_kaiming(
    in_features: int, features: int, *, uniform: bool = False, generator: Optional[torch.Generator] = None
) -> nn.Linear:
    """A ``Linear`` layer with Kaiming weights and a zero bias."""
    layer = nn.Linear(in_features, features)
    (kaiming_uniform_init if uniform else kaiming_normal_init)(layer.weight, generator)
    with torch.no_grad():
        layer.bias.zero_()
    return layer
