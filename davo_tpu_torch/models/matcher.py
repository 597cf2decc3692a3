"""Attention-based feature matching (the port of
``davo_tpu/models/matcher.py``, eval mode).

An attention head regresses, for each feature in view A, the
attention-weighted coordinates of its match in view B: queries come from
view A's descriptors, keys and values from view B (values are B's point
coordinates).  The eval path runs kernel K3 through
:func:`davo_tpu_torch.ops.attention.match_attention`; with
``return_confidence`` the weights are materialised by a plain softmax so
that their row maxima can be returned, as in the JAX module.  The
attention-weight dropout of the JAX module acts only in training, and
comes with the front end's training slice.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from davo_tpu_torch.ops.attention import match_attention
from davo_tpu_torch.types import FeaturePoints, MatchedPoints

__all__ = ["FeatureMatchModule", "NFoldMatcherModule"]


class FeatureMatchModule(nn.Module):
    """Match two views' features with scaled dot-product attention.

    :param descriptor_size: dimension of the input descriptors.
    :param embedding_size: dimension of the learned key/query projections
        (defaults to ``descriptor_size``).
    """

    def __init__(self, descriptor_size: int, embedding_size: Optional[int] = None):
        super().__init__()
        embed = embedding_size or max(descriptor_size, 1)
        self.embedding_size = embed
        self.query = nn.Linear(descriptor_size, embed)
        self.key = nn.Linear(descriptor_size, embed)

    def forward(
        self,
        features_a: FeaturePoints,
        features_b: FeaturePoints,
        *,
        return_confidence: bool = False,
    ):
        """:param return_confidence: also return the peak attention weight
        per query, ``(MatchedPoints, confidence (..., Q))``, through the
        plain softmax (K3 does not materialise the weights).
        """
        if self.training:
            raise NotImplementedError(
                "the matcher's training forward (dropout, gradients) is ported with "
                "train/frontend.py's training step in a later slice of the port"
            )
        query = self.query(features_a.descriptors)
        key = self.key(features_b.descriptors)
        if not return_confidence:
            matched = match_attention(query, key, features_b.points)
            return MatchedPoints(points_a=features_a.points, points_b=matched)
        logits = torch.einsum("...qd,...kd->...qk", query, key) / math.sqrt(self.embedding_size)
        weights = torch.softmax(logits, dim=-1)
        matched = torch.einsum("...qk,...kc->...qc", weights, features_b.points)
        return MatchedPoints(points_a=features_a.points, points_b=matched), torch.amax(weights, dim=-1)


class NFoldMatcherModule(nn.Module):
    """Match one anchor view against N-1 other views with shared attention
    weights."""

    def __init__(self, descriptor_size: int, embedding_size: Optional[int] = None):
        super().__init__()
        self.pairwise = FeatureMatchModule(descriptor_size, embedding_size)

    def forward(self, anchor: FeaturePoints, others: Sequence[FeaturePoints]) -> Sequence[MatchedPoints]:
        return [self.pairwise(anchor, other) for other in others]
