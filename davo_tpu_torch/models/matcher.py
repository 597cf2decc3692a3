"""Attention-based feature matching (the port of
``davo_tpu/models/matcher.py``).

An attention head regresses, for each feature in view A, the
attention-weighted coordinates of its match in view B: queries come from
view A's descriptors, keys and values from view B (values are B's point
coordinates).  The eval path runs kernel K3 through
:func:`davo_tpu_torch.ops.attention.match_attention`.  In training, or
with ``return_confidence`` (whose row maxima need the weights), the
weights are materialised by the plain ``softmax(Q K^T / sqrt(e))``, as in
the JAX module: K3 is forward-only, as the Pallas kernel is.  In training
an inverted-dropout keep mask (keep probability ``1 - dropout``) scales
the weights; it is drawn from a ``torch.Generator`` or injected.
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
    :param dropout: attention-weight dropout probability in training.
    """

    def __init__(self, descriptor_size: int, embedding_size: Optional[int] = None, dropout: float = 0.05):
        super().__init__()
        embed = embedding_size or max(descriptor_size, 1)
        self.embedding_size = embed
        self.dropout = dropout
        self.query = nn.Linear(descriptor_size, embed)
        self.key = nn.Linear(descriptor_size, embed)

    def forward(
        self,
        features_a: FeaturePoints,
        features_b: FeaturePoints,
        *,
        training: bool = False,
        return_confidence: bool = False,
        generator: Optional[torch.Generator] = None,
        dropout_mask: Optional[torch.Tensor] = None,
    ):
        """:param training: the training route (dropout, a graph for the
            gradient), as the JAX module's ``training`` argument.
        :param return_confidence: also return the peak attention weight
            per query, ``(MatchedPoints, confidence (..., Q))``, through the
            plain softmax (K3 does not materialise the weights).
        :param generator: draws the training dropout's keep mask.
        :param dropout_mask: ``(..., Q, K)`` boolean keep mask instead of
            the generator's draw.
        """
        query = self.query(features_a.descriptors)
        key = self.key(features_b.descriptors)
        if not training and not return_confidence:
            matched = match_attention(query, key, features_b.points)
            return MatchedPoints(points_a=features_a.points, points_b=matched)
        logits = torch.einsum("...qd,...kd->...qk", query, key) / math.sqrt(self.embedding_size)
        weights = torch.softmax(logits, dim=-1)
        if training and self.dropout > 0.0:
            keep = dropout_mask
            if keep is None:
                keep = torch.rand(weights.shape, generator=generator, device=weights.device) < 1.0 - self.dropout
            weights = weights * keep.to(weights.dtype) / (1.0 - self.dropout)
        matched = torch.einsum("...qk,...kc->...qc", weights, features_b.points)
        result = MatchedPoints(points_a=features_a.points, points_b=matched)
        if return_confidence:
            return result, torch.amax(weights, dim=-1)
        return result


class NFoldMatcherModule(nn.Module):
    """Match one anchor view against N-1 other views with shared attention
    weights."""

    def __init__(self, descriptor_size: int, embedding_size: Optional[int] = None, dropout: float = 0.05):
        super().__init__()
        self.pairwise = FeatureMatchModule(descriptor_size, embedding_size, dropout)

    def forward(
        self, anchor: FeaturePoints, others: Sequence[FeaturePoints], *, training: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Sequence[MatchedPoints]:
        return [self.pairwise(anchor, other, training=training, generator=generator) for other in others]
