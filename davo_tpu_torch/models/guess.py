"""Initial-guess networks for the gauge-fixed pinhole BA objective (the
port of ``davo_tpu/models/guess.py``).

Each maps observed pixels ``(B, M, N, 2)`` to :class:`PinholeBAParams`
with an estimates dimension E.  Layers follow flax's conventions (see
:mod:`davo_tpu_torch.models.calibration_network`), and parameter names
are the flax modules' (``dense_1``, ``norm``, ``head``, ``attn_0``, ...),
so :func:`davo_tpu_torch.models.convert.gen1_state_dict` carries the JAX
package's weights across.

:class:`PinholeTransformerGuess`'s fixed pixel embedding is the first two
columns of the Q factor of a normal ``(D, D)`` draw; the JAX package draws
it from ``jax.random.key(0)``, which torch cannot reproduce, so the port
draws it from a CPU generator seeded 0 and takes the JAX package's
matrix as ``pixel_projection`` where a JAX-trained network is loaded.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from davo_tpu_torch.camera.pinhole_ba import PinholeBAParams

from .calibration_network import _EMBEDDING_STD, _LAYER_NORM_EPS, _FlaxBatchNorm, _gelu, _SelfAttention

__all__ = [
    "num_guess_parameters",
    "guess_vector_to_params",
    "PinholeMLPGuess",
    "PinholeTransformerGuess",
    "PinholeFixedGuess",
]


def num_guess_parameters(num_views: int, num_points: int) -> int:
    """The guess head's output size ``3 + 6 M + 2 (N - 2) + (N - 3)``."""
    return 3 + 6 * num_views + 2 * (num_points - 2) + (num_points - 3)


def guess_vector_to_params(x: torch.Tensor, num_views: int, num_points: int) -> PinholeBAParams:
    """Unpack ``(..., G)`` guess vectors laid out as ``[f, cx, cy,
    orientation (3 M), translation (3 M), z (N - 3), xy (2 (N - 2))]``; the
    first free world point's z is gauge-fixed to 0."""
    m, n = num_views, num_points
    expected = num_guess_parameters(m, n)
    if x.shape[-1] != expected:
        raise ValueError(f"Guess vector must have {expected} entries for M={m}, N={n}; got {x.shape[-1]}")
    batch = tuple(x.shape[:-1])
    o_end = 3 + 3 * m
    t_end = o_end + 3 * m
    z_end = t_end + (n - 3)
    orientation = x[..., 3:o_end].reshape(batch + (m, 3))
    translation = x[..., o_end:t_end].reshape(batch + (m, 3))
    z = torch.cat([torch.zeros(batch + (1,), dtype=x.dtype, device=x.device), x[..., t_end:z_end]], dim=-1)
    xy = x[..., z_end:].reshape(batch + (n - 2, 2))
    return PinholeBAParams(
        focal_length=x[..., 0],
        cx=x[..., 1],
        cy=x[..., 2],
        translation=translation,
        orientation=orientation,
        world_points=torch.cat([xy, z[..., None]], dim=-1),
    )


class PinholeMLPGuess(nn.Module):
    """Linear / GELU / BatchNorm (no scale, no bias) / Linear, one estimate
    (E = 1); hidden ``8 M N`` unless ``num_hidden > 0``."""

    def __init__(self, num_views: int, num_points: int, num_hidden: int = -1):
        super().__init__()
        self.num_views, self.num_points = num_views, num_points
        hidden = num_hidden if num_hidden > 0 else 8 * num_views * num_points
        self.dense_1 = nn.Linear(2 * num_views * num_points, hidden)
        self.norm = _FlaxBatchNorm(hidden, affine=False)
        self.head = nn.Linear(hidden, num_guess_parameters(num_views, num_points))

    def forward(self, projected_points, visibility_mask, training: bool = False) -> PinholeBAParams:
        x = projected_points.reshape(projected_points.shape[0], -1)
        x = self.norm(_gelu(self.dense_1(x)), training)
        return guess_vector_to_params(self.head(x)[:, None, :], self.num_views, self.num_points)


class PinholeTransformerGuess(nn.Module):
    """Transformer guess head emitting E parallel estimates: pixels through
    a fixed orthonormal 2 -> D projection plus learned view and point
    embeddings, gated by visibility, after ``num_estimates`` learned
    estimate tokens; pre-LN encoder layers; each estimate token regresses
    a guess vector."""

    flax_normal_parameters = (
        ("view_embedding", _EMBEDDING_STD),
        ("point_embedding", _EMBEDDING_STD),
        ("estimate_tokens", _EMBEDDING_STD),
    )

    def __init__(
        self,
        num_views: int,
        num_points: int,
        num_estimates: int = 4,
        embed_dim: int = 64,
        num_layers: int = 2,
        num_heads: int = 4,
        pixel_projection: Optional[torch.Tensor] = None,
    ):
        super().__init__()
        m, n, d = num_views, num_points, embed_dim
        self.num_views, self.num_points, self.num_estimates, self.num_layers = m, n, num_estimates, num_layers
        if pixel_projection is None:
            draw = torch.randn(d, d, generator=torch.Generator("cpu").manual_seed(0), dtype=torch.float64)
            pixel_projection = torch.linalg.qr(draw)[0][:, :2]
        self.register_buffer("pixel_projection", torch.as_tensor(pixel_projection).clone(), persistent=False)
        self.view_embedding = nn.Parameter(torch.zeros(m, 1, d))
        self.point_embedding = nn.Parameter(torch.zeros(1, n, d))
        self.estimate_tokens = nn.Parameter(torch.zeros(num_estimates, d))
        for i in range(num_layers):
            self.add_module(f"ln_a_{i}", nn.LayerNorm(d, eps=_LAYER_NORM_EPS))
            self.add_module(f"attn_{i}", _SelfAttention(d, num_heads))
            self.add_module(f"ln_m_{i}", nn.LayerNorm(d, eps=_LAYER_NORM_EPS))
            self.add_module(f"mlp_in_{i}", nn.Linear(d, 4 * d))
            self.add_module(f"mlp_out_{i}", nn.Linear(4 * d, d))
        self.head = nn.Linear(d, num_guess_parameters(m, n))

    def forward(self, projected_points, visibility_mask, training: bool = False) -> PinholeBAParams:
        b = projected_points.shape[0]
        m, n = self.num_views, self.num_points
        projection = self.pixel_projection.to(projected_points.dtype)
        tokens = torch.einsum("bmnc,dc->bmnd", projected_points, projection)
        tokens = tokens + self.view_embedding + self.point_embedding
        tokens = tokens * visibility_mask.to(tokens.dtype).reshape(b, m, n, 1)
        tokens = tokens.reshape(b, m * n, -1)
        tokens = torch.cat([self.estimate_tokens.expand(b, -1, -1), tokens], dim=1)
        for i in range(self.num_layers):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            tokens = tokens + layer("attn")(layer("ln_a")(tokens))
            tokens = tokens + layer("mlp_out")(_gelu(layer("mlp_in")(layer("ln_m")(tokens))))
        x = self.head(tokens[:, : self.num_estimates, :])
        return guess_vector_to_params(x, m, n)


class PinholeFixedGuess(nn.Module):
    """A learnable constant guess shared by every scene (one estimate):
    focal length 1, principal point 0, orientations ``normal(1e-2)``,
    translations and world points ``[0, 0, initial_distance]``."""

    flax_normal_parameters = (("orientation", 1e-2),)

    def __init__(self, num_views: int, num_points: int, initial_distance: float = 20.0):
        super().__init__()
        m, n = num_views, num_points
        far = torch.tensor([0.0, 0.0, initial_distance])
        self.focal_length = nn.Parameter(torch.ones(1))
        self.centre = nn.Parameter(torch.zeros(2))
        self.orientation = nn.Parameter(torch.zeros(m, 3))
        self.translation = nn.Parameter(far.repeat(m, 1))
        self.world_points = nn.Parameter(far.repeat(n - 2, 1))

    def forward(self, projected_points, visibility_mask, training: bool = False) -> PinholeBAParams:
        b = projected_points.shape[0]

        def tile(x):
            return x.expand((b, 1) + tuple(x.shape))

        return PinholeBAParams(
            focal_length=self.focal_length[0].expand(b, 1),
            cx=self.centre[0].expand(b, 1),
            cy=self.centre[1].expand(b, 1),
            translation=tile(self.translation),
            orientation=tile(self.orientation),
            world_points=tile(self.world_points),
        )
