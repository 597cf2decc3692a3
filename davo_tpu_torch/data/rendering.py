"""Synthetic image rendering for the visual front end (the port of
``davo_tpu/data/rendering.py``).

Each world point carries a random appearance vector (fixed per scene)
decoded into a localised pattern: an anisotropic Gaussian blob with a
per-point RGB colour and a radial cosine ripple.  Two views of the same
point render the same pattern at different image locations, which is
what makes matching learnable.  A low-frequency background (a
``background_cells``-square uniform grid, bilinearly upsampled as
``jax.image.resize`` does it) plus Gaussian pixel noise stop the
detector from keying on any non-zero pixel.

Random numbers are drawn by :func:`draw_appearance_noise` and
:func:`draw_frame_noise`; :func:`appearance_from_noise` and
:func:`render_frame` (given ``noise``) are deterministic, so a test can
feed them the JAX package's own draws.  Every function here takes any
number of leading batch dimensions.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch

from davo_tpu_torch.utils.device import resolve_device

__all__ = [
    "APPEARANCE_DIM",
    "RenderConfig",
    "draw_appearance_noise",
    "appearance_from_noise",
    "sample_appearance",
    "draw_frame_noise",
    "render_frame",
    "render_views",
    "render_views_nokey",
]

# appearance vector layout (per point):
#   [0:3]  colour direction (normalised to unit RGB intensity)
#   [3]    log-scale of the blob radius
#   [4]    orientation angle theta
#   [5]    eccentricity in [0, 1)
#   [6]    ripple frequency
#   [7]    ripple phase
APPEARANCE_DIM = 8


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Rendering hyper-parameters.  Images cover the pixel domain
    ``[-1, 1]^2`` (visibility == inside this square)."""

    image_size: int = 64
    channels: int = 3
    base_sigma: float = 0.045  # blob radius in [-1, 1] units
    scale_spread: float = 0.35  # log-scale std of per-point radii
    max_eccentricity: float = 0.7
    ripple_strength: float = 0.6
    background_cells: int = 4  # low-frequency background resolution
    background_strength: float = 0.15
    noise_std: float = 0.02
    dtype: torch.dtype = torch.float32


def _uniform(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """A unit-uniform draw moved to ``[low, high)`` as ``jax.random.uniform``
    does it."""
    return torch.clamp(u * (high - low) + low, min=low)


def draw_appearance_noise(
    generator: torch.Generator,
    shape: Sequence[int],
    num_points: int,
    config: RenderConfig,
    device: torch.device,
) -> Dict[str, torch.Tensor]:
    """The unit draws of ``shape`` scenes' appearance vectors."""
    prefix = tuple(shape) + (num_points,)

    def draw(fn, *tail):
        return fn(prefix + tail, generator=generator, device=device, dtype=config.dtype)

    return dict(
        colour=draw(torch.rand, 3),
        log_scale=draw(torch.randn, 1),
        theta=draw(torch.rand, 1),
        ecc=draw(torch.rand, 1),
        freq=draw(torch.rand, 1),
        phase=draw(torch.rand, 1),
    )


def appearance_from_noise(noise: Dict[str, torch.Tensor], config: RenderConfig) -> torch.Tensor:
    """``(..., N, APPEARANCE_DIM)`` appearance vectors from the draws of
    :func:`draw_appearance_noise`."""
    colour = _uniform(noise["colour"], 0.25, 1.0)
    colour = colour / torch.linalg.vector_norm(colour, dim=-1, keepdim=True)
    return torch.cat(
        [
            colour,
            config.scale_spread * noise["log_scale"],
            _uniform(noise["theta"], 0.0, math.pi),
            _uniform(noise["ecc"], 0.0, config.max_eccentricity),
            _uniform(noise["freq"], 2.0, 5.0),
            _uniform(noise["phase"], 0.0, 2.0 * math.pi),
        ],
        dim=-1,
    )


def sample_appearance(
    generator: torch.Generator,
    num_points: int,
    config: RenderConfig,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.Tensor:
    """``(N, APPEARANCE_DIM)`` random per-point appearance vectors."""
    device = resolve_device(device)
    return appearance_from_noise(draw_appearance_noise(generator, (), num_points, config, device), config)


def draw_frame_noise(
    generator: torch.Generator,
    shape: Sequence[int],
    config: RenderConfig,
    device: torch.device,
) -> Dict[str, torch.Tensor]:
    """Background cells (unit uniform) and pixel noise (standard normal)
    of ``shape`` frames."""
    cells, s, c = config.background_cells, config.image_size, config.channels
    prefix = tuple(shape)
    return dict(
        background=torch.rand(prefix + (cells, cells, c), generator=generator, device=device, dtype=config.dtype),
        pixels=torch.randn(prefix + (s, s, c), generator=generator, device=device, dtype=config.dtype),
    )


def _pixel_grid(config: RenderConfig, device: Optional[torch.device] = None):
    """``(H, W)`` u/v coordinate grids over ``[-1, 1]^2`` (pixel centres)."""
    s = config.image_size
    coords = (torch.arange(s, dtype=config.dtype, device=device) + 0.5) / s * 2.0 - 1.0
    vv, uu = torch.meshgrid(coords, coords, indexing="ij")
    return uu, vv


def _bilinear_weights(in_size: int, out_size: int, dtype: torch.dtype, device) -> torch.Tensor:
    """``(out, in)`` weights of ``jax.image.resize(method="bilinear")``
    along one axis: the triangle kernel at half-pixel sample positions,
    normalised per output sample (so the edges clamp), computed in float64
    as JAX computes them."""
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) * inv_scale - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float64)[:, None]) / kernel_scale
    weights = np.maximum(0.0, 1.0 - x)
    total = weights.sum(axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, 1.0),
        0.0,
    )
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, 0.0)
    return torch.tensor(weights.T, dtype=dtype, device=device)


def render_frame(
    projections: torch.Tensor,
    visibility: torch.Tensor,
    appearance: torch.Tensor,
    config: RenderConfig,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Render views: each visible point becomes its appearance pattern at
    its projected location.

    :param projections: ``(..., N, 2)`` pixel coordinates in ``[-1, 1]``
        (out-of-bounds points simply render outside the image).
    :param visibility: ``(..., N)`` bool/float — invisible points render
        nothing.
    :param appearance: ``(..., N, APPEARANCE_DIM)`` (shared across the
        views of one scene; broadcast against ``projections``).
    :param noise: optional draws of :func:`draw_frame_noise` — adds the
        background and the pixel noise.
    :return: ``(..., H, W, channels)`` images.
    """
    dtype = projections.dtype
    uu, vv = _pixel_grid(config, projections.device)  # (H, W)

    def per_point(x):  # (..., N) -> (..., 1, 1, N)
        return x[..., None, None, :]

    du = uu[..., None] - per_point(projections[..., 0])  # (..., H, W, N)
    dv = vv[..., None] - per_point(projections[..., 1])

    colour = appearance[..., 0:3]  # (..., N, 3)
    sigma = per_point(config.base_sigma * torch.exp(appearance[..., 3]))
    theta = per_point(appearance[..., 4])
    ecc = per_point(appearance[..., 5])
    freq = per_point(appearance[..., 6])
    phase = per_point(appearance[..., 7])

    # rotate offsets into the blob's principal frame; squash the minor axis
    ct, st = torch.cos(theta), torch.sin(theta)
    major = du * ct + dv * st
    minor = -du * st + dv * ct
    inv_minor_sq = 1.0 / torch.square(1.0 - ecc)
    r_sq = (torch.square(major) + torch.square(minor) * inv_minor_sq) / torch.square(sigma)
    envelope = torch.exp(-0.5 * r_sq)
    ripple = 1.0 + config.ripple_strength * torch.cos(freq * torch.sqrt(r_sq + 1e-12) + phase)
    intensity = envelope * ripple * per_point(visibility.to(dtype))  # (..., H, W, N)
    image = torch.einsum("...hwn,...nc->...hwc", intensity, colour)
    if config.channels != 3:
        image = torch.mean(image, dim=-1, keepdim=True).expand(*image.shape[:-1], config.channels)

    if noise is not None:
        weights = _bilinear_weights(config.background_cells, config.image_size, dtype, projections.device)
        background = torch.einsum("hi,...ijc,wj->...hwc", weights, noise["background"], weights)
        image = image + config.background_strength * background
        image = image + config.noise_std * noise["pixels"]
    return image


def render_views(
    projections: torch.Tensor,
    visibility: torch.Tensor,
    appearance: torch.Tensor,
    config: RenderConfig,
    noise: Optional[Dict[str, torch.Tensor]] = None,
) -> torch.Tensor:
    """Render a stack of views of one scene (shared appearance).

    :param projections: ``(M, N, 2)``; :param visibility: ``(M, N)``;
    :param appearance: ``(N, APPEARANCE_DIM)``; :param noise: draws of
        :func:`draw_frame_noise` for ``M`` frames, or None.
    :return: ``(M, H, W, channels)``.
    """
    return render_frame(projections, visibility, appearance[None], config, noise)


def render_views_nokey(
    projections: torch.Tensor,
    visibility: torch.Tensor,
    appearance: torch.Tensor,
    config: RenderConfig,
) -> torch.Tensor:
    """:func:`render_views` without background/noise (deterministic)."""
    return render_views(projections, visibility, appearance, config, None)
