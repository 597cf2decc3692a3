"""Convolutional feature detector (U-Net) producing per-location feature
coordinates, descriptors and detection scores (the port of
``davo_tpu/models/detector.py``, eval mode).

The image is augmented with normalised u/v coordinate channels; a strided
encoder stack downsamples by 64 (96 px -> 2 cells); a bottleneck plus
skip-connected nearest-neighbour upsampling stages recover per-location
descriptors at 1/8 of the input resolution; a 3x3 head emits a bounded
coordinate offset and a detection logit per coarse cell.

The layers follow flax's conventions so converted JAX weights give the
same function:

* ``padding="SAME"`` pads ``(total // 2, total - total // 2)`` with
  ``total = max((ceil(n / s) - 1) s + k - n, 0)`` — asymmetric at stride
  2 on even sizes (96 -> 48 under a 7x7 kernel pads (2, 3); a 3x3 kernel
  pads (0, 1)), which ``Conv2d(padding=k // 2)`` does not reproduce, so
  every convolution pads explicitly;
* ``jax.image.resize(method="nearest")`` samples at half-pixel centres:
  torch's ``nearest-exact`` (2 -> 3 gives rows [0, 1, 1]);
* BatchNorm (epsilon 1e-5, running statistics) comes after the ReLU.

Tensors are NCHW inside the module; the public interface keeps the JAX
package's layout: images ``(B, H, W, C)``, features ``(B, K, .)`` with
the K = hc * wc cells flattened in (y, x) row-major order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from davo_tpu_torch.types import FeaturePoints

__all__ = [
    "UpscaleModule",
    "UpscaleWithSkipModule",
    "FeatureDetectionModule",
    "refine_points_centroid",
    "same_padding",
]

_BATCH_NORM_EPS = 1e-5  # flax nn.BatchNorm


def same_padding(size: int, kernel: int, stride: int):
    """flax/XLA ``SAME`` padding ``(low, high)`` of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class _SameConv(nn.Conv2d):
    """``nn.Conv2d`` with flax's ``SAME`` padding (explicit, per input size)."""

    def __init__(self, in_channels, out_channels, kernel, stride=1, bias=True):
        super().__init__(in_channels, out_channels, kernel, stride=stride, padding=0, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (kh, kw), (sh, sw) = self.kernel_size, self.stride
        top, bottom = same_padding(x.shape[-2], kh, sh)
        left, right = same_padding(x.shape[-1], kw, sw)
        return super().forward(F.pad(x, (left, right, top, bottom)))


def refine_points_centroid(
    images: torch.Tensor,
    points: torch.Tensor,
    *,
    iters: int = 2,
    radius_px: int = 4,
    weight_sigma_px: float = 2.0,
) -> torch.Tensor:
    """Subpixel keypoint refinement by local intensity centroid.

    Mean-shift of each detection to the background-subtracted (window
    median), Gaussian-windowed intensity centroid of a square window
    around it.  Pixel ``(y, x)``'s centre sits at ``((x + 0.5) / W * 2 - 1,
    (y + 0.5) / H * 2 - 1)``.

    :param images: ``(V, H, W, C)``.
    :param points: ``(V, K, 2)`` ``(u, v)`` coordinates in ``[-1, 1]``.
    :param iters: mean-shift iterations (the window re-centres each time).
    :param radius_px: half-width of the square refinement window.
    :param weight_sigma_px: Gaussian window sigma in pixels.
    :return: refined ``(V, K, 2)`` coordinates.
    """
    v, h, w, _ = images.shape
    k = points.shape[1]
    gray = torch.mean(images, dim=-1)  # (V, H, W)
    win = 2 * radius_px + 1
    offs = torch.arange(win, dtype=points.dtype, device=points.device) - radius_px
    oy, ox = torch.meshgrid(offs, offs, indexing="ij")
    gauss = torch.exp(-(torch.square(ox) + torch.square(oy)) / (2.0 * weight_sigma_px * weight_sigma_px))
    steps = torch.arange(win, device=points.device)
    view = torch.arange(v, device=points.device)[:, None, None, None]
    for _ in range(iters):
        x_pix = (points[..., 0] + 1.0) * 0.5 * w - 0.5
        y_pix = (points[..., 1] + 1.0) * 0.5 * h - 0.5
        cx = torch.clamp(torch.round(x_pix).to(torch.int64) - radius_px, 0, w - win)  # (V, K)
        cy = torch.clamp(torch.round(y_pix).to(torch.int64) - radius_px, 0, h - win)
        rows = (cy[..., None] + steps)[..., :, None]  # (V, K, win, 1)
        cols = (cx[..., None] + steps)[..., None, :]  # (V, K, 1, win)
        patch = gray[view, rows, cols]  # (V, K, win, win)
        median = torch.median(patch.reshape(v, k, -1), dim=-1).values  # odd count: the middle
        wgt = torch.clamp(patch - median[..., None, None], min=0.0) * gauss
        s = torch.sum(wgt, dim=(-2, -1)) + 1e-8
        mx = cx + radius_px + torch.sum(wgt * ox, dim=(-2, -1)) / s
        my = cy + radius_px + torch.sum(wgt * oy, dim=(-2, -1)) / s
        points = torch.stack([(mx + 0.5) / w * 2.0 - 1.0, (my + 0.5) / h * 2.0 - 1.0], dim=-1).to(points.dtype)
    return points


class UpscaleModule(nn.Module):
    """Nearest-neighbour upsample to a target spatial size + a bias-free
    smoothing conv (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3):
        super().__init__()
        self.smooth = _SameConv(in_channels, out_channels, kernel_size, bias=False)

    def forward(self, x: torch.Tensor, target_hw) -> torch.Tensor:
        x = F.interpolate(x, size=tuple(target_hw), mode="nearest-exact")
        return self.smooth(x)


class UpscaleWithSkipModule(nn.Module):
    """Upscale to the skip's size and add it (NCHW)."""

    def __init__(self, in_channels: int, skip_channels: int):
        super().__init__()
        self.upscale = UpscaleModule(in_channels, skip_channels)

    def forward(self, x: torch.Tensor, skip: torch.Tensor) -> torch.Tensor:
        return self.upscale(x, skip.shape[-2:]) + skip


class _ConvBlock(nn.Module):
    """Strided conv, ReLU, then BatchNorm (NCHW)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3, stride: int = 2):
        super().__init__()
        self.conv = _SameConv(in_channels, features, kernel, stride=stride)
        self.norm = nn.BatchNorm2d(features, eps=_BATCH_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(F.relu(self.conv(x)))


class FeatureDetectionModule(nn.Module):
    """U-Net feature detector.

    :param image_channels: channels of the input images (3 for RGB).
    :param descriptor_channels: channels of the output descriptors.
    :param max_offset_cells: bound of each cell's coordinate offset, in
        cell widths.
    """

    def __init__(self, image_channels: int = 3, descriptor_channels: int = 64, max_offset_cells: float = 1.5):
        super().__init__()
        d = descriptor_channels
        self.descriptor_channels = d
        self.max_offset_cells = max_offset_cells
        self.enc1_a = _ConvBlock(image_channels + 2, 8, kernel=7)
        self.enc1_b = _ConvBlock(8, 16)
        self.enc1_c = _ConvBlock(16, d + 2)
        self.enc2 = _ConvBlock(d, d)
        self.enc3 = _ConvBlock(d, d)
        self.enc4 = _ConvBlock(d, d)
        self.bottleneck = _SameConv(d, d, 3)
        self.up1 = UpscaleWithSkipModule(d, d)
        self.up2 = UpscaleWithSkipModule(d, d)
        self.up3 = UpscaleWithSkipModule(d, d)
        self.point_head = _SameConv(d + 2, 3, 3)

    def forward(self, image: torch.Tensor) -> FeaturePoints:
        """:param image: ``(B, H, W, C)``.
        :return: ``FeaturePoints`` with ``points (B, K, 2)``, ``descriptors
            (B, K, D)`` and ``scores (B, K)`` (detection logits)."""
        b, h, w, _ = image.shape
        dtype, device = image.dtype, image.device
        v = torch.linspace(-1.0, 1.0, h, dtype=dtype, device=device)
        u = torch.linspace(-1.0, 1.0, w, dtype=dtype, device=device)
        vv, uu = torch.meshgrid(v, u, indexing="ij")
        coords = torch.stack([uu, vv], dim=0).expand(b, 2, h, w)
        x = torch.cat([image.permute(0, 3, 1, 2), coords], dim=1)  # NCHW

        x = self.enc1_a(x)
        x = self.enc1_b(x)
        x = self.enc1_c(x)
        points_map, skip1 = x[:, 0:2], x[:, 2:]
        skip2 = self.enc2(skip1)
        skip3 = self.enc3(skip2)
        x = self.enc4(skip3)
        x = F.relu(self.bottleneck(x))
        x = self.up1(x, skip3)
        x = self.up2(x, skip2)
        x = self.up3(x, skip1)

        hc, wc = x.shape[-2], x.shape[-1]
        head = self.point_head(torch.cat([points_map, x], dim=1)).permute(0, 2, 3, 1)  # (B, hc, wc, 3)
        cell_v = torch.linspace(-1.0, 1.0, hc + 1, dtype=dtype, device=device)
        cell_u = torch.linspace(-1.0, 1.0, wc + 1, dtype=dtype, device=device)
        cv = 0.5 * (cell_v[:-1] + cell_v[1:])
        cu = 0.5 * (cell_u[:-1] + cell_u[1:])
        cvv, cuu = torch.meshgrid(cv, cu, indexing="ij")
        centres = torch.stack([cuu, cvv], dim=-1)[None]  # (1, hc, wc, 2)
        max_off = torch.tensor(
            [self.max_offset_cells * 2.0 / wc, self.max_offset_cells * 2.0 / hc], dtype=dtype, device=device
        )
        points_grid = centres + torch.tanh(head[..., 0:2]) * max_off
        return FeaturePoints(
            points=points_grid.reshape(b, -1, 2),
            descriptors=x.permute(0, 2, 3, 1).reshape(b, -1, self.descriptor_channels),
            scores=head[..., 2].reshape(b, -1),
        )
