"""12-parameter single-view camera with a two-vector orientation (the port
of ``davo_tpu/camera/simple_parameters.py``).

Layout ``[cx, cy, f, a1, a2, a3, b1, b2, b3, tx, ty, tz]``: the 3-vectors
``a`` (forward) and ``b`` (down) orthonormalise into the camera rotation
(:func:`davo_tpu_torch.geometry.two_vector_rotation_matrix`).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from davo_tpu_torch.geometry import two_vector_rotation_matrix

__all__ = ["SimpleCameraModelParameters", "NUM_SIMPLE_CAMERA_PARAMS"]

NUM_SIMPLE_CAMERA_PARAMS = 12


class SimpleCameraModelParameters(NamedTuple):
    """Single-view camera parameters with any leading batch dimensions."""

    cx: torch.Tensor
    cy: torch.Tensor
    focal_length: torch.Tensor
    a: torch.Tensor  # (..., 3) forward basis vector
    b: torch.Tensor  # (..., 3) down basis vector
    translation: torch.Tensor  # (..., 3)

    @classmethod
    def make(cls, vector: torch.Tensor) -> "SimpleCameraModelParameters":
        """Unpack a ``(..., 12)`` vector in the canonical layout."""
        if vector.shape[-1] != NUM_SIMPLE_CAMERA_PARAMS:
            raise ValueError(f"Expected {NUM_SIMPLE_CAMERA_PARAMS} parameters, got {vector.shape[-1]}")
        return cls(
            cx=vector[..., 0],
            cy=vector[..., 1],
            focal_length=vector[..., 2],
            a=vector[..., 3:6],
            b=vector[..., 6:9],
            translation=vector[..., 9:12],
        )

    @classmethod
    def stack(cls, items: Sequence["SimpleCameraModelParameters"], dim: int = 0) -> "SimpleCameraModelParameters":
        """Stack several parameter sets along a new batch dimension."""
        return cls(*(torch.stack([getattr(i, f) for i in items], dim=dim) for f in cls._fields))

    def as_vector(self) -> torch.Tensor:
        return torch.cat(
            [self.cx[..., None], self.cy[..., None], self.focal_length[..., None], self.a, self.b, self.translation],
            dim=-1,
        )

    def rotation_matrix(self) -> torch.Tensor:
        """Orthonormalised camera rotation, ``(..., 3, 3)``."""
        return two_vector_rotation_matrix(self.a, self.b)

    def project(self, points: torch.Tensor) -> torch.Tensor:
        """World points ``(..., N, 3)`` to pixels ``(..., N, 2)``: into
        camera coordinates by ``R^T`` (the rotation's columns are the
        camera axes) and the translation, then the 3-parameter pinhole."""
        cam = torch.einsum("...ji,...nj->...ni", self.rotation_matrix(), points) + self.translation[..., None, :]
        f = self.focal_length[..., None]
        u = f * cam[..., 0] / cam[..., 2] + self.cx[..., None]
        v = f * cam[..., 1] / cam[..., 2] + self.cy[..., None]
        return torch.stack([u, v], dim=-1)
