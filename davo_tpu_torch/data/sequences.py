"""Real-sequence trajectory formats, TUM-RGBD and KITTI odometry (the port
of ``davo_tpu/data/sequences.py``).

* **TUM-RGBD**: text lines ``timestamp tx ty tz qx qy qz qw`` (camera-to-
  world position and unit quaternion), ``#`` comments.  Intrinsics files
  hold ``fx fy cx cy``.
* **KITTI odometry**: one pose a line, a row-major ``3 x 4``
  camera-to-world matrix ``[R | t]`` (12 numbers); ``calib.txt`` holds
  ``P0: <12 numbers>`` projection rows, from which ``f, cx, cy`` of the
  left grayscale camera are taken.

Poses come back world->camera, ``(K, 6)`` ``[axis-angle, t]`` with
``t = -R c``, as everywhere in the package.  The files are parsed on the
host in float64 (numpy); the poses and intrinsics are then tensors of
``dtype`` on ``device`` (the card unless the caller asks for the CPU).
Intrinsics are normalised to the ``[-1, 1]`` image square.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from davo_tpu_torch.geometry import axis_angle_from_matrix
from davo_tpu_torch.utils.device import resolve_device

__all__ = [
    "SequenceData",
    "load_tum_trajectory",
    "load_kitti_trajectory",
    "load_tum_intrinsics",
    "load_kitti_calib",
    "associate_timestamps",
    "load_sequence",
]


@dataclasses.dataclass(frozen=True)
class SequenceData:
    """A loaded sequence: world->camera poses and optional metadata."""

    poses: torch.Tensor  # (K, 6) [axis-angle, t], world->camera
    timestamps: Optional[np.ndarray] = None  # (K,) seconds, TUM only
    intrinsics: Optional[torch.Tensor] = None  # (3,) (f, cx, cy) normalised


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """Unit quaternion ``(qx, qy, qz, qw)`` (TUM order) to the
    camera-to-world rotation matrix."""
    x, y, z, w = q
    n = np.sqrt(x * x + y * y + z * z + w * w)
    if n < 1e-12:
        return np.eye(3)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ]
    )


def _world_to_camera(rot_c2w: np.ndarray, centre: np.ndarray, device, dtype) -> torch.Tensor:
    """``(K, 3, 3), (K, 3)`` camera-to-world to ``(K, 6)`` world->camera
    (the axis-angle taken in float64 on the host)."""
    rot_w2c = np.transpose(rot_c2w, (0, 2, 1))
    t = -np.einsum("kij,kj->ki", rot_w2c, centre)
    aa = axis_angle_from_matrix(torch.from_numpy(np.ascontiguousarray(rot_w2c)))
    poses = torch.cat([aa, torch.from_numpy(t)], dim=-1)
    return poses.to(device=resolve_device(device), dtype=dtype)


def _data_lines(path: str):
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line and not line.startswith("#"):
                yield line


def load_tum_trajectory(path: str, device=None, dtype: torch.dtype = torch.float32) -> SequenceData:
    """Read a TUM-format trajectory (``timestamp tx ty tz qx qy qz qw``)."""
    stamps: List[float] = []
    rots: List[np.ndarray] = []
    centres: List[np.ndarray] = []
    for line in _data_lines(path):
        parts = line.split()
        if len(parts) != 8:
            raise ValueError(f"TUM line needs 8 fields, got {len(parts)}: {line!r}")
        vals = [float(p) for p in parts]
        stamps.append(vals[0])
        centres.append(np.asarray(vals[1:4]))
        rots.append(_quat_to_matrix(np.asarray(vals[4:8])))
    if not stamps:
        raise ValueError(f"No poses in {path}")
    poses = _world_to_camera(np.stack(rots), np.stack(centres), device, dtype)
    return SequenceData(poses=poses, timestamps=np.asarray(stamps))


def load_kitti_trajectory(path: str, device=None, dtype: torch.dtype = torch.float32) -> SequenceData:
    """Read a KITTI-odometry pose file (rows of 3 x 4 ``[R | t]``)."""
    rows = []
    for line in _data_lines(path):
        vals = [float(p) for p in line.split()]
        if len(vals) != 12:
            raise ValueError(f"KITTI pose line needs 12 fields, got {len(vals)}")
        rows.append(np.asarray(vals).reshape(3, 4))
    if not rows:
        raise ValueError(f"No poses in {path}")
    mats = np.stack(rows)
    return SequenceData(poses=_world_to_camera(mats[:, :, 0:3], mats[:, :, 3], device, dtype))


def _normalised(fx, cx, cy, image_size, device, dtype) -> torch.Tensor:
    half_w, half_h = image_size[0] / 2.0, image_size[1] / 2.0
    return torch.tensor([fx / half_w, cx / half_w - 1.0, cy / half_h - 1.0], dtype=dtype,
                        device=resolve_device(device))


def load_tum_intrinsics(
    path: str, image_size: Tuple[int, int] = (640, 480), device=None, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Read ``fx fy cx cy`` and normalise to the ``[-1, 1]`` square.

    :return: ``(3,)`` ``(f, cx, cy)`` with ``f = fx / (width / 2)``.
    """
    for line in _data_lines(path):
        vals = [float(p) for p in line.split()]
        if len(vals) < 4:
            raise ValueError("intrinsics line needs fx fy cx cy")
        return _normalised(vals[0], vals[2], vals[3], image_size, device, dtype)
    raise ValueError(f"No intrinsics in {path}")


def load_kitti_calib(
    path: str,
    camera: str = "P0",
    image_size: Tuple[int, int] = (1241, 376),
    device=None,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Read a KITTI ``calib.txt`` projection row and normalise.

    :return: ``(3,)`` ``(f, cx, cy)`` in ``[-1, 1]`` pixel units.
    """
    with open(path) as f:
        for line in f:
            if not line.startswith(camera):
                continue
            vals = [float(p) for p in line.split()[1:]]
            if len(vals) != 12:
                raise ValueError(f"{camera} row needs 12 values")
            p = np.asarray(vals).reshape(3, 4)
            return _normalised(p[0, 0], p[0, 2], p[1, 2], image_size, device, dtype)
    raise ValueError(f"No {camera} row in {path}")


def associate_timestamps(
    stamps_a: np.ndarray, stamps_b: np.ndarray, max_dt: float = 0.02
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy nearest-timestamp association (the TUM benchmark's rule):
    each ``a`` pairs with its nearest unmatched ``b`` within ``max_dt``.

    :return: ``(idx_a, idx_b)`` index arrays of equal length.
    """
    order = np.argsort(stamps_b)
    sorted_b = np.asarray(stamps_b)[order]
    used = np.zeros(len(sorted_b), dtype=bool)
    idx_a, idx_b = [], []
    for i, t in enumerate(np.asarray(stamps_a)):
        j = np.searchsorted(sorted_b, t)
        best, best_dt = -1, max_dt
        for cand in (j - 1, j, j + 1):
            if 0 <= cand < len(sorted_b) and not used[cand]:
                dt = abs(sorted_b[cand] - t)
                if dt <= best_dt:
                    best, best_dt = cand, dt
        if best >= 0:
            used[best] = True
            idx_a.append(i)
            idx_b.append(order[best])
    return np.asarray(idx_a, dtype=np.int64), np.asarray(idx_b, dtype=np.int64)


def load_sequence(path: str, format: str = "tum", device=None, dtype: torch.dtype = torch.float32) -> SequenceData:
    """Load a trajectory file by format name (``tum`` | ``kitti``)."""
    if format == "tum":
        return load_tum_trajectory(path, device, dtype)
    if format == "kitti":
        return load_kitti_trajectory(path, device, dtype)
    raise ValueError(f"Unknown sequence format: {format!r}")
