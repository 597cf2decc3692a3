"""Analytic communication model of the distributed Schur BA solvers (the
port of ``davo_tpu/parallel/comm_model.py``).

1. Closed-form per-LM-iteration collective traffic of
   :func:`davo_tpu_torch.parallel.distributed_schur_ba` (1-D point mesh)
   and :func:`~davo_tpu_torch.parallel.distributed_schur_ba_2d` (keyframe x
   point mesh) as a function of ``(M, N, mesh shape)``: the same inventory
   as the JAX package's.
2. A ring-all-reduce time model that combines those bytes with a measured
   single-device compute time to predict N-device efficiency.

The JAX module also has ``extract_hlo_all_reduces``, which parses the
``all-reduce`` ops out of a compiled XLA HLO module to audit the inventory.
PyTorch emits no HLO, so it is not ported: the port's solvers issue their
collectives themselves, and the tests record each ``dist.all_reduce`` and
``dist.all_gather`` a rank issues and hold them against this inventory
(``tests/test_torch_parallel.py``).  ``predict_efficiency`` takes the
link rate as a required argument: the JAX default was a TPU interconnect's.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Sequence

__all__ = [
    "Collective",
    "schur_1d_traffic",
    "schur_2d_traffic",
    "wire_bytes_per_device",
    "predict_efficiency",
]


@dataclasses.dataclass(frozen=True)
class Collective:
    """One all-reduce: ``payload_bytes`` reduced over ``group_size``
    devices, ``count`` times per LM iteration."""

    name: str
    group_size: int
    payload_bytes: int
    count: int = 1

    def wire_bytes(self) -> float:
        """Bytes each device moves over the interconnect for this
        collective under the ring algorithm (reduce-scatter + all-gather):
        ``2 * S * (g - 1) / g``."""
        g = self.group_size
        return self.count * 2.0 * self.payload_bytes * (g - 1) / g


def _camera_dim(num_views: int) -> int:
    return 3 + 6 * num_views


def schur_1d_traffic(num_views: int, num_points: int, devices: int, dtype_bytes: int = 4) -> List[Collective]:
    """Per-LM-iteration collectives of :func:`distributed_schur_ba` on a
    ``devices``-way point mesh: the reduced camera system ``(C, C)`` and
    its rhs ``(C,)`` in one fused all-reduce, and the scalar cost of the
    candidate step.  Independent of ``N``, the defining property of the
    Schur split."""
    del num_points  # traffic is N-independent; kept for signature parity
    c = _camera_dim(num_views)
    return [
        Collective("reduced_camera_system", devices, (c * c + c) * dtype_bytes),
        Collective("step_cost", devices, dtype_bytes),
    ]


def schur_2d_traffic(
    num_views: int, num_points: int, kf_devices: int, pt_devices: int, dtype_bytes: int = 4
) -> List[Collective]:
    """Per-LM-iteration collectives of :func:`distributed_schur_ba_2d` on an
    ``(a, b) = (kf_devices, pt_devices)`` mesh, as the JAX package's XLA
    program issues them.

    The keyframe-axis separator traffic dominates: each device completes
    its ``N / b`` points' factors ``(C_blk 3x3, H_cp Cx3, g_p 3)`` across
    the ``a`` keyframe shards that observe them, one fused all-reduce of
    ``(N/b) (3C + 12)`` elements.  XLA stages the scalar cost over the 2-D
    mesh as one all-reduce per axis (the port issues one over the whole
    mesh, and regathers no pose mask: its ranks hold it whole).
    """
    a, b = kf_devices, pt_devices
    c = _camera_dim(num_views)
    n_loc = num_points // b
    traffic = [
        Collective("separator_point_factors", a, n_loc * (3 * c + 12) * dtype_bytes),  # c_blk, h_cp, g_p
        Collective("reduced_camera_system", a * b, (c * c + c) * dtype_bytes),
        Collective("dp_regather", a, n_loc * 3 * dtype_bytes),
        Collective("pose_mask_regather", a, 6 * num_views * 4),  # int32
        Collective("step_cost_kf_stage", a, dtype_bytes),
        Collective("step_cost_pt_stage", b, dtype_bytes),
    ]
    return [t for t in traffic if t.group_size > 1]


def wire_bytes_per_device(traffic: Iterable[Collective]) -> float:
    return sum(t.wire_bytes() for t in traffic)


def predict_efficiency(
    compute_seconds_per_iteration: float,
    traffic: Sequence[Collective],
    *,
    serial_fraction: float = 0.0,
    devices: int,
    link_bytes_per_second: float,
    latency_per_collective: float = 2e-6,
) -> dict:
    """Strong-scaling prediction for one LM iteration.

    ``compute_seconds_per_iteration`` is the measured single-device time;
    the sharded portion divides by ``devices`` while ``serial_fraction`` of
    it (the replicated reduced-system solve) does not.  Communication adds
    ring-all-reduce wire time at ``link_bytes_per_second`` (the link's
    rate in one direction pair; no default: state the interconnect's) plus
    a fixed latency per collective.

    :return: dict with ``t_compute``, ``t_comm``, ``t_total``,
        ``wire_bytes`` and ``efficiency`` (= t_1 / (devices * t_D)).
    """
    t1 = compute_seconds_per_iteration
    t_serial = serial_fraction * t1
    t_compute = (t1 - t_serial) / devices + t_serial
    wire = wire_bytes_per_device(traffic)
    n_collectives = sum(t.count for t in traffic)
    t_comm = wire / link_bytes_per_second + n_collectives * latency_per_collective
    t_total = t_compute + t_comm
    return {
        "devices": devices,
        "t_compute": t_compute,
        "t_comm": t_comm,
        "t_total": t_total,
        "wire_bytes": wire,
        "efficiency": t1 / (devices * t_total),
    }
