"""Device meshes over ``torch.distributed`` (the port of
``davo_tpu/parallel/mesh.py``).

The JAX package shards the batch of problems (and the point and keyframe
blocks of the distributed BA) over a ``jax.sharding.Mesh``, and XLA
inserts the collectives.  Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same named
dimensions (``"data"``; ``"kf"`` and ``"pt"`` for the 2-D BA), over the
default process group: NCCL for the card, gloo for the CPU.  The code is
SPMD: every rank runs the same function on the full, replicated inputs,
takes its shard by its coordinate in the mesh, issues the collectives
itself (``dist.all_reduce`` on ``mesh.get_group(name)``) and returns the
full result, as the JAX functions return global arrays.

Launch ``N`` ranks with ``torchrun --nproc-per-node N`` (which sets
``MASTER_ADDR``, ``WORLD_SIZE`` and ``RANK``), then in each:
``initialize_distributed()`` and ``make_mesh()``.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from davo_tpu_torch.utils.device import resolve_device

__all__ = [
    "make_mesh",
    "replicate",
    "shard_along",
    "initialize_distributed",
    "DATA_AXIS",
]

DATA_AXIS = "data"


def _backend(device) -> str:
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device=None,
) -> int:
    """Initialise the default process group (NCCL on the card, gloo with
    ``device="cpu"``) and return this process's rank.

    With no coordinates, reads the environment that ``torchrun`` sets
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a no-op
    when the group already exists.

    Error contract (the JAX package's): when the caller passes explicit
    coordinates (``coordinator_address`` as ``host:port``, the world size,
    the rank), a failure is a misconfiguration and raises ``RuntimeError``;
    only the implicit path treats a failure as "no cluster here", and says
    so in a warning before going on single-process.
    """
    if dist.is_initialized():
        return dist.get_rank()
    backend = _backend(device)
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    try:
        dist.init_process_group(
            backend,
            init_method=f"tcp://{coordinator_address}" if coordinator_address else "env://",
            world_size=-1 if num_processes is None else num_processes,
            rank=-1 if process_id is None else process_id,
        )
    except (RuntimeError, ValueError) as exc:
        if explicit:
            raise RuntimeError(
                "torch.distributed.init_process_group failed for the explicitly "
                f"configured cluster ({coordinator_address=}, {num_processes=}, {process_id=})"
            ) from exc
        warnings.warn(
            f"multi-process auto-detection found no cluster ({type(exc).__name__}: {exc}); "
            "continuing single-process",
            stacklevel=2,
        )
    if not dist.is_initialized():
        return 0
    if backend == "nccl":  # one card a rank: torchrun's LOCAL_RANK, else the rank
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank())) % torch.cuda.device_count())
    return dist.get_rank()


def make_mesh(
    n_devices: Optional[int] = None, axis_names: Sequence[str] = (DATA_AXIS,), device=None
) -> DeviceMesh:
    """A mesh over every rank of the default process group, all on the
    first axis as the JAX package puts them, on the card unless ``device``
    says otherwise.  Callers needing a 2-D layout build it with
    ``init_device_mesh(device_type, (a, b), mesh_dim_names=("kf", "pt"))``.

    :param n_devices: the ranks the mesh spans: every rank of the group
        (a mesh over some of them is not supported).
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_distributed() first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"the mesh spans every rank of the process group ({world}), got n_devices={n_devices}")
    shape = (world,) + (1,) * (len(axis_names) - 1)
    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's part of ``mesh`` lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def require_mesh(mesh) -> DeviceMesh:
    """``mesh``, or a ``TypeError`` if it is not a ``DeviceMesh``."""
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a torch.distributed DeviceMesh (make_mesh), got {type(mesh).__name__}")
    return mesh


def axis(mesh: DeviceMesh, axis_name: str) -> Tuple[dist.ProcessGroup, int, int]:
    """``(group, size, coordinate)`` of this rank along ``axis_name``."""
    require_mesh(mesh)
    return mesh.get_group(axis_name), mesh.size(mesh.mesh_dim_names.index(axis_name)), mesh.get_local_rank(axis_name)


def whole_group(mesh: DeviceMesh):
    """The group of every rank of ``mesh`` (the default group, which the
    mesh spans)."""
    if mesh.size() != dist.get_world_size():
        raise ValueError("the mesh must span every rank of the process group")
    return dist.group.WORLD


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def replicate(tree, mesh: DeviceMesh):
    """Every tensor of ``tree`` whole, on this rank's device of the mesh
    (each rank holds a copy)."""
    device = mesh_device(mesh)
    return _tree_map(lambda x: x.to(device), tree)


def shard_along(tree, mesh: DeviceMesh, axis_name: str = DATA_AXIS, dim: int = 0):
    """This rank's slice of every tensor of ``tree`` along ``dim``, cut
    evenly over the mesh's ``axis_name``, on this rank's device.  Raises
    when a size does not divide."""
    _, size, coordinate = axis(mesh, axis_name)
    device = mesh_device(mesh)

    def shard(x):
        if x.shape[dim] % size:
            raise ValueError(f"dimension {dim} of size {x.shape[dim]} does not divide over {axis_name!r} ({size})")
        chunk = x.shape[dim] // size
        return x.narrow(dim, coordinate * chunk, chunk).to(device)

    return _tree_map(shard, tree)
