"""Checkpoints of the JAX package's two formats (the port of
``davo_tpu/train/checkpoint.py``).

A checkpoint directory holds ``checkpoint_<step>.pkl`` files of numpy
trees (the JAX package's ``format="pickle"``, which the shipped calibration
artifacts use) or ``checkpoint_<step>/`` Orbax directories (its default
``format="orbax"``, which ``fit --checkpoint-dir``, ``fit-frontend`` and
every resumable curriculum run write).  :func:`save_checkpoint` writes a
tree of numpy arrays and Python numbers as a pickle, as the JAX package
does (a ``.tmp`` file, then an atomic rename), so the JAX package's own
``restore_checkpoint`` reads what the port writes.  :func:`restore_checkpoint`
reads either format without JAX and returns numpy arrays, as the JAX
package's host restore does: the pickles through
:func:`davo_tpu_torch.models.load_numpy_checkpoint`, an Orbax directory
through the port's OCDBT reader (:mod:`davo_tpu_torch.train.ocdbt`), its
zarr arrays (:mod:`davo_tpu_torch.train.zarr`) and the tree its
``_METADATA`` describes.  The JAX package's ``abstract_state`` (a restore
straight onto a device mesh) has no counterpart: the port restores to the
host, and :func:`davo_tpu_torch.parallel.replicate` and
:func:`davo_tpu_torch.parallel.shard_along` place the result.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from davo_tpu_torch.models.convert import load_numpy_checkpoint

from .ocdbt import OcdbtStore
from .zarr import read_arrays

__all__ = ["latest_step", "restore_checkpoint", "restore_orbax", "save_checkpoint"]

_PREFIX = "checkpoint_"
# Orbax's pytree key types (orbax.checkpoint metadata KeyType) and the
# value types of the leaves that hold no array
_SEQUENCE_KEY, _DICT_KEY = 1, 2
_EMPTY_VALUES = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_ARRAY_VALUES = ("jax.Array", "np.ndarray", "scalar")
_IS_SEQUENCE = object()  # marks a node of restore_orbax's tree built as a dict


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _to_numpy(value) for key, value in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (int, float)):
        return tree
    return np.asarray(tree)


def save_checkpoint(directory: str, step: int, state: dict) -> str:
    """Write ``state`` (nested dicts of arrays, tensors and numbers) as
    ``checkpoint_<step>.pkl`` in ``directory``; returns its path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{_PREFIX}{step}.pkl")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(_to_numpy(state), f)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    """The largest step of a ``checkpoint_<step>`` entry in ``directory``
    (pickle or Orbax; a ``.tmp`` file left by an interrupted save and
    Orbax's unfinished ``checkpoint_<step>.orbax-checkpoint-tmp-<n>``
    directories are not), or ``None``."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if not name.startswith(_PREFIX):
            continue
        stem = name[len(_PREFIX) :]
        if stem.endswith(".pkl"):
            stem = stem[: -len(".pkl")]
        elif stem.endswith(".tmp"):
            continue
        try:
            steps.append(int(stem))
        except ValueError:
            continue
    return max(steps) if steps else None


def restore_checkpoint(directory: str, step: Optional[int] = None) -> dict:
    """The checkpoint at ``step`` (default: the latest) as a dict of numpy
    arrays (``params``, ``batch_stats``, ...), from a pickle or an Orbax
    directory."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {directory}")
    path = os.path.join(os.path.abspath(directory), f"{_PREFIX}{step}")
    if os.path.isdir(path):
        return restore_orbax(path)
    return load_numpy_checkpoint(path + ".pkl")


def restore_orbax(path: str) -> Any:
    """The tree of an Orbax ``StandardCheckpointHandler`` directory, as
    the JAX package's host restore returns it: numpy arrays (scalars as
    0-d arrays), dicts, lists for sequences (a tuple or an optax state
    among them), and ``None``, ``{}``, ``[]`` or ``()`` for the leaves
    Orbax kept no array for."""
    with open(os.path.join(path, "_METADATA")) as f:
        entries = json.load(f)["tree_metadata"].values()
    names = [".".join(k["key"] for k in e["key_metadata"]) for e in entries
             if e["value_metadata"]["value_type"] in _ARRAY_VALUES]
    arrays = read_arrays(OcdbtStore(path), names)
    root: dict = {}
    for entry in entries:
        keys, value_type = entry["key_metadata"], entry["value_metadata"]["value_type"]
        if value_type in _ARRAY_VALUES:
            leaf = arrays[".".join(k["key"] for k in keys)]
        elif value_type in _EMPTY_VALUES:
            leaf = _EMPTY_VALUES[value_type]()
        else:
            raise ValueError(f"{path}: leaf {[k['key'] for k in keys]} has value type {value_type!r}, "
                             f"which the port does not read")
        root.setdefault(_IS_SEQUENCE, keys[0]["key_type"] == _SEQUENCE_KEY)
        node = root
        for key, child in zip(keys, keys[1:] + [None]):
            if key["key_type"] not in (_SEQUENCE_KEY, _DICT_KEY):
                raise ValueError(f"{path}: key {key['key']!r} has key type {key['key_type']}")
            name = int(key["key"]) if key["key_type"] == _SEQUENCE_KEY else key["key"]
            if child is None:
                node[name] = leaf
            else:
                node = node.setdefault(name, {_IS_SEQUENCE: child["key_type"] == _SEQUENCE_KEY})
    return _finish(root, path)


def _finish(node: Any, path: str) -> Any:
    """The nested dicts of :func:`restore_orbax` with each sequence's
    dict of ``index: child`` made a list."""
    if not isinstance(node, dict) or _IS_SEQUENCE not in node:
        return node
    sequence = node.pop(_IS_SEQUENCE)
    children = {key: _finish(child, path) for key, child in node.items()}
    if not sequence:
        return children
    if sorted(children) != list(range(len(children))):
        raise ValueError(f"{path}: a sequence with indices {sorted(children)}")
    return [children[i] for i in range(len(children))]
