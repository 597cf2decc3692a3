"""Checkpoints of the JAX package's two formats (the port of
``davo_tpu/train/checkpoint.py``).

A checkpoint directory holds ``checkpoint_<step>/`` Orbax directories
(the JAX package's default ``format="orbax"``, which ``fit
--checkpoint-dir``, ``fit-frontend`` and every resumable curriculum run
write, in either package) or ``checkpoint_<step>.pkl`` files of numpy
trees (``format="pickle"``, which the shipped calibration artifacts use).

:func:`save_checkpoint` writes, by default, what Orbax's
``StandardCheckpointer`` writes for a tree of host arrays, with numpy and
the standard library alone: ``_METADATA`` (each leaf's keys, their key
types and its value type: ``np.ndarray`` for an array or a tensor, which
is moved to the host, ``scalar`` for a Python number, ``None``, ``Dict``,
``List`` or ``Tuple`` for a leaf that holds no array),
``_CHECKPOINT_METADATA``, and an OCDBT store of one zarr array a leaf
(:func:`davo_tpu_torch.train.ocdbt.write_store`,
:func:`davo_tpu_torch.train.zarr.write_arrays`).  Host arrays need neither
Orbax's ``_sharding`` file nor its ``array_metadatas/``: the JAX
package's ``restore_checkpoint`` reads the directory to the host, and
with ``abstract_state`` straight onto the shardings it names (a device
mesh among them).  The save is atomic as Orbax's is: the directory is
written as ``checkpoint_<step>.orbax-checkpoint-tmp-<n>`` and renamed.
``format="pickle"`` writes the numpy tree as a pickle, as the JAX package
does (a ``.tmp`` file, then a rename).

:func:`restore_checkpoint` reads either format without JAX and returns
numpy arrays, as the JAX package's host restore does: the pickles through
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
import shutil
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from davo_tpu_torch.models.convert import load_numpy_checkpoint

from .ocdbt import OcdbtStore, write_store
from .zarr import read_arrays, write_arrays

__all__ = ["latest_step", "restore_checkpoint", "restore_orbax", "save_checkpoint", "save_orbax"]

_PREFIX = "checkpoint_"
# Orbax's pytree key types (orbax.checkpoint metadata KeyType) and the
# value types of the leaves that hold no array
_SEQUENCE_KEY, _DICT_KEY = 1, 2
_EMPTY_VALUES = {"None": lambda: None, "Dict": dict, "List": list, "Tuple": tuple}
_ARRAY_VALUES = ("jax.Array", "np.ndarray", "scalar")
_IS_SEQUENCE = object()  # marks a node of restore_orbax's tree built as a dict
_HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_EMPTY_LEAVES = {type(None): "None", dict: "Dict", list: "List", tuple: "Tuple"}  # save_orbax's


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {key: _to_numpy(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(value) for value in tree)
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, (int, float)):
        return tree
    return np.asarray(tree)


def _host_array(leaf: Any, keys: List[str]) -> np.ndarray:
    """An array leaf (a tensor, anywhere, or a numpy array or scalar) as a
    numpy array on the host; a bfloat16 tensor as ``ml_dtypes.bfloat16``."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            try:
                import ml_dtypes
            except ImportError:
                raise ValueError(f"{'.'.join(keys)} is bfloat16, which needs the ml_dtypes package to be "
                                 f"written") from None
            return leaf.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return leaf.numpy()
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.asarray(leaf)
    raise ValueError(f"{'.'.join(keys)} is a {type(leaf).__name__}, which a checkpoint does not hold")


def _orbax_leaves(tree: Any, keys: Tuple[Tuple[str, int], ...] = ()):
    """``(keys, value metadata, array or None)`` of each leaf, in the order
    JAX flattens the tree (dict keys sorted); a key is ``(name, key type)``."""
    if isinstance(tree, (dict, list, tuple)) and len(tree):
        if isinstance(tree, dict):
            children = [((str(k), _DICT_KEY), tree[k]) for k in sorted(tree)]
        else:
            children = [((str(i), _SEQUENCE_KEY), v) for i, v in enumerate(tree)]
        for key, child in children:
            yield from _orbax_leaves(child, keys + (key,))
        return
    if type(tree) in _EMPTY_LEAVES:
        yield keys, {"value_type": _EMPTY_LEAVES[type(tree)], "skip_deserialize": True}, None
        return
    if isinstance(tree, (bool, int, float)):
        array = np.asarray(tree, np.bool_ if isinstance(tree, bool) else np.int64 if isinstance(tree, int)
                           else np.float64)
        yield keys, {"value_type": "scalar", "skip_deserialize": False}, array
        return
    yield keys, {"value_type": "np.ndarray", "skip_deserialize": False}, _host_array(tree, [k for k, _ in keys])


def save_orbax(path: str, state: Any) -> None:
    """``state`` as an Orbax ``StandardCheckpointHandler`` directory at
    ``path`` (which must not exist), written in place.  A tree with no
    array has no OCDBT store, as Orbax writes none for it."""
    started = time.time_ns()
    leaves = list(_orbax_leaves(state))
    arrays: Dict[str, np.ndarray] = {}
    tree_metadata = {}
    for keys, value, array in leaves:
        names = tuple(k for k, _ in keys)
        tree_metadata[str(names)] = {"key_metadata": [{"key": k, "key_type": t} for k, t in keys],
                                     "value_metadata": value}
        if array is not None:
            arrays[".".join(names)] = array
    os.makedirs(path)
    if arrays:
        write_store(path, write_arrays(arrays))
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": tree_metadata, "use_ocdbt": True, "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True, "custom_metadata": None}, f)
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": _HANDLER, "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": started, "commit_timestamp_nsecs": time.time_ns(),
                   "custom_metadata": {}}, f)


def save_checkpoint(directory: str, step: int, state: Any, *, format: str = "orbax") -> str:
    """Save ``state`` (nested dicts, lists and tuples of tensors, numpy
    arrays, Python numbers and empty leaves); returns the checkpoint's
    path.

    :param format: ``"orbax"`` (default; a ``checkpoint_<step>/``
        directory, replacing one of that step) or ``"pickle"`` (the
        single-file ``checkpoint_<step>.pkl``).
    """
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    if format == "orbax":
        path = os.path.join(directory, f"{_PREFIX}{step}")
        tmp = f"{path}.orbax-checkpoint-tmp-{time.time_ns()}"
        try:
            save_orbax(tmp, state)
            if os.path.isdir(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
        finally:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
        return path
    if format == "pickle":
        path = os.path.join(directory, f"{_PREFIX}{step}.pkl")
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(_to_numpy(state), f)
        os.replace(tmp, path)
        return path
    raise ValueError(f"Unknown checkpoint format: {format!r}")


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
