"""Checkpoints in the JAX package's pickle format (the port of
``davo_tpu/train/checkpoint.py``, ``format="pickle"``).

A checkpoint directory holds ``checkpoint_<step>.pkl`` files of numpy
trees (the JAX package's ``format="pickle"``, which the shipped artifacts
use) or ``checkpoint_<step>/`` Orbax directories.  :func:`save_checkpoint`
writes a tree of numpy arrays and Python numbers as the JAX package does
(a ``.tmp`` file, then an atomic rename), so the JAX package's own
``restore_checkpoint`` reads what the port writes.
:func:`restore_checkpoint` reads the pickles without JAX
(:func:`davo_tpu_torch.models.load_numpy_checkpoint`) and returns numpy
arrays; an Orbax directory raises, since its reader is still to be ported
(``ROADMAP.md``, Queue 1 item 8).
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

import numpy as np
import torch

from davo_tpu_torch.models.convert import load_numpy_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]

_PREFIX = "checkpoint_"


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
    (pickle or Orbax; a ``.tmp`` file left by an interrupted save is not
    one), or ``None``."""
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
    arrays (``params``, ``batch_stats``, ...)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {directory}")
    path = os.path.join(os.path.abspath(directory), f"{_PREFIX}{step}")
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is an Orbax checkpoint; the port reads the pickle format only "
            "(the Orbax reader is ROADMAP.md Queue 1 item 8)"
        )
    return load_numpy_checkpoint(path + ".pkl")
