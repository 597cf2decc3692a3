"""Checkpoint discovery and restore for the JAX package's pickle format
(the read side of ``davo_tpu/train/checkpoint.py``).

A checkpoint directory holds ``checkpoint_<step>.pkl`` files (the JAX
package's ``format="pickle"``, which the shipped artifacts use) or
``checkpoint_<step>/`` Orbax directories.  :func:`restore_checkpoint` reads
the pickles without JAX (:func:`davo_tpu_torch.models.load_numpy_checkpoint`)
and returns numpy arrays; an Orbax directory raises, since its reader is
still to be ported (``ROADMAP.md``, Queue 1 item 8).
"""

from __future__ import annotations

import os
from typing import Optional

from davo_tpu_torch.models.convert import load_numpy_checkpoint

__all__ = ["latest_step", "restore_checkpoint"]

_PREFIX = "checkpoint_"


def latest_step(directory: str) -> Optional[int]:
    """The largest step of a ``checkpoint_<step>`` entry in ``directory``
    (pickle or Orbax), or ``None``."""
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
