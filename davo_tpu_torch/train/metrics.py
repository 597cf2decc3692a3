"""Metric logging (the port of ``davo_tpu/train/metrics.py``): one JSON
line per split and epoch on stdout, appended to a JSONL file with a path,
and mirrored to a TensorBoard event directory with ``tensorboard_dir``
(``torch.utils.tensorboard``, which needs the ``tensorboard`` package,
imported only then).  With a run manifest (``train/runs.py``) the file
starts with a ``{"run": manifest}`` record and every record carries the
``run_id``.  :func:`weight_summaries` gives each weight's mean, standard
deviation and largest magnitude under the JAX package's name paths.
"""

from __future__ import annotations

import json
import time
from typing import Dict, Mapping, Optional

import torch

__all__ = ["MetricsLogger", "weight_summaries"]


class MetricsLogger:
    """Callable with ``fit``'s ``log_fn`` signature ``(split, epoch,
    metrics)``: prints one JSON record, appends it to ``path`` and writes
    ``<split>/<name>`` scalars at step ``epoch`` to the TensorBoard
    directory."""

    def __init__(self, path: Optional[str] = None, tensorboard_dir: Optional[str] = None,
                 run: Optional[dict] = None):
        self.path = path
        self.run = run
        self._run_id = (run or {}).get("run_id")
        self._start = time.time()
        self._writer = None
        if run is not None and path:
            # the provenance header; a file appended to holds it mid-stream,
            # so every record also carries the run_id to attribute it by
            with open(path, "a") as f:
                f.write(json.dumps({"run": run}) + "\n")
        if tensorboard_dir:
            from torch.utils.tensorboard import SummaryWriter

            self._writer = SummaryWriter(log_dir=tensorboard_dir)

    def __call__(self, split: str, epoch: int, metrics: Dict[str, float]) -> None:
        record = {
            "split": split,
            "epoch": epoch,
            "elapsed_s": round(time.time() - self._start, 3),
            **{k: float(v) for k, v in metrics.items()},
        }
        if self._run_id is not None:
            record["run_id"] = self._run_id
        line = json.dumps(record)
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self._writer is not None:
            for name, value in metrics.items():
                self._writer.add_scalar(f"{split}/{name}", float(value), global_step=epoch)
            self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            self._writer = None


def _leaves(tree, prefix=""):
    if isinstance(tree, Mapping):
        for key, child in tree.items():
            # a state_dict's dotted names become paths as nested keys do
            name = str(key).replace(".", "/")
            yield from _leaves(child, f"{prefix}/{name}" if prefix else name)
    else:
        yield prefix, tree


def weight_summaries(params: Mapping) -> Dict[str, Dict[str, float]]:
    """Per-weight statistics (mean, population std, absmax), the
    histogram-free analogue of the reference's weight logging.

    :param params: a nested dict of arrays or tensors (a flax ``params``
        tree, as ``models/convert.py`` gives a module's: the names are its
        key paths ``a/b/c``, as the JAX function names them), or a
        ``state_dict`` (its dotted names as paths).
    """
    out = {}
    for name, leaf in _leaves(params):
        x = torch.as_tensor(leaf)
        if not torch.is_floating_point(x):
            x = x.double()
        out[name] = {
            "mean": float(torch.mean(x)),
            "std": float(torch.std(x, correction=0)),
            "absmax": float(torch.max(torch.abs(x))),
        }
    return out
