"""Metric logging (the port of ``davo_tpu/train/metrics.py``): one JSON
line per split and epoch on stdout and, with a path, appended to a JSONL
file.  The TensorBoard mirror and the run manifests of ``train/runs.py``
are still to be ported (``ROADMAP.md``, Queue 1 item 8).
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    """Callable with ``fit``'s ``log_fn`` signature ``(split, epoch,
    metrics)``: prints one JSON record and appends it to ``path``."""

    def __init__(self, path: Optional[str] = None, tensorboard_dir: Optional[str] = None):
        if tensorboard_dir:
            raise NotImplementedError(
                "the TensorBoard mirror is not ported yet (ROADMAP.md Queue 1 item 8); "
                "the JSONL file holds the same records"
            )
        self.path = path
        self._start = time.time()

    def __call__(self, split: str, epoch: int, metrics: Dict[str, float]) -> None:
        record = {
            "split": split,
            "epoch": epoch,
            "elapsed_s": round(time.time() - self._start, 3),
            **{k: float(v) for k, v in metrics.items()},
        }
        line = json.dumps(record)
        print(line, flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
