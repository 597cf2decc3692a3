"""Profiling and debugging utilities (the port of
``davo_tpu/utils/profiling.py``).

* :func:`trace` — a ``torch.profiler`` window over the block, host and
  card activity, exported as a Chrome trace into a directory;
* :func:`timed` — best-of-N wall time, the card synchronised around
  each run (launches are asynchronous);
* :func:`debug_nans` — scoped NaN detection: the first floating-point
  NaN an operator produces inside the block raises.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["trace", "timed", "debug_nans"]


def _synchronize() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile everything the block runs (CPU, and CUDA where a card is
    present) and write ``log_dir/trace.json``, a Chrome trace (open it in
    ``chrome://tracing`` or Perfetto).  Yields the profiler, whose
    ``key_averages()`` tabulates the same events."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def timed(fn: Callable, *args, repeats: int = 5, **kwargs) -> Tuple[float, object]:
    """Best-of-``repeats`` wall time of ``fn(*args, **kwargs)`` after one
    warm-up call, the card synchronised before and after each run.

    :return: ``(seconds, last_result)``.
    """
    result = fn(*args, **kwargs)
    _synchronize()
    best = float("inf")
    for _ in range(repeats):
        _synchronize()
        start = time.perf_counter()
        result = fn(*args, **kwargs)
        _synchronize()
        best = min(best, time.perf_counter() - start)
    return best, result


class _NanCheck(TorchDispatchMode):
    """Raises on the first floating output of an operator that holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_flatten(out)[0]:
            if isinstance(x, torch.Tensor) and x.is_floating_point() and bool(torch.isnan(x).any()):
                raise FloatingPointError(f"NaN produced by {func}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scoped NaN checking, the analogue of ``jax_debug_nans``: any
    operator dispatched inside the block whose floating output holds a NaN
    raises ``FloatingPointError`` naming the operator.

    It sees what goes through PyTorch's dispatcher (every ``torch``
    operator, forward and backward).  It does not see inside the port's
    hand-written kernels: they are launched through ``ctypes``
    (``ops/build.py``), outside the dispatcher, so a NaN a kernel writes
    shows only once a later operator reads it.  Each check reads the
    result back to the host, so a block runs far slower inside it.
    """
    if not enable:
        yield
        return
    with _NanCheck():
        yield
