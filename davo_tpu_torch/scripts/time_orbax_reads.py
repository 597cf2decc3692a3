"""Time the port's Orbax reader on the JAX package's stores.

    python -m davo_tpu_torch.scripts.time_orbax_reads [--repeats 3] [store directory ...]

Each store (by default :data:`STORES`, the five under ``artifacts/``:
``ckpt_frontend_v2/checkpoint_300``, ``ckpt_frontend_v3/checkpoint_600``,
``ckpt_frontend_v4/checkpoint_600``, ``ckpt_v5_tokens/checkpoint_{600,1800}``)
is read whole by :func:`davo_tpu_torch.train.checkpoint.restore_orbax`
(the OCDBT walk, the values' bytes, zstd, the zarr arrays, the tree)
``--repeats`` times.  One JSON line a store: the first read's seconds
(the file cache as the process found it) and the fastest read's, the
store's bytes on disk, the arrays' bytes, and ``mb_per_s``, the arrays'
megabytes (10**6 bytes) a second at the fastest read; then one line
naming the host (CPU model and count, Python, numpy).  The reader is
host code: no device takes part.

:func:`tree_digest` condenses a restored tree (structure, and each
array's dtype, shape and bytes) into one SHA-256, and
:data:`PICKLE_DIGESTS` holds that digest of the pickle a store was
exported to, so a store can be held against its pickle bit for bit
where the pickle is not at hand.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import platform
import sys
import time
from pathlib import Path
from typing import Iterable, List, Optional

import numpy as np

from davo_tpu_torch.train.checkpoint import restore_orbax

__all__ = ["STORES", "PICKLE_DIGESTS", "read_store", "tree_digest", "host", "main"]

REPO = Path(__file__).resolve().parents[2]
STORES = {name: REPO / "artifacts" / path for name, path in (
    ("frontend_v2", "ckpt_frontend_v2/checkpoint_300"), ("frontend_v3", "ckpt_frontend_v3/checkpoint_600"),
    ("frontend_v4", "ckpt_frontend_v4/checkpoint_600"), ("v5_tokens_600", "ckpt_v5_tokens/checkpoint_600"),
    ("v5_tokens_1800", "ckpt_v5_tokens/checkpoint_1800"),
)}
# a store's tree_digest as read from the pickle it was exported to
PICKLE_DIGESTS = {
    "v5_tokens_1800": ("artifacts/calibration_transformer_v5_tokens8.pkl",
                       "0e7138086845a48bcfd9a05197bdc770b27fe03c11a77b449823028eaaa68173"),
}


def _leaves(tree) -> Iterable[np.ndarray]:
    if isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    elif isinstance(tree, np.ndarray):
        yield tree


def tree_digest(tree) -> str:
    """The SHA-256 of ``tree``'s structure (dict keys in sorted order,
    sequence positions, ``None``) and of each array's dtype, shape and
    bytes."""
    digest = hashlib.sha256()

    def walk(node):
        if isinstance(node, dict):
            digest.update(b"{%d" % len(node))
            for key in sorted(node):
                digest.update(repr(key).encode() + b":")
                walk(node[key])
        elif isinstance(node, (list, tuple)):
            digest.update(b"[%d" % len(node))
            for value in node:
                walk(value)
        elif node is None:
            digest.update(b"None")
        else:
            array = np.ascontiguousarray(node)
            digest.update(f"{array.dtype.str}{array.shape}".encode())
            digest.update(array.tobytes())

    walk(tree)
    return digest.hexdigest()


def read_store(path, repeats: int = 1) -> dict:
    """``path`` read ``repeats`` times: the first and the fastest read's
    seconds and the figures beside them, and the tree read."""
    path = Path(path)
    stored = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    seconds = []
    for _ in range(repeats):
        start = time.perf_counter()
        tree = restore_orbax(str(path))
        seconds.append(time.perf_counter() - start)
    arrays = sum(leaf.nbytes for leaf in _leaves(tree))
    figures = dict(store=str(path.relative_to(REPO)) if path.is_relative_to(REPO) else str(path),
                   first_seconds=seconds[0], seconds=min(seconds), stored_mb=stored / 1e6, array_mb=arrays / 1e6,
                   mb_per_s=arrays / 1e6 / min(seconds), arrays=sum(1 for _ in _leaves(tree)), reads=repeats)
    return dict(figures=figures, tree=tree)


def host() -> dict:
    """The CPU model (as ``/proc/cpuinfo`` names it, where it does),
    architecture and count, and the versions that run the reader."""
    model = platform.processor()
    try:
        with open("/proc/cpuinfo") as f:
            model = next((line.split(":", 1)[1].strip() for line in f if line.startswith("model name")), model)
    except OSError:
        pass
    return dict(cpu=model, machine=platform.machine(), cpus=os.cpu_count(), python=platform.python_version(),
                numpy=np.__version__)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("stores", nargs="*", default=[str(s) for s in STORES.values()])
    args = parser.parse_args(argv)
    for store in args.stores:
        print(json.dumps(read_store(store, args.repeats)["figures"]), flush=True)
    print(json.dumps({"host": host()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
