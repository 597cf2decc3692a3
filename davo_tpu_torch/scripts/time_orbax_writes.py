"""Time the port's Orbax writer on the JAX package's stores: each store's
round trip.

    python -m davo_tpu_torch.scripts.time_orbax_writes [--repeats 3] [store directory ...]

Each store (by default :data:`time_orbax_reads.STORES`, the five under
``artifacts/``) is read by :func:`davo_tpu_torch.train.checkpoint.restore_orbax`,
written by :func:`davo_tpu_torch.train.checkpoint.save_checkpoint` into a
temporary directory (``--repeats`` times, each a fresh ``checkpoint_<n>/``:
the zarr metadata, the OCDBT store, ``_METADATA``, the rename), and the
last write read back.  One JSON line a store: the read's seconds, the
first and the fastest write's seconds, ``write_mb_per_s`` (the arrays'
megabytes, 10**6 bytes, a second at the fastest write), the bytes written
and the arrays' bytes, the read-back's seconds, and the SHA-256
:func:`time_orbax_reads.tree_digest` of the tree read and of the tree
read back, which must be one (the script exits 1 where they differ); then
one line naming the host.  The writer is host code: no device takes part,
and the writes land in the file cache as the host's page cache takes them
(no ``fsync``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional

from davo_tpu_torch.train.checkpoint import restore_orbax, save_checkpoint

from .time_orbax_reads import STORES, host, read_store, tree_digest

__all__ = ["round_trip", "main"]


def _bytes_under(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def round_trip(store, directory, repeats: int = 1) -> dict:
    """``store`` read, written ``repeats`` times into ``directory`` (steps
    1, 2, ...) and its last write read back: the figures and both digests."""
    read = read_store(store)
    tree, figures = read["tree"], read["figures"]
    seconds = []
    for step in range(1, repeats + 1):
        start = time.perf_counter()
        path = save_checkpoint(str(directory), step, tree)
        seconds.append(time.perf_counter() - start)
    start = time.perf_counter()
    back = restore_orbax(path)
    reread = time.perf_counter() - start
    return dict(
        store=figures["store"], arrays=figures["arrays"], array_mb=figures["array_mb"],
        read_seconds=figures["seconds"], first_write_seconds=seconds[0], write_seconds=min(seconds),
        write_mb_per_s=figures["array_mb"] / min(seconds), written_mb=_bytes_under(Path(path)) / 1e6,
        stored_mb=figures["stored_mb"], reread_seconds=reread, writes=repeats,
        digest_read=tree_digest(tree), digest_written=tree_digest(back),
    )


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("stores", nargs="*", default=[str(s) for s in STORES.values()])
    args = parser.parse_args(argv)
    same = True
    for store in args.stores:
        with tempfile.TemporaryDirectory() as directory:
            figures = round_trip(store, directory, args.repeats)
        same &= figures["digest_read"] == figures["digest_written"]
        print(json.dumps(figures), flush=True)
    print(json.dumps({"host": host(), "cpus_usable": len(os.sched_getaffinity(0))}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
