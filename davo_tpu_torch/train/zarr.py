"""Zarr v2 arrays assembled from a key-value store: the layout Orbax
writes each array of a checkpoint in (``<name>/.zarray`` and one chunk a
key, ``<name>/0.0``, ``<name>/1.0``, ..., or ``<name>/0`` for a scalar).

Each array is built from its ``.zarray`` over its whole chunk grid: a
checkpoint saved sharded across devices writes one chunk per shard, and a
chunk the store lacks (Orbax may skip one equal to the fill value) takes
the fill value (0 where it is null).  The zstd-compressed chunks of the
arrays asked for are decompressed together, up to 64 MiB of them a call,
so their Huffman streams decode in one pass.

Supported: ``zarr_format`` 2, order ``C``, no filters, compressor
``zstd`` or null, dtypes ``<f4``, ``<f8``, ``<i4``, ``<i8``, ``|b1`` and
``bfloat16`` (as ``ml_dtypes.bfloat16``, JAX's numpy type for it, which
must then be importable).  Anything else raises ``ValueError`` naming
what it found.

:func:`write_arrays` is the write side: the store items of numpy arrays
as Orbax writes an array held whole on one device (one chunk, the
array's shape; C order, no filters, ``fill_value`` null,
``dimension_separator`` "."), uncompressed (``compressor`` null, as the
OCDBT store around them is; see :mod:`davo_tpu_torch.train.ocdbt`).  It
takes the dtypes above and raises ``ValueError`` on any other, and on an
array of no elements, which Orbax refuses to save too.
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Dict, Iterable, Mapping

import numpy as np

from davo_tpu_torch.utils.zstd import decompress_many

from .ocdbt import OcdbtStore

__all__ = ["read_arrays", "write_arrays"]

# compressed bytes decompressed in one call (its working memory is a few
# times this): a checkpoint's chunks in a few calls, each decoding its
# Huffman streams together
_BATCH_BYTES = 64 << 20
_DTYPES = {"<f4": np.float32, "<f8": np.float64, "<i4": np.int32, "<i8": np.int64, "|b1": np.bool_}
_FILL = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}


def _dtype(name: str, array: str) -> np.dtype:
    if name in _DTYPES:
        return np.dtype(_DTYPES[name])
    if name == "bfloat16":
        try:
            import ml_dtypes
        except ImportError:
            raise ValueError(f"zarr: {array} is bfloat16, which needs the ml_dtypes package to be read") from None
        return np.dtype(ml_dtypes.bfloat16)
    raise ValueError(f"zarr: {array} has dtype {name!r}; supported: {sorted(_DTYPES) + ['bfloat16']}")


def _check(meta: dict, array: str) -> None:
    problems = []
    if meta.get("zarr_format") != 2:
        problems.append(f"zarr_format {meta.get('zarr_format')!r}")
    if meta.get("order", "C") != "C":
        problems.append(f"order {meta['order']!r}")
    if meta.get("filters"):
        problems.append(f"filters {meta['filters']!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        problems.append(f"compressor {compressor!r}")
    if meta.get("dimension_separator", ".") not in (".", "/"):
        problems.append(f"dimension_separator {meta['dimension_separator']!r}")
    if len(meta["chunks"]) != len(meta["shape"]):
        problems.append(f"chunks {meta['chunks']} for shape {meta['shape']}")
    if problems:
        raise ValueError(f"zarr: {array} has unsupported metadata: {', '.join(problems)}")


def read_arrays(store: OcdbtStore, names: Iterable[str]) -> Dict[str, np.ndarray]:
    """The zarr arrays ``names`` of ``store``, by name, as numpy arrays."""
    names = list(names)
    present = set(store.list())
    metas = {name: json.loads(raw) for name, raw in zip(names, store.read_many(f"{n}/.zarray" for n in names))}
    plan = []  # (array name, chunk index, key) of every chunk the store holds
    dtypes = {}
    for name, meta in metas.items():
        _check(meta, name)
        dtypes[name] = _dtype(meta["dtype"], name)
        sep = meta.get("dimension_separator", ".")
        grid = [range(-(-s // c)) if c else range(1) for s, c in zip(meta["shape"], meta["chunks"])]
        for index in itertools.product(*grid):
            key = f"{name}/{sep.join(map(str, index)) if index else '0'}".encode()
            if key in present:
                plan.append((name, index, key))
    raw = store.read_many(key for _, _, key in plan)
    compressed = [i for i, (name, _, _) in enumerate(plan) if metas[name].get("compressor") is not None]
    while compressed:
        size, take = 0, 0
        while take < len(compressed) and (take == 0 or size + len(raw[compressed[take]]) <= _BATCH_BYTES):
            size += len(raw[compressed[take]])
            take += 1
        batch, compressed = compressed[:take], compressed[take:]
        for i, data in zip(batch, decompress_many([raw[i] for i in batch])):
            raw[i] = data
    out = {}
    for name, meta in metas.items():
        fill = meta.get("fill_value")
        fill = 0 if fill is None else _FILL.get(fill, fill)
        out[name] = np.full(meta["shape"], fill, dtypes[name])
    for (name, index, _), data in zip(plan, raw):
        meta, array = metas[name], out[name]
        chunks = meta["chunks"]
        if len(data) != math.prod(chunks) * array.itemsize:
            raise ValueError(f"zarr: chunk {index} of {name} holds {len(data)} bytes; its shape {chunks} "
                             f"of {array.dtype} needs {math.prod(chunks) * array.itemsize}")
        chunk = np.frombuffer(data, array.dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, meta["shape"]))
        array[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    return out


def _dtype_name(array: np.ndarray, name: str) -> str:
    if array.dtype.name == "bfloat16":
        return "bfloat16"
    if array.dtype.str in _DTYPES:
        return array.dtype.str
    raise ValueError(f"zarr: {name} has dtype {array.dtype.str!r} ({array.dtype}); "
                     f"supported: {sorted(_DTYPES) + ['bfloat16']}")


def write_arrays(arrays: Mapping[str, np.ndarray]) -> Dict[bytes, object]:
    """The OCDBT items of ``arrays`` (name: numpy array): ``<name>/.zarray``
    and the one chunk ``<name>/0.0...`` (``<name>/0`` for a scalar), the
    chunk as a read-only view of the array's bytes."""
    items: Dict[bytes, object] = {}
    for name, array in arrays.items():
        dtype = _dtype_name(array, name)
        if array.size == 0:
            raise ValueError(f"zarr: {name} has shape {array.shape}, no element: Orbax saves no such array")
        shape = list(array.shape)
        meta = dict(chunks=shape, compressor=None, dimension_separator=".", dtype=dtype, fill_value=None,
                    filters=None, order="C", shape=shape, zarr_format=2)
        items[f"{name}/.zarray".encode()] = json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()
        chunk = ".".join("0" for _ in shape) or "0"
        items[f"{name}/{chunk}".encode()] = np.ascontiguousarray(array).reshape(-1).view(np.uint8)
    return items
