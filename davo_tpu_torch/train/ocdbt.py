"""The read path of an OCDBT key-value store (tensorstore's
"optionally-cooperative distributed B+tree"), the store under every Orbax
checkpoint the JAX package writes.

A store is a directory: ``manifest.ocdbt`` (or numbered
``manifest.<16 hex digits>`` files beside a ``manifest.ocdbt`` that holds
the configuration alone) names the latest B-tree root among its versions;
the B-tree's nodes and the values too big to keep inline live in data
files under the store, which a node's data-file table names by paths
relative to the store's root (an Orbax checkpoint's top manifest points
into ``ocdbt.process_0/d/``).  Manifests and nodes are framed alike:

    magic (uint32, big-endian), length (uint64), format version (varint,
    0), compression (varint: 0 none, 1 zstd), the body (zstd-compressed
    when asked), crc32c of everything before it (uint32)

with every other integer a little-endian varint and every array stored a
field at a time.  Keys are prefix-compressed against the key before them
and stored relative to the prefix their node inherits.

:class:`OcdbtStore` mirrors the two tensorstore ``KvStore`` calls a
checkpoint reader needs, ``list()`` and ``read(key)``, and adds
``read_many``.  An unknown format version, compression id, manifest kind
or value kind raises ``ValueError``, as does a checksum that does not
match.

:func:`write_store` is the write side: one writer, one version.  It
writes the store at a directory's root (``manifest.ocdbt`` and one data
file under ``d/``), the layout tensorstore reads and Orbax restores from
(Orbax's own ``ocdbt.process_<n>/`` sub-stores exist for several writing
processes, which a port save never has).  The store is uncompressed:
compression id 0 in the configuration and in every frame, which
tensorstore and the reader above read as they read zstd (no zstd encoder
is needed, and a checkpoint's float arrays compress little).
"""

from __future__ import annotations

import os
import re
import time
from typing import Dict, Iterable, List, Mapping, NamedTuple, Tuple, Union

import numpy as np

from davo_tpu_torch.utils.zstd import decompress

__all__ = ["OcdbtStore", "write_store"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_BTREE_NODE_MAGIC = 0x0CDB20DE
_NO_ROOT = (1 << 64) - 1  # an empty tree's root offset and length
_NUMBERED_MANIFEST = re.compile(r"manifest\.([0-9a-f]{16})$")

Key = Union[bytes, str]


def _crc32c_table() -> np.ndarray:
    table = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        table = np.where(table & 1, (table >> 1) ^ np.uint32(0x82F63B78), table >> 1)
    return table


_CRC32C = _crc32c_table().tolist()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    crc, table = 0xFFFFFFFF, _CRC32C
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Reader:
    """Little-endian fields read in order from a decoded body."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        value = shift = 0
        while True:
            if self.pos >= len(self.data) or shift > 63:
                raise ValueError("ocdbt: a truncated or overlong varint")
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("ocdbt: a field runs past the end of its node")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return int.from_bytes(self.take(8), "little")

    def end(self, what: str) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"ocdbt: {len(self.data) - self.pos} bytes after the end of {what}")


def _decode_framed(encoded: bytes, magic: int, what: str, max_bytes: int = 0) -> bytes:
    """The body of a manifest or node, its frame checked."""
    if len(encoded) < 18 or int.from_bytes(encoded[:4], "big") != magic:
        raise ValueError(f"ocdbt: {what} does not start with its magic number")
    if int.from_bytes(encoded[4:12], "little") != len(encoded):
        raise ValueError(f"ocdbt: {what}'s length field does not match its size")
    if crc32c(encoded[:-4]) != int.from_bytes(encoded[-4:], "little"):
        raise ValueError(f"ocdbt: {what}'s crc32c does not match")
    header = _Reader(encoded[:-4])
    header.pos = 12
    version = header.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what} has format version {version}; only version 0 is known")
    compression = header.varint()
    body = encoded[header.pos:-4]
    if compression == 1:
        body = decompress(body)
    elif compression != 0:
        raise ValueError(f"ocdbt: {what} has compression id {compression}; only 0 (none) and 1 (zstd) are known")
    if max_bytes and len(body) > max_bytes:
        raise ValueError(f"ocdbt: {what} decodes to {len(body)} bytes, above max_decoded_node_bytes {max_bytes}")
    return body


def _data_file_table(r: _Reader) -> List[str]:
    """Data file paths (base path + relative path, relative to the
    store's root), each prefix-compressed against the one before."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)  # where each path's base path ends: the path is what is read
    paths, last = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(last):
            raise ValueError("ocdbt: a data file path's prefix is longer than the path before it")
        last = last[:p] + r.take(s)
        paths.append(last.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    """A node's ``n`` keys (relative to the node's prefix) and, for an
    interior node, each entry's subtree common-prefix length."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, last = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(last):
            raise ValueError("ocdbt: a key's prefix is longer than the key before it")
        last = last[:p] + r.take(s)
        keys.append(last)
    return keys, common


class OcdbtStore:
    """An OCDBT store opened at its latest version: ``list()``, ``read(key)``
    and ``read_many(keys)``.  ``config`` holds the manifest's
    configuration and ``generation`` the version read."""

    def __init__(self, root: Union[str, os.PathLike]):
        self.root = os.path.abspath(root)
        encoded = self._file("manifest.ocdbt")
        config, body = self._manifest(encoded)
        if config["manifest_kind"] == 1:  # numbered: the highest-numbered manifest holds the versions
            numbers = [int(m.group(1), 16) for m in map(_NUMBERED_MANIFEST.match, os.listdir(self.root)) if m]
            if not numbers:
                raise ValueError(f"ocdbt: {self.root} has a numbered manifest and no numbered manifest file")
            config, body = self._manifest(self._file(f"manifest.{max(numbers):016x}"))
        self.config = config
        versions = self._versions(body)
        self.generation, height, root = max(versions)
        self._entries: Dict[bytes, tuple] = {}
        if root is not None:
            self._walk(root, height, b"")
        self._keys = sorted(self._entries)

    # -------------------------------------------------------------- files ----

    def _file(self, path: str, offset: int = 0, length: int = -1) -> bytes:
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if length >= 0 and len(data) != length:
            raise ValueError(f"ocdbt: {path} ends before byte {offset + length}")
        return data

    def _manifest(self, encoded: bytes):
        r = _Reader(_decode_framed(encoded, _MANIFEST_MAGIC, "the manifest"))
        config = dict(uuid=r.take(16).hex(), manifest_kind=r.varint(), max_inline_value_bytes=r.varint(),
                      max_decoded_node_bytes=r.varint(), version_tree_arity_log2=r.u8())
        if config["manifest_kind"] not in (0, 1):
            raise ValueError(f"ocdbt: manifest kind {config['manifest_kind']}; only 0 (single) and 1 (numbered)")
        compression = r.varint()
        if compression == 0:
            config["compression"] = None
        elif compression == 1:
            config["compression"] = {"id": "zstd", "level": int.from_bytes(r.take(4), "little", signed=True)}
        else:
            raise ValueError(f"ocdbt: the configuration names compression id {compression}")
        return config, r

    def _versions(self, r: _Reader) -> List[tuple]:
        """The manifest's inline versions as ``(generation, root height,
        root location or None)``; the older versions' version-tree nodes,
        which the latest version does not need, are parsed and passed by."""
        if self.config["manifest_kind"] == 1 and r.pos == len(r.data):
            raise ValueError("ocdbt: a numbered manifest file without its versions")
        files = _data_file_table(r)
        n = r.varint()
        generation = r.varints(n)
        height = list(r.take(n))
        file_id, offset, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)  # each root's statistics: keys, tree bytes, indirect value bytes
        r.take(8 * n)  # commit times
        m = r.varint()  # the version tree's nodes: generation, location, count, commit time, height
        r.varints(5 * m)
        r.take(9 * m)
        r.end("the manifest")
        if not n:
            raise ValueError("ocdbt: a manifest with no version")
        versions = []
        for g, h, f, o, ln in zip(generation, height, file_id, offset, length):
            root = None if o == _NO_ROOT else (files[f], o, ln)
            versions.append((g, h, root))
        return versions

    # -------------------------------------------------------------- nodes ----

    def _walk(self, location: tuple, height: int, prefix: bytes) -> None:
        path, offset, length = location
        body = _decode_framed(self._file(path, offset, length), _BTREE_NODE_MAGIC, f"the B-tree node in {path}",
                              self.config["max_decoded_node_bytes"])
        r = _Reader(body)
        if r.u8() != height:
            raise ValueError(f"ocdbt: the node in {path} is not of the height its parent says ({height})")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            file_id, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # each subtree's statistics
            r.end("an interior node")
            for key, c, f, o, ln in zip(keys, common, file_id, offsets, lengths):
                self._walk((files[f], o, ln), height - 1, prefix + key[:c])
            return
        lengths, kinds = r.varints(n), r.varints(n)
        if any(k > 1 for k in kinds):
            raise ValueError(f"ocdbt: value kinds {sorted(set(kinds))}; only 0 (inline) and 1 (indirect)")
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        file_id, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        for i, f, o in zip(indirect, file_id, offsets):
            self._entries[prefix + keys[i]] = (files[f], o, lengths[i])
        for i, k in enumerate(kinds):
            if k == 0:
                self._entries[prefix + keys[i]] = r.take(lengths[i])
        r.end("a leaf node")

    # ---------------------------------------------------------- interface ----

    def list(self) -> List[bytes]:
        """Every key, in order."""
        return list(self._keys)

    def read(self, key: Key) -> bytes:
        """The value of ``key``; ``KeyError`` if the store has none."""
        return self.read_many([key])[0]

    def read_many(self, keys: Iterable[Key]) -> List[bytes]:
        """The values of ``keys``; indirect values read a data file at a
        time, in order of offset."""
        keys = [k.encode() if isinstance(k, str) else bytes(k) for k in keys]
        refs = [self._entries[k] for k in keys]
        out: List[bytes] = [b""] * len(keys)
        by_file: Dict[str, List[int]] = {}
        for i, ref in enumerate(refs):
            if isinstance(ref, bytes):
                out[i] = ref
            else:
                by_file.setdefault(ref[0], []).append(i)
        for path, idx in by_file.items():
            with open(os.path.join(self.root, path), "rb") as f:
                for i in sorted(idx, key=lambda j: refs[j][1]):
                    _, offset, length = refs[i]
                    f.seek(offset)
                    out[i] = f.read(length)
                    if len(out[i]) != length:
                        raise ValueError(f"ocdbt: {path} ends before byte {offset + length}")
        return out


# ---------------------------------------------------------------- write ----

# tensorstore's defaults for a store Orbax creates (its manifests carry them)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_MAX_VARINT = 10  # bytes of a 64-bit varint at most


def _varint(value: int) -> bytes:
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _varints(values: Iterable[int]) -> bytes:
    return b"".join(map(_varint, values))


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    for i in range(n):
        if a[i] != b[i]:
            return i
    return n


def _encode_framed(body: bytes, magic: int) -> bytes:
    """``body`` framed as :func:`_decode_framed` reads it: format version
    0, compression 0 (none)."""
    head = magic.to_bytes(4, "big") + (4 + 8 + 2 + len(body) + 4).to_bytes(8, "little") + _varint(0) + _varint(0)
    encoded = head + body
    return encoded + crc32c(encoded).to_bytes(4, "little")


def _encode_prefixed(strings: List[bytes], middle: bytes = b"") -> bytes:
    """``strings`` prefix-compressed, each against the one before: the
    prefix lengths (from the second), the suffix lengths, ``middle`` (the
    fields a table or node puts between them and the bytes), the suffixes."""
    prefix = [_common_prefix(a, b) for a, b in zip(strings, strings[1:])]
    suffix = [s[p:] for s, p in zip(strings, [0] + prefix)]
    return _varints(prefix) + _varints(map(len, suffix)) + middle + b"".join(suffix)


def _encode_table(paths: List[bytes]) -> bytes:
    """A data file table of ``paths`` (relative to the store's root, each
    with an empty base path)."""
    return _varint(len(paths)) + _encode_prefixed(paths, _varints([0] * len(paths)))


class _Node(NamedTuple):
    """A written B-tree node: the full keys it spans, the prefix its keys
    are stored relative to, its location and its subtree's statistics."""

    first: bytes
    last: bytes
    prefix: bytes
    offset: int
    length: int
    keys: int
    tree_bytes: int
    indirect_bytes: int


def _groups(costs: List[int], fixed: int, limit: int) -> List[Tuple[int, int]]:
    """Consecutive ranges of entries whose costs, with ``fixed``, stay
    within ``limit``."""
    out, start, size = [], 0, fixed
    for i, cost in enumerate(costs):
        if fixed + cost > limit:
            raise ValueError(f"ocdbt: an entry of up to {cost} bytes does not fit a node of "
                             f"max_decoded_node_bytes {limit}; lower max_inline_value_bytes")
        if i > start and size + cost > limit:
            out.append((start, i))
            start, size = i, fixed
        size += cost
    out.append((start, len(costs)))
    return out


def write_store(
    directory: Union[str, os.PathLike],
    items: Mapping[bytes, Union[bytes, bytearray, memoryview, np.ndarray]],
    *,
    max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES,
    max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES,
) -> None:
    """Write ``items`` (key: value bytes, or any C-contiguous buffer) as a
    new OCDBT store at ``directory``: a manifest of one version (generation
    1) and one data file, ``d/<32 hex digits>``, holding the values longer
    than ``max_inline_value_bytes``, then the B-tree's leaves, then its
    interior nodes, level by level up to the root.  A node holds as many
    entries as keep its body within ``max_decoded_node_bytes``; a node
    below the root stores its keys relative to the longest prefix its
    subtree's keys share."""
    if not items:
        raise ValueError("ocdbt: a store needs at least one key")
    entries = sorted(((k.encode() if isinstance(k, str) else bytes(k), v) for k, v in items.items()),
                     key=lambda entry: entry[0])
    data_path = f"d/{os.urandom(16).hex()}".encode()
    table = _encode_table([data_path])
    os.makedirs(os.path.join(directory, "d"), exist_ok=True)
    with open(os.path.join(directory, data_path.decode()), "wb") as f:
        offset = 0
        # (key, inline value or None, length, offset in the data file)
        leaves = []
        for key, value in entries:
            view = memoryview(value).cast("B") if not isinstance(value, bytes) else value
            if len(view) <= max_inline_value_bytes:
                leaves.append((key, bytes(view), len(view), 0))
            else:
                f.write(view)
                leaves.append((key, None, len(view), offset))
                offset += len(view)

        def write_node(body: bytes) -> Tuple[int, int]:
            nonlocal offset
            encoded = _encode_framed(body, _BTREE_NODE_MAGIC)
            f.write(encoded)
            offset += len(encoded)
            return offset - len(encoded), len(encoded)

        # an entry's bytes in its node at most: its key whole, every varint at its longest
        fixed = 1 + len(table) + _MAX_VARINT
        costs = [len(k) + 4 * _MAX_VARINT + (2 * _MAX_VARINT if v is None else n) for k, v, n, _ in leaves]
        groups = _groups(costs, fixed, max_decoded_node_bytes)
        nodes = []
        for start, stop in groups:
            part = leaves[start:stop]
            first, last = part[0][0], part[-1][0]
            prefix = first[:_common_prefix(first, last)] if len(groups) > 1 else b""
            keys = [k[len(prefix):] for k, _, _, _ in part]
            indirect = [(o, n) for _, v, n, o in part if v is None]
            body = (bytes([0]) + (table if indirect else _encode_table([])) + _varint(len(part))
                    + _encode_prefixed(keys) + _varints(n for _, _, n, _ in part)
                    + _varints(int(v is None) for _, v, _, _ in part)
                    + _varints([0] * len(indirect)) + _varints(o for o, _ in indirect)
                    + b"".join(v for _, v, _, _ in part if v is not None))
            at, length = write_node(body)
            nodes.append(_Node(first, last, prefix, at, length, len(part), length, sum(n for _, n in indirect)))
        height = 0
        while len(nodes) > 1:
            height += 1
            costs = [len(node.first) + 9 * _MAX_VARINT for node in nodes]
            groups = _groups(costs, fixed, max_decoded_node_bytes)
            parents = []
            for start, stop in groups:
                part = nodes[start:stop]
                first, last = part[0].first, part[-1].last
                prefix = first[:_common_prefix(first, last)] if len(groups) > 1 else b""
                keys = [node.first[len(prefix):] for node in part]
                body = (bytes([height]) + table + _varint(len(part))
                        + _encode_prefixed(keys, _varints(len(node.prefix) - len(prefix) for node in part))
                        + _varints([0] * len(part)) + _varints(node.offset for node in part)
                        + _varints(node.length for node in part) + _varints(node.keys for node in part)
                        + _varints(node.tree_bytes for node in part)
                        + _varints(node.indirect_bytes for node in part))
                at, length = write_node(body)
                parents.append(_Node(first, last, prefix, at, length, sum(n.keys for n in part),
                                     length + sum(n.tree_bytes for n in part),
                                     sum(n.indirect_bytes for n in part)))
            nodes = parents
    root = nodes[0]
    config = (os.urandom(16) + _varint(0) + _varint(max_inline_value_bytes) + _varint(max_decoded_node_bytes)
              + bytes([VERSION_TREE_ARITY_LOG2]) + _varint(0))
    version = (_varint(1) + _varint(1) + bytes([height]) + _varint(0) + _varint(root.offset) + _varint(root.length)
               + _varints([root.keys, root.tree_bytes, root.indirect_bytes])
               + time.time_ns().to_bytes(8, "little") + _varint(0))
    with open(os.path.join(directory, "manifest.ocdbt"), "wb") as f:
        f.write(_encode_framed(config + table + version, _MANIFEST_MAGIC))
