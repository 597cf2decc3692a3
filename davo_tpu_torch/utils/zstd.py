"""Zstandard decompression (RFC 8878), decode only, in numpy.

The port reads the JAX package's Orbax checkpoints, whose B-tree nodes
and array chunks are zstd frames, on hosts that have no zstd module
(Python 3.12 has none).  This decoder covers the format's whole decode
path without a dictionary:

- frames: single-segment or with a window descriptor, the frame content
  size present or absent, the optional content checksum (XXH64, verified),
  skippable frames, and any number of frames one after another;
- blocks: raw, RLE and compressed;
- literals: raw, RLE, Huffman-coded and treeless (the previous table), in
  one or four streams, the Huffman weights FSE-coded or direct;
- sequences: the predefined, RLE, FSE-coded and repeat table modes, the
  repeat offsets, and matches that overlap their own output.

A frame that names a dictionary, or holds a field this decoder does not
implement, raises ``ValueError``; so does one whose bits do not add up.

Speed: the Huffman-coded literals carry nearly all of a float array's
bytes.  :func:`decompress_many` parses every block of every frame it is
given first (tables, stream bounds, sequences), then decodes all their
Huffman streams at once, one symbol of every stream a step, as numpy
operations over the streams; then it executes each frame's sequences.  A
checkpoint's chunks decompressed in one call take as many steps as its
longest stream has symbols (at most 32,768), whatever their number.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["decompress", "decompress_many", "xxh64"]

_FRAME_MAGIC = 0xFD2FB528
_SKIPPABLE_MAGIC, _SKIPPABLE_MASK = 0x184D2A50, 0xFFFFFFF0
_MAX_BLOCK = 128 * 1024
_MAX_HUFFMAN_BITS = 11
_REPEAT_OFFSETS = (1, 4, 8)

# literal-length and match-length codes: (baseline, extra bits) (RFC 8878
# section 3.1.1.3.2.1.1)
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048, 4096, 8192,
                              16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_MAX_OFFSET_CODE = 31

# the predefined distributions (section 3.1.1.3.2.2): accuracy log, counts
_PREDEFINED = {
    "ll": (6, [4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
               -1, -1, -1, -1]),
    "ml": (6, [1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
               1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1]),
    "of": (5, [1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1]),
}
_MAX_ACCURACY = {"ll": 9, "ml": 9, "of": 8}
_MAX_SYMBOL = {"ll": len(_LL_BASE) - 1, "ml": len(_ML_BASE) - 1, "of": _MAX_OFFSET_CODE}


def _corrupt(what: str) -> ValueError:
    return ValueError(f"zstd: {what}")


# ------------------------------------------------------------------ bits ----


class _Backward:
    """A bitstream read from its end (RFC 8878 section 4.1): the last
    byte's highest set bit marks where it starts; reading below its first
    bit gives zeros, and ``pos`` (the bits left) goes negative."""

    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise _corrupt("a bitstream does not end in its marker bit")
        self.data = data
        self.pos = 8 * len(data) - 9 + data[-1].bit_length()

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        pos = self.pos
        if pos >= 0:
            lo = pos >> 3
            return (int.from_bytes(self.data[lo:(pos + n + 7) >> 3], "little") >> (pos & 7)) & ((1 << n) - 1)
        top = pos + n
        if top <= 0:
            return 0
        return (int.from_bytes(self.data[: (top + 7) >> 3], "little") & ((1 << top) - 1)) << -pos


def _highest_bit(value: int) -> int:
    return value.bit_length() - 1


# ------------------------------------------------------------------- FSE ----


class _FseTable:
    """An FSE decoding table: each state's symbol, bits to read and the
    base its next state adds them to."""

    __slots__ = ("log", "symbol", "bits", "base")

    def __init__(self, log: int, symbol: List[int], bits: List[int], base: List[int]):
        self.log, self.symbol, self.bits, self.base = log, symbol, bits, base

    @classmethod
    def from_counts(cls, log: int, counts: Sequence[int]) -> "_FseTable":
        """The table of a normalised distribution (section 4.1.1)."""
        size = 1 << log
        symbol = [0] * size
        next_desc = [0] * len(counts)
        high = size
        for s, c in enumerate(counts):
            if c == -1:  # "less than 1": one cell at the top of the table
                high -= 1
                symbol[high] = s
                next_desc[s] = 1
        step, mask, pos = (size >> 1) + (size >> 3) + 3, size - 1, 0
        for s, c in enumerate(counts):
            if c <= 0:
                continue
            next_desc[s] = c
            for _ in range(c):
                symbol[pos] = s
                pos = (pos + step) & mask
                while pos >= high:
                    pos = (pos + step) & mask
        if pos != 0:
            raise _corrupt("an FSE distribution does not fill its table")
        bits, base = [0] * size, [0] * size
        for i in range(size):
            desc = next_desc[symbol[i]]
            next_desc[symbol[i]] += 1
            bits[i] = log - _highest_bit(desc)
            base[i] = (desc << bits[i]) - size
        return cls(log, symbol, bits, base)

    @classmethod
    def rle(cls, symbol: int) -> "_FseTable":
        return cls(0, [symbol], [0], [0])


def _read_fse_counts(data: bytes, start: int, end: int, max_log: int, max_symbol: int):
    """A normalised distribution read forward from ``data[start:end]``
    (section 4.1.1): ``(accuracy log, counts, the byte after it)``."""
    value = int.from_bytes(data[start:end], "little")
    bit = 0

    def read(n):
        nonlocal bit
        out = (value >> bit) & ((1 << n) - 1)
        bit += n
        return out

    log = 5 + read(4)
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} above its maximum {max_log}")
    remaining, counts = 1 << log, []
    while remaining > 0:
        if len(counts) > max_symbol:
            raise _corrupt("an FSE distribution names more symbols than its alphabet")
        nbits = _highest_bit(remaining + 1) + 1
        val = read(nbits)
        lower_mask = (1 << (nbits - 1)) - 1
        threshold = (1 << nbits) - 1 - (remaining + 1)
        if (val & lower_mask) < threshold:
            bit -= 1
            val &= lower_mask
        elif val > lower_mask:
            val -= threshold
        count = val - 1
        remaining -= -count if count < 0 else count
        counts.append(count)
        if count == 0:
            while True:
                repeat = read(2)
                counts.extend([0] * repeat)
                if repeat != 3:
                    break
    if remaining != 0 or len(counts) > max_symbol + 1:
        raise _corrupt("an FSE distribution does not sum to its table size")
    after = start + ((bit + 7) >> 3)
    if after > end:
        raise _corrupt("an FSE distribution runs past its section")
    return log, counts, after


_PREDEFINED_TABLES: dict = {}


def _predefined(kind: str) -> _FseTable:
    if kind not in _PREDEFINED_TABLES:
        _PREDEFINED_TABLES[kind] = _FseTable.from_counts(*_PREDEFINED[kind])
    return _PREDEFINED_TABLES[kind]


# --------------------------------------------------------------- Huffman ----


class _HuffmanTable:
    """A Huffman decoding table of ``2**max_bits`` entries (section 4.2.2):
    the symbol and code length of every ``max_bits`` prefix."""

    __slots__ = ("max_bits", "symbol", "bits")

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w > 0)
        if total == 0:
            raise _corrupt("a Huffman table with no weights")
        max_bits = _highest_bit(total) + 1
        left = (1 << max_bits) - total
        if left & (left - 1):
            raise _corrupt("Huffman weights do not complete a power of two")
        weights = list(weights) + [_highest_bit(left) + 1]
        if max_bits > _MAX_HUFFMAN_BITS or len(weights) > 256:
            raise _corrupt(f"a Huffman table of {max_bits} bits and {len(weights)} symbols")
        nbits = [max_bits + 1 - w if w > 0 else 0 for w in weights]
        rank_count = [0] * (max_bits + 1)
        for b in nbits:
            rank_count[b] += 1
        size = 1 << max_bits
        symbol = np.zeros(size, np.uint8)
        bits = np.zeros(size, np.uint8)
        rank_start = [0] * (max_bits + 2)
        for b in range(max_bits, 0, -1):
            rank_start[b - 1] = rank_start[b] + rank_count[b] * (1 << (max_bits - b))
            bits[rank_start[b]:rank_start[b - 1]] = b
        for s, b in enumerate(nbits):
            if b:
                span = 1 << (max_bits - b)
                symbol[rank_start[b]:rank_start[b] + span] = s
                rank_start[b] += span
        self.max_bits, self.symbol, self.bits = max_bits, symbol, bits


def _read_huffman_table(data: bytes, start: int, end: int):
    """The Huffman tree description at ``data[start]`` (section 4.2.1):
    ``(table, the byte after it)``."""
    if start >= end:
        raise _corrupt("a Huffman tree description runs past its section")
    header = data[start]
    if header >= 128:  # direct: 4 bits a weight
        count = header - 127
        stop = start + 1 + (count + 1) // 2
        if stop > end:
            raise _corrupt("Huffman weights run past their section")
        weights = []
        for byte in data[start + 1:stop]:
            weights += [byte >> 4, byte & 15]
        return _HuffmanTable(weights[:count]), stop
    stop = start + 1 + header
    if stop > end:
        raise _corrupt("FSE-coded Huffman weights run past their section")
    log, counts, after = _read_fse_counts(data, start + 1, stop, 6, 255)
    table = _FseTable.from_counts(log, counts)
    bits = _Backward(data[after:stop])
    states = [bits.read(log), bits.read(log)]
    weights: List[int] = []
    which = 0
    while True:  # two interleaved states until the stream overflows
        state = states[which]
        weights.append(table.symbol[state])
        states[which] = table.base[state] + bits.read(table.bits[state])
        if bits.pos < 0:
            weights.append(table.symbol[states[1 - which]])
            break
        which = 1 - which
        if len(weights) > 255:
            raise _corrupt("too many Huffman weights")
    return _HuffmanTable(weights), stop


# ------------------------------------------------------------- parsing ----


class _Streams:
    """Huffman streams awaiting decoding: their bytes, symbol counts and
    tables, and where each stream's symbols go."""

    def __init__(self):
        self.data: List[bytes] = []
        self.counts: List[int] = []
        self.tables: List[_HuffmanTable] = []
        self.total = 0

    def add(self, data: bytes, count: int, table: _HuffmanTable) -> int:
        """Queue a stream of ``count`` symbols; returns where they start in
        the shared output."""
        start = self.total
        self.data.append(data)
        self.counts.append(count)
        self.tables.append(table)
        self.total += count
        return start


class _Frame:
    """A parsed frame: its blocks as ``("bytes", b)`` or ``("block",
    literals, sequences)`` where literals is bytes or a ``(start, size)``
    range of the decoded Huffman symbols and sequences an ``(n, 3)`` list
    of (literal length, match length, offset); its content size and
    checksum when the frame carries them."""

    __slots__ = ("blocks", "content_size", "checksum")

    def __init__(self):
        self.blocks: list = []
        self.content_size: Optional[int] = None
        self.checksum: Optional[int] = None


class _FrameState:
    """What a frame's blocks hand on: the last Huffman table, the last FSE
    table of each kind, and the repeat offsets."""

    def __init__(self):
        self.huffman: Optional[_HuffmanTable] = None
        self.fse = {"ll": None, "of": None, "ml": None}
        self.offsets = list(_REPEAT_OFFSETS)


def _parse_frames(data: bytes, streams: _Streams) -> List[_Frame]:
    frames, pos = [], 0
    while pos < len(data):
        if len(data) - pos < 4:
            raise _corrupt("trailing bytes after the last frame")
        magic = int.from_bytes(data[pos:pos + 4], "little")
        if magic & _SKIPPABLE_MASK == _SKIPPABLE_MAGIC:
            if len(data) - pos < 8:
                raise _corrupt("a truncated skippable frame")
            pos += 8 + int.from_bytes(data[pos + 4:pos + 8], "little")
            if pos > len(data):
                raise _corrupt("a truncated skippable frame")
            continue
        if magic != _FRAME_MAGIC:
            raise _corrupt(f"bad frame magic {magic:#010x}")
        try:
            frame, pos = _parse_frame(data, pos + 4, streams)
        except IndexError:  # a field read past the end of its block
            raise _corrupt("a truncated block") from None
        frames.append(frame)
    return frames


def _parse_frame(data: bytes, pos: int, streams: _Streams):
    frame, state = _Frame(), _FrameState()
    if pos >= len(data):
        raise _corrupt("a truncated frame header")
    descriptor = data[pos]
    pos += 1
    if descriptor & 0x08:
        raise _corrupt("the frame header's reserved bit is set")
    single_segment = bool(descriptor & 0x20)
    has_checksum = bool(descriptor & 0x04)
    did_size = (0, 1, 2, 4)[descriptor & 3]
    fcs_size = (1 if single_segment else 0, 2, 4, 8)[descriptor >> 6]
    if not single_segment:
        pos += 1  # the window descriptor: the whole output is kept, any window fits
    if pos + did_size + fcs_size > len(data):
        raise _corrupt("a truncated frame header")
    if did_size and int.from_bytes(data[pos:pos + did_size], "little"):
        raise ValueError("zstd: frames that need a dictionary are not supported")
    pos += did_size
    if fcs_size:
        size = int.from_bytes(data[pos:pos + fcs_size], "little")
        frame.content_size = size + 256 if fcs_size == 2 else size
        pos += fcs_size
    while True:
        if pos + 3 > len(data):
            raise _corrupt("a truncated block header")
        header = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, kind, size = header & 1, (header >> 1) & 3, header >> 3
        if kind == 0:  # raw
            if pos + size > len(data) or size > _MAX_BLOCK:
                raise _corrupt("a truncated raw block")
            frame.blocks.append(("bytes", bytes(data[pos:pos + size])))
            pos += size
        elif kind == 1:  # RLE: one byte, repeated
            if pos + 1 > len(data) or size > _MAX_BLOCK:
                raise _corrupt("a truncated RLE block")
            frame.blocks.append(("bytes", bytes(data[pos:pos + 1]) * size))
            pos += 1
        elif kind == 2:
            if pos + size > len(data) or size > _MAX_BLOCK:
                raise _corrupt("a truncated compressed block")
            frame.blocks.append(_parse_block(bytes(data[pos:pos + size]), state, streams))
            pos += size
        else:
            raise _corrupt("a block of the reserved type")
        if last:
            break
    if has_checksum:
        if pos + 4 > len(data):
            raise _corrupt("a truncated content checksum")
        frame.checksum = int.from_bytes(data[pos:pos + 4], "little")
        pos += 4
    return frame, pos


def _parse_block(block: bytes, state: _FrameState, streams: _Streams):
    literals, pos = _parse_literals(block, state, streams)
    sequences = _parse_sequences(block, pos, state)
    return ("block", literals, sequences)


def _parse_literals(block: bytes, state: _FrameState, streams: _Streams):
    """The literals section: ``(bytes or (start, size) of decoded symbols,
    the byte after it)``."""
    if not block:
        raise _corrupt("an empty compressed block")
    b0 = block[0]
    kind, size_format = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw or RLE
        if size_format in (0, 2):
            size, pos = b0 >> 3, 1
        elif size_format == 1:
            size, pos = (b0 >> 4) + (block[1] << 4), 2
        else:
            size, pos = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        if pos > len(block):
            raise _corrupt("a truncated literals header")
        if kind == 0:
            if pos + size > len(block):
                raise _corrupt("raw literals run past their block")
            return block[pos:pos + size], pos + size
        if pos + 1 > len(block):
            raise _corrupt("truncated RLE literals")
        return block[pos:pos + 1] * size, pos + 1
    header_size, field = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[size_format]
    if header_size > len(block):
        raise _corrupt("a truncated literals header")
    header = int.from_bytes(block[:header_size], "little")
    mask = (1 << field) - 1
    regenerated, compressed = (header >> 4) & mask, (header >> (4 + field)) & mask
    pos, end = header_size, header_size + compressed
    if end > len(block) or regenerated > _MAX_BLOCK:
        raise _corrupt("Huffman literals run past their block")
    if kind == 2:
        state.huffman, pos = _read_huffman_table(block, pos, end)
    elif state.huffman is None:
        raise _corrupt("treeless literals with no earlier Huffman table")
    table = state.huffman
    if size_format == 0:  # one stream
        start = streams.add(block[pos:end], regenerated, table)
        return (start, regenerated), end
    if pos + 6 > end:
        raise _corrupt("a truncated jump table")
    sizes = [int.from_bytes(block[pos + 2 * i:pos + 2 * i + 2], "little") for i in range(3)]
    pos += 6
    sizes.append(end - pos - sum(sizes))
    share = (regenerated + 3) // 4
    counts = [share, share, share, regenerated - 3 * share]
    if sizes[3] < 0 or counts[3] < 0:
        raise _corrupt("a jump table past its literals")
    start = None
    for size, count in zip(sizes, counts):
        at = streams.add(block[pos:pos + size], count, table)
        start = at if start is None else start
        pos += size
    return (start, regenerated), end


def _sequence_table(kind: str, mode: int, block: bytes, pos: int, state: _FrameState):
    if mode == 0:
        table = _predefined(kind)
    elif mode == 1:
        if pos >= len(block):
            raise _corrupt("a truncated RLE table")
        if block[pos] > _MAX_SYMBOL[kind]:
            raise _corrupt(f"an RLE {kind} code {block[pos]} out of range")
        table, pos = _FseTable.rle(block[pos]), pos + 1
    elif mode == 2:
        log, counts, pos = _read_fse_counts(block, pos, len(block), _MAX_ACCURACY[kind], _MAX_SYMBOL[kind])
        table = _FseTable.from_counts(log, counts)
    else:
        table = state.fse[kind]
        if table is None:
            raise _corrupt(f"a repeated {kind} table with no earlier one")
    state.fse[kind] = table
    return table, pos


def _parse_sequences(block: bytes, pos: int, state: _FrameState) -> list:
    """The sequences section: a list of (literal length, match length,
    offset) with repeat offsets resolved."""
    if pos >= len(block):
        raise _corrupt("a compressed block without its sequences section")
    b0 = block[pos]
    if b0 == 0:
        if pos + 1 != len(block):
            raise _corrupt("bytes after an empty sequences section")
        return []
    if b0 < 128:
        count, pos = b0, pos + 1
    elif b0 < 255:
        count, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        count, pos = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= len(block):
        raise _corrupt("a truncated sequences header")
    modes = block[pos]
    pos += 1
    if modes & 3:
        raise _corrupt("the sequences header's reserved bits are set")
    ll, pos = _sequence_table("ll", modes >> 6, block, pos, state)
    of, pos = _sequence_table("of", (modes >> 4) & 3, block, pos, state)
    ml, pos = _sequence_table("ml", (modes >> 2) & 3, block, pos, state)
    bits = _Backward(block[pos:])
    read = bits.read
    ll_state, of_state, ml_state = read(ll.log), read(of.log), read(ml.log)
    rep = state.offsets
    out = []
    for i in range(count):
        of_code, ll_code, ml_code = of.symbol[of_state], ll.symbol[ll_state], ml.symbol[ml_state]
        if of_code > _MAX_OFFSET_CODE:
            raise _corrupt(f"offset code {of_code} out of range")
        offset_value = (1 << of_code) + read(of_code)
        match = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
        literal = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
        if offset_value > 3:
            offset = offset_value - 3
            rep[:] = [offset, rep[0], rep[1]]
        else:
            index = offset_value - 1 + (literal == 0)
            if index == 0:
                offset = rep[0]
            else:
                offset = rep[index] if index < 3 else rep[0] - 1
                if index > 1:
                    rep[2] = rep[1]
                rep[1] = rep[0]
                rep[0] = offset
        if offset <= 0:
            raise _corrupt("a match offset of 0")
        out.append((literal, match, offset))
        if i + 1 < count:
            ll_state = ll.base[ll_state] + read(ll.bits[ll_state])
            ml_state = ml.base[ml_state] + read(ml.bits[ml_state])
            of_state = of.base[of_state] + read(of.bits[of_state])
    if bits.pos != 0:
        raise _corrupt("the sequences bitstream does not end where its sequences do")
    return out


# ---------------------------------------------------- Huffman decoding ----


def _decode_streams(streams: _Streams) -> np.ndarray:
    """Every queued Huffman stream decoded, into one array of
    ``streams.total`` symbols.  Each stream is read from its end (section
    4.2.2): its next ``max_bits`` bits index its table, which gives a
    symbol and how many of those bits it took.  One numpy step does that
    for every stream not yet done, at each stream's bit index into one
    buffer of all of them."""
    n = len(streams.data)
    out = np.empty(streams.total, np.uint8)
    if n == 0:
        return out
    counts = np.asarray(streams.counts, np.int64)
    order = np.argsort(-counts, kind="stable")  # the streams still going are a prefix
    pad = 2  # zero bytes before each stream: a read reaches 11 bits below its first bit
    lengths = np.fromiter((len(streams.data[i]) for i in order), np.int64, n)
    base = pad + np.concatenate([[0], np.cumsum(lengths + pad)[:-1]])
    buf = np.zeros(int(base[-1] + lengths[-1]) + 4, np.uint8)
    offsets, tables = {}, []
    table_offset = np.empty(n, np.int64)
    max_bits = np.empty(n, np.int64)
    total_bits = np.empty(n, np.int64)
    for j, i in enumerate(order):
        data = streams.data[i]
        if not data or data[-1] == 0:
            raise _corrupt("a Huffman stream does not end in its marker bit")
        buf[base[j]:base[j] + len(data)] = np.frombuffer(data, np.uint8)
        table = streams.tables[i]
        if id(table) not in offsets:
            offsets[id(table)] = sum(len(t.symbol) for t in tables)
            tables.append(table)
        table_offset[j] = offsets[id(table)]
        max_bits[j] = table.max_bits
        total_bits[j] = 8 * len(data) - 9 + data[-1].bit_length()
    index = np.int32 if 8 * len(buf) < 2**31 else np.int64
    # a table entry: its symbol, and its code's length above bit 8
    entries = np.concatenate([t.symbol.astype(np.int32) | (t.bits.astype(np.int32) << 8) for t in tables])
    # 31 bits from every byte on (a read needs at most 7 + 11)
    b = buf.astype(index)
    window = b[:-3] | (b[1:-2] << 8) | (b[2:-1] << 16) | ((b[3:] & 0x7F) << 24)
    del b
    mask = ((1 << max_bits) - 1).astype(index)
    table_offset = table_offset.astype(index)
    # each stream's next max_bits bits start at this bit of buf, going down
    low = (8 * base + total_bits - max_bits).astype(index)
    first = low.copy()
    sorted_counts = counts[order]
    steps = int(sorted_counts[0])
    decoded = np.empty((steps, n), np.uint8)  # step k: symbol k of every stream
    t = np.empty(n, index)
    w = np.empty(n, index)
    e = np.empty(n, np.int32)
    # the number of streams with more than k symbols, for every k
    active = np.searchsorted(-sorted_counts, -np.arange(steps), side="left")
    for k, m in enumerate(active.tolist()):
        lm, tm, wm, em = low[:m], t[:m], w[:m], e[:m]
        np.right_shift(lm, 3, out=tm)
        np.take(window, tm, out=wm)
        np.bitwise_and(lm, 7, out=tm)
        np.right_shift(wm, tm, out=wm)
        np.bitwise_and(wm, mask[:m], out=wm)
        np.add(wm, table_offset[:m], out=wm)
        np.take(entries, wm, out=em)
        decoded[k, :m] = em  # the symbol: the entry's low byte
        np.right_shift(em, 8, out=em)
        np.subtract(lm, em, out=lm)
    if not np.array_equal(first - low, total_bits):
        raise _corrupt("a Huffman stream's bits do not match its symbol count")
    decoded = np.ascontiguousarray(decoded.T)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    for j, i in enumerate(order.tolist()):
        out[starts[i]:starts[i] + counts[i]] = decoded[j, :counts[i]]
    return out


# -------------------------------------------------------------- output ----


def _execute(frame: _Frame, symbols: np.ndarray) -> bytes:
    out = bytearray()
    for block in frame.blocks:
        if block[0] == "bytes":
            out += block[1]
            continue
        _, literals, sequences = block
        if isinstance(literals, tuple):
            start, size = literals
            literals = symbols[start:start + size].tobytes()
        block_start = len(out)
        used = 0
        for literal, match, offset in sequences:
            if used + literal > len(literals):
                raise _corrupt("a sequence takes more literals than its block has")
            out += literals[used:used + literal]
            used += literal
            begin = len(out) - offset
            if begin < 0:
                raise _corrupt("a match offset before the start of the frame")
            if offset >= match:
                out += out[begin:begin + match]
            else:  # the match overlaps its own output: repeat the offset's bytes
                pattern = out[begin:]
                out += (pattern * (match // offset + 1))[:match]
        out += literals[used:]
        if len(out) - block_start > _MAX_BLOCK:
            raise _corrupt("a block decodes to more than 128 KiB")
    content = bytes(out)
    if frame.content_size is not None and len(content) != frame.content_size:
        raise _corrupt(f"a frame decoded to {len(content)} bytes; its header says {frame.content_size}")
    if frame.checksum is not None and xxh64(content) & 0xFFFFFFFF != frame.checksum:
        raise _corrupt("content checksum mismatch")
    return content


def decompress_many(buffers: Sequence[bytes]) -> List[bytes]:
    """Each buffer (zstd frames, one after another, skippable frames among
    them) decompressed; the Huffman streams of all of them decoded
    together."""
    streams = _Streams()
    parsed = [_parse_frames(memoryview(b).tobytes(), streams) for b in buffers]
    symbols = _decode_streams(streams)
    return [b"".join(_execute(frame, symbols) for frame in frames) for frames in parsed]


def decompress(data: bytes) -> bytes:
    """``data`` (zstd frames, one after another) decompressed."""
    return decompress_many([data])[0]


# ----------------------------------------------------------------- XXH64 ----

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane_p2: int) -> int:
    return (_rotl((acc + lane_p2) & _M64, 31) * _P1) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``: the lanes' products with the second prime taken
    in numpy (wrapping uint64), the four accumulators folded over the
    32-byte stripes in order."""
    data = bytes(data)
    n = len(data)
    stripes = n // 32
    h = (seed + _P5) & _M64
    if stripes:
        lanes = np.frombuffer(data, "<u8", count=4 * stripes).reshape(stripes, 4)
        products = (lanes * np.uint64(_P2)).tolist()
        v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed & _M64, (seed - _P1) & _M64]
        v1, v2, v3, v4 = v
        for a, b, c, d in products:
            v1, v2, v3, v4 = _round(v1, a), _round(v2, b), _round(v3, c), _round(v4, d)
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for acc in (v1, v2, v3, v4):
            h = (((h ^ _round(0, (acc * _P2) & _M64)) * _P1) + _P4) & _M64
    h = (h + n) & _M64
    pos = 32 * stripes
    while pos + 8 <= n:
        lane = int.from_bytes(data[pos:pos + 8], "little")
        h ^= _round(0, (lane * _P2) & _M64)
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        pos += 8
    if pos + 4 <= n:
        h ^= (int.from_bytes(data[pos:pos + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        pos += 4
    while pos < n:
        h ^= (data[pos] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        pos += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)
