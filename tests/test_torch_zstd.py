"""The port's zstd decoder (``davo_tpu_torch/utils/zstd.py``, numpy only)
against the ``zstandard`` package, which is a reference here and never
used by the port: byte-identical output on a corpus that reaches the
format's features (text, runs, random bytes, float arrays, inputs without
literals or with one literal byte a sequence; levels 1, 3, 19 and -5; one
block and many; the content checksum on and off; the content size present
and absent), concatenated and skippable frames, frames built by hand for
what the compressor seldom writes (RLE literals, raw literals behind a
3-byte header), and ``ValueError`` for what the decoder does not
implement or what does not add up, never wrong bytes.
"""

from pathlib import Path

import numpy as np
import pytest

from davo_tpu_torch.utils import zstd
from davo_tpu_torch.utils.zstd import decompress, decompress_many, xxh64

zstandard = pytest.importorskip("zstandard")

REPO = Path(__file__).resolve().parents[1]
TEXT = (REPO / "davo_tpu" / "cli.py").read_bytes()


def _corpus():
    rng = np.random.default_rng(0)
    table = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    one_literal = bytearray(table)  # 'qqqqqqq' and a 64-byte copy: RLE literal-length tables
    while len(one_literal) < 150_000:
        a = int(rng.integers(0, 4096 - 64))
        one_literal += b"qqqqqqq" + table[a:a + 64]
    no_literals = bytearray(table)  # copies only: RLE literal- and match-length tables
    for i in range(2000):
        no_literals += table[(i * 97) % 4000:(i * 97) % 4000 + 48]
    return {
        "empty": b"",
        "one_byte": b"x",
        "short_text": TEXT[:180],  # one Huffman stream
        "text": TEXT[:60_000],  # every repeat-offset case at level 19
        "random": rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes(),  # raw blocks
        "runs": np.repeat(rng.integers(0, 256, 2000, dtype=np.uint8), rng.integers(1, 40, 2000)).tobytes(),
        "one_value": b"\x07" * 300_000,  # RLE blocks after the first
        "floats": rng.standard_normal(40_000).astype(np.float32).tobytes(),
        "doubles": rng.standard_normal(3000).tobytes(),
        "one_literal": bytes(one_literal),
        "no_literals": bytes(no_literals),
        "small_alphabet": rng.integers(0, 3, 30_000, dtype=np.uint8).tobytes(),
    }


CORPUS = _corpus()
LEVELS = (1, 3, 19, -5)


@pytest.mark.parametrize("name", sorted(CORPUS))
@pytest.mark.parametrize("level", LEVELS)
def test_decoder_matches_zstandard(level, name):
    data = CORPUS[name]
    one_shot = zstandard.ZstdCompressor(level=level, write_checksum=True).compress(data)
    stream = zstandard.ZstdCompressor(level=level, write_checksum=False, write_content_size=False).compressobj()
    streamed = (stream.compress(data[: len(data) // 2]) + stream.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                + stream.compress(data[len(data) // 2:]) + stream.flush())
    assert decompress(one_shot) == data
    assert decompress(streamed) == data


def test_concatenated_skippable_and_batched_frames():
    parts = [CORPUS["text"][:5000], CORPUS["floats"][:8000], b"", CORPUS["runs"][:3000]]
    frames = [zstandard.ZstdCompressor(level=level, write_checksum=level % 2 == 0).compress(p)
              for p, level in zip(parts, (1, 2, 3, 19))]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"hello"
    joined = frames[0] + skippable + frames[1] + frames[2] + skippable + frames[3]
    assert decompress(joined) == b"".join(parts)
    # many buffers at once (their Huffman streams decoded together) as each alone
    assert decompress_many(frames + [joined]) == parts + [b"".join(parts)]


def _frame(block: bytes, content: bytes, last: bool = True) -> bytes:
    """A single-segment frame (content size in one byte) of one
    compressed block."""
    header = (0xFD2FB528).to_bytes(4, "little") + bytes([0x20, len(content)])
    return header + ((len(block) << 3) | (2 << 1) | int(last)).to_bytes(3, "little") + block


@pytest.mark.parametrize("size", [5, 31, 200])
def test_hand_built_literal_sections(size):
    """RLE literals (1- and 2-byte headers) and raw literals behind a
    3-byte header, each block with no sequence."""
    if size < 32:
        rle = bytes([(size << 3) | 1, 0x41])
    else:
        rle = bytes([1 | (1 << 2) | ((size & 15) << 4), size >> 4, 0x41])
    assert decompress(_frame(rle + b"\x00", b"A" * size)) == b"A" * size
    payload = bytes(range(size % 256))[:size] or b"z"
    raw = bytes([0 | (3 << 2) | ((len(payload) & 15) << 4), (len(payload) >> 4) & 0xFF, len(payload) >> 12])
    assert decompress(_frame(raw + payload + b"\x00", payload)) == payload


def test_what_the_decoder_does_not_take_raises():
    text = CORPUS["text"][:20_000]
    good = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(text)
    samples = [TEXT[i:i + 400] for i in range(0, len(TEXT) - 400, 97)]
    dictionary = zstandard.train_dictionary(2048, samples)
    with_id = zstandard.ZstdCompressor(level=3, dict_data=dictionary).compress(text)
    with pytest.raises(ValueError, match="dictionary"):
        decompress(with_id)
    # a raw-content dictionary has no id: its matches reach before the frame
    raw_dict = zstandard.ZstdCompressionDict(TEXT[:30_000], dict_type=zstandard.DICT_TYPE_RAWCONTENT)
    no_id = zstandard.ZstdCompressor(level=3, dict_data=raw_dict).compress(TEXT[:20_000])
    with pytest.raises(ValueError, match="before the start"):
        decompress(no_id)
    bad_checksum = good[:-1] + bytes([good[-1] ^ 1])
    with pytest.raises(ValueError, match="checksum"):
        decompress(bad_checksum)
    with pytest.raises(ValueError):
        decompress(good[:-9])  # truncated
    with pytest.raises(ValueError, match="trailing"):
        decompress(good + b"\x01")
    with pytest.raises(ValueError, match="magic"):
        decompress(b"\x00" * 8)
    reserved_bit = bytearray(good)
    reserved_bit[4] |= 0x08
    with pytest.raises(ValueError, match="reserved bit"):
        decompress(bytes(reserved_bit))
    reserved_block = _frame(b"", b"")[:6] + ((0 << 3) | (3 << 1) | 1).to_bytes(3, "little")
    with pytest.raises(ValueError, match="reserved type"):
        decompress(reserved_block)
    # a flipped bit inside the compressed data: an error, never other bytes
    for position in range(20, len(good) - 8, max(1, len(good) // 40)):
        damaged = bytearray(good)
        damaged[position] ^= 0x10
        try:
            out = decompress(bytes(damaged))
        except ValueError:
            continue
        assert out == text  # only the checksum could let a change through, and it did not


@pytest.mark.parametrize("data,expected", [
    (b"", 0xEF46DB3751D8E999), (b"a", 0xD24EC4F1A98C6E5B), (b"abc", 0x44BC2CF5AD770999),
])
def test_xxh64_known_values(data, expected):
    assert xxh64(data) == expected


def test_xxh64_is_the_frames_checksum():
    for n in (0, 7, 31, 32, 33, 100, 4097):
        data = CORPUS["random"][:n]
        frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
        assert xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little")


def test_huffman_table_rejects_weights_that_do_not_complete():
    with pytest.raises(ValueError, match="power of two"):
        zstd._HuffmanTable([1, 3])  # 1 + 4 = 5 of 8: the 3 left are no power of two
