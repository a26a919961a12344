"""The port's zstd decoder (``tvc_ai_torch.utils.zstd``) against ``zstandard``.

Every frame is written by the ``zstandard`` module (libzstd) at levels 1, 3,
19 and 22, with and without a content checksum and a content size, over data
that exercises each part of RFC 8878: zeros (RLE blocks), random bytes (raw
blocks), float32 weights (Huffman-coded literals in 4 streams), repetitive
text (sequences with FSE tables, repeat offsets, treeless literals across
blocks), a few symbols (RLE and predefined sequence tables), a few hundred
bytes of text (single-stream Huffman literals), zero runs between a token
(the shifted repeat offset ``rep1 - 1``), short inputs (raw literals). Also
concatenated and skippable frames, a hypothesis round trip, XXH64 against
the checksums libzstd writes, and ``ValueError`` on truncated, corrupt,
dictionary and trailing bytes.
"""

from __future__ import annotations

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tvc_ai_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")

LEVELS = (1, 3, 19, 22)


def _text() -> bytes:
    return b"".join(b"gimbal %d tilts %.2f rad at t=%d; " % (i % 97, (i % 13) / 7, i)
                    for i in range(12_000))


def samples() -> dict[str, bytes]:
    rng = np.random.default_rng(0)
    weights = (0.05 * rng.standard_normal(60_000)).astype(np.float32)
    words = [b"the ", b"rocket ", b"gimbal ", b"tilts ", b"a ", b"thrust "]
    return {
        # a few hundred skewed bytes: Huffman literals in one stream
        "small_text": b"".join(words[i] for i in rng.integers(0, 6, 120)),
        # runs of zeros between one repeated token: the "rep1 - 1" offset
        "zero_runs": b"".join(b"\x00" * int(k) + bytes(range(1, 9))
                              for k in rng.integers(1, 4, 3000)),
        "zeros": bytes(400_000),
        "random": rng.bytes(150_000),
        "float32_weights": weights.tobytes(),
        "text": _text(),
        "few_symbols": rng.integers(0, 3, 200_000).astype(np.uint8).tobytes(),
        "short": b"thrust vector control",
        "empty": b"",
    }


SAMPLES = samples()


def compress(data: bytes, level: int, checksum: bool, content_size: bool = True) -> bytes:
    return zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                    write_content_size=content_size).compress(data)


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(SAMPLES))
def test_matches_zstandard(name, level, checksum):
    data = SAMPLES[name]
    frame = compress(data, level, checksum)
    assert zstd.decompress(frame) == data == zstandard.ZstdDecompressor().decompress(frame)


@pytest.mark.parametrize("name", ["text", "float32_weights", "zeros"])
def test_frames_without_content_size(name):
    """A window descriptor and no content size: the output grows as it goes
    (the streaming writer, as tensorstore's frames have it)."""
    data = SAMPLES[name]
    cctx = zstandard.ZstdCompressor(level=3, write_content_size=False, write_checksum=True)
    out = cctx.compressobj()
    frame = out.compress(data) + out.flush()
    assert frame[4] & 0xE0 == 0   # no content size, not single-segment
    assert zstd.decompress(frame) == data


def test_concatenated_and_skippable_frames():
    a, b = SAMPLES["text"][:50_000], SAMPLES["float32_weights"][:30_000]
    skippable = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    stream = compress(a, 3, True) + skippable + compress(b, 19, False) + skippable
    assert zstd.decompress(stream) == a + b


def test_xxh64_matches_the_checksums_libzstd_writes():
    rng = np.random.default_rng(1)
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 63, 64, 100, 1000):
        data = rng.bytes(n)
        frame = compress(data, 1, True)
        assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:], "little"), n


@settings(max_examples=60, deadline=None)
@given(data=st.one_of(st.binary(max_size=3000),
                      st.lists(st.sampled_from([b"ab", b"rocket", b"\x00" * 7, b"xyz!"]),
                               max_size=800).map(b"".join)),
       level=st.sampled_from(LEVELS), checksum=st.booleans(), content_size=st.booleans())
def test_hypothesis_round_trip(data, level, checksum, content_size):
    assert zstd.decompress(compress(data, level, checksum, content_size)) == data


def test_truncated_frames_raise():
    frame = compress(SAMPLES["text"], 3, True)
    for cut in (1, 5, 9, len(frame) // 2, len(frame) - 1):
        with pytest.raises(ValueError):
            zstd.decompress(frame[:cut])
    with pytest.raises(ValueError):
        zstd.decompress(b"")


def test_corrupt_frames_raise():
    rng = np.random.default_rng(2)
    frame = bytearray(compress(SAMPLES["text"], 19, True))
    raised = 0
    for _ in range(40):
        bad = bytearray(frame)
        i = int(rng.integers(6, len(bad)))
        bad[i] ^= 1 << int(rng.integers(0, 8))
        try:
            out = zstd.decompress(bytes(bad))
        except ValueError:
            raised += 1
        else:   # a flip the format cannot see is caught by the checksum
            pytest.fail(f"flip at {i} decoded to {len(out)} bytes")
    assert raised == 40
    with pytest.raises(ValueError, match="not a frame"):
        zstd.decompress(b"\x00" * 16)


def test_trailing_bytes_raise():
    frame = compress(SAMPLES["short"], 3, False)
    with pytest.raises(ValueError, match="left over"):
        zstd.decompress(frame + b"\x01\x02")
    with pytest.raises(ValueError, match="not a frame"):
        zstd.decompress(frame + b"\x00" * 9)


def test_dictionary_frames_raise():
    samples_ = [b"rocket %d gimbal %d" % (i, i * 7) for i in range(400)]
    dictionary = zstandard.train_dictionary(2048, samples_)
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples_[3])
    with pytest.raises(ValueError, match="dictionary"):
        zstd.decompress(frame)
