"""The port's zstd decoder (``slice3d_tpu_torch/train/zstd.py``, its own C++
built with g++) against ``zstandard``, the reference implementation's
bindings, which only this test imports: every frame that ``zstandard``
writes decodes to the exact input; corrupt input raises ``ValueError`` and
never crashes the process; a frame that needs a dictionary is refused."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import zstandard
from hypothesis import given, settings, strategies as st

from slice3d_tpu_torch.train.zstd import crc32c, decompress

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LEVELS = (-5, 1, 3, 9, 19)


def _runs(rng, n_floats, run):
    """Quarter-step floats copied in runs of ``run`` from a pool: matches at
    many offsets, Huffman-coded literals."""
    pool = rng.integers(-8, 8, 4096).astype(np.float32) * 0.25
    starts = rng.integers(0, 4096 - run, n_floats // run)
    return np.concatenate([pool[s:s + run] for s in starts]).tobytes()


def _corpus():
    rng = np.random.default_rng(0)
    words = [rng.bytes(int(n)) for n in rng.integers(1, 12, 200)]
    return {
        "empty": b"",
        "one": b"x",
        "text": b"the quick brown fox jumps over the lazy dog; " * 40,
        "random_1k": rng.bytes(1000),
        "random_300k": rng.bytes(300_000),  # incompressible: raw blocks
        "zeros_1m": bytes(1 << 20),  # RLE blocks and literals
        "words_500k": b"".join(words[i] for i in rng.integers(0, 200, 80_000)),
        "normal_f32_1m": rng.standard_normal(1 << 18).astype(np.float32).tobytes(),
        "arange_i64": np.arange(60_000, dtype=np.int64).tobytes(),
        "runs_4m": _runs(rng, 1 << 20, 64),
    }


CORPUS = _corpus()


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("level", LEVELS)
def test_round_trip_matches_zstandard(level, checksum):
    """Every corpus entry at this level, with and without the XXH64 content
    checksum and the declared content size: the exact bytes back, as bytes
    (the size read from the frame, or found by growing) and into a
    preallocated array."""
    for name, data in CORPUS.items():
        if level == 19 and len(data) > (1 << 20):
            data = data[:1 << 20]  # level 19 compresses 4 MB in seconds
        for size in (True, False):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum,
                                             write_content_size=size).compress(data)
            assert decompress(frame) == data, (name, size)
        out = np.empty(len(data), np.uint8)
        assert decompress(frame, out=out) is out and out.tobytes() == data, name
        assert decompress(frame, size=len(data)).tobytes() == data, name


def _skippable(payload: bytes, nibble: int) -> bytes:
    return struct.pack("<II", 0x184D2A50 | nibble, len(payload)) + payload


@pytest.mark.parametrize("case", ["frames", "skippable", "streamed"])
def test_several_frames(case):
    """Frames back to back decode to their contents joined, skippable frames
    (any of the 16 magic numbers) contribute nothing, and a streamed frame
    (no content size, blocks flushed one by one) decodes too."""
    parts = [CORPUS["text"], CORPUS["arange_i64"], b"", CORPUS["random_1k"]]
    if case == "streamed":
        comp = zstandard.ZstdCompressor(level=3, write_checksum=True)
        stream = comp.compressobj()
        data = b"".join(stream.compress(p) + stream.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                        for p in parts) + stream.flush()
    else:
        frames = [zstandard.ZstdCompressor(level=lvl, write_checksum=lvl > 2).compress(p)
                  for lvl, p in zip(LEVELS, parts)]
        if case == "skippable":
            frames = [_skippable(b"meta" * k, k) + f for k, f in enumerate(frames)]
            frames.append(_skippable(b"", 15))
        data = b"".join(frames)
    assert decompress(data) == b"".join(parts)
    assert decompress(data, size=sum(map(len, parts))).tobytes() == b"".join(parts)
    with pytest.raises(ValueError, match="expected"):
        decompress(data, size=sum(map(len, parts)) - 1)


@settings(max_examples=60, deadline=None)
@given(data=st.binary(max_size=3000), repeat=st.integers(1, 40),
       level=st.sampled_from(LEVELS), checksum=st.booleans())
def test_random_inputs_round_trip(data, repeat, level, checksum):
    payload = data * repeat
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(payload)
    assert decompress(frame) == payload


def test_dictionary_frame_is_refused():
    samples = [b"sample %d of a dictionary training set, with words %d" % (i, i * 7)
               for i in range(2000)]
    dictionary = zstandard.train_dictionary(2048, samples)
    assert dictionary.dict_id() != 0
    frame = zstandard.ZstdCompressor(dict_data=dictionary).compress(samples[5])
    with pytest.raises(ValueError, match=f"dictionary {dictionary.dict_id()}"):
        decompress(frame)


def test_not_a_frame_raises():
    for data, match in ((b"", "empty"), (b"\x00" * 16, "not a zstd frame"),
                        (zstandard.ZstdCompressor().compress(b"abc") + b"\x01", "stray")):
        with pytest.raises(ValueError, match=match):
            decompress(data)


CORRUPT_SCRIPT = r"""
import sys
import numpy as np
import zstandard
from slice3d_tpu_torch.train.zstd import decompress

rng = np.random.default_rng(1)
pool = rng.integers(-8, 8, 4096).astype(np.float32) * 0.25
runs = np.concatenate([pool[s:s + 32] for s in rng.integers(0, 4000, 4000)]).tobytes()
sources = [runs, rng.standard_normal(30000).astype(np.float32).tobytes(),
           b"abcabcabd" * 5000, rng.bytes(5000)]
raised = kept = wrong = 0
for src in sources:
    for level in (1, 19):
        for checksum in (True, False):
            frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(src)
            trials = [frame[:n] for n in rng.integers(0, len(frame), 40)]
            for _ in range(150):
                m = bytearray(frame)
                for pos in rng.integers(0, len(m), int(rng.integers(1, 4))):
                    m[pos] ^= 1 << int(rng.integers(0, 8))
                trials.append(bytes(m))
            for k, t in enumerate(trials):
                try:
                    out = decompress(t)
                except ValueError:
                    raised += 1
                    continue
                assert k >= 40, "a truncated frame decoded"
                kept += 1
                wrong += out != src
                assert not checksum or out == src, "a checked frame decoded to other bytes"
print(raised, kept, wrong)
"""


def test_corrupt_frames_raise_and_never_crash():
    """Truncated frames (every one raises) and frames with 1-3 flipped bits
    (each raises, or decodes; to the original bytes where the frame carries
    its checksum), decoded in a subprocess so that a crash fails the test."""
    proc = subprocess.run([sys.executable, "-c", CORRUPT_SCRIPT], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    raised, kept, wrong = map(int, proc.stdout.split())
    assert raised > kept  # most damage is detected


@pytest.mark.parametrize("data,want", [(b"", 0), (b"a", 0xC1D04330),
                                       (b"123456789", 0xE3069283),
                                       (bytes(32), 0x8A9136AA), (b"\xff" * 32, 0x62A8AB43)])
def test_crc32c_known_values(data, want):
    """CRC-32C (Castagnoli) check values: RFC 3720 B.4 and the catalogue's."""
    assert crc32c(data) == want
