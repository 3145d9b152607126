"""The port's zstd decoder (``repro_torch/checkpoint/_zstd.py``) held
bit-exactly to ``zstandard``, which only this test imports: frames of every
shape the library writes (levels -5 to 19, with and without content size
and checksum, several blocks, inputs past the window, frames back to back
and skippable frames), the errors the decoder must raise, and a seeded fuzz
of byte flips in which every case runs under a time limit of its own and
either raises or yields bytes a crc32 rejects.
"""
import contextlib
import signal
import zlib

import numpy as np
import pytest
import zstandard

from proptest import cases
from repro_torch.checkpoint import _zstd, workers

CASE_SECONDS = 20


@contextlib.contextmanager
def time_limit(seconds: float):
    """Fail the case (instead of hanging the run) past ``seconds``."""
    def on_alarm(signum, frame):
        raise TimeoutError(f"zstd decode ran past {seconds} s")

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _compress(data: bytes, **kw) -> bytes:
    return zstandard.ZstdCompressor(**kw).compress(data)


def _inputs():
    rs = np.random.RandomState(0)
    text = b" ".join(rs.choice([b"tensor", b"layer", b"block", b"opt", b"m",
                                b"v", b"master", b"0.125", b"-3"], 20000))
    return {
        "empty": b"",
        "one_byte": b"a",
        "random": rs.bytes(5000),
        "repetitive": b"abc" * 20000,
        "zeros": bytes(300000),
        "long_matches": rs.bytes(4000) * 40,
        "text": text,
        "weights_f32": rs.standard_normal(60000).astype(np.float32).tobytes(),
        "small_alphabet": rs.randint(0, 5, 200000).astype(np.uint8).tobytes(),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decoder_equals_zstandard(name, level):
    data = INPUTS[name]
    with time_limit(CASE_SECONDS):
        assert bytes(_zstd.decompress(_compress(data, level=level))) == data


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
def test_frames_with_and_without_size_and_checksum(content_size, checksum):
    for name in ("one_byte", "text", "weights_f32"):
        data = INPUTS[name]
        frame = _compress(data, level=3, write_content_size=content_size,
                          write_checksum=checksum)
        # the flags are what the frame header says
        fhd = frame[4]
        assert bool(fhd & 4) == checksum
        assert bool(fhd >> 6 or fhd & 0x20) == content_size
        assert bytes(_zstd.decompress(frame)) == data


def test_several_blocks_and_input_beyond_the_window():
    rs = np.random.RandomState(1)
    head = rs.bytes(64 << 10)
    # 1.3 MiB through a 128 KiB window: repeats of ``head`` both past the
    # window and within it, several 128 KiB blocks
    data = head + rs.bytes(1 << 20) + head * 4
    for level in (1, 3, 19):
        params = zstandard.ZstdCompressionParameters.from_level(
            level, window_log=17, write_checksum=True)
        frame = zstandard.ZstdCompressor(
            compression_params=params).compress(data)
        dp = zstandard.get_frame_parameters(frame)
        assert dp.window_size == 1 << 17 and dp.has_checksum
        with time_limit(60):
            assert bytes(_zstd.decompress(frame)) == data


def test_concatenated_and_skippable_frames():
    parts = [INPUTS["text"][:7000], b"", INPUTS["random"],
             INPUTS["repetitive"][:999]]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"hello"
    blob = skip + b"".join(_compress(p, level=3, write_checksum=bool(i % 2))
                           + (skip if i == 1 else b"")
                           for i, p in enumerate(parts))
    assert bytes(_zstd.decompress(blob)) == b"".join(parts)


def test_seeded_property_over_sizes_and_levels():
    def gen(rs):
        n = int(rs.choice([0, 1, 2, 17, 255, 4096, 70000, 200000]))
        alpha = int(rs.choice([2, 16, 256]))
        run = int(rs.choice([1, 8, 300]))
        sym = rs.randint(0, alpha, -(-n // run) if n else 0).astype(np.uint8)
        data = np.repeat(sym, run)[:n].tobytes()
        level = int(rs.choice([-5, -1, 1, 3, 6, 12, 19]))
        return data, level, bool(rs.randint(2))

    for data, level, ck in cases(16, gen):
        with time_limit(CASE_SECONDS):
            out = _zstd.decompress(_compress(data, level=level,
                                             write_checksum=ck))
        assert bytes(out) == data, (len(data), level, ck)


def test_xxh64_against_frame_checksums():
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 64, 1000):
        data = bytes(range(256)) * 4
        frame = _compress(data[:n], level=1, write_checksum=True)
        want = int.from_bytes(frame[-4:], "little")
        assert _zstd.xxh64(data[:n]) & 0xFFFFFFFF == want, n


# ------------------------------------------------------------------ errors
def test_wrong_checksum_raises():
    frame = bytearray(_compress(INPUTS["text"], level=3,
                                write_checksum=True))
    frame[-1] ^= 0x40
    with pytest.raises(_zstd.ZstdError, match="checksum"):
        _zstd.decompress(bytes(frame))


@pytest.mark.parametrize("name", ["one_byte", "text", "weights_f32"])
def test_truncation_raises(name):
    frame = _compress(INPUTS[name], level=3)
    for cut in sorted({1, 4, 5, len(frame) // 2, len(frame) - 1}):
        with pytest.raises(_zstd.ZstdError):
            _zstd.decompress(frame[:cut])
    with pytest.raises(_zstd.ZstdError):
        _zstd.decompress(b"")
    with pytest.raises(_zstd.ZstdError):     # trailing garbage
        _zstd.decompress(frame + b"\x01")


def test_dictionary_frame_raises_codec_unavailable():
    samples = [INPUTS["text"][i:i + 300] for i in range(0, 60000, 300)]
    d = zstandard.train_dictionary(2048, samples)
    frame = zstandard.ZstdCompressor(level=3, dict_data=d).compress(
        INPUTS["text"][:5000])
    with pytest.raises(_zstd.DictionaryFrame):
        _zstd.decompress(frame)
    with pytest.raises(workers.CodecUnavailable, match="dictionary"):
        workers.zstd_decompress(frame)


def test_fuzzed_byte_flips_raise_or_fail_the_crc():
    """A flipped byte in a frame either raises (``ZstdError``, or
    ``DictionaryFrame`` where the flip names a dictionary) or decodes to
    bytes whose crc32 differs from the original's (what the callers check),
    within the case's time limit; a flip that decodes to the original bytes
    is one the format cannot see (a padding bit, an unused table bit)."""
    srcs = [_compress(INPUTS[n], level=lv) for n, lv in
            (("text", 3), ("weights_f32", 3), ("small_alphabet", 1),
             ("long_matches", 19), ("repetitive", -5))]
    want = [zlib.crc32(INPUTS[n]) for n in
            ("text", "weights_f32", "small_alphabet", "long_matches",
             "repetitive")]

    def gen(rs):
        i = int(rs.randint(len(srcs)))
        off = int(rs.randint(len(srcs[i])))
        return i, off, 1 << int(rs.randint(8))

    outcomes = {"raised": 0, "crc_rejects": 0, "invisible": 0}
    for i, off, bit in cases(120, gen, seed=99):
        frame = bytearray(srcs[i])
        frame[off] ^= bit
        with time_limit(CASE_SECONDS):
            try:
                out = _zstd.decompress(bytes(frame))
            except (_zstd.ZstdError, _zstd.DictionaryFrame):
                # a flip may set the header's dictionary flag
                outcomes["raised"] += 1
                continue
        if zlib.crc32(out) != want[i]:
            outcomes["crc_rejects"] += 1
        else:
            outcomes["invisible"] += 1
    assert outcomes["raised"] > 0 and outcomes["crc_rejects"] > 0, outcomes
