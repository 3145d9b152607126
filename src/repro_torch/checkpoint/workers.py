"""Byte-level codecs of the checkpoint format: chunk payloads with a crc32
per tensor record, sparse XOR deltas (XD01), block-sparse deltas (BD02),
object envelopes, and the blake2 digests.

Codecs ``none`` and ``int8`` are ported: the port writes exactly the bytes
the JAX package writes with ``codec="none"``, and with ``codec="int8"``
where that package has no ``zstandard`` (every record's ``comp`` is
``none``), and reads those objects back.  An int8 record holds a float or
bfloat16 tensor of at least 256 elements as its ``q`` (int8, 256 per
block) followed by one float32 scale per block; the quantizing itself is
the card's (``kernels/quantize``), so here a record is framed from, and
decoded to, those bytes (:class:`Int8Record`).  ``zstd`` (and int8 records
whose ``comp`` is ``zstd``, and compressed XD01 and BD02 deltas) raise
``CodecUnavailable``: the port does not use ``zstandard``.  Large byte fields travel as zero-copy buffers
(``_msgpack.Blob`` on the way out, memoryviews on the way in), so a
multi-GB unit is never copied to build its object.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import math
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint._msgpack import Blob, pack_parts, unpackb

CHUNK_FORMAT_VERSION = 1
OBJECT_VERSION = 1
DIGEST_BYTES = 20  # blake2b-160
BLOCK_DELTA_MAGIC = b"BD02"
DELTA_MAGIC = b"XD01"
# XOR runs closer than this many bytes share one delta segment.
DELTA_MERGE_GAP = 32
# The XOR delta encoder diffs this many bytes at a time, so its scratch
# memory does not grow with the payload or with the bytes that differ.
DELTA_WINDOW = 1 << 24

QUANT_BLOCK = 256
# Lossy codecs: their objects decode to other tensors than were
# fingerprinted, so they never anchor a block delta and a restore checks
# them by crc32 alone.
LOSSY_CODECS = ("int8",)
_QUANT_DTYPES = ("float16", "float32", "float64", "bfloat16")

# (name, shape, dtype, data) in flatten order; ``data`` is the raw
# little-endian bytes, or an ``Int8Record``.
Items = List[Tuple[str, Sequence[int], str, Any]]


class CodecUnavailable(RuntimeError):
    """A codec the port has not ported was asked for."""


class CorruptObject(RuntimeError):
    """An object failed to parse or verify."""


@dataclasses.dataclass
class Int8Record:
    """The data of an int8-coded tensor record: ``n_q`` int8 values (256
    per block, the last block zero-padded) followed by ``n_scale`` float32
    scales, little-endian, in one buffer."""
    data: Any
    n_q: int
    n_scale: int
    shape: Tuple[int, ...]
    dtype: str

    @property
    def nbytes(self) -> int:
        return self.n_q + 4 * self.n_scale


def resolve_codec(codec: str) -> str:
    """The codec a store writes: ``auto`` is ``none`` (the best lossless
    codec the port has), ``none`` and ``int8`` as named; ``zstd`` raises."""
    if codec in ("auto", "none"):
        return "none"
    if codec == "int8":
        return "int8"
    if codec == "zstd":
        raise CodecUnavailable("codec 'zstd' needs zstandard, which the "
                               "port does not use")
    raise ValueError(f"unknown codec {codec!r}")


def int8_eligible(dtype: str, shape: Sequence[int]) -> bool:
    """Whether codec int8 quantizes a tensor: a float or bfloat16 tensor
    of at least 256 elements (the JAX package's rule); every other tensor
    is stored raw (codec ``none``)."""
    return dtype in _QUANT_DTYPES and math.prod(shape) >= QUANT_BLOCK


def blake2_hex(blob, digest_size: int = DIGEST_BYTES) -> str:
    """blake2b of a buffer, or of a ``Blob``'s parts back to back."""
    h = hashlib.blake2b(digest_size=digest_size)
    for part in (blob.parts if isinstance(blob, Blob) else (blob,)):
        h.update(part)
    return h.hexdigest()


def _crc(buf) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


# ------------------------------------------------------ chunk payload level
def chunk_payload(items: Items, meta: Dict[str, Any]) -> Dict[str, Any]:
    """The chunk payload dict over the items' buffers: codec ``none`` for
    raw bytes, ``int8`` (``comp`` none) for an ``Int8Record``."""
    tensors = []
    for name, shape, dtype, raw in items:
        codec, extra = "none", None
        if isinstance(raw, Int8Record):
            codec = "int8"
            # key order is part of the bytes (msgpack keeps it)
            extra = {"n_q": int(raw.n_q), "n_scale": int(raw.n_scale),
                     "block": QUANT_BLOCK, "comp": "none"}
            raw = raw.data
        mv = memoryview(raw).cast("B")
        tensors.append({"name": name, "shape": list(shape), "dtype": dtype,
                        "codec": codec, "crc": _crc(mv), "extra": extra,
                        "data": mv})
    return {"version": CHUNK_FORMAT_VERSION, "meta": meta,
            "tensors": tensors}


def encode_chunk_blob(items: Items, meta: Dict[str, Any]) -> Blob:
    """Chunk payload as a zero-copy Blob."""
    return Blob(pack_parts(chunk_payload(items, meta)))


def decode_chunk_items(blob) -> Tuple[Dict, Items]:
    """(meta, items) of a chunk payload; item bytes are memoryviews into
    ``blob`` (an int8 record's in an ``Int8Record``, not dequantized).
    Checks each record's crc32."""
    try:
        payload = unpackb(blob, zero_copy=True)
    except ValueError as e:
        raise CorruptObject(f"unreadable chunk payload: {e!r}") from e
    if not isinstance(payload, dict) \
            or payload.get("version") != CHUNK_FORMAT_VERSION:
        raise CorruptObject("bad chunk version")
    items: Items = []
    for t in payload["tensors"]:
        if t["codec"] not in ("none", "int8"):
            raise CodecUnavailable(f"tensor {t['name']} uses codec "
                                   f"{t['codec']!r}: reading it needs "
                                   "zstandard, which the port does not use")
        if _crc(t["data"]) != t["crc"]:
            raise CorruptObject(f"crc mismatch for tensor {t['name']}")
        shape = tuple(t["shape"])
        data = t["data"]
        if t["codec"] == "int8":
            data = _int8_record(t, shape)
        items.append((t["name"], shape, t["dtype"], data))
    return payload["meta"], items


def _int8_record(t: Dict[str, Any], shape: Tuple[int, ...]) -> Int8Record:
    extra = t.get("extra") or {}
    # records written before the optional-zstd split always compressed
    comp = extra.get("comp", "zstd")
    if comp != "none":
        raise CodecUnavailable(f"int8 tensor {t['name']} is compressed with "
                               f"{comp!r}: reading it needs zstandard, which "
                               "the port does not use")
    if extra.get("block", QUANT_BLOCK) != QUANT_BLOCK:
        raise CodecUnavailable(f"int8 tensor {t['name']} uses block "
                               f"{extra['block']}, the port reads "
                               f"{QUANT_BLOCK}")
    n_q, n_scale = int(extra["n_q"]), int(extra["n_scale"])
    nb = -(-math.prod(shape) // QUANT_BLOCK)
    if (n_q != nb * QUANT_BLOCK or n_scale != nb
            or memoryview(t["data"]).nbytes != n_q + 4 * n_scale):
        raise CorruptObject(f"int8 tensor {t['name']}: {n_q} q and "
                            f"{n_scale} scales do not fit shape "
                            f"{list(shape)}")
    return Int8Record(t["data"], n_q, n_scale, shape, t["dtype"])


# ---------------------------------------------------- XOR delta (XD01)
def _parts(buf) -> List[memoryview]:
    """The non-empty byte pieces of a buffer or a ``Blob``, in order."""
    parts = (buf.parts if isinstance(buf, Blob)
             else (memoryview(buf).cast("B"),))
    return [p for p in parts if p.nbytes]


def _reader(buf):
    """(nbytes, read) of a buffer or a ``Blob``: ``read(off, end)`` gives
    its bytes [off, end) as a uint8 array, a view where they lie in one
    piece and a copy of that span alone where they do not."""
    parts = _parts(buf)
    starts = [0]
    for p in parts:
        starts.append(starts[-1] + p.nbytes)

    def read(off: int, end: int) -> np.ndarray:
        i = bisect.bisect_right(starts, off) - 1
        if end <= starts[i + 1]:
            return np.frombuffer(parts[i][off - starts[i]:end - starts[i]],
                                 np.uint8)
        out = np.empty(end - off, np.uint8)
        pos = off
        while pos < end:
            stop = min(end, starts[i + 1])
            out[pos - off:stop - off] = np.frombuffer(
                parts[i][pos - starts[i]:stop - starts[i]], np.uint8)
            pos, i = stop, i + 1
        return out

    return starts[-1], read


def _windows(cur, base, window: int):
    """(offset, XOR of the piece of ``cur`` at offset against ``base``)
    over ``cur`` in order, no piece longer than ``window`` bytes; ``base``
    is zero-padded past its end.  Either may be a buffer or a ``Blob``."""
    n_base, read_base = _reader(base)
    off = 0
    for part in _parts(cur):
        for i in range(0, part.nbytes, window):
            a = np.frombuffer(part[i:i + window], np.uint8)
            end = off + a.size
            if end <= n_base:
                x = a ^ read_base(off, end)
            else:
                x = a.copy()
                if off < n_base:
                    x[:n_base - off] ^= read_base(off, n_base)
            yield off, x
            off = end


def _runs(x: np.ndarray, gap: int):
    """(starts, ends) of the runs of ``x``'s nonzero bytes at most ``gap``
    apart, or None when every byte is zero.

    Two runs are split by a zero run of at least ``gap`` bytes, and a zero
    run of at least 31 bytes holds an aligned all-zero 16-byte block.  So
    for ``gap`` >= 31 only the runs of all-zero blocks are examined, each
    widened by the zero bytes that end the block before it and start the
    block after it: the work follows the zero blocks, not the nonzero
    bytes (a densely changed unit has few).  A smaller ``gap`` takes the
    nonzero positions."""
    if gap < 31:
        nz = np.flatnonzero(x)
        if not nz.size:
            return None
        brk = np.flatnonzero(np.diff(nz) > gap)
        return (nz[np.concatenate([[0], brk + 1])],
                nz[np.concatenate([brk, [nz.size - 1]])] + 1)
    nb = x.size // 16
    words = x[:nb * 16].view(np.uint64).reshape(nb, 2)
    live = (words[:, 0] != 0) | (words[:, 1] != 0)
    live_blocks = np.flatnonzero(live)
    tail = np.flatnonzero(x[nb * 16:])
    if not live_blocks.size and not tail.size:
        return None
    blocks = x[:nb * 16].reshape(nb, 16)
    if live_blocks.size:
        b = live_blocks[0]
        first = 16 * b + int(np.argmax(blocks[b] != 0))
    else:
        first = 16 * nb + int(tail[0])
    if tail.size:
        last_end = 16 * nb + int(tail[-1]) + 1
    else:
        b = live_blocks[-1]
        last_end = 16 * b + 16 - int(np.argmax(blocks[b][::-1] != 0))
    # runs [b0, b1) of dead (all-zero) blocks between live bytes: not the
    # leading one, nor the trailing one unless the tail is live
    d = np.diff(np.concatenate(([1], live.view(np.int8), [1])))
    b0, b1 = np.flatnonzero(d == -1), np.flatnonzero(d == 1)
    keep = (b0 > 0) & ((b1 < nb) | (tail.size > 0))
    b0, b1 = b0[keep], b1[keep]
    # widen each to its zero bytes: those ending block b0 - 1 and those
    # starting block b1 (or the tail)
    zs = 16 * b0 - np.argmax(blocks[b0 - 1][:, ::-1] != 0, axis=1)
    inner = b1 < nb
    ze = np.full(b1.size, 16 * nb + (int(tail[0]) if tail.size else 0))
    ze[inner] = 16 * b1[inner] + np.argmax(blocks[b1[inner]] != 0, axis=1)
    cut = ze - zs >= gap
    return (np.concatenate([[first], ze[cut]]),
            np.concatenate([zs[cut], [last_end]]))


def _walk(cur, base, gap: int, window: int):
    """(offset, XOR piece, run starts, run ends), offsets absolute, for each
    window of ``cur`` against ``base`` that differs anywhere."""
    for off, x in _windows(cur, base, window):
        runs = _runs(x, gap)
        if runs is not None:
            yield off, x, runs[0] + off, runs[1] + off


def delta_encode(cur, base, *, gap: int = DELTA_MERGE_GAP,
                 limit: Optional[float] = None, window: int = DELTA_WINDOW):
    """Sparse bytewise XOR diff of ``cur`` against ``base`` (each a buffer
    or a ``Blob``, never joined), as a ``Blob``: the JAX package's
    ``delta_encode`` bytes (uncompressed), ``{"n": n, "segs": [[offset,
    xor bytes], ...]}`` in msgpack after the magic and a ``\x00``.
    ``base`` is zero-padded or truncated to ``n``; nonzero XOR bytes at
    most ``gap`` apart share one segment.

    ``cur`` is diffed ``window`` bytes at a time, with the open segment and
    the gap rule carried across each window edge, so the scratch memory is
    a few windows whatever the number of differing bytes (the JAX encoder
    holds the whole XOR and 8 bytes per differing byte).  With ``limit``, a
    first pass adds up the segments' bytes without copying any and returns
    None once they reach it: the encoded delta would be longer still."""
    n = sum(p.nbytes for p in _parts(cur))
    if limit is not None:
        total, last_end = 0, None
        for _, _, starts, ends in _walk(cur, base, gap, window):
            total += int((ends - starts).sum())
            if last_end is not None and starts[0] - (last_end - 1) <= gap:
                total += int(starts[0]) - last_end
            last_end = int(ends[-1])
            if total >= limit:
                return None
    segs: List[list] = []
    open_start = last_end = -1     # the open segment is [open_start, last_end)
    chunks: List[bytes] = []

    def close() -> None:
        segs.append([open_start,
                     chunks[0] if len(chunks) == 1 else Blob(chunks)])

    for off, x, starts, ends in _walk(cur, base, gap, window):
        for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
            if i == 0 and open_start >= 0 and s - (last_end - 1) <= gap:
                # the run continues the segment left open at the window edge
                chunks.append(bytes(s - last_end))
            else:
                if open_start >= 0:
                    close()
                open_start, chunks = s, []
            chunks.append(x[s - off:e - off].tobytes())
            last_end = e
    if open_start >= 0:
        close()
    return Blob([DELTA_MAGIC + b"\x00",
                 *pack_parts({"n": n, "segs": segs})])


def delta_decode(blob, base) -> bytearray:
    """The payload ``delta_encode`` diffed against ``base`` (a buffer or a
    ``Blob``), built in one output buffer: ``base`` (zero-padded or
    truncated) patched in place."""
    mv = memoryview(blob).cast("B")
    if bytes(mv[:4]) != DELTA_MAGIC:
        raise ValueError("not a delta blob (bad magic)")
    if mv[4] == 1:
        raise CodecUnavailable("the XOR delta is compressed with zstd: "
                               "reading it needs zstandard, which the port "
                               "does not use")
    d = unpackb(mv[5:], zero_copy=True)
    n = d["n"]
    out = bytearray(n)
    off = 0
    for part in _parts(base):
        m = min(part.nbytes, n - off)
        if m <= 0:
            break
        out[off:off + m] = part[:m]
        off += m
    o = np.frombuffer(out, np.uint8)
    for off, data in d["segs"]:
        seg = np.frombuffer(data, np.uint8)
        o[off:off + len(seg)] ^= seg
    return out


# --------------------------------------------- block-sparse delta (BD02)
def block_delta_encode(records: List[Dict]) -> Blob:
    """Frame per-leaf dirty-block records as a BD02 blob (codec none).

    Each record: {"name", "shape", "dtype", "nbytes", "block",
    "idx": [block indices], "data": the blocks back to back}."""
    rows = [[r["name"], list(r["shape"]), r["dtype"], int(r["nbytes"]),
             int(r["block"]), [int(i) for i in r["idx"]], r["data"]]
            for r in records]
    body = pack_parts({"v": 1, "tensors": rows})
    return Blob([BLOCK_DELTA_MAGIC + b"\x00", *body])


def block_delta_decode(blob) -> List[Dict]:
    mv = memoryview(blob).cast("B")
    if bytes(mv[:4]) != BLOCK_DELTA_MAGIC:
        raise ValueError("not a block-delta blob (bad magic)")
    if mv[4] != 0:
        raise CodecUnavailable("compressed block deltas are not ported yet")
    d = unpackb(mv[5:], zero_copy=True)
    if not isinstance(d, dict) or d.get("v") != 1:
        raise ValueError("bad block-delta body")
    return [{"name": name, "shape": shape, "dtype": dtype, "nbytes": nbytes,
             "block": block, "idx": idx, "data": data}
            for name, shape, dtype, nbytes, block, idx, data in d["tensors"]]


def patch_items(base_items: Items, records: List[Dict]) -> Items:
    """Overlay dirty blocks from a block-delta payload onto base items.
    Unlisted leaves and blocks keep the base content."""
    out: Dict[str, list] = {name: [shape, dtype, raw]
                            for name, shape, dtype, raw in base_items}
    for rec in records:
        path = rec["name"]
        if path not in out:
            raise CorruptObject(f"block-delta patches unknown leaf {path!r}")
        block = int(rec["block"])
        nbytes = int(rec["nbytes"])
        if isinstance(out[path][2], Int8Record):
            raise CorruptObject(f"block-delta patches the lossy leaf "
                                f"{path!r}")
        raw = memoryview(out[path][2]).cast("B")
        if raw.nbytes != nbytes:
            raise CorruptObject(f"base leaf {path!r} has {raw.nbytes} bytes, "
                                f"delta expects {nbytes}")
        nb = max(1, -(-nbytes // block))
        buf = np.zeros(nb * block, np.uint8)
        buf[:nbytes] = np.frombuffer(raw, np.uint8)
        data = np.frombuffer(rec["data"], np.uint8)
        for j, bi in enumerate(rec["idx"]):
            buf[bi * block:(bi + 1) * block] = data[j * block:(j + 1) * block]
        out[path] = [tuple(rec["shape"]), rec["dtype"],
                     memoryview(buf[:nbytes]).cast("B")]
    return [(name, tuple(v[0]), v[1], v[2]) for name, v in out.items()]


# ------------------------------------------------------------ object level
def parse_envelope(blob, digest: str) -> Dict[str, Any]:
    """Object envelope dict; bins are memoryviews into ``blob``."""
    try:
        env = unpackb(blob, zero_copy=True)
    except ValueError as e:
        raise CorruptObject(
            f"unreadable object envelope for {digest}: {e!r}") from e
    if not isinstance(env, dict) or env.get("v") != OBJECT_VERSION:
        raise CorruptObject(f"bad object envelope/version for {digest}")
    return env
