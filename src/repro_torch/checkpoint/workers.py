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
decoded to, those bytes (:class:`Int8Record`).  What the JAX package
compresses with ``zstandard`` (codec ``zstd`` records, int8 records whose
``comp`` is ``zstd``, compressed XD01 and BD02 deltas) is read through the
port's own decoder (``_zstd``); the port writes no zstd, and a frame that
needs a dictionary raises ``CodecUnavailable``.  Large byte fields travel
as zero-copy buffers
(``_msgpack.Blob`` on the way out, memoryviews on the way in), so a
multi-GB unit is never copied to build its object.

This module is also what a subprocess IO worker runs (``io_backend=
"process"``, ``async_io.ProcessWorkerPool``): ``WORKER_FNS`` names the
tasks (chunk framing, XD01 and BD02 encode and decode, an object's decode
with its host checks, ``decode_object`` and ``canonical_object``, atomic
file writes and reads, and probes), ``run`` runs one in this process (the
thread backend), and ``worker_main`` is a worker's loop.  So it imports
the standard library, numpy and ``_msgpack`` alone, never torch and never
jax: a worker starts as a fresh interpreter with the port's source root
on its path, and neither package ``__init__`` on the way imports
anything.  Only builtins cross a worker's pipe (see ``worker_main``).
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import hashlib
import math
import mmap
import os
import pickle
import sys
import threading
import time
import traceback
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import _zstd
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
# Markers of the worker pipe: a buffer in shared memory (an argument's
# segment name, or a result's offset in the worker's scratch file) and an
# int8 record, as plain tuples.
SHM_DIR = "/dev/shm"
SHM_MARK = "__repro_shm__"
SEG_MARK = "__repro_seg__"
BLOB_MARK = "__repro_blob__"
INT8_MARK = "__repro_int8__"
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


def zstd_decompress(blob) -> bytearray:
    """The content of the zstd frames in ``blob`` (the port's decoder);
    malformed bytes raise ``CorruptObject``, a frame that needs a
    dictionary ``CodecUnavailable``."""
    try:
        return _zstd.decompress(blob)
    except _zstd.ZstdError as e:
        raise CorruptObject(f"bad zstd data: {e}") from e
    except _zstd.DictionaryFrame as e:
        raise CodecUnavailable(f"{e}: the JAX package writes none, and the "
                               "port reads none") from e


def _raw_nbytes(shape: Sequence[int], dtype: str) -> int:
    item = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
    return math.prod(shape) * item


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


def decode_chunk_items(blob, verify: bool = True) -> Tuple[Dict, Items]:
    """(meta, items) of a chunk payload; item bytes are memoryviews into
    ``blob`` (an int8 record's in an ``Int8Record``, not dequantized).
    Checks each record's crc32 unless ``verify`` is False."""
    try:
        payload = unpackb(blob, zero_copy=True)
    except ValueError as e:
        raise CorruptObject(f"unreadable chunk payload: {e!r}") from e
    if not isinstance(payload, dict) \
            or payload.get("version") != CHUNK_FORMAT_VERSION:
        raise CorruptObject("bad chunk version")
    items: Items = []
    for t in payload["tensors"]:
        if t["codec"] not in ("none", "int8", "zstd"):
            # every codec the JAX package writes is read here
            raise CorruptObject(f"tensor {t['name']} names an unknown "
                                f"codec {t['codec']!r}")
        if verify and _crc(t["data"]) != t["crc"]:
            raise CorruptObject(f"crc mismatch for tensor {t['name']}")
        shape = tuple(t["shape"])
        data = t["data"]
        if t["codec"] == "int8":
            data = _int8_record(t, shape)
        elif t["codec"] == "zstd":
            data = zstd_decompress(data)
            if len(data) != _raw_nbytes(shape, t["dtype"]):
                raise CorruptObject(f"tensor {t['name']} decompresses to "
                                    f"{len(data)} bytes, not its shape's")
        items.append((t["name"], shape, t["dtype"], data))
    return payload["meta"], items


def canonical_payload(env: Dict[str, Any], verify: bool = True):
    """The canonical payload of a full, canonically addressed, lossless
    object: a codec-none payload as it is; any other (zstd) decoded and
    framed codec none, its records' crc32 checked when ``verify`` (the
    JAX store's transcode)."""
    if env.get("codec") == "none":
        return env["payload"]
    meta, items = decode_chunk_items(env["payload"], verify)
    return encode_chunk_blob(items, meta)


def _int8_record(t: Dict[str, Any], shape: Tuple[int, ...]) -> Int8Record:
    extra = t.get("extra") or {}
    # records written before the optional-zstd split always compressed
    comp = extra.get("comp", "zstd")
    if comp not in ("none", "zstd"):
        raise CorruptObject(f"int8 tensor {t['name']} names an unknown "
                            f"compression {comp!r}")
    if extra.get("block", QUANT_BLOCK) != QUANT_BLOCK:
        # the JAX package writes no other block
        raise CorruptObject(f"int8 tensor {t['name']} names block "
                            f"{extra['block']}, not {QUANT_BLOCK}")
    n_q, n_scale = int(extra["n_q"]), int(extra["n_scale"])
    data = zstd_decompress(t["data"]) if comp == "zstd" else t["data"]
    nb = -(-math.prod(shape) // QUANT_BLOCK)
    if (n_q != nb * QUANT_BLOCK or n_scale != nb
            or memoryview(data).nbytes != n_q + 4 * n_scale):
        raise CorruptObject(f"int8 tensor {t['name']}: {n_q} q and "
                            f"{n_scale} scales do not fit shape "
                            f"{list(shape)}")
    return Int8Record(data, n_q, n_scale, shape, t["dtype"])


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
    body = zstd_decompress(mv[5:]) if mv[4] == 1 else mv[5:]
    d = unpackb(body, zero_copy=True)
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
    body = zstd_decompress(mv[5:]) if mv[4] == 1 else mv[5:]
    d = unpackb(body, zero_copy=True)
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


# ------------------------------------------------- object decode (offload)
@contextlib.contextmanager
def _decoding(digest: str):
    """Parse and decode errors of ``digest``'s bytes as ``CorruptObject``,
    as the store's own read path raises them."""
    try:
        yield
    except (ValueError, KeyError, TypeError, IndexError, OverflowError) as e:
        raise CorruptObject(f"unreadable object {digest}: {e!r}") from e


def _canonical_of(env: Dict[str, Any], digest: str, base,
                  verify: bool):
    """The canonical payload of a canonically addressed envelope: a full
    lossless object's (``canonical_payload``), or an XOR delta rebuilt on
    ``base`` (its base's canonical payload), checked against the digest
    when ``verify``."""
    fmt = env.get("format")
    with _decoding(digest):
        if fmt == "full" and env.get("codec") not in LOSSY_CODECS:
            canon = canonical_payload(env, verify)
        elif fmt == "delta":
            if base is None:
                raise CorruptObject(f"delta object {digest} without its "
                                    "base payload")
            canon = delta_decode(env["payload"], base)
        else:
            raise ValueError(f"the canonical bytes of a {fmt!r} object "
                             f"(codec {env.get('codec')!r}) are rebuilt on "
                             "a device")
    if verify and blake2_hex(canon) != digest:
        raise CorruptObject(f"digest mismatch for {digest}")
    return canon


def decode_object(blob, digest: str, base=None, verify: bool = True
                  ) -> Tuple[Items, Optional[bytes]]:
    """``(items, fingerprint table blob)`` of one object envelope: the
    decode and host checks of ``ChunkStore.read_items``, runnable in a
    subprocess worker.  ``base`` is what the object's format needs of its
    base: a block delta's base envelope (a full fp object), an XOR delta's
    base canonical payload.  With ``verify``, every record's crc32 and the
    table's (or the canonical payload's) hash to the digest are checked;
    the table blob comes back only then, and never for a lossy object: the
    caller holds it against the tensors placed on the device."""
    with _decoding(digest):
        env = parse_envelope(blob, digest)
        fmt = env.get("format")
        fp_blob = env.get("fp")
    if fp_blob is None:
        if fmt == "full":
            payload = env["payload"]
            if (verify and env.get("codec") == "none"
                    and blake2_hex(payload) != digest):
                raise CorruptObject(f"digest mismatch for {digest}")
        elif fmt == "delta":
            payload = _canonical_of(env, digest, base, verify)
        else:
            raise CorruptObject(f"unknown object format {fmt!r}")
        with _decoding(digest):
            _, items = decode_chunk_items(payload, verify)
        return items, None
    with _decoding(digest):
        fp_blob = bytes(fp_blob)
        if verify and blake2_hex(fp_blob) != digest:
            raise CorruptObject(f"fingerprint digest mismatch for {digest}")
        if fmt == "full":
            _, items = decode_chunk_items(env["payload"], verify)
        elif fmt == "block_delta":
            if base is None:
                raise CorruptObject(f"delta object {digest} without its "
                                    "base")
            base_env = parse_envelope(base, env["base"])
            if base_env.get("format") != "full" \
                    or base_env.get("fp") is None:
                raise CorruptObject(f"block delta {digest}: base "
                                    f"{env['base']} is not a full fp "
                                    "object")
            _, base_items = decode_chunk_items(base_env["payload"], verify)
            items = patch_items(base_items,
                                block_delta_decode(env["payload"]))
        else:
            raise CorruptObject(f"unknown object format {fmt!r}")
    lossy = env.get("codec") in LOSSY_CODECS
    return items, (fp_blob if verify and not lossy else None)


def canonical_object(blob, digest: str, base=None, verify: bool = True):
    """The canonical payload of a canonically addressed object (a full
    lossless object or an XOR delta over ``base``, its base's canonical
    payload), checked against the digest when ``verify``.  An fp or lossy
    object's canonical bytes need its tensors on a device: ``ValueError``."""
    with _decoding(digest):
        env = parse_envelope(blob, digest)
    return _canonical_of(env, digest, base, verify)


# ----------------------------------------------------------------- file IO
def file_read(path: str) -> bytearray:
    with open(path, "rb") as f:
        return bytearray(f.read())


def file_write_atomic(path: str, data, fsync: bool = False,
                      tag: Optional[str] = None) -> int:
    """Write ``data`` (a buffer or a ``Blob``) to a tmp file beside
    ``path`` and rename it over ``path`` (``backends.localfs.
    atomic_write``'s protocol).  ``tag`` is the coordinating process's
    ``<pid>-<thread>`` pair, so the tmp name keeps its owner's pid and
    ``sweep_tmp`` leaves a live write alone; the worker's pid is
    appended."""
    if tag is None:
        tag = f"{os.getpid():x}-{threading.get_ident():x}"
    else:
        tag = f"{tag}-{os.getpid():x}"
    tmp = f"{path}.tmp-{tag}"
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    n = 0
    with open(tmp, "wb") as f:
        for part in _parts(data):
            f.write(part)
            n += part.nbytes
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync and parent:
        fd = os.open(parent, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    return n


# ------------------------------------------------------- test/probe tasks
def ping() -> Dict[str, Any]:
    """The worker's pid and whether it holds torch or jax."""
    return {"pid": os.getpid(), "torch": "torch" in sys.modules,
            "jax": "jax" in sys.modules}


def loaded_modules() -> List[str]:
    return sorted(sys.modules)


def echo(value: Any) -> Any:
    """A buffer's length, any other value as it is."""
    if isinstance(value, (bytes, bytearray, memoryview, Blob)):
        return memoryview(value).nbytes if not isinstance(value, Blob) \
            else value.nbytes
    return value


def sleep_for(seconds: float) -> float:
    time.sleep(float(seconds))
    return float(seconds)


def boom(message: str = "boom") -> None:
    raise RuntimeError(message)


# ------------------------------------------------------------- task table
WORKER_FNS: Dict[str, Any] = {
    "ping": ping,
    "modules": loaded_modules,
    "echo": echo,
    "sleep": sleep_for,
    "boom": boom,
    "encode_chunk": encode_chunk_blob,
    "delta_encode":
        lambda cur, base, limit=None: delta_encode(cur, base, limit=limit),
    "delta_decode": delta_decode,
    "block_delta_encode": block_delta_encode,
    "block_delta_decode": block_delta_decode,
    "decode_object": decode_object,
    "canonical_object": canonical_object,
    "file_read": file_read,
    "file_write_atomic": file_write_atomic,
}


def run(fn_id: str, *args) -> Any:
    """A task run in this process: the thread backend's dispatch."""
    return WORKER_FNS[fn_id](*args)


# ------------------------------------------------------- worker main loop
def _map(name: str, maps: Dict[str, Tuple[Any, int]]) -> Tuple[Any, int]:
    """This call's read-only map of a parent-owned ``/dev/shm`` segment
    and its start address.  The worker maps the file and never attaches
    through ``SharedMemory`` (whose resource tracker would unlink the
    parent's segment when the worker dies)."""
    hit = maps.get(name)
    if hit is None:
        with open(os.path.join(SHM_DIR, name), "rb") as f:
            m = mmap.mmap(f.fileno(), 0, flags=mmap.MAP_SHARED
                          | getattr(mmap, "MAP_POPULATE", 0),
                          prot=mmap.PROT_READ)
        hit = maps[name] = (m, np.frombuffer(m, np.uint8).ctypes.data)
    return hit


def _resolve_shm(obj: Any, maps: Dict[str, Tuple[Any, int]]) -> Any:
    """Arguments off the pipe: segment markers to read-only views of the
    segments (no copy), blob tuples to ``Blob`` s, int8 tuples to
    ``Int8Record`` s."""
    if isinstance(obj, tuple) and obj:
        if obj[0] == SHM_MARK and len(obj) == 4:
            _, name, n, off = obj
            return memoryview(_map(name, maps)[0])[off:off + n]
        if obj[0] == BLOB_MARK:
            return Blob([_resolve_shm(p, maps) for p in obj[1]])
        if obj[0] == INT8_MARK:
            return Int8Record(_resolve_shm(obj[1], maps), obj[2], obj[3],
                              tuple(obj[4]), obj[5])
        return tuple(_resolve_shm(v, maps) for v in obj)
    if isinstance(obj, list):
        return [_resolve_shm(v, maps) for v in obj]
    if isinstance(obj, dict):
        return {k: _resolve_shm(v, maps) for k, v in obj.items()}
    return obj


# This worker's response scratch files, kept open so their tmpfs pages are
# allocated once and reused across responses.
_SCRATCH: Dict[str, Any] = {}


def _scratch_file(name: str):
    f = _SCRATCH.get(name)
    if f is None:
        f = _SCRATCH[name] = open(os.path.join(SHM_DIR, name), "wb+")
    return f


def _stage_buffer(parts: List[memoryview], fobj, min_bytes: int,
                  offset: List[int], maps) -> Any:
    n = sum(p.nbytes for p in parts)
    if n < min_bytes or fobj is None:
        return b"".join(parts)
    if len(parts) == 1:
        addr = np.frombuffer(parts[0], np.uint8).ctypes.data
        for name, (m, start) in maps.items():
            if start <= addr and addr + n <= start + len(m):
                # a view of an argument's segment: hand back its range
                return (SEG_MARK, name, addr - start, n)
    off = offset[0]
    fobj.seek(off)
    for p in parts:
        fobj.write(p)
    offset[0] = off + n
    return (SHM_MARK, off, n)


def _stage_result(obj: Any, fobj, min_bytes: int, offset: List[int],
                  maps=None) -> Any:
    """A result made picklable: a buffer of at least ``min_bytes`` that
    lies in an argument's segment as ``(SEG_MARK, name, offset, length)``,
    any other such buffer written into the scratch file as ``(SHM_MARK,
    offset, length)``, a shorter one as ``bytes``; a ``Blob`` part by part
    in a blob tuple, an ``Int8Record`` as an int8 tuple."""
    maps = maps or {}
    if isinstance(obj, Int8Record):
        return (INT8_MARK, _stage_result(obj.data, fobj, min_bytes, offset,
                                         maps),
                obj.n_q, obj.n_scale, list(obj.shape), obj.dtype)
    if isinstance(obj, Blob):
        return (BLOB_MARK, [_stage_buffer([p], fobj, min_bytes, offset,
                                          maps) for p in obj.parts])
    if isinstance(obj, (bytes, bytearray, memoryview, np.ndarray)):
        return _stage_buffer(_parts(obj), fobj, min_bytes, offset, maps)
    if isinstance(obj, tuple):
        return tuple(_stage_result(v, fobj, min_bytes, offset, maps)
                     for v in obj)
    if isinstance(obj, list):
        return [_stage_result(v, fobj, min_bytes, offset, maps) for v in obj]
    if isinstance(obj, dict):
        return {k: _stage_result(v, fobj, min_bytes, offset, maps)
                for k, v in obj.items()}
    return obj


def _error_kind(exc: BaseException) -> str:
    if isinstance(exc, CorruptObject):
        return "corrupt"
    if isinstance(exc, CodecUnavailable):
        return "codec"
    if isinstance(exc, FileNotFoundError):
        return "missing"
    return "error"


def worker_main(rd=None, wr=None) -> int:
    """Task loop of one subprocess worker: announces ``("ready", pid)``,
    then reads pickled ``(fn_id, args, (scratch name, min bytes))`` and
    answers ``("ok", result)`` or ``("err", kind, message, traceback)``;
    EOF or ``None`` ends it.  Only builtins cross the pipe, exceptions as
    strings; buffers ride ``/dev/shm`` (``_resolve_shm``,
    ``_stage_result``)."""
    rd = rd if rd is not None else sys.stdin.buffer
    wr = wr if wr is not None else sys.stdout.buffer
    sys.stdout = sys.stderr     # stdout is the protocol channel

    def send(resp) -> bool:
        try:
            out = pickle.dumps(resp, protocol=pickle.HIGHEST_PROTOCOL)
        except Exception as e:  # noqa: BLE001 - an unpicklable result
            out = pickle.dumps(("err", "error",
                                f"unpicklable worker result: {e!r}", ""),
                               protocol=pickle.HIGHEST_PROTOCOL)
        try:
            wr.write(out)
            wr.flush()
        except (BrokenPipeError, OSError):
            return False
        return True

    if not send(("ready", os.getpid())):
        return 1
    while True:
        try:
            msg = pickle.load(rd)
        except EOFError:
            return 0
        if msg is None:
            return 0
        fn_id, args, spec = msg
        maps: Dict[str, Tuple[Any, int]] = {}
        try:
            result = WORKER_FNS[fn_id](*_resolve_shm(args, maps))
            fobj = _scratch_file(spec[0]) if spec is not None else None
            result = _stage_result(result, fobj,
                                   spec[1] if spec is not None else 0, [0],
                                   maps)
            if fobj is not None:
                fobj.flush()
            resp = ("ok", result)
        except BaseException as e:  # noqa: BLE001 - marshal everything back
            resp = ("err", _error_kind(e), f"{type(e).__name__}: {e}",
                    traceback.format_exc())
        # the maps go with their last view (an error's traceback included)
        del args, maps
        if not send(resp):
            return 1
