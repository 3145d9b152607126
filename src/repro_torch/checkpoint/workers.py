"""Byte-level codecs of the checkpoint format: chunk payloads with a crc32
per tensor record, block-sparse deltas (BD02), object envelopes, and the
blake2 digests.

Codecs ``none`` and ``int8`` are ported: the port writes exactly the bytes
the JAX package writes with ``codec="none"``, and with ``codec="int8"``
where that package has no ``zstandard`` (every record's ``comp`` is
``none``), and reads those objects back.  An int8 record holds a float or
bfloat16 tensor of at least 256 elements as its ``q`` (int8, 256 per
block) followed by one float32 scale per block; the quantizing itself is
the card's (``kernels/quantize``), so here a record is framed from, and
decoded to, those bytes (:class:`Int8Record`).  ``zstd`` (and int8 records
whose ``comp`` is ``zstd``) raise ``CodecUnavailable``: the port does not
use ``zstandard``.  Large byte fields travel as zero-copy buffers
(``_msgpack.Blob`` on the way out, memoryviews on the way in), so a
multi-GB unit is never copied to build its object.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import zlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint._msgpack import Blob, pack_parts, unpackb

CHUNK_FORMAT_VERSION = 1
OBJECT_VERSION = 1
DIGEST_BYTES = 20  # blake2b-160
BLOCK_DELTA_MAGIC = b"BD02"

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
    return hashlib.blake2b(blob, digest_size=digest_size).hexdigest()


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
                                   f"{t['codec']!r}, not ported yet")
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
