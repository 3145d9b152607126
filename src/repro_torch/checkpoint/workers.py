"""Byte-level codecs of the checkpoint format: chunk payloads with a crc32
per tensor record, block-sparse deltas (BD02), object envelopes, and the
blake2 digests.

Only codec ``none`` is ported: the port writes exactly the bytes the JAX
package writes with ``codec="none"`` and reads those objects back; other
codecs raise ``CodecUnavailable``.  Large byte fields travel as zero-copy
buffers (``_msgpack.Blob`` on the way out, memoryviews on the way in), so a
multi-GB unit is never copied to build its object.
"""
from __future__ import annotations

import hashlib
import zlib
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint._msgpack import Blob, pack_parts, unpackb

CHUNK_FORMAT_VERSION = 1
OBJECT_VERSION = 1
DIGEST_BYTES = 20  # blake2b-160
BLOCK_DELTA_MAGIC = b"BD02"

# (name, shape, dtype, raw little-endian bytes) in flatten order.
Items = List[Tuple[str, Sequence[int], str, Any]]


class CodecUnavailable(RuntimeError):
    """A codec the port has not ported was asked for."""


class CorruptObject(RuntimeError):
    """An object failed to parse or verify."""


def blake2_hex(blob, digest_size: int = DIGEST_BYTES) -> str:
    return hashlib.blake2b(blob, digest_size=digest_size).hexdigest()


def _crc(buf) -> int:
    return zlib.crc32(buf) & 0xFFFFFFFF


# ------------------------------------------------------ chunk payload level
def chunk_payload(items: Items, meta: Dict[str, Any]) -> Dict[str, Any]:
    """The chunk payload dict (codec none) over raw item buffers."""
    tensors = []
    for name, shape, dtype, raw in items:
        mv = memoryview(raw).cast("B")
        tensors.append({"name": name, "shape": list(shape), "dtype": dtype,
                        "codec": "none", "crc": _crc(mv), "extra": None,
                        "data": mv})
    return {"version": CHUNK_FORMAT_VERSION, "meta": meta,
            "tensors": tensors}


def encode_chunk_blob(items: Items, meta: Dict[str, Any]) -> Blob:
    """Chunk payload as a zero-copy Blob."""
    return Blob(pack_parts(chunk_payload(items, meta)))


def decode_chunk_items(blob) -> Tuple[Dict, Items]:
    """(meta, items) of a chunk payload; item bytes are memoryviews into
    ``blob``.  Checks each record's crc32."""
    try:
        payload = unpackb(blob, zero_copy=True)
    except ValueError as e:
        raise CorruptObject(f"unreadable chunk payload: {e!r}") from e
    if not isinstance(payload, dict) \
            or payload.get("version") != CHUNK_FORMAT_VERSION:
        raise CorruptObject("bad chunk version")
    items: Items = []
    for t in payload["tensors"]:
        if t["codec"] != "none":
            raise CodecUnavailable(f"tensor {t['name']} uses codec "
                                   f"{t['codec']!r}, not ported yet")
        if _crc(t["data"]) != t["crc"]:
            raise CorruptObject(f"crc mismatch for tensor {t['name']}")
        items.append((t["name"], tuple(t["shape"]), t["dtype"], t["data"]))
    return payload["meta"], items


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
