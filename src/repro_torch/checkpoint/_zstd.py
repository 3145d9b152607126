"""A Zstandard decoder (RFC 8878), decode only, in Python and numpy.

The JAX package compresses with ``zstandard`` where that package is
installed (codec ``zstd``, int8 records with ``comp: zstd``, compressed
XD01 and BD02 deltas; level 3, no dictionary), and its codec ``auto``
resolves to ``zstd`` there.  The port reads those stores with this module
and never imports ``zstandard``; it writes no zstd (``workers.
resolve_codec``).  It is written from the RFC:

- frames (header with its window descriptor, single-segment flag,
  dictionary ID and content size), several back to back, and skippable
  frames between them;
- raw, RLE and compressed blocks; in a compressed block the literals
  (raw, RLE, Huffman with one or four streams, a table described directly
  or through FSE, or the previous block's table reused) and the sequences
  (literal length, match length and offset codes, each predefined, RLE,
  FSE-described or repeated from the previous block), with the three
  repeat offsets;
- the optional content checksum (the low 32 bits of XXH64, kept here).

A frame that names a dictionary raises :class:`DictionaryFrame` (the JAX
package compresses without one).  Anything truncated, overlong or
inconsistent raises :class:`ZstdError`, a ``ValueError``, which the store's
read paths report as a corrupt object.  Output never grows past a frame's
declared content size or a block past its maximum size, match offsets stay
inside what the frame has produced and its window, and every loop is
bounded by the input or by the header's counts.

Huffman streams are decoded through a numpy table of every bit position
(the symbol code that ends there), so the walk down a stream is one list
lookup per literal; sequences are decoded one at a time.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

FRAME_MAGIC = 0xFD2FB528
SKIPPABLE_MAGIC = 0x184D2A50      # the low 4 bits are free
SKIPPABLE_MASK = 0xFFFFFFF0
BLOCK_MAX = 128 << 10
MAX_WINDOW_LOG = 41
HUF_MAX_BITS = 11

# Literal length and match length codes: (baseline, extra bits).
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                131, 259, 515, 1027, 2051, 4099, 8195,
                                16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                      13, 14, 15, 16]
LL_MAX, ML_MAX, OF_MAX = 35, 52, 31
LL_MAX_LOG, ML_MAX_LOG, OF_MAX_LOG = 9, 9, 8

# The predefined distributions (RFC 8878, 3.1.1.3.2.2).
LL_DEFAULT = ([4, 3] + [2] * 11 + [1, 1, 1] + [2] * 9 + [3, 2]
              + [1] * 5 + [-1] * 4, 6)
ML_DEFAULT = ([1, 4, 3] + [2] * 6 + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1] * 6 + [2, 2, 2] + [1] * 15 + [-1] * 5, 5)


class ZstdError(ValueError):
    """Bytes that are not a well-formed Zstandard frame."""


class DictionaryFrame(RuntimeError):
    """A frame that needs a dictionary this decoder does not have."""


def _fail(msg: str):
    raise ZstdError(msg)


# ----------------------------------------------------------------- XXH64
_M64 = (1 << 64) - 1
_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of a buffer (the frame checksum's hash)."""
    mv = memoryview(data).cast("B")
    n = mv.nbytes
    p = 0
    if n >= 32:
        stripes = n // 32
        lanes = np.frombuffer(mv, "<u8", count=stripes * 4).tolist()
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        for i in range(0, 4 * stripes, 4):
            v1 = _rotl((v1 + lanes[i] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[i + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[i + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[i + 3] * _P2) & _M64, 31) * _P1 & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        p = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(mv[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= int.from_bytes(mv[p:p + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= mv[p] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    h ^= h >> 32
    return h


# ------------------------------------------------------------ bitstreams
class _Backward:
    """A backward bitstream (RFC 8878, 4.1): read from its last byte's
    highest set bit down, ``read(k)`` taking the k highest unread bits;
    bits below the start read as zeros and leave ``pos`` negative
    (the caller's overflow check)."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        if not buf or buf[-1] == 0:
            _fail("bitstream without its end mark")
        self.buf = buf
        self.pos = (len(buf) - 1) * 8 + buf[-1].bit_length() - 1

    def read(self, k: int) -> int:
        if k == 0:
            return 0
        hi = self.pos
        lo = self.pos = hi - k
        if lo >= 0:
            return (int.from_bytes(self.buf[lo >> 3:(hi + 7) >> 3], "little")
                    >> (lo & 7)) & ((1 << k) - 1)
        if hi <= 0:
            return 0
        return ((int.from_bytes(self.buf[:(hi + 7) >> 3], "little")
                 & ((1 << hi) - 1)) << -lo)


def _read_ncount(buf: bytes, max_log: int, max_sym: int
                 ) -> Tuple[List[int], int, int]:
    """An FSE table description (RFC 8878, 4.1.1): the normalized counts,
    the accuracy log and the bytes it took."""
    total = len(buf) * 8
    x = int.from_bytes(buf, "little")
    pos = 0

    def peek(k: int) -> int:
        return (x >> pos) & ((1 << k) - 1)

    if not buf:
        _fail("empty FSE table description")
    log = peek(4) + 5
    pos = 4
    if log > max_log:
        _fail(f"FSE accuracy log {log} > {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    norm: List[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            n0 = len(norm)
            while True:
                r = peek(2)
                pos += 2
                n0 += r
                if r != 3:
                    break
                if pos > total:
                    _fail("FSE table description truncated")
            if n0 > max_sym:
                _fail("FSE table description past its last symbol")
            norm.extend([0] * (n0 - len(norm)))
        if len(norm) > max_sym:
            _fail("FSE table description past its last symbol")
        mx = (2 * threshold - 1) - remaining
        v = peek(nbits)
        if (v & (threshold - 1)) < mx:
            count = v & (threshold - 1)
            pos += nbits - 1
        else:
            count = v & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            pos += nbits
        count -= 1
        remaining -= abs(count)
        norm.append(count)
        prev0 = count == 0
        if pos > total:
            _fail("FSE table description truncated")
        if remaining < threshold:
            if remaining <= 1:
                break
            nbits = remaining.bit_length()
            threshold = 1 << (nbits - 1)
    if remaining != 1:
        _fail("FSE table description does not sum to its table size")
    return norm, log, (pos + 7) >> 3


class _Fse:
    """An FSE decoding table: per state its symbol, the bits to read and
    the baseline of the next state."""

    __slots__ = ("sym", "nb", "base", "log")

    def __init__(self, sym, nb, base, log):
        self.sym, self.nb, self.base, self.log = sym, nb, base, log

    @staticmethod
    def build(norm: List[int], log: int) -> "_Fse":
        size = 1 << log
        sym = [0] * size
        high = size - 1
        nxt = [0] * len(norm)
        for s, c in enumerate(norm):
            if c == -1:
                sym[high] = s
                high -= 1
                nxt[s] = 1
            else:
                nxt[s] = c
        step = (size >> 1) + (size >> 3) + 3
        mask = size - 1
        pos = 0
        for s, c in enumerate(norm):
            for _ in range(c):
                sym[pos] = s
                pos = (pos + step) & mask
                while pos > high:
                    pos = (pos + step) & mask
        if pos != 0:
            _fail("FSE table does not spread evenly")
        nb = [0] * size
        base = [0] * size
        for u in range(size):
            s = sym[u]
            x = nxt[s]
            nxt[s] = x + 1
            b = log - (x.bit_length() - 1)
            nb[u] = b
            base[u] = (x << b) - size
        return _Fse(sym, nb, base, log)

    @staticmethod
    def rle(symbol: int) -> "_Fse":
        return _Fse([symbol], [0], [0], 0)


_PREDEFINED = {name: _Fse.build(*dist) for name, dist in
               (("ll", LL_DEFAULT), ("ml", ML_DEFAULT), ("of", OF_DEFAULT))}


# --------------------------------------------------------------- Huffman
class _Huffman:
    """A Huffman decoding table over ``max_bits`` bits: per index the
    symbol and its code length (RFC 8878, 4.2.2)."""

    __slots__ = ("sym", "nb", "max_bits")

    def __init__(self, weights: List[int]):
        if any(w > HUF_MAX_BITS for w in weights):
            _fail("Huffman weight too large")
        total = sum(1 << (w - 1) for w in weights if w)
        if total == 0:
            _fail("Huffman weights all zero")
        max_bits = total.bit_length()
        if max_bits > HUF_MAX_BITS:
            _fail(f"Huffman table of {max_bits} bits")
        left = (1 << max_bits) - total
        if left & (left - 1):
            _fail("Huffman weights do not complete a power of two")
        weights = weights + [left.bit_length()]
        if len(weights) > 256:
            _fail("Huffman table of more than 256 symbols")
        # by weight, then symbol: each symbol 2^(w-1) entries, from 0 up
        w = np.array(weights, np.int64)
        order = np.lexsort((np.arange(len(w)), w))
        order = order[w[order] > 0]
        counts = 1 << (w[order] - 1)
        self.sym = np.repeat(order, counts).astype(np.uint8)
        self.nb = np.repeat(max_bits + 1 - w[order], counts).astype(np.uint8)
        self.max_bits = max_bits

    def decode(self, stream: bytes, n: int) -> bytes:
        """``n`` symbols of one backward stream, which they must use up."""
        if not stream or stream[-1] == 0:
            _fail("Huffman stream without its end mark")
        start = (len(stream) - 1) * 8 + stream[-1].bit_length() - 1
        w = _windows(np.frombuffer(stream, np.uint8), _PAD)
        # idx[p]: the max_bits bits just below position p (zeros under 0)
        lo = np.arange(_PAD * 8 - self.max_bits,
                       _PAD * 8 - self.max_bits + start + 1)
        idx = (w[lo >> 3] >> (lo & 7).astype(np.uint32)) \
            & ((1 << self.max_bits) - 1)
        step = self.nb[idx].tolist()
        at = [0] * n
        p = start
        for i in range(n):
            if p < 0:
                _fail("Huffman stream overrun")
            at[i] = p
            p -= step[p]
        if p != 0:
            _fail("Huffman stream not used up")
        return self.sym[idx[at]].tobytes()


# Zero bytes below each backward stream: its reads past its start (at most
# HUF_MAX_BITS bits) see zeros.
_PAD = 2
# The lockstep decoder pays off from this many streams on.
_LOCKSTEP_MIN_STREAMS = 16


def _windows(data: np.ndarray, pad: int) -> np.ndarray:
    """w[k]: bytes k..k+2 of ``data`` behind ``pad`` zero bytes, as one
    little-endian 24-bit value."""
    u = np.zeros(pad + len(data) + 2, np.uint32)
    u[pad:pad + len(data)] = data
    return u[:-2] | (u[1:-1] << 8) | (u[2:] << 16)


def _decode_streams(jobs: List[Tuple[bytes, int, "_Huffman"]]
                    ) -> List[bytes]:
    """The symbols of several backward Huffman streams: one by one when
    they are few, else all in lockstep, one numpy step per symbol rank
    (the streams of many blocks, each on its own table)."""
    if len(jobs) < _LOCKSTEP_MIN_STREAMS:
        return [huf.decode(stream, n) for stream, n, huf in jobs]
    tables: dict = {}
    sym_parts, nb_parts = [], []
    sizes = [len(stream) for stream, _, _ in jobs]
    offs = np.cumsum([0] + [_PAD + n for n in sizes])
    data = np.zeros(int(offs[-1]), np.uint8)
    base, start, mb, toff = [], [], [], []
    for (stream, n, huf), off in zip(jobs, offs[:-1].tolist()):
        if not stream or stream[-1] == 0:
            _fail("Huffman stream without its end mark")
        data[off + _PAD:off + _PAD + len(stream)] = np.frombuffer(stream,
                                                                  np.uint8)
        if id(huf) not in tables:
            tables[id(huf)] = sum(len(t) for t in sym_parts)
            sym_parts.append(huf.sym)
            nb_parts.append(huf.nb)
        base.append((off + _PAD) * 8)
        start.append((len(stream) - 1) * 8 + stream[-1].bit_length() - 1)
        mb.append(huf.max_bits)
        toff.append(tables[id(huf)])
    w = _windows(data, 0)
    sym_cat = np.concatenate(sym_parts)
    nb_cat = np.concatenate(nb_parts).astype(np.int64)
    ns = np.array([n for _, n, _ in jobs])
    order = np.argsort(-ns, kind="stable")
    ns_s = ns[order]
    base_s = np.array(base, np.int64)[order]
    pos = base_s + np.array(start, np.int64)[order]
    mb_s = np.array(mb, np.int64)[order]
    mask_s = (1 << mb_s) - 1
    toff_s = np.array(toff, np.int64)[order]
    n_max = int(ns_s[0]) if len(ns_s) else 0
    out = np.zeros((n_max, len(jobs)), np.uint8)
    k = len(jobs)
    for t in range(n_max):
        while ns_s[k - 1] <= t:
            k -= 1
        p = pos[:k]
        lo = np.maximum(p - mb_s[:k], 0)
        e = toff_s[:k] + ((w[lo >> 3] >> (lo & 7)) & mask_s[:k])
        out[t, :k] = sym_cat[e]
        p -= nb_cat[e]
    if not np.array_equal(pos, base_s):
        _fail("Huffman stream overrun or not used up")
    col = np.empty(len(jobs), np.int64)
    col[order] = np.arange(len(jobs))
    return [out[:n, c].tobytes() for (_, n, _), c in zip(jobs, col.tolist())]


def _huffman_weights(buf: memoryview, q: int, end: int
                     ) -> Tuple[List[int], int]:
    """The weights of a Huffman tree description at ``q`` and where it
    ends."""
    if q >= end:
        _fail("Huffman tree description truncated")
    hb = buf[q]
    q += 1
    if hb >= 128:
        n = hb - 127
        nbytes = (n + 1) // 2
        if q + nbytes > end:
            _fail("Huffman weights truncated")
        raw = buf[q:q + nbytes]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return weights[:n], q + nbytes
    if q + hb > end or hb == 0:
        _fail("Huffman weights truncated")
    body = bytes(buf[q:q + hb])
    norm, log, used = _read_ncount(body, 6, 255)
    table = _Fse.build(norm, log)
    bs = _Backward(body[used:])
    sym, nb, base = table.sym, table.nb, table.base
    s1 = bs.read(log)
    s2 = bs.read(log)
    weights = []
    while True:
        if len(weights) > 253:
            _fail("too many Huffman weights")
        weights.append(sym[s1])
        s1 = base[s1] + bs.read(nb[s1])
        if bs.pos < 0:
            weights.append(sym[s2])
            break
        if len(weights) > 253:
            _fail("too many Huffman weights")
        weights.append(sym[s2])
        s2 = base[s2] + bs.read(nb[s2])
        if bs.pos < 0:
            weights.append(sym[s1])
            break
    return weights, q + hb


# ------------------------------------------------------------------ frame
class _FrameState:
    __slots__ = ("huffman", "ll", "of", "ml", "rep", "window", "block_max",
                 "out", "start", "limit")

    def __init__(self, out: bytearray, window: int, limit: Optional[int]):
        self.huffman: Optional[_Huffman] = None
        self.ll = self.of = self.ml = None
        self.rep = [1, 4, 8]
        self.window = window
        self.block_max = min(window, BLOCK_MAX)
        self.out = out
        self.start = len(out)
        self.limit = limit          # the frame's last output byte + 1

    def bound(self) -> int:
        """The end of the output the current block may write: its maximum
        size, and the declared content size."""
        end = len(self.out) + self.block_max
        return end if self.limit is None else min(end, self.limit)

    def grow(self, n: int) -> None:
        """Refuse a block's ``n`` bytes past its bound."""
        if len(self.out) + n > self.bound():
            _fail("block output past its maximum size or the frame's "
                  "declared content size")


def _literals(buf: memoryview, p: int, end: int, st: _FrameState):
    """A compressed block's literals section at ``p``: the literals (raw
    or RLE), or the block's Huffman streams to decode as ``(stream, n,
    table)`` jobs; and where the section ends."""
    b0 = buf[p]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:                        # raw or RLE
        if fmt in (0, 2):
            n, hl = b0 >> 3, 1
        elif fmt == 1:
            hl = 2
            n = (b0 >> 4) + (buf[p + 1] << 4) if p + 1 < end else -1
        else:
            hl = 3
            n = ((b0 >> 4) + (int.from_bytes(buf[p + 1:p + 3], "little") << 4)
                 if p + 2 < end else -1)
        if n < 0 or n > BLOCK_MAX:
            _fail("bad literals header")
        q = p + hl
        if kind == 0:
            if q + n > end:
                _fail("raw literals truncated")
            return bytes(buf[q:q + n]), q + n
        if q >= end:
            _fail("RLE literals truncated")
        return bytes(buf[q:q + 1]) * n, q + 1
    hl, streams, w = ((3, 1, 10), (3, 4, 10), (4, 4, 14), (5, 4, 18))[fmt]
    if p + hl > end:
        _fail("literals header truncated")
    hdr = int.from_bytes(buf[p:p + hl], "little") >> 4
    n, size = hdr & ((1 << w) - 1), hdr >> w
    q, qend = p + hl, p + hl + size
    if n > BLOCK_MAX or qend > end:
        _fail("bad compressed literals header")
    if kind == 2:
        weights, q = _huffman_weights(buf, q, qend)
        st.huffman = _Huffman(weights)
    elif st.huffman is None:
        _fail("treeless literals with no previous Huffman table")
    huf = st.huffman
    if streams == 1:
        return [(bytes(buf[q:qend]), n, huf)], qend
    if q + 6 > qend:
        _fail("literals jump table truncated")
    s1, s2, s3 = (int.from_bytes(buf[q + i:q + i + 2], "little")
                  for i in (0, 2, 4))
    q += 6
    seg = (n + 3) // 4
    last = n - 3 * seg
    if last < 0 or q + s1 + s2 + s3 >= qend:
        _fail("bad literals jump table")
    jobs = []
    for size_i, n_i in ((s1, seg), (s2, seg), (s3, seg),
                        (qend - q - s1 - s2 - s3, last)):
        jobs.append((bytes(buf[q:q + size_i]), n_i, huf))
        q += size_i
    return jobs, qend


def _table(buf: memoryview, q: int, end: int, mode: int, name: str,
           prev: Optional[_Fse], max_sym: int, max_log: int
           ) -> Tuple[_Fse, int]:
    if mode == 0:
        return _PREDEFINED[name], q
    if mode == 1:
        if q >= end or buf[q] > max_sym:
            _fail(f"bad RLE {name} code")
        return _Fse.rle(buf[q]), q + 1
    if mode == 2:
        # a description of max_sym + 1 counts takes well under 512 bytes
        norm, log, used = _read_ncount(bytes(buf[q:min(end, q + 512)]),
                                       max_log, max_sym)
        return _Fse.build(norm, log), q + used
    if prev is None:
        _fail(f"repeated {name} table with no previous table")
    return prev, q


def _sequences(buf: memoryview, p: int, end: int, lit: bytes,
               st: _FrameState) -> None:
    """Decode the sequences section at ``p`` and run it on the frame's
    output with the block's literals."""
    out = st.out
    if p >= end:
        _fail("sequences section missing")
    b0 = buf[p]
    if b0 == 0:
        if p + 1 != end:
            _fail("bytes after an empty sequences section")
        st.grow(len(lit))
        out += lit
        return
    if b0 < 128:
        nseq, p = b0, p + 1
    elif b0 < 255:
        if p + 2 > end:
            _fail("sequence count truncated")
        nseq, p = ((b0 - 128) << 8) + buf[p + 1], p + 2
    else:
        if p + 3 > end:
            _fail("sequence count truncated")
        nseq = int.from_bytes(buf[p + 1:p + 3], "little") + 0x7F00
        p += 3
    if p >= end:
        _fail("sequence modes truncated")
    modes = buf[p]
    p += 1
    if modes & 3:
        _fail("reserved sequence mode bits set")
    st.ll, p = _table(buf, p, end, modes >> 6, "ll", st.ll, LL_MAX,
                      LL_MAX_LOG)
    st.of, p = _table(buf, p, end, (modes >> 4) & 3, "of", st.of, OF_MAX,
                      OF_MAX_LOG)
    st.ml, p = _table(buf, p, end, (modes >> 2) & 3, "ml", st.ml, ML_MAX,
                      ML_MAX_LOG)
    bs = _Backward(bytes(buf[p:end]))
    read = bs.read
    ll_sym, ll_nb, ll_base = st.ll.sym, st.ll.nb, st.ll.base
    of_sym, of_nb, of_base = st.of.sym, st.of.nb, st.of.base
    ml_sym, ml_nb, ml_base = st.ml.sym, st.ml.nb, st.ml.base
    ll_s = read(st.ll.log)
    of_s = read(st.of.log)
    ml_s = read(st.ml.log)
    r0, r1, r2 = st.rep
    window, frame_start = st.window, st.start
    block_end = st.bound()
    lit_pos, nlit = 0, len(lit)
    for i in range(nseq):
        oc = of_sym[of_s]
        lc = ll_sym[ll_s]
        mc = ml_sym[ml_s]
        ofv = (1 << oc) + read(oc)
        ml = ML_BASE[mc] + read(ML_BITS[mc])
        ll = LL_BASE[lc] + read(LL_BITS[lc])
        if i + 1 < nseq:
            ll_s = ll_base[ll_s] + read(ll_nb[ll_s])
            ml_s = ml_base[ml_s] + read(ml_nb[ml_s])
            of_s = of_base[of_s] + read(of_nb[of_s])
        if ofv > 3:
            off = ofv - 3
            r0, r1, r2 = off, r0, r1
        else:
            k = ofv - (ll != 0)
            if k == 0:
                off = r0
            elif k == 1:
                off = r1
                r0, r1 = r1, r0
            elif k == 2:
                off = r2
                r0, r1, r2 = r2, r0, r1
            else:
                off = r0 - 1
                r0, r1, r2 = off, r0, r1
        if lit_pos + ll > nlit:
            _fail("sequence past the block's literals")
        o = len(out)
        if o + ll + ml > block_end:
            _fail("sequence output past the block or frame bound")
        if ll:
            out += lit[lit_pos:lit_pos + ll]
            lit_pos += ll
            o += ll
        if off <= 0 or off > o - frame_start or off > window:
            _fail(f"match offset {off} out of range")
        s = o - off
        if off >= ml:
            out += out[s:s + ml]
        else:
            pat = out[s:o]
            reps, rest = divmod(ml, off)
            out += pat * reps + pat[:rest]
    if bs.pos != 0:
        _fail("sequences bitstream not used up")
    st.rep = [r0, r1, r2]
    if len(out) + nlit - lit_pos > block_end:
        _fail("sequence output past the block or frame bound")
    out += lit[lit_pos:]


# Blocks parsed ahead of their run, their Huffman streams decoded together.
_GROUP_BLOCKS = 1024


def _run_blocks(buf: memoryview, group: list, st: _FrameState) -> None:
    """Run parsed blocks in order: their Huffman streams decoded together
    first (``_decode_streams``), then each block's output."""
    jobs = [job for kind, _, _, lit, _ in group
            if kind == 2 and isinstance(lit, list) for job in lit]
    texts = iter(_decode_streams(jobs))
    out = st.out
    for kind, p, size, lit, q in group:
        if kind == 1:
            st.grow(size)
            out += bytes(buf[p:p + 1]) * size
        elif kind == 0:
            st.grow(size)
            out += buf[p:p + size]
        else:
            if isinstance(lit, list):
                lit = b"".join(next(texts) for _ in lit)
            _sequences(buf, q, p + size, lit, st)


def _frame(buf: memoryview, p: int, out: bytearray) -> int:
    """Decode the frame whose header starts at ``p`` (past its magic) into
    ``out``; returns where the frame ends."""
    n = len(buf)
    if p >= n:
        _fail("frame header truncated")
    fhd = buf[p]
    p += 1
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        _fail("reserved frame header bit set")
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    window = 0
    if not single:
        if p >= n:
            _fail("window descriptor truncated")
        wd = buf[p]
        p += 1
        wlog = 10 + (wd >> 3)
        if wlog > MAX_WINDOW_LOG:
            _fail(f"window log {wlog} too large")
        window = (1 << wlog) + ((1 << wlog) >> 3) * (wd & 7)
    did_size = (0, 1, 2, 4)[dict_flag]
    fcs_size = (single, 2, 4, 8)[fcs_flag]
    if p + did_size + fcs_size > n:
        _fail("frame header truncated")
    if int.from_bytes(buf[p:p + did_size], "little"):
        raise DictionaryFrame("the zstd frame needs a dictionary")
    p += did_size
    fcs = None
    if fcs_size:
        fcs = int.from_bytes(buf[p:p + fcs_size], "little")
        fcs += 256 if fcs_size == 2 else 0
        p += fcs_size
    if single:
        window = fcs
    st = _FrameState(out, window, None if fcs is None else len(out) + fcs)
    group: list = []        # blocks parsed, not yet run
    while True:
        if p + 3 > n:
            _fail("block header truncated")
        bh = int.from_bytes(buf[p:p + 3], "little")
        p += 3
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        if kind == 3:
            _fail("reserved block type")
        if kind == 1:
            if p >= n:
                _fail("RLE block truncated")
            group.append((1, p, size, None, None))
            p += 1
        else:
            if size > BLOCK_MAX or p + size > n:
                _fail("bad block size")
            if kind == 2:
                if size == 0:
                    _fail("empty compressed block")
                lit, q = _literals(buf, p, p + size, st)
                group.append((2, p, size, lit, q))
            else:
                group.append((0, p, size, None, None))
            p += size
        if last or len(group) == _GROUP_BLOCKS:
            _run_blocks(buf, group, st)
            group = []
        if last:
            break
    if st.limit is not None and len(out) != st.limit:
        _fail("frame content shorter than its declared size")
    if checksum:
        if p + 4 > n:
            _fail("content checksum truncated")
        want = int.from_bytes(buf[p:p + 4], "little")
        if xxh64(memoryview(out)[st.start:]) & 0xFFFFFFFF != want:
            _fail("content checksum mismatch")
        p += 4
    return p


def decompress(data) -> bytearray:
    """The content of one or more zstd frames back to back (skippable
    frames skipped)."""
    buf = memoryview(data).cast("B")
    n = len(buf)
    if n == 0:
        _fail("no zstd frame")
    out = bytearray()
    p = 0
    while p < n:
        if p + 4 > n:
            _fail("frame magic truncated")
        magic = int.from_bytes(buf[p:p + 4], "little")
        if magic & SKIPPABLE_MASK == SKIPPABLE_MAGIC:
            if p + 8 > n:
                _fail("skippable frame header truncated")
            p += 8 + int.from_bytes(buf[p + 4:p + 8], "little")
            if p > n:
                _fail("skippable frame truncated")
            continue
        if magic != FRAME_MAGIC:
            _fail("not a zstd frame (bad magic)")
        p = _frame(buf, p + 4, out)
    return out
