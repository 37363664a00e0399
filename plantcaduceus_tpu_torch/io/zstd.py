"""Zstandard decompression (RFC 8878) in Python and numpy.

The JAX package writes its parquet shards and tokenized fine-tuning tables
with zstd pages (pandas' ``to_parquet(compression="zstd")``), and reads them
with pyarrow. The GPU hosts have neither pyarrow nor ``zstandard``, so the
port carries this decoder for ``io/parquet``.

:func:`decompress` decodes every frame of its input in a row:

* zstd frames: single-segment or windowed headers, frame content sizes of
  0, 1, 2, 4 or 8 bytes (checked when present), a dictionary ID of 0;
* raw, RLE and compressed blocks, matches reaching back across blocks;
* literals raw, RLE or Huffman-coded in 1 or 4 streams, the Huffman weights
  given directly (4 bits each) or FSE-compressed, treeless literals reusing
  the previous table;
* sequences with predefined, RLE, FSE-compressed or repeated tables for
  literal lengths, match lengths and offsets, read from the interleaved
  backward bitstream, and executed with the three repeat offsets;
* skippable frames (ignored);
* the content checksum, the low 32 bits of :func:`xxh64`, checked when the
  frame carries one.

A nonzero dictionary ID, a reserved bit set, a checksum or size that does
not match, and any stream that does not decode to its stated end raise a
``ValueError`` that names the fault. Huffman literals are decoded through a
table lookup at every bit position at once (numpy) and a walk over the
code lengths; matches are copied as slices.
"""

from __future__ import annotations

import functools
import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
SKIPPABLE_MASK, SKIPPABLE = 0xFFFFFFF0, 0x184D2A50
BLOCK_MAX = 128 * 1024
HUF_MAX_BITS = 11

# Literal and match length codes: (baseline, extra bits) (RFC 8878 3.1.1.3.2.1.1)
LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024, 2048,
                             4096, 8192, 16384, 32768, 65536]
LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
                                2051, 4099, 8195, 16387, 32771, 65539]
ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]

# Predefined distributions (RFC 8878 3.1.1.3.2.2): (normalized counts, accuracy log)
LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1,
               1, 1, 1, 1, -1, -1, -1, -1], 6)
ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
# (max accuracy log, max symbol) of each sequence table
LL_LIMITS, ML_LIMITS, OF_LIMITS = (9, 35), (9, 52), (8, 31)

_M64 = (1 << 64) - 1
_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261


def _corrupt(what: str) -> ValueError:
    return ValueError(f"corrupt zstd data: {what}")


# ---------------------------------------------------------------------------
# XXH64
# ---------------------------------------------------------------------------


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    acc = (acc + lane * _P2) & _M64
    return (((acc << 31) | (acc >> 33)) & _M64) * _P1 & _M64


def xxh64(data: bytes) -> int:
    """XXH64 of ``data`` with seed 0 (the hash zstd's content checksum takes)."""
    n = len(data)
    p = 0
    if n >= 32:
        stripes = n // 32
        # lane * P2 for every lane at once (uint64 products wrap as the hash's do)
        pre = (np.frombuffer(data, "<u8", count=stripes * 4) * np.uint64(_P2)).tolist()
        v1, v2, v3, v4 = (_P1 + _P2) & _M64, _P2, 0, (-_P1) & _M64
        for i in range(0, 4 * stripes, 4):
            v1 = (v1 + pre[i]) & _M64
            v1 = (((v1 << 31) | (v1 >> 33)) & _M64) * _P1 & _M64
            v2 = (v2 + pre[i + 1]) & _M64
            v2 = (((v2 << 31) | (v2 >> 33)) & _M64) * _P1 & _M64
            v3 = (v3 + pre[i + 2]) & _M64
            v3 = (((v3 << 31) | (v3 >> 33)) & _M64) * _P1 & _M64
            v4 = (v4 + pre[i + 3]) & _M64
            v4 = (((v4 << 31) | (v4 >> 33)) & _M64) * _P1 & _M64
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        p = stripes * 32
    else:
        h = _P5
    h = (h + n) & _M64
    while p + 8 <= n:
        (lane,) = struct.unpack_from("<Q", data, p)
        h = (_rotl(h ^ _round(0, lane), 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        (lane,) = struct.unpack_from("<I", data, p)
        h = (_rotl(h ^ (lane * _P1 & _M64), 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h = _rotl(h ^ (data[p] * _P5 & _M64), 11) * _P1 & _M64
        p += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ---------------------------------------------------------------------------
# Bitstreams and FSE tables
# ---------------------------------------------------------------------------


class _Backward:
    """A backward bitstream: read from its last bit (under the final byte's
    marker bit) towards its first, high bits first. Reading past the start
    yields zeros and leaves ``pos`` negative."""

    def __init__(self, data: bytes, what: str):
        if not data or not data[-1]:
            raise _corrupt(f"{what} bitstream lacks its end marker")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if not n:
            return 0
        pos, lo = self.pos, self.pos - n
        self.pos = lo
        if lo >= 0:
            v = int.from_bytes(self.data[lo >> 3:(pos + 7) >> 3], "little") >> (lo & 7)
            return v & ((1 << n) - 1)
        if pos <= 0:
            return 0
        v = int.from_bytes(self.data[:(pos + 7) >> 3], "little") & ((1 << pos) - 1)
        return v << -lo


def _read_ncount(data: bytes, pos: int, end: int, max_log: int,
                 max_symbol: int) -> Tuple[List[int], int, int]:
    """An FSE table description at data[pos:end]: (normalized counts,
    accuracy log, bytes used)."""
    span = data[pos:min(end, pos + 512)]
    bits = int.from_bytes(span, "little")
    nbits = 8 * len(span)
    at = 0

    def take(n):
        nonlocal at
        v = (bits >> at) & ((1 << n) - 1)
        at += n
        return v

    if nbits < 4:
        raise _corrupt("truncated FSE table description")
    log = take(4) + 5
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} above the limit {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    counts: List[int] = []
    previous0 = False
    while remaining > 1:
        if previous0:
            while True:
                r = take(2)
                counts.extend([0] * r)
                if r != 3:
                    break
            if len(counts) > max_symbol:
                raise _corrupt("FSE table description past its last symbol")
        mx = 2 * threshold - 1 - remaining
        low = (bits >> at) & (threshold - 1)
        if low < mx:
            count = low
            at += nb - 1
        else:
            count = (bits >> at) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            at += nb
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        previous0 = count == 0
        if remaining < threshold:
            if remaining <= 1:
                break
            nb = remaining.bit_length()
            threshold = 1 << (nb - 1)
        if len(counts) > max_symbol + 1:
            raise _corrupt("FSE table description past its last symbol")
        if at > nbits:
            raise _corrupt("truncated FSE table description")
    if remaining != 1 or at > nbits:
        raise _corrupt("FSE table description does not sum to its table size")
    return counts, log, (at + 7) >> 3


def _fse_table(counts: List[int], log: int) -> Tuple[list, list, list, int]:
    """The decoding table of normalized counts: (symbol, bits to read,
    next-state baseline) per state, and the accuracy log."""
    size = 1 << log
    sym = [0] * size
    nxt = []
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:  # "less than 1": one cell at the table's top, a full-width reload
            sym[high] = s
            high -= 1
            nxt.append(1)
        else:
            nxt.append(c)
    step, mask, p = (size >> 1) + (size >> 3) + 3, size - 1, 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[p] = s
            p = (p + step) & mask
            while p > high:
                p = (p + step) & mask
    if p:
        raise _corrupt("FSE counts do not fill their table")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        x = nxt[sym[u]]
        nxt[sym[u]] = x + 1
        nb = log - (x.bit_length() - 1)
        nbits[u], base[u] = nb, (x << nb) - size
    return sym, nbits, base, log


@functools.lru_cache(maxsize=None)
def _default_table(which: str):
    counts, log = {"ll": LL_DEFAULT, "ml": ML_DEFAULT, "of": OF_DEFAULT}[which]
    return _fse_table(counts, log)


# ---------------------------------------------------------------------------
# Huffman literals
# ---------------------------------------------------------------------------


def _huffman_weights(data: bytes, pos: int, end: int) -> Tuple[List[int], int]:
    """The Huffman tree description at data[pos:end]: (weights of every
    symbol but the last, bytes used)."""
    if pos >= end:
        raise _corrupt("truncated Huffman tree description")
    head = data[pos]
    if head >= 128:  # direct: 4 bits a weight
        n = head - 127
        used = 1 + (n + 1) // 2
        if pos + used > end:
            raise _corrupt("truncated Huffman weights")
        raw = data[pos + 1:pos + used]
        weights = [w for b in raw for w in (b >> 4, b & 15)][:n]
        return weights, used
    if pos + 1 + head > end or head == 0:
        raise _corrupt("truncated Huffman weights")
    comp = data[pos + 1:pos + 1 + head]
    counts, log, used = _read_ncount(comp, 0, len(comp), 6, 255)
    sym, nbits, base, _ = _fse_table(counts, log)
    br = _Backward(comp[used:], "Huffman weights")
    s1, s2 = br.read(log), br.read(log)
    weights = []
    while True:  # two interleaved states; the stream's overrun ends it
        weights.append(sym[s1])
        s1 = base[s1] + br.read(nbits[s1])
        if br.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + br.read(nbits[s2])
        if br.pos < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise _corrupt("too many Huffman weights")
    return weights, 1 + head


def _huffman_table(weights: List[int]) -> Tuple[np.ndarray, np.ndarray, int]:
    """(symbol, code length) for every ``max_bits``-bit prefix, and
    max_bits, from the given weights and the implied last one."""
    if any(w > HUF_MAX_BITS for w in weights):
        raise _corrupt("Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w)
    if not total:
        raise _corrupt("Huffman weights all zero")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if max_bits > HUF_MAX_BITS or rest & (rest - 1):
        raise _corrupt("Huffman weights do not complete a prefix code")
    weights = weights + [rest.bit_length()]
    size = 1 << max_bits
    sym, nb = np.zeros(size, np.uint8), np.zeros(size, np.int64)
    starts, at = {}, 0
    for w in range(1, max_bits + 1):
        starts[w] = at
        at += sum(1 for x in weights if x == w) << (w - 1)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            sym[starts[w]:starts[w] + n] = s
            nb[starts[w]:starts[w] + n] = max_bits + 1 - w
            starts[w] += n
    return sym, nb, max_bits


def _huffman_stream(stream: bytes, n: int, table) -> np.ndarray:
    """``n`` symbols of one backward Huffman stream, which they must use
    exactly: the code's table is looked up at every bit position at once,
    then the walk follows the code lengths from the stream's end."""
    sym, nb, max_bits = table
    if not stream or not stream[-1]:
        raise _corrupt("Huffman stream lacks its end marker")
    total = 8 * (len(stream) - 1) + stream[-1].bit_length() - 1
    bits = np.unpackbits(np.frombuffer(stream, np.uint8), bitorder="little")[:total]
    padded = np.concatenate([np.zeros(max_bits, np.uint8), bits]).astype(np.int64)
    peek = np.zeros(total + 1, np.int64)
    for i in range(max_bits):  # peek[p]: the max_bits bits under position p, high first
        peek |= padded[i:i + total + 1] << i
    if nb.min() == nb.max():  # one code length: the positions are a stride
        pos = total - int(nb[0]) * np.arange(n, dtype=np.int64)
        end = total - int(nb[0]) * n
    else:
        step = nb[peek].tolist()
        walk = [0] * n
        p = total
        for k in range(n):
            walk[k] = p
            p -= step[p] if p >= 0 else 1 << 30
        pos, end = np.asarray(walk, np.int64), p
    if end != 0:
        raise _corrupt("Huffman stream does not end where its literals do")
    return sym[peek[pos]]


# ---------------------------------------------------------------------------
# Frames and blocks
# ---------------------------------------------------------------------------


class _Frame:
    """What a frame's blocks hand on to the next: tables, offsets, output."""

    def __init__(self):
        self.out = bytearray()
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]


def _literals(data: bytes, pos: int, end: int, fr: _Frame) -> Tuple[bytes, int]:
    """The literals section at data[pos:end]: (literals, position after it)."""
    b0 = data[pos]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):  # raw or RLE
        if fmt in (0, 2):
            size, hl = b0 >> 3, 1
        elif fmt == 1:
            size, hl = (b0 >> 4) + (data[pos + 1] << 4), 2
        else:
            size, hl = (b0 >> 4) + (data[pos + 1] << 4) + (data[pos + 2] << 12), 3
        pos += hl
        if kind == 0:
            if pos + size > end:
                raise _corrupt("raw literals run past their block")
            return bytes(data[pos:pos + size]), pos + size
        if pos >= end:
            raise _corrupt("RLE literals run past their block")
        return bytes([data[pos]]) * size, pos + 1
    hl = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    if pos + hl > end:
        raise _corrupt("truncated literals header")
    h = int.from_bytes(data[pos:pos + hl], "little")
    width = {3: 10, 4: 14, 5: 18}[hl]
    size = (h >> 4) & ((1 << width) - 1)
    csize = (h >> (4 + width)) & ((1 << width) - 1)
    streams = 1 if fmt == 0 else 4
    pos += hl
    stop = pos + csize
    if stop > end or size > BLOCK_MAX:
        raise _corrupt("compressed literals run past their block")
    if kind == 2:
        weights, used = _huffman_weights(data, pos, stop)
        fr.huffman = _huffman_table(weights)
        pos += used
    elif fr.huffman is None:
        raise _corrupt("treeless literals without an earlier Huffman table")
    if streams == 1:
        lits = _huffman_stream(data[pos:stop], size, fr.huffman)
    else:
        if pos + 6 > stop:
            raise _corrupt("truncated literals jump table")
        s1, s2, s3 = struct.unpack_from("<3H", data, pos)
        pos += 6
        s4 = stop - pos - s1 - s2 - s3
        each = (size + 3) // 4
        last = size - 3 * each
        if s4 < 0 or last < 0:
            raise _corrupt("literals jump table does not fit its streams")
        parts, at = [], pos
        for s, n in ((s1, each), (s2, each), (s3, each), (s4, last)):
            parts.append(_huffman_stream(data[at:at + s], n, fr.huffman))
            at += s
        lits = np.concatenate(parts)
    return lits.tobytes(), stop


def _seq_table(mode: int, which: str, data: bytes, pos: int, end: int,
               fr: _Frame) -> int:
    """Set ``fr.tables[which]`` for this block's mode; the position after
    its description."""
    max_log, max_symbol = {"ll": LL_LIMITS, "ml": ML_LIMITS, "of": OF_LIMITS}[which]
    if mode == 0:
        fr.tables[which] = _default_table(which)
    elif mode == 1:
        if pos >= end or data[pos] > max_symbol:
            raise _corrupt(f"RLE {which} symbol out of range")
        fr.tables[which] = ([data[pos]], [0], [0], 0)
        pos += 1
    elif mode == 2:
        counts, log, used = _read_ncount(data, pos, end, max_log, max_symbol)
        fr.tables[which] = _fse_table(counts, log)
        pos += used
    elif fr.tables[which] is None:
        raise _corrupt(f"repeated {which} table without an earlier one")
    return pos


def _sequences(data: bytes, pos: int, end: int, lits: bytes, fr: _Frame) -> None:
    """Decode the sequences section at data[pos:end] and execute it on the
    frame's output with ``lits``."""
    out = fr.out
    b0 = data[pos]
    if b0 == 0:
        if pos + 1 != end:
            raise _corrupt("bytes after an empty sequences section")
        out += lits
        return
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        nseq, pos = ((b0 - 128) << 8) + data[pos + 1], pos + 2
    else:
        nseq, pos = data[pos + 1] + (data[pos + 2] << 8) + 0x7F00, pos + 3
    if pos >= end:
        raise _corrupt("truncated sequences header")
    modes = data[pos]
    if modes & 3:
        raise ValueError("zstd sequences header has its reserved bits set")
    pos += 1
    for which, shift in (("ll", 6), ("of", 4), ("ml", 2)):
        pos = _seq_table((modes >> shift) & 3, which, data, pos, end, fr)
    ll_sym, ll_nb, ll_base, ll_log = fr.tables["ll"]
    of_sym, of_nb, of_base, of_log = fr.tables["of"]
    ml_sym, ml_nb, ml_base, ml_log = fr.tables["ml"]
    ll_val, ll_xb = [LL_BASE[s] for s in ll_sym], [LL_BITS[s] for s in ll_sym]
    ml_val, ml_xb = [ML_BASE[s] for s in ml_sym], [ML_BITS[s] for s in ml_sym]
    br = _Backward(data[pos:end], "sequences")
    ll_s, of_s, ml_s = br.read(ll_log), br.read(of_log), br.read(ml_log)
    stream, bit = br.data, br.pos
    # words[k]: the 64 bits from byte k on, so a read of up to 57 bits at
    # bit position p is one lookup and a shift
    padded = np.frombuffer(stream + bytes(8), np.uint8).astype(np.uint64)
    words = np.zeros(len(stream), np.uint64)
    for j in range(8):
        words |= padded[j:j + len(stream)] << np.uint64(8 * j)
    words = words.tolist()
    reps = fr.reps
    lp, nl = 0, len(lits)
    for i in range(nseq):
        ofc, mlx, llx = of_sym[of_s], ml_xb[ml_s], ll_xb[ll_s]
        n = ofc + mlx + llx  # extra bits, offset's first
        if n:
            bit -= n
            if bit < 0:
                raise _corrupt("sequences bitstream ends before its sequences do")
            if n <= 57:
                v = (words[bit >> 3] >> (bit & 7)) & ((1 << n) - 1)
            else:
                v = (int.from_bytes(stream[bit >> 3:(bit + n + 7) >> 3], "little")
                     >> (bit & 7)) & ((1 << n) - 1)
            ll = ll_val[ll_s] + (v & ((1 << llx) - 1))
            v >>= llx
            ml = ml_val[ml_s] + (v & ((1 << mlx) - 1))
            ov = (1 << ofc) + (v >> mlx)
        else:
            ll, ml, ov = ll_val[ll_s], ml_val[ml_s], 1
        if ov > 3:
            off = ov - 3
            reps[2], reps[1], reps[0] = reps[1], reps[0], off
        else:
            idx = ov - (ll != 0)  # 0: rep 1, 1: rep 2, 2: rep 3, 3: rep 1 - 1
            if idx == 0:
                off = reps[0]
            elif idx == 1:
                off = reps[1]
                reps[1], reps[0] = reps[0], off
            else:
                off = reps[2] if idx == 2 else reps[0] - 1
                if not off:
                    raise _corrupt("repeat offset of 0")
                reps[2], reps[1], reps[0] = reps[1], reps[0], off
        if i + 1 < nseq:  # the states' updates: literal length's bits first
            a, b, c = ll_nb[ll_s], ml_nb[ml_s], of_nb[of_s]
            n = a + b + c
            bit -= n
            if bit < 0:
                raise _corrupt("sequences bitstream ends before its sequences do")
            v = (words[bit >> 3] >> (bit & 7)) & ((1 << n) - 1)
            of_s = of_base[of_s] + (v & ((1 << c) - 1))
            v >>= c
            ml_s = ml_base[ml_s] + (v & ((1 << b) - 1))
            ll_s = ll_base[ll_s] + (v >> b)
        if lp + ll > nl:
            raise _corrupt("a sequence takes more literals than the block has")
        out += lits[lp:lp + ll]
        lp += ll
        start = len(out) - off
        if start < 0:
            raise _corrupt(f"match offset {off} reaches before the frame's start")
        if off >= ml:
            out += out[start:start + ml]
        else:  # overlapping: the last ``off`` bytes repeat
            out += (out[start:] * (ml // off + 1))[:ml]
    if bit != 0:
        raise _corrupt("sequences bitstream does not end where its sequences do")
    out += lits[lp:]


def _frame(data: bytes, pos: int) -> Tuple[bytes, int]:
    """Decode the zstd frame at ``pos`` (past its magic number): (its
    content, the position after it)."""
    if pos >= len(data):
        raise _corrupt("truncated frame header")
    fhd = data[pos]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 0x08:
        raise ValueError("zstd frame header has its reserved bit set")
    has_checksum, did_flag = (fhd >> 2) & 1, fhd & 3
    pos += 1 + (not single)  # the window descriptor, which a whole-frame output needs not
    did_size = (0, 1, 2, 4)[did_flag]
    did = int.from_bytes(data[pos:pos + did_size], "little")
    if did:
        raise ValueError(f"zstd frame needs dictionary {did}, which the port's decoder does "
                         "not have (frames with dictionaries are not read)")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if pos + fcs_size > len(data):
        raise _corrupt("truncated frame header")
    fcs = int.from_bytes(data[pos:pos + fcs_size], "little") + (256 if fcs_size == 2 else 0)
    pos += fcs_size
    fr = _Frame()
    while True:
        if pos + 3 > len(data):
            raise _corrupt("truncated block header")
        bh = int.from_bytes(data[pos:pos + 3], "little")
        last, kind, size = bh & 1, (bh >> 1) & 3, bh >> 3
        pos += 3
        before = len(fr.out)
        if kind == 0:
            if pos + size > len(data):
                raise _corrupt("raw block runs past the input")
            fr.out += data[pos:pos + size]
            pos += size
        elif kind == 1:
            if pos >= len(data):
                raise _corrupt("RLE block runs past the input")
            fr.out += bytes([data[pos]]) * size
            pos += 1
        elif kind == 2:
            end = pos + size
            if end > len(data) or size > BLOCK_MAX or not size:
                raise _corrupt("compressed block runs past the input")
            lits, p = _literals(data, pos, end, fr)
            if p >= end:
                raise _corrupt("compressed block lacks its sequences section")
            _sequences(data, p, end, lits, fr)
            pos = end
        else:
            raise _corrupt("reserved block type")
        if len(fr.out) - before > BLOCK_MAX:
            raise _corrupt("a block decodes to more than 128 KiB")
        if last:
            break
    out = bytes(fr.out)
    if has_checksum:
        if pos + 4 > len(data):
            raise _corrupt("truncated content checksum")
        (want,) = struct.unpack_from("<I", data, pos)
        got = xxh64(out) & 0xFFFFFFFF
        if got != want:
            raise ValueError(f"zstd content checksum mismatch: {got:08x} != {want:08x}")
        pos += 4
    if fcs_size and len(out) != fcs:
        raise _corrupt(f"frame decodes to {len(out)} bytes, its header says {fcs}")
    return out, pos


def decompress(data: bytes, max_output: Optional[int] = None) -> bytes:
    """The content of every frame in ``data``, in a row (skippable frames
    skipped). Raises ``ValueError`` on an input with no frame, a frame this
    decoder does not read, or corrupt data; past ``max_output`` bytes too,
    where one is given."""
    data = bytes(data)
    if not data:
        raise _corrupt("no frame in an empty input")
    parts, pos, total = [], 0, 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise _corrupt("truncated magic number")
        (magic,) = struct.unpack_from("<I", data, pos)
        if magic & SKIPPABLE_MASK == SKIPPABLE:
            if pos + 8 > len(data):
                raise _corrupt("truncated skippable frame")
            (n,) = struct.unpack_from("<I", data, pos + 4)
            pos += 8 + n
            if pos > len(data):
                raise _corrupt("skippable frame runs past the input")
            continue
        if magic != MAGIC:
            raise _corrupt(f"bad magic number {magic:#010x}")
        try:
            out, pos = _frame(data, pos + 4)
        except (IndexError, struct.error):  # a length or offset past the input's end
            raise _corrupt("a field runs past the end of the input") from None
        total += len(out)
        if max_output is not None and total > max_output:
            raise _corrupt(f"more than the {max_output} bytes expected")
        parts.append(out)
    return b"".join(parts)
