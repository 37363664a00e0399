"""Flat parquet tables, read and written without pandas or pyarrow.

The JAX package reads its parquet tables (pre-training sources and shards,
the PlantCAD2 evaluation tables) with pandas, and ``convert_to_shards``
writes them with pandas. The GPU hosts carry neither pandas nor pyarrow,
so this module is the port's own reader and writer, in Python and numpy.

Reader (:func:`read_parquet`), flat columns only:

* physical types BOOLEAN, INT32, INT64, FLOAT, DOUBLE and BYTE_ARRAY
  (text), ``required`` or ``optional``;
* PLAIN, PLAIN_DICTIONARY and RLE_DICTIONARY values (a dictionary page and
  then PLAIN pages in one chunk, as pyarrow writes once its dictionary
  overflows), RLE-encoded booleans, RLE/bit-packed hybrid levels;
* DATA_PAGE and DATA_PAGE_V2, any number of row groups;
* codecs UNCOMPRESSED, GZIP and SNAPPY (:func:`snappy_decompress`).

ZSTD, LZ4, BROTLI and LZO pages, the DELTA encodings, INT96 and
fixed-length columns and nested columns (lists, structs, maps) raise a
``ValueError`` that names the codec, encoding or column and how to re-write
the file. The footer and page headers are Thrift compact structs, read by a
parser that skips the fields it does not know.

Writer (:func:`write_parquet`): flat text, integer and float columns
(``None`` in a text column is a null), one row group, one PLAIN page per
column, GZIP (default) or uncompressed; pyarrow and pandas read its files.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

MAGIC = b"PAR1"

# parquet.thrift enums
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY",
              "FIXED_LEN_BYTE_ARRAY")
REQUIRED, OPTIONAL, REPEATED = range(3)
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
                  5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
                  7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
UNCOMPRESSED, SNAPPY, GZIP = 0, 1, 2
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
               6: "ZSTD", 7: "LZ4_RAW"}
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
UTF8 = 0  # ConvertedType
_NUMPY = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}
_REWRITE = ("re-write it with compression='gzip' or 'snappy' (pandas: "
            "df.to_parquet(path, compression='gzip')), or convert the source with "
            "plantcaduceus_tpu_torch.train.streaming.convert_to_shards")

Column = Union[list, np.ndarray]


# ---------------------------------------------------------------------------
# Thrift compact protocol
# ---------------------------------------------------------------------------


class _Reader:
    """Thrift compact-protocol structs as dicts keyed by field id."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf, self.pos = buf, pos

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if b < 0x80:
                return out
            shift += 7

    def zigzag(self) -> int:
        n = self.varint()
        return (n >> 1) ^ -(n & 1)

    def binary(self) -> bytes:
        n = self.varint()
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def value(self, ctype: int):
        if ctype in (1, 2):          # a bool inside a list: one byte
            return self.byte() == 1
        if ctype == 3:
            b = self.byte()
            return b - 256 if b > 127 else b
        if ctype in (4, 5, 6):
            return self.zigzag()
        if ctype == 7:
            (v,) = struct.unpack_from("<d", self.buf, self.pos)
            self.pos += 8
            return v
        if ctype == 8:
            return self.binary()
        if ctype in (9, 10):
            head = self.byte()
            n, etype = head >> 4, head & 0x0F
            if n == 15:
                n = self.varint()
            return [self.value(etype) for _ in range(n)]
        if ctype == 11:
            n = self.varint()
            if not n:
                return {}
            kv = self.byte()
            return {self.value(kv >> 4): self.value(kv & 0x0F) for _ in range(n)}
        if ctype == 12:
            return self.struct()
        raise ValueError(f"corrupt parquet metadata: thrift type {ctype}")

    def struct(self) -> dict:
        out, fid = {}, 0
        while True:
            head = self.byte()
            if head == 0:
                return out
            delta, ctype = head >> 4, head & 0x0F
            fid = fid + delta if delta else self.zigzag()
            out[fid] = ctype == 1 if ctype in (1, 2) else self.value(ctype)


class _Writer:
    """Thrift compact-protocol output; a struct is a list of (field id,
    type, value), with type one of i32, i64, bin, list:<type>, struct."""

    def __init__(self):
        self.out = bytearray()

    def varint(self, n: int) -> None:
        while n > 0x7F:
            self.out.append((n & 0x7F) | 0x80)
            n >>= 7
        self.out.append(n)

    def zigzag(self, n: int) -> None:
        self.varint((n << 1) ^ (n >> 63))

    _CTYPES = {"i32": 5, "i64": 6, "bin": 8, "list": 9, "struct": 12}

    def value(self, kind: str, v) -> None:
        if kind in ("i32", "i64"):
            self.zigzag(int(v))
        elif kind == "bin":
            v = v.encode() if isinstance(v, str) else v
            self.varint(len(v))
            self.out += v
        elif kind == "struct":
            self.struct(v)
        elif kind.startswith("list:"):
            inner = kind[5:]
            n = len(v)
            self.out.append((min(n, 15) << 4) | self._CTYPES[inner.split(":")[0]])
            if n >= 15:
                self.varint(n)
            for x in v:
                self.value(inner, x)
        else:
            raise ValueError(kind)

    def struct(self, fields) -> None:
        last = 0
        for fid, kind, v in fields:
            if v is None:
                continue
            ctype = self._CTYPES[kind.split(":")[0]]
            if 0 < fid - last <= 15:
                self.out.append(((fid - last) << 4) | ctype)
            else:
                self.out.append(ctype)
                self.zigzag(fid)
            last = fid
            self.value(kind, v)
        self.out.append(0)


# ---------------------------------------------------------------------------
# Codecs and encodings
# ---------------------------------------------------------------------------


def snappy_decompress(data: bytes) -> bytes:
    """Raw (unframed) snappy: a varint length, then literals and back
    copies; a copy may overlap its own output."""
    r = _Reader(data)
    n = r.varint()
    out = bytearray()
    pos, end = r.pos, len(data)
    while pos < end:
        tag = data[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:
            length = (tag >> 2) + 1
            if length > 60:
                extra = length - 60
                length = int.from_bytes(data[pos:pos + extra], "little") + 1
                pos += extra
            out += data[pos:pos + length]
            pos += length
            continue
        if kind == 1:
            length = 4 + ((tag >> 2) & 7)
            offset = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif kind == 2:
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:
            length = (tag >> 2) + 1
            offset = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if not 0 < offset <= len(out):
            raise ValueError("corrupt snappy data: copy offset out of range")
        start = len(out) - offset
        if offset >= length:
            out += out[start:start + length]
        else:  # overlapping: the last ``offset`` bytes repeat
            pattern = bytes(out[start:])
            out += (pattern * (length // offset + 1))[:length]
    if len(out) != n:
        raise ValueError(f"corrupt snappy data: {len(out)} bytes, header says {n}")
    return bytes(out)


def _decompress(data: bytes, codec: int, where: str) -> bytes:
    if codec == UNCOMPRESSED:
        return data
    if codec == SNAPPY:
        return snappy_decompress(data)
    if codec == GZIP:
        return zlib.decompressobj(wbits=47).decompress(data)  # gzip or zlib header
    name = CODEC_NAMES.get(codec, f"codec {codec}")
    raise ValueError(f"{where}: {name} compression is not read by the PyTorch port "
                     f"(no {name.lower()} decoder on the GPU hosts); {_REWRITE}")


def _unpack_bits(buf: bytes, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian bit-packed values of ``bit_width`` bits."""
    if bit_width == 0:
        return np.zeros(count, np.int64)
    bits = np.unpackbits(np.frombuffer(buf, np.uint8), bitorder="little")
    bits = bits[:count * bit_width].reshape(count, bit_width).astype(np.int64)
    return bits @ (np.int64(1) << np.arange(bit_width, dtype=np.int64))


def rle_hybrid(buf: bytes, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """Decode ``count`` values of the RLE/bit-packed hybrid in buf[pos:end]."""
    out = np.zeros(count, np.int64)
    n = 0
    width_bytes = (bit_width + 7) // 8
    r = _Reader(buf, pos)
    while n < count and r.pos < end:
        header = r.varint()
        if header & 1:  # bit-packed groups of 8
            groups = header >> 1
            nbytes = groups * bit_width
            vals = _unpack_bits(buf[r.pos:r.pos + nbytes], bit_width, groups * 8)
            r.pos += nbytes
            take = min(groups * 8, count - n)
            out[n:n + take] = vals[:take]
            n += take
        else:
            run = header >> 1
            v = int.from_bytes(buf[r.pos:r.pos + width_bytes], "little")
            r.pos += width_bytes
            take = min(run, count - n)
            out[n:n + take] = v
            n += take
    if n < count:
        raise ValueError(f"corrupt parquet page: {n} of {count} levels decoded")
    return out


def _plain(buf: bytes, ptype: int, count: int) -> Column:
    if ptype == BYTE_ARRAY:
        out, pos = [], 0
        for _ in range(count):
            (n,) = struct.unpack_from("<I", buf, pos)
            out.append(bytes(buf[pos + 4:pos + 4 + n]))
            pos += 4 + n
        return out
    if ptype == BOOLEAN:
        return np.unpackbits(np.frombuffer(buf, np.uint8), count=count,
                             bitorder="little").astype(bool)
    return np.frombuffer(buf, _NUMPY[ptype], count=count)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def _footer(path: Path):
    """(the file's bytes, its FileMetaData struct)."""
    data = path.read_bytes()
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ValueError(f"{path}: not a parquet file (no PAR1 magic)")
    (n,) = struct.unpack_from("<I", data, len(data) - 8)
    return data, _Reader(data, len(data) - 8 - n).struct()


def _flat_columns(path: Path, schema: List[dict]) -> List[dict]:
    """The leaf columns of a flat schema; raises on any nested column."""
    root, fields = schema[0], schema[1:]
    if root.get(5, 0) != len(fields):
        nested = next(f[4].decode() for f in fields if f.get(5))
        raise ValueError(
            f"{path}: column {nested!r} is nested (a list, struct or map), which the "
            "PyTorch port's parquet reader does not read; store it flat (one value per "
            "cell) or read the file with pandas on a host that has it")
    for f in fields:
        if f.get(3, REQUIRED) == REPEATED:
            raise ValueError(f"{path}: column {f[4].decode()!r} is repeated (nested), "
                             "which the PyTorch port's parquet reader does not read")
    return fields


def _chunk_values(data: bytes, meta: dict, field: dict, n_rows: int, where: str):
    """(values, defined mask or None) of one column chunk."""
    ptype, codec = meta[1], meta[4]
    if ptype not in (BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY):
        raise ValueError(f"{where}: physical type {TYPE_NAMES[ptype]} is not read by the "
                         "PyTorch port")
    optional = field.get(3, REQUIRED) == OPTIONAL
    pos = min(meta[9], meta.get(11) or meta[9])  # the dictionary page comes first
    end = pos + meta[7]
    dictionary = None
    values: List[Column] = []
    defined: List[np.ndarray] = []
    got = 0
    while got < meta[5] and pos < end:
        r = _Reader(data, pos)
        head = r.struct()
        body = data[r.pos:r.pos + head[3]]
        pos = r.pos + head[3]
        ptype_page = head[1]
        if ptype_page == DICTIONARY_PAGE:
            dh = head[7]
            raw = _decompress(body, codec, where)
            dictionary = _plain(raw, ptype, dh[1])
            continue
        if ptype_page == DATA_PAGE:
            dh = head[5]
            n, enc = dh[1], dh[2]
            raw = _decompress(body, codec, where)
            p = 0
            if optional:
                (ln,) = struct.unpack_from("<I", raw, 0)
                levels = rle_hybrid(raw, 4, 4 + ln, 1, n)
                p = 4 + ln
        elif ptype_page == DATA_PAGE_V2:
            dh = head[8]
            n, enc = dh[1], dh[4]
            dl, rl = dh.get(5, 0), dh.get(6, 0)
            levels = rle_hybrid(body, rl, rl + dl, 1, n) if optional else None
            vals = body[rl + dl:]
            raw = _decompress(vals, codec, where) if dh.get(7, True) else vals
            p = 0
        else:
            continue  # index pages and unknown page types carry no values
        mask = levels.astype(bool) if optional else None
        n_def = int(mask.sum()) if optional else n
        if enc == PLAIN:
            vals = _plain(raw[p:], ptype, n_def)
        elif enc in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            if dictionary is None:
                raise ValueError(f"{where}: dictionary-encoded page without a dictionary")
            bw = raw[p]
            idx = rle_hybrid(raw, p + 1, len(raw), bw, n_def)
            vals = ([dictionary[i] for i in idx] if isinstance(dictionary, list)
                    else dictionary[idx])
        elif enc == RLE and ptype == BOOLEAN:
            (ln,) = struct.unpack_from("<I", raw, p)
            vals = rle_hybrid(raw, p + 4, p + 4 + ln, 1, n_def).astype(bool)
        else:
            raise ValueError(f"{where}: the {ENCODING_NAMES.get(enc, enc)} encoding is not "
                             f"read by the PyTorch port's parquet reader; {_REWRITE}")
        values.append(vals)
        if optional:
            defined.append(mask)
        got += n
    if got != n_rows:
        raise ValueError(f"{where}: {got} values for {n_rows} rows")
    if ptype == BYTE_ARRAY:
        flat = [v for part in values for v in part]
    else:
        flat = np.concatenate(values) if values else np.zeros(0, _NUMPY.get(ptype, bool))
    return flat, (np.concatenate(defined) if optional else None)


def _assemble(vals, mask, field: dict) -> Column:
    """A column as pandas gives it: text as a list of str (None for null),
    numbers as an array (NaN for null; ints with nulls become float64),
    booleans with nulls as a list of bool or None."""
    ptype = field[1]
    text = ptype == BYTE_ARRAY
    if text:
        utf8 = field.get(6) == UTF8 or 1 in field.get(10, {})
        vals = [v.decode("utf-8") for v in vals] if utf8 else vals
    if mask is None or mask.all():
        return list(vals) if text else np.asarray(vals)
    if text or ptype == BOOLEAN:
        it = iter(vals)
        return [next(it) if m else None for m in mask]
    out = np.full(len(mask), np.nan, np.float32 if ptype == FLOAT else np.float64)
    out[mask] = vals
    return out


def read_parquet(path, columns: Optional[Sequence[str]] = None) -> Dict[str, Column]:
    """The flat columns of a parquet file (all, or ``columns`` in that
    order) as ``{name: list | np.ndarray}``."""
    path = Path(path)
    data, meta = _footer(path)
    fields = _flat_columns(path, meta[2])
    names = [f[4].decode() for f in fields]
    want = list(columns) if columns is not None else names
    missing = [c for c in want if c not in names]
    if missing:
        raise KeyError(f"{path}: no column {missing} (columns: {names})")
    parts: Dict[str, list] = {c: [] for c in want}
    for rg in meta.get(4, []):
        for chunk, field, name in zip(rg[1], fields, names):
            if name not in parts:
                continue
            if chunk.get(1):
                raise ValueError(f"{path}: column {name!r} lives in another file "
                                 f"({chunk[1].decode()}), which the port does not read")
            where = f"{path}: column {name!r}"
            parts[name].append(_chunk_values(data, chunk[3], field, rg[3], where))
    out = {}
    for name in want:
        field = fields[names.index(name)]
        vals = [v for v, _ in parts[name]]
        masks = [m for _, m in parts[name]]
        if field[1] == BYTE_ARRAY:
            flat = [x for v in vals for x in v]
        else:
            flat = np.concatenate(vals) if vals else np.zeros(0, _NUMPY.get(field[1], bool))
        mask = None if not masks or masks[0] is None else np.concatenate(masks)
        out[name] = _assemble(flat, mask, field)
    return out


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _rle_runs(levels: np.ndarray) -> bytes:
    """Bit-width-1 levels as RLE runs only (a valid hybrid stream)."""
    w = _Writer()
    if len(levels):
        edges = np.flatnonzero(np.diff(levels)) + 1
        starts = np.concatenate([[0], edges])
        stops = np.concatenate([edges, [len(levels)]])
        for a, b in zip(starts, stops):
            w.varint(int(b - a) << 1)
            w.out.append(int(levels[a]))
    return bytes(w.out)


def _column_plain(name: str, values) -> tuple:
    """(physical type, converted type, PLAIN bytes of the defined values,
    defined mask)."""
    if isinstance(values, np.ndarray) and values.dtype.kind in "iuf":
        arr = values
        kind = arr.dtype.kind
        if kind == "f":
            ptype = FLOAT if arr.dtype == np.float32 else DOUBLE
        else:
            ptype = INT32 if arr.dtype.itemsize <= 4 and kind == "i" else INT64
        return ptype, None, arr.astype(_NUMPY[ptype]).tobytes(), np.ones(len(arr), bool)
    values = list(values)
    if values and all(isinstance(v, (int, np.integer)) and not isinstance(v, bool)
                      for v in values):
        return _column_plain(name, np.asarray(values, np.int64))
    if values and all(isinstance(v, (float, np.floating)) for v in values):
        return _column_plain(name, np.asarray(values, np.float64))
    if not all(v is None or isinstance(v, (str, bytes)) for v in values):
        raise ValueError(f"column {name!r}: write_parquet takes text, integer or float "
                         "columns")
    mask = np.array([v is not None for v in values], bool)
    out = bytearray()
    for v in values:
        if v is not None:
            b = v.encode("utf-8") if isinstance(v, str) else v
            out += struct.pack("<I", len(b)) + b
    return BYTE_ARRAY, UTF8, bytes(out), mask


def write_parquet(path, columns: Dict[str, Column], compression: Optional[str] = "gzip") -> None:
    """Write ``columns`` (equal lengths) as one row group of optional flat
    columns, one PLAIN page each, compressed with ``compression`` ("gzip",
    or None / "none" for none)."""
    comp = (compression or "none").lower()
    if comp not in ("gzip", "none", "uncompressed"):
        raise ValueError(f"write_parquet compresses with 'gzip' or none, not {compression!r}")
    codec = GZIP if comp == "gzip" else UNCOMPRESSED
    lengths = {len(v) for v in columns.values()}
    if len(lengths) > 1:
        raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
    n = lengths.pop() if lengths else 0
    body = bytearray(MAGIC)
    schema = [[(4, "bin", "schema"), (5, "i32", len(columns))]]
    chunks, total = [], 0
    for name, values in columns.items():
        ptype, conv, plain, mask = _column_plain(name, values)
        levels = _rle_runs(mask.astype(np.uint8))
        raw = struct.pack("<I", len(levels)) + levels + plain
        page = gzip.compress(raw, mtime=0) if codec == GZIP else raw
        head = _Writer()
        head.struct([(1, "i32", DATA_PAGE), (2, "i32", len(raw)), (3, "i32", len(page)),
                     (5, "struct", [(1, "i32", n), (2, "i32", PLAIN), (3, "i32", RLE),
                                    (4, "i32", RLE)])])
        offset = len(body)
        body += head.out + page
        size_c = len(head.out) + len(page)
        size_u = len(head.out) + len(raw)
        total += size_u
        schema.append([(1, "i32", ptype), (3, "i32", OPTIONAL), (4, "bin", name),
                       (6, "i32", conv),
                       (10, "struct", [(1, "struct", [])] if conv == UTF8 else None)])
        chunks.append([(2, "i64", offset),
                       (3, "struct", [(1, "i32", ptype), (2, "list:i32", [PLAIN, RLE]),
                                      (3, "list:bin", [name]), (4, "i32", codec),
                                      (5, "i64", n), (6, "i64", size_u), (7, "i64", size_c),
                                      (9, "i64", offset)])])
    meta = _Writer()
    meta.struct([(1, "i32", 1), (2, "list:struct", schema), (3, "i64", n),
                 (4, "list:struct", [[(1, "list:struct", chunks), (2, "i64", total),
                                      (3, "i64", n)]]),
                 (6, "bin", "plantcaduceus_tpu_torch")])
    body += meta.out + struct.pack("<I", len(meta.out)) + MAGIC
    Path(path).write_bytes(bytes(body))
