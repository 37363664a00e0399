"""Parquet tables, read and written without pandas or pyarrow.

The JAX package reads its parquet tables (pre-training sources and shards,
the PlantCAD2 evaluation tables, tokenized fine-tuning data) with pandas,
and ``convert_to_shards`` and ``lora_fine_tune tokenize`` write them with
pandas, zstd-compressed. The GPU hosts carry neither pandas nor pyarrow,
so this module is the port's own reader and writer, in Python and numpy.

Reader (:func:`read_parquet`):

* physical types BOOLEAN, INT32, INT64, FLOAT, DOUBLE and BYTE_ARRAY
  (text), ``required`` or ``optional``;
* flat columns, and one-level lists of those types: pyarrow's 3-level LIST
  layout, the legacy 2-level one and a bare ``repeated`` field; a list cell
  comes back as a 1-D numpy array, as pandas gives it (a null list as None,
  an empty list as an empty array, a null element as NaN in a float64
  array, or None in an object array for text and booleans);
* PLAIN, PLAIN_DICTIONARY and RLE_DICTIONARY values (a dictionary page and
  then PLAIN pages in one chunk, as pyarrow writes once its dictionary
  overflows), RLE-encoded booleans, RLE/bit-packed hybrid levels;
* DATA_PAGE and DATA_PAGE_V2, any number of row groups;
* codecs UNCOMPRESSED, GZIP, SNAPPY (:func:`snappy_decompress`) and ZSTD
  (``io.zstd``).

LZ4, BROTLI and LZO pages, the DELTA encodings, INT96 and fixed-length
columns, structs, maps and lists of lists or of structs raise a
``ValueError`` that names the codec, encoding or column. The footer and page
headers are Thrift compact structs, read by a parser that skips the fields
it does not know.

Writer (:func:`write_parquet`): flat text, integer and float columns
(``None`` in a text column is a null) and list columns of integers or
floats (pyarrow's 3-level layout; ``None`` is a null list), one row group,
one PLAIN page per column, GZIP (default) or uncompressed; pyarrow and
pandas read its files.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from plantcaduceus_tpu_torch.io import zstd

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
UNCOMPRESSED, SNAPPY, GZIP, ZSTD = 0, 1, 2, 6
CODEC_NAMES = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI", 5: "LZ4",
               6: "ZSTD", 7: "LZ4_RAW"}
DATA_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = 0, 2, 3
UTF8, MAP, MAP_KEY_VALUE, LIST = 0, 1, 2, 3  # ConvertedType
_NUMPY = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}
_REWRITE = ("re-write it with compression='gzip', 'snappy' or 'zstd' (pandas: "
            "df.to_parquet(path, compression='zstd')), or convert the source with "
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


def _decompress(data: bytes, codec: int, where: str, size: int) -> bytes:
    """A page's body, ``size`` bytes once decompressed."""
    if codec == UNCOMPRESSED:
        return data
    if codec == SNAPPY:
        return snappy_decompress(data)
    if codec == GZIP:
        return zlib.decompressobj(wbits=47).decompress(data)  # gzip or zlib header
    if codec == ZSTD:
        try:
            return zstd.decompress(data, max_output=size)
        except ValueError as e:
            raise ValueError(f"{where}: {e}") from None
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


class _Leaf:
    """A readable top-level column: its leaf's schema element and levels.

    ``path`` holds the repetition types from the top field down to the
    leaf. A flat column has no repeated node; a list column has one, and
    the definition level says how far down a cell's entry is defined:
    below ``d_null`` the row is null, below ``d_rep`` its list is empty,
    below ``max_def`` the element is null."""

    def __init__(self, leaf: dict, path: List[int]):
        self.leaf = leaf
        self.max_def = sum(r != REQUIRED for r in path)
        self.max_rep = sum(r == REPEATED for r in path)
        self.is_list = self.max_rep == 1
        k = path.index(REPEATED) if self.is_list else len(path)
        self.d_null = sum(r != REQUIRED for r in path[:k])
        self.d_rep = self.d_null + 1


def _schema_tree(schema: List[dict]):
    """The flattened schema as (element, children) trees under the root."""
    pos = 1

    def node():
        nonlocal pos
        el = schema[pos]
        pos += 1
        return el, [node() for _ in range(el.get(5, 0))]

    return [node() for _ in range(schema[0].get(5, 0))]


def _n_leaves(tree) -> int:
    el, kids = tree
    return sum(_n_leaves(k) for k in kids) if kids else 1


def _column(tree) -> Union[_Leaf, str]:
    """A top-level field as a :class:`_Leaf`, or what it is when the reader
    does not read it ("a struct", "a map", "a list of lists", ...)."""
    el, kids = tree
    name = el[4].decode()
    rep = el.get(3, REQUIRED)
    if not kids:
        return _Leaf(el, [rep])
    logical = el.get(10, {})
    conv = el.get(6)
    if conv in (MAP, MAP_KEY_VALUE) or 2 in logical:
        return "a map"
    if not (conv == LIST or 3 in logical) or rep == REPEATED:
        return "a struct"
    if len(kids) != 1 or kids[0][0].get(3) != REPEATED:
        return "a list whose layout the port does not read"
    mid, mid_kids = kids[0]
    if not mid_kids:  # 2-level: the repeated field is the element
        return _Leaf(mid, [rep, REPEATED])
    mid_name = mid[4].decode()
    if len(mid_kids) != 1 or mid_name == "array" or mid_name == name + "_tuple":
        return "a list of structs"
    (elem, elem_kids), = mid_kids
    if elem_kids:
        inner = elem.get(6) == LIST or 3 in elem.get(10, {})
        return "a list of lists" if inner else "a list of structs"
    if elem.get(3) == REPEATED:
        return "a list of lists"
    return _Leaf(elem, [rep, REPEATED, elem.get(3, REQUIRED)])


def _levels(buf: bytes, pos: int, end: int, max_level: int, n: int) -> Optional[np.ndarray]:
    return rle_hybrid(buf, pos, end, max_level.bit_length(), n) if max_level else None


def _chunk_values(data: bytes, meta: dict, col: _Leaf, n_rows: int, where: str):
    """(defined values, definition levels or None, repetition levels or
    None) of one column chunk."""
    ptype, codec = meta[1], meta[4]
    if ptype not in (BOOLEAN, INT32, INT64, FLOAT, DOUBLE, BYTE_ARRAY):
        raise ValueError(f"{where}: physical type {TYPE_NAMES[ptype]} is not read by the "
                         "PyTorch port")
    pos = min(meta[9], meta.get(11) or meta[9])  # the dictionary page comes first
    end = pos + meta[7]
    dictionary = None
    values: List[Column] = []
    defs: List[np.ndarray] = []
    reps: List[np.ndarray] = []
    got = 0
    while got < meta[5] and pos < end:
        r = _Reader(data, pos)
        head = r.struct()
        body = data[r.pos:r.pos + head[3]]
        pos = r.pos + head[3]
        ptype_page = head[1]
        if ptype_page == DICTIONARY_PAGE:
            dh = head[7]
            raw = _decompress(body, codec, where, head[2])
            dictionary = _plain(raw, ptype, dh[1])
            continue
        if ptype_page == DATA_PAGE:
            dh = head[5]
            n, enc = dh[1], dh[2]
            raw = _decompress(body, codec, where, head[2])
            p = 0
            rep = dfn = None
            if col.max_rep:
                (ln,) = struct.unpack_from("<I", raw, p)
                rep = _levels(raw, p + 4, p + 4 + ln, col.max_rep, n)
                p += 4 + ln
            if col.max_def:
                (ln,) = struct.unpack_from("<I", raw, p)
                dfn = _levels(raw, p + 4, p + 4 + ln, col.max_def, n)
                p += 4 + ln
        elif ptype_page == DATA_PAGE_V2:
            dh = head[8]
            n, enc = dh[1], dh[4]
            dl, rl = dh.get(5, 0), dh.get(6, 0)
            rep = _levels(body, 0, rl, col.max_rep, n)
            dfn = _levels(body, rl, rl + dl, col.max_def, n)
            vals = body[rl + dl:]
            raw = (_decompress(vals, codec, where, head[2] - rl - dl) if dh.get(7, True)
                   else vals)
            p = 0
        else:
            continue  # index pages and unknown page types carry no values
        n_def = n if dfn is None else int((dfn == col.max_def).sum())
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
        if dfn is not None:
            defs.append(dfn)
        if rep is not None:
            reps.append(rep)
        got += n
    rows = int(sum((r == 0).sum() for r in reps)) if col.max_rep else got
    if rows != n_rows:
        raise ValueError(f"{where}: {rows} rows for the row group's {n_rows}")
    if ptype == BYTE_ARRAY:
        flat = [v for part in values for v in part]
    else:
        flat = np.concatenate(values) if values else np.zeros(0, _NUMPY.get(ptype, bool))
    return (flat, np.concatenate(defs) if col.max_def else None,
            np.concatenate(reps) if col.max_rep else None)


def _with_nulls(vals, mask: Optional[np.ndarray], ptype: int):
    """Values with None (text, booleans) or NaN (numbers; integers become
    float64) where ``mask`` is False, as pandas fills a nullable column."""
    if mask is None or mask.all():
        return list(vals) if ptype == BYTE_ARRAY else np.asarray(vals)
    if ptype in (BYTE_ARRAY, BOOLEAN):
        it = iter(vals)
        return [next(it) if m else None for m in mask]
    out = np.full(len(mask), np.nan, np.float32 if ptype == FLOAT else np.float64)
    out[mask] = vals
    return out


def _assemble(vals, dfn, rep, col: _Leaf) -> Column:
    """A column as pandas gives it: text as a list of str (None for null),
    numbers as an array (NaN for null; ints with nulls become float64),
    booleans with nulls as a list of bool or None; a list column as a list
    of 1-D arrays (None for a null list)."""
    ptype = col.leaf[1]
    if ptype == BYTE_ARRAY:
        utf8 = col.leaf.get(6) == UTF8 or 1 in col.leaf.get(10, {})
        vals = [v.decode("utf-8") for v in vals] if utf8 else vals
    if not col.is_list:
        return _with_nulls(vals, None if dfn is None else dfn == col.max_def, ptype)
    if dfn is None:  # a bare repeated field of required values
        dfn = np.full(len(rep), col.max_def, np.int64)
    row = np.cumsum(rep == 0) - 1  # the row of every entry
    n_rows = int(row[-1]) + 1 if len(row) else 0
    has_elem = dfn >= col.d_rep
    elems = _with_nulls(vals, dfn[has_elem] == col.max_def, ptype)
    if isinstance(elems, list):  # text or booleans with nulls: an object array
        elems, items = np.empty(len(elems), object), elems
        elems[:] = items
    counts = np.bincount(row[has_elem], minlength=n_rows)
    cells = np.split(elems, np.cumsum(counts)[:-1]) if n_rows else []
    first = np.flatnonzero(rep == 0)
    null = dfn[first] < col.d_null
    return [None if z else c for c, z in zip(cells, null)]


def read_parquet(path, columns: Optional[Sequence[str]] = None) -> Dict[str, Column]:
    """The columns of a parquet file (all, or ``columns`` in that order) as
    ``{name: list | np.ndarray}``."""
    path = Path(path)
    data, meta = _footer(path)
    trees = _schema_tree(meta[2])
    names = [t[0][4].decode() for t in trees]
    want = list(columns) if columns is not None else names
    missing = [c for c in want if c not in names]
    if missing:
        raise KeyError(f"{path}: no column {missing} (columns: {names})")
    first_leaf = np.concatenate([[0], np.cumsum([_n_leaves(t) for t in trees])]).tolist()
    cols = {}
    for name in want:
        i = names.index(name)
        col = _column(trees[i])
        if isinstance(col, str):
            raise ValueError(
                f"{path}: column {name!r} is {col}, which the PyTorch port's parquet reader "
                "does not read (it reads flat columns and lists of numbers or text); store "
                "it flat or as such a list")
        cols[name] = (first_leaf[i], col)
    parts: Dict[str, list] = {c: [] for c in want}
    for rg in meta.get(4, []):
        for name, (k, col) in cols.items():
            chunk = rg[1][k]
            if chunk.get(1):
                raise ValueError(f"{path}: column {name!r} lives in another file "
                                 f"({chunk[1].decode()}), which the port does not read")
            where = f"{path}: column {name!r}"
            parts[name].append(_chunk_values(data, chunk[3], col, rg[3], where))
    out = {}
    for name, (_, col) in cols.items():
        vals = [v for v, _, _ in parts[name]]
        if col.leaf[1] == BYTE_ARRAY:
            flat = [x for v in vals for x in v]
        else:
            flat = (np.concatenate(vals) if vals
                    else np.zeros(0, _NUMPY.get(col.leaf[1], bool)))
        levels = [None if not has else
                  np.concatenate([p[j] for p in parts[name]] or [np.zeros(0, np.int64)])
                  for j, has in ((1, col.max_def), (2, col.max_rep))]
        out[name] = _assemble(flat, *levels, col)
    return out


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _rle_runs(levels: np.ndarray) -> bytes:
    """Levels of up to 8 bits as RLE runs only (a valid hybrid stream),
    after their 4-byte length, as a v1 data page carries them."""
    w = _Writer()
    if len(levels):
        edges = np.flatnonzero(np.diff(levels)) + 1
        starts = np.concatenate([[0], edges])
        stops = np.concatenate([edges, [len(levels)]])
        for a, b in zip(starts, stops):
            w.varint(int(b - a) << 1)
            w.out.append(int(levels[a]))
    return struct.pack("<I", len(w.out)) + bytes(w.out)


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
                         "columns, or lists of integers or floats")
    mask = np.array([v is not None for v in values], bool)
    out = bytearray()
    for v in values:
        if v is not None:
            b = v.encode("utf-8") if isinstance(v, str) else v
            out += struct.pack("<I", len(b)) + b
    return BYTE_ARRAY, UTF8, bytes(out), mask


def _is_list_column(values) -> bool:
    if isinstance(values, np.ndarray):
        return values.ndim == 2
    return any(isinstance(v, (list, tuple, np.ndarray)) for v in values)


def _list_page(name: str, values) -> tuple:
    """A list column (a 2-D array, or a sequence of 1-D sequences or None)
    in pyarrow's 3-level layout: (schema elements, path in the schema,
    physical type, page bytes, level entries)."""
    if isinstance(values, np.ndarray):
        cells = list(values)
    else:
        cells = [None if v is None else np.asarray(v) for v in values]
    if any(c is not None and c.ndim != 1 for c in cells):
        raise ValueError(f"column {name!r}: a list column's cells must be 1-D")
    present = [c for c in cells if c is not None and c.size]  # ``[]`` is float64 to numpy
    flat = np.concatenate(present) if present else np.zeros(0, np.int64)
    if flat.dtype.kind not in "iuf":
        raise ValueError(f"column {name!r}: write_parquet takes lists of integers or floats, "
                         f"not of {flat.dtype}")
    ptype, _, plain, _ = _column_plain(name, flat)
    lengths = np.array([-1 if c is None else len(c) for c in cells], np.int64)
    entries = np.maximum(lengths, 1)  # a null or empty list still takes one entry
    rep = np.ones(int(entries.sum()), np.uint8)
    rep[np.cumsum(entries) - entries] = 0
    row_def = np.where(lengths < 0, 0, np.where(lengths == 0, 1, 3))
    dfn = np.repeat(row_def, entries).astype(np.uint8)
    schema = [[(3, "i32", OPTIONAL), (4, "bin", name), (5, "i32", 1), (6, "i32", LIST),
               (10, "struct", [(3, "struct", [])])],
              [(3, "i32", REPEATED), (4, "bin", "list"), (5, "i32", 1)],
              [(1, "i32", ptype), (3, "i32", OPTIONAL), (4, "bin", "element")]]
    return (schema, [name, "list", "element"], ptype, _rle_runs(rep) + _rle_runs(dfn) + plain,
            len(rep))


def write_parquet(path, columns: Dict[str, Column], compression: Optional[str] = "gzip") -> None:
    """Write ``columns`` (equal lengths) as one row group of optional
    columns, one PLAIN page each, compressed with ``compression`` ("gzip",
    or None / "none" for none). A 2-D array, or a sequence of 1-D
    sequences (or None), is a list column."""
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
        if _is_list_column(values):
            elements, path_in_schema, ptype, raw, entries = _list_page(name, values)
        else:
            ptype, conv, plain, mask = _column_plain(name, values)
            raw = _rle_runs(mask.astype(np.uint8)) + plain
            elements = [[(1, "i32", ptype), (3, "i32", OPTIONAL), (4, "bin", name),
                         (6, "i32", conv),
                         (10, "struct", [(1, "struct", [])] if conv == UTF8 else None)]]
            path_in_schema, entries = [name], n
        page = gzip.compress(raw, mtime=0) if codec == GZIP else raw
        head = _Writer()
        head.struct([(1, "i32", DATA_PAGE), (2, "i32", len(raw)), (3, "i32", len(page)),
                     (5, "struct", [(1, "i32", entries), (2, "i32", PLAIN), (3, "i32", RLE),
                                    (4, "i32", RLE)])])
        offset = len(body)
        body += head.out + page
        size_c = len(head.out) + len(page)
        size_u = len(head.out) + len(raw)
        total += size_u
        schema.extend(elements)
        chunks.append([(2, "i64", offset),
                       (3, "struct", [(1, "i32", ptype), (2, "list:i32", [PLAIN, RLE]),
                                      (3, "list:bin", path_in_schema), (4, "i32", codec),
                                      (5, "i64", entries), (6, "i64", size_u),
                                      (7, "i64", size_c), (9, "i64", offset)])])
    meta = _Writer()
    meta.struct([(1, "i32", 1), (2, "list:struct", schema), (3, "i64", n),
                 (4, "list:struct", [[(1, "list:struct", chunks), (2, "i64", total),
                                      (3, "i64", n)]]),
                 (6, "bin", "plantcaduceus_tpu_torch")])
    body += meta.out + struct.pack("<I", len(meta.out)) + MAGIC
    Path(path).write_bytes(bytes(body))
