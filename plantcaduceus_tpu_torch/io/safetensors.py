"""Safetensors files, read and written without the ``safetensors`` package.

The released checkpoints (``model.safetensors``, or shards with
``model.safetensors.index.json``) and PEFT adapters
(``adapter_model.safetensors``) are safetensors files, which the JAX package
reads with the ``safetensors`` package. The GPU hosts lack it, so the port
carries this reader and writer, in numpy and the standard library.

A file is an 8-byte little-endian header length, a JSON header naming each
tensor's ``dtype``, ``shape`` and ``data_offsets`` (begin, end) into the
data that follows (an optional ``__metadata__`` maps strings to strings),
then the raw little-endian tensor bytes, contiguous and in offset order.

:func:`load_file` reads through ``np.memmap`` and returns numpy arrays:
F64, F32 and F16 as themselves, BF16 widened to float32 exactly (a 16-bit
shift of its bits), I64, I32, I16, I8, U8 and BOOL. A header that breaks
the format (offsets not contiguous or outside the file, a span that is not
the shape's size, a header of 100 MB or more, an unknown dtype) raises a
``ValueError`` that names it. :func:`save_file` writes numpy arrays, or
torch tensors (a bfloat16 tensor as BF16), padding the header with spaces
to a multiple of 8 bytes as the package does.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Dict, Mapping

import numpy as np

MAX_HEADER = 100_000_000
INDEX_NAME = "model.safetensors.index.json"

# dtype name -> numpy dtype of the stored bytes (BF16: its raw bits)
_STORED = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "BF16": "<u2", "I64": "<i8",
           "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}
_NAME = {np.dtype(v): k for k, v in _STORED.items() if k != "BF16"}


def _widen_bf16(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bits as float32: the same value, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _read_header(path) -> tuple:
    """(the header dict without ``__metadata__``, the offset of the data)
    of a safetensors file, validated."""
    path = Path(path)
    size = path.stat().st_size
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
        (n,) = struct.unpack("<Q", head)
        if n >= MAX_HEADER:
            raise ValueError(f"{path}: safetensors header of {n} bytes (the format's limit "
                             f"is {MAX_HEADER})")
        if 8 + n > size:
            raise ValueError(f"{path}: safetensors header of {n} bytes runs past the end of "
                             f"the file ({size} bytes)")
        raw = f.read(n)
    try:
        header = json.loads(raw.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise ValueError(f"{path}: safetensors header is not JSON: {e}") from None
    if not isinstance(header, dict):
        raise ValueError(f"{path}: safetensors header is not a JSON object")
    meta = header.pop("__metadata__", None)
    if meta is not None and not (isinstance(meta, dict) and
                                 all(isinstance(v, str) for v in meta.values())):
        raise ValueError(f"{path}: safetensors __metadata__ must map strings to strings")
    start = 8 + n
    spans = []
    for name, info in header.items():
        try:
            dtype, shape, (begin, end) = info["dtype"], info["shape"], info["data_offsets"]
        except (TypeError, KeyError, ValueError):
            raise ValueError(f"{path}: tensor {name!r} lacks dtype, shape or a pair of "
                             "data_offsets") from None
        if dtype not in _STORED:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dtype!r}, which the port's "
                             f"safetensors reader does not read ({', '.join(_STORED)})")
        if not (isinstance(shape, list) and all(isinstance(d, int) and d >= 0 for d in shape)):
            raise ValueError(f"{path}: tensor {name!r} has shape {shape!r}")
        want = int(np.prod(shape, dtype=np.int64)) * np.dtype(_STORED[dtype]).itemsize
        if not (isinstance(begin, int) and isinstance(end, int)) or end - begin != want:
            raise ValueError(f"{path}: tensor {name!r} spans [{begin}, {end}), not the "
                             f"{want} bytes of {dtype} {shape}")
        spans.append((begin, end, name))
    spans.sort()
    pos = 0
    for begin, end, name in spans:
        if begin != pos:
            raise ValueError(f"{path}: tensor {name!r} starts at {begin}, not at {pos}: the "
                             "data offsets must be contiguous")
        pos = end
    if start + pos != size:
        raise ValueError(f"{path}: the tensors end at byte {start + pos} of a "
                         f"{size}-byte file")
    return header, start


def load_file(path) -> Dict[str, np.ndarray]:
    """Every tensor of a safetensors file, as numpy arrays in header order
    (BF16 widened to float32). The arrays are views of a copy-on-write
    ``np.memmap`` of the file: writable, and a write never reaches the file."""
    header, start = _read_header(path)
    empty = all(info["data_offsets"][1] == 0 for info in header.values())
    data = (np.zeros(0, np.uint8) if empty  # np.memmap refuses a zero-length map
            else np.memmap(path, dtype=np.uint8, mode="c", offset=start))
    out = {}
    for name, info in header.items():
        begin, end = info["data_offsets"]
        arr = data[begin:end].view(_STORED[info["dtype"]]).reshape(info["shape"])
        out[name] = _widen_bf16(arr) if info["dtype"] == "BF16" else arr
    return out


def _stored(name: str, value) -> tuple:
    """(dtype name, shape, little-endian bytes) of a numpy array or tensor."""
    if hasattr(value, "detach"):  # a torch tensor
        t = value.detach().cpu().contiguous()
        if str(t.dtype) == "torch.bfloat16":
            import torch

            return "BF16", list(t.shape), t.view(torch.int16).numpy().astype("<i2").tobytes()
        value = t.numpy()
    arr = np.asarray(value)
    kind = _NAME.get(arr.dtype.newbyteorder("<") if arr.dtype.byteorder == ">" else arr.dtype)
    if kind is None:
        raise ValueError(f"tensor {name!r}: dtype {arr.dtype} has no safetensors name the "
                         f"port writes ({', '.join(_STORED)})")
    return kind, list(arr.shape), np.ascontiguousarray(arr, _STORED[kind]).tobytes()


def save_file(tensors: Mapping[str, object], path) -> None:
    """Write ``tensors`` (numpy arrays or torch tensors) as a safetensors
    file, in the mapping's order, the header padded with spaces to a
    multiple of 8 bytes."""
    header: Dict[str, object] = {}
    blobs, pos = [], 0
    for name, value in tensors.items():
        kind, shape, blob = _stored(name, value)
        header[name] = {"dtype": kind, "shape": shape, "data_offsets": [pos, pos + len(blob)]}
        blobs.append(blob)
        pos += len(blob)
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for blob in blobs:
            f.write(blob)


def save_sharded(tensors: Mapping[str, object], directory, n_shards: int) -> None:
    """Write ``tensors`` as ``n_shards`` files ``model-0000k-of-0000n
    .safetensors`` (the mapping's order cut into runs of near-equal bytes)
    and ``model.safetensors.index.json``, as ``save_pretrained`` lays out a
    sharded checkpoint."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    names = list(tensors)
    if not 1 <= n_shards <= max(len(names), 1):
        raise ValueError(f"{n_shards} shards for {len(names)} tensors")
    sizes = np.array([v.numel() * v.element_size() if hasattr(v, "element_size")
                      else np.asarray(v).nbytes for v in tensors.values()], np.int64)
    total = int(sizes.sum())
    # shard i takes the tensors whose bytes start in its share of the total
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    which = np.minimum(starts * n_shards // max(total, 1), n_shards - 1)
    weight_map = {}
    for i in range(n_shards):
        fname = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        part = {k: tensors[k] for k, w in zip(names, which) if w == i}
        save_file(part, directory / fname)
        weight_map.update({k: fname for k in part})
    (directory / INDEX_NAME).write_text(json.dumps(
        {"metadata": {"total_size": total}, "weight_map": weight_map}, indent=2))


def load_dir(directory) -> Dict[str, np.ndarray]:
    """Every tensor of every ``*.safetensors`` file in ``directory``, merged
    in sorted file order as the JAX package merges them: a tensor in two
    files takes the later file's value, and the index file is not read."""
    files = sorted(Path(directory).glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no *.safetensors under {directory}")
    out: Dict[str, np.ndarray] = {}
    for f in files:
        out.update(load_file(f))
    return out
