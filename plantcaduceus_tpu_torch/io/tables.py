"""Table files opened by their suffix, compressed or not.

The JAX package reads and writes its TSVs with pandas, which infers the
compression from the path's suffix (``pandas.io.common.infer_compression``).
The GPU hosts carry no pandas, so this is the port's copy of that rule for
the text tables of its CLIs:

* ``.gz`` (gzip), ``.bz2`` (bz2) and ``.xz`` (lzma): the stdlib modules,
  read and write;
* ``.zip``: reading opens the archive's single member and raises on none or
  several, as pandas does; writing stores one deflated member named after
  the path without its ``.zip`` suffix, as pandas names it;
* ``.zst`` needs a package the GPU hosts lack, and ``.tar``, ``.tar.gz``,
  ``.tar.bz2`` and ``.tar.xz`` are tar archives to pandas: both are refused
  with a ``ValueError`` that names the suffix;
* any other suffix: plain text.

Text is UTF-8 with ``newline=""``, as the ``csv`` module wants.
"""

from __future__ import annotations

import bz2
import contextlib
import gzip
import io
import lzma
import zipfile
from pathlib import Path
from typing import Iterator, Optional, TextIO

# pandas.io.common.extension_to_compression, in its order: the first suffix
# the lower-cased path ends with decides.
EXTENSION_TO_COMPRESSION = {
    ".tar": "tar", ".tar.gz": "tar", ".tar.bz2": "tar", ".tar.xz": "tar",
    ".gz": "gzip", ".bz2": "bz2", ".zip": "zip", ".xz": "xz", ".zst": "zstd",
}
_STREAMS = {None: open, "gzip": gzip.open, "bz2": bz2.open, "xz": lzma.open}
_REFUSED = {"tar": "a tar archive", "zstd": "zstandard compression, which needs a package"}


def suffix_of(path) -> Optional[str]:
    """The suffix of ``path`` that decides its compression, or None."""
    name = str(path).lower()
    return next((ext for ext in EXTENSION_TO_COMPRESSION if name.endswith(ext)), None)


def zip_member_name(path) -> str:
    """The member pandas writes into ``path``: its name without ``.zip``."""
    p = Path(path)
    return p.with_suffix("").name if p.suffix == ".zip" else p.name


@contextlib.contextmanager
def open_table(path, mode: str = "r") -> Iterator[TextIO]:
    """A text handle on ``path`` (``mode`` "r" or "w"), compressed as its
    suffix says."""
    if mode not in ("r", "w"):
        raise ValueError(f"mode must be 'r' or 'w', not {mode!r}")
    ext = suffix_of(path)
    method = EXTENSION_TO_COMPRESSION.get(ext)
    if method in _REFUSED:
        raise ValueError(f"{path}: a {ext!r} table is {_REFUSED[method]}; the PyTorch "
                         "port reads and writes plain, .gz, .bz2, .xz and .zip tables")
    if method != "zip":
        with _STREAMS[method](path, mode + "t", encoding="utf-8", newline="") as fh:
            yield fh
        return
    with zipfile.ZipFile(path, mode, compression=zipfile.ZIP_DEFLATED) as zf:
        if mode == "w":
            raw = zf.open(zip_member_name(path), "w")
        else:
            names = zf.namelist()
            if not names:
                raise ValueError(f"Zero files found in ZIP file {path}")
            if len(names) > 1:
                raise ValueError("Multiple files found in ZIP file. "
                                 f"Only one file per ZIP: {names}")
            raw = zf.open(names[0])
        with io.TextIOWrapper(raw, encoding="utf-8", newline="") as fh:
            yield fh
