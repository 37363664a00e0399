"""ctypes bindings for the native IO library (native/libpcio.so).

Accelerates FASTA loading and bulk window extraction for large genomes;
everything degrades gracefully to the pure-Python io.fasta implementation (a host I/O fallback)
when the shared library hasn't been built (``make -C native``) or the build
toolchain is absent. ``NativeFastaIndex`` mirrors the FastaIndex API used by
the scoring engine.
"""

from __future__ import annotations

import ctypes
import logging
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_REPO_ROOT = Path(__file__).resolve().parents[2]
_LIB_PATH = _REPO_ROOT / "native" / "libpcio.so"
_lib = None
_load_failed = False


def _try_build() -> bool:
    try:
        subprocess.run(["make", "-C", str(_REPO_ROOT / "native")],
                       check=True, capture_output=True, timeout=120)
        return _LIB_PATH.exists()
    except Exception as e:
        log.debug("native build failed: %s", e)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building on first use) libpcio, or None if unavailable."""
    global _lib, _load_failed
    if _lib is not None or _load_failed:
        return _lib
    if not _LIB_PATH.exists() and not _try_build():
        _load_failed = True
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError as e:
        log.warning("could not load %s: %s", _LIB_PATH, e)
        _load_failed = True
        return None
    lib.pcio_fasta_load.restype = ctypes.c_void_p
    lib.pcio_fasta_load.argtypes = [ctypes.c_char_p]
    lib.pcio_fasta_free.argtypes = [ctypes.c_void_p]
    lib.pcio_fasta_num_chroms.restype = ctypes.c_int64
    lib.pcio_fasta_num_chroms.argtypes = [ctypes.c_void_p]
    lib.pcio_fasta_chrom_name.restype = ctypes.c_int64
    lib.pcio_fasta_chrom_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
    lib.pcio_fasta_chrom_len.restype = ctypes.c_int64
    lib.pcio_fasta_chrom_len.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.pcio_extract_windows.restype = ctypes.c_int64
    lib.pcio_extract_windows.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_char_p]
    lib.pcio_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


class NativeFastaIndex:
    """C++-backed FASTA with bulk window extraction.

    Note: gz input is not handled natively — use io.fasta.FastaIndex for
    .gz files (the loader here raises)."""

    def __init__(self, path):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("libpcio unavailable; use io.fasta.FastaIndex")
        path = str(path)
        if path.endswith(".gz"):
            raise ValueError("native FASTA loader reads plain files only")
        self._lib = lib
        self._h = lib.pcio_fasta_load(path.encode())
        if not self._h:
            raise FileNotFoundError(path)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pcio_fasta_free(self._h)
            self._h = None

    def chrom_names(self):
        n = self._lib.pcio_fasta_num_chroms(self._h)
        out = []
        for i in range(n):
            m = self._lib.pcio_fasta_chrom_name(self._h, i, None, 0)
            buf = ctypes.create_string_buffer(m)
            self._lib.pcio_fasta_chrom_name(self._h, i, buf, m)
            out.append(buf.raw[:m].decode())
        return out

    def chrom_len(self, chrom: str) -> int:
        n = self._lib.pcio_fasta_chrom_len(self._h, chrom.encode())
        if n < 0:
            raise KeyError(chrom)
        return int(n)

    def windows(self, chrom: str, positions, window: int = 512,
                center_idx: int = 255) -> np.ndarray:
        """Bulk extraction: [n, window] uint8 array of chars ('A','C',...)."""
        pos = np.ascontiguousarray(positions, np.int64)
        out = np.empty((len(pos), window), np.uint8)
        r = self._lib.pcio_extract_windows(
            self._h, chrom.encode(),
            pos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(pos),
            window, center_idx,
            out.ctypes.data_as(ctypes.c_char_p))
        if r < 0:
            raise KeyError(chrom)
        return out

    def window(self, chrom: str, pos0: int, length: int = 512,
               center_idx: int = 255) -> str:
        return self.windows(chrom, [pos0], length, center_idx)[0].tobytes().decode()

    def evict(self, chrom: str) -> None:  # API parity; native keeps all
        pass


def open_fasta(path):
    """Best FASTA index available: native for plain files, Python otherwise."""
    from plantcaduceus_tpu_torch.io.fasta import FastaIndex

    p = str(path)
    if not p.endswith(".gz") and available():
        try:
            return NativeFastaIndex(p)
        except Exception as e:
            log.warning("native FASTA failed (%s); falling back to Python", e)
    return FastaIndex(path)
