"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each build unit, a source and the macros it is compiled with, compiles
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ctypes. A kernel's variants can be units of their
own built from its source (K2's ``fuse_in``, K1's ``combine``), so that
they compile beside it rather than after it. Libraries land in
``build/kernels/`` at the repository root, named by a hash of the sources
and flags, so an edited kernel is rebuilt and an unchanged one is reused.
All units compile in parallel, one ``nvcc`` each. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
# unit -> (source under csrc/, macros)
UNITS = {"scan_fwd": ("scan_fwd", ()), "scan_fwd_combine": ("scan_fwd", ("PC_SCAN_COMBINE",)),
         "mixer_fwd": ("mixer_fwd", ()), "mixer_fwd_x": ("mixer_fwd", ("PC_MIXER_FUSE_IN",)),
         "scan_bwd": ("scan_bwd", ()), "ssd_fwd": ("ssd_fwd", ()),
         "mixer2_fwd": ("mixer2_fwd", ()), "ssd_bwd": ("ssd_bwd", ()),
         "attn_fwd": ("attn_fwd", ()), "attn_bwd": ("attn_bwd", ())}
SOURCES = tuple(UNITS)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: Dict[str, ctypes.CDLL] = {}
ptxas_reports: Dict[str, str] = {}
build_seconds: Dict[str, float] = {}  # each source's nvcc, from the start of the build


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in CUDA_HOME, "
                       "default /usr/local/cuda): the CUDA kernels cannot be built")


def _command_flags(name: str):
    return NVCC_FLAGS + [f"-D{m}" for m in UNITS[name][1]]


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{UNITS[name][0]}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(_command_flags(name)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, Path]:
    """Compile every missing library (``names``: build units), all ``nvcc``
    processes started together. Raises with the compiler's output if one
    fails."""
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, p in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *_command_flags(n), "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{UNITS[n][0]}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True), tmp)

    def wait(n, proc):
        ptxas_reports[n] = proc.communicate()[0]
        build_seconds[n] = time.perf_counter() - t0

    waits = [threading.Thread(target=wait, args=(n, proc)) for n, (proc, _) in procs.items()]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    errors = []
    for n, (proc, tmp) in procs.items():
        out = ptxas_reports[n]
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {n} ({UNITS[n][0]}.cu, rc {proc.returncode}):"
                          f"\n{out}")
        else:
            os.replace(tmp, todo[n])  # atomic: a reader never sees half a file
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of build unit ``name``, built at first use."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all((name,))[name]))
        lib.pc_error_string.restype = ctypes.c_char_p
        lib.pc_error_string.argtypes = [ctypes.c_int]
        _libs[name] = lib
    return lib


def bind(name: str, fn: str, argtypes) -> ctypes.CDLL:
    """The library of build unit ``name`` with its entry point ``fn`` typed:
    ``argtypes`` in, a CUDA error code out."""
    lib = load(name)
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.restype = ctypes.c_int
        f.argtypes = argtypes
    return lib


def require(cond: bool, what: str, msg: str) -> None:
    """A wrapper's input check: raise ``ValueError`` on what the kernel
    does not take."""
    if not cond:
        raise ValueError(f"{what}: {msg}")


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (its
    ``cudaGetLastError()`` right after the launch)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} "
                           f"({lib.pc_error_string(rc).decode()}) at launch")
