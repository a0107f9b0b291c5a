"""The native graph core: a multi-threaded host CSR builder, bound with
ctypes.

Counterpart of ``pcgnn_tpu/native``.  ``csrc/graphcore.cpp`` (plain C ABI:
``gc_csr_capacity``, ``gc_build_csr``, ``gc_expand_rows``) builds a
deduplicated CSR from a COO edge list by counting rows and sorting each row
on every core, where the numpy version (``graph.csr.csr_arrays_plain``)
sorts one global key array on one.  Both give the same arrays.

The library is compiled with ``g++`` at first use into
``pcgnn_tpu_torch/build/`` (listed in ``.gitignore``), under a name holding
a digest of the source and the flags, through a temporary file that
``os.replace`` puts in place: processes that build at once each write their
own temporary file, and none can load a half-written library.  A build or
load failure is printed to stderr once; ``available()`` is then False and
``graph.csr`` builds with numpy.  ``CXX`` names another compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "graphcore.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-std=c++20", "-fPIC", "-pthread", "-Wall", "-Wextra",
             "-shared")
BUILD_TIMEOUT_S = 300

_lib: ctypes.CDLL | None = None
_path: str | None = None
_error: str | None = None


def compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join((compiler(),) + CXX_FLAGS).encode())
    return BUILD_DIR / f"graphcore-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    RuntimeError with the compiler's output if the build fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    cmd = [compiler(), *CXX_FLAGS, "-o", tmp, str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        if proc.returncode:
            raise RuntimeError(
                f"graph core build failed ({' '.join(cmd)} exited "
                f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as exc:
        raise RuntimeError(f"graph core build failed ({' '.join(cmd)}): "
                           f"{exc}") from exc
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.gc_csr_capacity.restype = ctypes.c_int64
    lib.gc_csr_capacity.argtypes = [ctypes.c_int64, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_int]
    lib.gc_build_csr.restype = ctypes.c_int64
    lib.gc_build_csr.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 i64p, i64p]
    lib.gc_expand_rows.restype = None
    lib.gc_expand_rows.argtypes = [i64p, ctypes.c_int64, ctypes.c_int, i64p]
    return lib


def _load() -> ctypes.CDLL | None:
    global _lib, _path, _error
    if _lib is None and _error is None:
        try:
            path = str(build())
            _lib = _bind(ctypes.CDLL(path))
            _path = path
        except (RuntimeError, OSError) as exc:
            _error = str(exc)
            print(f"pcgnn_tpu_torch.native: {_error}\nthe CSR builds fall "
                  f"back to numpy", file=sys.stderr)
    return _lib


def available() -> bool:
    """Whether the library is loaded (built first if needed)."""
    return _load() is not None


def load_error() -> str | None:
    """Why the library could not be loaded, or None."""
    _load()
    return _error


def loaded_path() -> str | None:
    """The loaded library's file, or None."""
    _load()
    return _path


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def csr_arrays(src, dst, num_nodes: int, *, symmetrize: bool = True,
               add_self_loops: bool = True, num_threads: int = 0):
    """(indptr [N+1], col [E]) int64 of the deduplicated CSR, rows sorted.
    ``col`` is a view of the capacity buffer.  Raises RuntimeError when
    the library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native graph core is unavailable: {_error}")
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if src.ndim != 1 or src.shape != dst.shape:
        raise ValueError(f"src and dst must be 1-D of one length, got "
                         f"{src.shape} and {dst.shape}")
    cap = lib.gc_csr_capacity(len(src), num_nodes, int(symmetrize),
                              int(add_self_loops))
    indptr = np.empty(num_nodes + 1, dtype=np.int64)
    col = np.empty(max(cap, 1), dtype=np.int64)
    e = lib.gc_build_csr(_ptr(src), _ptr(dst), len(src), num_nodes,
                         int(symmetrize), int(add_self_loops), num_threads,
                         _ptr(indptr), _ptr(col))
    if e < 0:
        raise ValueError(f"gc_build_csr refused its arguments "
                         f"(num_nodes={num_nodes}, edges={len(src)})")
    return indptr, col[:e]


def build_csr(src, dst, num_nodes: int, *, symmetrize: bool = True,
              add_self_loops: bool = True, num_threads: int = 0):
    """(indptr [N+1], col [E], row [E]) int64 arrays of the deduplicated
    CSR, rows sorted: ``pcgnn_tpu.native.build_csr``'s result.  Raises
    RuntimeError when the library is unavailable."""
    indptr, col = csr_arrays(src, dst, num_nodes, symmetrize=symmetrize,
                             add_self_loops=add_self_loops,
                             num_threads=num_threads)
    col = col.copy()
    row = np.empty(len(col), dtype=np.int64)
    _lib.gc_expand_rows(_ptr(indptr), num_nodes, num_threads, _ptr(row))
    return indptr, col, row
