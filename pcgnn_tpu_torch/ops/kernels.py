"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for Hopper (``sm_90a``) into its own shared library, loaded with ``ctypes``.
Libraries are built at first use into ``pcgnn_tpu_torch/build/`` (listed in
``.gitignore``), named by a hash of their source, so an edited source is
rebuilt and an unchanged one is reused.  ``build`` starts one ``nvcc`` per
source at once and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
# every kernel source of the package, by name (csrc/<name>.cu)
KERNELS = ("window_gather",)
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (not on PATH, not under CUDA_HOME or "
            "/usr/local/cuda): the CUDA kernels cannot be built")
    return path


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=KERNELS) -> dict[str, str]:
    """Compile every named kernel that is not built yet, all at once.
    Returns each compiled kernel's compiler report (``-Xptxas -v``:
    registers, shared memory, spills); raises if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
        os.close(fd)
        procs[name] = (tmp, subprocess.Popen(
            nvcc_command(nvcc, name, Path(tmp)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode == 0:
            os.replace(tmp, library_path(name))
        else:
            os.unlink(tmp)
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The named kernel's library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
