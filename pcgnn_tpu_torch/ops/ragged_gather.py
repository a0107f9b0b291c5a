"""Ragged gather: ``out[b, i] = col[starts[b] + i]`` for ``i < d``.

Counterpart of ``pcgnn_tpu/ops/pallas/ragged_gather.py``.  It fetches
contiguous runs of a CSR column array (int32 neighbor ids) from arbitrary
element offsets (CSR ``indptr`` values); the hub lane (``ops.hub``) reads
every hub row's edge tail with it.  A position outside ``col`` yields
``fill``: the JAX package's plain path clips onto the CSR's N-valued
padding, so a caller passes ``fill = N`` and gets the same ids without
padding ``col`` for its widest read.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/ragged_gather.cu`` or raises; on a CPU tensor it takes the plain
PyTorch version, ``ragged_gather_plain``.  The wrapper reads nothing back
from the card: its checks use shapes and dtypes only, so a caller may launch
it once per hub chunk without a host stall.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pcgnn_tpu_torch.ops import kernels

# kernel launches in this process; the only writer is ``launch``
launches = 0

_INT32 = torch.iinfo(torch.int32)


def ragged_gather_plain(col: torch.Tensor, starts: torch.Tensor, d: int,
                        fill: int) -> torch.Tensor:
    """The plain version: one [B, d] advanced-indexing gather of clipped
    positions, ``fill`` where the position lies outside ``col``."""
    pos = starts.to(torch.int64)[:, None] + torch.arange(d, device=col.device)
    inside = (pos >= 0) & (pos < col.numel())
    return torch.where(inside, col[pos.clamp(0, col.numel() - 1)], fill)


def _bind(lib: ctypes.CDLL):
    fn = lib.ragged_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.ragged_gather_error_string.argtypes = [ctypes.c_int]
        lib.ragged_gather_error_string.restype = ctypes.c_char_p
    return fn


def ragged_gather(col: torch.Tensor, starts: torch.Tensor, d: int,
                  fill: int) -> torch.Tensor:
    """[B, d] int32 runs of the flat int32 ``col`` ([E]) at ``starts`` [B]
    (int32 or int64 element offsets, any alignment, any value: positions
    outside ``col`` give ``fill``)."""
    if col.dim() != 1 or starts.dim() != 1:
        raise ValueError(f"ragged_gather wants a flat col and [B] starts, "
                         f"got {tuple(col.shape)} and {tuple(starts.shape)}")
    if col.dtype != torch.int32:
        raise TypeError(f"ragged_gather col dtype {col.dtype} is not int32")
    if starts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"ragged_gather starts dtype {starts.dtype} is not "
                        f"int32 or int64")
    if col.numel() == 0:
        raise ValueError("ragged_gather: col is empty")
    if d < 0 or not _INT32.min <= fill <= _INT32.max:
        raise ValueError(f"ragged_gather: d={d} is negative or fill={fill} "
                         f"is not an int32")
    if col.device != starts.device:
        raise ValueError(f"ragged_gather: col on {col.device} and starts "
                         f"on {starts.device}")
    if col.device.type == "cpu":
        return ragged_gather_plain(col, starts, d, fill)
    if col.device.type != "cuda":
        raise ValueError(f"ragged_gather: unsupported device {col.device}")
    if not col.is_contiguous():
        raise ValueError("ragged_gather: col must be contiguous")
    b = int(starts.shape[0])
    if b * d > _INT32.max:
        raise ValueError(f"ragged_gather: {b} rows of {d} ids exceed the "
                         f"kernel's 32-bit indexing")
    out = torch.empty((b, d), dtype=torch.int32, device=col.device)
    if b and d:
        launch(col, starts.contiguous(), out, fill)
    return out


def launch(col: torch.Tensor, starts: torch.Tensor, out: torch.Tensor,
           fill: int) -> None:
    """Launch the kernel on checked arguments: ``col`` int32 contiguous,
    ``starts`` int32 or int64 contiguous on the same card, ``out`` [B, d]
    int32 with B, d > 0.  ``ragged_gather`` checks them; a caller that
    times the kernel alone calls this directly."""
    global launches
    lib = kernels.load("ragged_gather")
    fn = _bind(lib)
    b, d = out.shape
    with torch.cuda.device(col.device):
        rc = fn(col.data_ptr(), col.numel(), starts.data_ptr(),
                starts.element_size(), out.data_ptr(), b, d, fill,
                torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = lib.ragged_gather_error_string(rc)
        raise RuntimeError(f"ragged_gather launch failed: "
                           f"{msg.decode()} (cudaError {rc})")
    launches += 1
