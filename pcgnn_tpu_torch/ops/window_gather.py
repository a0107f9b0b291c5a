"""Window gather: ``out[b, :] = store[starts[b] : starts[b] + dp]``.

Counterpart of ``pcgnn_tpu/ops/pallas/window_gather.py``.  On a CUDA tensor
the wrapper launches the hand-written kernel in ``csrc/window_gather.cu``
(one kernel for any 16-byte-aligned start, float32 or bfloat16, with an
optional ``active`` row mask) or raises; on a CPU tensor it takes the plain
PyTorch version, ``window_gather_plain``.  The kernel serves both callers:
the per-relation edge-window stores and the fused record store (record v is
the window at ``v * W``).

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pcgnn_tpu_torch.ops import kernels

# kernel launches in this process; the only writer is ``launch``
launches = 0

_VEC_BYTES = 16
_DTYPES = (torch.float32, torch.bfloat16)


def window_gather_plain(store: torch.Tensor, starts: torch.Tensor,
                        dp: int) -> torch.Tensor:
    """The plain version: one [B, dp] advanced-indexing gather."""
    idx = starts.to(torch.int64)[:, None] + torch.arange(
        dp, device=store.device)
    return store[idx]


def _bind(lib: ctypes.CDLL):
    fn = lib.window_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.window_gather_error_string.argtypes = [ctypes.c_int]
        lib.window_gather_error_string.restype = ctypes.c_char_p
    return fn


def window_gather(store: torch.Tensor, starts: torch.Tensor, dp: int, *,
                  active: torch.Tensor | None = None) -> torch.Tensor:
    """[B, dp] windows of the flat ``store`` ([L], float32 or bfloat16).

    ``starts`` [B] are element offsets (int32 or int64).  On the card each
    must be 16-byte aligned and ``starts + dp`` must fit the store, and
    ``dp`` must span whole 16-byte vectors; the wrapper checks all of it
    (one device-to-host read) and raises otherwise.  ``active`` [B]: rows
    where it is 0 are not copied and their output rows hold garbage the
    caller must mask (the plain version copies every row).
    """
    if store.dim() != 1 or starts.dim() != 1:
        raise ValueError(f"window_gather wants a flat store and [B] starts, "
                         f"got {tuple(store.shape)} and {tuple(starts.shape)}")
    if store.dtype not in _DTYPES:
        raise TypeError(f"window_gather store dtype {store.dtype} is not "
                        f"float32 or bfloat16")
    if starts.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"window_gather starts dtype {starts.dtype} is not "
                        f"int32 or int64")
    devices = {store.device, starts.device}
    if active is not None:
        if active.shape != starts.shape:
            raise ValueError("window_gather: active must be shaped like starts")
        devices.add(active.device)
    if len(devices) != 1:
        raise ValueError(f"window_gather: tensors on several devices {devices}")
    if store.device.type == "cpu":
        return window_gather_plain(store, starts, dp)
    if store.device.type != "cuda":
        raise ValueError(f"window_gather: unsupported device {store.device}")

    esize = store.element_size()
    a = _VEC_BYTES // esize
    b = int(starts.shape[0])
    if not store.is_contiguous() or store.data_ptr() % _VEC_BYTES:
        raise ValueError("window_gather: store must be contiguous and "
                         "16-byte aligned")
    if dp <= 0 or dp % a:
        raise ValueError(f"window_gather: dp={dp} is not a positive multiple "
                         f"of {a} elements (16 bytes)")
    if b >= 2 ** 31:
        raise ValueError(f"window_gather: {b} rows exceed the grid limit")
    out = torch.empty((b, dp), dtype=store.dtype, device=store.device)
    if b == 0:
        return out
    starts = starts.to(torch.int64).contiguous()
    bad = ((starts % a != 0).any() | (starts.min() < 0)
           | (starts.max() + dp > store.numel()))
    if bool(bad):
        raise ValueError("window_gather: a start is not 16-byte aligned or "
                         "its window runs past the store")
    if active is not None:
        active = active.to(torch.int32).contiguous()
    launch(store, starts, active, out)
    return out


def launch(store: torch.Tensor, starts: torch.Tensor,
           active: torch.Tensor | None, out: torch.Tensor) -> None:
    """Launch the kernel on checked arguments: ``starts`` int64 and
    ``active`` int32 (or None), contiguous, on the store's card; ``out``
    [B, dp] of the store's dtype.  ``window_gather`` checks them; a caller
    that times the kernel alone calls this directly."""
    global launches
    lib = kernels.load("window_gather")
    fn = _bind(lib)
    b, dp = out.shape
    esize = store.element_size()
    with torch.cuda.device(store.device):
        rc = fn(store.data_ptr(), starts.data_ptr(),
                None if active is None else active.data_ptr(),
                out.data_ptr(), b, dp * esize, esize,
                torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = lib.window_gather_error_string(rc)
        raise RuntimeError(f"window_gather launch failed: "
                           f"{msg.decode()} (cudaError {rc})")
    launches += 1
