"""Window gather: ``out[b, :] = store[s_b : s_b + dp]``.

Counterpart of ``pcgnn_tpu/ops/pallas/window_gather.py``.  A start is taken
as that module's fallback, ``jax.lax.dynamic_slice``, takes it: a negative
start gets the store's length L added once, then every start is clamped
into ``[0, L - dp]``.  So any start is valid and the CPU, the card and the
JAX function agree on every one.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/window_gather.cu`` or raises; on a CPU tensor it takes the plain
PyTorch version, ``window_gather_plain``.  The wrapper reads nothing back
from the card: its checks use shapes, dtypes and pointers only.  The kernel
serves both callers: the per-relation edge-window stores and the fused
record store (record v is the window at ``v * W``).  ``out_dtype=float32``
on a bfloat16 store widens in the same pass (exactly), which is what every
consumer of a bf16 window computes right after the fetch.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel; ``masked_launches`` counts those of them made with
``active`` (the sharded store lane's masked fetch).
"""

from __future__ import annotations

import ctypes

import torch

from pcgnn_tpu_torch.ops import kernels

# kernel launches in this process, and those with ``active``; the only
# writer is ``launch``
launches = 0
masked_launches = 0

_VEC_BYTES = 16
_DTYPES = (torch.float32, torch.bfloat16)


def window_gather_plain(store: torch.Tensor, starts: torch.Tensor, dp: int,
                        *, out_dtype: torch.dtype | None = None
                        ) -> torch.Tensor:
    """The plain version: starts wrapped and clamped as
    ``lax.dynamic_slice`` takes them, then one [B, dp] advanced-indexing
    gather (widened to ``out_dtype``)."""
    length = store.numel()
    s = starts.to(torch.int64)
    s = torch.where(s < 0, s + length, s).clamp(0, length - dp)
    out = store[s[:, None] + torch.arange(dp, device=store.device)]
    return out if out_dtype is None else out.to(out_dtype)


def _bind(lib: ctypes.CDLL):
    fn = lib.window_gather
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.window_gather_error_string.argtypes = [ctypes.c_int]
        lib.window_gather_error_string.restype = ctypes.c_char_p
    return fn


def window_gather(store: torch.Tensor, starts: torch.Tensor, dp: int, *,
                  active: torch.Tensor | None = None,
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """[B, dp] windows of the flat ``store`` ([L], float32 or bfloat16).

    ``starts`` [B] are element offsets (int32 or int64) of any value,
    wrapped and clamped as ``lax.dynamic_slice`` takes them.
    ``out_dtype``: the store's dtype (default) or float32, which widens a
    bfloat16 store exactly.  ``active`` [B]: rows where it is 0 are not
    copied and their output rows hold garbage the caller must mask (the
    plain version copies every row).
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
    out_dtype = store.dtype if out_dtype is None else out_dtype
    if out_dtype not in (store.dtype, torch.float32):
        raise TypeError(f"window_gather: out_dtype {out_dtype} is neither "
                        f"the store's {store.dtype} nor float32")
    if not 0 < dp <= store.numel():
        raise ValueError(f"window_gather: dp={dp} is not in "
                         f"(0, {store.numel()}], the store's length")
    devices = {store.device, starts.device}
    if active is not None:
        if active.shape != starts.shape:
            raise ValueError("window_gather: active must be shaped like starts")
        devices.add(active.device)
    if len(devices) != 1:
        raise ValueError(f"window_gather: tensors on several devices {devices}")
    if store.device.type == "cpu":
        return window_gather_plain(store, starts, dp, out_dtype=out_dtype)
    if store.device.type != "cuda":
        raise ValueError(f"window_gather: unsupported device {store.device}")
    if not store.is_contiguous() or store.data_ptr() % _VEC_BYTES:
        raise ValueError("window_gather: store must be contiguous and "
                         "16-byte aligned")
    b = int(starts.shape[0])
    if b >= 2 ** 31:
        raise ValueError(f"window_gather: {b} rows exceed the grid limit")
    out = torch.empty((b, dp), dtype=out_dtype, device=store.device)
    if b == 0:
        return out
    if active is not None:
        active = active.to(torch.int32).contiguous()
    launch(store, starts.to(torch.int64).contiguous(), active, out)
    return out


def launch(store: torch.Tensor, starts: torch.Tensor,
           active: torch.Tensor | None, out: torch.Tensor) -> None:
    """Launch the kernel on checked arguments: ``starts`` int64 and
    ``active`` int32 (or None), contiguous, on the store's card; ``out``
    [B, dp] of the store's dtype or float32, B > 0.  ``window_gather``
    checks them; a caller that times the kernel alone calls this
    directly."""
    global launches, masked_launches
    lib = kernels.load("window_gather")
    fn = _bind(lib)
    b, dp = out.shape
    with torch.cuda.device(store.device):
        rc = fn(store.data_ptr(), store.numel(), store.element_size(),
                starts.data_ptr(),
                None if active is None else active.data_ptr(),
                out.data_ptr(), out.element_size(), b, dp,
                torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = lib.window_gather_error_string(rc)
        raise RuntimeError(f"window_gather launch failed: "
                           f"{msg.decode()} (cudaError {rc})")
    launches += 1
    masked_launches += active is not None
