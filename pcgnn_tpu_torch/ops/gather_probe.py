"""Gather-kernel probes: [B, dp] int32 windows of a flat array through the
Tensor Memory Accelerator's bulk copies, two ways.

Counterpart of the two Pallas kernels of ``benchmarks/gather_kernel_probe.py``:

  * ``aligned_gather`` (P-a, ``aligned_window_gather``):
    ``out[b] = flat[a_b : a_b + dp]`` with ``a_b = (s_b // 1024) * 1024``,
    ``rows`` rows a block through a ring of as many slots as fit;
  * ``shift_gather`` (P-s, ``shift_window_gather``):
    ``out[b] = flat[s_b : s_b + dp]`` from any start, ``rows`` rows a block
    through ``slots`` slots, realigned by the block's threads.

``s_b`` is ``starts[b]`` clamped into ``[0, L - dp]`` before any rounding
(as the window gather clamps), so no launch reads past ``flat``; the JAX
probe leaves such starts undefined.  They are design probes of the window
gather (no training path calls them): ``pcgnn_tpu_torch.benchmarks.
gather_kernel_probe`` times them.

On a CUDA tensor each wrapper launches its hand-written kernel in
``csrc/gather_probe.cu`` or raises; on a CPU tensor it takes the plain
PyTorch version beside it.  Both check the same arguments first: int32
``flat`` [L] and ``starts`` [B], ``dp % 4 == 0``, ``L % 4 == 0`` (every
copy whole 16-byte units) and a row narrow enough for 2 slots of shared
memory.  The wrappers read nothing back from the card.

``aligned_launches`` and ``shift_launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from pcgnn_tpu_torch.ops import kernels

# kernel launches in this process; the only writers are the wrappers, where
# they launch
aligned_launches = 0
shift_launches = 0

ALIGN = 1024               # P-a's start granule, in elements
# shared memory a block may use on Hopper (227 KB); the kernels keep one
# 8-byte mbarrier a slot before the slots, rounded up to 128 bytes
SMEM_LIMIT = 232_448
_VEC_BYTES = 16


def shift_gather_plain(flat: torch.Tensor, starts: torch.Tensor,
                       dp: int) -> torch.Tensor:
    """The plain version of P-s: starts clamped into [0, L - dp], then one
    [B, dp] advanced-indexing gather."""
    s = starts.to(torch.int64).clamp(0, flat.numel() - dp)
    return flat[s[:, None] + torch.arange(dp, device=flat.device)]


def aligned_gather_plain(flat: torch.Tensor, starts: torch.Tensor,
                         dp: int) -> torch.Tensor:
    """The plain version of P-a: starts clamped as in P-s, then rounded
    down to a multiple of 1024."""
    s = starts.to(torch.int64).clamp(0, flat.numel() - dp)
    return shift_gather_plain(flat, s // ALIGN * ALIGN, dp)


def smem_bytes(slots: int, slot_bytes: int) -> int:
    """Shared memory a block of ``slots`` slots takes (``csrc/
    gather_probe.cu``: the mbarriers, then the slots)."""
    return -(-slots * 8 // 128) * 128 + slots * slot_bytes


def slot_cap(slot_bytes: int) -> int:
    """How many slots of ``slot_bytes`` fit a block's shared memory (with
    their mbarriers)."""
    k = SMEM_LIMIT // slot_bytes
    while k and smem_bytes(k, slot_bytes) > SMEM_LIMIT:
        k -= 1
    return k


def aligned_slots(dp: int, rows: int) -> int:
    """P-a's ring depth: as many slots of ``dp * 4`` bytes as fit, at most
    ``rows``."""
    return min(rows, slot_cap(dp * 4))


def shift_slots(dp: int, rows: int, slots: int) -> int:
    """P-s's ring depth: ``slots`` capped at ``rows`` and at what fits
    (slots of ``(dp + 4) * 4`` bytes: a window's 16-byte-aligned cover)."""
    return min(slots, rows, slot_cap((dp + 4) * 4))


def _check(name: str, flat: torch.Tensor, starts: torch.Tensor, dp: int,
           rows: int, slot_bytes: int) -> None:
    if flat.dim() != 1 or starts.dim() != 1:
        raise ValueError(f"{name} wants a flat array and [B] starts, got "
                         f"{tuple(flat.shape)} and {tuple(starts.shape)}")
    if flat.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError(f"{name}: flat and starts must be int32, got "
                        f"{flat.dtype} and {starts.dtype}")
    if flat.device != starts.device:
        raise ValueError(f"{name}: flat on {flat.device} and starts on "
                         f"{starts.device}")
    if not 0 < dp <= flat.numel() or dp % 4 or flat.numel() % 4:
        raise ValueError(f"{name}: dp={dp} must be a positive multiple of 4 "
                         f"no larger than L={flat.numel()}, itself a "
                         f"multiple of 4 (whole 16-byte copies)")
    if rows < 1:
        raise ValueError(f"{name}: rows={rows} must be at least 1")
    if slot_cap(slot_bytes) < 2:
        raise ValueError(
            f"{name}: a row of dp={dp} needs slots of {slot_bytes} bytes; "
            f"2 slots and their barriers need {smem_bytes(2, slot_bytes)}, "
            f"over the {SMEM_LIMIT} bytes of shared memory a block may use")


def _out(name: str, flat: torch.Tensor, starts: torch.Tensor, dp: int):
    if flat.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {flat.device}")
    if not flat.is_contiguous() or flat.data_ptr() % _VEC_BYTES:
        raise ValueError(f"{name}: flat must be contiguous and 16-byte "
                         f"aligned")
    return torch.empty((starts.shape[0], dp), dtype=torch.int32,
                       device=flat.device)


def aligned_gather(flat: torch.Tensor, starts: torch.Tensor, dp: int,
                   rows: int = 8) -> torch.Tensor:
    """P-a: [B, dp] windows of ``flat`` at the clamped starts rounded down
    to a multiple of 1024, ``rows`` rows a block."""
    _check("aligned_gather", flat, starts, dp, rows, dp * 4)
    if flat.device.type == "cpu":
        return aligned_gather_plain(flat, starts, dp)
    global aligned_launches
    out = _out("aligned_gather", flat, starts, dp)
    if out.shape[0]:
        _launch("gather_probe_aligned", flat, starts.contiguous(), out, rows,
                aligned_slots(dp, rows))
        aligned_launches += 1
    return out


def shift_gather(flat: torch.Tensor, starts: torch.Tensor, dp: int,
                 rows: int, slots: int) -> torch.Tensor:
    """P-s: [B, dp] windows of ``flat`` at the clamped starts, ``rows``
    rows a block through ``slots`` slots (capped by ``shift_slots``)."""
    _check("shift_gather", flat, starts, dp, rows, (dp + 4) * 4)
    if slots < 1:
        raise ValueError(f"shift_gather: slots={slots} must be at least 1")
    if flat.device.type == "cpu":
        return shift_gather_plain(flat, starts, dp)
    global shift_launches
    out = _out("shift_gather", flat, starts, dp)
    if out.shape[0]:
        _launch("gather_probe_shift", flat, starts.contiguous(), out, rows,
                shift_slots(dp, rows, slots))
        shift_launches += 1
    return out


def _bind(lib: ctypes.CDLL, name: str):
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.gather_probe_error_string.argtypes = [ctypes.c_int]
        lib.gather_probe_error_string.restype = ctypes.c_char_p
    return fn


def _launch(name: str, flat, starts, out, rows: int, slots: int) -> None:
    lib = kernels.load("gather_probe")
    fn = _bind(lib, name)
    b, dp = out.shape
    with torch.cuda.device(flat.device):
        rc = fn(flat.data_ptr(), flat.numel(), starts.data_ptr(),
                out.data_ptr(), b, dp, rows, slots,
                torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = lib.gather_probe_error_string(rc)
        raise RuntimeError(f"{name} launch failed: {msg.decode()} "
                           f"(cudaError {rc})")

