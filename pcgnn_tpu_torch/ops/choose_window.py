"""The window lane's choose as one kernel: selection scores, the keff
nearest and the kept rows' sum of one relation's section of the fused
records, ``csrc/choose_window.cu``.

``ops.aggregate.choose_window_sum`` is the wrapper: it checks the
arguments, takes the plain version (``choose_window_sum_plain``, the chain
of PyTorch ops the kernel replaces) for a CPU tensor and calls ``launch``
for a CUDA one.  No JAX kernel corresponds: the JAX package computes the
choose with XLA ops.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pcgnn_tpu_torch.ops import kernels

# kernel launches in this process; the only writer is ``launch``
launches = 0


def _bind(lib: ctypes.CDLL):
    fn = lib.choose_window
    if fn.argtypes is None:
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [ptr, i64, i64, i64, i64, ptr, ptr, i64, ptr, ptr, ptr,
                       i64, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        lib.choose_window_scratch.argtypes = [i64, i64]
        lib.choose_window_scratch.restype = i64
        lib.choose_window_error_string.argtypes = [ctypes.c_int]
        lib.choose_window_error_string.restype = ctypes.c_char_p
    return fn


def launch(raw: torch.Tensor, d: int, f: int, center_s0: torch.Tensor,
           w0: torch.Tensor, b0: torch.Tensor, deg: torch.Tensor,
           keff: torch.Tensor, hub_cap: int | None, round_bf16: bool,
           num: torch.Tensor, cnt: torch.Tensor, keep: torch.Tensor | None,
           scores: torch.Tensor | None = None) -> None:
    """Launch the kernel on checked arguments (``choose_window_sum`` checks
    them): ``raw`` [B, >= d*f] float32 with unit column stride,
    ``center_s0`` [B] float32, ``deg`` and ``keff`` [B] int32, all
    contiguous but ``raw`` and ``w0`` ([f] float32, any stride); ``b0`` one
    float32; outputs ``num`` [B, f], ``cnt`` [B] float32 and ``keep``
    [B, d] bool or None, contiguous; B, d, f > 0.  A caller that times the
    kernel alone calls this directly.  ``scores`` ([B, d] float32,
    contiguous), where given, receives the score of every slot the kernel
    scored: the valid slots of rows with 0 < keff < their valid count (a
    test's view of the kernel's arithmetic)."""
    global launches
    lib = kernels.load("choose_window")
    fn = _bind(lib)
    b = int(raw.shape[0])
    # each row's keep flags and sort keys, where a block's would not fit
    # its shared memory (windows of many thousand slots)
    words = lib.choose_window_scratch(d, f)
    scratch = (torch.empty((b, words), dtype=torch.float32, device=raw.device)
               if words else None)
    with torch.cuda.device(raw.device):
        rc = fn(raw.data_ptr(), raw.stride(0), b, d, f, center_s0.data_ptr(),
                w0.data_ptr(), w0.stride(0), b0.data_ptr(), deg.data_ptr(),
                keff.data_ptr(), -1 if hub_cap is None else hub_cap,
                int(round_bf16), num.data_ptr(), cnt.data_ptr(),
                None if keep is None else keep.data_ptr(),
                None if scratch is None else scratch.data_ptr(),
                None if scores is None else scores.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = lib.choose_window_error_string(rc)
        raise RuntimeError(f"choose_window launch failed: {msg.decode()} "
                           f"(cudaError {rc})")
    launches += 1
