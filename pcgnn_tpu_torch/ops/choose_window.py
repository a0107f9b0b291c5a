"""The choose as one kernel: selection scores, the keff nearest and the
kept rows' sum of one relation, ``csrc/choose_window.cu``, from one of two
row sources: the relation's section of the fused records (the store
lanes, ``launch``), or a feature table read through the window's neighbor
ids (the lanes without stores, ``launch_ids``).  The same file scores rows
for ``selection_score`` (``launch_scores``).

``ops.aggregate.choose_window_sum``, ``choose_ids_sum`` and
``selection_score`` are the wrappers: each checks its arguments, takes the
plain version (the chain of PyTorch ops the kernel replaces) for a CPU
tensor and calls the launch for a CUDA one.  No JAX kernel corresponds: the
JAX package computes the choose with XLA ops.

``launches``, ``ids_launches`` and ``score_launches`` count each kernel's
launches, so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pcgnn_tpu_torch.ops import kernels

# kernel launches in this process, by source: the records (``launch``),
# the ids (``launch_ids``), and the score kernel (``launch_scores``); each
# is written by its launch alone
launches = 0
ids_launches = 0
score_launches = 0


def _bind(lib: ctypes.CDLL):
    fn = lib.choose_window
    if fn.argtypes is None:
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [ptr, i64, i64, i64, i64, ptr, ptr, i64, ptr, ptr, ptr,
                       i64, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
        lib.choose_window_ids.argtypes = [
            ptr, i64, ptr, i64, i64, i64, i64, i64, ptr, ptr, i64, ptr, ptr,
            ptr, i64, ctypes.c_int, ptr, ptr, ptr, ptr, ptr, ptr]
        lib.choose_window_ids.restype = ctypes.c_int
        lib.score_rows.argtypes = [ptr, i64, i64, i64, i64, i64, ptr, i64,
                                   ptr, ptr, ptr]
        lib.score_rows.restype = ctypes.c_int
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
    scratch = _scratch(lib, b, d, f, raw.device)
    with torch.cuda.device(raw.device):
        rc = fn(raw.data_ptr(), raw.stride(0), b, d, f, center_s0.data_ptr(),
                w0.data_ptr(), w0.stride(0), b0.data_ptr(), deg.data_ptr(),
                keff.data_ptr(), -1 if hub_cap is None else hub_cap,
                int(round_bf16), num.data_ptr(), cnt.data_ptr(),
                _ptr(keep), _ptr(scratch), _ptr(scores),
                torch.cuda.current_stream().cuda_stream)
    _check(lib, rc, "choose_window")
    launches += 1


def launch_ids(xs: torch.Tensor, nbr: torch.Tensor, f: int,
               score_col: int | None, center_s0: torch.Tensor,
               w0: torch.Tensor, b0: torch.Tensor, deg: torch.Tensor,
               keff: torch.Tensor, hub_cap: int | None, round_bf16: bool,
               num: torch.Tensor, cnt: torch.Tensor,
               keep: torch.Tensor | None,
               scores: torch.Tensor | None = None) -> None:
    """Launch the ids source on checked arguments (``choose_ids_sum``
    checks them): ``xs`` [R, ld] float32 with unit column stride, ld >= f
    (and > ``score_col``, the column of a given score, or None to compute
    it); ``nbr`` [B, d] int32 with unit column stride, whose valid slots
    hold ids below R; the rest as ``launch``, with d = ``nbr.shape[1]``."""
    global ids_launches
    lib = kernels.load("choose_window")
    _bind(lib)
    b, d = (int(s) for s in nbr.shape)
    scratch = _scratch(lib, b, d, f, xs.device)
    with torch.cuda.device(xs.device):
        rc = lib.choose_window_ids(
            xs.data_ptr(), xs.stride(0), nbr.data_ptr(), nbr.stride(0),
            -1 if score_col is None else score_col, b, d, f,
            center_s0.data_ptr(), w0.data_ptr(), w0.stride(0),
            b0.data_ptr(), deg.data_ptr(), keff.data_ptr(),
            -1 if hub_cap is None else hub_cap, int(round_bf16),
            num.data_ptr(), cnt.data_ptr(), _ptr(keep), _ptr(scratch),
            _ptr(scores), torch.cuda.current_stream().cuda_stream)
    _check(lib, rc, "choose_window_ids")
    ids_launches += 1


def launch_scores(x: torch.Tensor, outer: tuple, inner: tuple, f: int,
                  w0: torch.Tensor, b0: torch.Tensor,
                  out: torch.Tensor) -> None:
    """Launch the score kernel: ``out`` [outer[0] * inner[0]] float32
    (contiguous) receives the selection score of the f values at ``x``'s
    storage offset plus i * outer[1] + j * inner[1] floats (unit stride),
    for i < outer[0], j < inner[0]; ``w0`` [f] float32 at any stride, ``b0``
    one float32 (``selection_score`` checks them)."""
    global score_launches
    lib = kernels.load("choose_window")
    _bind(lib)
    with torch.cuda.device(x.device):
        rc = lib.score_rows(x.data_ptr(), outer[0], inner[0], outer[1],
                            inner[1], f, w0.data_ptr(), w0.stride(0),
                            b0.data_ptr(), out.data_ptr(),
                            torch.cuda.current_stream().cuda_stream)
    _check(lib, rc, "score_rows")
    score_launches += 1


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def _scratch(lib, b: int, d: int, f: int, device) -> torch.Tensor | None:
    """Each row's keep flags and sort keys, where a block's would not fit
    its shared memory (windows of many thousand slots)."""
    words = lib.choose_window_scratch(d, f)
    return (torch.empty((b, words), dtype=torch.float32, device=device)
            if words else None)


def _check(lib, rc: int, name: str) -> None:
    if rc:
        msg = lib.choose_window_error_string(rc)
        raise RuntimeError(f"{name} launch failed: {msg.decode()} "
                           f"(cudaError {rc})")
