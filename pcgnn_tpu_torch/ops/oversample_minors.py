"""The training step's oversampled minors as one kernel: each fraud
center's candidate window, its (distance, slot) order, each relation's
minor keep, the dedup against the kept neighbors and the minors' sums,
every relation in one launch, ``csrc/oversample_minors.cu``.

``ops.aggregate.oversample_minor_sums`` is the wrapper: it checks the
arguments, takes the plain version (``oversample_minor_sums_plain``, the
chain of PyTorch ops the kernel replaces) for a CPU tensor and calls
``launch`` for a CUDA one.  No JAX kernel corresponds: the JAX package
computes the same with XLA ops.

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
    fn = lib.oversample_minors
    if fn.argtypes is None:
        i64, ptr = ctypes.c_int64, ctypes.c_void_p
        fn.argtypes = [ptr, ctypes.c_int, i64, i64, ptr, ptr, ptr, ptr, ptr,
                       ptr, ptr, i64, i64, i64, i64, ctypes.c_float, ptr, ptr,
                       ptr, ptr]
        fn.restype = ctypes.c_int
        lib.oversample_minors_scratch.argtypes = [i64, i64, i64]
        lib.oversample_minors_scratch.restype = i64
        lib.oversample_minors_max_relations.argtypes = []
        lib.oversample_minors_max_relations.restype = ctypes.c_int
        lib.oversample_minors_error_string.argtypes = [ctypes.c_int]
        lib.oversample_minors_error_string.restype = ctypes.c_char_p
    return fn


def launch(center_s0: torch.Tensor, sp_sorted: torch.Tensor,
           order: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor,
           chunk: int, m_max: int, batch: torch.Tensor, labels: torch.Tensor,
           rho: float, rels: list, view: tuple | None = None) -> None:
    """Launch the kernel on checked arguments (``oversample_minor_sums``
    checks them): ``center_s0`` [B] float32, ``batch`` and ``labels`` [B]
    int64, ``sp_sorted`` [P] float32, ``order`` and ``ids`` [P] int64, all
    contiguous; ``rows`` [P, F] float32 with unit column stride; ``chunk``
    the window's stride C, 0 for the dense form; ``rels`` one tuple a
    relation of (nbr int32 [B or N, d] with unit column stride, whether
    nbr's rows are read at ``batch``, keep [B, d] bool with unit column
    stride, ksample and deg [N] int32 contiguous, hub cap or -1, num
    [B, F] and cnt [B] float32 contiguous, which the minors are added
    into); B, F, m_max > 0.  A caller that times the kernel alone calls
    this directly.  ``view``, where given, is (slots [B, m_max] int32,
    taken [len(rels), B, m_max] bool), contiguous, which receive each
    fraud row's candidates' slots in (distance, slot) order and each
    relation's flags of the minors it took, for the candidates the row
    selected: where it takes any, the first min(its largest take, its
    valid candidates) (a test's view of the kernel's selection)."""
    global launches
    lib = kernels.load("oversample_minors")
    fn = _bind(lib)
    b, p, f = int(center_s0.shape[0]), int(sp_sorted.shape[0]), int(
        rows.shape[1])
    # each row's selection state, where a block's would not fit its
    # shared memory (windows of thousands of entries)
    nbytes = lib.oversample_minors_scratch(p, chunk, m_max)
    scratch = (torch.empty((b, nbytes), dtype=torch.uint8,
                           device=center_s0.device) if nbytes else None)
    per = lib.oversample_minors_max_relations()
    with torch.cuda.device(center_s0.device):
        for r0 in range(0, len(rels), per):
            group = rels[r0: r0 + per]
            words = []
            for nbr, by_batch, keep, ksample, deg, hub_cap, num, cnt in group:
                words += [nbr.data_ptr(), nbr.stride(0), int(by_batch),
                          int(keep.shape[1]), keep.data_ptr(), keep.stride(0),
                          ksample.data_ptr(), deg.data_ptr(), hub_cap,
                          num.data_ptr(), cnt.data_ptr()]
            slots = taken = None
            if view is not None:
                slots = view[0].data_ptr()
                taken = view[1][r0: r0 + per].data_ptr()
            rc = fn((ctypes.c_int64 * len(words))(*words), len(group), b, f,
                    center_s0.data_ptr(), batch.data_ptr(), labels.data_ptr(),
                    sp_sorted.data_ptr(), order.data_ptr(), ids.data_ptr(),
                    rows.data_ptr(), rows.stride(0), p, chunk, m_max, rho,
                    None if scratch is None else scratch.data_ptr(), slots,
                    taken, torch.cuda.current_stream().cuda_stream)
            if rc:
                msg = lib.oversample_minors_error_string(rc)
                raise RuntimeError(f"oversample_minors launch failed: "
                                   f"{msg.decode()} (cudaError {rc})")
            launches += 1
