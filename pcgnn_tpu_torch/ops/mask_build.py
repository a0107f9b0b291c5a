"""Dense selection-mask build: ``[B, N]`` float32 0/1, ones at each row's
kept ids, and each row's count of them.

Counterpart of ``pcgnn_tpu/ops/pallas/mask_build.py``.  The learned-feature
lane (``ops.aggregate.scatter_batch_mask_counts``) aggregates through this
mask with a GEMM, so gradients reach the node table, and divides the
product by the counts.  ``nbr [B, S]`` holds int32 ids and ``keep [B, S]``
which of them count; the minors come as a second column group,
``minor_ids`` [M] (shared by every row) or [B, M] with ``keep_minor``
[B, M].  A dropped slot folds to the sentinel ``num_nodes``, which, like
every id outside ``[0, num_nodes)``, sets nothing.  Duplicates, within a
group or across the two, give one 1.0 and count once (set semantics), so
the counts equal ``mask.sum(1)`` exactly.

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/mask_build.cu`` or raises; on a CPU tensor it takes the plain
PyTorch version, ``build_batch_mask_counts_plain``.  The wrapper reads
nothing back from the card.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pcgnn_tpu_torch.ops import kernels

# kernel launches in this process; the only writer is ``launch``
launches = 0

_INT32_MAX = torch.iinfo(torch.int32).max
_TILE = 4096               # row positions per block of the kernel (csrc kTile)


def build_batch_mask_counts_plain(nbr: torch.Tensor, keep: torch.Tensor,
                                  num_nodes: int,
                                  minor_ids: torch.Tensor | None = None,
                                  keep_minor: torch.Tensor | None = None):
    """The plain version, the JAX package's scatter path: the minors
    appended by columns, ones accumulated into a [B, N+1] buffer at each
    kept (row, id), every other id folded to the sentinel column N, clamped
    to 1 and sliced to [B, N]; the counts are its row sums."""
    if minor_ids is not None:
        nbr = torch.cat([nbr, minor_ids.to(nbr.dtype).expand(
            keep_minor.shape)], dim=1)
        keep = torch.cat([keep, keep_minor], dim=1)
    inside = keep & (nbr >= 0) & (nbr < num_nodes)
    ids = torch.where(inside, nbr, num_nodes).to(torch.int64)
    mask = torch.zeros((nbr.shape[0], num_nodes + 1), dtype=torch.float32,
                       device=nbr.device)
    mask.scatter_add_(1, ids, torch.ones(ids.shape, dtype=torch.float32,
                                         device=nbr.device))
    mask = mask.clamp_(max=1.0)[:, :num_nodes]
    return mask, mask.sum(dim=1)


def _bind(lib: ctypes.CDLL):
    fn = lib.mask_build
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mask_build_error_string.argtypes = [ctypes.c_int]
        lib.mask_build_error_string.restype = ctypes.c_char_p
    return fn


def _check_minors(nbr, minor_ids, keep_minor) -> None:
    if (minor_ids is None) != (keep_minor is None):
        raise ValueError("build_batch_mask_counts wants minor_ids and "
                         "keep_minor together")
    if minor_ids is None:
        return
    if minor_ids.dtype != torch.int32 or keep_minor.dtype != torch.bool:
        raise TypeError(f"build_batch_mask_counts wants int32 minor ids and "
                        f"bool keep_minor, got {minor_ids.dtype} and "
                        f"{keep_minor.dtype}")
    b = nbr.shape[0]
    if (keep_minor.dim() != 2 or keep_minor.shape[0] != b
            or minor_ids.shape not in (keep_minor.shape[1:],
                                       keep_minor.shape)):
        raise ValueError(f"build_batch_mask_counts wants minors [M] or "
                         f"[B, M] and keep_minor [B, M] with B={b}, got "
                         f"{tuple(minor_ids.shape)} and "
                         f"{tuple(keep_minor.shape)}")
    if not minor_ids.device == keep_minor.device == nbr.device:
        raise ValueError("build_batch_mask_counts: minors on another device "
                         "than the ids")


def build_batch_mask_counts(nbr: torch.Tensor, keep: torch.Tensor,
                            num_nodes: int,
                            minor_ids: torch.Tensor | None = None,
                            keep_minor: torch.Tensor | None = None):
    """(mask [B, num_nodes] float32 0/1 with ones at kept (row, id) slots,
    counts [B] float32, the mask's row sums).

    Args:
      nbr:  [B, S] int32 ids (S may be 0); ids outside [0, num_nodes) set
        nothing.
      keep: [B, S] bool.
      minor_ids, keep_minor: an optional second column group, int32 [M] or
        [B, M] ids and [B, M] bool, read in place.
    """
    if nbr.dim() != 2 or keep.shape != nbr.shape:
        raise ValueError(f"build_batch_mask wants [B, S] ids and keep of "
                         f"one shape, got {tuple(nbr.shape)} and "
                         f"{tuple(keep.shape)}")
    if nbr.dtype != torch.int32 or keep.dtype != torch.bool:
        raise TypeError(f"build_batch_mask wants int32 ids and bool keep, "
                        f"got {nbr.dtype} and {keep.dtype}")
    if not 0 <= num_nodes <= _INT32_MAX:
        raise ValueError(f"build_batch_mask: num_nodes={num_nodes} is not "
                         f"an int32 count")
    if nbr.device != keep.device:
        raise ValueError(f"build_batch_mask: ids on {nbr.device} and keep "
                         f"on {keep.device}")
    _check_minors(nbr, minor_ids, keep_minor)
    if nbr.device.type == "cpu":
        return build_batch_mask_counts_plain(nbr, keep, num_nodes, minor_ids,
                                             keep_minor)
    if nbr.device.type != "cuda":
        raise ValueError(f"build_batch_mask: unsupported device "
                         f"{nbr.device}")
    if not all(t is None or t.is_contiguous()
               for t in (nbr, keep, minor_ids, keep_minor)):
        raise ValueError("build_batch_mask: ids, keep and the minors must "
                         "be contiguous")
    b = int(nbr.shape[0])
    if b * -(-(num_nodes + 3) // _TILE) > _INT32_MAX:
        raise ValueError(f"build_batch_mask: {b} rows of {num_nodes} "
                         f"columns exceed the grid limit")
    out = torch.empty((b, num_nodes), dtype=torch.float32, device=nbr.device)
    if not num_nodes:
        return out, torch.zeros(b, dtype=torch.float32, device=nbr.device)
    counts = torch.empty(b, dtype=torch.float32, device=nbr.device)
    if b:
        launch(nbr, keep, out, counts, minor_ids, keep_minor)
    return out, counts


def build_batch_mask(nbr: torch.Tensor, keep: torch.Tensor,
                     num_nodes: int) -> torch.Tensor:
    """The mask alone, the JAX package's ``build_batch_mask``: [B,
    num_nodes] float32 0/1 with ones at kept (row, id) slots."""
    return build_batch_mask_counts(nbr, keep, num_nodes)[0]


def launch(nbr: torch.Tensor, keep: torch.Tensor, out: torch.Tensor,
           counts: torch.Tensor, minor_ids: torch.Tensor | None = None,
           keep_minor: torch.Tensor | None = None) -> None:
    """Launch the kernel on checked arguments: ``nbr`` [B, S] int32 and
    ``keep`` [B, S] bool, contiguous, optional contiguous minors as
    ``build_batch_mask_counts`` takes them, on the card of ``out`` [B, N]
    float32 and ``counts`` [B] float32 with B, N > 0.
    ``build_batch_mask_counts`` checks them; a caller that times the kernel
    alone calls this directly."""
    global launches
    lib = kernels.load("mask_build")
    fn = _bind(lib)
    b, n = out.shape
    if minor_ids is None:
        mids = kmin = None
        stride = minors = 0
    else:
        mids, kmin = minor_ids.data_ptr(), keep_minor.data_ptr()
        minors = keep_minor.shape[1]
        stride = 0 if minor_ids.dim() == 1 else minors
    with torch.cuda.device(out.device):
        rc = fn(nbr.data_ptr(), keep.data_ptr(), nbr.shape[1], mids, stride,
                kmin, minors, b, n, out.data_ptr(), counts.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = lib.mask_build_error_string(rc)
        raise RuntimeError(f"mask_build launch failed: "
                           f"{msg.decode()} (cudaError {rc})")
    launches += 1
