"""Dense selection-mask build: ``[B, N]`` float32 0/1, ones at each row's
kept ids.

Counterpart of ``pcgnn_tpu/ops/pallas/mask_build.py``.  The learned-feature
lane (``ops.aggregate.scatter_batch_mask``) aggregates through this mask with
a GEMM, so gradients reach the node table.  ``nbr [B, S]`` holds int32 ids
and ``keep [B, S]`` which of them count; a dropped slot folds to the
sentinel ``num_nodes``, which, like every id outside ``[0, num_nodes)``,
sets nothing.  Duplicates give one 1.0 (set semantics).

On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/mask_build.cu`` or raises; on a CPU tensor it takes the plain PyTorch
version, ``build_batch_mask_plain``.  The wrapper reads nothing back from
the card.

``launches`` counts kernel launches, so a run can show that its main path
went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from pcgnn_tpu_torch.ops import kernels

# kernel launches in this process; the only writer is ``launch``
launches = 0

_TILE = 8192               # columns per block of the kernel (csrc kTile)
_MAX_TILES = 65535         # grid.y limit
_INT32_MAX = torch.iinfo(torch.int32).max


def build_batch_mask_plain(nbr: torch.Tensor, keep: torch.Tensor,
                           num_nodes: int) -> torch.Tensor:
    """The plain version, the JAX package's scatter path: ones accumulated
    into a [B, N+1] buffer at each kept (row, id), every other id folded
    to the sentinel column N, clamped to 1 and sliced to [B, N]."""
    inside = keep & (nbr >= 0) & (nbr < num_nodes)
    ids = torch.where(inside, nbr, num_nodes).to(torch.int64)
    mask = torch.zeros((nbr.shape[0], num_nodes + 1), dtype=torch.float32,
                       device=nbr.device)
    mask.scatter_add_(1, ids, torch.ones(ids.shape, dtype=torch.float32,
                                         device=nbr.device))
    return mask.clamp_(max=1.0)[:, :num_nodes]


def _bind(lib: ctypes.CDLL):
    fn = lib.mask_build
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mask_build_error_string.argtypes = [ctypes.c_int]
        lib.mask_build_error_string.restype = ctypes.c_char_p
    return fn


def build_batch_mask(nbr: torch.Tensor, keep: torch.Tensor,
                     num_nodes: int) -> torch.Tensor:
    """[B, num_nodes] float32 0/1 mask with ones at kept (row, id) slots.

    Args:
      nbr:  [B, S] int32 ids (S may be 0); ids outside [0, num_nodes) set
        nothing.
      keep: [B, S] bool.
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
    if nbr.device.type == "cpu":
        return build_batch_mask_plain(nbr, keep, num_nodes)
    if nbr.device.type != "cuda":
        raise ValueError(f"build_batch_mask: unsupported device "
                         f"{nbr.device}")
    if not (nbr.is_contiguous() and keep.is_contiguous()):
        raise ValueError("build_batch_mask: ids and keep must be contiguous")
    b = int(nbr.shape[0])
    if b >= 2 ** 31 or -(-num_nodes // _TILE) > _MAX_TILES:
        raise ValueError(f"build_batch_mask: {b} rows of {num_nodes} "
                         f"columns exceed the grid limits")
    out = torch.empty((b, num_nodes), dtype=torch.float32, device=nbr.device)
    if b and num_nodes:
        launch(nbr, keep, out)
    return out


def launch(nbr: torch.Tensor, keep: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked arguments: ``nbr`` [B, S] int32 and
    ``keep`` [B, S] bool, contiguous, on the card of ``out`` [B, N] float32
    with B, N > 0.  ``build_batch_mask`` checks them; a caller that times
    the kernel alone calls this directly."""
    global launches
    lib = kernels.load("mask_build")
    fn = _bind(lib)
    b, n = out.shape
    with torch.cuda.device(out.device):
        rc = fn(nbr.data_ptr(), keep.data_ptr(), b, nbr.shape[1], n,
                out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if rc:
        msg = lib.mask_build_error_string(rc)
        raise RuntimeError(f"mask_build launch failed: "
                           f"{msg.decode()} (cudaError {rc})")
    launches += 1
