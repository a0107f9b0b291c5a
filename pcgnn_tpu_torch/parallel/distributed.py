"""Multi-host (multi-process) scaffolding.

Counterpart of ``pcgnn_tpu/parallel/distributed.py``.  Each process is one
``torch.distributed`` rank on one device; the ranks form a
('dcn', 'data', 'graph') mesh (``parallel.mesh``):

  * ``dcn``   — one slot per host.  Only the data-axis sums cross it: the
    loss terms and the flattened gradients, once a step.
  * ``data``  — batch sharding within a host.
  * ``graph`` — the node row-block partition of features and structure
    (``parallel.spmd.ShardedRel``) within a host, innermost, so the per-step
    score all-gather and aggregation sums stay on the host.

The group is initialized from an explicit address (``tcp://host:port``),
world size and rank, or, without an address, from the ``env://``
variables a launcher such as ``torchrun`` sets (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  The backend is ``nccl`` for
CUDA ranks that each own a card and ``gloo`` on the CPU; ranks that share
one card must ask for ``gloo``.  Nothing switches backend after a failure:
a rank that cannot initialize raises.

Collective overlap (the JAX package's ``enable_collective_overlap``, on by
default in :func:`init_distributed` and :func:`ensure_initialized` there
and here).  On the TPU it is a set of libtpu flags that let the
latency-hiding scheduler run the per-step score all-gather and the
aggregation sums asynchronously under halo-independent work.  On CUDA the
mechanism is the async work handle: a collective issued with
``async_op=True`` runs on the communicator's own stream (NCCL) or thread
(gloo), and the compute stream waits for it only at ``work.wait()``.  The
sharded step (``parallel.spmd``) issues its collectives as soon as their
inputs exist and waits on each just before its first use; the kernels
launched in between (the window fetches, their selection scores, the
neighbor-id reads) run under them.  The setting is chosen before the
group exists and every mesh :func:`make_multihost_mesh` / ``rank_mesh``
builds takes it for its life (``RankMesh.overlap``; a mesh is immutable);
off, every collective blocks where it is issued.  The libtpu flag strings
themselves have no counterpart.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from pcgnn_tpu_torch.parallel.mesh import (RankMesh, collective_overlap,
                                           rank_mesh,
                                           set_collective_overlap)

BACKENDS = ("nccl", "gloo")


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def gang_backend(device, world: int) -> str:
    """The backend of a local gang of ``world`` ranks on ``device``:
    ``nccl`` when each rank has a card of its own (``cuda``: rank r on
    ``cuda:r``) or is alone on a named card, ``gloo`` on the CPU or when
    the ranks share one named card (NCCL takes one rank per card)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo"
    return "nccl" if dev.index is None or world == 1 else "gloo"


def enable_collective_overlap() -> None:
    """Give the meshes of this process async collectives, waited at first
    use.  Must run before the process group exists (as the JAX one must run
    before a backend does): raises otherwise, so a silent no-op cannot pass
    for overlap.  :func:`init_distributed` calls it by default."""
    set_collective_overlap(True)


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: str = "gloo",
                     timeout_s: float = 600.0,
                     overlap: bool = True) -> None:
    """Join the process group.

    ``coordinator_address`` is ``host:port`` (as the JAX package takes it),
    with ``num_processes`` and ``process_id``; None reads the ``env://``
    variables.  ``overlap`` (default) gives the meshes async collectives
    (:func:`enable_collective_overlap`); False, blocking ones.  Raises on an
    unknown backend, a process already in a group, or a failed
    initialization."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} is not one of {BACKENDS}")
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout_s))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        addr = coordinator_address
        if "://" not in addr:
            addr = f"tcp://{addr}"
        kw.update(init_method=addr, world_size=int(num_processes),
                  rank=int(process_id))
    else:
        kw.update(init_method="env://")
    set_collective_overlap(overlap)
    dist.init_process_group(**kw)


def ensure_initialized(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, *,
                       backend: str = "gloo", overlap: bool = True) -> None:
    """Idempotent :func:`init_distributed`: a process already in a group
    keeps it, so sweep configs (``utils.config.grid``) can share one
    process.  A later call that asks for another world, rank, backend or
    collective schedule raises."""
    if not dist.is_initialized():
        init_distributed(coordinator_address, num_processes, process_id,
                         backend=backend, overlap=overlap)
        return
    have = (dist.get_world_size(), dist.get_rank(), dist.get_backend(),
            collective_overlap())
    for want, got, what in ((num_processes, have[0], "world size"),
                            (process_id, have[1], "rank"),
                            (backend, have[2], "backend"),
                            (overlap, have[3], "collective overlap")):
        if want is not None and type(got)(want) != got:
            raise ValueError(f"the process group is initialized with "
                             f"{what} {got}, not {want}")


def make_multihost_mesh(graph: int = 1, *, data: Optional[int] = None,
                        ranks_per_host: Optional[int] = None) -> RankMesh:
    """The ('dcn', 'data', 'graph') mesh over all ranks.

    ``graph`` (and optionally ``data``) size the per-host axes; 'dcn' is
    the number of hosts, world / ``ranks_per_host`` (default: one host).
    Each host's ranks form one contiguous (data, graph) tile, so graph
    groups stay within a host."""
    return rank_mesh(graph=graph, data=data, ranks_per_host=ranks_per_host)
