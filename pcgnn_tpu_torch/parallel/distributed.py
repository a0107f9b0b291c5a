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

The JAX package's ``enable_collective_overlap`` and
``OVERLAP_LIBTPU_FLAGS`` set libtpu flags for the TPU's latency-hiding
scheduler; they have no CUDA meaning and are not ported.
"""

from __future__ import annotations

import datetime
from typing import Optional

import torch
import torch.distributed as dist

from pcgnn_tpu_torch.parallel.mesh import RankMesh, rank_mesh

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


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     backend: str = "gloo",
                     timeout_s: float = 600.0) -> None:
    """Join the process group.

    ``coordinator_address`` is ``host:port`` (as the JAX package takes it),
    with ``num_processes`` and ``process_id``; None reads the ``env://``
    variables.  Raises on an unknown backend or a failed initialization."""
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
    dist.init_process_group(**kw)


def ensure_initialized(coordinator_address: Optional[str] = None,
                       num_processes: Optional[int] = None,
                       process_id: Optional[int] = None, *,
                       backend: str = "gloo") -> None:
    """Idempotent :func:`init_distributed`: a process already in a group
    keeps it, so sweep configs (``utils.config.grid``) can share one
    process.  A later call that asks for another world, rank or backend
    raises."""
    if not dist.is_initialized():
        init_distributed(coordinator_address, num_processes, process_id,
                         backend=backend)
        return
    have = (dist.get_world_size(), dist.get_rank(), dist.get_backend())
    for want, got, what in ((num_processes, have[0], "world size"),
                            (process_id, have[1], "rank"),
                            (backend, have[2], "backend")):
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
