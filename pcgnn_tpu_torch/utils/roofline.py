"""Roofline accounting on the card: a call's time against its least time.

Counterpart of ``pcgnn_tpu/utils/roofline.py``:

  * ``chip_peaks``  - the card's peak memory rate and dense bf16 rate, from
    its name (NVIDIA's data sheets, at the card's full power limit);
  * ``timed_ms``    - milliseconds per call of a run of back-to-back calls
    between two CUDA events;
  * ``measure``     - that time against ``analytic_bytes`` (the least bytes
    the call must move, with no credit for cache reuse) and
    ``analytic_flops``: ``sol_frac`` is the bytes' time at the peak rate
    over the measured time, ``mfu`` the same for the operations.

PyTorch has no compiler cost model, so ``xla_bytes`` is None and ``flops``
is ``analytic_flops``.  A measurement needs a CUDA card: on the CPU these
raise.  A share above ``SOL_LIMIT`` is a fault of the timing or of the
count (a working set that stays in the 50 MB L2 can beat the streaming
bound), so ``measure`` raises rather than report it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

# (part of the card's name, (peak memory bytes/s, peak dense bf16 FLOP/s)),
# first match wins: NVIDIA's H100 and H200 data sheets, dense rates
_CARD_PEAKS = (
    ("H200", (4.8e12, 989e12)),
    ("H100 PCIe", (2.0e12, 756e12)),
    ("H100 NVL", (3.9e12, 835e12)),
    ("H100", (3.35e12, 989e12)),        # SXM, "NVIDIA H100 80GB HBM3"
)
# the largest share of a peak a measurement may report
SOL_LIMIT = 1.05


def _card(device=None) -> torch.device:
    """The CUDA device ``device`` names (default: the current one); raises
    when it is not a CUDA device or no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(f"a roofline measurement times a CUDA card; "
                           f"{dev} is not one here")
    return dev


def chip_peaks(device=None):
    """(peak memory bytes/s, peak dense bf16 FLOP/s) of the card, by its
    name (``torch.cuda.get_device_name(device)``); (None, None) for a card
    not in the table, or when there is no card."""
    if not torch.cuda.is_available():
        return None, None
    kind = torch.cuda.get_device_name(device)
    for part, peaks in _CARD_PEAKS:
        if part in kind:
            return peaks
    return None, None


def timed_ms(call: Callable[[], object], *, target_s: float = 0.15,
             max_iters: int = 512) -> float:
    """Milliseconds per call of ``call()``, which enqueues work on the
    current stream: one warm-up call, then N back-to-back calls between two
    CUDA events and a synchronize, N doubled (or scaled) until the run
    lasts ``target_s`` or reaches ``max_iters``."""
    _card()
    call()
    torch.cuda.synchronize()
    n = 4
    while True:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call()
        end.record()
        end.synchronize()
        total_s = start.elapsed_time(end) / 1e3
        if total_s >= target_s or n >= max_iters:
            return total_s / n * 1e3
        n = min(max_iters, max(n * 2, int(n * target_s / max(total_s,
                                                             1e-4))))


def measure(fn: Callable, *args, analytic_bytes: Optional[float] = None,
            analytic_flops: Optional[float] = None, device=None,
            target_s: float = 0.15) -> dict:
    """Time ``fn(*args)`` on the card and report its roofline shares: the
    JAX package's keys, and ``device``, the card's name.  Each call runs
    ``fn`` again on the same arguments, so ``fn`` must take them more than
    once.  Raises on a CPU device and on a share above ``SOL_LIMIT``."""
    dev = _card(device)
    wall_ms = timed_ms(lambda: fn(*args), target_s=target_s)
    dt = wall_ms / 1e3
    peak_bw, peak_flops = chip_peaks(dev)
    flops = None if analytic_flops is None else float(analytic_flops)
    res = {
        "wall_ms": wall_ms,
        "xla_bytes": None,
        "flops": flops,
        "achieved_gflops": None if flops is None else flops / dt / 1e9,
        "peak_gbps": peak_bw / 1e9 if peak_bw else None,
        "mfu": flops / dt / peak_flops if flops is not None and peak_flops
        else None,
        "device": torch.cuda.get_device_name(dev),
    }
    if analytic_bytes is not None:
        res["analytic_bytes"] = float(analytic_bytes)
        res["achieved_gbps"] = analytic_bytes / dt / 1e9
        if peak_bw:
            sol_s = analytic_bytes / peak_bw
            res["sol_ms"] = sol_s * 1e3
            res["sol_frac"] = sol_s / dt
    for key in ("sol_frac", "mfu"):
        if res.get(key) is not None and res[key] > SOL_LIMIT:
            raise RuntimeError(f"measure: {key} {res[key]:.3f} is above "
                               f"{SOL_LIMIT} of the card's peak; the timing "
                               f"or the analytic count is wrong: {res}")
    return res


def pcgnn_step_streaming_bytes(graph, batch_size: int, m_max: int,
                               emb_dim: int) -> float:
    """Least memory traffic of one PC-GNN training step, in bytes, counted
    as the JAX package counts it: each relation's neighbor-window rows
    (features and score) and ids, the oversampled minor rows, one pass of
    the score product over the feature table, the self rows, and the
    [B, F + emb] activations three times (forward and backward).  Sort
    scratch, backward re-reads and the optimizer's traffic are left out:
    it is a lower bound."""
    f = graph.feat_dim
    n = graph.num_nodes
    b = batch_size
    total = 0.0
    for rel in graph.relations:
        d = max(int(rel.window_width), 1)
        total += b * d * ((f + 1) * 4 + 4)      # window rows + nbr indices
    total += b * m_max * (f * 4 + 4)            # oversampled minor rows
    total += n * f * 4                          # score matmul reads X once
    total += b * f * 4                          # self rows
    total += 3 * b * (f + emb_dim) * 4          # activations fwd+bwd
    return total
