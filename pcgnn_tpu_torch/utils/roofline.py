"""Roofline accounting on the card: a call's time against its least time.

Counterpart of ``pcgnn_tpu/utils/roofline.py``:

  * ``chip_peaks``  - the card's peak memory rate and dense bf16 rate, from
    its name (NVIDIA's data sheets, at the card's full power limit);
  * ``timed_ms``    - milliseconds per call of a run of back-to-back calls
    between two CUDA events;
  * ``kernel_ms``   - device milliseconds per call of back-to-back calls
    queued before the card starts them, cycling through argument sets, the
    outputs' write-back included (not in the JAX package);
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

import time
from typing import Callable, Optional, Sequence

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


# calls of one ``kernel_ms`` reading, and its readings after a warm-up run
KERNEL_CALLS = 32
KERNEL_READINGS = 5
# runs a reading may take to queue all its calls before the card starts it
QUEUE_TRIES = 4
# ``torch.cuda._sleep`` cycles per millisecond, by device index
_SLEEP_RATE: dict = {}


def _sleep_cycles_per_ms(dev: torch.device) -> float:
    """Cycles of ``torch.cuda._sleep`` the card spins per millisecond
    (measured once per device, on the second of two spins)."""
    if dev.index not in _SLEEP_RATE:
        cycles = 1 << 22
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            torch.cuda._sleep(cycles)
            end.record()
            end.synchronize()
        _SLEEP_RATE[dev.index] = cycles / start.elapsed_time(end)
    return _SLEEP_RATE[dev.index]


def kernel_ms(fn: Callable, arg_sets: Sequence[tuple]) -> list:
    """Device milliseconds per call of ``fn``, the write-back of its outputs
    to memory included: ``KERNEL_READINGS`` readings, sorted, each the time
    of a run of ``KERNEL_CALLS`` back-to-back calls between two CUDA
    events, after a warm-up run.  The calls take ``arg_sets`` in turn, so
    sets whose reads together exceed the card's L2 (50 MB) find their
    inputs in memory, and every output stays alive until the run after
    next ends, so no call writes where the last two runs wrote: the lines
    a call leaves dirty in the L2 go to memory while later calls of the
    run execute (the kernel's own time, as the profiler reads it, can end
    before they do).  Each run is queued behind a ``torch.cuda._sleep``
    longer than the host takes to issue it, so no launch gap of the host
    enters the time (the host can take longer to issue a call of a few
    tens of microseconds than the card to run it); a run whose start the
    card reached before the host had queued it is taken again with twice
    the sleep, up to ``QUEUE_TRIES`` times, then this raises.  Raises on a
    CPU device."""
    dev = _card()
    n_sets = len(arg_sets)

    def run(sleep_ms: float):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if sleep_ms:
            torch.cuda._sleep(int(sleep_ms * _sleep_cycles_per_ms(dev)))
        start.record()
        t = time.perf_counter()
        outs = [fn(*arg_sets[i % n_sets]) for i in range(KERNEL_CALLS)]
        host_ms = (time.perf_counter() - t) * 1e3
        queued = not start.query()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / KERNEL_CALLS, host_ms, queued, outs

    _, host_ms, _, outs = run(0.0)
    alive = [outs]          # the last two runs' outputs
    sleep_ms = 2 * host_ms + 1.0
    out = []
    for _ in range(KERNEL_READINGS):
        for _ in range(QUEUE_TRIES):
            ms, _, queued, outs = run(sleep_ms)
            alive = [alive[-1], outs]
            if queued:
                break
            sleep_ms *= 2
        else:
            raise RuntimeError(f"kernel_ms: the card reached a run of {fn} "
                               f"before the host had queued it, {QUEUE_TRIES}"
                               f" times (last sleep {sleep_ms / 2:.1f} ms)")
        out.append(ms)
    return sorted(out)


def measure(fn: Callable, *args, analytic_bytes: Optional[float] = None,
            analytic_flops: Optional[float] = None, device=None,
            target_s: float = 0.15,
            arg_sets: Optional[Sequence[tuple]] = None) -> dict:
    """Time ``fn(*args)`` on the card and report its roofline shares: the
    JAX package's keys, and ``device``, the card's name.  Each call runs
    ``fn`` again on the same arguments, so ``fn`` must take them more than
    once.  With ``arg_sets`` (and no ``args``) the time is instead the
    median of ``kernel_ms(fn, arg_sets)``, its readings in
    ``readings_ms``.  Raises on a CPU device and on a share above
    ``SOL_LIMIT``."""
    dev = _card(device)
    readings = None
    if arg_sets is None:
        wall_ms = timed_ms(lambda: fn(*args), target_s=target_s)
    else:
        if args:
            raise ValueError("measure takes args or arg_sets, not both")
        readings = kernel_ms(fn, arg_sets)
        wall_ms = readings[len(readings) // 2]
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
    if readings is not None:
        res["readings_ms"] = readings
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
                               emb_dim: int, *,
                               scored_rows: int | None = None) -> float:
    """Least memory traffic of one PC-GNN training step, in bytes, counted
    as the JAX package counts it: each relation's neighbor-window rows
    (features and score) and ids, the oversampled minor rows, one pass of
    the score product over the feature table, the self rows, and the
    [B, F + emb] activations three times (forward and backward).  Sort
    scratch, backward re-reads and the optimizer's traffic are left out:
    it is a lower bound.

    ``scored_rows`` is the rows the score product reads: by default the
    whole table, as the JAX package counts it.  A lane that scores from
    the window reads no table pass, only the batch's rows (the self rows)
    and the train positives' (pass their count)."""
    f = graph.feat_dim
    n = graph.num_nodes if scored_rows is None else scored_rows
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
