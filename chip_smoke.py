#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pcgnn_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with no
result line, on any failure.  In order:

  1. builds every CUDA kernel of the package from ``pcgnn_tpu_torch/csrc``
     (one ``nvcc`` per source, all at once) and prints the compiler report,
     and the native graph core (``g++``, meanwhile), which must load: every
     graph below is built through it, and each build says so;
  2. builds the ``synthetic:yelp-like`` graph (no hub rows) and its bf16
     edge-window and fused record stores on the card, then holds the
     window-gather kernel against its plain PyTorch version on the card at
     the main path's shapes, in the store's dtype and widened to float32,
     and at starts of every kind (every misalignment, negative, past the
     end; with and without ``active``), exactly (the kernel is a copy);
     times kernel, plain version, a one-call PyTorch yardstick, the
     memory-bound floor and the launch floor (1 row of 16 bytes);
  3. trains PC-GNN on yelp-like at full width with the bench configuration
     for 2 epochs (12 steps) in the fused-record lane through
     ``Trainer.run_epoch`` -- the first step eager, the training step
     captured as a CUDA graph, every other step a replay of it -- with
     every launch count set to 0 just before and read just after, then
     evaluates the validation split (``Trainer.evaluate``: the forward
     captured as a CUDA graph, a replay a batch, one read-back);
  4. runs steps in the per-relation store lane (fused store off);
  5. profiles one epoch of yelp-like steps (device time by kernel, kernel
     launches and host syncs per step, the card's busy share);
  6. runs one step on the card and the same step on the CPU's plain path,
     from the same weights and batch, and compares loss, gradients and
     parameters;
  7. builds ``synthetic:yelp-skew`` (relation 2 carries 40 hubs of degree
     up to 20,000 above a window cap near the p99.5 degree) and holds the
     ragged-gather kernel against its plain version, exactly, at the hub
     lane's real chunk shapes from one epoch's batches and at edge cases,
     with the same four timings, its launch floor (1 row x 1 id) and its
     bound averaged over the epoch's real calls;
  8. trains yelp-skew for 2 epochs (12 steps) through ``Trainer`` as in 3:
     the hub lane runs on every step with a hub row, and both kernels'
     counts are read; then evaluates the validation split;
  9. profiles one epoch of yelp-skew steps, as in 5, with the hub lane's
     own host and device time;
 10. compares the card's and the CPU's step on the yelp-skew batch with
     the most hub rows, as in 6;
 11. times yelp-like and yelp-skew steps in turns (like, skew, skew, like),
     so that the two graphs are compared at the same moments of the host;
 12. on yelp-like's graph without stores, with ``learn_features``, holds the
     mask-build kernel against its plain version, exactly, mask and row
     counts (and the counts against ``mask.sum(1)``), at the learned lane's
     real calls from one epoch's batches (window [B, D] and minors [B, M]
     as two column groups) and at edge cases, with the same four timings;
 13. trains the learned lane for 2 epochs (12 steps) through ``Trainer`` as
     in 3: every step launches the mask build once per relation and no
     window gather, and the table moves; then evaluates;
 14. profiles one epoch of learned steps, as in 5, where no reduction or
     elementwise kernel may take a mask-sized pass; then times the
     aggregation at relation 2's real mask, forward and backward, two ways
     in turns (old, new, new, old): the mask scaled before the GEMM,
     ``(mask / mask.sum(1)) @ x``, as the JAX package computes it, and the
     product divided by the kernel's counts, ``(mask @ x) / cnt``, as the
     port does; with each one's device time by kernel;
 15. compares the card's and the CPU's learned step, as in 6, and runs one
     learned forward with every dense neighbor table dropped (the CSR
     branch, through the ragged gather), whose logits must equal the
     table's exactly.

Phase 11 also times the learned steps in the same turns.  Then:

 16. trains PC-GNN on yelp-skew's graph without stores (``edge_windows:
     false``: the score-table lane) as in 8, with no window gather and the
     ragged gather on every step with a hub row; profiles an epoch and
     compares the card's step with the CPU's on the batch with the most
     hub rows;
 17. builds ``synthetic:stress-1m`` (1M nodes, directed relations, a
     degree-only homo graph) on the host, printing its seconds, builds its
     first epoch's plan twice and prints whether the two are equal, with
     the plan's digest (to compare two calls) and how many of 20 float32
     pick CDFs of its weights differ (the cumsum the pick used to take);
     trains one epoch in the per-relation store lane (three window gathers
     a step, scores from the windows), then evaluates; profiles it; holds
     the window gather against its plain version and times it at each
     relation's shape (also with reads from memory, and with the card idle
     before each call); runs one step without stores or the padded table
     (the clamped-id lane) on the card and the CPU; and one forward with
     every dense neighbor table dropped (the CSR branch, through the ragged
     gather), whose logits must equal the table's exactly;
 18. trains GCN and GraphSAGE on ``synthetic:amazon_new-like`` with the
     amazon baselines' hyperparameters for 2 epochs each (one window
     gather a step, on the homo store), after holding the window gather
     against its plain version at that shape and timing it with reads from
     memory; profiles and compares each with the CPU's step;
 19. runs one step of each baseline on yelp-skew's graph, whose homo hub
     rows go through ``hub_mean_sum`` and the ragged gather, card against
     CPU;
 20. writes yelp-like's graph as the reference's YelpChi files (the
     ``.pt`` features and four pickled ``defaultdict(set)`` adjacency
     lists), loads them onto the card (equal to the generated graph,
     exactly), and trains PC-GNN from them through ``pcgnn_tpu_torch.cli``
     with ``configs/pcgnn_yelpchi.json`` cut to 2 epochs: a window gather on
     every step, validation AUC above 0.5; then ``verify_dataset`` must say
     GO; it prints the write and load seconds and the step ms;
 21. on that graph, ``resume``: an uncut 4-epoch run, twice, and a 2-epoch
     run resumed to 4, whose epoch plans must equal the uncut run's and
     whose final parameters must be within 1e-3 of them (it prints that
     difference beside the two uncut runs'); and ``profile_dir``: a 5-epoch
     run whose trace of epochs 2-4 holds a window gather on every step;
 22. on every relation of yelp-like's and stress-1m's graphs, the full-graph
     ops: the three lowerings of ``segment_mean_spmm`` (window, edge-window
     on the bf16 store, segment with an all-true ``keep``) and the edge
     scoring (``edge_abs_diff``, its window and edge-window forms,
     ``edge_ranks_global``), once each with every launch count at 0: each
     edge-window call launches the window gather once per node chunk; the
     lowerings agree with one another on the card and with their plain CPU
     run (stress-1m's on 4,096 seeded rows); the segment form is called
     twice and whether it repeats bit for bit is printed; then each call is
     timed with ``utils.roofline.measure`` against its bytes, and the
     window gather is timed at the path's shape on each graph's largest
     relation (``chunk_sweep.py`` times the node chunk widths that chose
     the path's); last, ``Trainer.single_step`` is timed
     on yelp-like at ``nscan`` 1 and 16 against
     ``pcgnn_step_streaming_bytes``;
 23. the sharded step (``pcgnn_tpu_torch.parallel``): two gloo ranks,
     children of this script (``--sharded-rank``), share cuda:0 at
     (data 1, graph 2).  (b) They train yelp-like for 2 epochs as
     ``distributed: true`` ranks through ``pcgnn_tpu_torch.cli`` (captured
     steps and evaluates, the default on CUDA): test AUC above 0.5 and
     equal on both ranks, the first epoch's mean loss within rtol 1e-4 of
     this process's run, a fused fetch a step on the card.  (a) On graphs
     this process saves meanwhile, each of ``SHARD_CASES`` (yelp-like
     fused and per-relation store lanes, yelp-skew with stores and
     without, GCN and GraphSAGE on amazon_new-like) on the first epoch's
     batch with the most hub rows:
     loss and gradients against this process's single-rank step (as in
     6), parameters bit-equal on both ranks after 3 steps, the lanes'
     kernels launched (the masked fetch, kernel 1c, counted apart);
     the masked fetch's skipped rows 0 and owned rows equal to its plain
     version.  Each rank reports step ms, launches, collectives and bytes
     by axis, host round trips and peak memory a step.  Kernel 1c is then
     checked and timed here at that lane's shape, and (c) a 1-rank NCCL
     group initializes, all-reduces, and its captured steps at (1, 1) --
     one piece a step, no collective -- equal the single-rank captured
     steps exactly (the single rank sums its oversampled minors with the
     sharded step's chain of ops there).  Two ranks on one card give no
     scaling number.
     Each case also runs with the collectives async (``RankMesh.overlap``,
     the default) and blocking: loss and gradients from the same weights
     must be the same bits; 8 steps timed in turns (on, off, off, on, ...),
     the host syncs of one step each way, and one profiled step each way
     with the kernel launches between each async collective's issue and its
     wait (``launches_between_markers``).  (d) Each case then trains
     through its rank's ``Trainer`` (the case's configuration as a
     ``distributed: true`` rank) eagerly and captured -- the sharded step
     as pieces cut at its collectives (``train.capture.PieceGraph``) --
     from the same weights in turns (eager, captured, captured, eager;
     ``SHARD_CAPTURE_STEPS`` steps a turn), overlap on and off: losses,
     parameters and Adam state bit-equal after the second and fourth
     turns, and the captured evaluate of the validation split bit-equal to
     the eager per-batch one.  Each rank reports step ms on CUDA events
     each way, pieces and collectives a step, gloo's host round trips a
     step apart from the hub plan's collective and read-back a stack, the
     kernels the card ran (``card_launches``), capture seconds and
     graph-pool bytes;
 24. ``synthetic:stress-10m`` (BASELINE.json config 5: 10M nodes, F = 64,
     directed relations of 130M / 70M / 30M CSR edges), built on the host
     through the native graph core, and trained at full width for one
     epoch and one validation in the clamped CSR lane: no relation has a
     dense table or a store and there is no padded table, so every step
     reads each relation's window from the CSR through the ragged gather
     (three launches, no window gather) and gathers rows with ids clamped
     to N-1.  It checks the lane, the launches of every step, the
     validation AUC (above 0.5) and the card's step against the CPU's on
     the first batch, as in 6; and prints the build's seconds by step, the
     set-up's, a profiled span of 20 steps (launches, syncs, kernel ms,
     busy share), ``single_step`` through ``utils.roofline.measure``, the
     ragged gather at the three relations' calls against its plain version
     (exactly), its bound and an indexing gather, the oversample
     candidates and the row gathers timed alone, and peak device memory
     and host RSS;
 25. the probe path of ``benchmarks/`` (``pcgnn_tpu_torch.benchmarks``),
     with every kernel count at 0 before and read after:
     ``gather_kernel_probe`` at its defaults ([1024, 7,040] int32 windows
     of a 902 MB array through kernel 2, kernel 1's copy, the shift probe
     P-s at the JAX probe's (rows, slots) sweep, the aligned probe P-a at
     rows 8-64, the ``unfold`` indexing yardstick and the plain versions),
     every variant exact against its plain version and timed (calls
     queued ahead of the card over eight sets of starts, the output's
     write-back included) beside the read+write bound, a time under it
     failing; ``gather_probe`` (the five gather strategies at the
     JAX script's defaults, each exact against the first that computes its
     values); ``roofline``'s rows on yelp-like's graph from phase 3 (a
     share above ``SOL_LIMIT`` fails); then ``spmd_overhead`` in a process
     of its own (a 1-rank NCCL group, whose sharded step's loss must equal
     the single step's);
 26. the port's harnesses, each timed: ``measure_reference`` on this
     host (written to a file of the phase, never
     ``BASELINE_MEASURED.json``); the bench (``pcgnn_tpu_torch.bench``)
     at its defaults on yelp-like's graph from phase 3, with every count
     at 0 before and read after: ``bench.py``'s 13 keys, its
     ``vs_baseline`` against this host's reference and against the
     repository's file, one window gather a step; BASELINE.json config 3
     (PC-GNN on amazon-like at batch 256, lr 0.005, weight decay 0.0005):
     kernel 1 at its widened fused records, exact against the plain
     version and timed queued (below); ``quality_run`` cut in depth only
     (seed 2, 20 epochs, all five settings at full width, counts from 0):
     every test AUC above 0.5, peak device memory per run;
     ``quality_protocol`` on amazon-like, one seed, 2 epochs, through the
     CLI: rc 0 and a table of one row; ``spmd_scaling`` at (1, 1) over
     NCCL, then (2, 1) and (1, 2) over gloo ranks sharing cuda:0: every
     warm loss within ``LOSS_RTOL`` of the (1, 1) loss on its batch,
     kernel 1c launched at (1, 2); ``multihost_scaling`` with 1 and 2
     processes on ``small`` for 1 epoch.  The protocol and the two
     scaling harnesses run side by side, sharing the card and the host:
     one card gives no scaling number;
 27. the entry points of ``__graft_entry__.py``, ported
     (``pcgnn_tpu_torch.graft_entry``): ``entry()`` on the card, with
     every count at 0 before its forward and read after (kernel 1
     launched, finite [64, 2] logits and center scores within rtol 1e-5 of
     the CPU's), then ``dryrun_multichip(2, device="cuda:0")``: two gloo
     ranks sharing the card at (1, 2), one training step in each of the
     tiny (plain lane), skew-tiny (hub lane, bf16 stores, fused table:
     kernels 1 and 2) and stress-1m (1M nodes, plain lane) passes, each
     rank's counts at 0 before each step; losses finite and equal on both
     ranks, stress-1m's structure half on each rank within 4,096 bytes,
     seconds per pass; the tiny and skew-tiny steps held against the same
     dryrun on the CPU (the kernels' plain versions): each rank's loss
     within ``LOSS_RTOL``, gradients within ``GRAD_RTOL`` / ``GRAD_ATOL``,
     parameters after the Adam step within ``PARAM_ATOL``.

 28. the captured step (``train.capture``) against the eager step on the
     graphs above (yelp-like fused and learned, yelp-skew with and without
     stores, amazon_new-like GCN and GraphSAGE) and on stress-10m's (run
     inside phase 24): 12 steps each way from the same weights, in turns
     (eager, captured, captured, eager), bit-equal after 12 and 24 steps
     (losses, parameters, Adam state); step ms, the busy share, graph
     launches and kernels a step under the profiler, the capture's seconds
     and count, the graph pool's bytes, and the host syncs of a captured
     block (the hub plan's one read-back on a graph with hubs, none
     without).
 29. the captured forward (``train.capture.PredictRunner``, through
     ``Trainer.evaluate``) against the eager per-batch evaluate
     (``train.metrics.evaluate`` over ``Trainer.predict``) on the same
     graphs, stress-10m's inside phase 24 (its first 256 validation
     batches): a model trained one epoch, its validation evaluated in
     turns (eager, captured, captured, eager),
     the probabilities bit-equal and the AUC the same in every turn; each
     turn's seconds, host syncs, kernel launches, replays, captures and
     capture seconds, and the forward's graph pool; the replays must
     launch kernels 1, 2 and 3 between them.
 30. the choose kernel (kernel 4) at the benchmark cells' record sections,
     and its ids source and the score kernel at the stress cell's shapes,
     against their plain versions and timed queued (below);
 31. the oversample kernel (kernel 5) at the benchmark cells' shapes of a
     step's minors, against its plain version and timed queued (below).

Training runs through captured steps wherever the trainer's epochs or
``single_step`` run (phases 3, 8, 13, 16-18, 20-22, 24-26), and
evaluations through the captured forward wherever ``Trainer.evaluate``
runs (phases 3, 8, 13, 16-18, 20, 21, 24, 26).  A kernel wrapper counts
its call at a capture, which records the launch and runs nothing, and not
at a replay, which runs it: the launches a phase reports are what the card
ran (``card_launches``: the wrappers' counts less the captures', plus each
replay's recorded launches), and a step's launches are its captured
step's (``StepEvents``).  The phases that attribute time to a
profiler range (5, 9, 14, 16-18, 24) and the card-vs-CPU steps (6, 10, 15,
17-19) take the eager step, ``Trainer.step``, explicitly.

Phases 2, 7, 12 and 23 also time each kernel at the path's call with
``utils.roofline.kernel_ms`` (``queued_ms``: calls queued ahead of the
card, taking argument sets whose reads together exceed the L2 in turn,
every output's write-back inside the run), beside the plain version and
the library call; the kernels line carries those times, the profiler's
beside them, and a queued time under its bound fails.

Every profiled run (phases 5, 9, 14, 16-18, 24) counts the host syncs of
one step; a run whose relations have no hub rows must make none.

The line before the last is the card's name and power limit; before it, a
``{"kernels": [...]}`` line; the last line is
``{"ok": true, "device": {...}}``.  Longer details go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import glob
import hashlib
import json
import math
import os
import resource
import shutil
import subprocess
import sys
import tempfile
import time
import unittest.mock

import numpy as np
import torch

# the bench configuration of the repo (bench.py), cut to 2 epochs
BENCH_CFG = dict(seed=2, data_name="synthetic:yelp-like", model="PCGNN",
                 train_ratio=0.4, test_ratio=0.67, emb_size=64, lr=0.01,
                 weight_decay=0.001, alpha=2.0, rho=0.5, epochs=2,
                 valid_epochs=10 ** 9, batch_size=1024, patience=10 ** 9,
                 exp_num=0, ewin_dtype="bfloat16")
# the same, on the heavy-tailed preset that exercises the hub lane
SKEW_CFG = dict(BENCH_CFG, data_name="synthetic:yelp-skew")
# the same on yelp-like, with the node table trained (the dense mask lane)
LEARNED_CFG = dict(BENCH_CFG, learn_features=True)
# the same on yelp-skew without stores: the score-table lane
TABLE_CFG = dict(SKEW_CFG, edge_windows=False)
# the same on the 1M-node stress preset (directed relations, degree-only
# homo graph), one epoch: the per-relation store lane, scores from windows
STRESS_CFG = dict(BENCH_CFG, data_name="synthetic:stress-1m", epochs=1)
# GCN and GraphSAGE with the amazon baselines' hyperparameters
# (configs/gcn_amazon.json, configs/sage_amazon.json), cut to 2 epochs, on
# the synthetic preset of amazon_new's shape (its data are not in the
# repository)
GCN_CFG = dict(seed=2, data_name="synthetic:amazon_new-like", model="GCN",
               train_ratio=0.4, test_ratio=0.67, emb_size=64, lr=0.005,
               weight_decay=0.0005, epochs=2, valid_epochs=10 ** 9,
               batch_size=1024, patience=10 ** 9, exp_num=0,
               ewin_dtype="bfloat16")
SAGE_CFG = dict(GCN_CFG, model="SAGE")
TIMING_REPS = 30
PROFILE_TRIES = 5
# card against CPU, one Adam step from the same weights and batch.  Both
# select the same neighbors (selection scores are rounded once from float64,
# so they do not depend on the device's summation order); the float32 sums
# over the batch run in another order on each device.  So the loss agrees to
# rtol 1e-5 and the gradients to rtol 1e-4 with atol 1e-6 (for components
# that nearly cancel).  The first Adam step moves each weight by
# lr * g / (|g| + 1e-8): about lr for most, but a component that cancels to
# the size of eps turns a summation-order difference of ~1e-9 into a move
# that differs by a fraction of lr = 0.01, so parameters get atol 1e-3.
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_ATOL = 1e-3
# a kernel taking this long a launch is a pass over a mask-sized tensor: one
# pass over the learned lane's 188 MB mask takes 56 us at 3.35 TB/s
MASK_PASS_US = 30.0


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def memory_rate() -> float:
    """Card 0's published memory rate in bytes/s, from its name
    (``utils.roofline.chip_peaks``); raises for a card not in its table."""
    from pcgnn_tpu_torch.utils.roofline import chip_peaks
    rate, _ = chip_peaks(0)
    if rate is None:
        raise RuntimeError(f"no published memory rate known for "
                           f"{torch.cuda.get_device_name(0)!r}")
    return rate


def host_ops(prof) -> list:
    """[(name, host ms, calls)] of the operators and runtime calls a
    torch.profiler run saw on the host, by their own (self) time, longest
    first."""
    from torch.autograd import DeviceType
    return sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CPU), key=lambda x: -x[1])


def device_kernels(prof) -> list:
    """[(name, device ms, calls)] of the kernels a torch.profiler run saw,
    longest first.  Only kernel entries count: an operator's entry, and an
    annotated range such as the optimizer step's, repeat their kernels'
    device time."""
    from torch.autograd import DeviceType
    return sorted(((e.key, e.device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation), key=lambda x: -x[1])


def time_ms(fn, args_list, exclude: str | None = None) -> tuple[float, float]:
    """(device ms, run ms) per call of ``fn(*args)`` over ``args_list``,
    after one warm-up call.  Device ms is the kernels' own time under
    torch.profiler, without kernels whose name holds ``exclude``; run ms
    is CUDA events around the whole run of back-to-back calls over the
    count, which also holds the card's idle gaps while the host launches
    the next call."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args_list[0])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    end.synchronize()
    run_ms = start.elapsed_time(end) / len(args_list)
    # now and then the profiler records none of a run's kernels (seen on an
    # H100 with torch 2.11): profile the run again rather than report 0
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for args in args_list:
                fn(*args)
            torch.cuda.synchronize()
        dev_ms = sum(ms for k, ms, _ in device_kernels(prof)
                     if exclude is None or exclude not in k) / len(args_list)
        if dev_ms > 0:
            return dev_ms, run_ms
    raise RuntimeError(f"the profiler recorded no kernel of {fn} in "
                       f"{PROFILE_TRIES} runs")


def check_gather(store, starts, dp, active=None, out_dtype=None) -> float:
    """Kernel against plain version on the card, on the rows it copies;
    returns max |err|.  The kernel is a copy: anything but equality
    fails."""
    from pcgnn_tpu_torch.ops import window_gather as wg
    out = wg.window_gather(store, starts, dp, active=active,
                           out_dtype=out_dtype)
    ref = wg.window_gather_plain(store, starts, dp, out_dtype=out_dtype)
    torch.cuda.synchronize()
    rows = slice(None) if active is None else active.bool()
    out, ref = out[rows], ref[rows]
    err = float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0
    if not torch.equal(out, ref):
        raise AssertionError(f"window_gather disagrees with its plain "
                             f"version (dp={dp}, {store.dtype} -> "
                             f"{out.dtype}, max |err| {err})")
    return err


def any_starts(length, dp, a, gen, dev, rows=1000):
    """``rows`` starts of every kind for a store of ``length`` elements:
    random ones at every offset mod ``a`` (the elements of a 16-byte
    vector), and fixed ones at and past the end and negative (the kernel
    wraps a negative start once, then clamps every start into
    [0, length - dp], as ``lax.dynamic_slice`` does)."""
    fixed = torch.tensor([0, length - dp, length - dp + 1, length - 1, length,
                          3 * length, -1, -a - 1, -dp, -length, -length - 1,
                          -3 * length], device=dev)
    rand = torch.randint(0, length - dp + 1, (rows - len(fixed),),
                         generator=gen, device=dev)
    return torch.cat([fixed, rand])


def strided_rows(store, dp, a):
    """[L/a, dp] overlapping view: row i is store[i*a : i*a + dp]."""
    n = (store.numel() - dp) // a + 1
    return store.as_strided((n, dp), (a, 1))


def time_spaced_ms(fn, args_list, gap_s: float = 0.002) -> float:
    """Device ms per call of ``fn(*args)`` when the card was idle for
    ``gap_s`` before each call (host sleep after a synchronize), as on a
    host-bound training step; the kernels' own time under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn(*args_list[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for args in args_list:
            time.sleep(gap_s)
            fn(*args)
            torch.cuda.synchronize()
    return sum(ms for _, ms, _ in device_kernels(prof)) / len(args_list)


def window_case(name, store, starts_list, dp, table, rows_list, *,
                rate: float, active=None, flush=None,
                spaced: bool = False) -> dict:
    """Times one window shape: the kernel alone (``launch`` on checked
    arguments) copying (``ms``) and widening to float32 (``widen_ms``),
    the wrapper, the plain version (both ways), and one ``index_select``
    of the same windows from ``table``, a [rows, dp] view of the store
    (a copy: no PyTorch call also widens).  ``*_ms`` is device time per
    call, ``*_run_ms`` the back-to-back run time.  With ``active``, the
    kernel and the wrapper copy only the active rows; the plain version and
    ``index_select`` copy every row, which gives the active rows' values.
    With ``flush``, a buffer larger than the card's L2, every call first
    overwrites it, so the call's reads come from memory; the device ms
    leave the overwrite out, the run ms hold it.  ``spaced``: the
    copy and the widening also timed with the card idle before each
    call."""
    from pcgnn_tpu_torch.ops import window_gather as wg
    rows = len(starts_list[0])
    f32 = torch.float32
    out = torch.empty((rows, dp), dtype=store.dtype, device=store.device)
    wide = torch.empty((rows, dp), dtype=f32, device=store.device)
    starts = [(s,) for s in starts_list]
    # bytes the copy must move: each copied window read once and written
    # once (in float32 when widened), plus the int64 starts and the int32
    # mask
    copied = rows if active is None else int(active.sum())
    esize = store.element_size()
    extra = rows * 8 + (0 if active is None else rows * 4)
    nbytes = 2 * copied * dp * esize + extra
    wbytes = copied * dp * (esize + 4) + extra
    c = {"name": name, "rows": rows, "copied_rows": copied, "dp": dp,
         "row_bytes": dp * esize,
         "dtype": str(store.dtype).replace("torch.", ""),
         "bound_ms": nbytes / rate * 1e3, "bytes": nbytes,
         "widen_bound_ms": wbytes / rate * 1e3, "widen_bytes": wbytes}
    excl = None if flush is None else "FillFunctor"

    def cold(fn):
        if flush is None:
            return fn
        return lambda *a: (flush.fill_(0.0), fn(*a))[1]

    def kernel(dst):
        return lambda s: wg.launch(store, s, active, dst)

    for key, fn, args in (
            ("ms", kernel(out), starts),
            ("widen_ms", kernel(wide), starts),
            ("wrapper_ms", lambda s: wg.window_gather(store, s, dp,
                                                      active=active),
             starts),
            ("plain_ms", lambda s: wg.window_gather_plain(store, s, dp),
             starts),
            ("widen_plain_ms", lambda s: wg.window_gather_plain(
                store, s, dp, out_dtype=f32), starts),
            ("library_ms", lambda i: torch.index_select(table, 0, i),
             [(i,) for i in rows_list])):
        c[key], c[key.replace("ms", "run_ms")] = time_ms(cold(fn), args,
                                                         exclude=excl)
    if spaced:
        c["spaced_ms"] = time_spaced_ms(kernel(out), starts)
        c["widen_spaced_ms"] = time_spaced_ms(kernel(wide), starts)
    c["cold_reads"] = flush is not None
    return c


def queued_ms(fn, arg_sets, bound_ms: float | None = None,
              what: str = "") -> dict:
    """``utils.roofline.kernel_ms`` of ``fn`` over ``arg_sets`` (calls
    queued ahead of the card, taking the sets in turn, every output's
    write-back inside the run): the median and the readings.  Raises when
    the median reads under ``bound_ms`` by more than ``SOL_LIMIT`` (the
    timing or the byte count would be wrong)."""
    from pcgnn_tpu_torch.utils import roofline
    readings = roofline.kernel_ms(fn, arg_sets)
    ms = readings[len(readings) // 2]
    if bound_ms is not None and ms * roofline.SOL_LIMIT < bound_ms:
        raise AssertionError(f"{what}: {ms * 1e3:.2f} us reads under its "
                             f"bound {bound_ms * 1e3:.2f} us")
    return {"ms": ms, "readings_ms": readings}


def queued_window(store, starts_list, dp, table, rows_list, *,
                  rate: float, active=None) -> dict:
    """One window shape timed by ``queued_ms`` over the calls of
    ``starts_list`` (whose reads together exceed the L2): the kernel alone
    (``launch`` into a fresh output) widening to float32 (``ms``) and
    copying (``copy_ms``), the plain version widening (``plain_ms``), and
    one ``index_select`` copy of the same windows from ``table``
    (``library_ms``); the bounds as ``window_case`` counts them."""
    from pcgnn_tpu_torch.ops import window_gather as wg
    rows = len(starts_list[0])
    dev = store.device
    copied = rows if active is None else int(active.sum())
    esize = store.element_size()
    extra = rows * 8 + (0 if active is None else rows * 4)
    bound = (2 * copied * dp * esize + extra) / rate * 1e3
    widen_bound = (copied * dp * (esize + 4) + extra) / rate * 1e3

    def kernel(dtype):
        def call(s):
            out = torch.empty((rows, dp), dtype=dtype, device=dev)
            wg.launch(store, s, active, out)
            return out
        return call

    sets = [(s,) for s in starts_list]
    q = {"rows": rows, "copied_rows": copied, "dp": dp,
         "bound_ms": widen_bound, "copy_bound_ms": bound,
         "read_bytes": len(sets) * copied * dp * esize}
    for key, fn, args, bnd in (
            ("", kernel(torch.float32), sets, widen_bound),
            ("copy_", kernel(store.dtype), sets, bound),
            ("plain_", lambda s: wg.window_gather_plain(
                store, s, dp, out_dtype=torch.float32), sets, None),
            ("library_", lambda i: torch.index_select(table, 0, i),
             [(i,) for i in rows_list], None)):
        r = queued_ms(fn, args, bnd, f"window_gather {key}[{rows}, {dp}]")
        q[key + "ms"], q[key + "readings_ms"] = r["ms"], r["readings_ms"]
    return q


def kernel_phase(t, rate: float) -> tuple[dict, dict]:
    """Phase 2: exactness on the card and timings at the main path's
    shapes.  Returns (kernels-line entry, details)."""
    from pcgnn_tpu_torch.ops import window_gather as wg
    g, dev = t.graph, t.device
    b = t.batch_size
    f32 = torch.float32
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [t.idx_train_dev[torch.randint(len(t.idx_train), (b,),
                                             generator=gen, device=dev)]
               for _ in range(TIMING_REPS)]
    fused = g.fused
    w = fused.shape[1]
    esize = fused.element_size()
    flat = fused.view(-1)
    details = {"cases": []}

    # the main path's calls: the fused record fetch and each relation's
    # store, copied and widened
    errs = []
    for out_dtype in (None, f32):
        errs.append(check_gather(flat, batches[0] * w, w,
                                 out_dtype=out_dtype))
        for rel in g.relations:
            errs.append(check_gather(rel.ewin, rel.estart[batches[0]],
                                     rel.ewin_dp, out_dtype=out_dtype))
    # B = 1000 starts of every kind at the fused width, with and without an
    # active mask, copied and widened; and a float32 store at the widest
    # relation's window
    a = 16 // esize
    edge = any_starts(flat.numel(), w, a, gen, dev)
    active = torch.randint(0, 2, (1000,), generator=gen, device=dev,
                           dtype=torch.int32)
    f32_store = torch.randn(1 << 24, generator=gen, device=dev)
    dp32 = g.relations[-1].ewin_dp
    edge32 = any_starts(f32_store.numel(), dp32, 4, gen, dev)
    for act in (None, active):
        for st in (edge, edge.to(torch.int32)):
            for out_dtype in (None, f32):
                errs.append(check_gather(flat, st, w, act, out_dtype))
        errs.append(check_gather(f32_store, edge32, dp32, act))
    # a window that is not whole 16-byte vectors (the element path only)
    errs.append(check_gather(flat, edge, w - 3, active, f32))

    def case(*args, **kw):
        c = window_case(*args, rate=rate, **kw)
        details["cases"].append(c)
        return c

    main = case("fused_record", flat, [bt * w for bt in batches], w,
                fused, batches)
    # the masked variant (the TPU kernel's _gather_masked, whose caller is
    # the SPMD lane): half the rows active
    half = (torch.arange(b, device=dev) % 2).to(torch.int32)
    masked = case("fused_record_masked", flat, [bt * w for bt in batches], w,
                  fused, batches, active=half)
    for r, rel in enumerate(g.relations):
        a_r = 16 // rel.ewin.element_size()
        starts = [rel.estart[bt] for bt in batches]
        case(f"relation_{r}", rel.ewin, starts, rel.ewin_dp,
             strided_rows(rel.ewin, rel.ewin_dp, a_r),
             [s // a_r for s in starts])
    # the launch floor: the same kernel copying 1 row of 16 bytes
    floor = case("launch_floor", flat, [bt[:1] * w for bt in batches], a,
                 strided_rows(flat, a, a), [bt[:1] * w // a for bt in batches])
    # the main path's call queued ahead of the card over the 30 batches
    # (546 MB of reads), the write-back included: the times of the kernels
    # line; the profiler's beside them
    q = queued_window(flat, [bt * w for bt in batches], w, fused, batches,
                      rate=rate)
    details["queued"] = q
    # the main path's call widens the fused records to float32; no one
    # PyTorch call does that, so its yardstick is the copy's
    entry = {"name": "window_gather", "route": "cuda",
             "source": "pcgnn_tpu_torch/csrc/window_gather.cu",
             "replaces": "pcgnn_tpu/ops/pallas/window_gather.py:223",
             "launches": None, "max_abs_err": max(errs), "exact": True,
             "checked": len(errs),
             "ms": q["ms"], "plain_ms": q["plain_ms"],
             "bound_ms": q["bound_ms"], "bound_by": "bytes",
             "library_ms": None,
             "copy_ms": q["copy_ms"], "copy_bound_ms": q["copy_bound_ms"],
             "copy_library_ms": q["library_ms"],
             "range_ms": [q["readings_ms"][0], q["readings_ms"][-1]],
             "profiler_ms": main["widen_ms"],
             "profiler_copy_ms": main["ms"],
             "profiler_plain_ms": main["widen_plain_ms"],
             "profiler_copy_library_ms": main["library_ms"],
             "floor_ms": floor["ms"]}
    details["masked"] = {k: masked[k] for k in ("ms", "bound_ms", "plain_ms",
                                                "library_ms")}
    return entry, details


def check_ragged(col, starts, d, fill) -> float:
    """Ragged-gather kernel against its plain version on the card; returns
    max |err|.  The kernel is a copy: anything but equality fails."""
    from pcgnn_tpu_torch.ops.ragged_gather import (ragged_gather,
                                                   ragged_gather_plain)
    out = ragged_gather(col, starts, d, fill)
    ref = ragged_gather_plain(col, starts, d, fill)
    torch.cuda.synchronize()
    err = (float((out.double() - ref.double()).abs().max()) if out.numel()
           else 0.0)
    if not torch.equal(out, ref):
        raise AssertionError(f"ragged_gather disagrees with its plain "
                             f"version (B={len(starts)}, d={d}, max |err| "
                             f"{err})")
    return err


def hub_chunk_calls(t) -> list:
    """The ragged-gather calls the hub lane makes over the first epoch's
    batches, as the training step makes them: (relation, starts
    [HUB_CHUNK], width) for every chunk of the epoch's plan
    (``ops.hub.epoch_hub_plans``) in every batch, padding rows included
    (``ops.hub.run_hub_chunks``: past the batch they read its row 0)."""
    from pcgnn_tpu_torch.ops.hub import (HUB_BLOCK, HUB_CHUNK,
                                         epoch_hub_plans, hub_order)
    batches, _ = t.epoch_plan(0)
    rels = t.graph.relations
    plans = epoch_hub_plans(rels, batches)
    calls = []
    for bt in batches:
        for rel, plan in zip(rels, plans):
            if not plan:
                continue
            order = hub_order(rel.deg[bt], rel.deg[bt] > rel.window_width)
            order = torch.nn.functional.pad(
                order, (0, max(len(plan) * HUB_CHUNK - len(bt), 0)))
            for c, jb in enumerate(plan):
                rows = bt[order[c * HUB_CHUNK: (c + 1) * HUB_CHUNK]]
                calls.append((rel, rel.indptr[rows], jb * HUB_BLOCK))
    return calls


def ragged_case(name, col, starts_list, d, fill, rate: float) -> dict:
    """Times one ragged-gather shape over the calls in ``starts_list``
    (each [B]): the kernel alone (``launch`` on checked arguments), the
    plain version, and one PyTorch advanced-indexing gather of the same
    windows from ``col.unfold(0, d, 1)``.  ``*_ms`` is device time per
    call, ``*_run_ms`` the back-to-back run time.  The bound counts what a
    call must move: each id read once and written once, and the starts."""
    from pcgnn_tpu_torch.ops import ragged_gather as rg
    rows = len(starts_list[0])
    out = torch.empty((rows, d), dtype=torch.int32, device=col.device)
    table = col.unfold(0, d, 1)
    inside = [s.to(torch.int64).clamp(0, col.numel() - d)
              for s in starts_list]
    nbytes = 2 * rows * d * 4 + rows * starts_list[0].element_size()
    c = {"name": name, "rows": rows, "d": d, "bytes": nbytes,
         "bound_ms": nbytes / rate * 1e3}
    for key, fn, args in (
            ("ms", lambda s: rg.launch(col, s, out, fill),
             [(s,) for s in starts_list]),
            ("plain_ms", lambda s: rg.ragged_gather_plain(col, s, d, fill),
             [(s,) for s in starts_list]),
            ("library_ms", lambda i: table[i], [(i,) for i in inside])):
        c[key], c[key.replace("ms", "run_ms")] = time_ms(fn, args)
    return c


def queued_ragged(col, starts, d, fill, bound_ms: float) -> dict:
    """The ragged gather's call (``starts`` [B], width ``d``) timed by
    ``queued_ms``: the kernel alone (``launch`` into a fresh output), the
    plain version and the ``col.unfold`` indexing gather.  A hub chunk
    reads ~1 MB, so each of the run's calls reads its own copy of ``col``
    (one per queued call): the reads then come from memory, as in a
    step."""
    from pcgnn_tpu_torch.ops import ragged_gather as rg
    from pcgnn_tpu_torch.utils.roofline import KERNEL_CALLS
    cols = [col.clone() for _ in range(KERNEL_CALLS)]
    inside = starts.to(torch.int64).clamp(0, col.numel() - d)
    rows = len(starts)

    def kernel(c, s):
        out = torch.empty((rows, d), dtype=torch.int32, device=c.device)
        rg.launch(c, s, out, fill)
        return out

    sets = [(c, starts) for c in cols]
    q = {"rows": rows, "d": d, "copies": len(cols)}
    for key, fn, args, bnd in (
            ("", kernel, sets, bound_ms),
            ("plain_", lambda c, s: rg.ragged_gather_plain(c, s, d, fill),
             sets, None),
            ("library_", lambda c: c.unfold(0, d, 1)[inside],
             [(c,) for c in cols], None)):
        r = queued_ms(fn, args, bnd, f"ragged_gather {key}[{rows}, {d}]")
        q[key + "ms"], q[key + "readings_ms"] = r["ms"], r["readings_ms"]
    return q


# the choose kernel's shapes in the kernels line: the benchmark cells'
# sections of the fused records, (rows, F, relation widths); YelpChi's are
# 16-byte aligned, Amazon's (F = 25, rows of 23,925 floats) are not
CHOOSE_SHAPES = {"pcgnn-yelpchi": (1024, 32, (17, 49, 200)),
                 "pcgnn-amazon": (256, 25, (52, 700, 205))}


def choose_phase(rate: float) -> dict:
    """The choose kernel (``csrc/choose_window.cu``) at ``CHOOSE_SHAPES``,
    the three relations of a batch in turn as the training step calls it
    (keep masks written), every slot valid and keff = ceil(D / 2): equal
    to the plain version (keep and counts exactly, sums within rtol 1e-6),
    then timed by ``queued_ms`` over records that exceed the L2 together,
    beside the plain version (``time_ms``: its kernels' own time).  The
    bound counts the records read once and the sums, counts and keep masks
    written once, over ``rate``.  Returns the kernels-line entry."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    dev = torch.device("cuda")
    cells = {}
    for cell, (rows, f, widths) in CHOOSE_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(rows + f)
        width = sum(widths) * f
        sets = max(2, math.ceil(100e6 / (rows * width * 4)))
        recs = [(torch.rand((rows, width), generator=gen, device=dev) + 0.5)
                .to(torch.bfloat16).float() for _ in range(sets)]
        w0 = torch.randn((f, 2), generator=gen, device=dev)[:, 0]
        b0 = torch.randn(2, generator=gen, device=dev)[0]
        center = torch.randn(rows, generator=gen, device=dev)
        rels, off = [], 0
        for d in widths:
            deg = torch.full((rows,), d, dtype=torch.int32, device=dev)
            rels.append((off, d, deg, (deg + 1) // 2))
            off += d * f

        def each(fn):
            def call(rec):
                return [fn(rec[:, o: o + d * f], d, f, center, w0, b0, deg, k)
                        for o, d, deg, k in rels]
            return call

        kernel = each(agg.choose_window_sum)
        plain = each(agg.choose_window_sum_plain)
        for got, want in zip(kernel(recs[0]), plain(recs[0])):
            if not (torch.equal(got[2], want[2])
                    and torch.equal(got[1], want[1])
                    and torch.allclose(got[0], want[0], rtol=1e-6, atol=0)):
                raise AssertionError(f"choose_window at {cell} differs from "
                                     f"its plain version")
        nbytes = rows * (width * 4 + sum(f * 4 + 4 + d for d in widths)
                         + 12 * len(widths))
        bound_ms = nbytes / rate * 1e3
        args = [(r,) for r in recs]
        q = queued_ms(kernel, args, bound_ms, f"choose_window {cell}")
        # the plain version launches some forty kernels a relation, more
        # than the card's queue holds for a queued run: back to back
        plain_ms, plain_run_ms = time_ms(plain, args * 4)
        cells[cell] = {"rows": rows, "f": f, "widths": list(widths),
                       "bytes": nbytes, "bound_ms": bound_ms, "ms": q["ms"],
                       "readings_ms": q["readings_ms"], "plain_ms": plain_ms,
                       "plain_run_ms": plain_run_ms}
    first = cells["pcgnn-yelpchi"]
    return {"name": "choose_window", "route": "cuda",
            "source": "pcgnn_tpu_torch/csrc/choose_window.cu",
            "replaces": "none: XLA ops (pcgnn_tpu/models/pcgnn.py:218, "
                        "ops/aggregate.py:216 and :674)",
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "range_ms": [first["readings_ms"][0], first["readings_ms"][-1]],
            "cells": cells}


# the ids source's shapes: the stress cell's CSR lane, (rows, F, table
# rows, relation widths, mean degrees of the draws with the self-loop),
# and the score kernel's train-positive table, (P, F)
CHOOSE_IDS_SHAPES = {"pcgnn-stress10m": (1024, 64, 10_000_000, (36, 23, 14),
                                         (13, 7, 3))}
SCORE_SHAPES = {"pcgnn-stress10m": (200_000, 64)}


def choose_ids_phase(rate: float) -> tuple[dict, dict]:
    """The choose kernel's ids source (``choose_ids_sum``) at
    ``CHOOSE_IDS_SHAPES``: a float32 table of the cell's rows, batches of
    random rows whose degrees are Poisson at the relations' means
    (capped at their widths), random neighbor ids and padding N past the
    table, keff = ceil(deg / 2); the three relations in turn, as the step
    calls them.  Equal to the plain version (keep and counts exactly,
    sums within rtol 1e-6), then timed by ``queued_ms`` over batches whose
    rows exceed the L2 together, beside the plain version (``time_ms``).
    The bound counts each valid slot's row and id read once, a row's
    degree, keep count and center, and the sums, counts and keep masks
    written once.  Then ``selection_score`` at ``SCORE_SHAPES`` (the
    kernel queued over copies of the table, beside the float64 expression
    it replaced), checked against that expression to an ulp.  Returns the
    kernels-line entries of both kernels."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    dev = torch.device("cuda")
    cells, scores = {}, {}
    for cell, (rows, f, n, widths, means) in CHOOSE_IDS_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(rows + f)
        xs = torch.rand((n, f), generator=gen, device=dev) + 0.5
        w0 = torch.randn((f, 2), generator=gen, device=dev)[:, 0]
        b0 = torch.randn(2, generator=gen, device=dev)[0]
        sets, nbytes = [], 0
        for _ in range(30):
            center = torch.randn(rows, generator=gen, device=dev)
            rels = []
            for d, mean in zip(widths, means):
                deg = torch.poisson(torch.full((rows,), float(mean),
                                               device=dev), gen)
                deg = deg.clamp(1, d).to(torch.int32)
                nbr = torch.randint(0, n, (rows, d), generator=gen,
                                    device=dev, dtype=torch.int32)
                valid = torch.arange(d, device=dev) < deg[:, None]
                rels.append((torch.where(valid, nbr, n), deg,
                             (deg + 1) // 2))
                nbytes += (int(deg.sum()) * (f * 4 + 4)
                           + rows * (12 + f * 4 + 4 + d))
            sets.append((center, rels))
        nbytes //= len(sets)

        def each(fn):
            def call(center, rels):
                return [fn(xs, nbr, f, center, w0, b0, deg, k)
                        for nbr, deg, k in rels]
            return call

        kernel = each(agg.choose_ids_sum)
        plain = each(agg.choose_ids_sum_plain)
        for got, want in zip(kernel(*sets[0]), plain(*sets[0])):
            if not (torch.equal(got[2], want[2])
                    and torch.equal(got[1], want[1])
                    and torch.allclose(got[0], want[0], rtol=1e-6, atol=0)):
                raise AssertionError(f"choose_window_ids at {cell} differs "
                                     f"from its plain version")
        bound_ms = nbytes / rate * 1e3
        q = queued_ms(kernel, sets, bound_ms, f"choose_window_ids {cell}")
        plain_ms, plain_run_ms = time_ms(plain, sets)
        cells[cell] = {"rows": rows, "f": f, "table_rows": n,
                     "widths": list(widths), "mean_degrees": list(means),
                     "bytes": nbytes, "bound_ms": bound_ms, "ms": q["ms"],
                     "readings_ms": q["readings_ms"], "plain_ms": plain_ms,
                     "plain_run_ms": plain_run_ms}
        del xs, sets
    for cell, (p, f) in SCORE_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(p + f)
        tables = [torch.randn((p, f), generator=gen, device=dev)
                  for _ in range(4)]
        w0 = torch.randn((f, 2), generator=gen, device=dev)[:, 0]
        b0 = torch.randn(2, generator=gen, device=dev)[0]

        def expression(x):
            return (x.double() @ w0.double() + b0.double()).float()

        got, want = agg.selection_score(tables[0], w0, b0), expression(
            tables[0])
        ulp = torch.finfo(torch.float32).eps * want.abs()
        if not bool(((got - want).abs() <= ulp).all()):
            raise AssertionError(f"selection_score at {cell} differs from "
                                 f"the float64 expression")
        bound_ms = p * (f + 1) * 4 / rate * 1e3
        q = queued_ms(lambda x: agg.selection_score(x, w0, b0),
                      [(x,) for x in tables], bound_ms,
                      f"selection_score {cell}")
        plain_ms, plain_run_ms = time_ms(expression,
                                         [(x,) for x in tables] * 4)
        scores[cell] = {"rows": p, "f": f, "bound_ms": bound_ms,
                        "ms": q["ms"], "readings_ms": q["readings_ms"],
                        "plain_ms": plain_ms, "plain_run_ms": plain_run_ms}

    def entry(name, replaces, cells):
        first = cells["pcgnn-stress10m"]
        return {"name": name, "route": "cuda",
                "source": "pcgnn_tpu_torch/csrc/choose_window.cu",
                "replaces": replaces, "ms": first["ms"],
                "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "range_ms": [first["readings_ms"][0],
                             first["readings_ms"][-1]],
                "cells": cells}

    return (entry("choose_window_ids",
                  "none: XLA ops (pcgnn_tpu/models/pcgnn.py:218, "
                  "ops/aggregate.py:216 and :674)", cells),
            entry("selection_score",
                  "none: an XLA dot (pcgnn_tpu/models/pcgnn.py:215)", scores))


# the oversample kernel's shapes in the kernels line: the benchmark cells'
# steps, (rows, F, relation widths, train positives P, m_max): YelpChi's
# window of 2C = 256 sorted entries, Amazon's dense form over all P
OVERSAMPLE_SHAPES = {"pcgnn-yelpchi": (1024, 32, (17, 49, 200), 2665, 50),
                     "pcgnn-amazon": (256, 25, (52, 700, 205), 330, 175)}


def oversample_phase(rate: float) -> dict:
    """The oversample kernel (``csrc/oversample_minors.cu``) at
    ``OVERSAMPLE_SHAPES``: a step's minors of every relation as the training
    step calls it (ids read through the [N, D] neighbor tables at the
    batch, half the rows fraud, each row's sample count up to twice its
    relation's window, keep masks of about half the slots), equal to the
    plain version (counts exactly, sums within rtol 1e-6), then timed by
    ``queued_ms`` over argument sets whose neighbor tables exceed the L2
    together, beside the plain version (``time_ms``: its kernels' own
    time).  The bound counts what the fraud rows need, read once: their
    window's scores and slots, the ids and rows of the candidates they take
    at most, each relation's keep flags and ids, sample count and degree,
    and the sums read and written; the other rows' labels.  Returns the
    kernels-line entry."""
    from pcgnn_tpu_torch.graph.csr import RelGraph
    from pcgnn_tpu_torch.ops import aggregate as agg
    dev = torch.device("cuda")
    cells = {}
    for cell, (rows, f, widths, p, m_max) in OVERSAMPLE_SHAPES.items():
        gen = torch.Generator(device=dev).manual_seed(rows + f)
        n = 50_000
        z = torch.zeros(1, dtype=torch.int32, device=dev)
        tp = torch.randperm(n, generator=gen, device=dev)[:p]
        tpv = torch.ones(p, dtype=torch.bool, device=dev)
        tp_s0 = torch.randn(p, generator=gen, device=dev)
        tp_rows = torch.rand((p, f), generator=gen, device=dev) + 0.5
        center = torch.randn(rows, generator=gen, device=dev)
        labels = torch.arange(rows, device=dev) % 2
        sets = max(2, math.ceil(100e6 / (n * sum(widths) * 4)))
        arg_sets = []
        for _ in range(sets):
            batch = torch.randperm(n, generator=gen, device=dev)[:rows]
            rels, sums = [], []
            for d in widths:
                rel = RelGraph(
                    indptr=z, col=z,
                    deg=torch.full((n,), d, dtype=torch.int32, device=dev),
                    keff=z, ksample=torch.randint(
                        0, 2 * d, (n,), generator=gen, device=dev,
                        dtype=torch.int32), num_nodes=n, num_edges=0,
                    dmax=d, dcap=d, nbr2d=torch.randint(
                        0, n, (n, d), generator=gen, device=dev,
                        dtype=torch.int32))
                keep = torch.rand((rows, d), generator=gen, device=dev) < 0.5
                rels.append((rel, None, keep))
                sums.append((torch.zeros((rows, f), device=dev),
                             torch.zeros(rows, device=dev)))
            arg_sets.append((batch, rels, sums))

        def each(fn):
            def call(batch, rels, sums):
                fn(center, tp_s0, tp, tpv, tp_rows, m_max, batch, labels, 0.5,
                   rels, sums)
                return sums
            return call

        # the kernel alone: the train positives' sort, which the step
        # shares with the hub lane, is taken once here
        ranked = agg.rank_train_positives(tp_s0, tpv)
        kernel = each(lambda *a: agg.oversample_minor_sums(*a, ranked=ranked))
        plain = each(agg.oversample_minor_sums_plain)
        batch, rels, sums = arg_sets[0]
        got = kernel(batch, rels, [(a.clone(), c.clone()) for a, c in sums])
        want = plain(batch, rels, [(a.clone(), c.clone()) for a, c in sums])
        for (gn, gc), (wn, wc) in zip(got, want):
            if not (torch.equal(gc, wc)
                    and torch.allclose(gn, wn, rtol=1e-6, atol=0)):
                raise AssertionError(f"oversample_minors at {cell} differs "
                                     f"from its plain version")
        fraud = int((labels == 1).sum())
        window = p if 2 * m_max >= p else min(
            p, 2 * max(128, -(-2 * m_max // 128) * 128))
        nbytes = (rows * 8 + fraud * (
            16 + window * 12 + m_max * (8 + 4 * f)
            + sum(d * 5 + 8 + 8 * f + 8 for d in widths)))
        bound_ms = nbytes / rate * 1e3
        q = queued_ms(kernel, arg_sets, bound_ms, f"oversample_minors {cell}")
        # the plain version launches some sixty kernels a step, more than
        # the card's queue holds for a queued run: back to back
        plain_ms, plain_run_ms = time_ms(plain, arg_sets * 4)
        cells[cell] = {"rows": rows, "f": f, "widths": list(widths), "p": p,
                       "m_max": m_max, "window": window, "bytes": nbytes,
                       "bound_ms": bound_ms, "ms": q["ms"],
                       "readings_ms": q["readings_ms"], "plain_ms": plain_ms,
                       "plain_run_ms": plain_run_ms}
    first = cells["pcgnn-yelpchi"]
    return {"name": "oversample_minors", "route": "cuda",
            "source": "pcgnn_tpu_torch/csrc/oversample_minors.cu",
            "replaces": "none: XLA ops (pcgnn_tpu/ops/aggregate.py:347, "
                        ":466, :551 and :739)",
            "ms": first["ms"], "plain_ms": first["plain_ms"],
            "bound_ms": first["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "range_ms": [first["readings_ms"][0], first["readings_ms"][-1]],
            "cells": cells}


def ragged_phase(t, rate: float) -> tuple[dict, dict]:
    """Phase 7: the ragged-gather kernel against its plain version at the
    hub lane's real calls on yelp-skew and at edge cases, and its timings.
    Returns (kernels-line entry, details)."""
    from pcgnn_tpu_torch.ops import ragged_gather as rg
    from pcgnn_tpu_torch.ops.hub import HUB_BLOCK, HUB_CHUNK
    g, dev = t.graph, t.device
    calls = hub_chunk_calls(t)
    if not calls:
        raise AssertionError("the first yelp-skew epoch has no hub rows")
    errs = [check_ragged(rel.col, st, w, rel.num_nodes)
            for rel, st, w in calls]
    # edge cases: ragged B, repeated rows, starts near and past the end of
    # col and negative, int64 starts, widths that are not multiples of 128
    rel = max((r for r in g.relations if r.has_hubs),
              key=lambda r: r.num_edges)
    e = rel.col.numel()
    gen = torch.Generator(device=dev).manual_seed(0)
    edge = torch.randint(0, e, (7,), generator=gen, device=dev)
    edge[:4] = torch.tensor([e - 3, e - 3, -2, e + 5], device=dev)
    for st in (edge, edge.to(torch.int32)):
        for d in (1, 100, 1000, HUB_BLOCK, 40 * HUB_BLOCK):
            errs.append(check_ragged(rel.col, st, d, g.num_nodes))

    details = {"calls_per_epoch": len(calls),
               "widths": sorted({w for _, _, w in calls}), "cases": []}

    def case(name, col, starts, d):
        c = ragged_case(name, col, [starts] * TIMING_REPS, d, g.num_nodes,
                        rate)
        details["cases"].append(c)
        return c

    # the hub lane's widest real call, and one block of it (the width of
    # one TPU kernel call)
    wrel, wst, ww = max(calls, key=lambda c: (c[2], len(c[1])))
    main = case("widest_chunk", wrel.col, wst, ww)
    case("one_block", wrel.col, wst, HUB_BLOCK)
    # the launch floor: the same kernel copying 1 row of 1 id
    floor = case("launch_floor", wrel.col, wst[:1], 1)
    # the bound of the calls the path makes: the mean over the epoch's
    # real calls (each id read and written once, and the starts)
    path_bytes = [2 * len(st) * w * 4 + len(st) * st.element_size()
                  for _, st, w in calls]
    details["path_bound_ms"] = float(np.mean(path_bytes)) / rate * 1e3
    q = queued_ragged(wrel.col, wst, ww, g.num_nodes, main["bound_ms"])
    details["queued"] = q
    entry = {"name": "ragged_gather", "route": "cuda",
             "source": "pcgnn_tpu_torch/csrc/ragged_gather.cu",
             "replaces": "pcgnn_tpu/ops/pallas/ragged_gather.py:112",
             "launches": None, "max_abs_err": max(errs), "exact": True,
             "ms": q["ms"], "plain_ms": q["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": "bytes",
             "library_ms": q["library_ms"],
             "range_ms": [q["readings_ms"][0], q["readings_ms"][-1]],
             "profiler_ms": main["ms"], "profiler_plain_ms": main["plain_ms"],
             "profiler_library_ms": main["library_ms"],
             "floor_ms": floor["ms"],
             "path_bound_ms": details["path_bound_ms"]}
    details["chunk"] = HUB_CHUNK
    return entry, details


def check_mask(ids, keep, n, mids=None, kmin=None) -> float:
    """Mask-build kernel against its plain version on the card, mask and
    counts, and the counts against the mask's row sums; returns max |err|.
    The kernel writes 0s, 1s and integer counts: anything but equality
    fails."""
    from pcgnn_tpu_torch.ops.mask_build import (
        build_batch_mask_counts, build_batch_mask_counts_plain)
    out, counts = build_batch_mask_counts(ids, keep, n, mids, kmin)
    ref, ref_counts = build_batch_mask_counts_plain(ids, keep, n, mids, kmin)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max()) if out.numel() else 0.0
    if counts.numel():
        err = max(err, float((counts - ref_counts).abs().max()))
    if not (torch.equal(out, ref) and torch.equal(counts, ref_counts)
            and torch.equal(counts, out.sum(1))):
        raise AssertionError(f"mask_build disagrees with its plain version "
                             f"(B={ids.shape[0]}, S={ids.shape[1]}, N={n}, "
                             f"minors {None if kmin is None else kmin.shape}"
                             f", max |err| {err})")
    return err


def mask_calls(t) -> list:
    """The mask builds the learned lane asks for over the first epoch's
    training batches: (relation index, ids [B, D], keep, minor ids [B, M],
    keep_minor), recorded from the model's own forward (no gradients)."""
    from pcgnn_tpu_torch.ops import aggregate
    model = t.new_model()
    batches, _ = t.epoch_plan(0)
    calls = []
    real = aggregate.build_batch_mask_counts

    def record(ids, keep, n, mids=None, kmin=None):
        calls.append((len(calls) % t.graph.num_relations, ids.clone(),
                      keep.clone(), mids.clone(), kmin.clone()))
        return real(ids, keep, n, mids, kmin)

    aggregate.build_batch_mask_counts = record
    try:
        with torch.no_grad():
            for bt in batches:
                model(t.graph, bt, t.graph.labels[bt], train=True,
                      train_pos=t.consts["tp"],
                      train_pos_valid=t.consts["tpv"])
    finally:
        aggregate.build_batch_mask_counts = real
    return calls


def mask_phase(t, rate: float) -> tuple[dict, dict]:
    """Phase 12: the mask-build kernel against its plain version at the
    learned lane's real calls on yelp-like and at edge cases, and its
    timings.  Returns (kernels-line entry, details)."""
    from pcgnn_tpu_torch.ops import mask_build as mb
    g, dev = t.graph, t.device
    n = g.num_nodes
    calls = mask_calls(t)
    errs = [check_mask(ids, keep, n, mids, kmin)
            for _, ids, keep, mids, kmin in calls]
    # edge cases: N at every residue mod 4, small, one past a chunk of the
    # old tile and past one bitmap chunk; duplicates, ids outside [0, N),
    # all-dropped and sentinel-only rows; B = 1; S = 0
    gen = torch.Generator(device=dev).manual_seed(0)
    for rows, slots, nn in ((1, 300, 45_953), (7, 18, 7), (33, 500, 8193),
                            (1024, 290, 5000), (1, 0, 12), (5, 0, 8192),
                            (64, 265, 45_952), (64, 265, 45_955),
                            (3, 400, 300_000)):
        ids = torch.randint(-2, nn + 2, (rows, slots), generator=gen,
                            device=dev, dtype=torch.int32)
        keep = torch.randint(0, 2, (rows, slots), generator=gen,
                             device=dev, dtype=torch.int32).bool()
        if slots > 1:
            ids[:, 1] = ids[:, 0]
            keep[:, :2] = True
        if rows > 2:
            keep[0] = False
            ids[1] = nn
            keep[1] = True
        errs.append(check_mask(ids, keep, nn))
    # minors shared by every row ([M], row stride 0) as the JAX package's
    # callers may pass them: row 0's last window ids, the last one kept in
    # both groups
    _, ids, keep, _, _ = calls[0]
    mids = ids[0, -8:].clone()
    km = torch.ones((ids.shape[0], 8), dtype=torch.bool, device=dev)
    keep = keep.clone()
    keep[:, -1] = True
    errs.append(check_mask(ids, keep, n, mids, km))
    # the two column groups read in place give the build over the
    # concatenated columns
    _, ids, keep, mids, kmin = calls[-1]
    two = mb.build_batch_mask_counts(ids, keep, n, mids, kmin)
    cat = mb.build_batch_mask_counts(torch.cat([ids, mids], 1),
                                     torch.cat([keep, kmin], 1), n)
    if not all(torch.equal(a, b) for a, b in zip(two, cat)):
        raise AssertionError("the two-group mask build disagrees with the "
                             "build over the concatenated columns")

    details = {"calls_per_epoch": len(calls), "counts_checked": len(errs),
               "slots": sorted({(int(c[1].shape[1]), int(c[3].shape[1]))
                                for c in calls}),
               "cases": []}

    def case(name, ids, keep, mids, kmin):
        """Times one call shape: the kernel alone (``launch`` on checked
        arguments), the plain version, and one PyTorch ``scatter_`` of
        ones into a zeroed [B, N+1] buffer (the two groups' ids
        concatenated and folded to the sentinel beforehand; it gives no
        counts).  ``*_ms`` is device time per call, ``*_run_ms`` the
        back-to-back run time.  Each call writes another output than the
        call before (the kernel alternates two, the library call's last
        result is held), so no call rewrites lines still dirty in L2."""
        rows, slots = ids.shape
        minors = kmin.shape[1]
        outs = [(torch.empty((rows, n), dtype=torch.float32, device=dev),
                 torch.empty(rows, dtype=torch.float32, device=dev))
                for _ in range(2)]
        held = [None]
        folded = torch.where(torch.cat([keep, kmin], 1),
                             torch.cat([ids, mids], 1), n).long()

        def library():
            held[0] = torch.zeros((rows, n + 1), device=dev).scatter_(
                1, folded, 1.0)[:, :n]

        # bytes the build must move: the mask and the counts written once,
        # each id (4 bytes) and keep flag (1 byte) of both groups read once
        nbytes = rows * n * 4 + rows * 4 + rows * (slots + minors) * 5
        c = {"name": name, "rows": rows, "slots": slots, "minors": minors,
             "n": n, "bytes": nbytes, "bound_ms": nbytes / rate * 1e3}
        reps = [(i,) for i in range(TIMING_REPS)]
        for key, fn in (
                ("ms", lambda i: mb.launch(ids, keep, *outs[i % 2], mids,
                                           kmin)),
                ("plain_ms", lambda i: mb.build_batch_mask_counts_plain(
                    ids, keep, n, mids, kmin)),
                ("library_ms", lambda i: library())):
            c[key], c[key.replace("ms", "run_ms")] = time_ms(fn, reps)
        details["cases"].append(c)
        return c

    for r in range(g.num_relations):
        _, ids, keep, mids, kmin = next(c for c in calls if c[0] == r)
        main = case(f"relation_{r}", ids, keep, mids, kmin)  # the widest
    # the widest relation's calls over the epoch, queued ahead of the card
    # with every mask's write-back inside the run
    q = queued_mask([c[1:] for c in calls if c[0] == r], n,
                    main["bound_ms"])
    details["queued"] = q
    entry = {"name": "mask_build", "route": "cuda",
             "source": "pcgnn_tpu_torch/csrc/mask_build.cu",
             "replaces": "pcgnn_tpu/ops/pallas/mask_build.py:79",
             "launches": None, "max_abs_err": max(errs), "exact": True,
             "ms": q["ms"], "plain_ms": q["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": "bytes",
             "library_ms": q["library_ms"],
             "range_ms": [q["readings_ms"][0], q["readings_ms"][-1]],
             "profiler_ms": main["ms"], "profiler_plain_ms": main["plain_ms"],
             "profiler_library_ms": main["library_ms"]}
    return entry, details


def queued_mask(calls: list, n: int, bound_ms: float) -> dict:
    """Mask builds at ``calls`` ([(ids, keep, minor ids, keep_minor)], one
    relation's over an epoch) timed by ``queued_ms``: the kernel alone
    (``launch`` into fresh outputs), the plain version, and the ``scatter_``
    of ones into a zeroed [B, N+1] buffer (no counts)."""
    from pcgnn_tpu_torch.ops import mask_build as mb
    dev = calls[0][0].device

    def kernel(ids, keep, mids, kmin):
        out = torch.empty((ids.shape[0], n), dtype=torch.float32, device=dev)
        counts = torch.empty(ids.shape[0], dtype=torch.float32, device=dev)
        mb.launch(ids, keep, out, counts, mids, kmin)
        return out, counts

    def library(folded):
        return torch.zeros((folded.shape[0], n + 1), device=dev).scatter_(
            1, folded, 1.0)[:, :n]

    folded = [(torch.where(torch.cat([keep, kmin], 1),
                           torch.cat([ids, mids], 1), n).long(),)
              for ids, keep, mids, kmin in calls]
    q = {"calls": len(calls), "rows": int(calls[0][0].shape[0]), "n": n}
    for key, fn, args, bnd in (
            ("", kernel, calls, bound_ms),
            ("plain_", lambda *a: mb.build_batch_mask_counts_plain(
                a[0], a[1], n, a[2], a[3]), calls, None),
            ("library_", library, folded, None)):
        r = queued_ms(fn, args, bnd, f"mask_build {key}")
        q[key + "ms"], q[key + "readings_ms"] = r["ms"], r["readings_ms"]
    return q


def csr_branch_phase(t) -> dict:
    """Phase 15, second part: one learned forward with every relation's
    dense neighbor table dropped, so ``batch_neighbor_window`` reads the
    CSR through the ragged gather.  The ids are the table's, so the logits
    must be equal, not close."""
    from pcgnn_tpu_torch.ops import ragged_gather as rg
    g = t.graph
    csr_graph = dataclasses.replace(g, relations=tuple(
        dataclasses.replace(r, nbr2d=None) for r in g.relations))
    model = t.new_model()
    batches, _ = t.epoch_plan(0)
    bt = batches[0]
    kw = dict(train_pos=t.consts["tp"], train_pos_valid=t.consts["tpv"])
    with torch.no_grad():
        want = model(g, bt, g.labels[bt], train=True, **kw)
        before = rg.launches
        got = model(csr_graph, bt, g.labels[bt], train=True, **kw)
        torch.cuda.synchronize()
    launched = rg.launches - before
    if launched != g.num_relations:
        raise AssertionError(f"the CSR branch launched {launched} ragged "
                             f"gathers, expected {g.num_relations}")
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"the CSR-branch forward differs from the "
                                 f"table's by {float((a - b).abs().max())}")
    return {"ragged_launches": launched, "equal": True}


class LaunchCounter:
    """One more launch counter of a kernel wrapper module, under the name
    ``launches`` that a module of one kernel gives its own: reading and
    writing it reads and writes the module's ``attr``."""

    def __init__(self, mod, attr: str):
        self.mod, self.attr = mod, attr

    @property
    def launches(self) -> int:
        return getattr(self.mod, self.attr)

    @launches.setter
    def launches(self, n: int) -> None:
        setattr(self.mod, self.attr, n)


def kernel_counters() -> dict:
    """Every kernel of the package, by kernel name: its wrapper module, or
    a ``LaunchCounter`` where one module launches several kernels (the
    choose kernel's ids source and the score kernel)."""
    from pcgnn_tpu_torch.ops import (choose_window, mask_build,
                                     oversample_minors, ragged_gather,
                                     window_gather)
    return {"window_gather": window_gather, "ragged_gather": ragged_gather,
            "mask_build": mask_build, "choose_window": choose_window,
            "choose_window_ids": LaunchCounter(choose_window, "ids_launches"),
            "selection_score": LaunchCounter(choose_window, "score_launches"),
            "oversample_minors": oversample_minors}


# each counted kernel's name in a profile, where it is not ``<name>_kernel``:
# the choose kernel's two row sources are one template, told apart by the
# source's type
DEVICE_KERNELS = {"choose_window": ("choose_window_kernel", "::Records>"),
                  "choose_window_ids": ("choose_window_kernel", "::Ids>"),
                  "selection_score": ("score_rows_kernel",)}


def runs_kernel(name: str, key: str) -> bool:
    """Whether the profile's kernel ``key`` is the counted kernel ``name``."""
    return all(s in key for s in DEVICE_KERNELS.get(name, (f"{name}_kernel",)))


def choose_launches_per_step(t) -> dict:
    """Choose kernels one forward of ``t`` launches, by source: a PC-GNN
    forward on frozen features chooses each relation in one launch, from
    the relation's store where the model reads it (``choose_window``) and
    through the neighbor ids otherwise (``choose_window_ids``); the
    learned lane and the baselines launch neither."""
    if not t.is_pcgnn or t.learn_features:
        return {"choose_window": 0, "choose_window_ids": 0}
    rels = t.graph.relations
    from_window = scores_from_window(t.graph)
    stored = sum(r.ewin is not None and from_window for r in rels)
    return {"choose_window": stored, "choose_window_ids": len(rels) - stored}


def scores_from_window(g) -> bool:
    """Whether a PC-GNN forward on frozen features scores the rows it
    reads (every relation stored, or a graph at stress scale) rather than
    the whole table, as ``PCGNN.forward`` decides."""
    from pcgnn_tpu_torch.models.pcgnn import SCORE_FROM_WINDOW_MIN_NODES
    return (all(r.ewin is not None for r in g.relations)
            or g.num_nodes >= SCORE_FROM_WINDOW_MIN_NODES)


class StepEvents:
    """A ``StepRunner.step_hook``: CUDA events at each step's start and
    end, and the launches of the kernels each step ran (the runner's
    captured step's: the warm-up step runs what the capture records, and
    a replay what it recorded)."""

    def __init__(self, runner):
        import weakref
        # no reference cycle: a dead runner must go with its graph at once
        self.runner = weakref.proxy(runner)
        self.events, self.launches = [], []

    def __call__(self, what: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if what == "start":
            self.events.append([ev, None])
            return
        self.events[-1][1] = ev
        self.launches.append(dict(self.runner.replay_launches)
                             if self.runner.capture else None)

    def step_ms(self) -> list:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.events]


@contextlib.contextmanager
def runners_made():
    """Every runner made while the block runs: each ``StepRunner`` (the
    trainer's epochs and ``single_step``), timed by a ``StepEvents``, and
    each ``PredictRunner`` (its evaluations), with no hook."""
    from pcgnn_tpu_torch.train.capture import GraphRunner, StepRunner
    made = []
    real = GraphRunner.__init__

    def init(self, *args, **kw):
        real(self, *args, **kw)
        if isinstance(self, StepRunner):
            self.step_hook = StepEvents(self)
        made.append(self)

    GraphRunner.__init__ = init
    try:
        yield made
    finally:
        GraphRunner.__init__ = real


def step_runners(runners) -> list:
    """The ``StepRunner``s of ``runners_made``'s list."""
    return [r for r in runners if r.step_hook is not None]


def card_launches(counts: dict, runners) -> dict:
    """The kernel launches the card ran, from the wrappers' ``counts``
    over a block: a wrapper counts its call at a capture, which records
    the launch and runs nothing, and not at a replay, which runs what was
    recorded."""
    out = dict(counts)
    for r in runners:
        out = r.card_launches(out)
    return out


def run_name(t) -> str:
    """The configuration's name in this script's output."""
    name = t.config["data_name"]
    if not t.is_pcgnn:
        name += " " + t.model_name
    if t.learn_features:
        name += " learned"
    elif not t.config.get("edge_windows", True):
        name += " no stores"
    return name


def aggregated_relations(t) -> tuple:
    """The relations a model aggregates over: PC-GNN's, or the homo graph
    of GCN and GraphSAGE."""
    return t.graph.relations if t.is_pcgnn else (t.graph.homo,)


def window_launches_per_step(t) -> int:
    """Window gathers one training step of ``t`` launches: one fused record
    fetch, or one per relation store, or one on the homo store of a
    baseline; none without stores."""
    g = t.graph
    if t.learn_features or not t.config.get("edge_windows", True):
        return 0
    if not t.is_pcgnn:
        return int(g.homo.ewin is not None)
    if g.fused is not None:
        return 1
    return sum(r.ewin is not None for r in g.relations)


def eval_batches(t) -> int:
    """Batches of one validation evaluate."""
    return -(-len(t.idx_valid) // t.batch_size)


def hub_rows(t, batch) -> int:
    """Rows of ``batch`` above their relation's window cap, summed over
    the aggregated relations that have hubs."""
    return sum(int((rel.deg[batch] > rel.window_width).sum())
               for rel in aggregated_relations(t) if rel.has_hubs)


def main_path_phase(t) -> dict:
    """Phases 3, 8, 13, 16, 17, 18 and 24: the configuration's epochs of
    training through ``Trainer.run_epoch`` -- the first step eager (the
    warm-up), the graph captured, every other step a replay of it -- then
    one validation evaluate through ``Trainer.evaluate`` (the forward
    captured the same way, a replay a batch); every kernel count is 0 just
    before.  Each step's kernels are the captured step's: the warm-up and
    the capture each call every wrapper once per launch of the step, and
    nothing else in the training calls one.  Every step must launch the
    window gathers its lane reads (``window_launches_per_step``), and
    every step with a hub row the ragged gather.  Every step and
    validation batch launches the choose kernel once a relation, from the
    store or through the ids as ``choose_launches_per_step`` says, and
    every PC-GNN one the score kernel.  Every learned-lane step and
    validation batch launches the mask build once per relation and no
    gather, and the table must move.  ``launches`` are what the card ran
    (``card_launches`` over the step's and the forward's runners)."""
    from pcgnn_tpu_torch.bench import edges_per_epoch
    mods = kernel_counters()
    want_wg = window_launches_per_step(t)
    want_choose = choose_launches_per_step(t)
    nrel = t.graph.num_relations
    model = t.new_model()
    opt = t.new_optimizer(model)
    runner = t.runner(model, opt)
    if not runner.capture:
        raise AssertionError(f"{run_name(t)} trains eagerly on the card")
    timer = runner.step_hook = StepEvents(runner)
    losses, hubs = [], []
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    for mod in mods.values():
        mod.launches = 0
    for epoch in range(t.config["epochs"]):
        hubs += [hub_rows(t, bt) for bt in t.epoch_plan(epoch)[0]]
        losses.append(float(t.run_epoch(model, opt, epoch)))
    step_ms = timer.step_ms()
    wrapper = {k: m.launches for k, m in mods.items()}
    if wrapper != {k: 2 * runner.captured_launches[k] for k in wrapper}:
        raise AssertionError(f"the wrappers counted {wrapper} outside the "
                             f"warm-up steps and captures "
                             f"{runner.captured_launches}")
    train_launches = card_launches(wrapper, [runner])
    per_step = timer.launches
    ragged = [n["ragged_gather"] for n in per_step]
    for n, h in zip(per_step, hubs):
        if n["window_gather"] != want_wg:
            raise AssertionError(f"a training step launched "
                                 f"{n['window_gather']} window_gather "
                                 f"kernels, expected {want_wg}")
        if t.learn_features and n["mask_build"] != nrel:
            raise AssertionError("a learned step did not launch the mask "
                                 "build once per relation")
        if h and not n["ragged_gather"]:
            raise AssertionError(f"a training step with {h} hub rows "
                                 f"launched no ragged_gather")
        if any(n[k] != c for k, c in want_choose.items()):
            raise AssertionError(f"a training step launched {n}, expected "
                                 f"{want_choose} choose kernels")
        if t.is_pcgnn and not n["selection_score"]:
            raise AssertionError("a PC-GNN step launched no score kernel")
    if len(per_step) != len(hubs) or runner.eager_steps + runner.replays \
            != len(hubs):
        raise AssertionError(f"{len(hubs)} steps ran as "
                             f"{runner.eager_steps} eager and "
                             f"{runner.replays} replays")
    t_eval = time.time()
    res = t.evaluate(model, t.idx_valid, t.y_valid, print_line=False)
    eval_s = time.time() - t_eval
    predictor = t.predict_runner(model)
    if not predictor.capture or predictor.captures != 1:
        raise AssertionError(f"{run_name(t)}'s validation was not one "
                             f"captured forward: {predictor.stats()}")
    launches = card_launches({k: m.launches for k, m in mods.items()},
                             [runner, predictor])
    forwards = len(step_ms) + eval_batches(t)
    if any(launches[k] != c * forwards for k, c in want_choose.items()):
        raise AssertionError(f"{forwards} training steps and validation "
                             f"batches launched {launches}, expected "
                             f"{want_choose} choose kernels each")
    if t.is_pcgnn and launches["selection_score"] < forwards:
        raise AssertionError(f"{forwards} training steps and validation "
                             f"batches launched the score kernel "
                             f"{launches['selection_score']} times")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not res.auc > 0.5:
        raise AssertionError(f"validation AUC {res.auc} is not above 0.5")
    embed_moved = None
    if t.learn_features:
        want = nrel * (len(step_ms) + eval_batches(t))
        if launches["mask_build"] != want:
            raise AssertionError(f"mask_build launched "
                                 f"{launches['mask_build']} times, expected "
                                 f"{want}")
        if launches["window_gather"] or launches["ragged_gather"]:
            raise AssertionError(f"the learned lane launched a gather: "
                                 f"{launches}")
        embed_moved = float((model.embed.detach() - t.graph.features)
                            .abs().max())
        if not embed_moved > 0:
            raise AssertionError("the learned table did not move")
    elif want_wg == 0 and launches["window_gather"]:
        raise AssertionError(f"a lane without stores launched the window "
                             f"gather: {launches}")
    steady = float(np.median(step_ms[1:]))
    st = runner.stats()
    # the graphs' pools go with them
    t._runner = t._predict_runner = None
    return {"data": run_name(t), "steps": len(step_ms),
            "step_ms": step_ms, "step_ms_median": steady,
            "losses": losses,
            "hub_rows_per_step": hubs, "ragged_launches_per_step": ragged,
            "window_launches_per_step": want_wg,
            "train_launches": train_launches, "launches": launches,
            "captures": st["captures"], "replays": st["replays"],
            "capture_s": st["capture_s"], "graph_pool_bytes":
                st["pool_bytes"], "hub_plans": st["plans"],
            "valid_auc": res.auc, "valid_f1_macro": res.f1_macro,
            "eval_batches": eval_batches(t), "eval_s": eval_s,
            "eval_capture_s": predictor.capture_s,
            "eval_graph_pool_bytes": predictor.pool_bytes,
            "embed_moved": embed_moved,
            "edges_per_s": edges_per_epoch(t)
            / (steady * 1e-3 * t.num_batches),
            "peak_mem_bytes": torch.cuda.max_memory_allocated(),
            # above what was resident before the first step (graphs,
            # stores, and any other run's trainer still alive)
            "step_peak_extra_bytes":
                torch.cuda.max_memory_allocated() - resident}


def count_syncs(fn) -> int:
    """Device-to-host synchronizations that ``fn()`` makes, as PyTorch's
    sync debug mode reports them."""
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def profile_phase(t, steps: int | None = None) -> dict:
    """Where a training step's time goes: one epoch of fused-lane steps
    (or its first ``steps``) under torch.profiler, after a warm-up step.
    Device time by kernel, the count of kernel launches, the share of the
    profiled wall time the card was busy, and (outside the profile) the
    host syncs of one step."""
    from torch.profiler import ProfilerActivity, profile
    model = t.new_model()
    opt = t.new_optimizer(model)
    batches, weights = t.epoch_plan(0)
    batches, weights = batches[:steps], weights[:steps]
    labels = [t.graph.labels[bt] for bt in batches]
    t.step(model, opt, batches[0], labels[0], weights[0])
    syncs = count_syncs(lambda: t.step(model, opt, batches[0], labels[0],
                                       weights[0]))
    # the hub lane reads its chunk plan back once per relation with hubs;
    # nothing else in a step reads from the card
    want_syncs = sum(rel.has_hubs for rel in aggregated_relations(t))
    if syncs != want_syncs:
        raise AssertionError(f"a {run_name(t)} step made {syncs} host syncs, "
                             f"expected {want_syncs}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for bt, y, wt in zip(batches, labels, weights):
            t.step(model, opt, bt, y, wt)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_kernels(prof)
    device_ms = sum(ms for _, ms, _ in busy)
    launch_calls = sum(e.count for e in prof.key_averages()
                       if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                    "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    steps = len(batches)
    out = {"data": run_name(t), "steps": steps,
           "wall_ms_per_step": wall_ms / steps,
           "device_ms_per_step": device_ms / steps,
           "busy_share": device_ms / wall_ms,
           "kernel_launches_per_step": launch_calls / steps,
           "host_syncs_per_step": syncs,
           # the profiled epoch's peak above what was resident before it
           "step_peak_extra_bytes":
               torch.cuda.max_memory_allocated() - resident,
           "hub_rows_per_step": [hub_rows(t, bt) for bt in batches],
           "top_device_ms_per_step": [(k, ms / steps, n / steps)
                                      for k, ms, n in busy[:15]],
           "top_host_ms_per_step": [(k, ms / steps, n / steps)
                                    for k, ms, n in host_ops(prof)[:15]]}
    # the hub lane's profiler range.  Its host entry holds the host time
    # inside the range and the device time of the kernels launched there;
    # its device entry spans the range on the card's timeline, idle gaps
    # included
    from torch.autograd import DeviceType
    lane_name = "hub_choose_sum" if t.is_pcgnn else "hub_mean_sum"
    lane = {e.device_type: e for e in prof.key_averages()
            if e.key == lane_name}
    host = lane.get(DeviceType.CPU)
    span = lane.get(DeviceType.CUDA)
    out["hub_lane_host_ms_per_step"] = (
        host.cpu_time_total / 1e3 / steps if host else 0.0)
    out["hub_lane_kernel_ms_per_step"] = (
        host.device_time_total / 1e3 / steps if host else 0.0)
    out["hub_lane_device_span_ms_per_step"] = (
        span.device_time_total / 1e3 / steps if span else 0.0)
    out["mask_sized_kernels_per_step"] = mask_sized_kernels(prof, steps)
    for name in kernel_counters():
        hit = [(ms, n) for k, ms, n in busy if runs_kernel(name, k)]
        out[f"{name}_device_ms_per_launch"] = (
            sum(ms for ms, _ in hit) / sum(n for _, n in hit) if hit else None)
        out[f"{name}_launches_per_step"] = sum(n for _, n in hit) / steps
        out[f"{name}_share"] = sum(ms for ms, _ in hit) / device_ms
    return out


def mask_sized_kernels(prof, reps: int) -> list:
    """[(name, launches per rep, us per launch)] of the kernel launches a
    torch.profiler run saw that took MASK_PASS_US or more each."""
    from torch.autograd import DeviceType
    long = {}
    for e in prof.events():
        if (e.device_type == DeviceType.CUDA and not e.is_user_annotation
                and e.device_time_total >= MASK_PASS_US):
            n, us = long.get(e.name, (0, 0.0))
            long[e.name] = (n + 1, us + e.device_time_total)
    return [(k, n / reps, us / n) for k, (n, us) in
            sorted(long.items(), key=lambda kv: -kv[1][1])]


def mask_pass_faults(kernels: list) -> list:
    """The reductions and elementwise kernels among ``mask_sized_kernels``:
    a row sum or a division over the mask, which the lane no longer runs."""
    return [k for k, _, _ in kernels
            if "reduce" in k.lower() or "elementwise" in k.lower()]


def aggregation_phase(t) -> dict:
    """Phase 14, second part: the aggregation of relation 2's first real
    call (build, GEMM, backward into the table) timed both ways in turns,
    old, new, new, old: the JAX package's ``(mask / mask.sum(1)) @ x`` and
    the port's ``(mask @ x) / counts`` with the kernel's counts.  Gives
    each one's device and run ms, its kernels by name, its peak memory
    above what was resident, and checks that both give the same values."""
    from torch.profiler import ProfilerActivity, profile
    from pcgnn_tpu_torch.ops.aggregate import (masked_mean_aggregate,
                                               scatter_batch_mask,
                                               scatter_batch_mask_counts)
    n = t.graph.num_nodes
    last = t.graph.num_relations - 1
    _, ids, keep, mids, kmin = next(c for c in mask_calls(t)
                                    if c[0] == last)
    x = t.graph.features.clone().requires_grad_(True)
    gen = torch.Generator(device=t.device).manual_seed(0)
    grad = torch.randn((ids.shape[0], x.shape[1]), generator=gen,
                       device=t.device)

    def old():
        x.grad = None
        mask = scatter_batch_mask(n, ids, keep, mids, kmin)
        denom = mask.sum(dim=1, keepdim=True).clamp(min=1.0)
        agg = torch.matmul(mask / denom, x)
        agg.backward(grad)
        return agg

    def new():
        x.grad = None
        mask, cnt = scatter_batch_mask_counts(n, ids, keep, mids, kmin)
        agg = masked_mean_aggregate(mask, x, counts=cnt)
        agg.backward(grad)
        return agg

    forms = {"old": old, "new": new}
    values = {}
    out = {"rows": int(ids.shape[0]), "n": n, "slots": int(ids.shape[1]),
           "minors": int(kmin.shape[1])}
    for name, fn in forms.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        agg = fn().detach()
        torch.cuda.synchronize()
        values[name] = (agg, x.grad.clone())
        out[name] = {"peak_extra_bytes":
                     torch.cuda.max_memory_allocated() - resident}
    for a, b in zip(values["old"], values["new"]):
        torch.testing.assert_close(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    reps = [()] * 10
    turns = {"old": [], "new": []}
    for name in ("old", "new", "new", "old"):
        turns[name].append(time_ms(forms[name], reps))
    for name, fn in forms.items():
        out[name]["ms"] = float(np.mean([d for d, _ in turns[name]]))
        out[name]["run_ms"] = float(np.mean([r for _, r in turns[name]]))
        out[name]["turns"] = turns[name]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in reps:
                fn()
            torch.cuda.synchronize()
        out[name]["kernels"] = [(k[:90], ms / len(reps) * 1e3, c / len(reps))
                                for k, ms, c in device_kernels(prof)]
        out[name]["mask_sized"] = mask_sized_kernels(prof, len(reps))
    faults = mask_pass_faults(out["new"]["mask_sized"])
    if faults:
        raise AssertionError(f"the aggregation still runs a mask-sized "
                             f"reduction or elementwise pass: {faults}")
    return out


def store_lane_phase(t, steps: int = 3) -> dict:
    """Phase 4: the per-relation store lane (fused store off): one kernel
    launch per relation per forward."""
    from pcgnn_tpu_torch.ops import window_gather as wg
    from pcgnn_tpu_torch.train.trainer import train_step
    graph = dataclasses.replace(t.graph, fused=None)
    model = t.new_model()
    opt = t.new_optimizer(model)
    batches, weights = t.epoch_plan(0)
    nrel = graph.num_relations
    losses = []
    wg.launches = 0
    for bt, wt in list(zip(batches, weights))[:steps]:
        before = wg.launches
        losses.append(float(train_step(model, opt, graph, bt,
                                       graph.labels[bt], wt, t.consts)))
        if wg.launches - before != nrel:
            raise AssertionError(f"store-lane step launched "
                                 f"{wg.launches - before} kernels, "
                                 f"expected {nrel}")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite store-lane loss: {losses}")
    return {"steps": steps, "launches": wg.launches, "losses": losses}


def turns_phase(trainers, rounds: int = 2) -> dict:
    """Steps of each graph timed in turns within this call (A, B, B, A per
    round, one epoch each), so that a difference between the graphs is not
    a difference between moments of the host.  Step time is the host clock
    around a step that ends in a synchronize."""
    times = {run_name(t): [] for t in trainers}
    state = {id(t): (lambda m: (m, t.new_optimizer(m)))(t.new_model())
             for t in trainers}
    for _ in range(rounds):
        for t in list(trainers) + list(trainers)[::-1]:
            model, opt = state[id(t)]
            batches, weights = t.epoch_plan(0)
            for bt, wt in zip(batches, weights):
                y = t.graph.labels[bt]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                t.step(model, opt, bt, y, wt)
                torch.cuda.synchronize()
                times[run_name(t)].append(
                    (time.perf_counter() - t0) * 1e3)
    return {name: {"step_ms_median": float(np.median(ms)), "step_ms": ms}
            for name, ms in times.items()}


def card_vs_cpu_phase(t) -> dict:
    """Phases 6 and 10: one step on the card and on the CPU's plain path
    from the same weights and batch (of the first epoch's batches, the one
    with the most hub rows, if the graph has any)."""
    from pcgnn_tpu_torch.train.trainer import make_optimizer, train_step
    cfg = t.config
    batches, weights = t.epoch_plan(0)
    counts = [hub_rows(t, bt) for bt in batches]
    i = int(np.argmax(counts))
    bt, wt = batches[i], weights[i]
    model_c = t.new_model()
    model_h = copy.deepcopy(model_c).to("cpu")
    graph_h = t.graph.to("cpu")
    consts_h = {k: v.to("cpu") for k, v in t.consts.items()}
    out, launched = {}, {}
    mods = kernel_counters()
    for name, model, graph, consts, dev in (
            ("card", model_c, t.graph, t.consts, t.device),
            ("cpu", model_h, graph_h, consts_h, torch.device("cpu"))):
        opt = make_optimizer(model, cfg["lr"], cfg["weight_decay"])
        b, w = bt.to(dev), wt.to(dev)
        before = {k: m.launches for k, m in mods.items()}
        out[name] = float(train_step(model, opt, graph, b, graph.labels[b],
                                     w, consts))
        if name == "card":
            launched = {k: m.launches - before[k] for k, m in mods.items()}
    if counts[i] and not launched["ragged_gather"]:
        raise AssertionError(f"the card's step with {counts[i]} hub rows "
                             f"launched no ragged_gather")
    if launched["window_gather"] != window_launches_per_step(t):
        raise AssertionError(f"the card's step launched "
                             f"{launched['window_gather']} window gathers")
    if not math.isclose(out["card"], out["cpu"], rel_tol=LOSS_RTOL):
        raise AssertionError(f"step loss card {out['card']} vs CPU "
                             f"{out['cpu']}")
    diffs = {}
    for (k, pc), (_, ph) in zip(model_c.named_parameters(),
                                model_h.named_parameters()):
        gc, pc = pc.grad.cpu(), pc.detach().cpu()
        diffs[k] = {"grad": float((gc - ph.grad).abs().max()),
                    "param": float((pc - ph.detach()).abs().max())}
        if not torch.allclose(gc, ph.grad, rtol=GRAD_RTOL, atol=GRAD_ATOL):
            raise AssertionError(f"gradient of {k} differs card vs CPU by "
                                 f"{diffs[k]['grad']}")
        if not torch.allclose(pc, ph.detach(), rtol=0, atol=PARAM_ATOL):
            raise AssertionError(f"parameter {k} after one step differs "
                                 f"card vs CPU by {diffs[k]['param']}")
    return {"data": run_name(t), "hub_rows": counts[i],
            "loss_card": out["card"], "loss_cpu": out["cpu"],
            "card_launches": launched, "max_abs_diff": diffs}


def lane_phases(t) -> dict:
    """Phases 16-18 for one configuration: the main path, one profiled
    epoch and the card's step against the CPU's."""
    run = {"main_path": main_path_phase(t), "profile": profile_phase(t)}
    run["card_vs_cpu"] = card_vs_cpu_phase(t)
    return run


def homo_window_phase(t, rate: float) -> dict:
    """Phase 18: the window gather on the baselines' homo store, held
    against its plain version exactly at the first epoch's batches, copied
    and widened (the path's call), and timed at that shape as phase 2 times
    its cases, with reads from memory: the store (160 MB) is a few times
    the L2, but the training rows' windows (64 MB) are not, so every timed
    call first overwrites a 256 MB buffer and draws its 1,024 rows from all
    nodes."""
    rel, dev = t.graph.homo, t.device
    batches, _ = t.epoch_plan(0)
    errs = [check_gather(rel.ewin, rel.estart[bt], rel.ewin_dp,
                         out_dtype=out_dtype)
            for bt in batches for out_dtype in (None, torch.float32)]
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = [torch.randint(t.graph.num_nodes, (t.batch_size,),
                           generator=gen, device=dev)
             for _ in range(TIMING_REPS)]
    a = 16 // rel.ewin.element_size()
    starts = [rel.estart[bt] for bt in timed]
    flush = torch.empty(1 << 26, device=dev)
    c = window_case("homo", rel.ewin, starts, rel.ewin_dp,
                    strided_rows(rel.ewin, rel.ewin_dp, a),
                    [s // a for s in starts], rate=rate, flush=flush)
    c.update(max_abs_err=max(errs), checked_calls=len(errs),
             window_width=rel.window_width, dmax=rel.dmax,
             hub_rows=int((rel.deg > rel.window_width).sum()))
    return c


def graph_shape(g) -> dict:
    """The sizes the phases rely on, to check against the presets."""
    def rel_shape(r):
        return {"edges": r.num_edges, "dmax": r.dmax,
                "dcap": r.window_width, "stub": r.is_stub,
                "hub_rows": (int((r.deg > r.window_width).sum())
                             if r.has_hubs else 0),
                "dense_table": r.nbr2d is not None,
                "store_bytes": (r.ewin.numel() * r.ewin.element_size()
                                if r.ewin is not None else 0)}
    return {"nodes": g.num_nodes, "feat_dim": g.feat_dim,
            "relations": [rel_shape(r) for r in g.relations],
            "homo": rel_shape(g.homo),
            "fused_bytes": (g.fused.numel() * g.fused.element_size()
                            if g.fused is not None else 0),
            "features_pad": g.features_pad is not None}


def stress_window_cases(t, rate: float) -> list:
    """Phase 17: the window gather at each stress-1m relation store's
    shape, held against its plain version exactly at the first epoch's
    first batch (copied and widened, the path's call) and timed as phase 2
    times its cases (1,024 rows drawn from all 1M nodes; each store is many
    times the L2); also with reads from memory (a 256 MB buffer overwritten
    before each call) and with the card idle before each call, the two
    ways a call on the host-bound path differs from one of a back-to-back
    run."""
    g, dev = t.graph, t.device
    bt0 = t.epoch_plan(0)[0][0]
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = [torch.randint(g.num_nodes, (t.batch_size,), generator=gen,
                           device=dev) for _ in range(TIMING_REPS)]
    flush = torch.empty(1 << 26, device=dev)
    cases = []
    for r, rel in enumerate(g.relations):
        err = max(check_gather(rel.ewin, rel.estart[bt0], rel.ewin_dp,
                               out_dtype=out_dtype)
                  for out_dtype in (None, torch.float32))
        a = 16 // rel.ewin.element_size()
        starts = [rel.estart[bt] for bt in timed]
        table = strided_rows(rel.ewin, rel.ewin_dp, a)
        rows = [s // a for s in starts]
        c = window_case(f"stress_relation_{r}", rel.ewin, starts,
                        rel.ewin_dp, table, rows, rate=rate, spaced=True)
        cold = window_case(f"stress_relation_{r}_cold", rel.ewin, starts,
                           rel.ewin_dp, table, rows, rate=rate, flush=flush)
        c["cold"] = {k: cold[k] for k in ("ms", "widen_ms", "library_ms")}
        c["max_abs_err"] = err
        cases.append(c)
    return cases


def window_summary(c: dict) -> dict:
    """A window-gather case's numbers for the summary line: its shape, its
    times (ms: device time per call), bounds and yardsticks, and where
    measured spaced and cold reads."""
    out = {k: c[k] for k in ("name", "rows", "dp", "row_bytes", "dtype",
                             "ms", "bound_ms", "widen_ms", "widen_bound_ms",
                             "plain_ms", "library_ms", "cold_reads")}
    for k in ("spaced_ms", "widen_spaced_ms", "cold"):
        if k in c:
            out[k] = c[k]
    return out


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for x in tensors:
        h.update(x.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def plan_check(t, picks: int = 20) -> dict:
    """Phase 17: the first epoch's plan built twice in this process (it is
    seeded, so the two must be equal), and its digest, to compare two
    calls; and the float32 ``torch.cumsum`` of the pick weights, the CDF
    the pick used to draw from, taken ``picks`` times: how many distinct
    results it gives."""
    first, second = t.epoch_plan(0), t.epoch_plan(0)
    w32 = t.pick_weights.to(torch.float32)
    cdfs = {digest(torch.cumsum(w32, dim=0)) for _ in range(picks)}
    return {"equal_in_process": all(torch.equal(a, b)
                                    for a, b in zip(first, second)),
            "digest": digest(*first), "float32_cdfs": picks,
            "float32_cdfs_distinct": len(cdfs),
            "train_nodes": int(w32.numel()), "draws": t.sample_size}


def stress_phase(rate: float) -> tuple:
    """Phase 17: PC-GNN on the 1M-node stress preset.  The graph is built
    on the host (its seconds printed), the relations' bf16 stores on the
    card; one epoch in the per-relation store lane (three window gathers a
    step: the fused store does not fit what the stores leave of the
    budget), profiled; the window gather at each relation's shape
    (``stress_window_cases``); then, without stores or the padded table,
    one step in the clamped-id lane against the CPU's, and one forward with
    every dense table dropped (the CSR branch, through the ragged gather),
    equal to the dense-table forward.  Returns the phase's record and the
    graph with its stores (phase 22 reuses it)."""
    from pcgnn_tpu_torch.data.loaders import load_data
    from pcgnn_tpu_torch.train.trainer import Trainer
    t1 = time.time()
    g = load_data(STRESS_CFG["data_name"], seed=STRESS_CFG["seed"])
    build_s = time.time() - t1
    print(f"stress-1m graph built on the host in {build_s:.1f} s (CSR: "
          f"{csr_path()})", file=sys.stderr)
    t2 = time.time()
    t = Trainer(STRESS_CFG, graph=g, device="cuda")
    torch.cuda.synchronize()
    run = {"host_build_s": build_s, "csr_path": csr_path(),
           "setup_s": time.time() - t2,
           "graph": graph_shape(t.graph), "plan": plan_check(t)}
    plan = run["plan"]
    print(f"stress-1m epoch_plan(0): equal when built twice in this "
          f"process: {plan['equal_in_process']}; digest {plan['digest']}; "
          f"{plan['float32_cdfs_distinct']} distinct of "
          f"{plan['float32_cdfs']} float32 cumsums of the "
          f"{plan['train_nodes']} pick weights")
    if not plan["equal_in_process"]:
        raise AssertionError("stress-1m's first epoch plan differs between "
                             "two builds in one process")
    if not t.graph.homo.is_stub or t.graph.fused is not None or any(
            r.ewin is None for r in t.graph.relations):
        raise AssertionError(f"stress-1m is not in the per-relation store "
                             f"lane: {run['graph']}")
    run.update(lane_phases(t))
    run["window_cases"] = stress_window_cases(t, rate)
    tc = Trainer(dict(STRESS_CFG, edge_windows=False),
                 graph=t.graph.without_stores(), device="cuda")
    if tc.graph.features_pad is not None or any(
            r.has_hubs for r in tc.graph.relations):
        raise AssertionError("the stress step without stores is not in "
                             "the clamped-id lane")
    run["clamp_card_vs_cpu"] = card_vs_cpu_phase(tc)
    run["csr_branch"] = csr_branch_phase(tc)
    return run, t.graph


# ------------------------------------------------ phase 24: stress-10m
# BASELINE.json config 5, "PC-GNN on synthetic 10M-node/200M-edge
# multi-relation graph": the bench configuration on synthetic:stress-10m at
# full width (10M nodes, F = 64, emb 64, B = 1024), cut to one epoch and one
# validation.  At that size no relation has a dense neighbor table, so none
# has a store, and the features are over the padded table's budget: every
# step reads each relation's neighbor ids from the CSR through the ragged
# gather and gathers feature rows with ids clamped to N-1
STRESS10M_CFG = dict(BENCH_CFG, data_name="synthetic:stress-10m", epochs=1)
# steps of the profiled span
STRESS10M_PROFILE_STEPS = 20
# first-epoch batches whose CSR windows are held against the plain version
STRESS10M_CHECKED_BATCHES = 20
# phase 29's turns on stress-10m take the first 256 of its 1,934
# validation batches each way (the main path evaluates all of them,
# captured), so that the script keeps inside its time
STRESS10M_PREDICT_BATCHES = 256


def csr_path() -> str:
    """What builds this process's CSRs: the native graph core (its file)
    or the numpy version."""
    from pcgnn_tpu_torch import native
    return (f"native core {native.loaded_path()}" if native.available()
            else "numpy")


def peak_rss_bytes() -> int:
    """This process's peak resident memory so far."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def stress10m_build(seed: int) -> tuple:
    """(host graph, record): ``synthetic:stress-10m`` built on the host
    with the seconds of each step, the CSR path and the peak host
    memory."""
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    timings = {}
    t0 = time.time()
    g = synthetic_fraud_graph("stress-10m", seed=seed, timings=timings)
    return g, {"build_s": time.time() - t0, "steps_s": timings,
               "csr_path": csr_path(),
               "peak_rss_bytes": peak_rss_bytes()}


def stress10m_lane(t) -> dict:
    """The lane stress-10m's scale forces, checked: no dense table, store
    or fused record on any relation, no padded table, the degree stub, no
    hub row, scores from the gathered rows, and so clamped ids."""
    from pcgnn_tpu_torch.models.pcgnn import SCORE_FROM_WINDOW_MIN_NODES
    g = t.graph
    lane = {"tables": [r.nbr2d is not None for r in g.relations],
            "stores": [r.ewin is not None for r in g.relations],
            "fused": g.fused is not None,
            "features_pad": g.features_pad is not None,
            "homo_stub": g.homo.is_stub,
            "hubs": [r.has_hubs for r in g.relations],
            "score_from_window": g.num_nodes >= SCORE_FROM_WINDOW_MIN_NODES}
    want = {"tables": [False] * 3, "stores": [False] * 3, "fused": False,
            "features_pad": False, "homo_stub": True, "hubs": [False] * 3,
            "score_from_window": True}
    if lane != want:
        raise AssertionError(f"stress-10m is not in the clamped CSR lane: "
                             f"{lane}")
    lane["clamped_ids"] = True
    return lane


def stress10m_ragged_cases(t, rate: float) -> tuple:
    """Kernel 2 at the path's calls: each relation's [B, dcap] CSR windows
    at ``indptr[batch]`` (int32 starts into a column of 130M / 70M / 30M
    ids), held against the plain version exactly on the first epoch's
    first batches, then timed over distinct random training batches (their
    reads are spread over the whole column) with the launch floor (1 row
    of 1 id).  Returns (cases, max |err|)."""
    g, dev = t.graph, t.device
    batches, _ = t.epoch_plan(0)
    errs = [check_ragged(rel.col, rel.indptr[bt], rel.window_width,
                         g.num_nodes)
            for bt in batches[:STRESS10M_CHECKED_BATCHES]
            for rel in g.relations]
    gen = torch.Generator(device=dev).manual_seed(0)
    timed = [t.idx_train_dev[torch.randint(len(t.idx_train),
                                           (t.batch_size,), generator=gen,
                                           device=dev)]
             for _ in range(TIMING_REPS)]
    cases = [ragged_case(f"stress_10m_relation_{r}", rel.col,
                         [rel.indptr[bt] for bt in timed], rel.window_width,
                         g.num_nodes, rate)
             for r, rel in enumerate(g.relations)]
    from pcgnn_tpu_torch.ops import ragged_gather as rg
    for c, rel in zip(cases, g.relations):
        # queued (utils.roofline.kernel_ms) over the distinct batches, each
        # call into a fresh output: the kernel and one indexing gather of
        # the same windows from ``col.unfold``
        d, col = rel.window_width, rel.col
        sets = [(rel.indptr[bt],) for bt in timed]

        def kernel(st, col=col, d=d):
            out = torch.empty((len(st), d), dtype=torch.int32,
                              device=col.device)
            rg.launch(col, st, out, g.num_nodes)
            return out

        table = col.unfold(0, d, 1)
        q = queued_ms(kernel, sets, c["bound_ms"],
                      f"ragged_gather {c['name']}")
        lib = queued_ms(lambda st, table=table, col=col, d=d: table[
            st.to(torch.int64).clamp(0, col.numel() - d)], sets)
        c.update(queued_ms=q["ms"], queued_readings_ms=q["readings_ms"],
                 queued_library_ms=lib["ms"],
                 queued_library_readings_ms=lib["readings_ms"],
                 col_entries=col.numel())
    rel0 = g.relations[0]
    cases.append(ragged_case("stress_10m_launch_floor", rel0.col,
                             [rel0.indptr[bt[:1]] for bt in timed], 1,
                             g.num_nodes, rate))
    return cases, max(errs)


def stress10m_op_cases(t) -> list:
    """Two PyTorch ops of the lane timed alone (``time_ms``) at the path's
    inputs over distinct random training batches: the oversample
    candidates, which sort every train positive's score each step (work
    that follows P, not B), and each relation's gather of table rows by
    clamped neighbor id, ``x[nbr.clamp(max=N-1)]`` (1,024 x dcap rows of
    256 B spread over the 2.56 GB table)."""
    from pcgnn_tpu_torch.ops.aggregate import (batch_neighbor_window,
                                               oversample_candidates_values,
                                               selection_score)
    g, dev = t.graph, t.device
    x, n = g.features, g.num_nodes
    model = t.new_model()
    w0 = model.label_clf.w[:, 0].detach()
    b0 = model.label_clf.b[0].detach()
    tp, tpv = t.consts["tp"], t.consts["tpv"]
    tp_s0 = selection_score(t.consts["tpf"], w0, b0)
    m_max = model.minor_window(int(tp.shape[0]), g.relations)
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [t.idx_train_dev[torch.randint(len(t.idx_train),
                                             (t.batch_size,), generator=gen,
                                             device=dev)]
               for _ in range(TIMING_REPS)]
    cases = []
    ms, run_ms = time_ms(
        lambda c: oversample_candidates_values(c, tp_s0, tp, tpv, m_max),
        [(selection_score(x[bt], w0, b0),) for bt in batches])
    cases.append({"name": "oversample_candidates_values", "positives":
                  int(tp.shape[0]), "m_max": m_max, "ms": ms,
                  "run_ms": run_ms})
    for r, rel in enumerate(g.relations):
        ids = [(batch_neighbor_window(rel, bt)[0].clamp(max=n - 1),)
               for bt in batches]
        ms, run_ms = time_ms(lambda i: x[i], ids)
        cases.append({"name": f"row_gather_relation_{r}",
                      "rows": list(ids[0][0].shape), "ms": ms,
                      "run_ms": run_ms})
    return cases


def stress10m_phase(g, build: dict, rate: float, card: str) -> dict:
    """Phase 24: PC-GNN on ``synthetic:stress-10m`` (``g``, built on the
    host; ``build`` its record) on the card.  The lane checked
    (``stress10m_lane``); one epoch through ``Trainer`` with three ragged
    gathers and no window gather on every step, then one validation
    (``main_path_phase``: AUC above 0.5); a profiled span of steps (no host
    sync a step); the card's step against the CPU's on the first batch;
    ``single_step`` timed with ``utils.roofline.measure``; kernel 2 at the
    path's shapes, and two PyTorch ops of the lane alone
    (``stress10m_op_cases``); peak device and host memory, and the seconds
    of each part."""
    from pcgnn_tpu_torch.train.trainer import Trainer
    torch.cuda.reset_peak_memory_stats()
    t1 = time.time()
    t = Trainer(STRESS10M_CFG, graph=g, device="cuda")
    torch.cuda.synchronize()
    run = {"build": build, "setup_s": time.time() - t1,
           "graph": graph_shape(t.graph), "lane": stress10m_lane(t),
           "batches": t.num_batches, "card": card}
    sec = {}
    for name, fn in (
            ("main_path", lambda: main_path_phase(t)),
            ("profile", lambda: profile_phase(t, STRESS10M_PROFILE_STEPS)),
            ("card_vs_cpu", lambda: card_vs_cpu_phase(t)),
            ("single_step", lambda: single_step_phase(t, card,
                                                      "phase 24"))):
        t2 = time.time()
        run[name] = fn()
        sec[name] = time.time() - t2
    mp = run["main_path"]
    nrel = t.graph.num_relations
    bad = [i for i, n in enumerate(mp["ragged_launches_per_step"])
           if n != nrel]
    if bad:
        raise AssertionError(f"stress-10m steps {bad[:5]} did not launch "
                             f"one ragged gather per relation")
    if mp["launches"]["ragged_gather"] != nrel * (mp["steps"]
                                                  + mp["eval_batches"]):
        raise AssertionError(f"the stress-10m validation did not launch one "
                             f"ragged gather per relation and batch: "
                             f"{mp['launches']}")
    if mp["train_launches"]["window_gather"]:
        raise AssertionError("a stress-10m step launched a window gather")
    t2 = time.time()
    run["capture"] = capture_lane(t, card)
    sec["capture"] = time.time() - t2
    t2 = time.time()
    run["predict"] = predict_lane(t, card, STRESS10M_PREDICT_BATCHES)
    sec["predict"] = time.time() - t2
    t2 = time.time()
    run["ragged_cases"], run["ragged_max_abs_err"] = (
        stress10m_ragged_cases(t, rate))
    run["op_cases"] = stress10m_op_cases(t)
    sec["kernel_cases"] = time.time() - t2
    run["seconds"] = sec
    run["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    run["peak_host_rss_bytes"] = peak_rss_bytes()
    pr = run["profile"]
    print(f"phase 24, stress-10m: host build {build['build_s']:.1f} s "
          f"({', '.join(f'{k} {v:.1f}' for k, v in build['steps_s'].items())}"
          f"; {build['csr_path']}), setup {run['setup_s']:.1f} s; "
          f"{mp['steps']} steps, median {mp['step_ms_median']:.2f} ms, "
          f"validation ({mp['eval_batches']} batches) {mp['eval_s']:.1f} s, "
          f"AUC {mp['valid_auc']:.4f}; ragged gathers a step "
          f"{pr['ragged_gather_launches_per_step']:.0f}, window gathers "
          f"{pr['window_gather_launches_per_step']:.0f}, launches "
          f"{pr['kernel_launches_per_step']:.0f}, host syncs "
          f"{pr['host_syncs_per_step']}, kernel ms "
          f"{pr['device_ms_per_step']:.3f}, busy {pr['busy_share']:.3f}; "
          f"peak device {run['peak_device_bytes'] / 2**30:.2f} GiB, host "
          f"RSS {run['peak_host_rss_bytes'] / 2**30:.2f} GiB; on {card}")
    for c in run["op_cases"]:
        print(f"phase 24, {c['name']}: {c['ms'] * 1e3:.2f} us of kernels a "
              f"call, {c['run_ms'] * 1e3:.2f} us back to back; on {card}")
    for c in run["ragged_cases"]:
        queued = (f"queued {c['queued_ms'] * 1e3:.3f} us (indexing "
                  f"{c['queued_library_ms'] * 1e3:.3f} us), "
                  if "queued_ms" in c else "")
        print(f"phase 24, ragged gather {c['name']} [{c['rows']}, {c['d']}]: "
              f"{queued}profiler {c['ms'] * 1e3:.3f} us against a "
              f"{c['bound_ms'] * 1e3:.3f} us bound; plain "
              f"{c['plain_ms'] * 1e3:.3f} us, indexing "
              f"{c['library_ms'] * 1e3:.3f} us; on {card}")
    return run


# ------------------------------------- phase 28: the captured step

CAPTURE_STEPS = 12


def capture_stack(t, steps: int = CAPTURE_STEPS) -> tuple:
    """The first ``steps`` batches of ``t``'s epochs from epoch 0 on, as
    [steps, B] (batches, labels, weights) and their draws' seeds."""
    bs, ws, seeds, epoch = [], [], [], 0
    while len(bs) < steps:
        b, w = t.epoch_plan(epoch)
        bs += list(b)
        ws += list(w)
        seeds += [t.step_seed(epoch, i) for i in range(len(b))]
        epoch += 1
    batches = torch.stack(bs[:steps])
    return batches, t.labels[batches], torch.stack(ws[:steps]), seeds[:steps]


def same_bits(a, b) -> bool:
    """Whether two (model, optimizer, losses) runs hold the same bits:
    losses, parameters and Adam state."""
    (ma, oa, la), (mb, ob, lb) = a, b
    return torch.equal(la, lb) and all(
        torch.equal(p, q) and all(torch.equal(v, ob.state[q][k])
                                  for k, v in oa.state[p].items())
        for p, q in zip(ma.parameters(), mb.parameters()))


def profiled_block(r, stack) -> dict:
    """One block of ``r``'s steps under torch.profiler: wall ms a step,
    kernel ms a step, the busy share, kernels a step (device entries) and
    host launch calls a step, graph launches included."""
    from torch.profiler import ProfilerActivity, profile
    steps = stack[0].shape[0]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r.run(*stack)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = device_kernels(prof)
    device_ms = sum(ms for _, ms, _ in busy)
    calls = {e.key: e.count for e in prof.key_averages()}
    launch = sum(calls.get(k, 0) for k in ("cudaLaunchKernel",
                                           "cuLaunchKernel",
                                           "cudaLaunchKernelExC",
                                           "cuLaunchKernelEx"))
    return {"wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": device_ms / steps,
            "busy_share": device_ms / wall_ms,
            "kernels_per_step": sum(n for _, _, n in busy) / steps,
            "kernel_launch_calls_per_step": launch / steps,
            "graph_launches_per_step": sum(
                n for k, n in calls.items()
                if k.startswith("cudaGraphLaunch")) / steps}


def capture_lane(t, card: str) -> dict:
    """Phase 28 for one trainer: ``CAPTURE_STEPS`` steps eager and the same
    steps captured (``StepRunner``), each from the same initial weights,
    in turns (eager, captured, captured, eager: 24 steps each way).  After
    12 and after 24 steps the two must hold the same bits (losses,
    parameters, Adam state).  Then a block of each under the profiler.
    Records step ms (CUDA events around each step) and the host's wall ms
    a step, graph launches and kernels a step, the busy share, the
    captures and their seconds, the graph pool's bytes and the host syncs
    of a captured block: the hub plan's one read-back on a graph with
    hubs, none without."""
    stack = capture_stack(t)
    hub_rels = sum(r.has_hubs for r in aggregated_relations(t))
    runs = {}
    for capture in (False, True):
        t.capture = capture
        model = t.new_model()
        opt = t.new_optimizer(model)
        r = t.runner(model, opt)
        r.step_hook = StepEvents(r)
        runs[capture] = [model, opt, r, None]
    t.capture, t._runner = True, None
    walls = {False: [], True: []}
    syncs = None
    for i, capture in enumerate((False, True, True, False)):
        model, opt, r, _ = runs[capture]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 2:
            got = []
            syncs = count_syncs(lambda: got.append(r.run(*stack)))
            runs[capture][3] = got[0]
        else:
            runs[capture][3] = r.run(*stack)
        torch.cuda.synchronize()
        walls[capture].append((time.perf_counter() - t0) * 1e3
                              / CAPTURE_STEPS)
        if i in (1, 3) and not same_bits(
                [runs[False][0], runs[False][1], runs[False][3]],
                [runs[True][0], runs[True][1], runs[True][3]]):
            raise AssertionError(f"{run_name(t)}: eager and captured steps "
                                 f"differ after {6 * (i + 1)} steps")
    if syncs != int(hub_rels > 0):
        raise AssertionError(f"{run_name(t)}: a captured block made {syncs} "
                             f"host syncs, expected {int(hub_rels > 0)}")
    prof = {"eager": profiled_block(runs[False][2], stack),
            "captured": profiled_block(runs[True][2], stack)}
    r = runs[True][2]
    if r.captures != 1 or prof["captured"]["graph_launches_per_step"] != 1:
        raise AssertionError(f"{run_name(t)}: {r.captures} captures, "
                             f"{prof['captured']} under the profiler")
    ms = {k: runs[c][2].step_hook.step_ms() for k, c in (("eager", False),
                                                         ("captured", True))}
    out = {"data": run_name(t), "steps": CAPTURE_STEPS, "bit_equal": True,
           "step_ms_median": {k: float(np.median(v[1:]))
                              for k, v in ms.items()},
           # the captured run's second block: replays only (its first
           # holds the warm-up step and the capture)
           "wall_ms_per_step": {"eager": float(np.median(walls[False])),
                                "captured": walls[True][1]},
           "profile": prof, "captures": r.captures,
           # kernel ms a step over the step's time on the card's clock
           # (the profiler's busy share divides by its own wall, which
           # holds its host time)
           "event_busy_share": {
               k: prof[k]["device_ms_per_step"] / float(np.median(v[1:]))
               for k, v in ms.items()},
           "capture_s": r.capture_s, "graph_pool_bytes": r.pool_bytes,
           "replay_launches": r.replay_launches, "hub_plans": r.plans,
           "host_syncs_per_captured_block": syncs, "card": card}
    print(f"phase 28, {out['data']}: eager and captured bit-equal after 12 "
          f"and 24 steps; step ms median eager "
          f"{out['step_ms_median']['eager']:.3f}, captured "
          f"{out['step_ms_median']['captured']:.3f} (host wall a step "
          f"{out['wall_ms_per_step']['eager']:.3f} / "
          f"{out['wall_ms_per_step']['captured']:.3f}); graph launches a "
          f"step {prof['captured']['graph_launches_per_step']:.0f}, kernels "
          f"a step captured {prof['captured']['kernels_per_step']:.1f}, "
          f"eager {prof['eager']['kernels_per_step']:.1f} (kernel launch "
          f"calls {prof['captured']['kernel_launch_calls_per_step']:.1f} / "
          f"{prof['eager']['kernel_launch_calls_per_step']:.1f}); busy "
          f"share eager {prof['eager']['busy_share']:.3f}, "
          f"captured {prof['captured']['busy_share']:.3f} (kernel ms over "
          f"step ms: {out['event_busy_share']['eager']:.3f} / "
          f"{out['event_busy_share']['captured']:.3f}); {r.captures} "
          f"capture in {r.capture_s:.2f} s, graph pool {r.pool_bytes} "
          f"bytes; host syncs of a captured block {syncs}; on {card}")
    return out


def capture_phase(lanes: list, stress10m: dict, card: str) -> dict:
    """Phase 28: ``capture_lane`` on each trainer of ``lanes`` (the graphs
    earlier phases built), beside stress-10m's (run in phase 24, whose
    graph is gone by now)."""
    t1 = time.time()
    out = {"lanes": {}}
    for t in lanes:
        rec = capture_lane(t, card)
        out["lanes"][rec["data"]] = rec
    out["lanes"][stress10m["data"]] = stress10m
    out["seconds"] = time.time() - t1
    return out


# ---------------------------------- phase 29: the captured forward

def runner_counts(r) -> dict:
    """A ``PredictRunner``'s running totals, to take a turn's share."""
    return {"captures": r.captures, "replays": r.replays,
            "capture_s": r.capture_s,
            "captured": dict(r.captured_launches),
            "replayed": dict(r.replayed_launches)}


def predict_lane(t, card: str, batches: int | None = None) -> dict:
    """Phase 29 for one trainer: a fresh model trained for one epoch of
    captured steps, then its validation split (its first ``batches``
    batches, when given) evaluated two ways in turns
    (eager, captured, captured, eager): eagerly, ``train.metrics.evaluate``
    over ``Trainer.predict`` (a forward, an id copy to the card and a
    read-back a batch; the hub plan read back a batch and hub relation),
    and through ``Trainer.evaluate`` (a replay of the captured forward a
    batch, one hub plan, one read-back).  Every turn must give the same
    probabilities, bit for bit, and so the same AUC.  Each turn records
    its seconds, its host syncs (``count_syncs``), the kernel launches the
    card ran (the wrappers' counts from 0, less what a capture recorded,
    plus what each replay ran) and its replays, captures and capture
    seconds.  The second captured turn is replays only: it must sync once
    on a graph without hubs and twice on one with hubs.  Then the
    captured turn's time split: the replays of one stack alone (host
    clock to the card's end, and CUDA events a replay), and the metrics
    on the host (``evaluate_probs``) of its probabilities."""
    from pcgnn_tpu_torch.train.metrics import evaluate, evaluate_probs
    mods = kernel_counters()
    hub_rels = sum(r.has_hubs for r in aggregated_relations(t))
    m = len(t.idx_valid) if batches is None else batches * t.batch_size
    nodes, labels = t.idx_valid[:m], t.y_valid[:m]
    nb = -(-len(nodes) // t.batch_size)
    model = t.new_model()
    t.run_epoch(model, t.new_optimizer(model), 0)
    t._runner = None                  # the step graph's pool goes first
    prun = t.predict_runner(model)
    ways = {"eager": lambda: evaluate(lambda b: t.predict(model, b), nodes,
                                      labels, t.batch_size,
                                      print_line=False),
            "captured": lambda: t.evaluate(model, nodes, labels,
                                           print_line=False)}
    turns, first = [], None
    for way in ("eager", "captured", "captured", "eager"):
        for mod in mods.values():
            mod.launches = 0
        was = runner_counts(prun)
        got = []

        def timed_turn():
            t0 = time.perf_counter()
            got.append(ways[way]())
            got.append(time.perf_counter() - t0)

        syncs = count_syncs(timed_turn)
        res, seconds = got
        now = runner_counts(prun)
        launches = {k: m.launches - (now["captured"][k] - was["captured"][k])
                    + now["replayed"][k] - was["replayed"][k]
                    for k, m in mods.items()}
        if first is None:
            first = res
        elif not (np.array_equal(res.anomaly_confidence,
                                 first.anomaly_confidence)
                  and res.auc == first.auc):
            raise AssertionError(f"{run_name(t)}: the {way} evaluate differs "
                                 f"from the first eager one (AUC {res.auc} "
                                 f"against {first.auc})")
        turns.append({"way": way, "seconds": seconds, "host_syncs": syncs,
                      "launches": launches, "auc": res.auc,
                      "captures": now["captures"] - was["captures"],
                      "replays": now["replays"] - was["replays"],
                      "capture_s": now["capture_s"] - was["capture_s"]})
    eager, captured = turns[0]["launches"], turns[2]["launches"]
    if (captured["window_gather"] != eager["window_gather"]
            or captured["mask_build"] != eager["mask_build"]
            or captured["ragged_gather"] < eager["ragged_gather"]
            or (eager["ragged_gather"] and not captured["ragged_gather"])):
        raise AssertionError(f"{run_name(t)}: the replays launched "
                             f"{captured}, the eager forwards {eager}")
    if prun.captures != 1 or turns[2]["replays"] != nb \
            or turns[2]["host_syncs"] != 1 + int(hub_rels > 0):
        raise AssertionError(f"{run_name(t)}: {prun.captures} captures, a "
                             f"captured turn of {turns[2]}")
    stack = t._stack(nodes)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ev[0].record()
    probs = prun.run(stack)
    ev[1].record()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    probs = probs.reshape(-1, 2)[: len(nodes)].cpu().numpy()
    t0 = time.perf_counter()
    evaluate_probs(probs, labels, print_line=False)
    metrics_s = time.perf_counter() - t0
    out = {"data": run_name(t), "batches": nb, "bit_equal": True,
           "auc": first.auc, "turns": turns, "replay_s": replay_s,
           "replay_ms": ev[0].elapsed_time(ev[1]) / nb,
           "metrics_s": metrics_s,
           "seconds": {w: [x["seconds"] for x in turns if x["way"] == w]
                       for w in ways},
           "graph_pool_bytes": prun.pool_bytes, "capture_s": prun.capture_s,
           "replay_launches": prun.replay_launches, "hub_plans": prun.plans,
           "card": card}
    t._predict_runner = None          # and the forward's
    print(f"phase 29, {out['data']}: eager and captured evaluates of "
          f"{nb} batches bit-equal, AUC {first.auc:.4f}; seconds eager "
          f"{turns[0]['seconds']:.3f} / {turns[3]['seconds']:.3f}, captured "
          f"{turns[1]['seconds']:.3f} (capture {turns[1]['capture_s']:.2f}) "
          f"/ {turns[2]['seconds']:.3f}; host syncs eager "
          f"{turns[0]['host_syncs']}, captured {turns[2]['host_syncs']}; "
          f"launches eager {eager}, captured {captured}; graph pool "
          f"{prun.pool_bytes / 2**20:.1f} MB; replays of a stack "
          f"{replay_s:.3f} s ({out['replay_ms']:.3f} ms each), metrics "
          f"{metrics_s:.3f} s; on {card}")
    return out


def predict_phase(lanes: list, stress10m: dict, card: str) -> dict:
    """Phase 29: ``predict_lane`` on each trainer of ``lanes``, beside
    stress-10m's (run in phase 24).  Between them, the replays must
    launch every kernel of the package but the oversample kernel, which
    runs in training alone."""
    t1 = time.time()
    out = {"lanes": {}}
    for t in lanes:
        rec = predict_lane(t, card)
        out["lanes"][rec["data"]] = rec
    out["lanes"][stress10m["data"]] = stress10m
    out["launches"] = {k: sum(x["launches"][k] for rec in
                              out["lanes"].values() for x in rec["turns"]
                              if x["way"] == "captured")
                       for k in kernel_counters()}
    if not all(n for k, n in out["launches"].items()
               if k != "oversample_minors"):
        raise AssertionError(f"the captured forwards launched "
                             f"{out['launches']}")
    out["seconds"] = time.time() - t1
    return out


# configs/pcgnn_yelpchi.json, cut to 2 epochs with a validation at the end,
# on YelpChi-format files written from yelp-like's graph at this seed (the
# real YelpChi files are not in the repository)
FILES_CONFIG = os.path.join("configs", "pcgnn_yelpchi.json")
FILES_SEED = 2
FILES_RUN = dict(epochs=2, valid_epochs=2)
# phase 21: runs of 4 epochs, validated and saved every epoch, one cut
# after 2; the profiled run takes 5 epochs so that its trace spans 2-4
RESUME_RUN = dict(epochs=4, valid_epochs=1, resume=True)
RESUME_CUT = 2
PROFILE_EPOCHS = 5


def write_yelp_files(g, prefix: str) -> None:
    """Phase 20: graph ``g`` as the reference's YelpChi files under
    ``prefix``: ``YelpChi_data.pt`` (x and y under ``"review"``) and the
    homo, rur, rtr and rsr adjacency lists, each a pickled
    ``defaultdict(set)`` of every node with neighbors."""
    import pickle
    from collections import defaultdict

    from pcgnn_tpu_torch.data.verify import expected_files
    pt, *adj_files = expected_files("yelp", prefix)
    os.makedirs(os.path.dirname(pt), exist_ok=True)
    torch.save({"review": {"x": g.features.cpu(), "y": g.labels.cpu()}}, pt)
    for path, rel in zip(adj_files, (g.homo, *g.relations)):
        indptr = rel.indptr.cpu().numpy()
        col = rel.col.cpu().numpy()
        adj = defaultdict(set)
        for v in np.flatnonzero(np.diff(indptr)):
            adj[int(v)] = set(col[indptr[v]:indptr[v + 1]].tolist())
        with open(path, "wb") as f:
            pickle.dump(adj, f)


def graph_differences(want, got) -> list:
    """Where graph ``got`` is not exactly ``want``: the CSR arrays, degrees,
    keep counts and window widths of every relation and the homo graph,
    the features and the labels."""
    if want.num_relations != got.num_relations:
        return ["relation count"]
    out = []
    pairs = [(f"relation {r}", a, b)
             for r, (a, b) in enumerate(zip(want.relations, got.relations))]
    for name, a, b in pairs + [("homo", want.homo, got.homo)]:
        e = a.num_edges
        sizes = [(r.num_edges, r.dmax, r.dcap) for r in (a, b)]
        if sizes[0] != sizes[1]:
            out.append(f"{name}: edges/dmax/dcap {sizes[0]} vs {sizes[1]}")
            continue
        for k, x, y in (("indptr", a.indptr, b.indptr),
                        ("col", a.col[:e], b.col[:e]), ("deg", a.deg, b.deg),
                        ("keff", a.keff, b.keff),
                        ("ksample", a.ksample, b.ksample)):
            if not torch.equal(x.cpu(), y.cpu()):
                out.append(f"{name}: {k}")
    for k in ("features", "labels"):
        if not torch.equal(getattr(want, k).cpu(), getattr(got, k).cpu()):
            out.append(k)
    return out


def files_config(prefix: str, **kw) -> dict:
    from pcgnn_tpu_torch.utils.config import load_config
    cfg = load_config(FILES_CONFIG)
    cfg.update(data_prefix=prefix, **kw)
    return cfg


def files_phase(work: str, card: str, like) -> tuple:
    """Phase 20: the main path from files, through the CLI.  yelp-like's
    graph at ``FILES_SEED`` is written as YelpChi-format files and loaded
    back onto the card (equal to the generated graph, exactly); then
    ``python -m pcgnn_tpu_torch.cli`` trains PC-GNN on a copy of
    ``configs/pcgnn_yelpchi.json`` pointed at them (``FILES_RUN``), in a
    fresh result root, with every kernel count set to 0 just before: every
    step must launch the window gather, and the validation AUC must be
    above 0.5.  Then ``verify_dataset`` must say GO on the files; and the
    loaded graph's steps are timed in turns with those of ``like``, phase
    3's trainer on the generated graph (``turns_phase``).  Returns the
    phase's record and the loaded graph."""
    from pcgnn_tpu_torch import cli
    from pcgnn_tpu_torch.data.loaders import load_data
    from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
    from pcgnn_tpu_torch.data.verify import verify_dataset
    from pcgnn_tpu_torch.train.results import ResultManager, read_table
    from pcgnn_tpu_torch.train.trainer import Trainer
    prefix = os.path.join(work, "data") + "/"
    t1 = time.time()
    gen = synthetic_fraud_graph("yelp-like", seed=FILES_SEED)
    run = {"generate_s": time.time() - t1}
    t1 = time.time()
    write_yelp_files(gen, prefix)
    run["write_s"] = time.time() - t1
    run["file_bytes"] = sum(os.path.getsize(os.path.join(d, f))
                            for d, _, fs in os.walk(prefix) for f in fs)
    t1 = time.time()
    graph = load_data("yelp", prefix, device="cuda")
    torch.cuda.synchronize()
    run["load_s"] = time.time() - t1
    diffs = graph_differences(gen, graph)
    if diffs:
        raise AssertionError(f"the graph loaded from the files differs from "
                             f"the generated one: {diffs}")
    cfg = files_config(prefix, **FILES_RUN)
    cfg_path = os.path.join(work, "pcgnn_yelpchi.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    mods = kernel_counters()
    cwd = os.getcwd()
    try:
        os.chdir(work)
        for mod in mods.values():
            mod.launches = 0
        with contextlib.redirect_stdout(sys.stderr), runners_made() as rs:
            auc, recall, f1 = cli.main(["--exp_config_path", cfg_path])
        launches = card_launches({k: m.launches for k, m in mods.items()},
                                 rs)
    finally:
        os.chdir(cwd)
    # each step's window gathers (the captured step's) and its time
    steps = step_runners(rs)
    gathers = [n["window_gather"] for r in steps for n in r.step_hook.launches]
    step_ms = [ms for r in steps for ms in r.step_hook.step_ms()]
    loaded = Trainer(cfg, graph=graph, device="cuda", result=ResultManager(
        cfg, root=os.path.join(work, "turns")))
    if (len(gathers) != FILES_RUN["epochs"] * loaded.num_batches
            or min(gathers) < 1
            or not all(r.capture for r in rs)):
        raise AssertionError(f"the CLI run made {len(gathers)} steps with "
                             f"window gathers {gathers}")
    (val_table,) = glob.glob(os.path.join(work, "experimental_results",
                                          "validation_df", "*.csv"))
    valid_auc = float(read_table(val_table)[-1]["auc"])
    if not valid_auc > 0.5:
        raise AssertionError(f"validation AUC {valid_auc} is not above 0.5")
    ok, lines = verify_dataset("yelp", prefix)
    if not ok:
        raise AssertionError("verify_dataset says NO-GO on the files:\n"
                             + "\n".join(lines))
    turns = turns_phase([like, loaded])
    run.update(steps=len(step_ms), step_ms=step_ms,
               step_ms_median=float(np.median(step_ms[1:])),
               window_launches_per_step=gathers,
               launches=launches, valid_auc=valid_auc, test_auc=auc,
               test_recall=recall, test_f1_macro=f1, verify=lines[-1],
               shape=graph_shape(graph), turns=turns)
    print(f"phase 20, yelp from files: generated in {run['generate_s']:.1f} "
          f"s, written in {run['write_s']:.1f} s ({run['file_bytes']} bytes), "
          f"loaded onto the card in {run['load_s']:.1f} s; CLI step "
          f"{run['step_ms_median']:.2f} ms (median of {len(step_ms)}), "
          f"valid AUC {valid_auc:.4f}; {lines[-1]}; in turns, step "
          f"{turns[run_name(loaded)]['step_ms_median']:.2f} ms loaded, "
          f"{turns[run_name(like)]['step_ms_median']:.2f} ms generated; "
          f"on {card}")
    return run, graph


def tree_leaves(tree) -> list:
    """The arrays of a parameter tree, in a fixed order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [np.asarray(tree)]


def max_abs_diff(a, b) -> float:
    return max(float(np.abs(x - y).max())
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def resume_phase(work: str, graph, card: str) -> dict:
    """Phase 21: ``resume`` and ``profile_dir`` on the card, on phase 20's
    graph (its stores built once).  With ``RESUME_RUN``: an uncut run,
    twice, each in a fresh result root; then a run of ``RESUME_CUT`` epochs
    and the same configuration resumed from it, in one fresh root.  The
    resumed run's epoch plans must equal the uncut run's exactly, and its
    final parameters (its resume file's) be within ``PARAM_ATOL`` of the
    uncut run's; the two uncut runs' difference is the card's own spread.
    Then a ``PROFILE_EPOCHS`` run with ``profile_dir`` must write a trace
    of epochs 2-4 whose kernels hold a window gather on every traced
    step."""
    from pcgnn_tpu_torch.train.checkpoint import load_checkpoint
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    from pcgnn_tpu_torch.utils.profiling import trace_kernels
    prefix = os.path.join(work, "data") + "/"
    cfg = files_config(prefix, **RESUME_RUN)
    with contextlib.redirect_stdout(sys.stderr):
        base = Trainer(cfg, graph=graph, device="cuda",
                       result=ResultManager(cfg, root=os.path.join(work,
                                                                   "base")))
    plans, plan = {}, Trainer.epoch_plan
    running = None

    def recorded_plan(self, epoch):
        out = plan(self, epoch)
        plans[running][epoch] = digest(*out)
        return out

    def run(tag, root, **kw):
        nonlocal running
        running = tag
        plans[tag] = {}
        c = dict(cfg, **kw)
        t = Trainer(c, graph=base.graph, device="cuda",
                    result=ResultManager(c, root=os.path.join(work, root)))
        t1 = time.time()
        t.train()
        return t, time.time() - t1

    Trainer.epoch_plan = recorded_plan
    try:
        with contextlib.redirect_stdout(sys.stderr):
            (a, a_s), (b, _) = run("uncut", "a"), run("uncut again", "b")
            run("cut", "c", epochs=RESUME_CUT)
            r, r_s = run("resumed", "c")
    finally:
        Trainer.epoch_plan = plan
    states = {tag: load_checkpoint(t._resume_path())
              for tag, t in (("uncut", a), ("uncut again", b), ("resumed", r))}
    resumed_epochs = sorted(plans["resumed"])
    if resumed_epochs != list(range(RESUME_CUT, RESUME_RUN["epochs"])):
        raise AssertionError(f"the resumed run trained epochs "
                             f"{resumed_epochs}")
    if any(plans["resumed"][e] != plans["uncut"][e] for e in resumed_epochs):
        raise AssertionError(f"the resumed run's epoch plans differ from the "
                             f"uncut run's: {plans}")
    if not (states["uncut"]["epoch"] == states["resumed"]["epoch"]
            == RESUME_RUN["epochs"] - 1):
        raise AssertionError("a resume file is not from the last epoch")
    out = {"plans": plans, "uncut_s": a_s, "resumed_s": r_s,
           "resumed_vs_uncut": max_abs_diff(states["resumed"]["params"],
                                            states["uncut"]["params"]),
           "uncut_vs_uncut": max_abs_diff(states["uncut again"]["params"],
                                          states["uncut"]["params"])}
    if not out["resumed_vs_uncut"] <= PARAM_ATOL:
        raise AssertionError(f"the resumed run's parameters differ from the "
                             f"uncut run's by {out['resumed_vs_uncut']}")
    prof_dir = os.path.join(work, "profile")
    c = dict(cfg, epochs=PROFILE_EPOCHS, resume=False, profile_dir=prof_dir)
    t = Trainer(c, graph=base.graph, device="cuda",
                result=ResultManager(c, root=os.path.join(work, "p")))
    with contextlib.redirect_stdout(sys.stderr):
        t.train()
    (path,) = glob.glob(os.path.join(prof_dir, "trace-*.json"))
    kernels = trace_kernels(path)
    gathers = sum(n for k, n in kernels.items() if "window_gather_kernel" in k)
    out.update(trace_bytes=os.path.getsize(path),
               trace_kernel_launches=sum(kernels.values()),
               trace_window_gathers=gathers,
               traced_steps=3 * t.num_batches)
    if gathers < out["traced_steps"]:
        raise AssertionError(f"the profiled run's trace holds {gathers} "
                             f"window gathers for {out['traced_steps']} "
                             f"steps: {kernels.most_common(10)}")
    print(f"phase 21, resume: resumed run's plans equal the uncut run's; "
          f"final parameters differ by {out['resumed_vs_uncut']:.3g} "
          f"(two uncut runs: {out['uncut_vs_uncut']:.3g}); profile_dir trace "
          f"of epochs 2-4: {gathers} window gathers for "
          f"{out['traced_steps']} steps; on {card}")
    return out


# phase 22: the full-graph ops on every relation of yelp-like and stress-1m.
# stress-1m's results are held against a plain CPU computation on a seeded
# sample of rows: a CPU segment pass over its 13M x 64 floats takes minutes
# and gigabytes
FULL_SAMPLE_ROWS = 4096
# measure's run length per timed call
FULL_TARGET_S = 0.05
# the means are float32 sums taken in another order on each device; the
# edge-window distances score each neighbor from its window row (float64,
# rounded once) where the window form gathers the score table's value
MEAN_TOL = dict(rtol=1e-5, atol=1e-6)
EWIN_ATOL = 1e-5


def full_graph_calls(rel, x, s0, w0, b0) -> list:
    """[(name, fn, args, bytes)] of one relation's full-graph calls: the
    three lowerings of the mean (the segment form forced by an all-true
    ``keep``; the edge-window form on the store, whose snapshot ``x``
    must be) and the three forms of the edge scoring, on scores ``s0`` of
    ``x`` by ``w0``, ``b0``.  ``bytes`` is what ``benchmarks/roofline.py``
    counts for the same call: each gathered row read once with its ids,
    each output written once."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import sddmm
    n, f = x.shape
    nd = n * max(rel.window_width, 1)
    spmm_bytes = rel.e_pad * (f * 4 + 8) + n * (f * 4 + 4)
    keep = torch.ones(rel.e_pad, dtype=torch.bool, device=x.device)
    return [
        ("spmm_window", agg.segment_mean_spmm, (rel, x), spmm_bytes),
        ("spmm_ewin", lambda r, y: agg.segment_mean_spmm(
            r, y, assume_ewin_features=True), (rel, x), spmm_bytes),
        ("spmm_segment", agg.segment_mean_spmm, (rel, x, keep), spmm_bytes),
        ("sddmm_window", sddmm.edge_abs_diff_window, (rel, s0), nd * 13),
        ("sddmm_ewin", sddmm.edge_abs_diff_window_ewin, (rel, s0, w0, b0),
         nd * (4 * f + 5)),
        ("sddmm_flat", sddmm.edge_abs_diff, (rel, s0), rel.e_pad * 12)]


def ranks_call(rel, dist) -> tuple:
    """``edge_ranks_global``'s call, with its bytes (benchmarks/roofline.py
    counts none): each distance read once, each rank written once, and
    the row offsets read once."""
    from pcgnn_tpu_torch.ops.sddmm import edge_ranks_global
    return ("edge_ranks", edge_ranks_global, (rel, dist),
            rel.e_pad * 8 + (rel.num_nodes + 1) * 4)


def check_mean(name, got, want, errs) -> None:
    err = float((got.double() - want.double()).abs().max())
    errs[name] = max(errs.get(name, 0.0), err)
    torch.testing.assert_close(got.double(), want.double(), **MEAN_TOL,
                               msg=lambda m: f"{name}: {m}")


def check_ewin_dist(name, got, want, errs) -> None:
    """Edge-window distances against a reference's: the same valid slots,
    within ``EWIN_ATOL`` there, +inf elsewhere."""
    (d, v), (dw, vw) = got, want
    if not torch.equal(v, vw):
        raise AssertionError(f"{name}: valid masks differ")
    err = float((d[v] - dw[v]).abs().max()) if v.any() else 0.0
    errs[name] = max(errs.get(name, 0.0), err)
    if not err <= EWIN_ATOL or not torch.isinf(d[~v]).all():
        raise AssertionError(f"{name}: distances differ by {err}")


def check_exact(name, got, want, errs) -> None:
    got, want = (tuple(x) if isinstance(x, tuple) else (x,)
                 for x in (got, want))
    for a, b in zip(got, want):
        if not torch.equal(a, b):
            raise AssertionError(f"{name} differs from its reference")
    errs.setdefault(name, 0.0)


def cpu_full_check(rel, x, s0, w0, b0, got, errs) -> None:
    """Each call again on the CPU (the plain path), on the whole relation:
    the means within ``MEAN_TOL``, the window and flat distances and the
    ranks exactly, the edge-window distances within ``EWIN_ATOL``."""
    cpu = torch.device("cpu")
    args = (rel.to(cpu), x.cpu(), s0.cpu(), w0.cpu(), b0.cpu())
    calls = full_graph_calls(*args)
    want = {name: fn(*a) for name, fn, a, _ in calls}
    name, fn, a, _ = ranks_call(args[0], want["sddmm_flat"])
    want[name] = fn(*a)
    for name, out in got.items():
        ref = want[name]
        out = (tuple(o.cpu() for o in out) if isinstance(out, tuple)
               else out.cpu())
        if name.startswith("spmm"):
            check_mean(name, out, ref, errs)
        elif name == "sddmm_ewin":
            check_ewin_dist(name, out, ref, errs)
        else:
            check_exact(name, out, ref, errs)


def cpu_sample_check(rel, x, s0, w0, b0, got, rows, errs) -> None:
    """The calls' results at ``rows`` against plain CPU computations of
    those rows from the CSR: the mean over each row's neighbors (float64),
    each window and flat distance, each edge-window distance (the
    neighbors' rows scored as ``selection_score`` scores them) and each
    edge's rank within its row (a stable argsort).  For a relation without
    hub rows, whose window holds every edge of a row."""
    from pcgnn_tpu_torch.ops.aggregate import selection_score
    if rel.has_hubs:
        raise ValueError("cpu_sample_check reads whole rows from the window")
    d = max(rel.window_width, 1)
    rows_d = rows.to(x.device)
    nbr = rel.nbr2d[rows_d].cpu().long()
    deg = rel.deg[rows_d].cpu().long()
    valid = torch.arange(d)[None, :] < deg[:, None]
    xc = torch.cat([x.cpu(), x.new_zeros((1, x.shape[1]), device="cpu")])
    s0c = torch.cat([s0.cpu(), s0.new_zeros(1, device="cpu")])
    xw = torch.where(valid[..., None], xc[nbr].double(), 0.0)
    mean = xw.sum(1) / deg.clamp(min=1)[:, None]
    for name in ("spmm_window", "spmm_ewin", "spmm_segment"):
        check_mean(name, got[name][rows_d].cpu(), mean, errs)
    center = s0c[rows][:, None]
    dist = torch.where(valid, (center - s0c[nbr]).abs(), math.inf)
    dw, vw = (t[rows_d].cpu() for t in got["sddmm_window"])
    check_exact("sddmm_window", (dw, vw), (dist, valid), errs)
    s_n = selection_score(xc[nbr], w0.cpu(), b0.cpu())
    dist_e = torch.where(valid, (center - s_n).abs(), math.inf)
    check_ewin_dist("sddmm_ewin",
                    tuple(t[rows_d].cpu() for t in got["sddmm_ewin"]),
                    (dist_e, valid), errs)
    # each row's edges, at its window's valid slots
    pos = torch.where(valid, rel.indptr[rows_d].cpu().long()[:, None]
                      + torch.arange(d), 0)
    flat = got["sddmm_flat"].cpu()
    check_exact("sddmm_flat", flat[pos][valid], dist[valid], errs)
    span = torch.where(valid, flat[pos], math.inf)
    order = torch.argsort(span, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True).to(torch.int32)
    check_exact("edge_ranks", got["edge_ranks"].cpu()[pos][valid],
                rank[valid], errs)


def full_graph_relation(rel, x, s0, w0, b0, rows=None) -> dict:
    """Phase 22 on one relation: each call once (the path), each
    edge-window call launching the window gather once per node chunk; the
    lowerings held against one another on the card; the segment form
    called again, bit for bit or not; each call against its plain CPU run
    (whole, or at ``rows``); then each call timed with
    ``utils.roofline.measure`` against its bytes."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import sddmm
    from pcgnn_tpu_torch.ops import window_gather as wg
    from pcgnn_tpu_torch.utils.roofline import measure
    n = rel.num_nodes
    mods = kernel_counters()
    start = {k: m.launches for k, m in mods.items()}
    calls = full_graph_calls(rel, x, s0, w0, b0)
    got, launches = {}, {}
    for name, fn, args, _ in calls:
        before = wg.launches
        got[name] = fn(*args)
        launches[name] = wg.launches - before
    name, fn, args, nbytes = ranks_call(rel, got["sddmm_flat"])
    calls.append((name, fn, args, nbytes))
    got[name] = fn(*args)
    torch.cuda.synchronize()
    # the path's launches; the checks and timings below launch more
    path = {k: m.launches - start[k] for k, m in mods.items()}
    want = {"spmm_ewin": -(-n // agg.SPMM_NODE_CHUNK),
            "sddmm_ewin": -(-n // sddmm.SDDMM_NODE_CHUNK)}
    for name, count in launches.items():
        if count != want.get(name, 0) or (name in want and not count):
            raise AssertionError(f"{name} launched the window gather {count} "
                                 f"times, expected {want.get(name, 0)}")
    errs = {}
    # the lowerings against one another on the card
    torch.testing.assert_close(got["spmm_window"], got["spmm_segment"],
                               **MEAN_TOL)
    if not torch.equal(got["spmm_ewin"], got["spmm_window"]):
        raise AssertionError("the edge-window mean differs from the window "
                             "mean on the store's table")
    check_ewin_dist("sddmm_ewin_vs_window", got["sddmm_ewin"],
                    got["sddmm_window"], errs)
    name, fn, args, _ = calls[2]
    again = fn(*args)
    segment_repeats = bool(torch.equal(again, got["spmm_segment"]))
    del again
    t1 = time.time()
    if rows is None:
        cpu_full_check(rel, x, s0, w0, b0, got, errs)
    else:
        cpu_sample_check(rel, x, s0, w0, b0, got, rows, errs)
    cpu_s = time.time() - t1
    del got
    timed = {}
    for name, fn, args, nbytes in calls:
        r = measure(fn, *args, analytic_bytes=nbytes, target_s=FULL_TARGET_S)
        timed[name] = {k: r[k] for k in ("wall_ms", "sol_frac", "sol_ms",
                                          "achieved_gbps", "analytic_bytes")}
    return {"nodes": n, "edges": rel.num_edges, "e_pad": rel.e_pad,
            "window_width": rel.window_width, "ewin_dp": rel.ewin_dp,
            "window_launches": launches, "path_launches": path,
            "segment_repeats": segment_repeats,
            "max_abs_err": errs, "cpu_s": cpu_s,
            "cpu_rows": n if rows is None else len(rows), "timed": timed}


def full_graph_window_case(name, rel, rate: float) -> dict:
    """The window gather at a full-graph call's shape: the starts of
    ``SPMM_NODE_CHUNK`` consecutive nodes, widened to float32 (the call's
    fetch), timed as phase 2 times its cases, over ``TIMING_REPS`` calls
    that take the relation's whole chunks in turn (a profile of yelp-like's
    two chunks alone recorded no kernel in five tries on an H100).
    Consecutive nodes' windows overlap in the store, so the bytes the copy
    must read are the store span the chunk's windows cover, once (not each
    window): the bounds count that span and each window written once.  The
    profiler's kernel time undercounts these write-heavy calls (a widened
    chunk read below its bound), so the back-to-back CUDA-event times are
    the ones reported, and a copy, widening or ``index_select`` run that
    reads under its bound (by more than ``SOL_LIMIT``) fails."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.utils.roofline import SOL_LIMIT
    c = min(agg.SPMM_NODE_CHUNK, rel.num_nodes)
    chunks = max(rel.num_nodes // c, 1)
    starts = [rel.estart[i % chunks * c:(i % chunks + 1) * c]
              for i in range(TIMING_REPS)]
    esize = rel.ewin.element_size()
    a = 16 // esize
    err = check_gather(rel.ewin, starts[0], rel.ewin_dp,
                       out_dtype=torch.float32)
    case = window_case(name, rel.ewin, starts, rel.ewin_dp,
                       strided_rows(rel.ewin, rel.ewin_dp, a),
                       [st // a for st in starts], rate=rate)
    span = float(np.mean([int(st[-1]) + rel.ewin_dp - int(st[0])
                          for st in starts])) * esize
    written = c * rel.ewin_dp
    case.update(bytes=span + written * esize + c * 8,
                widen_bytes=span + written * 4 + c * 8,
                span_bytes=span, max_abs_err=err)
    case["bound_ms"] = case["bytes"] / rate * 1e3
    case["widen_bound_ms"] = case["widen_bytes"] / rate * 1e3
    for key, bound in (("run_ms", "bound_ms"), ("library_run_ms", "bound_ms"),
                       ("widen_run_ms", "widen_bound_ms")):
        if case[key] * SOL_LIMIT < case[bound]:
            raise AssertionError(f"{name}: {key} {case[key]:.4f} reads under "
                                 f"its bound {case[bound]:.4f} ms; the timing "
                                 f"or the byte count is wrong")
    return case


def full_graph_inputs(g, rel):
    """(x, s0, w0, b0): the table ``rel``'s store holds (the features,
    bf16-rounded in a bf16 store), random weights from a seed, and the
    scores of that table."""
    from pcgnn_tpu_torch.ops.aggregate import selection_score
    gen = torch.Generator().manual_seed(22)
    f = g.feat_dim
    w0 = (torch.randn(f, generator=gen) / math.sqrt(f)).to(g.features.device)
    b0 = torch.tensor(0.25, device=g.features.device)
    x = g.features.to(rel.ewin.dtype).float()
    return x, selection_score(x, w0, b0), w0, b0


def full_graph_phase(graphs: dict, rate: float, card: str) -> dict:
    """Phase 22: every relation of each graph (``full_graph_relation``;
    stress-1m's CPU check on ``FULL_SAMPLE_ROWS`` seeded rows), with every
    kernel count set to 0 just before and its path calls' launches summed;
    then the window gather at the path's shape, on each graph's largest
    relation."""
    mods = kernel_counters()
    for mod in mods.values():
        mod.launches = 0
    out = {"graphs": {}, "launches": dict.fromkeys(mods, 0)}
    for gname, g in graphs.items():
        rels = {}
        for r, rel in enumerate(g.relations):
            x, s0, w0, b0 = full_graph_inputs(g, rel)
            rows = None
            if g.num_nodes > 100_000:
                gen = torch.Generator().manual_seed(r)
                rows = torch.randperm(g.num_nodes, generator=gen)[
                    :FULL_SAMPLE_ROWS]
            t1 = time.time()
            rels[r] = full_graph_relation(rel, x, s0, w0, b0, rows)
            rels[r]["seconds"] = time.time() - t1
            for k, count in rels[r]["path_launches"].items():
                out["launches"][k] += count
            for name, tm in rels[r]["timed"].items():
                print(f"phase 22, {gname} relation {r} {name}: "
                      f"{tm['wall_ms']:.4f} ms, sol_frac {tm['sol_frac']:.4f} "
                      f"(bound {tm['sol_ms']:.4f} ms); on {card}")
            print(f"phase 22, {gname} relation {r}: segment form repeats bit "
                  f"for bit: {rels[r]['segment_repeats']}; window gathers "
                  f"{rels[r]['window_launches']}", file=sys.stderr)
        out["graphs"][gname] = rels
    for gname, g in graphs.items():
        big = max(range(g.num_relations),
                  key=lambda r: g.relations[r].num_edges)
        out[gname] = {"relation": big,
                      "window_case": full_graph_window_case(
                          f"full_graph_{gname}_relation_{big}",
                          g.relations[big], rate)}
    return out


def single_step_phase(t, card: str, label: str = "phase 22") -> dict:
    """Phase 22, last: ``Trainer.single_step`` on ``t``'s graph at its
    configuration, timed with ``utils.roofline.measure`` at ``nscan`` 1
    and 16 against ``pcgnn_step_streaming_bytes`` (the JAX bench's
    roofline reading, ``bench.py:116-121``), whose score product reads the
    rows the lane scores: the whole table, or the train positives where
    the forward scores from the window: printed, no claim."""
    from pcgnn_tpu_torch.utils.roofline import (measure,
                                                pcgnn_step_streaming_bytes)
    rng = np.random.default_rng(0)
    rb = rng.choice(t.idx_train, t.batch_size)
    ry = t.graph.labels.cpu().numpy()[rb]
    rw = np.ones(t.batch_size, np.float32)
    m_max = t.new_model().minor_window(int(t.train_pos_dev.shape[0]),
                                       t.graph.relations)
    scored = (int(t.train_pos_dev.shape[0]) if scores_from_window(t.graph)
              else None)
    step_bytes = pcgnn_step_streaming_bytes(t.graph, t.batch_size, m_max,
                                            t.config["emb_size"],
                                            scored_rows=scored)
    out = {"step_bytes": step_bytes, "m_max": m_max, "scored_rows": scored}
    for nscan in (1, 16):
        model = t.new_model()
        fn, args = t.single_step(model, t.new_optimizer(model), rb, ry, rw,
                                 nscan=nscan)
        r = measure(fn, *args, analytic_bytes=step_bytes * nscan)
        out[nscan] = {"step_ms": r["wall_ms"] / nscan,
                      "sol_frac": r["sol_frac"], "device": r["device"]}
        print(f"{label}, single_step nscan {nscan}: "
              f"{out[nscan]['step_ms']:.4f} ms a step, sol_frac "
              f"{r['sol_frac']:.6f}; on {card}")
    return out


# ------------------------------------------------ phase 23: sharded steps

# two gloo ranks share the card at (data 1, graph 2): the only way one card
# runs a sharded step (NCCL refuses two ranks on one device).  They give no
# scaling number: both ranks' kernels and the gloo host round trips share
# one card and one host
SHARD_RANKS = 2
SHARD_STEPS = 3
# phase 23(d): steps of each turn, eager and captured
SHARD_CAPTURE_STEPS = 4
SHARD_TIMEOUT_S = 600.0
# case: (graph file, model, edge_windows, fused record table)
SHARD_CASES = {
    "yelp-like fused": ("like", "PCGNN", True, True),
    "yelp-like store lane": ("like", "PCGNN", True, False),
    "yelp-skew stores": ("skew", "PCGNN", True, True),
    "yelp-skew no stores": ("skew", "PCGNN", False, False),
    "amazon_new-like GCN": ("amazon", "GCN", True, False),
    "amazon_new-like SAGE": ("amazon", "SAGE", True, False),
}


def sharded_reference(t, graph, edge_windows: bool) -> dict:
    """The single-process step's inputs and values on the card, for one
    phase-23 case: the initial weights, the first epoch's batch with the
    most hub rows, the loss and the gradients (no optimizer step)."""
    batches, weights = t.epoch_plan(0)
    i = int(np.argmax([hub_rows(t, bt) for bt in batches]))
    bt, wt = batches[i], weights[i]
    model = t.new_model()
    init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    y = t.labels[bt]
    if t.is_pcgnn:
        loss = model.loss(graph, bt, y, wt, train_pos=t.consts["tp"],
                          train_pos_valid=t.consts["tpv"],
                          train_pos_feats=t.consts["tpf"])
    else:
        loss = model.loss(graph, bt, y, wt)
    loss.backward()
    return {"init": init, "batch": bt.cpu(), "y": y.cpu(), "w": wt.cpu(),
            "tp": t.consts["tp"].cpu(), "tpv": t.consts["tpv"].cpu(),
            "hub_rows": hub_rows(t, bt), "loss": loss.item(),
            "grads": {k: p.grad.detach().cpu().clone()
                      for k, p in model.named_parameters()}}


def sharded_cli_config(port: int, rank: int) -> dict:
    """Phase 23b's run: the bench configuration for 2 epochs, validated
    after each, as a distributed rank of a gloo group on cuda:0."""
    return dict(BENCH_CFG, epochs=2, valid_epochs=1, distributed=True,
                coordinator_address=f"localhost:{port}",
                num_processes=SHARD_RANKS, process_id=rank, mesh_graph=2,
                dist_backend="gloo")


def sharded_case_trainer(g, name: str, port: int, rank: int, work: str):
    """This rank's ``Trainer`` of one phase-23 case on graph ``g`` (no
    stores; the trainer shards it and builds its block's stores): the
    case's configuration as a ``distributed: true`` rank of the running
    gloo group at (1, 2); the per-relation store lane has no fused
    table."""
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    gkey, model_name, ew, fused = SHARD_CASES[name]
    cfg = {"PCGNN": BENCH_CFG, "GCN": GCN_CFG, "SAGE": SAGE_CFG}[model_name]
    cfg = dict(cfg, edge_windows=ew, distributed=True,
               coordinator_address=f"localhost:{port}",
               num_processes=SHARD_RANKS, process_id=rank,
               mesh_graph=SHARD_RANKS, dist_backend="gloo")
    root = os.path.join(work, f"case{rank}-{gkey}-{model_name}")
    t = Trainer(cfg, graph=g, device="cuda:0",
                result=ResultManager(cfg, root=root))
    if not fused:
        t.sharded = dataclasses.replace(t.sharded, fused=None, fused_off=())
    return t


def sharded_capture_turns(t) -> dict:
    """Phase 23(d) on one case, on this rank: for the collectives async and
    blocking, ``SHARD_CAPTURE_STEPS`` steps eager and the same steps
    captured, each from the same initial weights, in turns (eager,
    captured, captured, eager); after the second and the fourth turn the
    two must hold the same bits (losses, parameters, Adam state).  The
    captured run's second turn is replays only: its host syncs
    (``count_syncs``: the hub plan's read-back, one a stack with hubs) and
    gloo's round trips (the collectives' count in ``mesh.stats``, the
    plan's one graph collective apart).  Then the validation split
    evaluated eagerly (``Trainer.predict`` a batch) and captured
    (``Trainer.evaluate``) twice, the first with the capture: the same
    probabilities, bit for bit.  Returns
    each schedule's step ms (CUDA events; the captured run's warm-up step
    left out), pieces and collectives a step, syncs and round trips, the
    kernels the card ran a step, capture seconds and graph-pool bytes,
    and the evaluates' seconds."""
    from pcgnn_tpu_torch.train.metrics import evaluate
    from pcgnn_tpu_torch.parallel.spmd import plan_relations
    stack = capture_stack(t, SHARD_CAPTURE_STEPS)
    hubs = any(sh.has_hubs for sh in plan_relations(t.sharded))
    out = {}
    mesh = t.mesh
    for overlap in (True, False):
        t.sharded = dataclasses.replace(t.sharded, mesh=dataclasses.replace(
            mesh, overlap=overlap))
        runs = {}
        for capture in (False, True):
            t.capture = capture
            model = t.new_model()
            opt = t.new_optimizer(model)
            r = t.runner(model, opt)
            r.step_hook = StepEvents(r)
            runs[capture] = [model, opt, r, None]
        t.capture, t._runner = True, None
        rec = {}
        for i, capture in enumerate((False, True, True, False)):
            model, opt, r, _ = runs[capture]
            if i == 2:
                was = mesh.stats.snapshot()
                got = []
                rec["explicit_syncs_per_stack"] = count_syncs(
                    lambda: got.append(r.run(*stack)))
                runs[capture][3] = got[0]
                now = mesh.stats.snapshot()
                rec["gloo_round_trips_per_stack"] = (
                    now["host_syncs"] - was["host_syncs"])
                rec["collectives_per_stack"] = {
                    a: now["calls"][a] - was["calls"][a]
                    for a in now["calls"]}
            else:
                runs[capture][3] = r.run(*stack)
            torch.cuda.synchronize()
            if i in (1, 3) and not same_bits(
                    [runs[False][0], runs[False][1], runs[False][3]],
                    [runs[True][0], runs[True][1], runs[True][3]]):
                raise AssertionError(
                    f"{run_name(t)} (overlap {overlap}): eager and captured "
                    f"sharded steps differ after "
                    f"{SHARD_CAPTURE_STEPS * (i + 1) // 2} steps")
        r = runs[True][2]
        steps = SHARD_CAPTURE_STEPS
        # the plan's owner pick (with hubs and dg > 1) is the stack's one
        # collective outside the replays
        plan_calls = int(hubs and mesh.dg > 1)
        rec.update({
            "step_ms_median": {
                "eager": float(np.median(runs[False][2].step_hook.step_ms())),
                "captured": float(np.median(r.step_hook.step_ms()[1:]))},
            "pieces": r.pieces, "collectives": r.collectives,
            "captures": r.captures, "capture_s": r.capture_s,
            "graph_pool_bytes": r.pool_bytes,
            "card_launches_per_step": dict(r.replay_launches),
            "plan_collectives_per_stack": plan_calls,
            "gloo_round_trips_per_step":
                (rec["gloo_round_trips_per_stack"] - plan_calls) / steps,
            "hub_plans": r.plans})
        if r.captures != 1 or r.pieces < 2 \
                or rec["explicit_syncs_per_stack"] != int(hubs) \
                or rec["gloo_round_trips_per_step"] != r.collectives:
            raise AssertionError(f"{run_name(t)} (overlap {overlap}): the "
                                 f"captured sharded run: {rec}")
        # the validation split, eager a batch and captured
        model = runs[True][0]
        for k in list(runs):
            runs[k] = None
        t1 = time.perf_counter()
        want = evaluate(lambda b: t.predict(model, b), t.idx_valid,
                        t.y_valid, t.batch_size, print_line=False)
        eager_s = time.perf_counter() - t1
        captured_s = []
        for _ in range(2):
            t1 = time.perf_counter()
            got = t.evaluate(model, t.idx_valid, t.y_valid, print_line=False)
            captured_s.append(time.perf_counter() - t1)
            if not (np.array_equal(got.anomaly_confidence,
                                   want.anomaly_confidence)
                    and got.auc == want.auc):
                raise AssertionError(f"{run_name(t)} (overlap {overlap}): "
                                     f"the captured sharded evaluate "
                                     f"differs (AUC {got.auc} against "
                                     f"{want.auc})")
        pr = t.predict_runner(model)
        # the first captured evaluate holds the capture, the second
        # replays only
        rec["evaluate"] = {"auc": got.auc, "eager_s": eager_s,
                           "captured_s": captured_s,
                           "capture_s": pr.capture_s, "pieces": pr.pieces,
                           "collectives": pr.collectives,
                           "graph_pool_bytes": pr.pool_bytes,
                           "batches": eval_batches(t)}
        t._predict_runner = None
        out["on" if overlap else "off"] = rec
    t.sharded = dataclasses.replace(t.sharded, mesh=mesh)
    return out


def sharded_rank_main(argv) -> int:
    """One rank of phase 23 (``chip_smoke.py --sharded-rank R PORT WORK``):
    (b) the distributed trainer through the CLI, then (a) each case's
    sharded loss, gradients and 3 steps on the graphs the parent saved,
    with kernel launches, collectives, host syncs, step times and peak
    memory, and (d) its eager and captured steps and evaluates in turns;
    results to ``WORK/rank<R>.pt``."""
    from pcgnn_tpu_torch import cli
    from pcgnn_tpu_torch.models import build_model
    from pcgnn_tpu_torch.parallel import spmd
    from pcgnn_tpu_torch.train.trainer import make_optimizer
    rank, port, work = int(argv[0]), int(argv[1]), argv[2]
    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    mods = kernel_counters()
    from pcgnn_tpu_torch.ops import window_gather as wg
    out = {"rank": rank}

    def counts(runners=()):
        """The kernels the card ran since ``zero_counts`` (through
        ``runners``), the masked fetch (kernel 1c) apart from kernel 1."""
        c = card_launches({k: m.launches for k, m in mods.items()}
                          | {"window_gather_masked": wg.masked_launches},
                          runners)
        c["window_gather"] -= c["window_gather_masked"]
        return c

    def zero_counts():
        for m in mods.values():
            m.launches = 0
        wg.masked_launches = 0

    # (b) the trainer through the CLI's entry, as a distributed rank
    made = []

    class Recording(cli.Trainer):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    cli.Trainer = Recording
    rank_dir = os.path.join(work, f"cli{rank}")
    os.makedirs(rank_dir, exist_ok=True)
    cfg_path = os.path.join(rank_dir, "config.json")
    with open(cfg_path, "w") as f:
        json.dump(sharded_cli_config(port, rank), f)
    cwd = os.getcwd()
    os.chdir(rank_dir)
    t1 = time.time()
    zero_counts()
    try:
        with runners_made() as cli_runners:
            auc, _, _ = cli.main(["--exp_config_path", cfg_path,
                                  "--device", "cuda:0"])
    finally:
        os.chdir(cwd)
    tr = made[0]
    step_rs = step_runners(cli_runners)
    out["cli"] = {"test_auc": float(auc), "seconds": time.time() - t1,
                  "epoch_losses": tr.epoch_losses,
                  "epoch_ms": [s * 1e3 for s in tr.epoch_times],
                  "steps": tr.num_batches * len(tr.epoch_losses),
                  "mesh": tr.mesh.shape, "launches": counts(cli_runners),
                  "captured": tr.capture,
                  "pieces": [r.pieces for r in step_rs],
                  "collectives": [r.collectives for r in step_rs],
                  "step_ms_median": float(np.median(
                      [ms for r in step_rs
                       for ms in r.step_hook.step_ms()[1:]]))}
    del tr, made[:], cli_runners, step_rs

    # (a) the cases, once the parent has saved the graphs and references
    ready = os.path.join(work, "ready")
    while not os.path.exists(ready):
        time.sleep(0.2)
    if open(ready).read() != "ok":
        return 1
    graphs = {}
    out["cases"] = {}
    for name, (gkey, model_name, ew, fused) in SHARD_CASES.items():
        if gkey not in graphs:
            graphs[gkey] = torch.load(os.path.join(work, f"graph-{gkey}.pt"),
                                      weights_only=False)
        g = graphs[gkey]
        ref = torch.load(os.path.join(work, f"case-{name}.pt"),
                         weights_only=False)
        pcgnn = model_name == "PCGNN"
        # the case's trainer shards the graph (bf16 block stores, the
        # fused table unless the case is the store lane) on a mesh of its
        # own, which (a) takes too
        t1 = time.time()
        t = sharded_case_trainer(g, name, port, rank, work)
        sg, mesh = t.sharded, t.mesh
        torch.cuda.synchronize()
        shard_s = time.time() - t1
        kw = (dict(num_relations=g.num_relations, alpha=BENCH_CFG["alpha"],
                   rho=BENCH_CFG["rho"]) if pcgnn else {})
        model = build_model(model_name, feat_dim=g.feat_dim,
                            emb_dim=BENCH_CFG["emb_size"], **kw).to(dev)
        model.load_state_dict(ref["init"])
        cfg = BENCH_CFG if pcgnn else GCN_CFG
        opt = make_optimizer(model, cfg["lr"], cfg["weight_decay"])
        bt, y, wt = (ref[k].to(dev) for k in ("batch", "y", "w"))
        consts = {"tp": ref["tp"].to(dev), "tpv": ref["tpv"].to(dev)}
        consts["tpf"] = g.features[ref["tp"]].to(dev)
        torch.cuda.reset_peak_memory_stats()
        # the phase's main path: one loss and gradients, then 3 steps,
        # with every count at 0 just before
        zero_counts()
        mesh.stats.reset()
        if pcgnn:
            loss, local = spmd.spmd_loss(model, sg, bt, y, wt, consts["tp"],
                                         consts["tpv"],
                                         train_pos_feats=consts["tpf"],
                                         fused=fused)
        else:
            loss, local = spmd.spmd_homo_loss(model, sg, bt, y, wt)
        local.backward()
        spmd.data_sum_grads(model, mesh)
        grads = {k: p.grad.detach().cpu().clone()
                 for k, p in model.named_parameters()}
        step_ms = []
        for _ in range(SHARD_STEPS):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            spmd.spmd_train_step(model, opt, sg, bt, y, wt, consts)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t1) * 1e3)
        calls = SHARD_STEPS + 1
        launches = counts()
        stats = mesh.stats.snapshot()
        params = {k: p.detach().cpu().clone()
                  for k, p in model.named_parameters()}
        rec = {"loss": float(loss), "grads": grads, "params": params,
               "shard_s": shard_s, "step_ms": step_ms,
               "step_ms_median": float(np.median(step_ms)),
               "launches": launches,
               "launches_per_step": {k: v / calls
                                     for k, v in launches.items()},
               "collectives_per_step": {
                   "calls": {a: n / calls for a, n in stats["calls"].items()},
                   "bytes": {a: n / calls for a, n in stats["bytes"].items()}},
               "gloo_host_round_trips_per_step": stats["host_syncs"] / calls,
               "peak_mem_bytes": torch.cuda.max_memory_allocated(),
               "stores": [sh.ewin is not None for sh in
                          (sg.shards if pcgnn else (sg.homo,))],
               "fused": sg.fused is not None}
        # host reads the step makes itself (outside the counted run)
        rec["explicit_syncs_per_step"] = count_syncs(
            lambda: spmd.spmd_train_step(model, opt, sg, bt, y, wt, consts))
        rec["overlap"] = overlap_turns(model, opt, sg, bt, y, wt, consts,
                                       mesh, pcgnn, fused)
        if not fused and ew and pcgnn:
            rec["masked_fetch"] = masked_fetch_check(sg, bt, mesh)
        # (d) eager against captured through the trainer, counts from 0
        del model, opt, sg
        zero_counts()
        with runners_made() as runners:
            rec["captured"] = sharded_capture_turns(t)
        rec["captured_launches"] = counts(runners)
        out["cases"][name] = rec
        del t, runners
        torch.cuda.empty_cache()
    torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def launches_between_markers(prof) -> dict:
    """{collective: [kernel launches]}: for each async collective of a
    profiled run (``parallel.mesh``'s zero-length ``collective_issue:`` and
    ``collective_wait:`` ranges, paired in order), the kernel launches the
    host made between its issue and its wait."""
    from torch.autograd import DeviceType
    issue, wait, launch = {}, {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CPU:
            continue
        t = e.time_range.start
        kind, _, name = e.name.partition(":")
        if kind == "collective_issue":
            issue.setdefault(name, []).append(t)
        elif kind == "collective_wait":
            wait.setdefault(name, []).append(t)
        elif "LaunchKernel" in e.name:
            launch.append(t)
    return {name: [sum(t0 <= t <= t1 for t in launch)
                   for t0, t1 in zip(sorted(ts), sorted(wait.get(name, [])))]
            for name, ts in issue.items()}


# phase 23's overlap turns: the schedule of each timed step (on, off, off,
# on), so both see the host at the same moments
OVERLAP_TURNS = (True, False, False, True, True, False, False, True)


def overlap_turns(model, opt, sg, bt, y, wt, consts, mesh, pcgnn: bool,
                  fused: bool) -> dict:
    """Phase 23's collective-overlap reading on one case, on this rank: the
    loss and gradients on ``mesh`` (overlap on) and on its blocking copy
    from the same weights must be the same bits; then steps timed in turns
    (``OVERLAP_TURNS``), the host syncs of one step each way, and one
    profiled step each way with the kernel launches between each async
    collective's issue and its wait (none exist with overlap off: every
    collective completes where it is issued)."""
    from torch.profiler import ProfilerActivity, profile

    from pcgnn_tpu_torch.parallel import spmd

    # the sharded graph on the mesh built (overlap on) and on its blocking
    # copy: the same shards and groups
    sgs = {True: sg, False: dataclasses.replace(
        sg, mesh=dataclasses.replace(mesh, overlap=False))}

    def loss_grads(sg):
        model.zero_grad(set_to_none=True)
        if pcgnn:
            loss, local = spmd.spmd_loss(
                model, sg, bt, y, wt, consts["tp"], consts["tpv"],
                train_pos_feats=consts["tpf"], fused=fused)
        else:
            loss, local = spmd.spmd_homo_loss(model, sg, bt, y, wt)
        local.backward()
        spmd.data_sum_grads(model, mesh)
        return [loss.detach().clone()] + [p.grad.detach().clone()
                                          for p in model.parameters()]

    def step(sg):
        spmd.spmd_train_step(model, opt, sg, bt, y, wt, consts)

    out = {"step_ms": {"on": [], "off": []}, "explicit_syncs": {},
           "launches_between": {}}
    got = {on: loss_grads(s) for on, s in sgs.items()}
    out["bit_equal"] = all(torch.equal(a, b)
                           for a, b in zip(got[True], got[False]))
    out["loss"] = float(got[True][0])
    if not out["bit_equal"]:
        raise AssertionError(
            f"overlap on and off differ: loss {float(got[True][0])!r} "
            f"vs {float(got[False][0])!r}")
    for on in OVERLAP_TURNS:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        step(sgs[on])
        torch.cuda.synchronize()
        out["step_ms"]["on" if on else "off"].append(
            (time.perf_counter() - t1) * 1e3)
    for on, s in sgs.items():
        key = "on" if on else "off"
        out["explicit_syncs"][key] = count_syncs(lambda: step(s))
        mesh.stats.reset()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step(s)
            torch.cuda.synchronize()
        out["launches_between"][key] = launches_between_markers(prof)
        st = mesh.stats.snapshot()
        out.setdefault("schedule", {})[key] = [
            w for w in st["waits"]
            if w["collectives_between"] or w["ops_between"]]
        out.setdefault("async_calls", {})[key] = st["async_calls"]
        out.setdefault("host_round_trips", {})[key] = st["host_syncs"]
    out["step_ms_median"] = {k: float(np.median(v))
                             for k, v in out["step_ms"].items()}
    return out


def masked_fetch_check(sg, batch, mesh) -> dict:
    """Kernel 1c against its plain version on this rank's block of the
    batch: skipped rows exactly 0 (the memory is filled with NaN and freed
    first), owned rows equal the plain copy exactly."""
    from pcgnn_tpu_torch.ops.window_gather import window_gather_plain
    from pcgnn_tpu_torch.parallel import spmd
    b = mesh.batch_block(batch)
    local = b - sg.col_lo
    mine = (local >= 0) & (local < sg.block)
    out = {"rows": int(b.shape[0]), "owned": int(mine.sum())}
    for r, sh in enumerate(sg.shards):
        starts = sh.estart[local.clamp(0, sg.block - 1)]
        junk = torch.full((b.shape[0], sh.ewin_dp), float("nan"),
                          device=b.device)
        del junk
        got = spmd.sharded_feature_window(sh, starts, mine)
        want = window_gather_plain(sh.ewin, starts, sh.ewin_dp,
                                   out_dtype=torch.float32)
        want = want[:, : got.shape[1] * got.shape[2]].view_as(got)
        torch.cuda.synchronize()
        zero = bool((got[~mine] == 0).all())
        err = float((got[mine] - want[mine]).abs().max())
        if not zero or err != 0.0:
            raise AssertionError(f"masked fetch of relation {r}: skipped "
                                 f"rows zero {zero}, owned rows differ by "
                                 f"{err}")
        out[f"rel{r}_max_abs_err"] = err
    return out


def nccl_phase(t, card: str) -> dict:
    """Phase 23c: a 1-rank NCCL group on cuda:0 initializes and
    all-reduces once; a Trainer joined to it trains at the (1, 1) mesh,
    where every collective is elided, so its captured step is one piece
    with no collective, and ``SHARD_CAPTURE_STEPS`` captured steps equal
    the single-rank trainer's captured steps exactly (losses and
    parameters): both add their oversampled minors with the oversample
    kernel."""
    import torch.distributed as dist

    from pcgnn_tpu_torch.parallel.distributed import init_distributed
    from pcgnn_tpu_torch.train.trainer import Trainer
    from pcgnn_tpu_torch.utils.multiproc import free_port
    torch.cuda.set_device(0)
    t1 = time.time()
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        x = torch.full((1024,), 2.0, device="cuda:0")
        dist.all_reduce(x)
        if not bool((x == 2.0).all()):
            raise AssertionError("the 1-rank NCCL all-reduce changed values")
        init_s = time.time() - t1
        rank = Trainer(dict(t.config, distributed=True), device="cuda:0",
                       graph=t.graph.without_stores())
        if rank.mesh.backend != "nccl" or rank.mesh.size != 1:
            raise AssertionError(f"the NCCL rank's mesh is {rank.mesh}")
        got = []
        for tr in (t, rank):
            model = tr.new_model()
            opt = tr.new_optimizer(model)
            r = tr.runner(model, opt)
            loss = r.run(*capture_stack(tr, SHARD_CAPTURE_STEPS))
            got.append((loss, [p.detach() for p in model.parameters()], r))
        exact = bool(torch.equal(got[0][0], got[1][0]) and all(
            torch.equal(a, b) for a, b in zip(got[0][1], got[1][1])))
        r = got[1][2]
        if not exact or (r.pieces, r.collectives, r.captures) != (1, 0, 1):
            raise AssertionError(f"the (1, 1) NCCL captured steps differ "
                                 f"from the single-rank ones, or are not "
                                 f"one piece a step: losses {got[1][0]} vs "
                                 f"{got[0][0]}, {r.stats()}")
        pieces = {"pieces": r.pieces, "collectives": r.collectives}
        t._runner = rank._runner = None
        del got, r
        calls = rank.mesh.stats.snapshot()
    finally:
        dist.destroy_process_group()
    return {"init_s": init_s, "loss": float(loss[-1]), "exact": exact,
            "captured": pieces, "collectives": calls, "card": card}


def masked_window_case(t, refs, rate: float) -> dict:
    """Kernel 1c at the sharded store lane's shape, as phase 2 times a
    window: graph rank 0's block store of yelp-like's largest relation
    (dg = 2, bf16), the batches' starts in it, ``active`` = the rows the
    rank owns (about half); checked against the plain version, then
    timed with reads from memory (``window_case``)."""
    from pcgnn_tpu_torch.parallel import spmd
    dg = SHARD_RANKS
    g = t.graph
    rel = g.without_stores().relations[-1]
    mesh = single_rank_like(dg)
    n_pad = -(-g.num_nodes // dg) * dg
    sh = spmd.shard_relation(rel, mesh, n_pad, g.features,
                             ewin_dtype=torch.bfloat16, device=t.device)
    block = n_pad // dg
    gen = torch.Generator(device=t.device).manual_seed(1)
    batches = [refs["yelp-like store lane"]["batch"].to(t.device)] + [
        t.idx_train_dev[torch.randint(len(t.idx_train), (t.batch_size,),
                                      generator=gen, device=t.device)]
        for _ in range(TIMING_REPS - 1)]
    mine = [(bt < block) for bt in batches]
    starts = [sh.estart[bt.clamp(max=block - 1)] for bt in batches]
    # one active mask for the timed calls (the first batch's), as the
    # kernel takes one per call
    active = mine[0].to(torch.int32)
    err = max(check_gather(sh.ewin, s, sh.ewin_dp, m.to(torch.int32),
                           torch.float32) for s, m in zip(starts, mine))
    a = 16 // sh.ewin.element_size()
    # reads from memory, as a training step's are: a 256 MB overwrite
    # before each call (left out of the device time), as phase 18 times
    # the homo store; a warm L2 holds much of the 6.6 MB a call reads
    flush = torch.empty(1 << 26, device=t.device)
    c = window_case("sharded_store_masked", sh.ewin, starts, sh.ewin_dp,
                    strided_rows(sh.ewin, sh.ewin_dp, a),
                    [s // a for s in starts], rate=rate, active=active,
                    flush=flush)
    c["max_abs_err"] = err
    # queued ahead of the card over the 30 batches, as phase 2's
    c["queued"] = queued_window(sh.ewin, starts, sh.ewin_dp,
                                strided_rows(sh.ewin, sh.ewin_dp, a),
                                [s // a for s in starts], rate=rate,
                                active=active)
    return c


def single_rank_like(dg: int):
    """Graph rank 0 of a (1, dg) mesh, for building one block's shards in
    this process (no collective is called)."""
    from pcgnn_tpu_torch.parallel.mesh import RankMesh
    return RankMesh(shape={"dcn": 1, "data": 1, "graph": dg}, rank=0,
                    host=0, data_index=0, graph_index=0)


def sharded_phase(trainers, gcn, sage, card: str, rate: float) -> dict:
    """Phase 23: the sharded step on the card.  Two gloo ranks share
    cuda:0 at (data 1, graph 2) (children of this process; the kernels are
    built here first): (b) the distributed trainer through the CLI, AUC
    above 0.5 and the same on both ranks, the first epoch's mean loss
    within rtol 1e-4 of the single-process run (phase 3's); (a) each case
    of ``SHARD_CASES``: loss (rtol 1e-5) and gradients (rtol 1e-4, atol
    1e-6) equal to the single-process step's, parameters bit-equal across
    the ranks after 3 steps, the kernels of its lanes launched; the masked
    fetch checked (phase 23a's store lane).  Then (c), ``nccl_phase``."""
    from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                                 run_workers, worker_env)
    like, skew = trainers[0], trainers[1]
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_sharded-", dir="build")
    t0 = time.time()
    try:
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            gang = pool.submit(gang_with_fresh_port, lambda port: run_workers(
                [os.path.abspath(__file__), "--sharded-rank"],
                [(r, port, work) for r in range(SHARD_RANKS)],
                env=worker_env(), timeout=SHARD_TIMEOUT_S))
            status = "abort"
            try:
                refs = sharded_references(like, skew, gcn, sage, work)
                status = "ok"
            finally:
                with open(os.path.join(work, "ready"), "w") as f:
                    f.write(status)
            logs = gang.result()
        ranks = [torch.load(os.path.join(work, f"rank{r}.pt"),
                            weights_only=False) for r in range(SHARD_RANKS)]
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"seconds_gang": time.time() - t0, "card": card,
           "scaling": "none: two gloo ranks share one card and one host",
           "cli": sharded_cli_check(ranks, like), "cases": {}}
    for name, (gkey, model_name, ew, fused) in SHARD_CASES.items():
        out["cases"][name] = sharded_case_check(name, refs[name],
                                                [r["cases"][name]
                                                 for r in ranks])
    for name, c in out["cases"].items():
        ov = c["ranks"][0]["overlap"]
        under = ov["launches_between"]["on"]
        print(f"phase 23 overlap, {name} (rank 0): step ms on "
              f"{ov['step_ms_median']['on']:.2f} / off "
              f"{ov['step_ms_median']['off']:.2f}; kernel launches between "
              f"issue and wait {under}; host syncs on/off "
              f"{ov['explicit_syncs']['on']}/{ov['explicit_syncs']['off']}; "
              f"loss and gradients bit-equal ({card})", file=sys.stderr)
        for r, rk in enumerate(c["ranks"]):
            for sched, x in rk["captured"].items():
                ev = x["evaluate"]
                print(f"phase 23(d), {name} rank {r}, overlap {sched}: "
                      f"eager and captured bit-equal after "
                      f"{2 * SHARD_CAPTURE_STEPS} steps; step ms eager "
                      f"{x['step_ms_median']['eager']:.3f}, captured "
                      f"{x['step_ms_median']['captured']:.3f}; {x['pieces']} "
                      f"pieces, {x['collectives']} collectives a step; gloo "
                      f"round trips a step "
                      f"{x['gloo_round_trips_per_step']:.0f}, plan "
                      f"collectives / read-backs a stack "
                      f"{x['plan_collectives_per_stack']} / "
                      f"{x['explicit_syncs_per_stack']}; card launches a "
                      f"step {x['card_launches_per_step']}; capture "
                      f"{x['capture_s']:.2f} s, graph pool "
                      f"{x['graph_pool_bytes'] / 2**20:.1f} MB; evaluate of "
                      f"{ev['batches']} batches bit-equal, eager "
                      f"{ev['eager_s']:.3f} s, captured "
                      f"{ev['captured_s'][0]:.3f} s with its capture "
                      f"({ev['capture_s']:.2f} s, {ev['pieces']} pieces), "
                      f"{ev['captured_s'][1]:.3f} s replays only ({card})",
                      file=sys.stderr)
    out["rank_log_tail"] = logs[0][-1500:]
    out["masked_case"] = masked_window_case(like, refs, rate)
    # the phase's launches by kernel, both ranks: the CLI run and every
    # case's counted runs, eager (a) and through the trainer (d)
    out["launches"] = {k: sum(r["cli"]["launches"][k]
                              + sum(c["launches"][k]
                                    + c["captured_launches"][k]
                                    for c in r["cases"].values())
                              for r in ranks)
                       for k in ranks[0]["cli"]["launches"]}
    t1 = time.time()
    out["nccl"] = nccl_phase(like, card)
    out["nccl"]["seconds"] = time.time() - t1
    return out


def sharded_references(like, skew, gcn, sage, work) -> dict:
    """Save phase 23's graphs (without stores, on the host) and each
    case's single-process inputs and values for the ranks."""
    owners = {"like": like, "skew": skew, "amazon": gcn}
    for key, t in owners.items():
        torch.save(t.graph.without_stores().to("cpu"),
                   os.path.join(work, f"graph-{key}.pt"))
    baselines = {"GCN": gcn, "SAGE": sage}
    refs = {}
    for name, (gkey, model_name, ew, fused) in SHARD_CASES.items():
        t = baselines.get(model_name) or owners[gkey]
        graph = t.graph
        if not ew:
            graph = graph.without_stores()
        elif not fused:
            graph = dataclasses.replace(graph, fused=None, fused_off=())
        refs[name] = sharded_reference(t, graph, ew)
        torch.save({k: v for k, v in refs[name].items()
                    if k not in ("loss", "grads", "hub_rows")},
                   os.path.join(work, f"case-{name}.pt"))
    return refs


def sharded_cli_check(ranks, like) -> dict:
    """Phase 23b's checks on the ranks' reports."""
    clis = [r["cli"] for r in ranks]
    aucs = [c["test_auc"] for c in clis]
    if not all(a > 0.5 for a in aucs) or len(set(aucs)) != 1:
        raise AssertionError(f"the distributed trainer's AUC per rank: "
                             f"{aucs}")
    losses = like_epoch_losses(like)
    got = clis[0]["epoch_losses"][0]
    if not math.isclose(got, losses[0], rel_tol=1e-4):
        raise AssertionError(f"first epoch mean loss {got}, single process "
                             f"{losses[0]}")
    if any(c["launches"]["window_gather"] < c["steps"] for c in clis):
        raise AssertionError(f"a distributed step launched no fused fetch: "
                             f"{[c['launches'] for c in clis]}")
    if not all(c["captured"] and min(c["pieces"]) > 1 for c in clis):
        raise AssertionError(f"the distributed trainer did not train "
                             f"captured pieces: {clis}")
    return {"test_auc": aucs, "first_epoch_loss": got,
            "single_first_epoch_loss": losses[0],
            "epoch_ms": [c["epoch_ms"] for c in clis],
            "steps": clis[0]["steps"], "mesh": clis[0]["mesh"],
            "launches": [c["launches"] for c in clis],
            "pieces": [c["pieces"] for c in clis],
            "collectives": [c["collectives"] for c in clis],
            "step_ms_median": [c["step_ms_median"] for c in clis],
            "seconds": [c["seconds"] for c in clis]}


def like_epoch_losses(t) -> list:
    """Epoch mean losses of the single-process run of phase 23b's
    configuration (2 epochs), from a fresh model."""
    model = t.new_model()
    opt = t.new_optimizer(model)
    return [float(t.run_epoch(model, opt, e)) for e in range(2)]


def sharded_case_check(name, ref, ranks) -> dict:
    """Phase 23a's checks on one case: values against the single-process
    step, replicas bit-equal, the lanes' kernels launched."""
    for r, rec in enumerate(ranks):
        if not math.isclose(rec["loss"], ref["loss"], rel_tol=LOSS_RTOL):
            raise AssertionError(f"{name} rank {r}: loss {rec['loss']} vs "
                                 f"single {ref['loss']}")
        for k, g in ref["grads"].items():
            if not torch.allclose(rec["grads"][k], g, rtol=GRAD_RTOL,
                                  atol=GRAD_ATOL):
                raise AssertionError(f"{name} rank {r}: gradient of {k} "
                                     f"differs by "
                                     f"{float((rec['grads'][k] - g).abs().max())}")
        for k, p in rec["params"].items():
            if not torch.equal(p, ranks[0]["params"][k]):
                raise AssertionError(f"{name}: parameter {k} differs "
                                     f"between the ranks after "
                                     f"{SHARD_STEPS} steps")
    per = ranks[0]["launches_per_step"]
    gkey, model_name, ew, fused = SHARD_CASES[name]
    if ew and fused and ranks[0]["fused"] and per["window_gather"] < 1:
        raise AssertionError(f"{name}: no fused fetch (kernel 1a) a step")
    if ew and not fused and per["window_gather_masked"] < 1:
        raise AssertionError(f"{name}: no masked fetch (kernel 1c) a step")
    if ref["hub_rows"] and per["ragged_gather"] < 1:
        raise AssertionError(f"{name}: {ref['hub_rows']} hub rows and no "
                             f"ragged gather")
    for r, rec in enumerate(ranks):
        ov = rec["overlap"]
        if not ov["bit_equal"] or ov["async_calls"]["off"]["graph"]:
            raise AssertionError(f"{name} rank {r}: overlap on and off "
                                 f"differ, or the off run issued async "
                                 f"collectives: {ov}")
        if not ov["launches_between"]["on"] or ov["launches_between"]["off"]:
            raise AssertionError(f"{name} rank {r}: the profiler shows no "
                                 f"async collective with overlap on, or one "
                                 f"with it off: {ov['launches_between']}")
    for r, rec in enumerate(ranks):
        for sched, x in rec["captured"].items():
            first = ranks[0]["captured"][sched]
            if (x["pieces"], x["collectives"]) != (first["pieces"],
                                                   first["collectives"]):
                raise AssertionError(f"{name}: the ranks cut different "
                                     f"pieces: {x} against {first}")
        got = rec["captured_launches"]
        if ew and fused and ranks[0]["fused"] and got["window_gather"] < 1:
            raise AssertionError(f"{name} rank {r}: the card ran no fused "
                                 f"fetch in (d): {got}")
        if ew and not fused and got["window_gather_masked"] < 1:
            raise AssertionError(f"{name} rank {r}: the card ran no masked "
                                 f"fetch in (d): {got}")
        if ref["hub_rows"] and got["ragged_gather"] < 1:
            raise AssertionError(f"{name} rank {r}: the card ran no ragged "
                                 f"gather in (d): {got}")
    keys = ("step_ms_median", "launches_per_step", "collectives_per_step",
            "gloo_host_round_trips_per_step", "explicit_syncs_per_step",
            "peak_mem_bytes", "shard_s", "stores", "fused", "overlap",
            "captured", "captured_launches")
    return {"loss": ref["loss"], "hub_rows": ref["hub_rows"],
            "loss_ranks": [r["loss"] for r in ranks],
            "max_grad_diff": max(float((r["grads"][k] - g).abs().max())
                                 for r in ranks
                                 for k, g in ref["grads"].items()),
            "launches": [r["launches"] for r in ranks],
            "masked_fetch": [r.get("masked_fetch") for r in ranks],
            "ranks": [{k: r[k] for k in keys} for r in ranks]}



# ------------------------------------- phase 25: probes and measurement

# the TPU probe kernels this slice ports: (kernel of the probe's rows, entry
# key, file:line of the Pallas call)
PROBE_KERNELS = (("P-a", "gather_probe_aligned",
                  "benchmarks/gather_kernel_probe.py:71"),
                 ("P-s", "gather_probe_shift",
                  "benchmarks/gather_kernel_probe.py:133"))


def probe_entries(kp: dict, launches: dict) -> dict:
    """The kernels-line entries of P-a and P-s from the probe's run
    (``gather_kernel_probe.run``): the time at the JAX probe's first
    setting (rows 8; slots 4 for P-s), every setting's beside it, the plain
    version's and the library yardstick's (``flat.unfold(0, dp, 1)
    [starts]``), and the read+write bound the probe computed from its
    inputs.  Each time is the median of ``utils.roofline.kernel_ms``'s
    readings (queued calls over eight sets of starts, the output's
    write-back included; ``*_range_ms`` their spread), and ``run`` raised
    on any that read under the bound by more than ``SOL_LIMIT``."""
    by = {r["kernel"]: r for r in kp["rows"]}
    spread = lambda r: [min(r["readings_ms"]), max(r["readings_ms"])]
    out = {}
    for kind, key, replaces in PROBE_KERNELS:
        rows = [r for r in kp["rows"] if r["kernel"] == kind]
        first, plain, lib = rows[0], by[f"plain {kind}"], by["library"]
        out[key] = {
            "name": f"gather probe {kind} ({key})", "route": "cuda",
            "source": "pcgnn_tpu_torch/csrc/gather_probe.cu",
            "replaces": replaces, "launches": launches[key],
            "launches_by_path": {"probe (phase 25)": launches[key]},
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": first["wall_ms"], "plain_ms": plain["wall_ms"],
            "bound_ms": kp["rw_bound_ms"], "bound_by": "bytes",
            "library_ms": lib["wall_ms"], "range_ms": spread(first),
            "plain_range_ms": spread(plain),
            "library_range_ms": spread(lib),
            "setting": {k: first.get(k) for k in ("rows", "slots",
                                                  "slots_applied")},
            "sweep": [{k: r.get(k) for k in ("rows", "slots",
                                             "slots_applied", "wall_ms",
                                             "readings_ms")}
                      for r in rows],
            "rows": kp["b"], "dp": kp["dp"]}
    return out


def spmd_overhead_run() -> dict:
    """``pcgnn_tpu_torch.benchmarks.spmd_overhead`` at its defaults, as a
    process of its own (its 1-rank NCCL group ends with it); its JSON."""
    from pcgnn_tpu_torch.utils.multiproc import worker_env
    out = subprocess.run(
        [sys.executable, "-m", "pcgnn_tpu_torch.benchmarks.spmd_overhead"],
        env=worker_env(), capture_output=True, text=True, timeout=600)
    if out.returncode:
        raise AssertionError(f"spmd_overhead exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def probe_phase(like_graph, card: str) -> dict:
    """Phase 25: with every kernel count at 0, the gather-kernel probe and
    the gather strategies at their defaults (each variant exact against
    its plain version, and the probe's times not under their read+write
    bound, else they raise) and the roofline rows on yelp-like's
    graph from phase 3 (``measure`` raises on a share above
    ``SOL_LIMIT``); the counts are read after.  Then the 1-rank sharded
    step's overhead in its own process (its loss equal to the single
    step's, else it exits non-zero)."""
    from pcgnn_tpu_torch.benchmarks import gather_kernel_probe, gather_probe
    from pcgnn_tpu_torch.benchmarks import roofline as bench_roofline
    from pcgnn_tpu_torch.ops import gather_probe as gp
    mods = kernel_counters()
    for mod in mods.values():
        mod.launches = 0
    gp.aligned_launches = gp.shift_launches = 0
    t1 = time.time()
    kp = gather_kernel_probe.run()
    launches = {"gather_probe_aligned": gp.aligned_launches,
                "gather_probe_shift": gp.shift_launches}
    if not all(launches.values()):
        raise AssertionError(f"the probe launched no P-a or P-s: {launches}")
    strategies = gather_probe.run()
    t2 = time.time()
    rows = bench_roofline.bench_relation_kernels(like_graph, 1024)
    with runners_made() as rs:
        rows += bench_roofline.bench_train_step("yelp-like", 1024, 64,
                                                "cuda", graph=like_graph)
    for r in rows:
        print(json.dumps({"phase25_roofline": r["kernel"],
                          "shape": r["shape"], "wall_ms": r["wall_ms"],
                          "sol_frac": r.get("sol_frac"), "mfu": r["mfu"],
                          "analytic_bytes": r.get("analytic_bytes"),
                          "card": card}))
    launches.update(card_launches({k: m.launches for k, m in mods.items()},
                                  rs))
    t3 = time.time()
    spmd = spmd_overhead_run()
    print(json.dumps({"phase25_spmd_overhead": spmd}))
    t4 = time.time()
    return {"kernel_probe": kp, "gather_probe": strategies,
            "roofline": rows, "spmd_overhead": spmd,
            "launches": launches,
            "entries": probe_entries(kp, launches),
            "seconds": {"probes": t2 - t1, "roofline": t3 - t2,
                        "spmd_overhead": t4 - t3}}


# ------------------------- phase 26: the bench, quality and scaling

# BASELINE.json config 3: PC-GNN on Amazon at configs/pcgnn_amazon.json's
# batch, lr and weight decay, on the synthetic preset of Amazon's shape
# (quality_run's fourth setting)
CONFIG3_CFG = dict(BENCH_CFG, data_name="synthetic:amazon-like", lr=0.005,
                   weight_decay=0.0005, batch_size=256)
# quality_run cut in depth only: one seed, 20 epochs (two validations)
QUALITY_SEEDS = (2,)
QUALITY_EPOCHS = 20
# quality_protocol on its smallest dataset, one seed, 2 epochs
PROTOCOL_DATASET = "synthetic:amazon-like"
PROTOCOL_EPOCHS = 2
# the scaling harnesses on the JAX scripts' default preset
SCALING_PRESET = "small"
SCALING_TIMEOUT_S = 600.0
# bench.py's line, key for key (bench.py:134-149)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "epochs_per_hour",
              "step_ms", "hbm_bw_util", "step_achieved_gbps", "peak_gbps",
              "roofline_step_ms", "preset", "batch_size", "device")


def reference_on_host(path: str) -> dict:
    """``measure_reference`` on this machine's host, in a process of its
    own, written to ``path`` (never ``BASELINE_MEASURED.json``)."""
    from pcgnn_tpu_torch.utils.multiproc import worker_env
    out = subprocess.run(
        [sys.executable, "-m", "pcgnn_tpu_torch.benchmarks.measure_reference",
         "--out", path], env=worker_env(), capture_output=True, text=True,
        timeout=600)
    if out.returncode:
        raise AssertionError(f"measure_reference exited {out.returncode}:\n"
                             f"{out.stderr[-4000:]}")
    with open(path) as f:
        return json.load(f)


def bench_phase(like_graph, baseline: str, name: str) -> dict:
    """The bench at its defaults on yelp-like's graph from phase 3, every
    kernel count at 0 before and read after: its line (``bench.py``'s 13
    keys, ``value`` > 0, ``hbm_bw_util`` <= ``SOL_LIMIT``, the card's name),
    ``vs_baseline`` against this host's reference (``baseline``) and the
    repository's ``BASELINE_MEASURED.json``, and the launches per step (one
    fused record fetch a step: the bench's epochs and its ``single_step``
    replay the captured step, so the steps and the launches the card ran
    are the runners' (``card_launches``), not the wrappers' counts)."""
    from pcgnn_tpu_torch import bench
    from pcgnn_tpu_torch.utils.roofline import SOL_LIMIT
    mods = kernel_counters()
    for mod in mods.values():
        mod.launches = 0
    with runners_made() as rs:
        line = bench.run(graph=like_graph, baseline=baseline)
    launches = card_launches({k: m.launches for k, m in mods.items()}, rs)
    steps = [sum(r.eager_steps + r.replays for r in step_runners(rs))]
    if not all(r.capture for r in rs) or not all(
            n["window_gather"] == 1 for r in step_runners(rs)
            for n in r.step_hook.launches):
        raise AssertionError("a bench step was not the captured step with "
                             "one window gather")
    print(json.dumps(line))
    if tuple(line) != BENCH_KEYS:
        raise AssertionError(f"the bench's keys {list(line)} are not "
                             f"bench.py's {list(BENCH_KEYS)}")
    if not line["value"] > 0 or not line["hbm_bw_util"] <= SOL_LIMIT:
        raise AssertionError(f"the bench's line is out of range: {line}")
    if line["device"] != name:
        raise AssertionError(f"the bench ran on {line['device']!r}")
    if launches["window_gather"] != steps[0]:
        raise AssertionError(f"{steps[0]} bench steps launched "
                             f"{launches['window_gather']} window gathers")
    repo_ref = bench.reference_edges_per_s(bench.BASELINE_PATH)
    return {"line": line, "steps": steps[0], "launches": launches,
            "launches_per_step": {k: v / steps[0]
                                  for k, v in launches.items()},
            "vs_host_reference": line["vs_baseline"],
            "vs_baseline_measured_json": line["value"] / repo_ref,
            "baseline_measured_json_edges_per_s": repo_ref}


def config3_fetch_phase(rate: float) -> tuple:
    """Config 3's trainer on amazon-like (batch 256): kernel 1 at its
    widened fused records, held exactly against the plain version on 30
    batches (copied and widened) and timed by ``queued_window`` beside its
    bound and the ``index_select`` copy.  Returns (record, the host-built
    graph without stores, for the quality run)."""
    from pcgnn_tpu_torch.data.loaders import load_data
    from pcgnn_tpu_torch.train.trainer import Trainer
    cfg = CONFIG3_CFG
    t1 = time.time()
    raw = load_data(cfg["data_name"], seed=cfg["seed"], device="cuda")
    t = Trainer(cfg, graph=raw, device="cuda")
    g, dev = t.graph, t.device
    torch.cuda.synchronize()
    setup_s = time.time() - t1
    if g.fused is None:
        raise AssertionError("config 3 on amazon-like has no fused record "
                             "store")
    w = g.fused.shape[1]
    flat = g.fused.view(-1)
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [t.idx_train_dev[torch.randint(len(t.idx_train),
                                             (t.batch_size,), generator=gen,
                                             device=dev)]
               for _ in range(TIMING_REPS)]
    errs = [check_gather(flat, bt * w, w, out_dtype=od)
            for bt in batches for od in (None, torch.float32)]
    q = queued_window(flat, [bt * w for bt in batches], w, g.fused, batches,
                      rate=rate)
    rec = {"setup_s": setup_s, "graph": graph_shape(g), "fused_width": w,
           "fused_off": list(g.fused_off), "dps": [r.ewin_dp for r in
                                                   g.relations],
           "max_abs_err": max(errs), "checked": len(errs), **q}
    del t, g, flat
    return rec, raw


def quality_phase(graphs: dict, work: str) -> dict:
    """``quality_run`` cut in depth (``QUALITY_SEEDS``, ``QUALITY_EPOCHS``),
    all five settings at full width, every kernel count at 0 before and
    read after (the launches the card ran, ``card_launches``): every test
    AUC above 0.5."""
    from pcgnn_tpu_torch.benchmarks import quality_run
    mods = kernel_counters()
    for mod in mods.values():
        mod.launches = 0
    out = os.path.join(work, "RESULTS.md")
    with runners_made() as rs:
        rows, runs = quality_run.run(seeds=QUALITY_SEEDS,
                                     epochs=QUALITY_EPOCHS, out=out,
                                     device="cuda", graphs=graphs)
    launches = card_launches({k: m.launches for k, m in mods.items()}, rs)
    with open(out) as f:
        text = f.read()
    print(text, end="")
    low = [r for r in runs if not r["auc"] > 0.5]
    if low:
        raise AssertionError(f"quality runs with test AUC not above 0.5: "
                             f"{low}")
    if not launches["window_gather"] or not launches["ragged_gather"]:
        raise AssertionError(f"the quality run launched {launches}")
    return {"rows": rows, "runs": runs, "launches": launches, "table": text}


def protocol_phase(work: str) -> dict:
    """``quality_protocol`` on one dataset, one seed and 2 epochs through
    the CLI: every run rc 0 and a table of one row."""
    from pcgnn_tpu_torch.benchmarks import quality_protocol
    res = quality_protocol.run(
        workdir=os.path.join(work, "protocol"), datasets=[PROTOCOL_DATASET],
        seeds="1", epochs=PROTOCOL_EPOCHS, device="cuda",
        run_timeout=SCALING_TIMEOUT_S)
    if res["failed"] or res["done"] != 1 or len(res["summary"]) != 1:
        logs = glob.glob(os.path.join(work, "protocol", "logs", "*.log"))
        tails = "".join(open(p).read()[-3000:] for p in logs)
        raise AssertionError(f"quality_protocol: {res}\n{tails}")
    with open(res["out"]) as f:
        text = f.read()
    print(text, end="")
    return {"runs": res["runs"], "table": text,
            "summary": {" ".join(k): v for k, v in res["summary"].items()}}


def timed(fn, *args) -> tuple:
    """(``fn(*args)``, its wall seconds)."""
    t1 = time.time()
    return fn(*args), time.time() - t1


def spmd_scaling_phase() -> dict:
    """``spmd_scaling`` over (1, 1) on one NCCL rank, then (2, 1) and
    (1, 2) over gloo ranks sharing cuda:0: every warm loss within rtol
    ``LOSS_RTOL`` of the (1, 1) loss on the same batch, and kernel 1c
    launched at (1, 2).  One card gives relative numbers, no scaling
    claim."""
    from pcgnn_tpu_torch.benchmarks import spmd_scaling
    spmd = spmd_scaling.run(devices=2, preset=SCALING_PRESET,
                            device="cuda:0", timeout=SCALING_TIMEOUT_S)
    for r in spmd["records"]:
        if not math.isclose(r["warm_loss"], r["ref_loss"], rel_tol=LOSS_RTOL):
            raise AssertionError(f"{r['mesh']}: loss {r['warm_loss']!r} is "
                                 f"not within {LOSS_RTOL} of the (1, 1) "
                                 f"loss {r['ref_loss']!r}")
    backends = [r["backend"] for r in spmd["records"]]
    if backends != ["nccl", "gloo", "gloo"]:
        raise AssertionError(f"spmd_scaling ran over {backends}")
    graph_mesh = spmd["records"][2]
    if not graph_mesh["launches"]["window_gather_masked"]:
        raise AssertionError(f"(1, 2) launched no masked window gather: "
                             f"{graph_mesh['launches']}")
    return spmd


def multihost_phase() -> list:
    """``multihost_scaling`` with 1 and 2 processes on ``SCALING_PRESET``
    for 1 epoch, the ranks on cuda:0: both counts finish."""
    from pcgnn_tpu_torch.benchmarks import multihost_scaling
    multi = multihost_scaling.run(multihost_scaling.parse_args([
        "--procs", "2", "--devices_per_proc", "1", "--mesh_graph", "1",
        "--preset", SCALING_PRESET, "--epochs", "1", "--device", "cuda:0",
        "--timeout", str(SCALING_TIMEOUT_S)]))
    if [r["procs"] for r in multi] != [1, 2] or multi[0]["scaling_eff"] != 1:
        raise AssertionError(f"multihost_scaling: {multi}")
    return multi


def harness_phase(like_graph, skew_graph, card: str, name: str,
                  rate: float) -> dict:
    """Phase 26: the reference on this host, the bench, config 3's fetch,
    the quality run and protocol, and the scaling harnesses, each timed;
    their files in a fresh directory under ``build/``, removed after."""
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_harness-", dir="build")
    seconds = {}
    t0 = time.time()
    try:
        t1 = time.time()
        ref_path = os.path.join(work, "reference.json")
        ref = reference_on_host(ref_path)
        seconds["measure_reference"] = time.time() - t1
        t1 = time.time()
        bench = bench_phase(like_graph, ref_path, name)
        seconds["bench"] = time.time() - t1
        print(f"phase 26, bench: {bench['line']['value']} edges/s, "
              f"vs_baseline {bench['vs_host_reference']} against this "
              f"host's reference ({ref['reference_edges_per_s']:.0f} "
              f"edges/s on {ref['cpu_model']}), "
              f"{bench['vs_baseline_measured_json']:.3f} against "
              f"BASELINE_MEASURED.json's "
              f"{bench['baseline_measured_json_edges_per_s']:.0f} (another "
              f"host); launches a step {bench['launches_per_step']} over "
              f"{bench['steps']} steps; {card}")
        t1 = time.time()
        fetch, amazon = config3_fetch_phase(rate)
        seconds["config3_fetch"] = time.time() - t1
        print(f"phase 26, kernel 1 at config 3's widened fused records "
              f"[{fetch['rows']}, {fetch['dp']}]: {fetch['ms'] * 1e3:.2f} us "
              f"({fetch['readings_ms'][0] * 1e3:.2f}-"
              f"{fetch['readings_ms'][-1] * 1e3:.2f}), bound "
              f"{fetch['bound_ms'] * 1e3:.2f}; copy "
              f"{fetch['copy_ms'] * 1e3:.2f} (bound "
              f"{fetch['copy_bound_ms'] * 1e3:.2f}, index_select "
              f"{fetch['library_ms'] * 1e3:.2f}); plain "
              f"{fetch['plain_ms'] * 1e3:.2f}; exact on {fetch['checked']} "
              f"calls; {card}")
        t1 = time.time()
        quality = quality_phase({
            (BENCH_CFG["data_name"], 2): like_graph.without_stores(),
            (SKEW_CFG["data_name"], 2): skew_graph.without_stores(),
            (CONFIG3_CFG["data_name"], 2): amazon}, work)
        seconds["quality_run"] = time.time() - t1
        for r in quality["runs"]:
            print(json.dumps({"phase26_quality": r, "card": card}))
        del amazon
        # the scaling gangs and the protocol's CLI run go side by side,
        # sharing the card and the host: on one card the gangs give no
        # scaling number (their timings are relative; run a harness alone
        # for its records), and the checks read losses, launches, exit
        # codes and AUC
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            beside = pool.submit(timed, protocol_phase, work)
            multi_run = pool.submit(timed, multihost_phase)
            spmd, seconds["spmd_scaling"] = timed(spmd_scaling_phase)
            multi, seconds["multihost_scaling"] = multi_run.result()
            protocol, seconds["quality_protocol"] = beside.result()
        scaling = {"spmd_scaling": spmd, "multihost_scaling": multi}
        for r in spmd["records"]:
            print(json.dumps({"phase26_spmd_scaling": r, "card": card}))
        print(json.dumps({"phase26_multihost_scaling": multi, "card": card}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds["total"] = time.time() - t0
    print(f"phase 26 took {seconds['total']:.1f} s: "
          + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()
                      if k != "total")
          + " (the last three side by side)")
    return {"reference": ref, "bench": bench, "config3_fetch": fetch,
            "quality": quality, "protocol": protocol, "scaling": scaling,
            "seconds": seconds}


# ----------------------- phase 27: the entry points of __graft_entry__.py

GRAFT_RANKS = 2
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6


def graft_phase(card: str) -> dict:
    """Phase 27: ``pcgnn_tpu_torch.graft_entry``, the counterpart of
    ``__graft_entry__.py``.  ``entry()`` on the card, with every count at 0
    just before its forward and read just after: kernel 1 (the fused
    record fetch) launched, logits and center scores finite, of shape
    [64, 2], and within rtol 1e-5 of the same forward on the CPU.  Then
    ``dryrun_multichip(2, device="cuda:0")``: two gloo ranks sharing the
    card at (1, 2), one training step in each of the tiny, skew-tiny and
    stress-1m passes (each rank zeroes its counts just before each step):
    the losses finite and the same on both ranks, kernels 1 and 2 launched
    by the skew pass, stress-1m's structure half on each rank.  The tiny
    and skew-tiny steps are then run again by the same dryrun on the CPU
    (``GRAFT_DRYRUN_STRESS=0``), where every kernel is its plain version:
    each card rank's loss, summed gradients and parameters after the Adam
    step must agree with the CPU rank's (``LOSS_RTOL``, ``GRAD_RTOL`` /
    ``GRAD_ATOL``, ``PARAM_ATOL``)."""
    from pcgnn_tpu_torch import graft_entry
    mods = kernel_counters()
    t0 = time.time()
    fn, args = graft_entry.entry()
    torch.cuda.synchronize()
    setup_s = time.time() - t0
    for m in mods.values():
        m.launches = 0
    logits, center = fn(*args)
    torch.cuda.synchronize()
    entry_launches = {k: m.launches for k, m in mods.items()}
    if entry_launches["window_gather"] < 1:
        raise AssertionError(f"entry() launched no fused record fetch: "
                             f"{entry_launches}")
    if logits.shape != (64, 2) or center.shape != (64, 2) or not bool(
            torch.isfinite(logits).all() and torch.isfinite(center).all()):
        raise AssertionError(f"entry(): logits {tuple(logits.shape)}, "
                             f"center {tuple(center.shape)}, not all finite")
    fn_c, args_c = graft_entry.entry(device="cpu")
    logits_c, center_c = fn_c(*args_c)
    err = max(float((a.detach().cpu() - b.detach()).abs().max())
              for a, b in ((logits, logits_c), (center, center_c)))
    for a, b in ((logits, logits_c), (center, center_c)):
        if not torch.allclose(a.detach().cpu(), b.detach(), rtol=FWD_RTOL,
                              atol=FWD_ATOL):
            raise AssertionError(f"entry() on the card differs from the CPU "
                                 f"by {err}")
    entry_s = time.time() - t0
    t1 = time.time()
    ranks = graft_entry.dryrun_multichip(GRAFT_RANKS, device="cuda:0")
    dryrun_s = time.time() - t1
    passes = list(ranks[0]["passes"])
    if passes != ["tiny", "skew-tiny", "stress-1m"]:
        raise AssertionError(f"the dryrun ran the passes {passes}")
    for name in passes:
        losses = [r["passes"][name]["loss"] for r in ranks]
        if len(set(losses)) != 1 or not math.isfinite(losses[0]):
            raise AssertionError(f"dryrun {name}: the ranks' losses {losses}")
    for r in ranks:
        skew = r["passes"]["skew-tiny"]["launches"]
        if skew["window_gather"] < 1 or skew["ragged_gather"] < 1:
            raise AssertionError(f"the skew pass on rank {r['rank']} "
                                 f"launched {skew}: kernels 1 and 2 wanted")
        st = r["passes"]["stress-1m"]
        mine, total = st["struct_rank_bytes"], st["struct_total_bytes"]
        if not total <= GRAFT_RANKS * mine <= total + 4096 * GRAFT_RANKS:
            raise AssertionError(f"stress-1m on rank {r['rank']}: {mine} "
                                 f"bytes of structure of {total}")
    t2 = time.time()
    with unittest.mock.patch.dict(os.environ, {"GRAFT_DRYRUN_STRESS": "0"}):
        ref = graft_entry.dryrun_multichip(GRAFT_RANKS, device="cpu")
    ref_s = time.time() - t2
    vs_cpu = {}
    for name in ("tiny", "skew-tiny"):
        for r, c in zip(ranks, ref):
            got, want = r["passes"][name], c["passes"][name]
            if not math.isclose(got["loss"], want["loss"], rel_tol=LOSS_RTOL,
                                abs_tol=0.0):
                raise AssertionError(
                    f"dryrun {name} rank {r['rank']}: card loss "
                    f"{got['loss']!r}, CPU {want['loss']!r}")
            errs = {"loss": abs(got["loss"] - want["loss"])}
            for kind, rtol, atol in (("grads", GRAD_RTOL, GRAD_ATOL),
                                     ("params", 0.0, PARAM_ATOL)):
                if set(got[kind]) != set(want[kind]):
                    raise AssertionError(f"dryrun {name}: the {kind}' names "
                                         f"differ from the CPU's")
                for k, a in got[kind].items():
                    if not np.allclose(a, want[kind][k], rtol=rtol,
                                       atol=atol):
                        raise AssertionError(
                            f"dryrun {name} rank {r['rank']}: {kind} {k} "
                            f"differ from the CPU's by "
                            f"{float(np.abs(a - want[kind][k]).max())}")
                errs[kind] = max(float(np.abs(a - want[kind][k]).max())
                                 for k, a in got[kind].items())
            vs_cpu.setdefault(name, []).append(errs)
    for r in ranks + ref:
        for rec in r["passes"].values():
            rec.pop("grads", None)
            rec.pop("params", None)
    launches = {k: entry_launches[k] + sum(
        r["passes"][p]["launches"][k] for r in ranks for p in passes)
        for k in mods}
    out = {"card": card, "entry": {
        "launches": entry_launches, "setup_s": setup_s, "seconds": entry_s,
        "max_abs_diff_vs_cpu": err,
        "logits_row0": logits[0].tolist()},
        "dryrun": {"seconds": dryrun_s, "ranks": ranks,
                   "cpu_reference": {
                       "seconds": ref_s, "max_abs_diff": vs_cpu,
                       "losses": {p: [c["passes"][p]["loss"] for c in ref]
                                  for p in vs_cpu}}},
        "launches": launches, "seconds": time.time() - t0}
    print(f"phase 27, entry(): kernel 1 x{entry_launches['window_gather']}, "
          f"card vs CPU {err:.3g}, {entry_s:.1f} s; dryrun_multichip(2, "
          f"cuda:0) {dryrun_s:.1f} s: " + "; ".join(
              f"{p} loss {ranks[0]['passes'][p]['loss']:.4f} in "
              f"{ranks[0]['passes'][p]['seconds']:.1f} s (step "
              f"{ranks[0]['passes'][p]['step_s'] * 1e3:.1f} ms)"
              for p in passes) + f"; stress-1m structure "
          f"{ranks[0]['passes']['stress-1m']['struct_rank_bytes'] / 1e6:.1f} "
          f"MB/rank of "
          f"{ranks[0]['passes']['stress-1m']['struct_total_bytes'] / 1e6:.1f}"
          f" MB; against the CPU dryrun ({ref_s:.1f} s): " + "; ".join(
              f"{p} max abs loss {max(e['loss'] for e in v):.3g}, grads "
              f"{max(e['grads'] for e in v):.3g}, params after Adam "
              f"{max(e['params'] for e in v):.3g}"
              for p, v in vs_cpu.items()) + f" ({card})", file=sys.stderr)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from pcgnn_tpu_torch import native
    from pcgnn_tpu_torch.ops import kernels
    from pcgnn_tpu_torch.train.trainer import Trainer

    t0 = time.time()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rate = memory_rate()
    # the graph core (g++) builds while the kernels (nvcc) do
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        core = pool.submit(native.available)
        for kname, report in kernels.build().items():
            print(f"[build {kname}]\n{report.strip()}", file=sys.stderr)
        if not core.result():
            raise AssertionError(f"the native graph core is not loaded: "
                                 f"{native.load_error()}")
    print(f"built kernels and the graph core ({native.loaded_path()}) in "
          f"{time.time() - t0:.1f} s; every graph below is built through "
          f"it", file=sys.stderr)

    runs, trainers = {}, []
    for cfg in (BENCH_CFG, SKEW_CFG, LEARNED_CFG):
        t1 = time.time()
        if cfg is LEARNED_CFG:
            # yelp-like's graph from phase 2's loader call, without stores
            t = Trainer(cfg, graph=trainers[0].graph.without_stores(),
                        device="cuda")
        else:
            t = Trainer(cfg, device="cuda")
        torch.cuda.synchronize()
        g = t.graph
        run = {"setup_s": time.time() - t1}
        stores = (f"fused={tuple(g.fused.shape)} {g.fused.dtype} "
                  f"dps={[r.ewin_dp for r in g.relations]} "
                  if g.fused is not None else "no stores ")
        print(f"{run_name(t)} graph on the card in {run['setup_s']:.1f} s "
              f"(CSR: {csr_path()}): N={g.num_nodes} {stores}"
              f"dcap/dmax={[(r.window_width, r.dmax) for r in g.relations]}",
              file=sys.stderr)
        if cfg is BENCH_CFG:
            run["entry"], run["kernel"] = kernel_phase(t, rate)
        elif cfg is SKEW_CFG:
            run["entry"], run["kernel"] = ragged_phase(t, rate)
        else:
            run["entry"], run["kernel"] = mask_phase(t, rate)
        run["main_path"] = main_path_phase(t)
        if cfg is BENCH_CFG:
            run["store_lane"] = store_lane_phase(t)
        run["profile"] = profile_phase(t)
        if cfg is LEARNED_CFG:
            faults = mask_pass_faults(
                run["profile"]["mask_sized_kernels_per_step"])
            if faults:
                raise AssertionError(f"a learned step runs a mask-sized "
                                     f"reduction or elementwise pass: "
                                     f"{faults}")
            run["aggregation"] = aggregation_phase(t)
        run["card_vs_cpu"] = card_vs_cpu_phase(t)
        if cfg is LEARNED_CFG:
            run["csr_branch"] = csr_branch_phase(t)
        print(f"{run_name(t)} phases done at {time.time() - t0:.1f} s",
              file=sys.stderr)
        runs[run_name(t)] = run
        trainers.append(t)
    turns = turns_phase(trainers)
    like, skew, learned = (runs[run_name(t)] for t in trainers)
    if skew["main_path"]["launches"]["window_gather"] < 1:
        raise AssertionError("the yelp-skew run launched no window_gather")

    # 16: the score-table lane on yelp-skew's graph without stores
    t16 = Trainer(TABLE_CFG, graph=trainers[1].graph.without_stores(),
                  device="cuda")
    runs[run_name(t16)] = lane_phases(t16)
    print(f"phase 16 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 17: stress-1m
    runs[STRESS_CFG["data_name"]], stress_graph = stress_phase(rate)
    print(f"phase 17 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 18: GCN and GraphSAGE on amazon_new-like, one graph and homo store
    t1 = time.time()
    gcn = Trainer(GCN_CFG, device="cuda")
    sage = Trainer(SAGE_CFG, graph=gcn.graph, device="cuda")
    torch.cuda.synchronize()
    homo_window = homo_window_phase(gcn, rate)
    homo_window["setup_s"] = time.time() - t1
    homo_window["graph"] = graph_shape(gcn.graph)
    for t in (gcn, sage):
        runs[run_name(t)] = lane_phases(t)
    print(f"phase 18 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 19: one step of each baseline on yelp-skew's graph, whose homo hub
    # rows go through hub_mean_sum
    gcn_skew = Trainer(dict(GCN_CFG, data_name=SKEW_CFG["data_name"]),
                       graph=trainers[1].graph.without_stores(),
                       device="cuda")
    sage_skew = Trainer(dict(SAGE_CFG, data_name=SKEW_CFG["data_name"]),
                        graph=gcn_skew.graph, device="cuda")
    skew_steps = {"homo": graph_shape(gcn_skew.graph)["homo"]}
    for t in (gcn_skew, sage_skew):
        skew_steps[run_name(t)] = card_vs_cpu_phase(t)
        if not skew_steps[run_name(t)]["hub_rows"]:
            raise AssertionError("no yelp-skew batch has a homo hub row")
    print(f"phase 19 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 20-21: yelp from YelpChi-format files through the CLI; resume and
    # profile_dir on its graph; files, result roots and trace in a fresh
    # directory, removed after
    os.makedirs("build", exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_files-", dir="build")
    try:
        files, files_graph = files_phase(work, card, trainers[0])
        print(f"phase 20 done at {time.time() - t0:.1f} s", file=sys.stderr)
        resume = resume_phase(work, files_graph, card)
        print(f"phase 21 done at {time.time() - t0:.1f} s", file=sys.stderr)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    # 22: the full-graph ops on yelp-like's and stress-1m's graphs, then
    # Trainer.single_step timed on yelp-like
    full = full_graph_phase({"yelp-like": trainers[0].graph,
                             "stress-1m": stress_graph}, rate, card)
    del stress_graph
    full["single_step"] = single_step_phase(trainers[0], card)
    print(f"phase 22 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 23: the sharded step on the card (two gloo ranks on cuda:0), the
    # distributed trainer through the CLI, and a 1-rank NCCL group
    sharded = sharded_phase(trainers, gcn, sage, card, rate)
    print(f"phase 23 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 24: stress-10m, built here on the host, in the clamped CSR lane
    g10, build10 = stress10m_build(STRESS10M_CFG["seed"])
    runs[STRESS10M_CFG["data_name"]] = stress10m_phase(g10, build10, rate,
                                                       card)
    del g10
    print(f"phase 24 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 25: the gather-kernel probes (P-a, P-s), the gather strategies, the
    # roofline rows on yelp-like's graph, the 1-rank sharded step's overhead
    probes = probe_phase(trainers[0].graph, card)
    print(f"phase 25 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 26: the bench, config 3's fetch, the quality run and protocol, the
    # scaling harnesses
    harness = harness_phase(trainers[0].graph, trainers[1].graph, card, name,
                            rate)
    print(f"phase 26 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 27: __graft_entry__.py's entry points (graft_entry): entry() on the
    # card and the dryrun's three sharded passes on two gloo ranks sharing
    # it
    graft = graft_phase(card)
    print(f"phase 27 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 28: the captured step against the eager step on the graphs above
    captured = capture_phase(
        [trainers[0], trainers[2], trainers[1], t16, gcn, sage],
        runs[STRESS10M_CFG["data_name"]]["capture"], card)
    print(f"phase 28 done at {time.time() - t0:.1f} s "
          f"({captured['seconds']:.1f} s)", file=sys.stderr)
    # 29: the captured forward against the eager one on the same graphs
    predicted = predict_phase(
        [trainers[0], trainers[2], trainers[1], t16, gcn, sage],
        runs[STRESS10M_CFG["data_name"]]["predict"], card)
    print(f"phase 29 done at {time.time() - t0:.1f} s "
          f"({predicted['seconds']:.1f} s)", file=sys.stderr)

    # 30: the choose kernel at the benchmark cells' record sections, its
    # ids source at the stress cell's and the score kernel
    choose = choose_phase(rate)
    choose_ids, scores = choose_ids_phase(rate)
    print(f"phase 30 done at {time.time() - t0:.1f} s", file=sys.stderr)
    # 31: the oversample kernel at the benchmark cells' steps
    oversample = oversample_phase(rate)
    print(f"phase 31 done at {time.time() - t0:.1f} s", file=sys.stderr)

    # each kernel's launches: the sum over the main paths' runs, each read
    # with every count set to 0 just before it
    entries = {"window_gather": like["entry"],
               "ragged_gather": skew["entry"], "mask_build": learned["entry"],
               "choose_window": choose, "choose_window_ids": choose_ids,
               "selection_score": scores, "oversample_minors": oversample}
    for kname, entry in entries.items():
        entry["launches_by_path"] = {
            data: run["main_path"]["launches"][kname]
            for data, run in runs.items()}
        entry["launches_by_path"]["yelp from files (cli)"] = (
            files["launches"][kname])
        entry["launches_by_path"]["full graph"] = full["launches"][kname]
        entry["launches_by_path"]["sharded (phase 23, both ranks)"] = (
            sharded["launches"][kname]
            + (sharded["launches"]["window_gather_masked"]
               if kname == "window_gather" else 0))
        entry["launches_by_path"]["probes and roofline (phase 25)"] = (
            probes["launches"][kname])
        entry["launches_by_path"]["bench (phase 26)"] = (
            harness["bench"]["launches"][kname])
        entry["launches_by_path"]["quality run (phase 26)"] = (
            harness["quality"]["launches"][kname])
        entry["launches_by_path"]["graft entry and dryrun (phase 27)"] = (
            graft["launches"][kname])
        entry["launches_by_path"]["captured predict (phase 29)"] = (
            predicted["launches"][kname])
        entry["launches"] = sum(entry["launches_by_path"].values())
    # kernel 1c (the window gather with ``active``) apart: its only path is
    # the sharded store lane
    entries["window_gather"]["masked_launches"] = (
        sharded["launches"]["window_gather_masked"])
    # kernel 1c, the same kernel with ``active``, at its sharded shape: its
    # own entry, widened as the path calls it (no one PyTorch call copies
    # only the active rows, or widens)
    mc = sharded["masked_case"]
    mq = mc["queued"]
    entries["window_gather_masked"] = {
        "name": "window_gather (active: kernel 1c)", "route": "cuda",
        "source": "pcgnn_tpu_torch/csrc/window_gather.cu",
        "replaces": "pcgnn_tpu/ops/pallas/window_gather.py:196",
        "launches": None,
        "launches_by_path": {
            "sharded (phase 23, both ranks)":
                sharded["launches"]["window_gather_masked"],
            "spmd_scaling (phase 26, rank 0 of each mesh)": sum(
                r["launches"]["window_gather_masked"]
                for r in harness["scaling"]["spmd_scaling"]["records"])},
        "max_abs_err": mc["max_abs_err"], "ms": mq["ms"],
        "plain_ms": mq["plain_ms"], "bound_ms": mq["bound_ms"],
        "bound_by": "bytes", "library_ms": None, "copy_ms": mq["copy_ms"],
        "copy_bound_ms": mq["copy_bound_ms"],
        "copy_library_ms": mq["library_ms"],
        "range_ms": [mq["readings_ms"][0], mq["readings_ms"][-1]],
        "profiler_ms": mc["widen_ms"], "profiler_copy_ms": mc["ms"],
        "profiler_plain_ms": mc["widen_plain_ms"],
        "profiler_copy_library_ms": mc["library_ms"], "rows": mc["rows"],
        "copied_rows": mc["copied_rows"], "dp": mc["dp"]}
    entries["window_gather_masked"]["launches"] = sum(
        entries["window_gather_masked"]["launches_by_path"].values())
    # kernel 1 at config 3's widened fused records (phase 26)
    fetch = harness["config3_fetch"]
    like["entry"]["config3_fused"] = {k: fetch[k] for k in (
        "rows", "dp", "ms", "readings_ms", "bound_ms", "copy_ms",
        "copy_bound_ms", "library_ms", "plain_ms", "max_abs_err")}
    # kernel 2 at stress-10m's calls (phase 24): [1024, dcap] CSR windows
    skew["entry"]["stress_10m"] = [
        {k: c[k] for k in ("name", "rows", "d", "col_entries", "ms",
                           "plain_ms", "bound_ms", "library_ms", "run_ms",
                           "queued_ms", "queued_library_ms",
                           "queued_readings_ms")
         if k in c}
        for c in runs[STRESS10M_CFG["data_name"]]["ragged_cases"]]
    # P-a and P-s (phase 25), after the three kernels and kernel 1c
    entries.update(probes["entries"])
    like["entry"]["homo_store"] = {k: homo_window[k] for k in (
        "ms", "widen_ms", "plain_ms", "library_ms", "bound_ms",
        "widen_bound_ms", "rows", "dp", "max_abs_err")}

    # back-to-back CUDA-event times (full_graph_window_case)
    like["entry"]["full_graph"] = {g: {k: full[g]["window_case"][k] for k in (
        "rows", "dp", "run_ms", "widen_run_ms", "widen_plain_run_ms",
        "library_run_ms", "bound_ms", "widen_bound_ms")}
        for g in ("yelp-like", "stress-1m")}

    details = {"card": card, "kind": name, "runs": runs, "turns": turns,
               "homo_window": homo_window, "skew_baseline_steps": skew_steps,
               "files": files, "resume": resume, "full_graph": full,
               "sharded": sharded, "probes": probes, "harness": harness,
               "graft": graft, "captured": captured,
               "predicted": predicted, "seconds": time.time() - t0}
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    summary = {}
    for data, run in runs.items():
        mp, pr = run["main_path"], run["profile"]
        summary[data] = {
            "main_path": {k: mp[k] for k in (
                "steps", "step_ms_median", "edges_per_s", "valid_auc",
                "launches", "hub_rows_per_step", "embed_moved")},
            "profile": {k: pr[k] for k in (
                "wall_ms_per_step", "device_ms_per_step", "busy_share",
                "kernel_launches_per_step", "host_syncs_per_step",
                "window_gather_device_ms_per_launch",
                "ragged_gather_device_ms_per_launch",
                "ragged_gather_launches_per_step",
                "mask_build_device_ms_per_launch",
                "mask_build_launches_per_step", "mask_build_share",
                "step_peak_extra_bytes", "mask_sized_kernels_per_step",
                "hub_lane_host_ms_per_step", "hub_lane_kernel_ms_per_step",
                "hub_lane_device_span_ms_per_step")},
            "turns_step_ms_median": (turns[data]["step_ms_median"]
                                     if data in turns else None),
            "card_vs_cpu_loss": [run["card_vs_cpu"]["loss_card"],
                                 run["card_vs_cpu"]["loss_cpu"]]}
    summary["store_lane_launches"] = like["store_lane"]["launches"]
    summary["window_gather_masked"] = like["kernel"]["masked"]
    summary["window_gather_cases"] = [window_summary(c) for c in (
        like["kernel"]["cases"] + [homo_window]
        + runs[STRESS_CFG["data_name"]]["window_cases"])]
    summary["ragged_gather_cases"] = [
        {k: c[k] for k in ("name", "rows", "d", "ms", "bound_ms", "plain_ms",
                           "library_ms")} for c in skew["kernel"]["cases"]]
    summary["ragged_gather_path_bound_ms"] = skew["kernel"]["path_bound_ms"]
    summary["mask_build_cases"] = [
        {k: c[k] for k in ("name", "rows", "slots", "minors", "ms",
                           "bound_ms", "plain_ms", "library_ms")}
        for c in learned["kernel"]["cases"]]
    summary["mask_build_counts_checked"] = learned["kernel"]["counts_checked"]
    summary["aggregation"] = {
        name: {k: learned["aggregation"][name][k] for k in (
            "ms", "run_ms", "peak_extra_bytes", "kernels")}
        for name in ("old", "new")}
    summary["csr_branch"] = learned["csr_branch"]
    stress = runs[STRESS_CFG["data_name"]]
    summary["stress"] = {k: stress[k] for k in ("host_build_s", "setup_s",
                                                "graph", "csr_branch",
                                                "plan")}
    summary["stress"]["clamp_card_vs_cpu_loss"] = [
        stress["clamp_card_vs_cpu"]["loss_card"],
        stress["clamp_card_vs_cpu"]["loss_cpu"]]
    s10 = runs[STRESS10M_CFG["data_name"]]
    summary["stress_10m"] = {
        "build": s10["build"], "setup_s": s10["setup_s"],
        "lane": s10["lane"], "graph": s10["graph"],
        "seconds": s10["seconds"], "eval_s": s10["main_path"]["eval_s"],
        "peak_device_bytes": s10["peak_device_bytes"],
        "peak_host_rss_bytes": s10["peak_host_rss_bytes"],
        "single_step": s10["single_step"],
        "top_device_ms_per_step": s10["profile"]["top_device_ms_per_step"],
        "op_cases": s10["op_cases"],
        "ragged_max_abs_err": s10["ragged_max_abs_err"],
        "card_vs_cpu_max_abs_diff": s10["card_vs_cpu"]["max_abs_diff"]}
    summary["homo_window"] = {k: homo_window[k] for k in (
        "checked_calls", "setup_s", "window_width", "dmax", "hub_rows")}
    summary["skew_baseline_steps"] = {
        k: v if k == "homo" else {
            "loss": [v["loss_card"], v["loss_cpu"]],
            "hub_rows": v["hub_rows"], "launches": v["card_launches"]}
        for k, v in skew_steps.items()}
    summary["files"] = {k: files[k] for k in (
        "generate_s", "write_s", "load_s", "file_bytes", "steps",
        "step_ms_median", "launches", "valid_auc", "test_auc", "verify")}
    summary["files"]["turns_step_ms_median"] = {
        k: v["step_ms_median"] for k, v in files["turns"].items()}
    summary["resume"] = {k: resume[k] for k in (
        "resumed_vs_uncut", "uncut_vs_uncut", "uncut_s", "resumed_s",
        "trace_window_gathers", "traced_steps", "trace_bytes")}
    summary["full_graph"] = {
        g: {r: {"timed": {k: [v["wall_ms"], v["sol_frac"]]
                          for k, v in rec["timed"].items()},
                "segment_repeats": rec["segment_repeats"],
                "window_launches": rec["window_launches"],
                "max_abs_err": rec["max_abs_err"], "cpu_s": rec["cpu_s"],
                "seconds": rec["seconds"]}
            for r, rec in rels.items()}
        for g, rels in full["graphs"].items()}
    summary["full_graph"]["single_step"] = full["single_step"]
    summary["sharded"] = {
        "scaling": sharded["scaling"], "cli": sharded["cli"],
        "nccl": {k: sharded["nccl"][k] for k in ("init_s", "exact",
                                                 "captured", "collectives",
                                                 "seconds")},
        "launches": sharded["launches"],
        "cases": {case: {k: c[k] for k in ("loss", "hub_rows",
                                           "max_grad_diff", "masked_fetch")}
                  for case, c in sharded["cases"].items()}}
    summary["probes"] = {
        "kernel_probe": [{k: r.get(k) for k in (
            "name", "wall_ms", "readings_ms", "sol_frac", "rw_frac",
            "exact")}
            for r in probes["kernel_probe"]["rows"]],
        "rw_bound_ms": probes["kernel_probe"]["rw_bound_ms"],
        "gather_probe": [{k: r[k] for k in ("name", "wall_ms", "readings_ms",
                                            "sol_frac")}
                         for r in probes["gather_probe"]["rows"]],
        "roofline": [{k: r.get(k) for k in ("kernel", "wall_ms", "sol_frac",
                                            "mfu")}
                     for r in probes["roofline"]],
        "spmd_overhead": probes["spmd_overhead"],
        "launches": probes["launches"], "seconds": probes["seconds"]}
    summary["harness"] = {
        "bench": {k: harness["bench"][k] for k in (
            "line", "steps", "launches_per_step", "vs_host_reference",
            "vs_baseline_measured_json")},
        "reference_edges_per_s":
            harness["reference"]["reference_edges_per_s"],
        "cpu_model": harness["reference"]["cpu_model"],
        "quality": [{k: r[k] for k in ("data", "model", "seed", "auc",
                                       "gmean", "seconds", "peak_mem_bytes")}
                    for r in harness["quality"]["runs"]],
        "protocol_runs": harness["protocol"]["runs"],
        "spmd_scaling": harness["scaling"]["spmd_scaling"]["summary"],
        "multihost_scaling": harness["scaling"]["multihost_scaling"],
        "seconds": harness["seconds"]}
    summary["graft"] = {
        "entry": {k: graft["entry"][k] for k in (
            "launches", "seconds", "max_abs_diff_vs_cpu")},
        "dryrun_seconds": graft["dryrun"]["seconds"],
        "passes": {p: {k: rec.get(k) for k in (
            "loss", "seconds", "step_s", "launches", "build_s",
            "struct_rank_bytes", "struct_total_bytes", "directed_edges")}
            for p, rec in graft["dryrun"]["ranks"][0]["passes"].items()},
        "seconds": graft["seconds"]}
    summary["sharded"]["overlap"] = {
        case: {k: [r["overlap"][k] for r in c["ranks"]]
               for k in ("step_ms_median", "explicit_syncs",
                         "launches_between", "host_round_trips")}
        for case, c in sharded["cases"].items()}
    summary["captured"] = {
        data: {k: rec[k] for k in (
            "step_ms_median", "wall_ms_per_step", "captures", "capture_s",
            "graph_pool_bytes", "replay_launches", "event_busy_share",
            "host_syncs_per_captured_block")}
        | {"busy_share": {k: v["busy_share"]
                          for k, v in rec["profile"].items()},
           "kernels_per_step": rec["profile"]["captured"]["kernels_per_step"]}
        for data, rec in captured["lanes"].items()}
    summary["predicted"] = {
        data: {k: rec[k] for k in ("batches", "auc", "graph_pool_bytes",
                                   "replay_s", "replay_ms", "metrics_s")}
        | {"turns": [{k: x[k] for k in (
            "way", "seconds", "host_syncs", "launches", "captures",
            "replays", "capture_s")} for x in rec["turns"]]}
        for data, rec in predicted["lanes"].items()}
    summary["seconds"] = details["seconds"]
    # phase 23 per rank, one line each: step ms, launches a step by kernel
    # (the masked fetch apart), collectives a step by axis, host syncs a
    # step, peak memory
    for case, c in sharded["cases"].items():
        for r, rk in enumerate(c["ranks"]):
            print(json.dumps({"phase23": case, "rank": r, **rk,
                              "card": card}))
    print(json.dumps(summary))
    print(json.dumps({"kernels": list(entries.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank_main(sys.argv[2:]))
    sys.exit(main())
