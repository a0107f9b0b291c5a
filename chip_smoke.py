#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pcgnn_tpu_torch``) on one GPU and check it.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (``nvcc``); exits non-zero, with no
result line, on any failure.  In order:

  1. builds every CUDA kernel of the package from ``pcgnn_tpu_torch/csrc``
     (one ``nvcc`` per source, all at once) and prints the compiler report;
  2. builds the ``synthetic:yelp-like`` graph and its bf16 edge-window and
     fused record stores on the card, then holds each kernel against its
     plain PyTorch version on the card at the main path's shapes (and on
     ragged, masked and float32 cases), exactly (the kernel is a copy), and
     times kernel, plain version, a one-call PyTorch yardstick and the
     memory-bound floor;
  3. trains PC-GNN on yelp-like at full width with the bench configuration
     for 2 epochs (12 steps) in the fused-record lane through ``Trainer``,
     with every launch count set to 0 just before and read just after, then
     evaluates the validation split;
  4. runs steps in the per-relation store lane (fused store off);
  5. profiles one epoch of main-path steps (device time by kernel, kernel
     launches per step, the card's busy share);
  6. runs one step on the card and the same step on the CPU's plain path,
     from the same weights and batch, and compares loss, gradients and
     parameters.

The line before the last is the card's name and power limit; before it, a
``{"kernels": [...]}`` line; the last line is
``{"ok": true, "device": {...}}``.  Longer details go to
``build/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the bench configuration of the repo (bench.py), cut to 2 epochs
BENCH_CFG = dict(seed=2, data_name="synthetic:yelp-like", model="PCGNN",
                 train_ratio=0.4, test_ratio=0.67, emb_size=64, lr=0.01,
                 weight_decay=0.001, alpha=2.0, rho=0.5, epochs=2,
                 valid_epochs=10 ** 9, batch_size=1024, patience=10 ** 9,
                 exp_num=0, ewin_dtype="bfloat16")
TIMING_REPS = 30
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def memory_rate(name: str) -> float:
    """The card's published memory rate in bytes/s, from its name."""
    if "H200" in name:
        return 4.8e12
    if "H100" in name:
        if "PCIe" in name:
            return 2.0e12
        if "NVL" in name:
            return 3.9e12
        return 3.35e12            # H100 SXM (80GB HBM3)
    raise RuntimeError(f"no published memory rate known for {name!r}")


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


def time_ms(fn, args_list) -> tuple[float, float]:
    """(device ms, run ms) per call of ``fn(*args)`` over ``args_list``,
    after one warm-up call.  Device ms is the kernels' own time under
    torch.profiler; run ms is CUDA events around the whole run of
    back-to-back calls over the count, which also holds the card's idle
    gaps while the host launches the next call."""
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for args in args_list:
            fn(*args)
        torch.cuda.synchronize()
    dev_ms = sum(ms for _, ms, _ in device_kernels(prof)) / len(args_list)
    return dev_ms, run_ms


def check_gather(store, starts, dp, active=None) -> float:
    """Kernel against plain version on the card, on the rows it copies;
    returns max |err|.  The kernel is a copy: anything but equality fails."""
    from pcgnn_tpu_torch.ops.window_gather import (window_gather,
                                                   window_gather_plain)
    out = window_gather(store, starts, dp, active=active)
    ref = window_gather_plain(store, starts, dp)
    torch.cuda.synchronize()
    rows = slice(None) if active is None else active.bool()
    out, ref = out[rows], ref[rows]
    err = float((out.float() - ref.float()).abs().max()) if out.numel() else 0.0
    if not torch.equal(out, ref):
        raise AssertionError(f"window_gather disagrees with its plain "
                             f"version (dp={dp}, max |err| {err})")
    return err


def strided_rows(store, dp, a):
    """[L/a, dp] overlapping view: row i is store[i*a : i*a + dp]."""
    n = (store.numel() - dp) // a + 1
    return store.as_strided((n, dp), (a, 1))


def kernel_phase(t, rate: float) -> tuple[dict, dict]:
    """Phase 2: exactness on the card and timings at the main path's
    shapes.  Returns (kernels-line entry, details)."""
    from pcgnn_tpu_torch.ops import window_gather as wg
    from pcgnn_tpu_torch.ops.window_gather import (window_gather,
                                                   window_gather_plain)
    g, dev = t.graph, t.device
    b = t.batch_size
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [t.idx_train_dev[torch.randint(len(t.idx_train), (b,),
                                             generator=gen, device=dev)]
               for _ in range(TIMING_REPS)]
    fused = g.fused
    w = fused.shape[1]
    esize = fused.element_size()
    flat = fused.view(-1)
    details = {"cases": []}

    errs = [check_gather(flat, batches[0] * w, w)]
    for rel in g.relations:
        errs.append(check_gather(rel.ewin, rel.estart[batches[0]],
                                 rel.ewin_dp))
    # B = 1000, starts aligned to 16 bytes but not to records, active mask
    a = 16 // esize
    ragged = torch.randint(0, (flat.numel() - w) // a, (1000,),
                           generator=gen, device=dev) * a
    active = torch.randint(0, 2, (1000,), generator=gen, device=dev,
                           dtype=torch.int32)
    errs.append(check_gather(flat, ragged, w))
    errs.append(check_gather(flat, ragged, w, active=active))
    # a float32 store at the widest relation's window
    f32 = torch.randn(1 << 24, generator=gen, device=dev)
    dp32 = g.relations[-1].ewin_dp
    st32 = torch.randint(0, (f32.numel() - dp32) // 4, (1000,),
                         generator=gen, device=dev) * 4
    errs.append(check_gather(f32, st32, dp32))
    errs.append(check_gather(f32, st32, dp32,
                             active=torch.ones(1000, dtype=torch.int32,
                                               device=dev)))

    def case(name, store, starts_list, dp, table, rows_list):
        """Times one window shape: the kernel alone (``launch`` on checked
        arguments), the wrapper (its checks read the starts back to the
        host), the plain version, and one ``index_select`` of the same
        windows from ``table``, a [rows, dp] view of the store.  ``*_ms``
        is device time per call, ``*_run_ms`` the back-to-back run time."""
        rows = len(starts_list[0])
        out = torch.empty((rows, dp), dtype=store.dtype, device=store.device)
        starts = [(s,) for s in starts_list]
        # bytes the copy must move: each window read once and written once,
        # plus the int64 starts
        nbytes = 2 * rows * dp * store.element_size() + rows * 8
        c = {"name": name, "rows": rows, "dp": dp,
             "dtype": str(store.dtype).replace("torch.", ""),
             "bound_ms": nbytes / rate * 1e3, "bytes": nbytes}
        for key, fn, args in (
                ("ms", lambda s: wg.launch(store, s, None, out), starts),
                ("wrapper_ms", lambda s: window_gather(store, s, dp), starts),
                ("plain_ms", lambda s: window_gather_plain(store, s, dp),
                 starts),
                ("library_ms", lambda i: torch.index_select(table, 0, i),
                 [(i,) for i in rows_list])):
            c[key], c[key.replace("ms", "run_ms")] = time_ms(fn, args)
        details["cases"].append(c)
        return c

    main = case("fused_record", flat, [bt * w for bt in batches], w,
                fused, batches)
    for r, rel in enumerate(g.relations):
        a_r = 16 // rel.ewin.element_size()
        starts = [rel.estart[bt] for bt in batches]
        case(f"relation_{r}", rel.ewin, starts, rel.ewin_dp,
             strided_rows(rel.ewin, rel.ewin_dp, a_r),
             [s // a_r for s in starts])
    entry = {"name": "window_gather", "route": "cuda",
             "source": "pcgnn_tpu_torch/csrc/window_gather.cu",
             "replaces": "pcgnn_tpu/ops/pallas/window_gather.py:223",
             "launches": None, "max_abs_err": max(errs), "exact": True,
             "ms": main["ms"], "plain_ms": main["plain_ms"],
             "bound_ms": main["bound_ms"], "bound_by": "bytes",
             "library_ms": main["library_ms"]}
    return entry, details


def edges_per_epoch(t) -> float:
    """Expected candidate edges per epoch (bench.py's definition): each of
    the epoch's picked nodes contributes deg_r(v) slots per relation."""
    p = t.pick_weights.double().cpu().numpy()
    p = p / p.sum()
    per_sample = sum(float((p * rel.deg.double().cpu().numpy()[t.idx_train])
                           .sum()) for rel in t.graph.relations)
    return per_sample * t.sample_size


def main_path_phase(t) -> dict:
    """Phase 3: 2 epochs of training through Trainer's step, then one
    validation evaluate; every kernel count is 0 just before."""
    from pcgnn_tpu_torch.ops import window_gather as wg
    from pcgnn_tpu_torch.train.metrics import evaluate
    model = t.new_model()
    opt = t.new_optimizer(model)
    step_ms, losses = [], []
    torch.cuda.reset_peak_memory_stats()
    wg.launches = 0
    for epoch in range(t.config["epochs"]):
        batches, weights = t.epoch_plan(epoch)
        for bt, wt in zip(batches, weights):
            before = wg.launches
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = t.step(model, opt, bt, t.graph.labels[bt], wt)
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            losses.append(float(loss))
            if wg.launches < before + 1:
                raise AssertionError("a training step launched no "
                                     "window_gather kernel")
    train_launches = wg.launches
    res = evaluate(lambda nodes: t.predict(model, nodes), t.idx_valid,
                   t.y_valid, t.batch_size, print_line=False)
    launches = wg.launches
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not res.auc > 0.5:
        raise AssertionError(f"validation AUC {res.auc} is not above 0.5")
    steady = float(np.median(step_ms[1:]))
    return {"steps": len(step_ms), "step_ms": step_ms,
            "step_ms_median": steady, "losses": losses,
            "train_launches": train_launches, "launches": launches,
            "valid_auc": res.auc, "valid_f1_macro": res.f1_macro,
            "edges_per_s": edges_per_epoch(t)
            / (steady * 1e-3 * t.num_batches),
            "peak_mem_bytes": torch.cuda.max_memory_allocated()}


def profile_phase(t) -> dict:
    """Where a main-path step's time goes: one epoch of fused-lane steps
    under torch.profiler, after a warm-up step.  Device time by kernel, the
    count of kernel launches, and the share of the epoch's wall time the
    card was busy."""
    from torch.profiler import ProfilerActivity, profile
    model = t.new_model()
    opt = t.new_optimizer(model)
    batches, weights = t.epoch_plan(0)
    labels = [t.graph.labels[bt] for bt in batches]
    t.step(model, opt, batches[0], labels[0], weights[0])
    torch.cuda.synchronize()
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
    gather = [(ms, n) for k, ms, n in busy if "window_gather_kernel" in k]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "window_gather_device_ms_per_launch":
                gather[0][0] / gather[0][1] if gather else None,
            "device_ms_per_step": device_ms / steps,
            "busy_share": device_ms / wall_ms,
            "kernel_launches_per_step": launch_calls / steps,
            "top_device_ms_per_step": [(k, ms / steps, n / steps)
                                       for k, ms, n in busy[:15]]}


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


def card_vs_cpu_phase(t) -> dict:
    """Phase 5: one step on the card and on the CPU's plain path from the
    same weights and batch."""
    from pcgnn_tpu_torch.train.trainer import make_optimizer, train_step
    cfg = t.config
    batches, weights = t.epoch_plan(0)
    bt, wt = batches[0], weights[0]
    model_c = t.new_model()
    model_h = copy.deepcopy(model_c).to("cpu")
    graph_h = t.graph.to("cpu")
    consts_h = {k: v.to("cpu") for k, v in t.consts.items()}
    out = {}
    for name, model, graph, consts, dev in (
            ("card", model_c, t.graph, t.consts, t.device),
            ("cpu", model_h, graph_h, consts_h, torch.device("cpu"))):
        opt = make_optimizer(model, cfg["lr"], cfg["weight_decay"])
        b, w = bt.to(dev), wt.to(dev)
        out[name] = float(train_step(model, opt, graph, b, graph.labels[b],
                                     w, consts))
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
    return {"loss_card": out["card"], "loss_cpu": out["cpu"],
            "max_abs_diff": diffs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from pcgnn_tpu_torch.ops import kernels
    from pcgnn_tpu_torch.train.trainer import Trainer

    t0 = time.time()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    rate = memory_rate(name)
    for kname, report in kernels.build().items():
        print(f"[build {kname}]\n{report.strip()}", file=sys.stderr)
    print(f"built kernels in {time.time() - t0:.1f} s", file=sys.stderr)

    t1 = time.time()
    t = Trainer(BENCH_CFG, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.time() - t1
    g = t.graph
    print(f"yelp-like graph and stores on the card in {setup_s:.1f} s: "
          f"N={g.num_nodes} fused={tuple(g.fused.shape)} "
          f"{g.fused.dtype} dps={[r.ewin_dp for r in g.relations]}",
          file=sys.stderr)

    entry, kdetails = kernel_phase(t, rate)
    main_run = main_path_phase(t)
    entry["launches"] = main_run["launches"]
    store_run = store_lane_phase(t)
    prof = profile_phase(t)
    cross = card_vs_cpu_phase(t)

    details = {"card": card, "kind": name, "setup_s": setup_s,
               "kernel": kdetails, "main_path": main_run,
               "store_lane": store_run, "profile": prof,
               "card_vs_cpu": cross, "seconds": time.time() - t0}
    os.makedirs("build", exist_ok=True)
    with open(os.path.join("build", "chip_smoke.json"), "w") as f:
        json.dump(details, f, indent=1)
    print(json.dumps({"main_path": {
        k: main_run[k] for k in ("steps", "step_ms_median", "edges_per_s",
                                 "valid_auc", "train_launches", "launches")},
        "store_lane_launches": store_run["launches"],
        "profile": {k: prof[k] for k in (
            "wall_ms_per_step", "device_ms_per_step", "busy_share",
            "kernel_launches_per_step",
            "window_gather_device_ms_per_launch")},
        "card_vs_cpu_loss": [cross["loss_card"], cross["loss_cpu"]],
        "seconds": details["seconds"]}))
    print(json.dumps({"kernels": [entry]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
