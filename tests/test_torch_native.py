"""The port's native graph core (``pcgnn_tpu_torch/native.py``,
``csrc/graphcore.cpp``) against its numpy version and against the JAX
package's core and ``csr_from_edges``, on seeded random edge lists.  CSR
arrays are integers: every comparison is exact.

The JAX package's core is compiled from its own source (``native/
graphcore.cpp``) into a pytest temporary directory and loaded through
``pcgnn_tpu.native``'s binding, so the comparison does not depend on a
``make`` into the shared package directory.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from pcgnn_tpu import native as jnative
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu_torch import native
from pcgnn_tpu_torch.data import synthetic as tsyn
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.ops.ragged_gather import ragged_gather

ROOT = Path(__file__).resolve().parents[1]
JAX_SOURCE = ROOT / "native" / "graphcore.cpp"

# name: (nodes, edges); the edge lists are drawn in _edges
CASES = {"random": (200, 3000), "duplicates": (40, 2000),
         "self_loops": (60, 500), "out_of_range": (80, 1500),
         "empty": (30, 0), "above_serial_size": (5000, 70000)}


def _edges(case):
    n, e = CASES[case]
    rng = np.random.default_rng(len(case) * 7 + e)
    if case == "out_of_range":
        src = rng.integers(-5, n + 5, e)
        dst = rng.integers(-5, n + 5, e)
        src[:3] = [-1, n, 2**40]
    else:
        src = rng.integers(0, n, e)
        dst = rng.integers(0, n, e)
    if case == "duplicates":
        src, dst = np.tile(src[:200], 10), np.tile(dst[:200], 10)
    if case == "self_loops":
        dst[::3] = src[::3]
    return src.astype(np.int64), dst.astype(np.int64), n


@pytest.fixture(scope="module")
def jax_core(tmp_path_factory):
    """The JAX package's core, built from its source into a private path."""
    out = tmp_path_factory.mktemp("jax_core") / "libgraphcore.so"
    subprocess.run(["g++", "-O3", "-std=c++20", "-fPIC", "-pthread",
                    "-shared", "-o", str(out), str(JAX_SOURCE)], check=True,
                   capture_output=True, timeout=300)
    return out


@pytest.fixture
def jax_native(jax_core, monkeypatch):
    monkeypatch.setattr(jnative, "_LIB_PATH", str(jax_core))
    monkeypatch.setattr(jnative, "_lib", None)
    monkeypatch.setattr(jnative, "_load_failed", False)
    assert jnative.available()
    return jnative


def test_the_core_loads():
    assert native.available(), native.load_error()
    path = Path(native.loaded_path())
    assert path.parent == native.BUILD_DIR and path.exists()
    assert native.load_error() is None


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("loops", [True, False], ids=["loops", "no_loops"])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "directed"])
@pytest.mark.parametrize("case", list(CASES))
def test_core_matches_numpy_and_jax_core(jax_native, case, sym, loops,
                                         threads):
    """indptr, col and row of the port's core equal its numpy version's and
    the JAX package's core's, bit for bit, at 1 and 8 threads."""
    src, dst, n = _edges(case)
    kw = dict(symmetrize=sym, add_self_loops=loops)
    indptr, col, row = native.build_csr(src, dst, n, num_threads=threads,
                                        **kw)
    p_indptr, p_col = tcsr.csr_arrays_plain(src, dst, n, **kw)
    j_indptr, j_col, j_row = jax_native.build_csr(src, dst, n,
                                                  num_threads=threads, **kw)
    for got in (indptr, col, row):
        assert got.dtype == np.int64
    np.testing.assert_array_equal(indptr, p_indptr)
    np.testing.assert_array_equal(col, p_col)
    np.testing.assert_array_equal(row, np.repeat(np.arange(n),
                                                 np.diff(p_indptr)))
    np.testing.assert_array_equal(indptr, j_indptr)
    np.testing.assert_array_equal(col, j_col)
    np.testing.assert_array_equal(row, j_row)
    # rows sorted and distinct; a loop on every node where asked
    for r in range(n):
        run = col[indptr[r]:indptr[r + 1]]
        assert (np.diff(run) > 0).all()
        if loops:
            assert r in run


def _assert_rel_equal(rt, rj):
    assert (rt.num_edges, rt.dmax, rt.dcap) == (rj.num_edges, rj.dmax,
                                                rj.dcap)
    e = rj.num_edges
    for name in ("indptr", "deg", "keff", "ksample", "nbr2d"):
        np.testing.assert_array_equal(getattr(rt, name).numpy(),
                                      np.asarray(getattr(rj, name)))
    np.testing.assert_array_equal(rt.col.numpy()[:e], np.asarray(rj.col)[:e])


@pytest.mark.parametrize("jax_path", ["native", "numpy"])
@pytest.mark.parametrize("loops", [True, False], ids=["loops", "no_loops"])
@pytest.mark.parametrize("sym", [True, False], ids=["sym", "directed"])
@pytest.mark.parametrize("case", ["random", "duplicates", "self_loops",
                                  "empty"])
def test_csr_from_edges_matches_jax(jax_native, monkeypatch, case, sym,
                                    loops, jax_path):
    """The port's csr_from_edges, through its core, against the JAX
    package's, through its core and through its numpy path (which keeps
    out-of-range ids, so those cases compare with the cores only)."""
    src, dst, n = _edges(case)
    kw = dict(symmetrize=sym, add_self_loops=loops, threshold=0.4)
    if jax_path == "numpy":
        monkeypatch.setattr(jax_native, "available", lambda: False)
    assert native.available()
    _assert_rel_equal(tcsr.csr_from_edges(src, dst, n, **kw),
                      jcsr.csr_from_edges(src, dst, n, **kw))


def test_csr_from_edges_without_the_core_is_equal(monkeypatch):
    """With the core refused, csr_from_edges builds the same relation with
    numpy."""
    src, dst, n = _edges("out_of_range")
    want = tcsr.csr_from_edges(src, dst, n, threshold=0.3)
    monkeypatch.setattr(native, "available", lambda: False)
    got = tcsr.csr_from_edges(src, dst, n, threshold=0.3)
    for name in ("indptr", "col", "deg", "keff", "ksample", "nbr2d"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name


@pytest.mark.parametrize("compiler", ["false", "no-such-compiler-xyz"])
def test_a_failed_build_is_reported_once(monkeypatch, tmp_path, capsys,
                                         compiler):
    """A compiler that fails, or is missing, leaves the core unavailable;
    the reason goes to stderr once, and the CSR builds with numpy."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_path", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setenv("CXX", compiler)
    assert not native.available()
    assert not native.available()
    err = capsys.readouterr().err
    assert err.count("graph core build failed") == 1, err
    assert compiler in err and "fall back to numpy" in err
    assert native.loaded_path() is None and compiler in native.load_error()
    assert list(tmp_path.iterdir()) == []          # no temporary left
    with pytest.raises(RuntimeError, match="unavailable"):
        native.csr_arrays(np.zeros(1, np.int64), np.zeros(1, np.int64), 2)
    src, dst, n = _edges("random")
    got = tcsr.csr_arrays(src, dst, n)
    want = tcsr.csr_arrays_plain(src, dst, n)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert capsys.readouterr().err == ""


_WORKER = """
import json, os, sys, time
from pathlib import Path
import numpy as np
from pcgnn_tpu_torch import native
from pcgnn_tpu_torch.graph import csr
native.BUILD_DIR = Path(sys.argv[1])
Path(sys.argv[3]).touch()
while not os.path.exists(sys.argv[2]):
    time.sleep(0.001)
ok = native.available()
src = np.arange(100) % 17
got = csr.csr_arrays(src, src[::-1].copy(), 17)
want = csr.csr_arrays_plain(src, src[::-1].copy(), 17)
print(json.dumps({"available": ok, "path": native.loaded_path(),
                  "error": native.load_error(),
                  "equal": all((a == b).all() for a, b in zip(got, want))}))
"""


def test_first_use_is_race_free_across_processes(tmp_path):
    """Processes that import the port and use the core at the same moment,
    into an empty build directory, all load one complete library: none
    falls back to numpy, and no temporary file is left."""
    build = tmp_path / "build"
    go = tmp_path / "go"
    ready = [tmp_path / f"ready-{i}" for i in range(6)]
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(build),
                               str(go), str(r)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in ready]
    deadline = time.time() + 120
    while not all(r.exists() for r in ready) and time.time() < deadline:
        time.sleep(0.01)            # every process imported and waiting
    go.touch()
    results = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
        results.append(json.loads(out.strip().splitlines()[-1]))
    assert all(r["available"] and r["equal"] and r["error"] is None
               for r in results), results
    assert len({r["path"] for r in results}) == 1
    assert sorted(os.listdir(build)) == [Path(results[0]["path"]).name]


def test_stub_degrees_match_the_global_unique():
    """The stress presets' homo degrees through the core equal the set
    semantics the JAX package computes with one global unique (the
    relations' (src, dst) pairs deduplicated, the self-loop folded in)."""
    rng = np.random.default_rng(5)
    n = 3000
    srcs = [rng.integers(0, n, k) for k in (9000, 4000, 2500)]
    dsts = [rng.integers(0, n, k) for k in (9000, 4000, 2500)]
    srcs[1][:1000], dsts[1][:1000] = srcs[0][:1000], dsts[0][:1000]
    dsts[2][:100] = srcs[2][:100]
    loops = np.arange(n, dtype=np.int64)
    key = np.unique(np.concatenate(
        [s * n + d for s, d in zip(srcs, dsts)] + [loops * n + loops]))
    want = np.bincount(key // n, minlength=n)
    np.testing.assert_array_equal(tsyn.stub_degrees(srcs, dsts, n), want)
    # and the same through the numpy version
    indptr, _ = tcsr.csr_arrays_plain(np.concatenate(srcs),
                                      np.concatenate(dsts), n,
                                      symmetrize=False)
    np.testing.assert_array_equal(np.diff(indptr), want)


def test_build_timings_name_every_step(monkeypatch):
    monkeypatch.setitem(tsyn.PRESETS, "stress-1m",
                        (2048, 8, 0.05, (8192, 4096, 2048), 3))
    timings = {}
    g = tsyn.synthetic_fraud_graph("stress-1m", seed=1, timings=timings)
    assert set(timings) == {"draws", "homo", "assemble"} | {
        f"relation {r} {step}" for r in range(3)
        for step in ("csr", "finalize")}
    assert all(v >= 0 for v in timings.values())
    assert g.homo.is_stub


# ---------------------------------------- offsets beyond 32 bits (audit)

def test_finalize_refuses_offsets_past_int32():
    """indptr is stored as int32 (as in the JAX package): a relation of
    2^31 edges is refused before anything is allocated, not wrapped."""
    with pytest.raises(ValueError, match="2\\^31"):
        tcsr.finalize_csr(np.array([0, 2**31], np.int64),
                          np.empty(0, np.int64), 1)


@pytest.mark.parametrize("start", [2**31, 2**32 + 3, -(2**32) + 3])
def test_ragged_gather_takes_starts_past_int32(start):
    """An int64 start beyond 32 bits reads past col, so every id is the
    fill: a start wrapped to 32 bits would read col[3:] instead."""
    col = torch.arange(100, dtype=torch.int32)
    starts = torch.tensor([start, 3], dtype=torch.int64)
    out = ragged_gather(col, starts, 5, 777)
    assert out[0].tolist() == [777] * 5
    assert out[1].tolist() == [3, 4, 5, 6, 7]


def test_build_profile_reports_each_step(monkeypatch, tmp_path, capsys):
    """``build_profile.py`` on a small preset: one line for the host, one
    per build, the numpy build equal to the native one, and every step's
    seconds."""
    sys.path.insert(0, str(ROOT))
    try:
        import build_profile
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(build_profile, "TOUCH_BYTES", 1 << 20)
    out = tmp_path / "profile.jsonl"
    assert build_profile.main(["--preset", "skew-tiny", "--seed", "3",
                               "--numpy", "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert capsys.readouterr().out.count("\n") == 3 == len(lines)
    host, core, plain = lines
    assert host["host"]["cores"] >= 1
    assert core["csr_path"].startswith("native ") and plain["csr_path"] == (
        "numpy")
    assert plain["equal_to_native_build"]
    for rec in (core, plain):
        assert {"draws", "homo", "relation 2 csr"} <= set(rec["steps_s"])
        assert len(rec["relations"]) == 3 and rec["top_own_s"]
