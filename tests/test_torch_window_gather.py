"""Window gather and edge-window stores: the port against the JAX package.

On the CPU the port's ``window_gather`` takes its plain version; the JAX
``window_gather`` takes its XLA fallback (the Pallas kernel compiles only for
a TPU).  Both are copies, and the stores hold copies of the same feature
rows rounded to the same dtype, so every comparison here is exact.  The
kernel itself is held against the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcgnn_tpu.data import synthetic as jsyn
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu.ops import aggregate as jagg
from pcgnn_tpu.ops.pallas import window_gather as jwg
from pcgnn_tpu_torch.data import synthetic as tsyn
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.ops import aggregate as tagg
from pcgnn_tpu_torch.ops import kernels
from pcgnn_tpu_torch.ops import window_gather as twg

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


# starts of each kind, for a store of 6 * 1024 elements and dp = 1024: the
# JAX fallback (``lax.dynamic_slice``) wraps a negative start once by adding
# the length, then clamps every start into [0, L - dp]
_L, _DP = 6 * 1024, 1024
_STARTS = {
    "in_range": None,
    "unaligned": [1, 2, 3, 5, 6, 7, 9, 1027, 1029, 4093, _L - _DP - 1],
    "negative": [-1, -3, -7, -8, -_DP, -_DP - 3, -_L + 5, -_L, -_L - 1,
                 -3 * _L, -2 ** 31],
    "past_the_end": [_L - _DP, _L - _DP + 1, _L - _DP + 8, _L - 1, _L,
                     _L + 3, 2 * _L, 2 ** 31 - 1],
}


@pytest.mark.parametrize("case", sorted(_STARTS))
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_plain_matches_jax_fallback(dtype, case):
    """In-range, unaligned, negative and past-the-end starts: the port's
    window (its plain version on the CPU) equals the JAX function's exactly,
    so both take every start as ``lax.dynamic_slice`` takes it."""
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(0)
    store = rng.normal(size=_L).astype(np.float32)
    dp = _DP
    if _STARTS[case] is None:
        # 37 rows (not a multiple of 8), arbitrary element starts
        starts = rng.integers(0, store.size - dp, 37).astype(np.int32)
    else:
        starts = np.asarray(_STARTS[case], np.int32)
    rows = len(starts)
    want = jwg.window_gather(jnp.asarray(store, jdt), jnp.asarray(starts), dp,
                             aligned=False)
    got = twg.window_gather(torch.tensor(store, dtype=tdt),
                            torch.from_numpy(starts), dp)
    assert got.dtype == tdt and got.shape == (rows, dp)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    # int64 starts and an active mask give the same copy on the CPU
    act = torch.from_numpy(rng.integers(0, 2, rows).astype(np.int32))
    again = twg.window_gather(torch.tensor(store, dtype=tdt),
                              torch.from_numpy(starts.astype(np.int64)), dp,
                              active=act)
    assert torch.equal(again, got)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_widened_window_is_the_upcast_copy(dtype):
    """``out_dtype=float32`` gives the copy upcast exactly (bf16 widens,
    float32 stays), at any start; the default is the store's dtype."""
    _, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(1)
    store = torch.tensor(rng.normal(size=_L), dtype=tdt)
    starts = torch.tensor(_STARTS["unaligned"] + _STARTS["negative"]
                          + _STARTS["past_the_end"])
    raw = twg.window_gather(store, starts, 520)
    wide = twg.window_gather(store, starts, 520, out_dtype=torch.float32)
    assert raw.dtype == tdt and wide.dtype == torch.float32
    assert torch.equal(wide, raw.to(torch.float32))
    assert torch.equal(twg.window_gather_plain(store, starts, 520,
                                               out_dtype=torch.float32), wide)
    # a fetch that widens leaves unpack_window nothing to convert
    assert tagg.unpack_window(wide, 65, 8).data_ptr() == wide.data_ptr()


def test_wrapper_rejects_bad_dp_and_out_dtype():
    store = torch.zeros(4096)
    starts = torch.zeros(3, dtype=torch.int64)
    for dp in (0, -8, 4097):
        with pytest.raises(ValueError, match="dp="):
            twg.window_gather(store, starts, dp)
    with pytest.raises(TypeError, match="out_dtype"):
        twg.window_gather(store, starts, 64, out_dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="out_dtype"):
        twg.window_gather(store.bfloat16(), starts, 64,
                          out_dtype=torch.float16)
    assert twg.window_gather(store, starts, 4096).shape == (3, 4096)


def _both_graphs(seed: int, f: int):
    """The same edge lists built into a JAX and a port graph.  The last 20
    nodes get no edges, so their only neighbor is their self-loop (degree
    1); an odd ``f`` exercises the JAX bf16 store's padded slot column."""
    rng = np.random.default_rng(seed)
    n = 200
    feats = rng.normal(size=(n, f)).astype(np.float32)
    labels = (rng.random(n) < 0.2).astype(np.int64)
    rels_j, rels_t, srcs, dsts = [], [], [], []
    for e in (400, 900, 150):
        src = rng.integers(0, n - 20, e)
        dst = rng.integers(0, n - 20, e)
        rels_j.append(jcsr.csr_from_edges(src, dst, n))
        rels_t.append(tcsr.csr_from_edges(src, dst, n))
        srcs.append(src)
        dsts.append(dst)
    src, dst = np.concatenate(srcs), np.concatenate(dsts)
    gj = jcsr.build_multirel(rels_j, jcsr.csr_from_edges(src, dst, n), feats,
                             labels)
    gt = tcsr.build_multirel(rels_t, tcsr.csr_from_edges(src, dst, n), feats,
                             labels)
    return gj, gt


def _valid(rel_t, batch: np.ndarray) -> np.ndarray:
    d = max(rel_t.window_width, 1)
    deg = np.minimum(rel_t.deg.numpy()[batch], d)
    return np.arange(d)[None, :] < deg[:, None]


@pytest.mark.parametrize("f", [4, 5])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_store_windows_match_jax(dtype, f):
    """Every valid slot of the per-relation windows and of each fused-record
    section equals JAX ``unpack_window(batch_raw_window(...))``, and the
    numpy truth: the neighbor's feature row rounded to the store dtype."""
    jdt, tdt = _DTYPES[dtype]
    gj, gt = _both_graphs(1, f)
    gj_rel = jcsr.materialize_edge_windows(gj, dtype=jdt, fused=False)
    gj_fused = jcsr.materialize_edge_windows(gj, dtype=jdt, fused=True)
    gt = tcsr.materialize_edge_windows(gt, dtype=tdt, fused=True)
    assert gj_fused.fused is not None and gt.fused is not None
    rng = np.random.default_rng(2)
    # 61 rows: not a multiple of 8; includes degree-1 rows and a duplicate
    batch = np.concatenate([rng.integers(0, 180, 56), [199, 185, 190, 3, 3]])
    bj, bt = jnp.asarray(batch, jnp.int32), torch.from_numpy(batch)
    feats = gt.features.to(tdt).float().numpy()
    rec_j = np.asarray(jagg.batch_record_window(gj_fused, bj))
    rec_t = tagg.batch_record_window(gt, bt)
    assert rec_t.dtype == torch.float32          # widened by the fetch
    for r, rel_t in enumerate(gt.relations):
        rel_j = gj_rel.relations[r]
        d = max(rel_t.window_width, 1)
        valid = _valid(rel_t, batch)
        assert valid[-5:-2].sum(axis=1).tolist() == [1, 1, 1]
        want = np.asarray(jagg.unpack_window(
            jagg.batch_raw_window(rel_j, bj), d, f, rel_j.ewin_fs,
            rel_j.ewin_packed))
        got = tagg.unpack_window(tagg.batch_raw_window(rel_t, bt), d, f)
        assert got.dtype == torch.float32 and got.shape == (61, d, f)
        got = got.numpy()
        np.testing.assert_array_equal(got[valid], want[valid])
        truth = feats[rel_t.nbr2d.numpy()[batch].clip(max=gt.num_nodes - 1)]
        np.testing.assert_array_equal(got[valid], truth[valid])
        # the fused record's section r holds the same window
        fj = gj_fused.relations[r]
        sec_j = np.asarray(jagg.unpack_window(
            jnp.asarray(rec_j[:, gj_fused.fused_off[r]:
                              gj_fused.fused_off[r + 1]]),
            d, f, fj.ewin_fs, fj.ewin_packed))
        sec_t = tagg.unpack_window(
            rec_t[:, gt.fused_off[r]: gt.fused_off[r + 1]], d, f).numpy()
        np.testing.assert_array_equal(sec_t[valid], sec_j[valid])
        np.testing.assert_array_equal(sec_t[valid], truth[valid])


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_store_layout_is_gpu_aligned(dtype):
    """Runs start on 16-byte boundaries, the window length is whole 16-byte
    vectors, and the tail keeps one window of slack past the last run."""
    _, tdt = _DTYPES[dtype]
    _, gt = _both_graphs(3, 5)
    gt = tcsr.materialize_edge_windows(gt, dtype=tdt)
    for rel in gt.relations:
        a = 16 // rel.ewin.element_size()
        assert rel.ewin.dtype == tdt and rel.ewin_f == 5
        assert rel.ewin_dp % a == 0
        assert (rel.estart % a == 0).all()
        assert int(rel.estart.max()) + rel.ewin_dp <= rel.ewin.numel()
    w = gt.fused.shape[1]
    assert w == gt.fused_off[-1] and (w * gt.fused.element_size()) % 16 == 0


def test_store_budget_skips_relation():
    _, gt = _both_graphs(4, 4)
    rel = gt.relations[1]
    assert tcsr.attach_edge_windows(rel, gt.features, budget_bytes=64).ewin \
        is None
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tcsr.attach_edge_windows(rel, gt.features, dtype=torch.float16)
    # a graph whose relations lack stores gets no fused store either
    g2 = tcsr.materialize_edge_windows(gt, total_budget_bytes=64)
    assert g2.fused is None and all(r.ewin is None for r in g2.relations)


def _tiny_pair():
    return (jsyn.synthetic_fraud_graph("tiny", seed=0),
            tsyn.synthetic_fraud_graph("tiny", seed=0))


@pytest.mark.parametrize("budget,stored", [(16_777_216, [False, True, False]),
                                           (211_136, [False, False, False])])
def test_store_coverage_matches_jax(budget, stored):
    """``synthetic:tiny``, seed 0, bf16: at one total budget both packages
    store the same relations, as the JAX package's byte accounting of its
    own layout decides (the port's smaller 16-byte runs decide nothing)."""
    gj0, gt0 = _tiny_pair()
    gj = jcsr.materialize_edge_windows(gj0, dtype=jnp.bfloat16,
                                       total_budget_bytes=budget)
    gt = tcsr.materialize_edge_windows(gt0, dtype=torch.bfloat16,
                                       total_budget_bytes=budget)
    assert [r.ewin is not None for r in gj.relations] == stored
    assert [r.ewin is not None for r in gt.relations] == stored
    for rj, rt in zip(gj.relations, gt.relations):
        if rj.ewin is not None:
            assert tcsr.reference_store_bytes(
                rt.deg.numpy(), rt.window_width, gt0.feat_dim, torch.bfloat16,
                budget) == (int(rj.ewin.size) * 4, rj.ewin_aligned)
            assert rt.ewin_aligned == rj.ewin_aligned
    # the accounting alone, for one relation: aligned, then exact runs
    rel = gt0.relations[1]
    deg = rel.deg.numpy()
    full = tcsr.reference_store_bytes(deg, rel.window_width, gt0.feat_dim,
                                      torch.bfloat16, 2 ** 40)
    assert full == (16_777_216, True)
    assert tcsr.reference_store_bytes(deg, rel.window_width, gt0.feat_dim,
                                      torch.bfloat16, 16_777_215) is None


def _ref_charges(gj, dtype):
    """Bytes of each relation store the JAX package builds at full budget."""
    return sum(int(jcsr.attach_edge_windows(r, np.asarray(gj.features),
                                            dtype=dtype).ewin.size) * 4
               for r in gj.relations)


@pytest.mark.parametrize("over", [0, -1])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_fused_store_coverage_matches_jax(dtype, over):
    """A total budget of the relations' stores plus the JAX record table,
    and one byte less: the fused store exists in both packages or in
    neither."""
    jdt, tdt = _DTYPES[dtype]
    gj0, gt0 = _tiny_pair()
    fused = jcsr.materialize_edge_windows(gj0, dtype=jdt).fused
    budget = _ref_charges(gj0, jdt) + int(fused.size) * 4 + over
    gj = jcsr.materialize_edge_windows(gj0, dtype=jdt,
                                       total_budget_bytes=budget)
    gt = tcsr.materialize_edge_windows(gt0, dtype=tdt,
                                       total_budget_bytes=budget)
    assert all(r.ewin is not None for r in (*gj.relations, *gt.relations))
    assert (gj.fused is not None) == (gt.fused is not None) == (over == 0)


@pytest.mark.parametrize("over", [0, -1])
@pytest.mark.parametrize("dtype", sorted(_DTYPES))
def test_homo_store_coverage_matches_jax(dtype, over):
    """The baselines' homo store takes what the relations' stores leave:
    at the relations' stores plus the JAX homo store, and one byte less,
    the homo store exists in both packages or in neither, though the port
    builds no relation store for GCN and GraphSAGE."""
    jdt, tdt = _DTYPES[dtype]
    gj0, gt0 = _tiny_pair()
    homo = jcsr.attach_edge_windows(gj0.homo, np.asarray(gj0.features),
                                    dtype=jdt).ewin
    budget = _ref_charges(gj0, jdt) + int(homo.size) * 4 + over
    gj = jcsr.materialize_edge_windows(gj0, dtype=jdt,
                                       total_budget_bytes=budget)
    gt = tcsr.materialize_edge_windows(gt0, dtype=tdt, relations=False,
                                       homo=True, fused=False,
                                       total_budget_bytes=budget)
    assert all(r.ewin is None for r in gt.relations)
    assert (gj.homo.ewin is not None) == (gt.homo.ewin is not None) \
        == (over == 0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    store = torch.zeros(4096)
    starts = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(TypeError):
        twg.window_gather(store.double(), starts, 64)
    with pytest.raises(TypeError):
        twg.window_gather(store, starts.float(), 64)
    with pytest.raises(ValueError):
        twg.window_gather(store.view(64, 64), starts, 64)
    with pytest.raises(ValueError):
        twg.window_gather(store, starts, 64, active=torch.ones(2))
    # a tensor that is on neither the CPU nor a CUDA card is refused, not
    # copied through the plain version
    with pytest.raises(ValueError, match="unsupported device"):
        twg.window_gather(store.to("meta"), starts.to("meta"), 64)
    with pytest.raises(ValueError, match="several devices"):
        twg.window_gather(store, starts.to("meta"), 64)


def test_cpu_path_launches_no_kernel():
    before = twg.launches
    twg.window_gather(torch.zeros(256), torch.tensor([0, 8]), 32)
    assert twg.launches == before


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    """A missing compiler is an exception, never a quiet fallback."""
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(kernels, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.load("window_gather")


def test_kernel_build_command_targets_hopper(tmp_path):
    cmd = kernels.nvcc_command("nvcc", "window_gather", tmp_path / "k.so")
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in cmd and "-O3" in cmd
    assert cmd[-1].endswith("csrc/window_gather.cu")
    # the library is named by its source's hash: an edited source rebuilds
    assert kernels.library_path("window_gather").name.startswith(
        "window_gather-")
    assert set(kernels.KERNELS) == {p.stem for p in kernels.CSRC.glob("*.cu")}
