"""The port's file loaders and data tools against the JAX package's, on
tiny fabricated files in the reference's formats (no dataset is in the
repository).

Both packages load the same files.  Ids, CSR arrays, degrees, keep counts,
window widths, dense neighbor tables, labels and report lines must be
equal; features allclose at rtol 1e-6.
"""

import os
import pickle
import types
from collections import defaultdict

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from pcgnn_tpu.data import loaders as jloaders
from pcgnn_tpu.data import process as jprocess
from pcgnn_tpu.data import verify as jverify
from pcgnn_tpu.data.synthetic import synthetic_fraud_graph as jax_graph
from pcgnn_tpu.graph import csr as jcsr
from pcgnn_tpu.train.results import ResultManager as JResults
from pcgnn_tpu.train.trainer import Trainer as JTrainer
from pcgnn_tpu_torch.data import loaders as tloaders
from pcgnn_tpu_torch.data import prep as tprep
from pcgnn_tpu_torch.data import process as tprocess
from pcgnn_tpu_torch.data import verify as tverify
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph as torch_graph
from pcgnn_tpu_torch.graph import csr as tcsr
from pcgnn_tpu_torch.train.results import ResultManager as TResults
from pcgnn_tpu_torch.train.trainer import Trainer as TTrainer

FEATURE_RTOL = 1e-6


def assert_rel_equal(j, t, what=""):
    assert t.num_nodes == j.num_nodes, what
    assert t.num_edges == j.num_edges, what
    assert (t.dmax, t.dcap, t.is_stub) == (j.dmax, j.dcap, j.is_stub), what
    assert (t.ksample_max, t.ksample_cap) == (j.ksample_max, j.ksample_cap)
    e = j.num_edges
    np.testing.assert_array_equal(t.indptr.cpu().numpy(),
                                  np.asarray(j.indptr), err_msg=what)
    np.testing.assert_array_equal(t.col.cpu().numpy()[:e],
                                  np.asarray(j.col)[:e], err_msg=what)
    for k in ("deg", "keff", "ksample"):
        np.testing.assert_array_equal(getattr(t, k).cpu().numpy(),
                                      np.asarray(getattr(j, k)),
                                      err_msg=f"{what} {k}")
    assert (t.nbr2d is None) == (j.nbr2d is None), what
    if j.nbr2d is not None:
        np.testing.assert_array_equal(t.nbr2d.cpu().numpy(),
                                      np.asarray(j.nbr2d), err_msg=what)


def assert_graph_equal(j, t):
    assert t.num_relations == j.num_relations
    for r, (jr, tr) in enumerate(zip(j.relations, t.relations)):
        assert_rel_equal(jr, tr, f"relation {r}")
    assert_rel_equal(j.homo, t.homo, "homo")
    np.testing.assert_array_equal(t.labels.cpu().numpy(),
                                  np.asarray(j.labels))
    np.testing.assert_allclose(t.features.cpu().numpy(),
                               np.asarray(j.features), rtol=FEATURE_RTOL)


def _adjacency(rng, n, extra, hub=None):
    """A reference-format adjacency: ``defaultdict(set)``, symmetric, with
    a self-loop on every node; ``hub`` links one node to many."""
    adj = defaultdict(set)
    for i in range(n):
        adj[i].add(i)
    for _ in range(extra):
        i, j = (int(x) for x in rng.integers(0, n, 2))
        adj[i].add(j)
        adj[j].add(i)
    if hub is not None:
        for j in rng.choice(n, size=min(n - 1, 300), replace=False):
            adj[hub].add(int(j))
            adj[int(j)].add(hub)
    return adj


def _feature_file(x, y, layout):
    """The ``.pt`` object of each layout the loader reads: x / y under
    ``"review"`` (YelpChi) or ``"user"`` (Amazon), at the top level, or as
    attributes of a PyG-like object in a list."""
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if layout in ("review", "user"):
        return {layout: {"x": tx, "y": ty}}
    if layout == "top":
        return {"x": tx, "y": ty}
    return [types.SimpleNamespace(x=tx, y=ty)]


def write_pickled(prefix, name, n=64, f=8, seed=0, layout="top", extra=None,
                  hub=None):
    """Fabricate ``name``'s directory under ``prefix`` in the reference's
    formats; returns the features and labels written."""
    subdir, fpref, rel_sufs, pt_name = jloaders._PICKLED[name]
    base = os.path.join(prefix, subdir)
    os.makedirs(base, exist_ok=True)
    rng = np.random.default_rng(seed)
    x = rng.random((n, f)).astype(np.float32)
    y = (rng.random(n) < 0.3).astype(np.int64)
    torch.save(_feature_file(x, y, layout), os.path.join(base, pt_name))
    for suf in ("homo",) + tuple(s for s in rel_sufs if s != "homo"):
        adj = _adjacency(rng, n, extra or 2 * n, hub)
        with open(os.path.join(base, f"{fpref}_{suf}_adjlists.pickle"),
                  "wb") as fh:
            pickle.dump(adj, fh)
    return x, y


@pytest.mark.parametrize("name,layout,threshold", [
    ("yelp", "review", 0.5),
    ("yelp", "review", [0.3, 0.5, 0.7]),
    ("amazon", "user", 0.5),
    ("amazon_new", "list", 0.4),
    ("tfinance", "top", 0.5),
    ("elliptic", "list", 0.5),
    ("weibo", "top", [0.2]),
])
def test_pickled_formats_match_jax(tmp_path, name, layout, threshold):
    x, y = write_pickled(str(tmp_path), name, layout=layout)
    prefix = str(tmp_path) + "/"
    j = jloaders.load_data(name, prefix, threshold=threshold)
    t = tloaders.load_data(name, prefix, threshold=threshold)
    assert_graph_equal(j, t)
    np.testing.assert_array_equal(t.labels.numpy(), y)
    np.testing.assert_allclose(t.features.numpy(), x, rtol=FEATURE_RTOL)
    for r, rel in enumerate(t.relations):
        # the shared homo graph keeps the homo graph's threshold
        thr = tcsr.rel_threshold(threshold, None if rel is t.homo else r)
        np.testing.assert_array_equal(
            rel.ksample.numpy(), np.ceil(thr * rel.deg.numpy()).astype(int))
    # a single-relation dataset's relation 0 is its homo graph, one object
    assert (t.relations[0] is t.homo) == (j.relations[0] is j.homo)


def test_pickled_hub_rows_match_jax(tmp_path):
    """A hub row (degree 300 among ~5) gets a window cap below dmax in
    both packages, and the same capped dense table."""
    write_pickled(str(tmp_path), "yelp", n=1024, extra=2048, hub=5,
                  layout="review")
    prefix = str(tmp_path) + "/"
    j, t = (m.load_data("yelp", prefix) for m in (jloaders, tloaders))
    assert_graph_equal(j, t)
    assert t.homo.has_hubs and t.homo.dmax > 300


def test_single_relation_graph_is_shared_through_the_port(tmp_path):
    """tfinance's relation 0 and homo graph stay one object through
    ``MultiRelGraph.to`` and the stores.  So PC-GNN's relation store is the
    homo graph's, and GCN's homo store is charged once, as relation 0's:
    under a total budget of one store it is built, where a second homo
    object would find the budget spent."""
    import dataclasses
    write_pickled(str(tmp_path), "tfinance", n=256)
    g = tloaders.load_data("tfinance", str(tmp_path) + "/")
    assert g.relations[0] is g.homo
    moved = g.to("cpu")
    assert moved.relations[0] is moved.homo
    s = tcsr.materialize_edge_windows(g, relations=True, homo=False)
    assert s.homo.ewin is not None and s.relations[0] is s.homo
    one, _ = tcsr.reference_store_bytes(g.homo.deg.numpy(),
                                        g.homo.window_width, g.feat_dim,
                                        torch.bfloat16, 1 << 30)
    kw = dict(relations=False, homo=True, fused=False, dtype=torch.bfloat16,
              total_budget_bytes=one)
    assert tcsr.materialize_edge_windows(g, **kw).homo.ewin is not None
    apart = dataclasses.replace(g, homo=dataclasses.replace(g.homo))
    assert tcsr.materialize_edge_windows(apart, **kw).homo.ewin is None


def test_loader_errors(tmp_path):
    with pytest.raises(ValueError, match="unknown dataset"):
        tloaders.load_data("nope")
    with pytest.raises(FileNotFoundError):
        tloaders.load_data("yelp", str(tmp_path) + "/")
    base = tmp_path / "pyg/TFinance/processed"
    base.mkdir(parents=True)
    torch.save({"z": torch.zeros(3)}, base / "tfinance_data.pt")
    with pytest.raises(ValueError, match="could not locate x/y"):
        tloaders.load_data("tfinance", str(tmp_path) + "/")


def _write_kdk(root, n=64, f=8, gid="007", seed=0):
    rng = np.random.default_rng(seed)
    for d in ("attributes", "labels", "G0_Hetero", "G0_Homo"):
        (root / d).mkdir()
    feats = sp.csc_matrix(rng.normal(size=(n, f)).astype(np.float32))
    sp.save_npz(root / "attributes" / f"{gid}_node_feature(CSC).npz", feats)
    np.save(root / "labels" / f"{gid}_label.npy",
            (rng.random(n) < 0.2).astype(np.int64))
    mats = []
    for t in tloaders._KDK_NETWORKS:
        m = sp.random(n, n, density=0.05, random_state=rng, format="csc")
        sp.save_npz(root / "G0_Hetero" / f"{gid}{t}(CSC).npz", m)
        mats.append(m)
    homo = sp.csc_matrix(sum(m.astype(bool).astype(np.int8) for m in mats))
    sp.save_npz(root / "G0_Homo" / f"{gid}_G0_Homo_network(CSC).npz", homo)
    return mats


@pytest.mark.parametrize("threshold", [0.5, [0.1, 0.3, 0.5, 0.7, 0.9]])
def test_kdk_matches_jax(tmp_path, threshold):
    mats = _write_kdk(tmp_path)
    prefix = str(tmp_path) + "/"
    j = jloaders.load_data("kdk", prefix, graph_id=7, threshold=threshold)
    t = tloaders.load_data("kdk", prefix, graph_id=7, threshold=threshold)
    assert_graph_equal(j, t)
    assert t.num_relations == 5 and not t.homo.is_stub
    for rel, m in zip(t.relations, mats):
        want = (m.astype(bool) + m.T.astype(bool)
                + sp.eye(m.shape[0], dtype=bool)).astype(bool)
        assert rel.num_edges == want.nnz


def test_csr_builders_match_jax():
    rng = np.random.default_rng(4)
    n = 50
    m = sp.random(n, n, density=0.1, random_state=rng, format="csr")
    for kw in (dict(), dict(add_self_loops=False, symmetrize=False),
               dict(threshold=0.3, window_cap=4)):
        assert_rel_equal(jcsr.csr_from_scipy(m, **kw),
                         tcsr.csr_from_scipy(m, **kw), str(kw))
    adj = _adjacency(rng, n, 120, hub=3)
    for kw in (dict(), dict(threshold=0.7, window_cap=8)):
        assert_rel_equal(jcsr.csr_from_adj_dict(adj, n, **kw),
                         tcsr.csr_from_adj_dict(adj, n, **kw), str(kw))
    # a row is sorted whatever order its set iterates in
    t = tcsr.csr_from_adj_dict({0: {3, 1, 2}, 2: {0}}, 4)
    assert t.col[:4].tolist() == [1, 2, 3, 0]
    assert t.deg.tolist() == [3, 0, 1, 0]


def _write_mat(path, n=24, f=3, dups=(5, 11)):
    """A raw ``Amazon.mat``: features (two rows duplicating row 0),
    labels, three ``net_*`` relations and a homo matrix."""
    rng = np.random.default_rng(0)
    feats = rng.random((n, f))
    for d in dups:
        feats[d] = feats[0]
    label = (rng.random(n) < 0.4).astype(np.float64)

    def rand_adj(seed):
        m = sp.random(n, n, density=0.2, random_state=seed, format="csc")
        return (m + m.T).sign()

    scipy.io.savemat(path, {
        "features": feats, "label": label.reshape(1, -1),
        "net_upu": rand_adj(1), "net_usu": rand_adj(2), "net_uvu": rand_adj(3),
        "homo": rand_adj(4)})


@pytest.mark.parametrize("dedup", [False, True])
def test_convert_mat_matches_jax(tmp_path, capsys, dedup):
    mat = str(tmp_path / "Amazon.mat")
    _write_mat(mat)
    outs = {}
    for tag, mod in (("jax", jprocess), ("torch", tprocess)):
        outs[tag] = str(tmp_path / f"{tag}.npz")
        mod.convert_mat(mat, outs[tag], dataset="amazon", dedup=dedup,
                        num_unlabeled=4)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].replace("jax.npz", "X") == lines[1].replace("torch.npz",
                                                                "X")
    zj, zt = np.load(outs["jax"]), np.load(outs["torch"])
    assert sorted(zj.files) == sorted(zt.files)
    for k in zj.files:
        np.testing.assert_array_equal(zt[k], zj[k], err_msg=k)
    g = tloaders.load_data(outs["torch"])
    assert g.num_nodes == (22 if dedup else 24)
    labels = g.labels.numpy()
    assert set(labels.tolist()) <= {0, 1, 2}
    assert (labels[:4] == 2).all() == dedup
    assert_graph_equal(jloaders.load_data(outs["jax"]), g)


def test_process_cli(tmp_path):
    mat = str(tmp_path / "Amazon.mat")
    _write_mat(mat)
    out = str(tmp_path / "amazon_new.npz")
    tprocess.main(["--mat", mat, "--out", out, "--dedup",
                   "--num_unlabeled", "4"])
    assert tloaders.load_data(out).num_nodes == 22


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_native_files_cross_packages(tmp_path, writer):
    """A native file written by either package loads in the other to the
    same graph; every key is written the same."""
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        jloaders.save_native(path, jax_graph("tiny", seed=3))
    else:
        tloaders.save_native(path, torch_graph("tiny", seed=3))
    z = np.load(path)
    assert sorted(z.files) == sorted(
        ["features", "labels", "num_relations", "homo_row", "homo_col"]
        + [f"rel{i}_{k}" for i in range(3) for k in ("row", "col")])
    for thr in (0.3, 0.5):
        j = jloaders.load_data(path, threshold=thr)
        t = tloaders.load_data(path, threshold=thr)
        assert_graph_equal(j, t)
    # at the generator's threshold, the graph it was written from
    assert_graph_equal(jax_graph("tiny", seed=3), t)
    other = str(tmp_path / "other.npz")
    tloaders.save_native(other, t)
    zo = np.load(other)
    for k in z.files:
        np.testing.assert_array_equal(zo[k], z[k], err_msg=k)


def test_save_native_refuses_a_stub(tmp_path, monkeypatch):
    from pcgnn_tpu_torch.data import synthetic
    monkeypatch.setitem(synthetic.PRESETS, "stress-1m",
                        (256, 8, 0.05, (512, 256, 128), 3))
    g = tloaders.load_data("synthetic:stress-1m")
    with pytest.raises(ValueError, match="degree-only stub"):
        tloaders.save_native(str(tmp_path / "s.npz"), g)


def _trainer_cfg(**kw):
    cfg = dict(seed=2, model="PCGNN", train_ratio=0.4, test_ratio=0.67,
               emb_size=8, lr=0.005, weight_decay=0.0005, alpha=2.0, rho=0.5,
               epochs=1, valid_epochs=1, batch_size=64, patience=10,
               exp_num=0)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("name,npz", [("amazon", False), ("amazon_new", False),
                                      ("amazon", True)])
def test_amazon_files_through_trainer_match_jax(tmp_path, monkeypatch, name,
                                                npz):
    """Both trainers on fabricated amazon files: the leading
    ``NUM_UNLABELED`` ids stay out of every split, features are
    row-normalized, and the graph is equal.  A native ``.npz`` of the same
    graph gets neither the unlabeled range nor the normalization, in both
    packages."""
    n = tloaders.NUM_UNLABELED[name] + 400
    write_pickled(str(tmp_path), name, n=n, f=6, extra=n, layout="user")
    data_name = name
    if npz:
        # a bare file name: the result files are named after data_name
        monkeypatch.chdir(tmp_path)
        data_name = "graph.npz"
        tloaders.save_native(data_name,
                             tloaders.load_data(name, str(tmp_path) + "/"))
    cfg = _trainer_cfg(data_name=data_name, data_prefix=str(tmp_path) + "/")
    jt = JTrainer(cfg, result=JResults(cfg, root=str(tmp_path / "j")))
    tt = TTrainer(cfg, device="cpu",
                  result=TResults(cfg, root=str(tmp_path / "t")))
    for k in ("idx_train", "idx_valid", "idx_test", "train_pos"):
        np.testing.assert_array_equal(getattr(tt, k), getattr(jt, k),
                                      err_msg=k)
    assert_graph_equal(jt.graph, tt.graph)
    split = np.concatenate([tt.idx_train, tt.idx_valid, tt.idx_test])
    num_unlabeled = 0 if npz else tloaders.NUM_UNLABELED[name]
    assert split.min() == num_unlabeled and len(split) == n - num_unlabeled
    raw = tloaders.load_data(data_name, str(tmp_path) + "/").features
    want = raw if npz else torch.from_numpy(
        tprep.normalize_features(raw.numpy()))
    torch.testing.assert_close(tt.graph.features, want, rtol=0, atol=0)


def _verify_case(tmp_path, case):
    prefix = str(tmp_path) + "/"
    if case == "unknown":
        return "nope", prefix
    if case == "yelp_stats":
        write_pickled(prefix, "yelp", n=20, f=32, layout="review")
        return "yelp", prefix
    write_pickled(prefix, "tfinance", n=48)
    victim = jverify.expected_files("tfinance", prefix)[1]
    if case == "missing":
        os.remove(victim)
    elif case == "asymmetric":
        with open(victim, "rb") as fh:
            adj = pickle.load(fh)
        adj[0].add(len(adj) - 1)
        adj[len(adj) - 1].discard(0)
        with open(victim, "wb") as fh:
            pickle.dump(adj, fh)
    return "tfinance", prefix


@pytest.mark.parametrize("case,ok,needle", [
    ("go", True, "GO: dataset verified"),
    ("missing", False, "MISSING"),
    ("asymmetric", False, "FAILED homo: symmetric adjacency"),
    ("unknown", False, "unknown dataset"),
    ("yelp_stats", False, "FAILED node count == 45954"),
])
def test_verify_dataset_matches_jax(tmp_path, case, ok, needle):
    name, prefix = _verify_case(tmp_path, case)
    got = tverify.verify_dataset(name, prefix)
    assert got == jverify.verify_dataset(name, prefix)
    assert got[0] == ok and any(needle in ln for ln in got[1]), got
    assert tverify.expected_files("yelp", prefix) == jverify.expected_files(
        "yelp", prefix)
    assert tverify._EXPECTED == jverify._EXPECTED


def test_verify_cli_exit_codes(tmp_path, capsys):
    prefix = str(tmp_path) + "/"
    write_pickled(prefix, "tfinance", n=32)
    argv = ["--data_name", "tfinance", "--data_prefix", prefix]
    assert tverify.main(argv) == 0
    assert "GO: dataset verified" in capsys.readouterr().out
    assert tverify.main(["--data_name", "amazon", "--data_prefix",
                         prefix]) == 1
    assert "NO-GO" in capsys.readouterr().out
