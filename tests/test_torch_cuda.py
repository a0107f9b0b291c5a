"""The hand-written kernels on the card.  A CUDA kernel has no CPU mode, so
these tests carry the ``cuda`` marker and skip where no card is present.

This file imports neither JAX nor the JAX package (the GPU machine has
neither), so it runs there without the repository's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

The window and ragged gathers are copies and the mask build writes 0s and
1s and integer counts, so each kernel must equal its plain version
exactly.  The model on the card is compared with the same
model on the CPU's plain path: both select the same rows (selection scores
are rounded once from float64), and their float32 sums run in another
order, so logits agree to rtol 1e-5 with atol 1e-6.
"""

import dataclasses
import math
import warnings

import numpy as np
import pytest
import torch

from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.graph import csr
from pcgnn_tpu_torch.models.pcgnn import PCGNN
from pcgnn_tpu_torch.ops import gather_probe as gp
from pcgnn_tpu_torch.ops import hub
from pcgnn_tpu_torch.ops import mask_build as mb
from pcgnn_tpu_torch.ops import ragged_gather as rg
from pcgnn_tpu_torch.ops import window_gather as wg

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _starts(gen, rows, length, dp, a, device):
    return torch.randint(0, (length - dp) // a + 1, (rows,), generator=gen,
                         device=device) * a


@pytest.mark.parametrize("dtype,dp", [
    (torch.bfloat16, 8), (torch.bfloat16, 544), (torch.bfloat16, 6784),
    (torch.bfloat16, 8896), (torch.float32, 4), (torch.float32, 1000),
    (torch.float32, 3392)])
@pytest.mark.parametrize("rows", [1, 7, 1000, 1024])
def test_kernel_equals_plain(card, dtype, dp, rows):
    gen = torch.Generator(device=card).manual_seed(rows + dp)
    store = torch.randn(1 << 20, generator=gen, device=card).to(dtype)
    a = 16 // store.element_size()
    starts = _starts(gen, rows, store.numel(), dp, a, card)
    ref = wg.window_gather_plain(store, starts, dp)
    before = wg.launches
    out = wg.window_gather(store, starts, dp)
    assert wg.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (rows, dp)
    assert torch.equal(out, ref)
    # int32 starts and an active mask: active rows are copied exactly
    active = torch.randint(0, 2, (rows,), generator=gen, device=card,
                           dtype=torch.int32)
    out2 = wg.window_gather(store, starts.to(torch.int32), dp, active=active)
    torch.cuda.synchronize()
    assert torch.equal(out2[active.bool()], ref[active.bool()])


def test_kernel_reaches_the_store_end(card):
    store = torch.arange(4096, dtype=torch.float32, device=card)
    out = wg.window_gather(store, torch.tensor([4096 - 64, 0], device=card), 64)
    torch.cuda.synchronize()
    assert out[0, -1].item() == 4095 and out[1, 0].item() == 0


def _any_starts(length, dp, a, gen, device):
    """Starts of every kind: in range at every offset mod a (a elements a
    16-byte vector), at and past the end, negative (wrapped once, then
    clamped), and random aligned ones."""
    fixed = [0, length - dp, length - dp + 1, length - 1, length, length + 5,
             3 * length, -1, -a - 1, -dp, -length, -length - 1, -3 * length,
             2 ** 31 - 1, -2 ** 31]
    fixed += [4096 + k for k in range(1, a)] + [length - dp - k
                                                for k in range(1, a)]
    rand = torch.randint(0, (length - dp) // a + 1, (24,), generator=gen,
                         device=device) * a
    return torch.cat([torch.tensor(fixed, device=device), rand])


@pytest.mark.parametrize("widen", [False, True])
@pytest.mark.parametrize("dtype,dp", [
    (torch.bfloat16, 13), (torch.bfloat16, 512), (torch.bfloat16, 832),
    (torch.bfloat16, 2048), (torch.bfloat16, 4096), (torch.bfloat16, 8128),
    (torch.bfloat16, 8896), (torch.float32, 6), (torch.float32, 200),
    (torch.float32, 1000), (torch.float32, 3392)])
def test_kernel_takes_any_start(card, dtype, dp, widen):
    """Clamped, negative and past-the-end starts, every misalignment of a
    start (1-7 elements for bf16, 1-3 for f32), rows that take blocks of 1
    to 8 warps (and loop past 8), a dp that is not whole units, int32
    starts (widened by the wrapper) and int64 ones, with and without
    ``active``, in the store's dtype and widened to float32: the kernel
    equals the plain version bit for bit."""
    gen = torch.Generator(device=card).manual_seed(dp + widen)
    store = torch.randn(1 << 18, generator=gen, device=card).to(dtype)
    a = 16 // store.element_size()
    starts = _any_starts(store.numel(), dp, a, gen, card)
    out_dtype = torch.float32 if widen else dtype
    ref = wg.window_gather_plain(store, starts, dp, out_dtype=out_dtype)
    active = torch.randint(0, 2, starts.shape, generator=gen, device=card,
                           dtype=torch.int32)
    for st in (starts, starts.to(torch.int32)):
        for act in (None, active):
            out = torch.full((len(st), dp), -1.0, dtype=out_dtype,
                             device=card)
            before = wg.launches
            wg.launch(store, st.to(torch.int64).contiguous(), act, out)
            assert wg.launches == before + 1
            torch.cuda.synchronize()
            rows = slice(None) if act is None else act.bool()
            assert torch.equal(out[rows], ref[rows]), (st.dtype, act is None)
            if act is not None:        # inactive rows are not written
                assert out[~act.bool()].eq(-1).all()
    got = wg.window_gather(store, starts, dp, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert got.dtype == out_dtype and torch.equal(got, ref)


def test_window_gather_makes_no_host_sync(card):
    store = torch.arange(4096, dtype=torch.float32, device=card)
    starts = torch.tensor([5, -3, 4000, 16], device=card)
    wg.window_gather(store, starts, 512)            # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = wg.window_gather(store, starts, 512)
        wide = wg.window_gather(store.bfloat16(), starts, 512,
                                out_dtype=torch.float32)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out[:, 0].tolist() == [5, 4096 - 512, 4096 - 512, 16]
    assert torch.equal(wide, out.bfloat16().float())


def test_wrapper_raises_on_bad_arguments(card):
    store = torch.zeros(4096, device=card)
    ok = torch.tensor([0, 4], device=card)
    bad = [
        (store, ok, 0),                                       # dp <= 0
        (store, ok, 4097),                                    # dp > L
        (store[::2], ok, 8),                                  # strided
        (store[1:], ok, 8),                                   # not 16-byte
        (store, ok.cpu(), 8),                                 # two devices
    ]
    for args in bad:
        with pytest.raises(ValueError):
            wg.window_gather(*args)
    with pytest.raises(TypeError):
        wg.window_gather(store, ok, 8, out_dtype=torch.bfloat16)
    assert wg.window_gather(store, ok[:0], 8).shape == (0, 8)
    # what the wrapper refused before, and now copies: a start that is not
    # 16-byte aligned, past the end or negative, and a dp that is not
    # whole vectors
    store = torch.arange(4096, dtype=torch.float32, device=card)
    for starts, dp in ((torch.tensor([2], device=card), 8),
                       (torch.tensor([4096 - 4], device=card), 8),
                       (torch.tensor([-4], device=card), 8),
                       (ok, 6)):
        got = wg.window_gather(store, starts, dp)
        torch.cuda.synchronize()
        assert torch.equal(got, wg.window_gather_plain(store, starts, dp))


def _graph_pair(card, dtype, fused):
    g = synthetic_fraud_graph("small", seed=3)
    host = csr.materialize_edge_windows(g, dtype=dtype, fused=fused)
    dev = csr.materialize_edge_windows(g.to(card), dtype=dtype, fused=fused)
    return host, dev


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_store_build_on_card_equals_cpu(card, dtype):
    host, dev = _graph_pair(card, dtype, True)
    for rh, rd in zip(host.relations, dev.relations):
        assert torch.equal(rd.ewin.cpu(), rh.ewin)
        assert torch.equal(rd.estart.cpu(), rh.estart)
    assert dev.fused_off == host.fused_off
    assert torch.equal(dev.fused.cpu(), host.fused)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_model_on_card_equals_cpu(card, dtype, fused):
    host, dev = _graph_pair(card, dtype, fused)
    gen = torch.Generator().manual_seed(0)
    model_h = PCGNN(host.feat_dim, 16, 3, 2.0, 0.5, generator=gen)
    model_d = PCGNN(host.feat_dim, 16, 3, 2.0, 0.5).to(card)
    model_d.load_state_dict(model_h.state_dict())
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.integers(0, host.num_nodes, 1000))
    labels = host.labels[batch]
    tp = torch.nonzero(host.labels == 1)[:, 0][:200]
    kw = dict(train_pos=tp, train_pos_valid=torch.ones(len(tp), dtype=bool))
    out_h = model_h(host, batch, labels, train=True, **kw)
    wg.launches = 0
    out_d = model_d(dev, batch.to(card), labels.to(card), train=True,
                    **{k: v.to(card) for k, v in kw.items()})
    assert wg.launches == (1 if fused else host.num_relations)
    for h, d in zip(out_h, out_d):
        torch.testing.assert_close(d.cpu(), h, rtol=1e-5, atol=1e-6)


def test_trainer_epoch_on_card(card, tmp_path):
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    cfg = dict(seed=2, data_name="synthetic:small", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=1,
               valid_epochs=1, batch_size=256, patience=10, exp_num=0)
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)))
    assert t.device.type == "cuda" and t.graph.fused.is_cuda
    model = t.new_model()
    opt = t.new_optimizer(model)
    wg.launches = 0
    loss = float(t.run_epoch(model, opt, 0))
    assert math.isfinite(loss)
    # one window gather a step: the wrapper launched it at the warm-up
    # step and recorded it at the capture; every other step replayed it
    r = t.runner(model, opt)
    assert r.eager_steps + r.replays == t.num_batches
    assert r.replay_launches["window_gather"] == 1
    assert wg.launches == r.eager_steps + r.captures


# the choose kernel's cases: (rows, F, relation widths, the width of the
# relation with hub rows or None, round to bfloat16): the benchmark cells'
# sections of the fused records (YelpChi's [1024, 8,512], 16-byte aligned
# at F = 32; Amazon's [256, 23,925], unaligned at F = 25; the hub cell's
# R-S-R capped at 192), a float32 store among bfloat16 ones, and widths past
# the kernel's shared-memory budgets (distances spilled to a scratch row;
# a tile of two slots; more features than threads)
_CHOOSE_CASES = {
    "yelpchi": (1024, 32, (17, 49, 200), None, False),
    "amazon": (256, 25, (52, 700, 205), None, False),
    "hubs": (1024, 32, (17, 49, 192), 192, False),
    "mixed": (256, 25, (52, 700), None, True),
    "wide": (8, 4, (20000,), None, False),
    "deep": (16, 3000, (40,), None, False),
}


def _choose_windows(card, case, seed):
    """Fused records of ``case`` and each relation's (raw section, width,
    degrees, keep counts, hub cap); the centers' scores, w0 (a strided view,
    as the model's) and b0.  Values are positive and multiples of 2^-12
    under 2, so every sum of them is exact in float32 (bfloat16 values where
    the store is bfloat16; 2^-12 more, which rounding to bfloat16 drops,
    where ``round``).  Rows 0-63 repeat slot 0 in slots 1-3 (ties) and
    their centers score as slot 0 (a self-loop at distance 0); rows 64-95
    keep 0, 96-127 their valid count, 128-159 more than the width; a
    relation with hubs has rows past its cap."""
    from pcgnn_tpu_torch.ops.aggregate import selection_score
    rows, f, widths, hub_cap, rnd = _CHOOSE_CASES[case]
    gen = torch.Generator(device=card).manual_seed(seed)
    rec = (torch.rand((rows, sum(widths) * f), generator=gen, device=card)
           + 0.5).to(torch.bfloat16).float()
    if rnd:
        rec += 2.0 ** -12
    w = torch.randn((f, 2), generator=gen, device=card)
    w0, b0 = w[:, 0], torch.randn(2, generator=gen, device=card)[0]
    center = torch.randn(rows, generator=gen, device=card) * w0.norm() + b0
    rels, off = [], 0
    for d in widths:
        raw = rec[:, off: off + d * f]
        off += d * f
        if d >= 4:
            raw[:64, f: 4 * f] = raw[:64, :f].repeat(1, 3)
        top = d + 8 if hub_cap else d
        deg = torch.randint(0, top + 1, (rows,), generator=gen, device=card,
                            dtype=torch.int32)
        k = (deg + 1) // 2
        keff = torch.where(deg <= k + 1, deg, k)
        keff[64:96] = 0
        keff[96:128] = deg[96:128].clamp(max=d)
        keff[128:160] = d + 1
        rels.append((raw, d, deg, keff, hub_cap if d == hub_cap else None))
    slot0 = rels[0][0][:, :f]
    if rnd:
        slot0 = slot0.to(torch.bfloat16).float()
    center[:64] = selection_score(slot0, w0, b0)[:64]
    return rels, center, w0, b0


@pytest.mark.parametrize("case", sorted(_CHOOSE_CASES))
def test_choose_kernel_equals_plain(card, case):
    """The choose kernel against its plain version (the chain of ops it
    replaced): its scores equal ``selection_score``'s bits, keep masks and
    counts are equal, and sums, exact in float32 here, within rtol 1e-6;
    a second launch repeats every bit, a launch is counted and makes no
    host sync, and without ``want_keep`` no mask is written."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import choose_window as cw
    rels, center, w0, b0 = _choose_windows(card, case, seed=7)
    rows_in, f, _, _, rnd = _CHOOSE_CASES[case]
    for raw, d, deg, keff, hub_cap in rels:
        args = (raw, d, f, center, w0, b0, deg, keff)
        kw = dict(hub_cap=hub_cap, round_bf16=rnd)
        want = agg.choose_window_sum_plain(*args, **kw)
        before = cw.launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = agg.choose_window_sum(*args, **kw)
            again = agg.choose_window_sum(*args, **kw)
            bare = agg.choose_window_sum(*args, **kw, want_keep=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert cw.launches == before + 3
        num, cnt, keep = got
        assert torch.equal(keep, want[2]), (case, d)
        assert torch.equal(cnt, want[1]), (case, d)
        torch.testing.assert_close(num, want[0], rtol=1e-6, atol=0)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert bare[2] is None and torch.equal(bare[0], num)
        assert torch.equal(bare[1], cnt)
        # the cases are there: partial keeps, ties and hub rows
        n = deg.clamp(max=d)
        if hub_cap is not None:
            n = torch.where(deg > hub_cap, 0, n)
            assert (deg > hub_cap).any() and not keep[deg > hub_cap].any()
        chose = (keff > 0) & (keff < n)
        assert chose.sum() >= min(8, rows_in // 4)
        # the scores the kernel took: selection_score's bits at every
        # scored slot
        scores = torch.full((raw.shape[0], d), float("nan"), device=card)
        out = (torch.empty_like(num), torch.empty_like(cnt))
        cw.launch(raw, d, f, center, w0, b0, deg, keff, hub_cap, rnd, *out,
                  None, scores=scores)
        rows = raw[:, : d * f].reshape(-1, d, f)
        if rnd:
            rows = rows.to(torch.bfloat16).float()
        ref = agg.selection_score(rows, w0, b0)
        scored = chose[:, None] & (torch.arange(d, device=card) < n[:, None])
        assert torch.equal(scores[scored], ref[scored]), (case, d)
        assert torch.isnan(scores[~scored]).all()


# the ids source's cases: (rows, F, table columns, relation widths, the
# width of the relation with hub rows or None, the score column or None,
# a sentinel row N): the stress cell's clamped CSR lane (a [N, 64] table of
# 16-byte rows, no sentinel), hub_table's F + 1 columns (the train-positive
# indicator) and F + 2 (the score-table lane's score and indicator), both
# unaligned, at widths past the rank select and past shared memory, and
# values scored at their bfloat16 rounding (``rounded``)
_IDS_CASES = {
    "stress": (1024, 64, 64, (36, 23, 14), None, None, False),
    "padded": (1024, 32, 32, (17, 49), None, None, True),
    "hub_table": (512, 32, 33, (49, 300), 300, None, True),
    "score_table": (512, 32, 34, (17, 300), 300, 32, True),
    "wide": (8, 5, 6, (20000,), None, None, True),
    "wide_table": (8, 5, 7, (20000,), None, 5, True),
    "rounded": (512, 32, 32, (17, 49), None, None, True),
}


def _ids_inputs(card, case, seed):
    """A table of ``case`` and each relation's (ids [B, D], degrees, keep
    counts, hub cap); the centers' scores, w0 (a strided view) and b0.
    Values are bfloat16 values in [0.5, 2), so every sum of them is exact
    in float32 (``rounded``: 2^-12 more, which rounding to bfloat16
    drops); the score column holds each row's score.  Invalid slots
    hold ids far past the table (a read of one faults), or N, the padding
    id, past a table without a sentinel row.  Rows 0-63 take their own
    node at slot 0 and repeat it in slots 1-3 (a self-loop at distance 0
    and ties); rows 64-95 keep 0, 96-127 their valid count, 128-159 more
    than the width; a relation with hubs has rows past its cap."""
    from pcgnn_tpu_torch.ops.aggregate import selection_score
    rows, f, cols, widths, hub_cap, score_col, sentinel = _IDS_CASES[case]
    n = 200_000
    gen = torch.Generator(device=card).manual_seed(seed)
    xs = (torch.rand((n + sentinel, cols), generator=gen, device=card)
          + 0.5).to(torch.bfloat16).float()
    if case == "rounded":
        xs += 2.0 ** -12
    w = torch.randn((f, 2), generator=gen, device=card)
    w0, b0 = w[:, 0], torch.randn(2, generator=gen, device=card)[0]
    if score_col is not None:
        xs[:, score_col] = selection_score(xs[:, :f], w0, b0)
    batch = torch.randint(0, n, (rows,), generator=gen, device=card)
    center = selection_score(xs[batch, :f].to(torch.bfloat16).float()
                             if case == "rounded" else xs[batch, :f], w0, b0)
    if rows > 64:
        center[64:] = (torch.randn(rows - 64, generator=gen, device=card)
                       * w0.norm() + b0)
    rels = []
    for d in widths:
        top = d + 8 if hub_cap else d
        deg = torch.randint(0, top + 1, (rows,), generator=gen, device=card,
                            dtype=torch.int32)
        deg[:64] = deg[:64].clamp(min=min(d, 4))
        nbr = torch.randint(0, n, (rows, d), generator=gen, device=card,
                            dtype=torch.int32)
        nbr[:64, : min(d, 4)] = batch[:64, None].int()
        k = (deg + 1) // 2
        keff = torch.where(deg <= k + 1, deg, k)
        keff[64:96] = 0
        keff[96:128] = deg[96:128].clamp(max=d)
        keff[128:160] = d + 1
        cap = hub_cap if d == hub_cap else None
        valid = torch.arange(d, device=card) < deg.clamp(max=d)[:, None]
        if cap is not None:
            valid &= ~(deg > cap)[:, None]
        pad = n if not sentinel else 2 ** 31 - 1
        nbr = torch.where(valid, nbr, pad)
        rels.append((nbr, deg, keff, cap))
    return xs, rels, center, w0, b0


@pytest.mark.parametrize("case", sorted(_IDS_CASES))
def test_choose_ids_kernel_equals_plain(card, case):
    """The choose kernel's ids source against its plain version (the chain
    of ops it replaced): keep masks and counts equal, sums (exact here)
    within float32 round-off of the order, and the scores it took equal
    ``selection_score``'s on the card (the same arithmetic) or the score
    column; invalid slots' ids, past the table, are never read.  A second
    launch repeats every bit, launches are counted and make no host sync,
    and without ``want_keep`` no mask is written."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import choose_window as cw
    xs, rels, center, w0, b0 = _ids_inputs(card, case, seed=3)
    rows_in, f, _, _, _, score_col, _ = _IDS_CASES[case]
    rnd = case == "rounded"
    for nbr, deg, keff, hub_cap in rels:
        d = nbr.shape[1]
        args = (xs, nbr, f, center, w0, b0, deg, keff)
        kw = dict(hub_cap=hub_cap, score_col=score_col, round_bf16=rnd)
        want = agg.choose_ids_sum_plain(*args, **kw)
        before = cw.ids_launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = agg.choose_ids_sum(*args, **kw)
            again = agg.choose_ids_sum(*args, **kw)
            bare = agg.choose_ids_sum(*args, **kw, want_keep=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        assert cw.ids_launches == before + 3
        num, cnt, keep = got
        assert torch.equal(keep, want[2]), (case, d)
        assert torch.equal(cnt, want[1]), (case, d)
        torch.testing.assert_close(num, want[0], rtol=1e-6, atol=0)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        assert bare[2] is None and torch.equal(bare[0], num)
        assert torch.equal(bare[1], cnt)
        # the cases are there: partial keeps, self-loops and hub rows
        n = deg.clamp(max=d)
        if hub_cap is not None:
            n = torch.where(deg > hub_cap, 0, n)
            assert (deg > hub_cap).any() and not keep[deg > hub_cap].any()
        chose = (keff > 0) & (keff < n)
        assert chose.sum() >= min(8, rows_in // 4)
        assert keep[:64, 0][(keff[:64] > 0) & (n[:64] > 0)].all()
        # the scores the kernel took
        scores = torch.full((len(nbr), d), float("nan"), device=card)
        out = (torch.empty_like(num), torch.empty_like(cnt))
        cw.launch_ids(xs, nbr, f, score_col, center, w0, b0, deg, keff,
                      hub_cap, rnd, *out, None, scores=scores)
        scored = chose[:, None] & (torch.arange(d, device=card) < n[:, None])
        rows = xs[torch.where(scored, nbr, 0)]
        sel = rows[..., :f]
        if rnd:
            sel = sel.to(torch.bfloat16).float()
        ref = (agg.selection_score(sel, w0, b0)
               if score_col is None else rows[..., score_col])
        assert torch.equal(scores[scored], ref[scored]), (case, d)
        assert torch.isnan(scores[~scored]).all()


def _score_reference(rows: np.ndarray, w0: np.ndarray, b0: float):
    """[..., F] float32 rows -> [...] float32, the score kernel's
    arithmetic in numpy: feature j into float64 chain j mod 4 in order
    (past the last multiple of 4, chain 0), (a0 + a1) + (a2 + a3) + b0,
    rounded once.  A float32 product is exact in float64, so each of the
    kernel's fused multiply-adds is this product and sum."""
    x = rows.astype(np.float64)
    w = w0.astype(np.float64)
    f = x.shape[-1]
    a = [np.zeros(x.shape[:-1]) for _ in range(4)]
    for j in range(f - f % 4):
        a[j % 4] = a[j % 4] + x[..., j] * w[j]
    for j in range(f - f % 4, f):
        a[0] = a[0] + x[..., j] * w[j]
    return (((a[0] + a[1]) + (a[2] + a[3])) + np.float64(b0)).astype(
        np.float32)


def test_selection_score_kernel_equals_float64(card):
    """``selection_score`` on the card is the score kernel: on the train
    positives' [P, 64] table and on strided views of a [B, D, F + 2]
    table (a hub chunk's rows) and of fused records ([B, D * F] sections),
    and at F past a chunk of 32 features (36 in 16-byte reads, 70 in
    4-byte ones, with a tail past the last multiple of 4), it equals the
    kernel's arithmetic in numpy bit for bit and the float64 expression to
    an ulp, gives a row the same value in every layout, launches once a
    call with no host sync, and leaves the CPU path the float64
    expression."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import choose_window as cw
    gen = torch.Generator(device=card).manual_seed(5)
    table = torch.randn((200_000, 64), generator=gen, device=card)
    wide = torch.randn((1024, 36, 66), generator=gen, device=card)
    wide[:, 5, :64] = table[:1024]
    rec = torch.randn((1024, 5000), generator=gen, device=card)
    cases = {"table": table, "chunk": wide[..., :64],
             "records": rec[:, 7: 7 + 36 * 64].view(1024, 36, 64),
             "f36": torch.randn((5000, 36), generator=gen, device=card),
             "f70": torch.randn((3001, 72), generator=gen,
                                device=card)[:, :70]}
    assert not cases["chunk"].is_contiguous()
    weights = {f: torch.randn((f, 2), generator=gen, device=card)[:, 0]
               for f in (64, 36, 70)}
    b0 = torch.randn(2, generator=gen, device=card)[0]
    before = cw.score_launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = {k: agg.selection_score(v, weights[v.shape[-1]], b0)
               for k, v in cases.items()}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cw.score_launches == before + len(cases)
    b0n = float(b0)
    for k, v in cases.items():
        rows, w0 = v.cpu(), weights[v.shape[-1]].cpu()
        assert torch.equal(got[k].cpu(), torch.from_numpy(
            _score_reference(rows.numpy(), w0.numpy(), b0n))), k
        expr = agg.selection_score(rows, w0, b0.cpu())
        ulp = torch.finfo(torch.float32).eps * expr.abs().clamp(min=2 ** -126)
        assert ((got[k].cpu() - expr).abs() <= ulp).all(), k
    assert torch.equal(got["chunk"][:, 5], got["table"][:1024])
    rows, w0 = table[:64].cpu(), weights[64].cpu()
    assert torch.equal(agg.selection_score(rows, w0, b0.cpu()),
                       (rows.double() @ w0.double()
                        + b0.cpu().double()).float())


def test_selection_score_kernel_widens_half_rows_and_refuses_others(card):
    """On the card, bfloat16 and float16 rows are widened to float32
    (exactly) and scored by the kernel, as the float32 rows of the same
    values are, bit for bit and one launch a call; float64 rows raise, as
    no float64 copy is scored on the card."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import choose_window as cw
    gen = torch.Generator(device=card).manual_seed(6)
    x = torch.randn((3000, 9, 40), generator=gen, device=card)
    w0 = torch.randn(40, generator=gen, device=card)
    b0 = torch.randn((), generator=gen, device=card)
    for dtype in (torch.bfloat16, torch.float16):
        half = x.to(dtype)
        before = cw.score_launches
        got = agg.selection_score(half, w0, b0)
        assert cw.score_launches == before + 1, dtype
        assert got.dtype == torch.float32 and got.shape == (3000, 9)
        assert torch.equal(got, agg.selection_score(half.float(), w0, b0))
    before = cw.score_launches
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        agg.selection_score(x.double(), w0, b0)
    assert cw.score_launches == before


_OVERSAMPLE_CASES = {
    # case: (rows, F, relation widths, train positives P, m_max, the hub
    # cap of the relation that width, the ids: "table" (nbr2d read at the
    # batch, the store lanes) or "rows" ([B, D], the CSR lane))
    "yelpchi": (1024, 32, (17, 49, 200), 2600, 50, None, "table"),
    "amazon": (256, 25, (52, 700, 205), 330, 175, None, "table"),
    "hubs": (1024, 32, (17, 49, 192), 2600, 48, 192, "table"),
    "stress": (1024, 64, (36, 23, 14), 200_000, 9, None, "rows"),
    # a window of 12,032 entries, past a block's shared memory; F past a
    # block's threads; five relations, two launches
    "spill": (16, 300, (40, 9, 3, 77, 20), 20_000, 3000, None, "rows"),
}


def _oversample_inputs(card, case, seed):
    """One step's arguments of ``oversample_minor_sums`` for ``case``:
    train positives (a twentieth invalid) whose scores take few values
    (ties on both sides of a center), centers at valid train positives'
    scores (some 1e-3 off), random labels (rows 0-7 fraud), and per
    relation a neighbor table whose first column holds each batch row's
    center's train positive and two more columns train positives (kept
    neighbors among the candidates), random degrees (a relation with a
    hub cap has rows past it), sample counts and keep masks, and its
    sums.  Values are bfloat16 values in [0.5, 2), so every sum of them
    here is exact in float32."""
    from pcgnn_tpu_torch.graph.csr import RelGraph
    rows_b, f, widths, p, m_max, hub_cap, ids_form = _OVERSAMPLE_CASES[case]
    gen = torch.Generator(device=card).manual_seed(seed)

    def ints(hi, shape, dtype=torch.int64):
        return torch.randint(0, hi, shape, generator=gen, device=card,
                             dtype=dtype)

    def halves(shape):
        return (torch.rand(shape, generator=gen, device=card) + 0.5).to(
            torch.bfloat16).float()

    n = max(4 * p, 50_000)
    tp = torch.randperm(n, generator=gen, device=card)[:p]
    tpv = torch.rand(p, generator=gen, device=card) < 0.95
    tp_s0 = ints(max(p // 8, 4), (p,)).float() / 97
    tp_rows = halves((p, f))
    batch = torch.randperm(n, generator=gen, device=card)[:rows_b]
    labels = ints(2, (rows_b,))
    labels[:8] = 1
    valid = torch.nonzero(tpv)[:, 0]
    near = valid[ints(len(valid), (rows_b,))]
    center = tp_s0[near].clone()
    center[::3] += 1e-3
    z = torch.zeros(1, dtype=torch.int32, device=card)
    rels, sums = [], []
    for d in widths:
        nbr2d = ints(n + 1, (n, d), torch.int32)
        nbr2d[:, 1: 3] = tp[ints(p, (n, min(2, d - 1)))].int()
        nbr2d[batch, 0] = tp[near].int()
        cap = hub_cap if d == hub_cap else None
        rel = RelGraph(indptr=z, col=z, deg=ints(d + 9, (n,), torch.int32),
                       keff=z, ksample=ints(2 * m_max + 4, (n,), torch.int32),
                       num_nodes=n, num_edges=0, dmax=d + 8 if cap else d,
                       dcap=d, nbr2d=nbr2d)
        keep = torch.rand((rows_b, d), generator=gen, device=card) < 0.6
        rels.append((rel, nbr2d[batch] if ids_form == "rows" else None,
                     keep))
        sums.append((halves((rows_b, f)), ints(9, (rows_b,)).float()))
    return (center, tp_s0, tp, tpv, tp_rows, m_max, batch, labels, rels,
            sums)


@pytest.mark.parametrize("case", sorted(_OVERSAMPLE_CASES))
def test_oversample_kernel_equals_plain(card, case):
    """The oversample kernel against its plain version (the chain of ops
    it replaced), on the card: each fraud row's candidates in (distance,
    slot) order and each relation's minors taken equal the chain's
    selection exactly, counts are equal and sums (exact here) within rtol
    1e-6; a second launch repeats every bit, launches are counted (one a
    four relations) and make no host sync, and rows that are not fraud
    centers, hub rows and duplicates of kept neighbors take nothing."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import kernels
    from pcgnn_tpu_torch.ops import oversample_minors as om
    (center, tp_s0, tp, tpv, tp_rows, m_max, batch, labels, rels,
     sums) = _oversample_inputs(card, case, seed=11)
    args = (center, tp_s0, tp, tpv, tp_rows, m_max, batch, labels, 0.5,
            rels)
    want = [(num.clone(), cnt.clone()) for num, cnt in sums]
    agg.oversample_minor_sums_plain(*args, want)
    cand_slots, keeps = agg.oversample_minor_keeps(*args[:4], m_max, batch,
                                                   labels, 0.5, rels)
    r = len(rels)
    views = [(torch.full((len(batch), m_max), -1, dtype=torch.int32,
                         device=card),
              torch.zeros((r, len(batch), m_max), dtype=torch.bool,
                          device=card)) for _ in range(2)]
    got = [[(num.clone(), cnt.clone()) for num, cnt in sums]
           for _ in range(2)]
    ranked = agg.rank_train_positives(tp_s0, tpv)
    before = om.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        for out, view in zip(got, views):
            agg.oversample_minor_sums(*args, out, ranked=ranked, view=view)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert om.launches == before + 2 * -(-r // 4)
    for (num, cnt), (wn, wc) in zip(got[0], want):
        assert torch.equal(cnt, wc), case
        torch.testing.assert_close(num, wn, rtol=1e-6, atol=0)
    assert all(torch.equal(a, b) for x, y in zip(*got)
               for a, b in zip(x, y))
    # the selection itself: the minors each relation took, and the slots
    # of the candidates any relation took, in the chain's order
    slots, taken = views[0]
    assert torch.equal(taken, torch.stack(keeps)), case
    some = taken.any(0)
    assert torch.equal(slots[some], cand_slots[some]), case
    assert torch.equal(views[1][0], slots) and torch.equal(views[1][1], taken)
    # the cases are there
    lib = kernels.load("oversample_minors")
    om._bind(lib)
    c = 0 if 2 * m_max >= len(tp) else max(128, -(-2 * m_max // 128) * 128)
    assert (lib.oversample_minors_scratch(len(tp), c, m_max) > 0) == (
        case == "spill")
    assert (c == 0) == (case == "amazon")
    fraud = labels == 1
    assert some[fraud].any() and not taken[:, ~fraud].any()
    for (rel, _, _), k in zip(rels, keeps):
        if rel.has_hubs:
            hub = rel.deg[batch] > rel.window_width
            assert hub[fraud].any() and not k[hub].any()
    no_dedup = agg.oversample_minor_keeps(
        *args[:4], m_max, batch, labels, 0.5,
        [(rel, nbr, torch.zeros_like(keep)) for rel, nbr, keep in rels])[1]
    assert any((a & ~b).any() for a, b in zip(no_dedup, keeps)), case


@pytest.mark.parametrize("d", [1, 100, 128, 512, 1000, 20480])
@pytest.mark.parametrize("rows", [1, 7, 32, 1024])
def test_ragged_kernel_equals_plain(card, d, rows):
    """Any start (unaligned, repeated, near and past the end of col, and
    negative), int32 and int64 starts, widths that are not multiples of
    128: the kernel equals the plain version bit for bit."""
    gen = torch.Generator(device=card).manual_seed(rows * 7 + d)
    e = 50_000
    col = torch.randint(0, 1 << 30, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    starts = torch.randint(0, e, (rows,), generator=gen, device=card)
    starts[0] = e - 3
    if rows > 2:
        starts[1] = starts[2]
    if rows > 4:
        starts[3] = -5
        starts[4] = e + 7
    for st in (starts, starts.to(torch.int32)):
        ref = rg.ragged_gather_plain(col, st, d, 12345)
        before = rg.launches
        out = rg.ragged_gather(col, st, d, 12345)
        assert rg.launches == before + 1
        torch.cuda.synchronize()
        assert out.dtype == torch.int32 and out.shape == (rows, d)
        assert torch.equal(out, ref)
    assert out[0, 3:].eq(12345).all()


def test_ragged_kernel_makes_no_host_sync(card):
    col = torch.arange(4096, dtype=torch.int32, device=card)
    starts = torch.tensor([5, 4000, 17], device=card)
    rg.ragged_gather(col, starts, 512, 4096)       # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = rg.ragged_gather(col, starts, 512, 4096)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out[1, 95].item() == 4095 and out[1, 96].item() == 4096


def test_ragged_wrapper_raises_on_bad_arguments(card):
    col = torch.zeros(4096, dtype=torch.int32, device=card)
    ok = torch.tensor([0, 4], device=card)
    for args in [(col[::2], ok, 8, 0),                 # strided
                 (col, ok.cpu(), 8, 0),                # two devices
                 (col, ok, 2 ** 30, 0)]:               # B * d past int32
        with pytest.raises(ValueError):
            rg.ragged_gather(*args)
    assert rg.ragged_gather(col, ok[:0], 8, 0).shape == (0, 8)


@pytest.mark.parametrize("d", [17, 49, 212, 513, 16896])
def test_ragged_kernel_every_alignment(card, d):
    """Starts at every offset mod 4, near, at and past the end of col and
    negative, from a 16-byte-aligned col (vector path where d % 4 == 0) and
    from a view one id in (scalar path): the kernel equals the plain
    version bit for bit."""
    gen = torch.Generator(device=card).manual_seed(d)
    base = torch.randint(0, 1 << 30, (40_001,), generator=gen, device=card,
                         dtype=torch.int32)
    for col in (base[:40_000], base[1:]):
        e = col.numel()
        starts = torch.tensor(
            [0, 1, 2, 3, 4097, 4098, 4099, 4100, e - d - 1, e - d, e - d + 1,
             e - 5, e - 4, e - 1, e, e + 3, -1, -3, -d - 2, 1000],
            device=card)
        for st in (starts, starts.to(torch.int32)):
            ref = rg.ragged_gather_plain(col, st, d, -7)
            out = rg.ragged_gather(col, st, d, -7)
            torch.cuda.synchronize()
            assert torch.equal(out, ref), (d, col.data_ptr() % 16)
    assert out[13, 1:].eq(-7).all() and out[14].eq(-7).all()


@pytest.mark.parametrize("d", [36, 23, 14])
def test_ragged_kernel_at_stress_10m_width(card, d):
    """Stress-10m's path calls: [1024, dcap] windows at int32 starts into
    a column of 130M ids (its relation 0), and int64 starts past 2^31,
    which read the fill (a start wrapped to 32 bits would read ids):
    the kernel equals the plain version bit for bit."""
    gen = torch.Generator(device=card).manual_seed(d)
    e = 130_000_000
    col = torch.randint(0, 10_000_000, (e,), generator=gen, device=card,
                        dtype=torch.int32)
    starts = torch.randint(0, e, (1024,), generator=gen, device=card,
                           dtype=torch.int32)
    starts[:3] = torch.tensor([0, e - d, e - 5], dtype=torch.int32)
    far = starts.to(torch.int64)
    far[3:6] = torch.tensor([2**31, 2**32 + 3, -(2**32) + 3])
    for st in (starts, far):
        ref = rg.ragged_gather_plain(col, st, d, 10_000_000)
        out = rg.ragged_gather(col, st, d, 10_000_000)
        torch.cuda.synchronize()
        assert torch.equal(out, ref)
    assert out[3:6].eq(10_000_000).all() and out[2, 5:].eq(10_000_000).all()


def test_native_core_on_the_card_machine(card):
    """The native graph core builds and loads on the card machine's host
    and gives what the numpy version gives."""
    from pcgnn_tpu_torch import native
    assert native.available(), native.load_error()
    rng = np.random.default_rng(0)
    n = 200_000
    src, dst = rng.integers(0, n, 2_000_000), rng.integers(0, n, 2_000_000)
    for sym in (True, False):
        got = native.csr_arrays(src, dst, n, symmetrize=sym)
        want = csr.csr_arrays_plain(src, dst, n, symmetrize=sym)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def _skew_pair(card, dtype):
    g = synthetic_fraud_graph("skew-tiny", seed=3)
    host = csr.materialize_edge_windows(g, dtype=dtype)
    dev = csr.materialize_edge_windows(g.to(card), dtype=dtype)
    return host, dev


def test_hub_lane_syncs_once_per_relation(card):
    """The hub lane reads its chunk plan back in ONE device-to-host copy;
    everything else it launches stays on the card."""
    _, dev = _skew_pair(card, torch.float32)
    rel = dev.relations[0]
    batch = torch.argsort(rel.deg, descending=True)[:64]
    is_hub = rel.deg[batch] > rel.window_width
    xs = torch.cat([dev.features, dev.features.new_zeros((1, 16))])
    w0 = torch.randn(16, device=card)
    b0 = torch.zeros((), device=card)
    args = (rel, batch, is_hub, xs, 16, torch.zeros(64, device=card))
    hub.hub_choose_sum(*args, w0=w0, b0=b0, chunk=4, block=128)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            before = rg.launches
            hub.hub_choose_sum(*args, w0=w0, b0=b0, chunk=4, block=128)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in syncs]
    assert rg.launches - before == -(-int(is_hub.sum()) // 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hub_model_on_card_equals_cpu(card, dtype):
    """skew-tiny, every hub row in the batch: the hub lane on the card
    selects and sums as on the CPU."""
    host, dev = _skew_pair(card, dtype)
    gen = torch.Generator().manual_seed(0)
    model_h = PCGNN(host.feat_dim, 16, 3, 2.0, 0.5, generator=gen)
    model_d = PCGNN(host.feat_dim, 16, 3, 2.0, 0.5).to(card)
    model_d.load_state_dict(model_h.state_dict())
    rel = host.relations[0]
    hubs = torch.nonzero(rel.deg > rel.window_width)[:, 0]
    rng = np.random.default_rng(1)
    batch = torch.cat([hubs, torch.from_numpy(
        rng.integers(0, host.num_nodes, 500))])
    labels = host.labels[batch].clone()
    labels[: len(hubs): 2] = 1
    tp = torch.nonzero(host.labels == 1)[:, 0][:200]
    kw = dict(train_pos=tp, train_pos_valid=torch.ones(len(tp), dtype=bool))
    out_h = model_h(host, batch, labels, train=True, **kw)
    rg.launches = 0
    out_d = model_d(dev, batch.to(card), labels.to(card), train=True,
                    **{k: v.to(card) for k, v in kw.items()})
    assert rg.launches >= 1
    for h, d in zip(out_h, out_d):
        torch.testing.assert_close(d.cpu(), h, rtol=1e-5, atol=1e-6)


def test_trainer_epoch_on_card_with_hubs(card, tmp_path):
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    cfg = dict(seed=2, data_name="synthetic:skew-tiny", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=1,
               valid_epochs=1, batch_size=128, patience=10, exp_num=0)
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)))
    assert t.graph.relations[0].has_hubs
    model = t.new_model()
    opt = t.new_optimizer(model)
    rg.launches = 0
    loss = float(t.run_epoch(model, opt, 0))
    assert math.isfinite(loss)
    assert rg.launches >= 1


def _mask_args(gen, rows, slots, n, device):
    """Ids over [-2, n + 2): real ids, the sentinel n and ids outside the
    domain; duplicates within rows; row 0 all dropped and row 1 all
    sentinels where there are such rows."""
    ids = torch.randint(-2, n + 2, (rows, slots), generator=gen,
                        device=device, dtype=torch.int32)
    keep = torch.randint(0, 2, (rows, slots), generator=gen, device=device,
                         dtype=torch.int32).bool()
    if slots > 1:
        ids[:, 1] = ids[:, 0]
        keep[:, :2] = True
    if rows > 1:
        keep[0] = False
        ids[1] = n
    return ids, keep


@pytest.mark.parametrize("n", [1, 7, 4097, 8192, 8193, 45952, 45953, 45954,
                               45955, 300_000])
@pytest.mark.parametrize("rows,slots", [(1, 0), (1, 300), (7, 18),
                                        (1024, 290)])
def test_mask_kernel_equals_plain(card, n, rows, slots):
    """N at every residue mod 4 (rows start at every 16-byte offset), odd,
    small and past one bitmap chunk (300,000 columns: the block builds the
    row in chunks); B = 1, S = 0: the mask and the counts equal the plain
    version bit for bit, and the counts are the mask's row sums."""
    gen = torch.Generator(device=card).manual_seed(n * 31 + rows + slots)
    ids, keep = _mask_args(gen, rows, slots, n, card)
    ref, ref_counts = mb.build_batch_mask_counts_plain(ids, keep, n)
    before = mb.launches
    out, counts = mb.build_batch_mask_counts(ids, keep, n)
    assert mb.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and out.shape == (rows, n)
    assert counts.dtype == torch.float32 and counts.shape == (rows,)
    assert torch.equal(out, ref)
    assert torch.equal(counts, ref_counts)
    assert torch.equal(counts, out.sum(1))
    if rows > 1:
        assert not out[:2].any() and not counts[:2].any()


@pytest.mark.parametrize("n", [45953, 45954, 300_000])
@pytest.mark.parametrize("minors", ["1d", "2d"])
@pytest.mark.parametrize("rows,slots", [(1, 0), (7, 18), (1024, 212)])
def test_mask_kernel_two_groups_equal_plain(card, n, minors, rows, slots):
    """The window and the minors ([M] shared by every row, or [B, M]) read
    as two column groups, with a minor that is also a kept neighbor: mask
    and counts equal the plain version over the concatenated columns."""
    gen = torch.Generator(device=card).manual_seed(n + rows + slots)
    ids, keep = _mask_args(gen, rows, slots, n, card)
    m = 53
    shape = (m,) if minors == "1d" else (rows, m)
    mids = torch.randint(-1, n + 1, shape, generator=gen, device=card,
                         dtype=torch.int32)
    kmin = torch.randint(0, 2, (rows, m), generator=gen, device=card,
                         dtype=torch.int32).bool()
    if slots:
        # row 0's first kept window id, also a kept minor
        keep[0, 0] = True
        ids[0, 0] = 5
        mids[..., 0] = 5
        kmin[0, 0] = True
    ref, ref_counts = mb.build_batch_mask_counts_plain(ids, keep, n, mids,
                                                       kmin)
    out, counts = mb.build_batch_mask_counts(ids, keep, n, mids, kmin)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and torch.equal(counts, ref_counts)
    assert torch.equal(counts, out.sum(1))
    if slots:
        assert out[0, 5].item() == 1.0


def test_mask_wrapper_raises_and_makes_no_host_sync(card):
    ids = torch.tensor([[0, 3, 3, 9]], dtype=torch.int32, device=card)
    keep = torch.tensor([[True, True, False, True]], device=card)
    mids = torch.tensor([3, 0], dtype=torch.int32, device=card)
    kmin = torch.tensor([[True, True]], device=card)
    mb.build_batch_mask(ids, keep, 9)          # builds and loads first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = mb.build_batch_mask(ids, keep, 9)
        both, counts = mb.build_batch_mask_counts(ids, keep, 9, mids, kmin)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert out.cpu().tolist() == [[1, 0, 0, 1, 0, 0, 0, 0, 0]]
    assert both.cpu().tolist() == [[1, 0, 0, 1, 0, 0, 0, 0, 0]]
    assert counts.cpu().tolist() == [2.0]
    for args in [(ids[:, ::2], keep[:, ::2], 9),           # strided
                 (ids, keep.cpu(), 9),                      # two devices
                 (ids, keep, 2 ** 31)]:                     # N past int32
        with pytest.raises(ValueError):
            mb.build_batch_mask(*args)
    strided = torch.tensor([[3, 7, 0, 7]], dtype=torch.int32,
                           device=card)[:, ::2]
    with pytest.raises(ValueError):                         # strided minors
        mb.build_batch_mask_counts(ids, keep, 9, strided, kmin)
    with pytest.raises(TypeError):
        mb.build_batch_mask(ids.long(), keep, 9)
    assert mb.build_batch_mask(ids[:0], keep[:0], 9).shape == (0, 9)


def test_learned_model_on_card_equals_cpu(card):
    """The learned lane on the card selects, masks and aggregates as on the
    CPU; the forward with the dense neighbor table dropped (the CSR branch
    and the ragged gather) gives the same logits exactly."""
    host = synthetic_fraud_graph("small", seed=3)
    dev = host.to(card)
    gen = torch.Generator().manual_seed(0)
    model_h = PCGNN(host.feat_dim, 16, 3, 2.0, 0.5, learn_features=True,
                    features=host.features, generator=gen)
    model_d = PCGNN(host.feat_dim, 16, 3, 2.0, 0.5, learn_features=True,
                    features=host.features).to(card)
    model_d.load_state_dict(model_h.state_dict())
    rng = np.random.default_rng(1)
    batch = torch.from_numpy(rng.integers(0, host.num_nodes, 1000))
    labels = host.labels[batch]
    tp = torch.nonzero(host.labels == 1)[:, 0][:200]
    kw = dict(train_pos=tp, train_pos_valid=torch.ones(len(tp), dtype=bool))
    kw_d = {k: v.to(card) for k, v in kw.items()}
    loss_h = model_h.loss(host, batch, labels, **kw)
    loss_h.backward()
    mb.launches = wg.launches = 0
    loss_d = model_d.loss(dev, batch.to(card), labels.to(card), **kw_d)
    loss_d.backward()
    assert mb.launches == host.num_relations and wg.launches == 0
    torch.testing.assert_close(loss_d.cpu(), loss_h, rtol=1e-5, atol=1e-6)
    for (k, ph), (_, pd) in zip(model_h.named_parameters(),
                                model_d.named_parameters()):
        torch.testing.assert_close(pd.grad.cpu(), ph.grad, rtol=1e-4,
                                   atol=1e-6, msg=k)
    csr_graph = dataclasses.replace(dev, relations=tuple(
        dataclasses.replace(r, nbr2d=None) for r in dev.relations))
    with torch.no_grad():
        want = model_d(dev, batch.to(card), labels.to(card), train=True,
                       **kw_d)
        before = rg.launches
        got = model_d(csr_graph, batch.to(card), labels.to(card),
                      train=True, **kw_d)
    assert rg.launches - before == host.num_relations
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_learned_trainer_epoch_on_card(card, tmp_path):
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    cfg = dict(seed=2, data_name="synthetic:small", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=1,
               valid_epochs=1, batch_size=256, patience=10, exp_num=0,
               learn_features=True)
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)))
    assert t.device.type == "cuda" and t.graph.fused is None
    model = t.new_model()
    opt = t.new_optimizer(model)
    start = model.embed.detach().clone()
    mb.launches = wg.launches = 0
    loss = float(t.run_epoch(model, opt, 0))
    assert math.isfinite(loss)
    assert mb.launches == 3 * t.num_batches and wg.launches == 0
    assert not torch.equal(model.embed.detach(), start)


# -------------------------------- lanes without stores and the baselines

def _baseline_pair(card, name, dtype, preset="small"):
    from pcgnn_tpu_torch.models import build_model
    g = synthetic_fraud_graph(preset, seed=3)
    kw = dict(dtype=dtype, relations=False, homo=True, fused=False)
    host = csr.materialize_edge_windows(g, **kw)
    dev = csr.materialize_edge_windows(g.to(card), **kw)
    model_h = build_model(name, feat_dim=g.feat_dim, emb_dim=16,
                          generator=torch.Generator().manual_seed(0))
    model_d = build_model(name, feat_dim=g.feat_dim, emb_dim=16).to(card)
    model_d.load_state_dict(model_h.state_dict())
    return host, dev, model_h, model_d


@pytest.mark.parametrize("name", ["GCN", "SAGE"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_baseline_store_lane_on_card_equals_cpu(card, name, dtype):
    """The homo store's windows with the self column, fetched by the
    window-gather kernel, equal the CPU's exactly; the baseline's logits
    and loss agree to rtol 1e-5 with one kernel launch a forward."""
    from pcgnn_tpu_torch.ops import aggregate
    host, dev, model_h, model_d = _baseline_pair(card, name, dtype)
    assert dev.homo.ewin is not None
    batch = torch.from_numpy(np.random.default_rng(1).integers(
        0, host.num_nodes, 1000))
    xw_h, keep_h = aggregate.self_union_feature_window(host.homo, batch,
                                                       host.features)
    xw_d, keep_d = aggregate.self_union_feature_window(
        dev.homo, batch.to(card), dev.features)
    assert torch.equal(keep_d.cpu(), keep_h)
    assert torch.equal(xw_d.cpu()[keep_h], xw_h[keep_h])
    labels = host.labels[batch]
    wg.launches = 0
    out_d = model_d(dev, batch.to(card))[0]
    assert wg.launches == 1
    out_h = model_h(host, batch)[0]
    torch.testing.assert_close(out_d.cpu(), out_h, rtol=1e-5, atol=1e-6)
    loss_h = model_h.loss(host, batch, labels)
    loss_d = model_d.loss(dev, batch.to(card), labels.to(card))
    torch.testing.assert_close(loss_d.cpu(), loss_h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("include_self", [True, False])
def test_hub_mean_sum_on_card_equals_cpu(card, include_self):
    """skew-tiny's homo hub rows: one ragged-gather launch a chunk; counts
    equal and sums (float64, rounded once) agree with the CPU's."""
    g = synthetic_fraud_graph("skew-tiny", seed=3)
    rel, rel_d = g.homo, g.homo.to(card)
    assert rel.has_hubs
    hubs = torch.nonzero(rel.deg > rel.window_width)[:, 0]
    batch = torch.cat([hubs, hubs[:1], torch.arange(40)])
    is_hub = rel.deg[batch] > rel.window_width
    xp = torch.cat([g.features, g.features.new_zeros((1, g.feat_dim))])
    kw = dict(include_self=include_self, chunk=2, block=128)
    num_h, cnt_h = hub.hub_mean_sum(rel, batch, is_hub, xp, **kw)
    rg.launches = 0
    num_d, cnt_d = hub.hub_mean_sum(rel_d, batch.to(card), is_hub.to(card),
                                    xp.to(card), **kw)
    assert rg.launches == -(-int(is_hub.sum()) // 2)
    assert torch.equal(cnt_d.cpu(), cnt_h)
    torch.testing.assert_close(num_d.cpu(), num_h, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["GCN", "SAGE"])
def test_baseline_hub_model_on_card_equals_cpu(card, name):
    host, dev, model_h, model_d = _baseline_pair(card, name, torch.bfloat16,
                                                 "skew-tiny")
    rel = host.homo
    assert rel.has_hubs
    hubs = torch.nonzero(rel.deg > rel.window_width)[:, 0]
    batch = torch.cat([hubs, torch.arange(300)])
    wg.launches = rg.launches = 0
    out_d = model_d(dev, batch.to(card))[0]
    assert wg.launches == 1 and rg.launches >= 1
    torch.testing.assert_close(out_d.cpu(), model_h(host, batch)[0],
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("lane", ["table", "window_csr"])
def test_lanes_without_stores_on_card_equal_cpu(card, monkeypatch, lane):
    """skew-tiny without stores: the score-table lane (hub rows read the
    score column; no window gather), and score-from-window with every dense
    table dropped (each relation's windows through the ragged gather)."""
    from pcgnn_tpu_torch.models import pcgnn
    g = synthetic_fraud_graph("skew-tiny", seed=3)
    if lane == "window_csr":
        monkeypatch.setattr(pcgnn, "SCORE_FROM_WINDOW_MIN_NODES", 0)
        g = dataclasses.replace(g, relations=tuple(
            dataclasses.replace(r, nbr2d=None) for r in g.relations))
    dev = g.to(card)
    gen = torch.Generator().manual_seed(0)
    model_h = PCGNN(g.feat_dim, 16, 3, 2.0, 0.5, generator=gen)
    model_d = PCGNN(g.feat_dim, 16, 3, 2.0, 0.5).to(card)
    model_d.load_state_dict(model_h.state_dict())
    rel = g.relations[0]
    hubs = torch.nonzero(rel.deg > rel.window_width)[:, 0]
    batch = torch.cat([hubs, torch.from_numpy(
        np.random.default_rng(1).integers(0, g.num_nodes, 500))])
    labels = g.labels[batch].clone()
    labels[: len(hubs): 2] = 1
    tp = torch.nonzero(g.labels == 1)[:, 0][:200]
    kw = dict(train_pos=tp, train_pos_valid=torch.ones(len(tp), dtype=bool))
    out_h = model_h(g, batch, labels, train=True, **kw)
    wg.launches = rg.launches = 0
    out_d = model_d(dev, batch.to(card), labels.to(card), train=True,
                    **{k: v.to(card) for k, v in kw.items()})
    assert wg.launches == 0
    assert rg.launches >= (1 if lane == "table" else 1 + g.num_relations)
    for h, d in zip(out_h, out_d):
        torch.testing.assert_close(d.cpu(), h, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["GCN", "SAGE"])
def test_baseline_trainer_epoch_on_card(card, tmp_path, name):
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    cfg = dict(seed=2, data_name="synthetic:small", model=name,
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.005,
               weight_decay=0.0005, epochs=1, valid_epochs=1,
               batch_size=256, patience=10, exp_num=0)
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)))
    assert t.graph.homo.ewin.is_cuda
    model = t.new_model()
    opt = t.new_optimizer(model)
    wg.launches = 0
    loss = float(t.run_epoch(model, opt, 0))
    assert math.isfinite(loss)
    # one window gather a step: the wrapper launched it at the warm-up
    # step and recorded it at the capture; every other step replayed it
    r = t.runner(model, opt)
    assert r.eager_steps + r.replays == t.num_batches
    assert r.replay_launches["window_gather"] == 1
    assert wg.launches == r.eager_steps + r.captures


# ------------------------------------------------------ epoch plan repeats

def test_stress_epoch_plan_repeats(card, monkeypatch, tmp_path):
    """Stress-1m's shape, patched small: ``epoch_plan(0)`` built twice in
    one process is the same plan (run the file twice to compare two
    processes: the plan is seeded, so it must not move between them)."""
    from pcgnn_tpu_torch.data import synthetic
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    monkeypatch.setitem(synthetic.PRESETS, "stress-1m",
                        (4096, 16, 0.05, (16384, 8192, 4096), 3))
    cfg = dict(seed=2, data_name="synthetic:stress-1m", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=1,
               valid_epochs=1, batch_size=256, patience=10, exp_num=0)
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)))
    first, second = t.epoch_plan(0), t.epoch_plan(0)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_pick_repeats_at_stress_size(card):
    """The pick at stress-1m's real size (400,000 training nodes, 40,000
    draws) from one seed gives the same draws every time."""
    from pcgnn_tpu_torch.sampling.pick import pick_cdf, pick_probs, pick_step
    rng = np.random.default_rng(0)
    t = 400_000
    deg = torch.from_numpy(rng.integers(1, 60, t)).to(card)
    y = torch.from_numpy((rng.random(t) < 0.05).astype(np.int64)).to(card)
    idx = torch.arange(t, device=card)
    weights = pick_probs(deg, y)
    draws = []
    for _ in range(20):
        g = torch.Generator(device=card).manual_seed(7)
        draws.append(pick_step(g, idx, pick_cdf(weights), 40_000))
    assert all(torch.equal(d, draws[0]) for d in draws)


# --------------------------------------------------- resume and profile_dir

def _small_cfg(**kw):
    cfg = dict(seed=2, data_name="synthetic:small", model="PCGNN",
               train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
               weight_decay=0.001, alpha=2.0, rho=0.5, epochs=4,
               valid_epochs=1, batch_size=256, patience=10, exp_num=0)
    cfg.update(kw)
    return cfg


def test_adam_state_round_trip_on_card(card):
    """The restored Adam state sits where torch's Adam keeps its own on
    the card (moments on the parameter's device, ``step`` as torch makes
    it), equal, and the next step is the same."""
    from pcgnn_tpu_torch.train.trainer import (adam_state, load_adam_state,
                                               make_optimizer)
    gen = torch.Generator(device=card).manual_seed(0)
    model = torch.nn.Linear(16, 4).to(card)
    x = torch.randn(64, 16, generator=gen, device=card)
    opt = make_optimizer(model, 0.01, 0.001)

    def step(m, o):
        o.zero_grad()
        m(x).square().sum().backward()
        o.step()

    step(model, opt)
    twin = torch.nn.Linear(16, 4).to(card)
    twin.load_state_dict(model.state_dict())
    opt2 = make_optimizer(twin, 0.01, 0.001)
    load_adam_state(twin, opt2, adam_state(model, opt))
    for p, q in zip(model.parameters(), twin.parameters()):
        for k, v in opt.state[p].items():
            w = opt2.state[q][k]
            assert (w.dtype, w.device) == (v.dtype, v.device), k
            assert torch.equal(w, v), k
    step(model, opt)
    step(twin, opt2)
    for p, q in zip(model.parameters(), twin.parameters()):
        torch.testing.assert_close(q, p, rtol=0, atol=1e-6)


def test_resume_on_card(card, tmp_path, monkeypatch):
    """A 4-epoch run cut after 2 and resumed replays the uncut run's epoch
    plans exactly, and ends within atol 1e-3 of its parameters (the
    card's step against the CPU's, phase 6 of chip_smoke.py)."""
    from pcgnn_tpu_torch.train.checkpoint import load_checkpoint
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    plans = []
    plan = Trainer.epoch_plan

    def recorded(self, epoch):
        out = plan(self, epoch)
        plans[-1][epoch] = [x.cpu() for x in out]
        return out

    monkeypatch.setattr(Trainer, "epoch_plan", recorded)
    cfg = _small_cfg(resume=True)
    finals = []
    for tag, cut in (("uncut", None), ("cut", 2)):
        root = str(tmp_path / tag)
        if cut:
            plans.append({})
            Trainer(dict(cfg, epochs=cut),
                    result=ResultManager(cfg, root=root)).train()
        plans.append({})
        t = Trainer(cfg, result=ResultManager(cfg, root=root))
        assert t.device.type == "cuda"
        t.train()
        finals.append(load_checkpoint(t._resume_path()))
    uncut, _, resumed = plans
    assert sorted(resumed) == [2, 3]
    for e in (2, 3):
        for a, b in zip(uncut[e], resumed[e]):
            assert torch.equal(a, b)
    assert finals[0]["epoch"] == finals[1]["epoch"] == 3
    a, b = finals[0]["params"], finals[1]["params"]
    for k in ("label_clf", "inter", "head"):
        for leaf in a[k]:
            np.testing.assert_allclose(b[k][leaf], a[k][leaf], rtol=0,
                                       atol=1e-3, err_msg=k)


def test_profile_dir_on_card_traces_the_window_gather(card, tmp_path):
    """A 5-epoch run with ``profile_dir`` writes a trace of epochs 2-4
    whose kernels hold a window gather on every traced step."""
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    from pcgnn_tpu_torch.utils.profiling import trace_kernels
    cfg = _small_cfg(epochs=5, profile_dir=str(tmp_path / "prof"))
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path / "r")))
    t.train()
    (path,) = (tmp_path / "prof").glob("trace-*.json")
    kernels = trace_kernels(str(path))
    gathers = sum(n for k, n in kernels.items() if "window_gather_kernel" in k)
    assert gathers >= 3 * t.num_batches, kernels.most_common(10)


# --------------------------------------------------------- full-graph ops

def _full_graph_calls(rel, x, s0, w0, b0, keep):
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import sddmm
    return {
        "spmm_window": lambda: agg.segment_mean_spmm(rel, x),
        "spmm_ewin": lambda: agg.segment_mean_spmm(
            rel, x, assume_ewin_features=True),
        "spmm_segment": lambda: agg.segment_mean_spmm(rel, x, keep),
        "sddmm_window": lambda: sddmm.edge_abs_diff_window(rel, s0),
        "sddmm_ewin": lambda: sddmm.edge_abs_diff_window_ewin(rel, s0, w0,
                                                              b0),
        "sddmm_flat": lambda: sddmm.edge_abs_diff(rel, s0),
        "edge_ranks": lambda: sddmm.edge_ranks_global(
            rel, sddmm.edge_abs_diff(rel, s0))}


def _full_graph_inputs(g, rel, device, keep_rate):
    from pcgnn_tpu_torch.ops.aggregate import selection_score
    gen = torch.Generator().manual_seed(1)
    w0 = torch.randn(g.feat_dim, generator=gen) / 4
    b0 = torch.tensor(0.25)
    x = g.features.to(rel.ewin.dtype).float()
    keep = torch.rand(rel.e_pad, generator=gen) < keep_rate
    return [t.to(device) for t in (x, selection_score(x, w0, b0), w0, b0,
                                   keep)]


@pytest.mark.parametrize("keep_rate", [1.0, 0.6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_full_graph_ops_on_card_equal_cpu(card, dtype, keep_rate):
    """Each full-graph call on the card against the same call on the CPU
    (``small``, every relation with a store): the means to rtol 1e-5 /
    atol 1e-6 (float32 sums in another order), the window and flat
    distances and the ranks exactly, the edge-window distances to atol
    1e-5 (float64 scores rounded once); and on the card the edge-window
    mean equals the window mean on the store's table exactly."""
    g = synthetic_fraud_graph("small", seed=3)
    for rel in g.relations:
        rel = csr.attach_edge_windows(rel, g.features, dtype=dtype)
        host_in = _full_graph_inputs(g, rel, "cpu", keep_rate)
        host = {k: f() for k, f in _full_graph_calls(rel, *host_in).items()}
        dev_in = [t.to(card) for t in host_in]
        dev = {k: f() for k, f in
               _full_graph_calls(rel.to(card), *dev_in).items()}
        assert torch.equal(dev["spmm_ewin"], dev["spmm_window"])
        for k, want in host.items():
            got = dev[k]
            if k.startswith("spmm"):
                torch.testing.assert_close(got.cpu(), want, rtol=1e-5,
                                           atol=1e-6)
            elif k == "sddmm_ewin":
                (d, v), (dw, vw) = [t.cpu() for t in got], want
                assert torch.equal(v, vw)
                torch.testing.assert_close(d[v], dw[v], rtol=0, atol=1e-5)
                assert torch.isinf(d[~v]).all()
            else:
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                for a, b in zip(got, want):
                    assert torch.equal(a.cpu(), b), k


def test_edge_window_lowerings_launch_the_window_gather(card, monkeypatch):
    """The edge-window mean and scoring launch the window gather once per
    node chunk (100 nodes: 41 chunks of ``small``), the other forms
    never."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    from pcgnn_tpu_torch.ops import sddmm
    monkeypatch.setattr(agg, "SPMM_NODE_CHUNK", 100)
    monkeypatch.setattr(sddmm, "SDDMM_NODE_CHUNK", 100)
    g = synthetic_fraud_graph("small", seed=3)
    rel = csr.attach_edge_windows(g.relations[1], g.features,
                                  dtype=torch.bfloat16).to(card)
    calls = _full_graph_calls(rel, *_full_graph_inputs(g, rel, card, 1.0))
    for k, f in calls.items():
        before = wg.launches
        f()
        torch.cuda.synchronize()
        want = -(-g.num_nodes // 100) if "ewin" in k else 0
        assert wg.launches - before == want, k


def test_segment_form_repeats_on_card(card):
    """The segment form (``torch.segment_reduce`` over each row's run, no
    atomics) gives the same bits on every call, on a relation with hub
    rows."""
    from pcgnn_tpu_torch.ops import aggregate as agg
    g = synthetic_fraud_graph("skew-tiny", seed=1).to(card)
    rel = g.relations[0]
    assert rel.has_hubs
    first = agg.segment_mean_spmm(rel, g.features)
    for _ in range(5):
        assert torch.equal(agg.segment_mean_spmm(rel, g.features), first)


def test_measure_anchors(card):
    """``utils.roofline.measure`` on two calls whose share of the card's
    peak is known to be high: a 1 GB copy (1 GB read, 1 GB written) and an
    8192^3 bf16 product (2 * 8192^3 operations); each reads a share in
    (0.3, 1.05] and names the card."""
    from pcgnn_tpu_torch.utils.roofline import measure
    src = torch.empty(1 << 28, device=card)
    dst = torch.empty_like(src)
    r = measure(dst.copy_, src, analytic_bytes=2 * src.numel() * 4)
    assert 0.3 < r["sol_frac"] <= 1.05, r
    assert r["device"] == torch.cuda.get_device_name(card)
    a = torch.randn(8192, 8192, device=card, dtype=torch.bfloat16)
    r = measure(torch.matmul, a, a, analytic_flops=2 * 8192 ** 3)
    assert 0.3 < r["mfu"] <= 1.05, r


def test_kernel_ms_reads_a_copy_near_its_time(card):
    """``utils.roofline.kernel_ms`` of a 1 GB copy: sorted readings, the
    median at most 1.05 of the bytes' share of the peak and within a factor
    of 2 of the back-to-back CUDA-event time (a call long against its host
    overhead)."""
    from pcgnn_tpu_torch.utils.roofline import (KERNEL_READINGS, chip_peaks,
                                                kernel_ms, timed_ms)
    src = torch.empty(1 << 28, device=card)
    dst = torch.empty_like(src)
    readings = kernel_ms(dst.copy_, [(src,)])
    run_ms = timed_ms(lambda: dst.copy_(src))
    rate, _ = chip_peaks(card)
    assert readings == sorted(readings) and len(readings) == KERNEL_READINGS
    dev_ms = readings[len(readings) // 2]
    assert 2 * src.numel() * 4 / rate * 1e3 <= dev_ms * 1.05
    assert run_ms / 2 < dev_ms < run_ms * 2


def test_kernel_ms_includes_the_write_back(card):
    """A 28.8 MB fill, whose output fits the 50 MB L2, written to fresh
    memory each call: ``kernel_ms`` reads no call under the time its bytes
    take to reach memory (by more than 1.05)."""
    from pcgnn_tpu_torch.utils.roofline import chip_peaks, kernel_ms
    n = 1024 * 7040
    readings = kernel_ms(lambda: torch.zeros(n, dtype=torch.int32,
                                             device=card), [()])
    rate, _ = chip_peaks(card)
    assert n * 4 / rate * 1e3 <= readings[0] * 1.05, readings


def test_single_step_on_card(card, tmp_path):
    """``Trainer.single_step`` on the card: its loss equals the same steps
    taken one by one (the card's step repeats bit for bit), and
    ``measure`` times it below the step's streaming bound share of 1."""
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    from pcgnn_tpu_torch.utils.roofline import (measure,
                                                pcgnn_step_streaming_bytes)
    cfg = _small_cfg()
    t = Trainer(cfg, result=ResultManager(cfg, root=str(tmp_path)))
    rng = np.random.default_rng(0)
    batch = rng.choice(t.idx_train, t.batch_size)
    y = t.graph.labels.cpu().numpy()[batch]
    w = np.ones(t.batch_size, np.float32)
    m1, m2 = t.new_model(), t.new_model()
    fn, args = t.single_step(m1, t.new_optimizer(m1), batch, y, w, nscan=3)
    loss = fn(*args)
    o2 = t.new_optimizer(m2)
    b, yy, ww = args[2:]
    for i in range(3):
        want = t.step(m2, o2, torch.roll(b, i), torch.roll(yy, i),
                      torch.roll(ww, i))
    assert torch.equal(loss, want)
    m_max = m1.minor_window(int(t.train_pos_dev.shape[0]), t.graph.relations)
    nbytes = pcgnn_step_streaming_bytes(t.graph, t.batch_size, m_max,
                                        cfg["emb_size"])
    r = measure(fn, *args, analytic_bytes=3 * nbytes)
    assert 0 < r["sol_frac"] < 1 and r["wall_ms"] > 0


# ------------------------------------------------- sharded step (module 13)

def _rank_mesh(dd, dg, g):
    from pcgnn_tpu_torch.parallel.mesh import RankMesh
    return RankMesh(shape={"dcn": 1, "data": dd, "graph": dg}, rank=g,
                    host=0, data_index=0, graph_index=g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_masked_fetch_zeroes_skipped_rows(card, dtype):
    """The sharded store lane's fetch (kernel 1c): rows the rank does not
    own are not copied, and are 0 when the fetch returns, whatever the
    memory held before (it is filled with NaN and freed first); owned rows
    equal the plain version exactly."""
    from pcgnn_tpu_torch.parallel import spmd
    g = synthetic_fraud_graph("small", seed=1)
    dg = 2
    block = g.num_nodes // dg
    gen = torch.Generator().manual_seed(0)
    batch = torch.randint(0, g.num_nodes, (1024,), generator=gen).to(card)
    for gi in range(dg):
        sh = spmd.shard_relation(g.relations[2], _rank_mesh(1, dg, gi),
                                 g.num_nodes, g.features, ewin_dtype=dtype,
                                 device=card)
        local = batch - gi * block
        mine = (local >= 0) & (local < block)
        starts = sh.estart[local.clamp(0, block - 1)]
        junk = torch.full((1024, sh.ewin_dp), float("nan"), device=card)
        del junk
        before = (wg.launches, wg.masked_launches)
        got = spmd.sharded_feature_window(sh, starts, mine)
        torch.cuda.synchronize()
        assert (wg.launches, wg.masked_launches) == (before[0] + 1,
                                                     before[1] + 1)
        assert bool((got[~mine] == 0).all())
        want = wg.window_gather_plain(sh.ewin, starts, sh.ewin_dp,
                                      out_dtype=torch.float32)
        want = want[:, : got.shape[1] * got.shape[2]].view_as(got)
        assert torch.equal(got[mine], want[mine])


_GLOO_CARD_WORKER = r'''
import sys
import numpy as np
import torch
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.parallel import spmd
from pcgnn_tpu_torch.parallel.distributed import init_distributed
from pcgnn_tpu_torch.parallel.mesh import make_mesh
torch.cuda.set_device(0)
init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
mesh = make_mesh(data=1, graph=2)
g = synthetic_fraud_graph("skew-tiny", seed=4)
model = build_model("PCGNN", feat_dim=g.feat_dim, emb_dim=16,
                    num_relations=3, alpha=2.0, rho=0.5,
                    generator=torch.Generator().manual_seed(0)).cuda()
sg = spmd.shard_graph(g, mesh, ewin_dtype=torch.bfloat16, device="cuda:0")
tp = torch.nonzero(g.labels == 1)[:48, 0].cuda()
tpv = torch.ones(len(tp), dtype=torch.bool, device="cuda")
batch = torch.arange(64, device="cuda")
y = g.labels.cuda()[batch]
w = torch.ones(64, device="cuda")
res = {}
for fused in (True, False):
    model.zero_grad()
    loss, local = spmd.spmd_loss(model, sg, batch, y, w, tp, tpv,
                                 fused=fused)
    local.backward()
    res[f"loss{int(fused)}"] = np.float32(loss.item())
    for n, p in model.named_parameters():
        res[f"{int(fused)}.{n}"] = p.grad.cpu().numpy()
res["masked"] = np.int64(__import__(
    "pcgnn_tpu_torch.ops.window_gather",
    fromlist=["x"]).masked_launches)
np.savez(out, **res)
torch.distributed.destroy_process_group()
'''


def test_two_gloo_ranks_on_one_card_equal_the_single_rank_step(card,
                                                                tmp_path):
    """Two gloo ranks sharing the card at (data 1, graph 2), on the hub
    graph with bf16 stores: the sharded loss and gradients, fused and
    per-relation store lanes, equal the single-device step's; the store
    lane launched the masked fetch."""
    from pcgnn_tpu_torch.models import build_model
    from pcgnn_tpu_torch.ops import kernels
    from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                                 run_workers, worker_env)
    kernels.build()
    worker = tmp_path / "worker.py"
    worker.write_text(_GLOO_CARD_WORKER)
    outs = [tmp_path / f"r{r}.npz" for r in range(2)]
    gang_with_fresh_port(lambda port: run_workers(
        str(worker), [(r, port, outs[r]) for r in range(2)],
        env=worker_env(), timeout=300))
    g = synthetic_fraud_graph("skew-tiny", seed=4, device=card)
    model = build_model("PCGNN", feat_dim=g.feat_dim, emb_dim=16,
                        num_relations=3, alpha=2.0, rho=0.5,
                        generator=torch.Generator().manual_seed(0)).to(card)
    tp = torch.nonzero(g.labels == 1)[:48, 0]
    tpv = torch.ones(len(tp), dtype=torch.bool, device=card)
    batch = torch.arange(64, device=card)
    for fused in (True, False):
        gs = csr.materialize_edge_windows(g, dtype=torch.bfloat16,
                                          fused=fused)
        model.zero_grad()
        loss = model.loss(gs, batch, g.labels[batch],
                          torch.ones(64, device=card), train_pos=tp,
                          train_pos_valid=tpv)
        loss.backward()
        for out in outs:
            res = np.load(out)
            np.testing.assert_allclose(res[f"loss{int(fused)}"], loss.item(),
                                       rtol=1e-5)
            for n, p in model.named_parameters():
                np.testing.assert_allclose(res[f"{int(fused)}.{n}"],
                                           p.grad.cpu().numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=n)
    assert all(int(np.load(o)["masked"]) == 3 for o in outs)


def test_one_rank_nccl_group(card, tmp_path, monkeypatch):
    """A 1-rank NCCL group initializes and all-reduces; its (1, 1) mesh
    elides every collective and steps exactly as the single device."""
    import torch.distributed as dist

    from pcgnn_tpu_torch.parallel.distributed import init_distributed
    from pcgnn_tpu_torch.train.trainer import Trainer
    from pcgnn_tpu_torch.utils.multiproc import free_port
    monkeypatch.chdir(tmp_path)
    torch.cuda.set_device(0)
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        t = torch.full((8,), 3.0, device=card)
        dist.all_reduce(t)
        assert t.tolist() == [3.0] * 8
        cfg = dict(seed=2, data_name="synthetic:skew-tiny", model="PCGNN",
                   train_ratio=0.4, test_ratio=0.67, emb_size=16, lr=0.01,
                   weight_decay=0.001, alpha=2.0, rho=0.5, epochs=1,
                   valid_epochs=1, batch_size=128, patience=10, exp_num=0)
        single = Trainer(cfg, device=card)
        rank = Trainer(dict(cfg, distributed=True), device="cuda:0",
                       graph=single.graph)
        assert rank.mesh.backend == "nccl" and rank.mesh.size == 1
        got = []
        for tr in (single, rank):
            model = tr.new_model()
            opt = tr.new_optimizer(model)
            batches, weights = tr.epoch_plan(0)
            loss = tr.step(model, opt, batches[0], tr.labels[batches[0]],
                           weights[0])
            got.append((loss, list(model.parameters())))
        assert torch.equal(got[0][0], got[1][0])
        assert all(torch.equal(a, b) for a, b in zip(got[0][1], got[1][1]))
    finally:
        dist.destroy_process_group()


_OVERLAP_CARD_WORKER = r'''
import dataclasses, sys
import numpy as np
import torch
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.models import build_model
from pcgnn_tpu_torch.ops import ragged_gather as rg
from pcgnn_tpu_torch.ops import window_gather as wg
from pcgnn_tpu_torch.parallel import spmd
from pcgnn_tpu_torch.parallel.distributed import init_distributed
from pcgnn_tpu_torch.parallel.mesh import make_mesh
torch.cuda.set_device(0)
init_distributed(f"localhost:{port}", 2, rank, backend="gloo")
mesh = make_mesh(data=1, graph=2)
g = synthetic_fraud_graph("skew-tiny", seed=4)
tp = torch.nonzero(g.labels == 1)[:48, 0].cuda()
tpv = torch.ones(len(tp), dtype=torch.bool, device="cuda")
# relation 0's hub rows first: the hub lane (kernel 2) runs
rel0 = g.relations[0]
batch = torch.arange(64)
hubs = torch.nonzero(rel0.deg > rel0.window_width)[:4, 0]
batch[:len(hubs)] = hubs
batch = batch.cuda()
y = g.labels.cuda()[batch]
w = torch.ones(64, device="cuda")
res = {"default": np.int64(mesh.overlap), "hubs": np.int64(len(hubs))}
for name, ew, fused, model_name in (("fused", True, True, "PCGNN"),
                                    ("store", True, False, "PCGNN"),
                                    ("plain", False, False, "PCGNN"),
                                    ("gcn", True, False, "GCN")):
    pcgnn = model_name == "PCGNN"
    kw = dict(num_relations=3, alpha=2.0, rho=0.5) if pcgnn else {}
    model = build_model(model_name, feat_dim=g.feat_dim, emb_dim=16,
                        generator=torch.Generator().manual_seed(0),
                        **kw).cuda()
    sg = spmd.shard_graph(g, mesh, pcgnn=pcgnn, edge_windows=ew,
                          ewin_dtype=torch.bfloat16, fused=fused,
                          device="cuda:0")
    # the mesh built (overlap on) and its blocking copy
    schedules = {1: sg, 0: dataclasses.replace(
        sg, mesh=dataclasses.replace(mesh, overlap=False))}
    for mode, sgm in schedules.items():
        model.zero_grad(set_to_none=True)
        mesh.stats.reset()
        before = (wg.launches, rg.launches)
        if pcgnn:
            loss, local = spmd.spmd_loss(model, sgm, batch, y, w, tp, tpv,
                                         fused=fused)
        else:
            loss, local = spmd.spmd_homo_loss(model, sgm, batch, y, w)
        local.backward()
        res[f"{name}.{mode}.async"] = np.int64(
            mesh.stats.async_calls["graph"])
        res[f"{name}.{mode}.launches"] = np.array(
            [wg.launches - before[0], rg.launches - before[1]])
        res[f"{name}.{mode}.loss"] = np.float32(loss.item())
        for n, p in model.named_parameters():
            res[f"{name}.{mode}.{n}"] = p.grad.cpu().numpy()
np.savez(out, **res)
torch.distributed.destroy_process_group()
'''


def test_overlap_on_and_off_are_bit_equal_on_card(card, tmp_path):
    """Two gloo ranks sharing the card at (data 1, graph 2), on the hub
    graph with bf16 stores and hub rows in the batch: the sharded loss and
    gradients with the collectives async (the default) and blocking are
    the same bits, in the fused, store, plain and GCN lanes, and both
    schedules launch the same kernels."""
    from pcgnn_tpu_torch.ops import kernels
    from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                                 run_workers, worker_env)
    kernels.build()
    worker = tmp_path / "worker.py"
    worker.write_text(_OVERLAP_CARD_WORKER)
    outs = [tmp_path / f"r{r}.npz" for r in range(2)]
    gang_with_fresh_port(lambda port: run_workers(
        str(worker), [(r, port, outs[r]) for r in range(2)],
        env=worker_env(), timeout=300))
    for out in outs:
        res = np.load(out)
        assert int(res["default"]) == 1
        for name in ("fused", "store", "plain", "gcn"):
            assert int(res[f"{name}.1.async"]) > 0
            assert int(res[f"{name}.0.async"]) == 0
            np.testing.assert_array_equal(res[f"{name}.1.launches"],
                                          res[f"{name}.0.launches"])
            keys = [k[len(name) + 3:] for k in res.files
                    if k.startswith(f"{name}.1.")]
            # the loss and every gradient
            keys = [k for k in keys if k not in ("async", "launches")]
            assert "loss" in keys and len(keys) > 1
            for k in keys:
                np.testing.assert_array_equal(res[f"{name}.1.{k}"],
                                              res[f"{name}.0.{k}"],
                                              err_msg=f"{name} {k}")
        assert int(res["hubs"]) > 0
        assert res["fused.1.launches"][0] >= 1      # kernel 1 (fused fetch)
        assert res["fused.1.launches"][1] >= 1      # kernel 2 (hub lane)


def test_graft_entry_on_card_equals_cpu(card):
    """``graft_entry.entry()`` on the card: the fused record fetch (kernel
    1) launched, logits and center scores within rtol 1e-5 of the same
    forward on the CPU (the same weights: seeded on the host)."""
    from pcgnn_tpu_torch import graft_entry
    fn, args = graft_entry.entry()
    before = wg.launches
    logits, center = fn(*args)
    torch.cuda.synchronize()
    assert wg.launches > before
    assert logits.device.type == "cuda" and logits.shape == (64, 2)
    fn_c, args_c = graft_entry.entry(device="cpu")
    logits_c, center_c = fn_c(*args_c)
    np.testing.assert_allclose(logits.detach().cpu().numpy(),
                               logits_c.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(center.detach().cpu().numpy(),
                               center_c.detach().numpy(), rtol=1e-5,
                               atol=1e-6)


# ------------------------------------------------- gather-kernel probes

def _probe_flat(card, length, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    return torch.randint(-2 ** 30, 2 ** 30, (length,), generator=gen,
                         dtype=torch.int32, device=card)


def _probe_starts(card, b, length, dp, seed):
    """B starts in [0, L - dp]: the first min(B, 1024) at every value mod
    1024 (so every mod 4 class), the rest random."""
    gen = torch.Generator(device=card).manual_seed(seed)
    blocks = (length - dp) // 1024
    k = min(b, 1024)
    res = torch.randperm(1024, generator=gen, device=card)[:k]
    extra = torch.randint(0, 1024, (b - k,), generator=gen, device=card)
    base = torch.randint(0, blocks, (b,), generator=gen, device=card) * 1024
    return (base + torch.cat([res, extra])).to(torch.int32)


PROBE_DPS = [128, 132, 2048, 7040]


@pytest.mark.parametrize("rows,slots", [(8, 4), (16, 8), (32, 8), (32, 16),
                                        (64, 16), (1, 1), (3, 2)])
@pytest.mark.parametrize("dp", PROBE_DPS)
@pytest.mark.parametrize("b", [1, 37, 1027])
def test_shift_probe_equals_plain(card, rows, slots, dp, b):
    """P-s at every (rows, slots) of the probe's sweep (slots capped at 8
    for dp = 7,040), every start mod 1024, B not a multiple of rows."""
    length = 1 << 22
    flat = _probe_flat(card, length, dp + b)
    starts = _probe_starts(card, b, length, dp, rows * slots + b)
    before = gp.shift_launches
    out = gp.shift_gather(flat, starts, dp, rows, slots)
    assert gp.shift_launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, gp.shift_gather_plain(flat, starts, dp))


@pytest.mark.parametrize("rows", [1, 2, 8, 16, 32, 64])
@pytest.mark.parametrize("dp", PROBE_DPS)
@pytest.mark.parametrize("b", [1, 37, 1027])
def test_aligned_probe_equals_plain(card, rows, dp, b):
    length = 1 << 22
    flat = _probe_flat(card, length, dp + b + 1)
    starts = _probe_starts(card, b, length, dp, rows + b)
    before = gp.aligned_launches
    out = gp.aligned_gather(flat, starts, dp, rows)
    assert gp.aligned_launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(out, gp.aligned_gather_plain(flat, starts, dp))


@pytest.mark.parametrize("length", [16384, 16388 + 128])
def test_probes_clamp_starts_past_the_end(card, length):
    """Starts past L - dp and negative ones are clamped into [0, L - dp]
    (no read past flat; P-s's cover is cut at its end), as on the CPU."""
    dp = 128
    flat = _probe_flat(card, length, length)
    s = length - dp
    starts = torch.tensor([s, s - 1, s - 2, s - 3, s + 1, length, 10 ** 9,
                           -1, -5000, 0, 3], dtype=torch.int32, device=card)
    for got, want in (
            (gp.shift_gather(flat, starts, dp, 8, 4),
             gp.shift_gather_plain(flat, starts, dp)),
            (gp.aligned_gather(flat, starts, dp, 8),
             gp.aligned_gather_plain(flat, starts, dp))):
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert torch.equal(gp.shift_gather(flat, starts[:1], dp, 8, 4)[0],
                       flat[-dp:])


def test_probes_refuse_on_card(card):
    """A row too wide for 2 slots is refused with the limit named, and a
    misaligned flat, before any launch; B = 0 launches nothing."""
    flat = _probe_flat(card, 1 << 16, 5)
    starts = torch.zeros(4, dtype=torch.int32, device=card)
    before = (gp.aligned_launches, gp.shift_launches)
    with pytest.raises(ValueError, match="232448 bytes of shared"):
        gp.aligned_gather(flat, starts, 29044)
    with pytest.raises(ValueError, match="232448 bytes of shared"):
        gp.shift_gather(flat, starts, 29040, 8, 4)
    with pytest.raises(ValueError, match="16-byte"):
        gp.shift_gather(flat[1:(1 << 16) - 3], starts, 128, 8, 4)
    empty = torch.zeros(0, dtype=torch.int32, device=card)
    assert gp.aligned_gather(flat, empty, 128).shape == (0, 128)
    assert (gp.aligned_launches, gp.shift_launches) == before
    # the widest rows that 2 slots fit run and are exact
    for fn, dp in ((lambda d: gp.aligned_gather(flat, starts, d, 8), 29040),
                   (lambda d: gp.shift_gather(flat, starts + 3, d, 8, 4),
                    29036)):
        out = fn(dp)
        torch.cuda.synchronize()
        off = 0 if dp == 29040 else 3
        assert torch.equal(out, flat[off:off + dp].expand(4, dp))


# ------------------------------------------------ the bench and scaling

def _bench_py_keys() -> list:
    """The keys of ``bench.py``'s JSON line, read from its source."""
    import ast
    from pathlib import Path
    tree = ast.parse((Path(__file__).resolve().parents[1] / "bench.py")
                     .read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", None) == "dumps")
    return [k.value for k in call.args[0].keys]


def test_bench_line_on_card(card, tmp_path):
    """The bench on the card: bench.py's 13 keys, a positive rate, a
    bandwidth share the roofline accepts, the card's name, and
    ``vs_baseline`` 1.0 without a baseline file."""
    from pcgnn_tpu_torch import bench
    line = bench.run(preset="small", batch_size=256, epochs=2,
                     baseline=str(tmp_path / "absent.json"))
    assert list(line) == _bench_py_keys()
    assert line["value"] > 0 and 0 < line["hbm_bw_util"] <= 1.05
    assert line["device"] == torch.cuda.get_device_name(0)
    assert line["vs_baseline"] == 1.0 and line["preset"] == "small"


@pytest.mark.parametrize("device,meshes,backends", [
    ("cuda", [(1, 1)], ["nccl"]),
    ("cuda:0", [(1, 1), (1, 2), (2, 1)], ["nccl", "gloo", "gloo"])])
def test_spmd_scaling_on_card(card, device, meshes, backends):
    """spmd_scaling on the card: (1, 1) over NCCL, more ranks sharing
    cuda:0 over gloo; every warm loss within rtol 1e-5 of the (1, 1) loss
    on its batch, and the (1, 2) mesh's rank 0 launches kernel 1c."""
    from pcgnn_tpu_torch.benchmarks import spmd_scaling
    out = spmd_scaling.run(preset="tiny", batch_per_data=32, steps=2,
                           device=device, meshes=meshes, timeout=300)
    recs = out["records"]
    assert [r["backend"] for r in recs] == backends
    for r in recs:
        assert math.isclose(r["warm_loss"], r["ref_loss"], rel_tol=1e-5)
        assert r["launches"]["window_gather"] > 0
    for r, (dd, dg) in zip(recs, meshes):
        assert (r["launches"]["window_gather_masked"] > 0) == (dg > 1)


# --------------------------------------------- the captured training step

_LANES = {
    # lane: (preset, config changes, patches of (module name, attribute,
    # value)), the single-device lanes of the port
    "fused": ("small", {}, ()),
    "relation": ("small", {"fused": False}, ()),
    "score_table": ("small", {"edge_windows": False}, ()),
    "plain": ("small", {"edge_windows": False},
              (("pcgnn", "SCORE_FROM_WINDOW_MIN_NODES", 0),)),
    "hub": ("skew-tiny", {}, ()),
    "hub_no_stores": ("skew-tiny", {"edge_windows": False}, ()),
    "learned": ("small", {"learn_features": True}, ()),
    "csr": ("small", {"edge_windows": False},
            (("csr", "NBR2D_BUDGET_BYTES", 8), ("csr", "FPAD_BUDGET_BYTES", 0),
             ("pcgnn", "SCORE_FROM_WINDOW_MIN_NODES", 0))),
    "gcn": ("small", {"model": "GCN"}, ()),
    "gcn_hub": ("skew-tiny", {"model": "GCN"}, ()),
    "sage": ("small", {"model": "SAGE", "num_sample": 5}, ()),
}


def _lane_trainer(tmp_path, monkeypatch, lane, **kw):
    """A trainer of ``lane`` on the card, with 6 steps an epoch."""
    from pcgnn_tpu_torch.models import pcgnn as pcgnn_mod
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    preset, changes, patches = _LANES[lane]
    for mod, name, value in patches:
        monkeypatch.setattr({"csr": csr, "pcgnn": pcgnn_mod}[mod], name,
                            value)
    changes = dict(changes)
    fused = changes.pop("fused", True)
    cfg = _small_cfg(data_name=f"synthetic:{preset}", epochs=2,
                     valid_epochs=10 ** 9, **changes)
    graph = None
    if not fused:
        graph = csr.materialize_edge_windows(
            synthetic_fraud_graph(preset, seed=cfg["seed"]), fused=False)
    t = Trainer(cfg, graph=graph,
                result=ResultManager(cfg, root=str(tmp_path / lane)), **kw)
    t.batch_size = -(-t.sample_size // 6)
    t.num_batches = -(-t.sample_size // t.batch_size)
    return t


def _run(t, capture: bool, epochs=2):
    """Two epochs of a fresh model through ``run_epoch``: (model,
    optimizer, epoch losses)."""
    t.capture = capture
    model = t.new_model()
    opt = t.new_optimizer(model)
    losses = [t.run_epoch(model, opt, e) for e in range(epochs)]
    torch.cuda.synchronize()
    return model, opt, torch.stack(losses)


def _assert_same_run(a, b):
    (ma, oa, la), (mb, ob, lb) = a, b
    assert torch.equal(la, lb), (la, lb)
    for (name, p), q in zip(ma.named_parameters(), mb.parameters()):
        assert torch.equal(p, q), name
        for k, v in oa.state[p].items():
            assert torch.equal(v, ob.state[q][k]), (name, k)


@pytest.mark.parametrize("lane", sorted(_LANES))
def test_captured_epochs_equal_eager_bit_for_bit(card, tmp_path, monkeypatch,
                                                 lane):
    """Two epochs (12 steps) replayed from the captured step equal the same
    epochs taken eagerly: losses, parameters and Adam state, bit for bit,
    in every single-device lane (GraphSAGE's draws included: the graph's
    generator gives the eager generator's draws).  Every replayed step
    runs the lane's kernels, and the epoch plan holds the hub lane's
    chunks."""
    from pcgnn_tpu_torch.train.capture import launch_counts
    t = _lane_trainer(tmp_path, monkeypatch, lane)
    assert t.num_batches == 6 and t.capture
    eager = _run(t, False)
    before = launch_counts()
    captured = _run(t, True)
    after = launch_counts()
    _assert_same_run(eager, captured)
    r = t.runner(*captured[:2]).stats()
    assert (r["captures"], r["eager_steps"], r["replays"]) == (1, 1, 11)
    per = r["replay_launches"]
    # the wrapper ran at the warm-up step and at the capture, and nowhere
    # else: the replays launched what the capture recorded
    assert {k: after[k] - before[k] for k in after} == {
        k: 2 * n for k, n in per.items()}
    if lane in ("fused", "gcn", "sage"):
        assert per["window_gather"] == 1
    if lane == "relation":
        assert per["window_gather"] == 3
    if lane == "learned":
        assert per["mask_build"] == 3 and per["window_gather"] == 0
    # the store lanes choose in one kernel a relation from the records, the
    # lanes without stores through the ids; the others do not choose
    assert per["choose_window"] == (
        3 if lane in ("fused", "relation", "hub") else 0), lane
    assert per["choose_window_ids"] == (
        3 if lane in ("score_table", "plain", "hub_no_stores", "csr")
        else 0), lane
    # every frozen PC-GNN lane takes a step's minors in one kernel; the
    # learned and baseline lanes take none
    assert per["oversample_minors"] == (
        0 if lane in ("learned", "gcn", "gcn_hub", "sage") else 1), lane
    if lane in ("hub", "hub_no_stores", "gcn_hub", "csr"):
        assert per["ragged_gather"] >= 1
    assert r["pool_bytes"] > 0


def test_captured_replays_run_the_kernels(card, tmp_path, monkeypatch):
    """The profiler sees each replay launch the lane's kernels: the window
    gather once a step in the fused lane, and the ragged gather in the hub
    lane, as many times a step as the capture recorded."""
    from torch.profiler import ProfilerActivity, profile
    for lane, name in (("fused", "window_gather"), ("hub", "ragged_gather")):
        t = _lane_trainer(tmp_path, monkeypatch, lane)
        model = t.new_model()
        opt = t.new_optimizer(model)
        r = t.runner(model, opt)
        batches, weights = t.epoch_plan(0)
        r.run(batches, t.labels[batches], weights)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            r.run(batches, t.labels[batches], weights)
            torch.cuda.synchronize()
        assert (r.captures, r.replays) == (1, 2 * t.num_batches - 1)
        seen = sum(e.count for e in prof.key_averages()
                   if f"{name}_kernel" in e.key)
        assert seen == t.num_batches * r.replay_launches[name] > 0


def test_replays_run_their_section_map(card, tmp_path, monkeypatch):
    """Each replay of a captured PC-GNN step runs one device operation a
    node of the capture's section map (``stats()["sections"]``), so the
    k-th operation of a replay is the map's k-th node; every section of
    the step is there, the hub lane's in the hub lane, the choose kernel
    (one a relation) in ``choose``, and the nodes outside every section
    take at most 5% of a replay's device time.  Section ``oversample``
    runs the oversample kernel once and none of the chain it replaced (no
    reduction, scatter-gather or matrix product)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    from pcgnn_tpu_torch.utils.profiling import node_sections
    for lane in ("fused", "hub"):
        t = _lane_trainer(tmp_path, monkeypatch, lane)
        model = t.new_model()
        opt = t.new_optimizer(model)
        r = t.runner(model, opt)
        batches, weights = t.epoch_plan(0)
        r.run(batches, t.labels[batches], weights)
        torch.cuda.synchronize()
        names = node_sections(r.stats()["sections"])
        # the profiler can miss the first operations after it starts: the
        # second stack's replays are the ones held to the map
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                r.run(batches, t.labels[batches], weights)
                torch.cuda.synchronize()
        events = list(prof.profiler.kineto_results.events())
        launches = {e.correlation_id() for e in events
                    if e.device_type().name == "CPU"
                    and e.name().startswith("cudaGraphLaunch")}
        # a device operation carries the correlation id of the call that
        # launched it
        replays = collections.defaultdict(list)
        for e in events:
            if e.device_type().name != "CPU" \
                    and e.correlation_id() in launches:
                replays[e.correlation_id()].append(
                    (e.start_ns(), e.duration_ns(), e.name()))
        assert len(replays) == 2 * t.num_batches
        second = sorted(replays.values(), key=min)[t.num_batches:]
        assert [len(ops) for ops in second] == \
            [len(names)] * t.num_batches, lane
        ms = collections.Counter()
        choose = collections.Counter()
        minors = collections.Counter()
        chain = []
        for ops in second:
            for name, (_, dur, kernel) in zip(names, sorted(ops)):
                ms[name] += dur
                if "choose_window_kernel" in kernel:
                    choose[name] += 1
                if "oversample_minors_kernel" in kernel:
                    minors[name] += 1
                if name == "oversample" and any(
                        k in kernel for k in ("reduce_kernel", "scatter_gather",
                                              "gemm", "gemv")):
                    chain.append(kernel)
        assert choose == {"choose": 3 * t.num_batches}, (lane, choose)
        assert minors == {"oversample": t.num_batches}, (lane, minors)
        assert not chain, (lane, chain)
        want = {"io", "gather", "choose", "oversample", "dense", "backward",
                "adam"} | ({"hub"} if lane == "hub" else set())
        assert set(ms) - {"other"} == want, lane
        assert ms["other"] <= 0.05 * sum(ms.values()), (lane, ms)


def test_captured_epoch_makes_no_host_sync(card, tmp_path, monkeypatch):
    """After the capture, an epoch of a graph without hubs runs under
    ``set_sync_debug_mode("error")``; on a hub graph the epoch's only sync
    is the hub plan's read-back."""
    t = _lane_trainer(tmp_path, monkeypatch, "fused")
    model = t.new_model()
    opt = t.new_optimizer(model)
    t.run_epoch(model, opt, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loss = t.run_epoch(model, opt, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert math.isfinite(float(loss))
    t = _lane_trainer(tmp_path, monkeypatch, "hub")
    model = t.new_model()
    opt = t.new_optimizer(model)
    t.run_epoch(model, opt, 0)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t.run_epoch(model, opt, 1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message) for w in caught if "synchroniz" in str(w.message)]
    assert len(syncs) == 1, syncs


def test_make_optimizer_is_capturable_on_the_card(card):
    from pcgnn_tpu_torch.train.trainer import make_optimizer
    opt = make_optimizer(torch.nn.Linear(4, 2).to(card), 0.01, 0.0)
    assert opt.defaults["capturable"] is True


def test_a_larger_plan_captures_once_more(card, tmp_path, monkeypatch):
    """Stacks whose hub plan the captured one bounds replay; one that
    exceeds it captures again, once, at the union of the two; a smaller
    one after it replays."""
    t = _lane_trainer(tmp_path, monkeypatch, "hub")
    model = t.new_model()
    opt = t.new_optimizer(model)
    r = t.runner(model, opt)
    rel = t.graph.relations[0]
    deg = rel.deg
    order = torch.argsort(deg, descending=True)
    plain = torch.nonzero(deg <= rel.window_width)[:, 0]
    b = t.batch_size

    def stack(hubs):
        rows = torch.cat([hubs, plain[: b - len(hubs)]])
        return rows.repeat(2, 1)

    # two hub rows fill one chunk; the heaviest hub 40 times fills two
    light, heavy = stack(order[4:6]), stack(order[:1].repeat(40))
    for s in (light, light, heavy, light, heavy):
        r.run(s, t.labels[s], torch.ones(s.shape, device=card))
    torch.cuda.synchronize()
    assert r.captures == 2
    assert r.graph_plans == r.plans


def test_load_adam_state_in_place_keeps_the_captured_tensors(card, tmp_path,
                                                             monkeypatch):
    """Loading Adam state into a captured trainer copies into the tensors
    the graph reads, so the next replayed epoch equals an eager one from
    the same state."""
    from pcgnn_tpu_torch.train.trainer import adam_state, load_adam_state
    t = _lane_trainer(tmp_path, monkeypatch, "fused")
    runs = []
    for capture in (True, False):
        t.capture = capture
        model = t.new_model()
        opt = t.new_optimizer(model)
        t.run_epoch(model, opt, 0)
        saved = adam_state(model, opt), {k: v.clone() for k, v in
                                         model.state_dict().items()}
        t.run_epoch(model, opt, 1)
        ids = [id(v) for p in model.parameters() for v in
               opt.state[p].values()]
        load_adam_state(model, opt, saved[0])
        model.load_state_dict(saved[1])
        assert ids == [id(v) for p in model.parameters() for v in
                       opt.state[p].values()]
        loss = t.run_epoch(model, opt, 1)
        torch.cuda.synchronize()
        runs.append((model, opt, loss.view(1)))
    _assert_same_run(*runs)


def test_resume_and_restore_best_with_a_captured_trainer(card, tmp_path):
    """A captured run of 4 epochs cut after 2 and resumed ends with the
    uncut captured run's parameters, bit for bit, restores the same best
    state and scores the test split the same.  Each run's evaluations
    replay one forward, captured after the resumed parameters were loaded,
    and its test scores are the eager evaluate's of the restored model."""
    from pcgnn_tpu_torch.interop import params_from_jax
    from pcgnn_tpu_torch.train.checkpoint import load_checkpoint
    from pcgnn_tpu_torch.train.metrics import evaluate
    from pcgnn_tpu_torch.train.results import ResultManager
    from pcgnn_tpu_torch.train.trainer import Trainer
    cfg = _small_cfg(resume=True)
    out = []
    for tag, cut in (("uncut", None), ("cut", 2)):
        root = str(tmp_path / tag)
        if cut:
            Trainer(dict(cfg, epochs=cut),
                    result=ResultManager(cfg, root=root)).train()
        t = Trainer(cfg, result=ResultManager(cfg, root=root))
        assert t.capture
        res = t.train()
        r = t.predict_runner(t.model)
        assert r.capture and r.captures == 1
        want = evaluate(lambda b: t.predict(t.model, b), t.idx_test,
                        t.y_test, t.batch_size, print_line=False)
        assert res == (want.auc, want.recall, want.f1_macro)
        out.append((res, load_checkpoint(t._resume_path()),
                    {k: v.cpu() for k, v in t.model.state_dict().items()}))
    (res_a, ck_a, best_a), (res_b, ck_b, best_b) = out
    assert ck_a["epoch"] == ck_b["epoch"] == 3
    last_a, last_b = (params_from_jax(c["params"]) for c in (ck_a, ck_b))
    for k in last_a:
        assert torch.equal(last_a[k], last_b[k]), k
    for k in best_a:
        assert torch.equal(best_a[k], best_b[k]), k
    assert res_a == res_b


def test_replayed_draws_equal_a_fresh_generator(card):
    """A graph that draws from a registered generator, seeded before each
    replay, gives a fresh generator's draws of that seed."""
    gen = torch.Generator(device=card)
    out = torch.empty(1000, device=card)
    gen.manual_seed(1)
    out.copy_(torch.rand(1000, generator=gen, device=card))
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out.copy_(torch.rand(1000, generator=gen, device=card))
    for seed in (5, 6, 5):
        gen.manual_seed(seed)
        graph.replay()
        fresh = torch.Generator(device=card).manual_seed(seed)
        assert torch.equal(out, torch.rand(1000, generator=fresh,
                                           device=card))


def test_a_capture_that_cannot_succeed_raises(card, tmp_path):
    """A step that reads a value back cannot be captured: the captured
    run raises (in a process of its own, which the failed capture leaves
    behind), and there is no eager fallback."""
    import subprocess
    import sys
    script = tmp_path / "sync_step.py"
    script.write_text(
        "import torch\n"
        "from pcgnn_tpu_torch.train.capture import StepRunner\n"
        "w = torch.zeros(4, device='cuda', requires_grad=True)\n"
        "opt = torch.optim.Adam([w], capturable=True)\n"
        "def step(b, y, x, g, plans):\n"
        "    opt.zero_grad(set_to_none=True)\n"
        "    loss = (w * x).sum() * float(x.sum())\n"
        "    loss.backward()\n"
        "    opt.step()\n"
        "    return loss.detach()\n"
        "r = StepRunner(step, (), torch.device('cuda'), capture=True,\n"
        "               draws=False)\n"
        "ones = torch.ones(3, 4, device='cuda')\n"
        "try:\n"
        "    r.run(ones.long(), ones.long(), ones)\n"
        "except RuntimeError as e:\n"
        "    print('raised', r.replays, r.captures, e)\n")
    import os
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    done = subprocess.run([sys.executable, str(script)], env=env,
                          capture_output=True, text=True, timeout=120)
    assert done.stdout.startswith("raised 0 0"), (done.stdout, done.stderr)


# ------------------------------------------- the captured forward (predict)

def _stacked_launches(t, model, nodes, labels, counted):
    """``t.evaluate`` of ``model`` on ``nodes``, its wrapper launch counts
    added to ``counted``."""
    from pcgnn_tpu_torch.train.capture import launch_counts
    before = launch_counts()
    res = t.evaluate(model, nodes, labels, print_line=False)
    after = launch_counts()
    for k in counted:
        counted[k] += after[k] - before[k]
    return res


def _assert_same_eval(got, want):
    assert np.array_equal(got.anomaly_confidence, want.anomaly_confidence)
    for k in ("accuracy", "f1", "f1_macro", "precision", "recall", "auc",
              "gmean"):
        a, b = getattr(got, k), getattr(want, k)
        assert a == b or (math.isnan(a) and math.isnan(b)), k


@pytest.mark.parametrize("lane", sorted(_LANES))
def test_captured_evaluate_equals_eager_bit_for_bit(card, tmp_path,
                                                    monkeypatch, lane):
    """The stacked evaluate of the validation and test splits -- one
    captured forward, replayed a batch -- equals the per-batch eager
    ``evaluate`` over ``Trainer.predict`` bit for bit in every
    single-device lane: after an epoch of captured training (the capture),
    after another (its replays moved the parameters in place) and after a
    restore (``load_state_dict``).  One capture; the replays launch the
    lane's kernels, counted by ``card_launches``."""
    from pcgnn_tpu_torch.train.capture import launch_counts
    from pcgnn_tpu_torch.train.metrics import evaluate
    t = _lane_trainer(tmp_path, monkeypatch, lane)
    model, opt, _ = _run(t, True, epochs=1)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    splits = ((t.idx_valid, t.y_valid), (t.idx_test, t.y_test))
    counted = dict.fromkeys(launch_counts(), 0)

    def check():
        for nodes, labels in splits:
            want = evaluate(lambda b: t.predict(model, b), nodes, labels,
                            t.batch_size, print_line=False)
            got = _stacked_launches(t, model, nodes, labels, counted)
            _assert_same_eval(got, want)

    check()
    t.run_epoch(model, opt, 1)
    check()
    model.load_state_dict(saved)
    check()
    r = t.predict_runner(model)
    nb = sum(-(-len(n) // t.batch_size) for n, _ in splits)
    assert (r.captures, r.eager_steps, r.replays) == (1, 1, 3 * nb - 1)
    per = r.replay_launches
    assert r.card_launches(counted) == {k: 3 * nb * n for k, n in
                                        per.items()}
    if lane in ("fused", "gcn", "sage"):
        assert per["window_gather"] == 1
    if lane == "relation":
        assert per["window_gather"] == 3
    if lane == "learned":
        assert per["mask_build"] == 3 and per["window_gather"] == 0
    if lane in ("hub", "hub_no_stores", "gcn_hub", "csr"):
        assert per["ragged_gather"] >= 1
    assert r.pool_bytes > 0


def test_captured_evaluate_makes_no_host_sync(card, tmp_path, monkeypatch):
    """After the capture, the forwards of a stack run under
    ``set_sync_debug_mode("error")``; a whole evaluate syncs once (the
    read-back of its probabilities) on a graph without hubs and twice on
    one with hubs (and the hub plan's)."""
    for lane, syncs in (("fused", 1), ("hub", 2)):
        t = _lane_trainer(tmp_path, monkeypatch, lane)
        model = t.new_model()
        t.evaluate(model, t.idx_valid, t.y_valid, print_line=False)
        r = t.predict_runner(model)
        stack = t._stack(t.idx_valid)
        torch.cuda.synchronize()
        if lane == "fused":
            torch.cuda.set_sync_debug_mode("error")
            try:
                probs = r.run(stack)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            assert bool(torch.isfinite(probs).all())
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t.evaluate(model, t.idx_valid, t.y_valid, print_line=False)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen = [str(w.message) for w in caught
                if "synchroniz" in str(w.message)]
        assert len(seen) == syncs, (lane, seen)
        assert r.captures == 1


@pytest.mark.parametrize("lane", sorted(_LANES))
def test_a_train_captures_the_forward_once(card, tmp_path, monkeypatch,
                                           lane):
    """``train()`` with a validation every epoch and the restore-best test
    replays one captured forward: one capture for validation and test
    together, and the test's metrics are the eager evaluate's of the
    restored model."""
    from pcgnn_tpu_torch.train.metrics import evaluate
    t = _lane_trainer(tmp_path, monkeypatch, lane)
    t.config.update(epochs=2, valid_epochs=1)
    auc, recall, f1 = t.train()
    r = t.predict_runner(t.model)
    nv, nt = (-(-len(n) // t.batch_size) for n in (t.idx_valid, t.idx_test))
    assert (r.captures, r.replays) == (1, 2 * nv + nt - 1)
    want = evaluate(lambda b: t.predict(t.model, b), t.idx_test, t.y_test,
                    t.batch_size, print_line=False)
    assert (auc, recall, f1) == (want.auc, want.recall, want.f1_macro)



# ------------------------------- the captured sharded step and evaluate

_CAPTURED_SHARD_WORKER = r'''
import dataclasses, json, os, sys
import numpy as np
import torch
rank, port, out, dd, dg = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                           int(sys.argv[4]), int(sys.argv[5]))
os.chdir(os.path.dirname(out))
from pcgnn_tpu_torch.graph import csr
from pcgnn_tpu_torch.train.capture import launch_counts
from pcgnn_tpu_torch.train.metrics import evaluate
from pcgnn_tpu_torch.train.results import ResultManager
from pcgnn_tpu_torch.train.trainer import Trainer
torch.cuda.set_device(0)
# case: (preset, config changes, fused record table)
cases = json.loads(sys.argv[6])
base = dict(seed=2, model="PCGNN", train_ratio=0.4, test_ratio=0.67,
            emb_size=16, lr=0.01, weight_decay=0.001, alpha=2.0, rho=0.5,
            epochs=2, valid_epochs=10 ** 9, batch_size=64,
            patience=10 ** 9, exp_num=0,
            distributed=True, coordinator_address=f"localhost:{port}",
            num_processes=2, process_id=rank, mesh_graph=dg,
            dist_backend="gloo")
res = {}


def heavy_stack(t):
    """Two batches whose first data block is relation 0's heaviest hub row
    over and over (two hub chunks) and whose second holds no hub row."""
    rel = t.graph.relations[0]
    plain = [v for v in t.idx_train.tolist()
             if int(rel.deg[v]) <= rel.window_width]
    bd = t.batch_size // 2
    row = [int(torch.argmax(rel.deg))] * bd + plain[:bd]
    b = torch.tensor([row, row], device=t.device)
    return b, t.labels[b], torch.ones(b.shape, device=t.device), [0, 0]


def run(t, capture, epochs=2):
    """Two epochs of a fresh model through the runner (at dd = 2 then the
    heavy stack, which only data rank 0's plan must grow for): (model,
    optimizer, losses, the captures the heavy stack made)."""
    t.capture = capture
    model = t.new_model()
    opt = t.new_optimizer(model)
    losses = [t.run_epoch(model, opt, e) for e in range(epochs)]
    r = t.runner(model, opt)
    before = r.captures
    if dd == 2:
        losses.append(r.run(*heavy_stack(t)).mean())
    torch.cuda.synchronize()
    return model, opt, torch.stack(losses), r.captures - before


for name, (preset, changes, fused) in cases.items():
    cfg = dict(base, data_name="synthetic:" + preset, **changes)
    t = Trainer(cfg, device="cuda:0", result=ResultManager(
        cfg, root=os.path.join(os.path.dirname(out), f"r{rank}-{name}")))
    assert t.capture and t.mesh.backend == "gloo"
    if not fused:
        t.sharded = dataclasses.replace(t.sharded, fused=None, fused_off=())
    # 3-4 steps an epoch; at dd = 2 blocks over one hub chunk (32 rows)
    t.batch_size = max(-(-t.sample_size // 4), 33 * dd)
    t.batch_size = -(-t.batch_size // dd) * dd
    t.num_batches = -(-t.sample_size // t.batch_size)
    for overlap in (True, False):
        key = f"{name}.{int(overlap)}"
        t.sharded = dataclasses.replace(t.sharded, mesh=dataclasses.replace(
            t.mesh, overlap=overlap))
        counted, got = [], []
        for capture in (False, True):
            before = launch_counts()
            got.append(run(t, capture))
            after = launch_counts()
            counted.append({k: after[k] - before[k] for k in after})
        eager, captured = got
        r = t.runner(*captured[:2])
        res[key + ".eager_launches"] = counted[0]
        res[key + ".card_launches"] = r.card_launches(counted[1])
        res[key + ".stats"] = r.stats()
        res[key + ".heavy_captures"] = captured[3]
        same = torch.equal(eager[2], captured[2])
        for (n, p), q in zip(eager[0].named_parameters(),
                             captured[0].parameters()):
            same = same and torch.equal(p, q) and all(
                torch.equal(v, captured[1].state[q][k])
                for k, v in eager[1].state[p].items())
        res[key + ".same"] = bool(same)
        res[key + ".losses"] = captured[2].tolist()
        # the evaluate: eager per batch, then the captured stacked one
        model = captured[0]
        t._runner = None
        want = evaluate(lambda b: t.predict(model, b), t.idx_valid,
                        t.y_valid, t.batch_size, print_line=False)
        got = t.evaluate(model, t.idx_valid, t.y_valid, print_line=False)
        pr = t.predict_runner(model)
        res[key + ".eval_same"] = bool(np.array_equal(
            got.anomaly_confidence, want.anomaly_confidence)
            and got.auc == want.auc)
        res[key + ".predict_stats"] = pr.stats()
        t._predict_runner = None
    del t
    torch.cuda.empty_cache()
json.dump(res, open(out, "w"))
torch.distributed.destroy_process_group()
'''

# case: (preset, config changes, fused record table); the lanes each
# capture exercises: the fused records (kernel 1a) and the hub lane
# (kernel 2) on skew-tiny, the per-relation store lane (kernel 1c), GCN's
# and GraphSAGE's store and hub lanes, GraphSAGE's draws
_SHARD_CAPTURE_CASES = {
    "skew_stores": ("skew-tiny", {"ewin_dtype": "bfloat16"}, True),
    "store_lane": ("small", {"ewin_dtype": "bfloat16"}, False),
    "gcn_hub": ("skew-tiny", {"model": "GCN"}, False),
    "sage_draws": ("small", {"model": "SAGE", "num_sample": 5}, False),
}


def _sharded_capture_gang(tmp_path, cases, dd, dg):
    """Two gloo ranks on cuda:0 running ``_CAPTURED_SHARD_WORKER`` over
    ``cases`` at the (dd, dg) mesh: the ranks' reports."""
    import json

    from pcgnn_tpu_torch.ops import kernels
    from pcgnn_tpu_torch.utils.multiproc import (gang_with_fresh_port,
                                                 run_workers, worker_env)
    kernels.build()
    worker = tmp_path / "worker.py"
    worker.write_text(_CAPTURED_SHARD_WORKER)
    outs = [tmp_path / f"r{r}.json" for r in range(2)]
    gang_with_fresh_port(lambda port: run_workers(
        str(worker), [(r, port, outs[r], dd, dg, json.dumps(cases))
                      for r in range(2)],
        env=worker_env(), timeout=600))
    return [json.loads(o.read_text()) for o in outs]


def test_captured_sharded_epochs_equal_eager_bit_for_bit(card, tmp_path):
    """Two gloo ranks sharing the card at (data 1, graph 2): two sharded
    epochs replayed from the captured pieces equal the same epochs taken
    eagerly -- losses, parameters and Adam state, bit for bit -- with the
    collectives async and blocking, in the fused and hub lanes (kernels 1a
    and 2), the store lane (kernel 1c), GCN's hub lane and GraphSAGE's
    draws; the stacked captured evaluate gives the eager per-batch
    probabilities bit for bit.  Each replay is several pieces with the
    collectives between them, and runs the lanes' kernels; the ranks
    agree."""
    ranks = _sharded_capture_gang(tmp_path, _SHARD_CAPTURE_CASES, 1, 2)
    for res in ranks:
        for name in _SHARD_CAPTURE_CASES:
            for overlap in (1, 0):
                key = f"{name}.{overlap}"
                assert res[key + ".same"], key
                assert res[key + ".eval_same"], key
                assert res[key + ".losses"] == ranks[0][key + ".losses"]
                st = res[key + ".stats"]
                assert st["captures"] >= 1, st
                assert st["eager_steps"] == st["captures"], st
                assert st["pieces"] > 1 and st["collectives"] >= 3, st
                assert st["pieces"] <= st["collectives"] * (1 + overlap) + 1
                assert res[key + ".predict_stats"]["pieces"] > 1
                # the replays ran what the eager steps launched
                assert res[key + ".card_launches"] == res[
                    key + ".eager_launches"], key
        assert res["skew_stores.1.stats"]["replay_launches"][
            "window_gather"] == 1
        assert res["skew_stores.1.stats"]["replay_launches"][
            "ragged_gather"] >= 1
        assert res["store_lane.1.stats"]["replay_launches"][
            "window_gather"] == 3
        assert res["gcn_hub.1.stats"]["replay_launches"]["ragged_gather"] >= 1


def test_data_groups_capture_at_different_steps(card, tmp_path):
    """At (data 2, graph 1) each data rank plans its own block, so the two
    ranks may capture at different stacks: a capture runs no collective,
    so their data-axis sums still pair, and every step equals the eager
    one bit for bit."""
    cases = {"skew_stores": _SHARD_CAPTURE_CASES["skew_stores"]}
    ranks = _sharded_capture_gang(tmp_path, cases, 2, 1)
    for overlap in (1, 0):
        key = f"skew_stores.{overlap}"
        for res in ranks:
            assert res[key + ".same"] and res[key + ".eval_same"], key
            st = res[key + ".stats"]
            # the loss terms' and the gradients' data sums: no graph axis
            assert st["collectives"] == 2, st
            assert res[key + ".losses"] == ranks[0][key + ".losses"]
        # the heavy stack grew data rank 0's plan only: rank 0 captured
        # again (its warm-up step ran the data sums) while rank 1 replayed
        assert [r[key + ".heavy_captures"] for r in ranks] == [1, 0]


def test_one_rank_nccl_group_steps_equal_single_device_exactly(
        card, tmp_path, monkeypatch):
    """The card's form of the CPU test of the same name: a 1-rank NCCL
    group's (1, 1) step, captured, on the hub graph with bf16 stores
    (fused, store and hub lanes), is the single device's captured step bit
    for bit: loss and every parameter after 3 steps.  Both add their
    oversampled minors with the oversample kernel, once a replay."""
    import torch.distributed as dist

    from pcgnn_tpu_torch.parallel.distributed import init_distributed
    from pcgnn_tpu_torch.train.trainer import Trainer
    from pcgnn_tpu_torch.utils.multiproc import free_port
    monkeypatch.chdir(tmp_path)
    torch.cuda.set_device(0)
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        cfg = _small_cfg(seed=7, data_name="synthetic:skew-tiny",
                         batch_size=64, ewin_dtype="bfloat16")
        single = Trainer(cfg, device=card)
        rank = Trainer(dict(cfg, distributed=True), device="cuda:0",
                       graph=single.graph)
        assert rank.mesh.size == 1 and rank.sharded.fused is not None
        got = []
        for t in (single, rank):
            model = t.new_model()
            r = t.runner(model, t.new_optimizer(model))
            batches, weights = t.epoch_plan(0)
            losses = r.run(batches[:3], t.labels[batches[:3]], weights[:3])
            torch.cuda.synchronize()
            got.append((losses, list(model.parameters()), r.stats()))
        assert torch.equal(got[0][0], got[1][0]), (got[0][0], got[1][0])
        for a, b in zip(got[0][1], got[1][1]):
            assert torch.equal(a, b)
        for st in (got[0][2], got[1][2]):
            assert st["captures"] == 1, st
            assert st["replay_launches"]["oversample_minors"] == 1, st
        assert rank.mesh.stats.calls == {"graph": 0, "data": 0}
    finally:
        dist.destroy_process_group()


def test_one_rank_nccl_group_captures_one_piece_a_step(card, tmp_path,
                                                       monkeypatch):
    """A 1-rank NCCL group's (1, 1) mesh issues no collective, so its
    captured step and forward are one piece each, with nothing between
    replays; two captured epochs and the captured evaluate equal the
    single device's captured ones bit for bit."""
    import torch.distributed as dist

    from pcgnn_tpu_torch.parallel.distributed import init_distributed
    from pcgnn_tpu_torch.train.trainer import Trainer
    from pcgnn_tpu_torch.utils.multiproc import free_port
    monkeypatch.chdir(tmp_path)
    torch.cuda.set_device(0)
    init_distributed(f"localhost:{free_port()}", 1, 0, backend="nccl")
    try:
        cfg = _small_cfg(data_name="synthetic:skew-tiny", batch_size=64,
                         epochs=2, valid_epochs=10 ** 9)
        single = Trainer(cfg, device=card)
        rank = Trainer(dict(cfg, distributed=True), device="cuda:0",
                       graph=single.graph)
        assert rank.mesh.backend == "nccl" and rank.capture
        got = []
        for t in (single, rank):
            model, opt, losses = _run(t, True)
            ev = t.evaluate(model, t.idx_valid, t.y_valid, print_line=False)
            got.append((model, opt, losses, ev))
        _assert_same_run(got[0][:3], got[1][:3])
        _assert_same_eval(got[1][3], got[0][3])
        for r in (rank.runner(*got[1][:2]), rank.predict_runner(got[1][0])):
            assert (r.pieces, r.collectives) == (1, 0)
            assert r.captures == 1
        assert rank.mesh.stats.calls == {"graph": 0, "data": 0}
    finally:
        dist.destroy_process_group()
