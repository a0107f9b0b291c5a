"""The hand-written kernels on the card.  A CUDA kernel has no CPU mode, so
these tests carry the ``cuda`` marker and skip where no card is present.

This file imports neither JAX nor the JAX package (the GPU machine has
neither), so it runs there without the repository's JAX conftest:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

The window gather is a copy, so the kernel must equal its plain version
exactly.  The model on the card is compared with the same model on the CPU's
plain path: both select the same rows (selection scores are rounded once
from float64), and their float32 sums run in another order, so logits agree
to rtol 1e-5 with atol 1e-6.
"""

import math

import numpy as np
import pytest
import torch

from pcgnn_tpu_torch.data.synthetic import synthetic_fraud_graph
from pcgnn_tpu_torch.graph import csr
from pcgnn_tpu_torch.models.pcgnn import PCGNN
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


def test_wrapper_raises_on_bad_arguments(card):
    store = torch.zeros(4096, device=card)
    ok = torch.tensor([0, 4], device=card)
    bad = [
        (store, torch.tensor([2], device=card), 8),          # not 16-byte
        (store, torch.tensor([4096 - 4], device=card), 8),   # past the end
        (store, torch.tensor([-4], device=card), 8),          # negative
        (store, ok, 6),                                       # dp not 16 B
        (store[::2], ok, 8),                                  # strided
        (store, ok.cpu(), 8),                                 # two devices
    ]
    for args in bad:
        with pytest.raises(ValueError):
            wg.window_gather(*args)
    assert wg.window_gather(store, ok[:0], 8).shape == (0, 8)


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
    assert wg.launches == t.num_batches
