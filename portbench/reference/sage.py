"""The GraphSAGE baseline's layer, loss, gradients and Adam, written
plainly.

GraphSAGE (Hamilton, Ying and Leskovec, NeurIPS 2017, arXiv:1706.02216)
as PC-GNN's trainer builds it (``src/model_handler.py`` of PC-GNN's code,
``gcn=True``; ``src/graphsage.py``), over the homo graph, the union of the
relations (symmetric, a self-loop on every node, each edge once):

* agg(v): the mean of v's homo neighbors' features and v's own, the self
  column only where v's CSR row lacks the self-loop, over
  max(count, 1); a neighbor reads its stored features
  (``reference.graph``: bfloat16 where the configuration holds bfloat16
  stores, else exact) unless v's degree exceeds the window cap, and the
  self column reads exact features;
* z = relu(agg W_enc), logits = z W_head; no gradient reaches agg;
* loss = sum w CE(logits) / max(sum w, 1); Adam (``plain.adam_steps``);
* the fraud probability is softmax(logits)[:, 1].

Departures from the paper, as the author's code departs, and from the
author's code, as the port departs:

* ``gcn=True``: one mean over the row and its neighbors together, with
  no concatenation of the row's own features (the paper's GCN variant of
  the mean aggregator);
* no sampling: the trainer calls the aggregator without ``num_sample``,
  so every neighbor is read; the Encoder's ``num_sample=10`` is declared
  and unused;
* the author's ``to_prob`` calls ``log_softmax(dim=2)`` on a 2-D tensor;
  the port gives the softmax, and so does this reference.

The graph, the plan (every training node once an epoch, shuffled), the
edges an epoch and the initial weights (``enc.w`` [F, E], ``head.w``
[E, 2]) are GCN's (``reference.gcn``), and so are the layer over the
aggregate, the loss and Adam, which take this module's aggregate and
softmax; the aggregate is this module's.
"""

from __future__ import annotations

import torch

from portbench.reference import gcn
from portbench.reference.gcn import (build_graph, edges_per_epoch,  # noqa: F401
                                     initial_weights)
from portbench.reference.plain import row_sum, tf32


def aggregate(g, nodes: torch.Tensor, low: bool) -> torch.Tensor:
    """[B, F] agg of ``nodes``: the mean over each row's neighbors and
    itself."""
    rel = g.relations[0]
    deg = rel.deg[nodes]
    width = int(deg.max())
    slot = torch.arange(width, device=nodes.device)
    valid = slot[None, :] < deg[:, None]
    nbr = torch.where(valid, rel.indptr[nodes][:, None] + slot[None, :], 0)
    nbr = torch.where(valid, rel.col[nbr], 0)
    num = row_sum(g, nbr, valid, deg > rel.dcap, low)
    lacks = ~((nbr == nodes[:, None]) & valid).any(1)
    x = g.features[nodes]
    num = num + torch.where(lacks[:, None], tf32(x) if low else x, 0.0)
    cnt = (deg + lacks).clamp(min=1).float()
    return num / cnt[:, None]


def softmax_of_fraud(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=1)[:, 1]


# Interface: what the harness and the check call (``reference/__init__``);
# ``build_graph``, ``edges_per_epoch`` and ``initial_weights`` are GCN's


def steps(g, params0: dict, batches, batch_weights, hyper: dict,
          low: bool = False) -> dict:
    return gcn.steps(g, params0, batches, batch_weights, hyper, low,
                     agg=aggregate)


def fraud_probabilities(g, params: dict, nodes: torch.Tensor, hyper: dict,
                        low: bool = False, block: int = 4096):
    return gcn.fraud_probabilities(g, params, nodes, hyper, low, block,
                                   agg=aggregate, prob=softmax_of_fraud)
