"""The GCN baseline's layer, loss, gradients and Adam, written plainly.

The author's ``GCNAggregator`` / ``GCNEncoder`` (``src/graphsage.py`` of
PC-GNN's code), over the homo graph, the union of the relations (symmetric,
a self-loop on every node, each edge once):

* agg(v): the sum of v's homo neighbors' features and v's own, the self
  column only where v's CSR row lacks the self-loop, over
  sqrt(max(count, 1)); a neighbor reads its stored features
  (``reference.graph``: bfloat16 where the configuration holds bfloat16
  stores, else exact) unless v's degree exceeds the window cap, and the
  self column reads exact features;
* z = relu(agg W_enc), logits = z W_head; no gradient reaches agg;
* loss = sum w CE(logits) / max(sum w, 1); Adam (``plain.adam_steps``);
* the fraud probability is sigmoid(logit 1).

Departure from Kipf & Welling (arXiv:1609.02907), as the author's code
departs: the normalization is by the row's own count alone, not the
symmetric D^-1/2 A D^-1/2.

The plan takes every training node once an epoch, shuffled (``Graph``'s
``permutation``); the graph's one relation is the homo graph, so the
harness's degree sums and window width read the graph the model reads.
"""

from __future__ import annotations

import dataclasses

import torch

from portbench.reference import graph as refgraph
from portbench.reference import weights as init_weights
from portbench.reference.plain import adam_steps, ce, mm, row_sum, tf32


@dataclasses.dataclass
class HomoGraph(refgraph.Graph):
    """``relations`` is ``[homo graph]``; every training node once an
    epoch."""
    permutation = True

    @property
    def sample_size(self) -> int:
        return len(self.idx_train)


def aggregate(g, nodes: torch.Tensor, low: bool) -> torch.Tensor:
    """[B, F] agg of ``nodes``."""
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
    return num / cnt.sqrt()[:, None]


def forward(g, params: dict, nodes: torch.Tensor, low: bool = False,
            agg=aggregate) -> torch.Tensor:
    """[B, 2] logits over the aggregate ``agg`` (GCN's, or a sibling's
    over the same graph and weights)."""
    with torch.no_grad():
        a = agg(g, nodes, low)
    z = torch.relu(mm(a, params["enc.w"], low))
    return mm(z, params["head.w"], low)


def loss(g, params: dict, nodes, weights, low: bool = False,
         agg=aggregate):
    y = g.labels[nodes]
    denom = weights.sum().clamp(min=1.0)
    return (ce(forward(g, params, nodes, low, agg), y) * weights).sum() / denom


def sigmoid_of_fraud(logits: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(logits)[:, 1]


# Interface: what the harness and the check call (``reference/__init__``)


def build_graph(raw, cfg: dict, device) -> HomoGraph:
    directed = bool(cfg["graph"].get("directed"))
    h = refgraph.homo(raw, device, directed)
    return HomoGraph(relations=[h], homo_deg=h.deg,
                     **refgraph.nodes(raw, cfg["model"], int(cfg["seed"]),
                                      device))


def edges_per_epoch(g) -> float:
    """Every training node once, each bringing its homo degree."""
    idx = torch.as_tensor(g.idx_train, device=g.homo_deg.device)
    return float(g.homo_deg[idx].double().sum())


def initial_weights(seed: int, raw, cfg: dict, device) -> dict:
    f, e = raw.features.shape[1], cfg["model"]["emb_size"]
    return init_weights.draw(seed, {"enc.w": init_weights.xavier(f, e),
                                    "head.w": init_weights.xavier(e, 2)},
                             device)


def steps(g, params0: dict, batches, batch_weights, hyper: dict,
          low: bool = False, agg=aggregate) -> dict:
    return adam_steps(params0, batches, batch_weights,
                      lambda p, nodes, w: loss(g, p, nodes, w, low, agg),
                      lr=hyper["lr"], weight_decay=hyper["weight_decay"])


def fraud_probabilities(g, params: dict, nodes: torch.Tensor, hyper: dict,
                        low: bool = False, block: int = 4096, agg=aggregate,
                        prob=sigmoid_of_fraud):
    """``prob`` of the logits: the fraud probability of each of ``nodes``."""
    with torch.no_grad():
        return torch.cat([prob(forward(g, params, nodes[i: i + block], low,
                                       agg))
                          for i in range(0, nodes.shape[0], block)])
