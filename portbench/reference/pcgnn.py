"""PC-GNN's layer, loss, gradients and Adam, written plainly.

For a center v of relation r, with s(u) = float32(bf16(x_u) . w0 + b0)
summed in float64 (w0, b0: column 0 of the label classifier, with no
gradient through it):

* kept: the ``keff(v)`` neighbors nearest by |s(v) - s(u)| in float32,
  ties to the lower neighbor id;
* minors (training, fraud centers only): the ``floor(ksample(v) * rho)``
  train positives nearest by the same distance, ties to the earlier in
  the train split's order;
* agg_r(v): the mean over the union of the two sets; a kept neighbor reads
  its stored features (``reference.graph``: bfloat16 where the
  configuration holds bfloat16 stores, else exact) unless v's degree
  exceeds the window cap, a minor that is not kept reads its exact
  features;
* h_r = relu([x_v ; agg_r] W_r), z = relu([x_v ; h_1 ; ... ; h_R] W_inter),
  logits = z W_head, scores = x_v W_clf + b_clf;
* loss = sum w CE(logits) / max(sum w, 1) + alpha sum w CE(scores) /
  max(sum w, 1); Adam (betas 0.9, 0.999, eps 1e-8) with the weight decay
  added to the gradient, its bias corrections computed in float32.

Matrix products and the sums of gathered rows go through ``plain``:
float32, or, for the control, TF32.  The aggregates gather the rows they
sum, so their memory follows the batch, its widest row and the train
positives, not the node count.

The harness reaches a reference only through its module's interface, the
functions under "Interface" at the end of this file (``reference/__init__``).
"""

from __future__ import annotations

import torch

from portbench.reference import graph as refgraph
from portbench.reference import weights as init_weights
from portbench.reference.plain import adam_steps, ce, mm, row_sum


def scores(g, w0: torch.Tensor, b0: torch.Tensor,
           block: int = 1 << 20) -> torch.Tensor:
    """[N] selection scores of the stored features, in blocks of nodes."""
    w, b = w0.double(), b0.double()
    return torch.cat([(g.stored[i: i + block].double() @ w + b).float()
                      for i in range(0, g.stored.shape[0], block)])


def _nearest(dist: torch.Tensor, k: torch.Tensor) -> tuple:
    """(cols [B, K], take [B, K]): each row's columns by distance, ties to
    the lower column, the first K = min(max k, width) of them, and which
    of those are among the row's ``k`` nearest."""
    width = min(int(k.max()), dist.shape[1]) if k.numel() else 0
    cols = torch.argsort(dist, dim=1, stable=True)[:, :width]
    take = torch.arange(width, device=dist.device)[None, :] < k[:, None]
    return cols, take


def aggregate(g, rel, nodes: torch.Tensor, s: torch.Tensor,
              labels_b, rho: float, low: bool) -> torch.Tensor:
    """[B, F] agg_r of ``nodes``; ``labels_b`` None for inference (no
    minors)."""
    n = g.features.shape[0]
    deg = rel.deg[nodes]
    width = int(deg.max())
    slot = torch.arange(width, device=nodes.device)
    valid = slot[None, :] < deg[:, None]
    nbr = torch.where(valid, rel.indptr[nodes][:, None] + slot[None, :], 0)
    nbr = torch.where(valid, rel.col[nbr], 0)
    dist = (s[nodes][:, None] - s[nbr]).abs()
    dist = torch.where(valid, dist, float("inf"))
    cols, kept = _nearest(dist, rel.keff[nodes])
    kept &= valid.gather(1, cols)
    kept_ids = nbr.gather(1, cols)
    num = row_sum(g, kept_ids, kept, deg > rel.dcap, low)
    cnt = kept.sum(1)
    if labels_b is not None and g.train_pos.numel():
        tp = g.train_pos
        m = torch.floor(rel.ksample[nodes].float() * rho).long()
        m = torch.where(labels_b == 1, m, 0)
        dm = (s[nodes][:, None] - s[tp][None, :]).abs()
        mcols, minor = _nearest(dm, m)
        minor_ids = tp[mcols]
        # minors only where not kept: looked up in the row's kept ids,
        # sorted, the untaken slots past every node id
        ks = torch.sort(torch.where(kept, kept_ids, n), dim=1).values
        if ks.shape[1]:
            at = torch.searchsorted(ks, minor_ids).clamp(max=ks.shape[1] - 1)
            minor &= ks.gather(1, at) != minor_ids
        num = num + row_sum(g, minor_ids, minor, None, low)
        cnt = cnt + minor.sum(1)
    return num / cnt.clamp(min=1)[:, None].float()


def forward(g, params: dict, nodes: torch.Tensor, labels_b, rho: float,
            low: bool = False, s: torch.Tensor | None = None):
    """(logits [B, 2], label scores [B, 2]); ``labels_b`` given in
    training (the minors)."""
    if s is None:
        s = scores(g, params["label_clf.w"][:, 0].detach(),
                   params["label_clf.b"][0].detach())
    x = g.features[nodes]
    with torch.no_grad():
        aggs = [aggregate(g, rel, nodes, s, labels_b, rho, low)
                for rel in g.relations]
    hs = [torch.relu(mm(torch.cat([x, a], 1), params[f"intra.{r}.w"], low))
          for r, a in enumerate(aggs)]
    z = torch.relu(mm(torch.cat([x] + hs, 1), params["inter.w"], low))
    logits = mm(z, params["head.w"], low)
    label_scores = mm(x, params["label_clf.w"], low) + params["label_clf.b"]
    return logits, label_scores


def loss(g, params: dict, nodes, weights, alpha: float, rho: float,
         low: bool = False) -> torch.Tensor:
    y = g.labels[nodes]
    logits, label_scores = forward(g, params, nodes, y, rho, low)
    denom = weights.sum().clamp(min=1.0)
    return ((ce(logits, y) * weights).sum() / denom
            + alpha * (ce(label_scores, y) * weights).sum() / denom)


def train_steps(g, params0: dict, batches, weights, *, lr: float,
                weight_decay: float, alpha: float, rho: float,
                low: bool = False) -> dict:
    """Adam steps on PC-GNN's joint loss (``plain.adam_steps``)."""
    return adam_steps(
        params0, batches, weights,
        lambda p, nodes, w: loss(g, p, nodes, w, alpha, rho, low),
        lr=lr, weight_decay=weight_decay)


def probabilities(g, params: dict, nodes: torch.Tensor, rho: float,
                  low: bool = False, block: int = 4096) -> torch.Tensor:
    """[M, 2] sigmoid of the logits of ``nodes``, in blocks of rows."""
    s = scores(g, params["label_clf.w"][:, 0], params["label_clf.b"][0])
    out = []
    with torch.no_grad():
        for i in range(0, nodes.shape[0], block):
            logits, _ = forward(g, params, nodes[i: i + block], None, rho,
                                low, s=s)
            out.append(torch.sigmoid(logits))
    return torch.cat(out)


# Interface: what the harness and the check call (``reference/__init__``)


def build_graph(raw, cfg: dict, device):
    """The reference graph of configuration ``cfg`` from the generator's
    ``raw`` arrays."""
    return refgraph.build(raw, cfg["model"], int(cfg["seed"]), device,
                          directed=bool(cfg["graph"].get("directed")))


def edges_per_epoch(g) -> float:
    return refgraph.edges_per_epoch(g)


def initial_weights(seed: int, raw, cfg: dict, device) -> dict:
    return init_weights.initial(seed, raw.features.shape[1],
                           cfg["model"]["emb_size"], len(raw.srcs), device)


def steps(g, params0: dict, batches, batch_weights, hyper: dict,
          low: bool = False) -> dict:
    return train_steps(g, params0, batches, batch_weights, lr=hyper["lr"],
                       weight_decay=hyper["weight_decay"],
                       alpha=hyper["alpha"], rho=hyper["rho"], low=low)


def fraud_probabilities(g, params: dict, nodes: torch.Tensor, hyper: dict,
                        low: bool = False) -> torch.Tensor:
    return probabilities(g, params, nodes, hyper["rho"], low)[:, 1]
